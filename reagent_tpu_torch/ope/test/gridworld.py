"""Gridworld OPE benchmark harness.

Port of ``reagent_tpu/ope/test/gridworld.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/test/gridworld.py — an enumerable gridworld MDP with a
DP-derived ground truth, used to benchmark the sequential estimators.
"""

from __future__ import annotations

from typing import Hashable, List, Tuple

import numpy as np

from reagent_tpu_torch.ope.estimators.sequential_estimators import RLEstimatorInput
from reagent_tpu_torch.ope.trainers.rl_tabular_trainers import (
    DPTrainer,
    DPValueFunction,
    TabularPolicy,
)


class GridWorld:
    """Deterministic gridworld with a goal; actions {left,right,up,down}."""

    num_actions = 4

    def __init__(self, size: int = 4, goal_reward: float = 1.0, step_reward: float = -0.01):
        self.size = size
        self.goal = (size - 1, size - 1)
        self.goal_reward = goal_reward
        self.step_reward = step_reward
        self.states: List[Tuple[int, int]] = [
            (x, y) for x in range(size) for y in range(size)
        ]

    def transition(self, s, a):
        if s == self.goal:
            return [(1.0, s, 0.0, True)]
        x, y = s
        dx = [-1, 1, 0, 0][a]
        dy = [0, 0, -1, 1][a]
        nx = min(max(x + dx, 0), self.size - 1)
        ny = min(max(y + dy, 0), self.size - 1)
        ns = (nx, ny)
        done = ns == self.goal
        r = self.goal_reward if done else self.step_reward
        return [(1.0, ns, r, done)]

    def state_features(self, s) -> np.ndarray:
        onehot = np.zeros(2 * self.size)
        onehot[s[0]] = 1
        onehot[self.size + s[1]] = 1
        return onehot

    def rollout(self, policy: TabularPolicy, max_steps: int, rng) -> Tuple[List, List, List]:
        s = (0, 0)
        states, actions, rewards = [], [], []
        for _ in range(max_steps):
            probs = policy.action_dist(s)
            a = int(rng.choice(self.num_actions, p=probs))
            (_, ns, r, done), = self.transition(s, a)
            states.append(s)
            actions.append(a)
            rewards.append(r)
            s = ns
            if done:
                break
        return states, actions, rewards


def generate_logs(
    world: GridWorld,
    log_policy: TabularPolicy,
    tgt_policy: TabularPolicy,
    value_fn: DPValueFunction,
    num_episodes: int,
    max_steps: int,
    gamma: float,
    seed: int = 0,
) -> RLEstimatorInput:
    """Roll out the logging policy and assemble padded estimator input."""
    rng = np.random.default_rng(seed)
    N, T, A = num_episodes, max_steps, world.num_actions
    actions = np.zeros((N, T), np.int64)
    rewards = np.zeros((N, T))
    log_prop = np.ones((N, T))
    tgt_prop = np.full((N, T, A), 1.0 / A)
    mask = np.zeros((N, T))
    q_values = np.zeros((N, T, A))
    state_feats = np.zeros((N, T, 2 * world.size))
    for i in range(N):
        states, acts, rews = world.rollout(log_policy, max_steps, rng)
        for t, (s, a, r) in enumerate(zip(states, acts, rews)):
            actions[i, t] = a
            rewards[i, t] = r
            log_prop[i, t] = log_policy.action_dist(s)[a]
            tgt_prop[i, t] = tgt_policy.action_dist(s)
            mask[i, t] = 1.0
            state_feats[i, t] = world.state_features(s)
            for aa in range(A):
                # Q under the target policy from DP: r + gamma * V(next)
                (_, ns, rr, done), = world.transition(s, aa)
                q_values[i, t, aa] = rr + (0.0 if done else gamma * value_fn.state_value(ns))
    # absorbing-state padding keeps terminated episodes in the per-step
    # weight denominators (see RLEstimatorInput.with_absorbing_padding)
    return RLEstimatorInput(
        gamma=gamma,
        actions=actions,
        rewards=rewards,
        log_propensities=log_prop,
        tgt_propensities=tgt_prop,
        mask=mask,
        q_values=q_values,
        states=state_feats,
    ).with_absorbing_padding()
