"""Host-env episode runners.

Port of ``reagent_tpu/gym/runners/gymrunner.py`` (``Trajectory``,
``run_episode``, ``evaluate_for_n_episodes``, :16-68; reference
reagent/gym/runners/gymrunner.py:25-138, which runs an mp.Pool): sequential
or thread-pooled over a host env and an ``Agent``.  The device-resident
evaluator is ``online_loop.evaluate_policy``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np


class Trajectory:
    def __init__(self):
        self.observations: List = []
        self.actions: List = []
        self.rewards: List[float] = []

    def add_transition(self, obs, action, reward: float) -> None:
        self.observations.append(obs)
        self.actions.append(action)
        self.rewards.append(reward)

    def calculate_cumulative_reward(self, gamma: float = 1.0) -> float:
        return float(sum(r * gamma**i for i, r in enumerate(self.rewards)))

    def __len__(self):
        return len(self.rewards)


def run_episode(env, agent, max_steps: Optional[int] = None, mdp_id: int = 0) -> Trajectory:
    """Reference gymrunner.py:25-64."""
    trajectory = Trajectory()
    obs = env.reset()
    done = False
    steps = 0
    while not done and (max_steps is None or steps < max_steps):
        action = agent.act(obs)
        next_obs, reward, done = env.step(action)
        trajectory.add_transition(obs, action, reward)
        agent.post_step((obs, action, reward, next_obs, done))
        obs = next_obs
        steps += 1
    agent.post_episode(trajectory)
    return trajectory


def evaluate_for_n_episodes(
    n: int,
    env,
    agent,
    max_steps: Optional[int] = None,
    gamma: float = 1.0,
    num_processes: int = 1,
) -> np.ndarray:
    """Reference gymrunner.py:67-138 (mp.Pool there)."""
    def one(i):
        return run_episode(env, agent, max_steps, mdp_id=i).calculate_cumulative_reward(gamma)

    if num_processes <= 1:
        rewards = [one(i) for i in range(n)]
    else:
        with ThreadPoolExecutor(max_workers=num_processes) as pool:
            rewards = list(pool.map(one, range(n)))
    return np.array(rewards).reshape(-1, 1)
