"""Tabular ground-truth policies / value functions for OPE benchmarks.

Port of ``reagent_tpu/ope/trainers/rl_tabular_trainers.py``, line for line (numpy on the
host), so that the port imports nothing of the JAX package.

Reference: reagent/ope/trainers/rl_tabular_trainers.py:1-394 (TabularPolicy,
DPTrainer value iteration, DPValueFunction).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional

import numpy as np


class TabularPolicy:
    """state -> action distribution table."""

    def __init__(self, num_actions: int, epsilon: float = 0.0, rng=None):
        self.num_actions = num_actions
        self.epsilon = epsilon
        self._table: Dict[Hashable, np.ndarray] = {}
        self._rng = rng or np.random.default_rng(0)

    def update(self, state: Hashable, action: int) -> None:
        """Make ``action`` the greedy choice with eps-smoothing."""
        probs = np.full(self.num_actions, self.epsilon / self.num_actions)
        probs[action] += 1.0 - self.epsilon
        self._table[state] = probs

    def action_dist(self, state: Hashable) -> np.ndarray:
        return self._table.get(
            state, np.full(self.num_actions, 1.0 / self.num_actions)
        )

    def sample(self, state: Hashable) -> int:
        return int(self._rng.choice(self.num_actions, p=self.action_dist(state)))

    def __call__(self, state: Hashable) -> np.ndarray:
        return self.action_dist(state)


class DPTrainer:
    """Dynamic-programming (value iteration) trainer on an enumerable MDP.

    The MDP protocol: ``states`` list, ``transition(s, a) -> list of
    (prob, next_state, reward, done)``.
    """

    def __init__(self, mdp, policy: Optional[TabularPolicy] = None):
        self.mdp = mdp
        self.policy = policy

    def train(self, gamma: float = 0.9, iterations: int = 1000, tol: float = 1e-8) -> Dict:
        V: Dict[Hashable, float] = {s: 0.0 for s in self.mdp.states}
        num_actions = self.mdp.num_actions
        for _ in range(iterations):
            delta = 0.0
            for s in self.mdp.states:
                qs = []
                for a in range(num_actions):
                    q = 0.0
                    for prob, ns, r, done in self.mdp.transition(s, a):
                        q += prob * (r + (0.0 if done else gamma * V[ns]))
                    qs.append(q)
                best = max(qs)
                delta = max(delta, abs(best - V[s]))
                V[s] = best
                if self.policy is not None:
                    self.policy.update(s, int(np.argmax(qs)))
            if delta < tol:
                break
        return V


class DPValueFunction:
    """Policy evaluation for a fixed tabular policy (reference :300-394)."""

    def __init__(self, policy: TabularPolicy, mdp, gamma: float = 0.9):
        self.policy = policy
        self.mdp = mdp
        self.gamma = gamma
        self._V: Optional[Dict] = None

    def evaluate(self, iterations: int = 1000, tol: float = 1e-8) -> Dict:
        V: Dict[Hashable, float] = {s: 0.0 for s in self.mdp.states}
        for _ in range(iterations):
            delta = 0.0
            for s in self.mdp.states:
                v = 0.0
                probs = self.policy.action_dist(s)
                for a in range(self.mdp.num_actions):
                    for prob, ns, r, done in self.mdp.transition(s, a):
                        v += probs[a] * prob * (r + (0.0 if done else self.gamma * V[ns]))
                delta = max(delta, abs(v - V[s]))
                V[s] = v
            if delta < tol:
                break
        self._V = V
        return V

    def state_value(self, state) -> float:
        if self._V is None:
            self.evaluate()
        return self._V.get(state, 0.0)


def generate_episode(
    mdp, policy: TabularPolicy, start, rng, max_steps: int = 100
) -> List:
    """Sample one episode [(state, action, reward), ...] from ``start``.

    The sampled analogue of the reference's PolicyLogGenerator.generate_log
    (reagent/ope/test/envs.py) on our enumerable-MDP protocol
    (``transition(s, a) -> [(prob, next_state, reward, done)]``).
    """
    s = start
    steps = []
    for _ in range(max_steps):
        a = int(rng.choice(mdp.num_actions, p=policy.action_dist(s)))
        outcomes = mdp.transition(s, a)
        probs = np.array([o[0] for o in outcomes])
        _, ns, r, done = outcomes[int(rng.choice(len(outcomes), p=probs))]
        steps.append((s, a, r))
        s = ns
        if done:
            break
    return steps


def _mc_returns(steps: List, gamma: float, first_visit: bool):
    """Yield (state, action, return) pairs, backwards-accumulated.

    With ``first_visit`` only the earliest occurrence of each (s, a) in the
    episode contributes — TEXTBOOK first-visit MC.  This deliberately
    diverges from the reference (rl_tabular_trainers.py:330-360), whose
    reverse walk updates every occurrence EXCEPT the earliest, so a
    once-visited pair there never receives any update at all; we keep the
    standard estimator instead of that quirk.
    """
    remaining: Dict = {}
    if first_visit:
        for s, a, _ in steps:
            remaining[(s, a)] = remaining.get((s, a), 0) + 1
    g = 0.0
    out = []
    for s, a, r in reversed(steps):
        g = gamma * g + r
        if first_visit:
            remaining[(s, a)] -= 1
            if remaining[(s, a)] > 0:
                continue
        out.append((s, a, g))
    return out


class MonteCarloTrainer:
    """MC control: first-visit Q estimation + softmax policy improvement.

    Reference: reagent/ope/trainers/rl_tabular_trainers.py:316-394
    (MonteCarloTrainer) — episodes from every state, incremental-mean Q
    updates, policy updated every ``update_interval`` iterations toward
    softmax(Q·count), stopping when the policy is stable.
    """

    def __init__(self, mdp, policy: TabularPolicy, seed: int = 0):
        self.mdp = mdp
        self.policy = policy
        self._rng = np.random.default_rng(seed)

    def train(
        self,
        iterations: int = 100,
        gamma: float = 0.9,
        first_visit: bool = True,
        update_interval: int = 20,
        max_steps: int = 100,
    ) -> None:
        value_counts: Dict = {}
        for i in range(1, iterations + 1):
            for state in self.mdp.states:
                steps = generate_episode(
                    self.mdp, self.policy, state, self._rng, max_steps
                )
                for s, a, g in _mc_returns(steps, gamma, first_visit):
                    v, c = value_counts.get((s, a), (0.0, 0))
                    c += 1
                    value_counts[(s, a)] = (v + (g - v) / c, c)
            if i % update_interval == 0 and self._update_policy(value_counts):
                break

    def _update_policy(self, value_counts: Dict) -> bool:
        """Softmax over count-weighted Q, as the reference does; returns
        True when no state's distribution moved more than 1e-6.

        The policy's epsilon is mixed INTO the stored distribution
        (p*(1-eps) + eps/A) — our TabularPolicy returns its table verbatim,
        whereas the reference applies epsilon at action_dist read time
        (reference rl_tabular_trainers.py:49-60); mixing here preserves the
        exploration the MC rollouts rely on."""
        stable = True
        eps = self.policy.epsilon
        A = self.mdp.num_actions
        for state in self.mdp.states:
            logits = np.array(
                [
                    value_counts.get((state, a), (0.0, 0))[0]
                    * value_counts.get((state, a), (0.0, 0))[1]
                    for a in range(A)
                ]
            )
            z = np.exp(logits - logits.max())
            probs = (z / z.sum()) * (1.0 - eps) + eps / A
            old = self.policy.action_dist(state)
            if np.max(np.abs(probs - old)) >= 1e-6:
                stable = False
            self.policy._table[state] = probs
        return stable


class MonteCarloValueFunction:
    """On-demand MC state values under a fixed policy.

    Reference: reagent/ope/trainers/rl_tabular_trainers.py:238-313 — rolls
    episodes from the queried state until its visit count reaches
    ``count_threshold`` (or ``max_iteration`` episodes), updating every
    visited state's running-mean return along the way.
    """

    def __init__(
        self,
        policy: TabularPolicy,
        mdp,
        gamma: float = 0.99,
        first_visit: bool = True,
        count_threshold: int = 100,
        max_iteration: int = 200,
        max_steps: int = 100,
        seed: int = 0,
    ):
        self.policy = policy
        self.mdp = mdp
        self.gamma = gamma
        self.first_visit = first_visit
        self.count_threshold = count_threshold
        self.max_iteration = max_iteration
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._values: Dict = {}
        self._counts: Dict = {}

    def state_value(self, state) -> float:
        i = 0
        while self._counts.get(state, 0) < self.count_threshold and i < self.max_iteration:
            i += 1
            steps = generate_episode(
                self.mdp, self.policy, state, self._rng, self.max_steps
            )
            # per-state first-visit accounting (ignores the action)
            remaining: Dict = {}
            if self.first_visit:
                for s, _, _ in steps:
                    remaining[s] = remaining.get(s, 0) + 1
            g = 0.0
            for s, _, r in reversed(steps):
                g = self.gamma * g + r
                if self.first_visit:
                    remaining[s] -= 1
                    if remaining[s] > 0:
                        continue
                v = self._values.get(s, 0.0)
                c = self._counts.get(s, 0) + 1
                self._values[s] = v + (g - v) / c
                self._counts[s] = c
        return self._values.get(state, 0.0)

    def __call__(self, state) -> float:
        return self.state_value(state)

    def reset(self, clear_state_values: bool = False) -> None:
        if clear_state_values:
            self._values.clear()
            self._counts.clear()


class EstimatedStateValueFunction:
    """MC-estimated V(s) for every state, computed eagerly.

    Reference: reagent/ope/trainers/rl_tabular_trainers.py:120-155
    (EstimatedStateValueFunction) — for each state, average the discounted
    return of ``num_episodes`` sampled episodes.
    """

    def __init__(
        self,
        policy: TabularPolicy,
        mdp,
        gamma: float = 0.99,
        num_episodes: int = 100,
        max_steps: int = 100,
        seed: int = 0,
    ):
        self.policy = policy
        self.mdp = mdp
        self.gamma = gamma
        self.num_episodes = num_episodes
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._values: Optional[Dict] = None

    def _estimate(self) -> None:
        self._values = {}
        for state in self.mdp.states:
            total = 0.0
            for _ in range(self.num_episodes):
                steps = generate_episode(
                    self.mdp, self.policy, state, self._rng, self.max_steps
                )
                discount, ret = 1.0, 0.0
                for _, _, r in steps:
                    ret += discount * r
                    discount *= self.gamma
                total += ret
            self._values[state] = total / self.num_episodes

    def state_value(self, state) -> float:
        if self._values is None:
            self._estimate()
        return self._values.get(state, 0.0)

    def __call__(self, state) -> float:
        return self.state_value(state)

    def reset(self) -> None:
        self._values = None
