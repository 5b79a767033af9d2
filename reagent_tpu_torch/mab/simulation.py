"""Bandit simulation and benchmark loops.

Port of ``reagent_tpu/mab/simulation.py`` (reference
reagent/mab/simulation.py:18-225): the ``BernoulliMAB`` environment and the
per-algorithm loops that collect regret trajectories.

JAX splits one key a step into the action's key (whose first half gives the
gumbels of its categorical choices, the second the scores' draws) and the
reward's (a uniform under the arm's probability).  Here a run takes those
draws as values, ``draws={"gumbels": [T, K], "uniforms": [T],
"scores": [T, ...]}`` (``scores`` only for an algorithm that samples); the
ones not given come from a ``torch.Generator`` seeded with ``seed``.  The
state, the pending sums and the regrets stay on the bandit's device; the
loop reads nothing back until the trajectory is returned.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Type

import numpy as np
import torch
import torch.nn.functional as F

from reagent_tpu_torch.mab.mab_algorithm import MABAlgo
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class MAB:
    """Synthetic bandit environment base (reference simulation.py:24)."""

    def __init__(self, max_steps: int, expected_rewards, arm_ids=None, device="cuda"):
        self.max_steps = max_steps
        self.expected_rewards = torch.as_tensor(expected_rewards, dtype=torch.float32,
                                                device=resolve_device(device))
        self.n_arms = self.expected_rewards.shape[0]
        self.arm_ids = arm_ids or [str(i) for i in range(self.n_arms)]
        self.best_action_value = float(self.expected_rewards.max())
        self.t = 0

    def act(self, arm_id: str, uniform: Optional[Tensor] = None,
            generator: Optional[torch.Generator] = None) -> float:
        raise NotImplementedError


class BernoulliMAB(MAB):
    """Bernoulli rewards with per-arm success probabilities (reference :58)."""

    def __init__(self, max_steps: int, probs, arm_ids=None, device="cuda"):
        super().__init__(max_steps, probs, arm_ids, device)
        assert float(self.expected_rewards.max()) <= 1.0
        assert float(self.expected_rewards.min()) >= 0.0

    def reward_of(self, idx: Tensor, uniform: Tensor) -> Tensor:
        """``jax.random.bernoulli``: 1.0 where the uniform falls under the
        arm's probability."""
        return (uniform < torch.take(self.expected_rewards, idx)).to(torch.float32)

    def act(self, arm_id, uniform=None, generator=None):
        if uniform is None:
            uniform = torch.rand((), generator=generator, device=self.expected_rewards.device)
        idx = torch.tensor(self.arm_ids.index(arm_id), device=self.expected_rewards.device)
        return float(self.reward_of(idx, uniform))


def single_evaluation_bandit_algo(bandit: MAB, algo: MABAlgo, seed: int = 0,
                                  update_every: int = 1,
                                  draws: Optional[Dict[str, Tensor]] = None) -> np.ndarray:
    """Run one bandit-vs-algo episode, return the cumulative pseudo-regret
    trajectory [max_steps] (reference simulation.py:70-120)."""
    device = bandit.expected_rewards.device
    generator = torch.Generator(device=device).manual_seed(seed)  # the draws not fed
    draws = draws or {}
    T, K = bandit.max_steps, algo.n_arms
    state = algo.init(device)
    pending = torch.zeros((3, K), device=device)  # n, sum, sum of squares
    chosen = torch.empty(T, dtype=torch.int64, device=device)
    scores = draws.get("scores")
    for t in range(T):
        g = draws["gumbels"][t] if "gumbels" in draws else None
        u = draws["uniforms"][t] if "uniforms" in draws else torch.rand(
            (), generator=generator, device=device)
        idx = algo.action_index(state, g, None if scores is None else scores[t], generator)
        chosen[t] = idx
        reward = bandit.reward_of(idx, u)
        onehot = F.one_hot(idx, K).to(torch.float32)
        pending = pending + onehot * torch.stack([torch.ones_like(reward), reward, reward ** 2])[
            :, None]
        if (t + 1) % update_every == 0:
            state = algo.add_batch_observations(state, pending[0], pending[1], pending[2])
            pending = torch.zeros_like(pending)
    p = bandit.expected_rewards.to(torch.float64)
    regrets = bandit.best_action_value - p[chosen]
    return torch.cumsum(regrets, 0).cpu().numpy()


def compare_bandit_algos(algo_clss: Sequence[Type[MABAlgo]], bandit: MAB, n_trials: int = 5,
                         update_every: int = 1) -> Dict[str, np.ndarray]:
    """Mean cumulative-regret trajectory per algorithm (reference :150-225)."""
    results = {}
    for cls in algo_clss:
        trajs = [single_evaluation_bandit_algo(bandit, cls(n_arms=bandit.n_arms), seed=s,
                                               update_every=update_every)
                 for s in range(n_trials)]
        results[cls.__name__] = np.mean(np.stack(trajs), axis=0)
    return results
