"""Augmented Random Search optimizer.

A numpy copy of ``reagent_tpu/training/gradient_free/ars_util.py``
(reference: reagent/training/gradient_free/ars_util.py:62-160; ARS of Mania
et al. 2018: antithetic perturbations, top-b ranking, reward-std scaling):
the same seed gives the same ``ars_params`` bit for bit.  Its checks raise
``ValueError`` where JAX's copy asserts.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class ARSOptimizer:
    """Maximizes an objective over a linear parameter vector."""

    def __init__(
        self,
        feature_dim: int,
        n_pert: int = 10,
        rand_ars_params: bool = False,
        alpha: float = 1.0,
        noise: float = 1.0,
        b_top: int = None,
        seed: int = 0,
    ) -> None:
        self.feature_dim = feature_dim
        self.rng = np.random.default_rng(seed)
        self.ars_params = (
            self.rng.normal(size=feature_dim) if rand_ars_params else np.zeros(feature_dim)
        )
        self.alpha = alpha
        self.noise = noise
        self.n_pert = n_pert
        self.b_top = b_top if b_top is not None else n_pert
        self.perturbations: List[np.ndarray] = []

    def sample_perturbed_params(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Antithetic (pos, neg) parameter pairs (reference :118-135)."""
        self.perturbations = []
        pairs = []
        for _ in range(self.n_pert):
            pert = self.rng.normal(size=self.feature_dim)
            self.perturbations.append(pert)
            pairs.append(
                (self.ars_params + self.noise * pert, self.ars_params - self.noise * pert)
            )
        return pairs

    def update_ars_params(self, rewards: np.ndarray) -> None:
        """rewards = [r_pert1_pos, r_pert1_neg, r_pert2_pos, ...] (reference :85-116)."""
        if not self.perturbations:
            raise ValueError("call sample_perturbed_params first")
        rewards = np.asarray(rewards).reshape(-1)
        if rewards.shape != (2 * self.n_pert,):
            raise ValueError(f"{rewards.shape[0]} rewards for {self.n_pert} perturbation pairs")
        rank = {}
        for i in range(self.n_pert):
            rp, rn = rewards[2 * i], rewards[2 * i + 1]
            rank[i] = max(rp, rn)
            self.perturbations[i] = self.perturbations[i] * (rp - rn)
        std_r = np.std(rewards)
        top = sorted(rank, key=rank.get, reverse=True)[: self.b_top]
        weight_sum = sum(self.perturbations[i] for i in top)
        self.ars_params = self.ars_params + self.alpha * weight_sum / (
            self.b_top * (std_r if std_r > 0 else 1.0)
        )
        self.perturbations = []
