"""Thompson-sampling bandits.

Port of ``reagent_tpu/mab/thompson_sampling.py`` (reference
reagent/mab/thompson_sampling.py:13-130).  ``get_scores`` takes its draws as
values or from a ``torch.Generator``: ``BernoulliBetaThompson`` its Beta
posterior's draws [K]; ``NormalGammaThompson`` a [2, K] tensor, standard
gamma draws at the posterior's shapes (JAX's ``gamma(r1, alpha_0)``) over
standard normal draws (``normal(r2, K)``).
"""

from __future__ import annotations

from typing import Dict

import torch

from reagent_tpu_torch.mab.mab_algorithm import MABAlgo, MABState, standard_gamma

Tensor = torch.Tensor


class BaseThompsonSampling(MABAlgo):
    def _posterior_samples(self, state: MABState, generator) -> Tensor:
        raise NotImplementedError

    def _posterior_of(self, state: MABState, draws: Tensor) -> Tensor:
        raise NotImplementedError

    def get_scores(self, state, draws=None, generator=None):
        if draws is not None:
            return self._posterior_of(state, draws)
        return self._posterior_samples(state, generator)


class BernoulliBetaThompson(BaseThompsonSampling):
    """Beta(1 + successes, 1 + failures) posterior (reference :22-35)."""

    def _posterior_of(self, state, draws):
        return draws

    def _posterior_samples(self, state, generator):
        alpha = 1.0 + state.total_sum_reward_per_arm
        beta = 1.0 + state.total_n_obs_per_arm - state.total_sum_reward_per_arm
        x = standard_gamma(alpha, generator)
        return x / (x + standard_gamma(beta, generator))


class NormalGammaThompson(BaseThompsonSampling):
    """Normal-Gamma conjugate posterior for gaussian rewards (reference :38-130)."""

    def __init__(self, n_arms=None, arm_ids=None):
        super().__init__(n_arms=n_arms, arm_ids=arm_ids)
        self.lambda_0 = 1.0  # pseudo-observations for the prior mean

    def init_extra(self, device="cuda") -> Dict[str, Tensor]:
        K = self.n_arms
        return {
            "mus": torch.zeros(K, device=device),
            "alpha_0": torch.full((K,), 1.5, device=device),  # shape
            "betas": torch.full((K,), 0.5, device=device),  # rate
            "lambdas": torch.full((K,), self.lambda_0, device=device),
        }

    def add_batch_observations(self, state, n_obs_per_arm, sum_reward_per_arm,
                               sum_reward_squared_per_arm):
        n = n_obs_per_arm
        zero = torch.zeros_like(n)
        mean_rewards = torch.where(n > 0, sum_reward_per_arm / torch.clamp(n, min=1e-12), zero)
        extra = state.extra
        lambdas, mus = extra["lambdas"], extra["mus"]
        new_mus = torch.where(n > 0, (lambdas * mus + n * mean_rewards) / (lambdas + n), mus)
        # the standard Normal-Gamma update
        ssq = sum_reward_squared_per_arm - n * mean_rewards ** 2
        new_betas = extra["betas"] + 0.5 * ssq + (
            lambdas * n * (mean_rewards - mus) ** 2) / (2.0 * (lambdas + n))
        new_extra = {
            "mus": new_mus,
            "alpha_0": extra["alpha_0"] + 0.5 * n,
            "betas": new_betas,
            "lambdas": lambdas + n,
        }
        state = super().add_batch_observations(
            state, n_obs_per_arm, sum_reward_per_arm, sum_reward_squared_per_arm)
        return state.replace(extra=new_extra)

    def _posterior_of(self, state, draws):
        extra = state.extra
        precisions = extra["lambdas"] * draws[0] / extra["betas"]
        return extra["mus"] + draws[1] / torch.sqrt(torch.clamp(precisions, min=1e-12))

    def _posterior_samples(self, state, generator):
        gammas = standard_gamma(state.extra["alpha_0"], generator)
        normals = torch.randn(self.n_arms, generator=generator, device=gammas.device)
        return self._posterior_of(state, torch.stack([gammas, normals]))
