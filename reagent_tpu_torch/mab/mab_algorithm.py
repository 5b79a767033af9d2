"""MAB base: per-arm sufficient statistics and the batch-update API.

Port of ``reagent_tpu/mab/mab_algorithm.py`` (reference
reagent/mab/mab_algorithm.py:103 ``MABAlgo``): arms are tracked by id on the
host, batch observations fold (n, sum of rewards, sum of squared rewards)
per arm into a ``MABState`` of tensors, and scores come from those sums.

JAX draws its randomness from keys.  Here every random choice takes its
draws as values or from a ``torch.Generator``: ``randomized_argmax`` and
``get_action`` take the gumbels of JAX's ``jax.random.categorical`` (the
argmax of gumbels plus logits), and an algorithm's ``get_scores`` takes the
draws it samples from (``RandomActionsAlgo``'s uniforms, a Thompson
posterior's draws).  ``action_index`` picks an arm on the device with no
read of the host, so a simulation keeps its state on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core.types import _TensorDataClass
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
_TINY = torch.finfo(torch.float32).tiny
# Marsaglia-Tsang proposals drawn at once for each gamma draw
_GAMMA_ROUNDS = 16


@dataclasses.dataclass
class MABState(_TensorDataClass):
    total_n_obs_per_arm: Tensor  # [K]
    total_sum_reward_per_arm: Tensor  # [K]
    total_sum_reward_squared_per_arm: Tensor  # [K]
    # per-algorithm statistics (the NormalGamma posterior's)
    extra: Optional[Dict[str, Tensor]] = None

    @property
    def total_n_obs_all_arms(self) -> Tensor:
        return self.total_n_obs_per_arm.sum()


def gumbel(shape, generator: Optional[torch.Generator] = None, device="cuda") -> Tensor:
    """Standard gumbel draws as ``jax.random.gumbel``: -log(-log(u)), u
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=resolve_device(device))
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def standard_gamma(alpha: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
    """Gamma(alpha, 1) draws from ``generator`` (Marsaglia and Tsang 2000):
    ``_GAMMA_ROUNDS`` proposals an entry at once, the first accepted kept
    (each is accepted with probability above 0.95 for alpha >= 1), and
    alpha < 1 boosted by ``u^(1/alpha)``."""
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn((_GAMMA_ROUNDS, *alpha.shape), generator=generator, device=alpha.device)
    u = torch.rand((_GAMMA_ROUNDS, *alpha.shape), generator=generator, device=alpha.device)
    v = torch.clamp((1.0 + c * x) ** 3, min=_TINY)
    ok = (1.0 + c * x > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
    first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
    sample = d * torch.gather(v, 0, first)[0]
    w = torch.rand(alpha.shape, generator=generator, device=alpha.device)
    return torch.where(boost, sample * w ** (1.0 / alpha), sample)


def _pick(g: Tensor, weights: Tensor) -> Tensor:
    """``jax.random.categorical`` over ``log(w / sum(w))`` given its gumbels."""
    w = weights.to(torch.float32)
    return torch.argmax(g + torch.log(w / w.sum()))


def randomized_argmax(x: Tensor, gumbels: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Tensor:
    """Argmax with uniform tie-breaking (reference mab_algorithm.py:78)."""
    g = gumbels if gumbels is not None else gumbel(x.shape, generator, x.device)
    return _pick(g, x == x.max())


class MABAlgo:
    """Base: holds arm ids on the host; all math on the ``MABState``."""

    def __init__(self, n_arms: Optional[int] = None, arm_ids: Optional[Sequence[str]] = None):
        if arm_ids is not None:
            self.arm_ids: List[str] = list(arm_ids)
        else:
            assert n_arms is not None
            self.arm_ids = [str(i) for i in range(n_arms)]
        self.n_arms = len(self.arm_ids)
        self._id2idx = {a: i for i, a in enumerate(self.arm_ids)}

    def init(self, device="cuda") -> MABState:
        K = self.n_arms
        device = resolve_device(device)
        return MABState(
            total_n_obs_per_arm=torch.zeros(K, device=device),
            total_sum_reward_per_arm=torch.zeros(K, device=device),
            total_sum_reward_squared_per_arm=torch.zeros(K, device=device),
            extra=self.init_extra(device),
        )

    def init_extra(self, device="cuda") -> Optional[Dict[str, Tensor]]:
        return None

    def add_batch_observations(self, state: MABState, n_obs_per_arm: Tensor,
                               sum_reward_per_arm: Tensor,
                               sum_reward_squared_per_arm: Tensor) -> MABState:
        """Reference mab_algorithm.py:126."""
        return state.replace(
            total_n_obs_per_arm=state.total_n_obs_per_arm + n_obs_per_arm,
            total_sum_reward_per_arm=state.total_sum_reward_per_arm + sum_reward_per_arm,
            total_sum_reward_squared_per_arm=(
                state.total_sum_reward_squared_per_arm + sum_reward_squared_per_arm),
        )

    def add_single_observation(self, state: MABState, arm_id: str, reward: float) -> MABState:
        device = state.total_n_obs_per_arm.device
        onehot = F.one_hot(torch.tensor(self._id2idx[arm_id], device=device),
                           self.n_arms).to(torch.float32)
        return self.add_batch_observations(state, onehot, onehot * reward, onehot * reward ** 2)

    def get_avg_reward_values(self, state: MABState) -> Tensor:
        return state.total_sum_reward_per_arm / torch.clamp(state.total_n_obs_per_arm, min=1e-12)

    def get_scores(self, state: MABState, draws: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Tensor:
        """[K] scores; ``draws`` are the values a random algorithm samples
        from, else it draws them from ``generator``."""
        raise NotImplementedError

    def action_index(self, state: MABState, gumbels: Optional[Tensor] = None,
                     score_draws: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Tensor:
        """The arm's index as a device scalar: an unseen arm first, uniformly
        among them, else the randomized argmax of the scores (reference
        :167-179).  ``gumbels`` serve both choices, as JAX's one key ``r1``
        does; the scores are computed either way and read only where every
        arm was seen."""
        unseen = state.total_n_obs_per_arm == 0
        g = gumbels if gumbels is not None else gumbel(
            (self.n_arms,), generator, unseen.device)
        scores = self.get_scores(state, score_draws, generator)
        return _pick(g, torch.where(unseen.any(), unseen, scores == scores.max()))

    def get_action(self, state: MABState, gumbels: Optional[Tensor] = None,
                   score_draws: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> str:
        return self.arm_ids[int(self.action_index(state, gumbels, score_draws, generator))]

    def forward(self, state: MABState, draws: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        return self.get_scores(state, draws, generator)


class RandomActionsAlgo(MABAlgo):
    def get_scores(self, state, draws=None, generator=None):
        if draws is not None:
            return draws
        return torch.rand(self.n_arms, generator=generator,
                          device=state.total_n_obs_per_arm.device)


class GreedyAlgo(MABAlgo):
    def get_scores(self, state, draws=None, generator=None):
        return self.get_avg_reward_values(state)

