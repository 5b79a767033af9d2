"""Frechet-sort: differentiable stochastic ranking policy.

Port of ``reagent_tpu/samplers/frechet.py`` (reference
reagent/samplers/frechet.py:19-160): perturb (log-)scores with Gumbel(0,
1/shape) noise, argsort descending; the log-prob of a permutation is the
Plackett-Luce chain sum of successive masked log-softmax heads.

JAX draws the standard Gumbel noise from a key (``jax.random.gumbel`` at
``frechet.py:45``); here ``sample_action`` takes it as a value (``noise``,
``[B, N]``) or draws it from ``generator``.  The sort is stable, as
``jnp.argsort``: of two equal perturbed scores the lower index ranks first.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.mab.mab_algorithm import gumbel

Tensor = torch.Tensor


class FrechetSort:
    EPS = 1e-12

    def __init__(
        self,
        shape: float = 1.0,
        topk: Optional[int] = None,
        equiv_len: Optional[int] = None,
        log_scores: bool = False,
    ):
        self.shape = shape
        self.topk = topk
        self.upto = equiv_len
        if topk is not None:
            if equiv_len is None:
                self.upto = topk
            if self.upto is not None and self.upto > topk:
                raise ValueError(f"Equiv length {equiv_len} cannot exceed topk={topk}.")
        self.log_scores = log_scores

    def sample_action(self, scores: Tensor, noise: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> rlt.ActorOutput:
        """scores [B, N] -> permutation [B, N] (or the topk prefix); ``noise``
        the [B, N] standard Gumbel draws, else drawn from ``generator`` on
        the scores' device."""
        assert scores.ndim == 2, "sample_action only accepts batches"
        if noise is None:
            noise = gumbel(scores.shape, generator, scores.device)
        log_scores = scores if self.log_scores else torch.log(scores)
        perturbed = log_scores + noise.to(scores.dtype) / self.shape
        action = torch.argsort(-perturbed, dim=1, stable=True)
        log_prob = self.log_prob(scores, action)
        if self.topk is not None:
            action = action[:, : self.topk]
        return rlt.ActorOutput(action=action, log_prob=log_prob)

    def log_prob(
        self,
        scores: Tensor,
        action: Tensor,
        equiv_len_override: Optional[Union[int, Tensor]] = None,
    ) -> Tensor:
        """Plackett-Luce log-prob of the top-``upto`` prefix (ref frechet.py:90)."""
        if scores.ndim == 1:
            scores = scores[None]
            action = action[None]
        n = scores.shape[1]
        assert action.shape[1] == n, (
            f"action must cover all {n} scores; pad shorter slates with index {n}"
        )
        log_scores = scores if self.log_scores else torch.log(scores)
        # padding slot: -inf score at index n
        padded = torch.cat(
            [log_scores, torch.full((log_scores.shape[0], 1), -torch.inf,
                                    dtype=log_scores.dtype, device=log_scores.device)], dim=1)
        s = torch.gather(padded, 1, action.long()) * self.shape

        upto = self.upto if equiv_len_override is None else equiv_len_override
        p = upto if upto is not None else n

        def head_logprob(i):
            # log softmax over the remaining tail, take the head
            lp = torch.log_softmax(s[:, i:], dim=1)[:, 0]
            return torch.nan_to_num(lp, neginf=0.0)

        if isinstance(p, int):
            return sum(head_logprob(i) for i in range(p))
        p = torch.as_tensor(p, device=s.device)
        return sum(head_logprob(i) * (i < p).to(torch.float32) for i in range(n))
