"""Slate-ranking serving wrappers: the DPP re-ranker and the Seq2Slate,
slate-reward and ranking-actor modules with their preprocessors.

Port of ``reagent_tpu/prediction/ranking/predictor_wrapper.py``
(``DeterminantalPointProcessPredictorWrapper`` :32, ``SlateRankingPreprocessor``
:110, ``Seq2SlateWithPreprocessor`` :136, ``Seq2SlatePredictorWrapper`` :182,
``Seq2SlateRewardWithPreprocessor`` :199, ``RankingActorWithPreprocessor``
:252, ``RankingActorPredictorWrapper`` :293; reference reagent/prediction/
ranking/predictor_wrapper.py:21-126 and prediction/predictor_wrapper.py:376-826).

The DPP's greedy MAP keeps JAX's incremental-Cholesky form (Chen et al.
2018: each item's marginal log-det gain is ``log d_i^2``, updated in O(n) a
pick), in float32, the first maximum on ties, one loop step a slate
position.  Each wrapper runs without a graph; ``params`` None runs a
module's own parameters.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.seq2slate import Seq2SlateMode
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor


class Kernel(enum.Enum):
    Linear = "linear"
    RBF = "rbf"


MIN_VALUE = -3.4e38


class DeterminantalPointProcessPredictorWrapper:
    def __init__(self, alpha: float, kernel: Kernel = Kernel.Linear, sigma: float = 1.0,
                 rerank_topk: Optional[int] = None) -> None:
        if rerank_topk is not None and rerank_topk <= 0:
            raise ValueError(f"rerank_topk must be positive: {rerank_topk}")
        self.alpha = alpha
        self.kernel = kernel
        self.sigma = sigma
        self.rerank_topk = rerank_topk

    def _build_kernel(self, quality_scores: Tensor, feature_vectors: Tensor) -> Tensor:
        q = quality_scores.to(torch.float32)
        f = feature_vectors.to(torch.float32)
        f = f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True), min=1e-12)
        n = q.shape[0]
        if self.kernel == Kernel.Linear:
            b = (self.alpha ** 0.5) * q * f
            L = b @ b.T
            idx = torch.arange(n, device=L.device)
            L[idx, idx] = q.reshape(-1) ** 2
        elif self.kernel == Kernel.RBF:
            d2 = torch.sum((f[:, None, :] - f[None, :, :]) ** 2, dim=-1)
            L = self.alpha * (q @ q.T) * torch.exp(-d2 / (2 * self.sigma ** 2))
        else:
            raise NotImplementedError(self.kernel)
        return L

    @torch.no_grad()
    def __call__(self, quality_scores: Tensor, feature_vectors: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
        """(num_items, 1) scores and (num_items, F) features -> (the chosen
        order, each step's marginal gains [k, n], the kernel L)."""
        L = self._build_kernel(quality_scores, feature_vectors)
        n = L.shape[0]
        k = min(self.rerank_topk or n, n)
        dev = L.device
        d2 = torch.diagonal(L).clone()
        C = torch.zeros((n, k), device=dev)
        chosen_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        chosen, dets = [], []
        for t in range(k):
            gains = torch.where(chosen_mask, MIN_VALUE, d2)
            j = torch.argmax(gains)
            # c_i := (L_ij - <c_i, c_j>) / d_j for every i; where the kernel
            # is rank-deficient d_j ~ 0 and every remaining gain is ~0: skip
            dj = d2[j]
            e = torch.where(dj < 1e-10, 0.0,
                            (L[:, j] - C @ C[j]) / torch.sqrt(torch.clamp(dj, min=1e-12)))
            C[:, t] = e
            d2 = torch.clamp(d2 - e ** 2, min=0.0)
            chosen_mask[j] = True
            chosen.append(j)
            dets.append(gains)
        order = torch.stack(chosen)
        if k < n:
            # the unchosen items after, in their order (ref :75-78)
            order = torch.cat([order, torch.nonzero(~chosen_mask)[:, 0]])
        return order, torch.stack(dets), L


class SlateRankingPreprocessor:
    """Raw (state, candidates) features -> dense inputs (reference
    prediction/predictor_wrapper.py:495-545): the candidates flattened to
    [B * C, F] for one preprocessor call, then reshaped back."""

    def __init__(self, state_preprocessor, candidate_preprocessor, candidate_size: int):
        self.state_preprocessor = state_preprocessor
        self.candidate_preprocessor = candidate_preprocessor
        self.candidate_size = candidate_size

    @torch.no_grad()
    def __call__(self, state_vp, candidate_vp):
        B, C, F = candidate_vp[0].shape
        state = self.state_preprocessor(*state_vp)
        cand = self.candidate_preprocessor(
            candidate_vp[0].reshape(B * C, F), candidate_vp[1].reshape(B * C, F)
        ).reshape(B, C, -1)
        return state, cand


class Seq2SlateWithPreprocessor:
    """Preprocessing and a greedy or sampled Seq2Slate rank (reference
    prediction/predictor_wrapper.py:548-614).  ``model`` is a
    ``Seq2SlateTransformerNet``; a sampled rank takes gumbel draws or a
    generator and raises without either."""

    def __init__(self, model, params, state_preprocessor, candidate_preprocessor,
                 greedy: bool):
        self.model = model
        self.params = params
        self.greedy = greedy
        self.preprocessor = SlateRankingPreprocessor(
            state_preprocessor, candidate_preprocessor, model.seq2slate.max_src_seq_len)

    @torch.no_grad()
    def __call__(self, state_vp, candidate_vp, gumbel: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        if not self.greedy and gumbel is None and generator is None:
            raise ValueError("sampled ranking needs gumbel draws or a generator")
        state, candidates = self.preprocessor(state_vp, candidate_vp)
        res = functional.apply(
            self.model.seq2slate, self.params, Seq2SlateMode.RANK_MODE.value, state, candidates,
            tgt_seq_len=candidates.shape[1], greedy=self.greedy, gumbel=gumbel,
            generator=generator)
        return res.ranked_per_symbol_probs, res.ranked_per_seq_probs, res.ranked_tgt_out_idx


class Seq2SlatePredictorWrapper:
    """The serving facade: (per-sequence propensity, 0-based ranked indices)
    (reference prediction/predictor_wrapper.py:616-640; the -2 removes the
    padding and start symbols)."""

    def __init__(self, seq2slate_with_preprocessor: Seq2SlateWithPreprocessor):
        self.model = seq2slate_with_preprocessor

    def __call__(self, state_vp, candidate_vp, gumbel: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        _, per_seq, idx = self.model(state_vp, candidate_vp, gumbel, generator)
        return per_seq, idx - 2


class Seq2SlateRewardWithPreprocessor:
    """The first ``max_tgt_seq_len`` candidates scored by a slate reward net
    (reference prediction/predictor_wrapper.py:740-826)."""

    def __init__(self, model: nn.Module, params, max_src_seq_len: int, max_tgt_seq_len: int,
                 state_preprocessor=None, candidate_preprocessor=None):
        self.model = model
        self.params = params
        self.max_src_seq_len = max_src_seq_len
        self.max_tgt_seq_len = max_tgt_seq_len
        self.state_preprocessor = state_preprocessor
        self.candidate_preprocessor = candidate_preprocessor

    @torch.no_grad()
    def __call__(self, state_vp, candidate_vp) -> Tensor:
        B = state_vp[0].shape[0]
        state = (self.state_preprocessor(*state_vp) if self.state_preprocessor is not None
                 else state_vp[0])
        if self.candidate_preprocessor is not None:
            C, F = candidate_vp[0].shape[1], candidate_vp[0].shape[2]
            candidates = self.candidate_preprocessor(
                candidate_vp[0].reshape(B * C, F), candidate_vp[1].reshape(B * C, F)
            ).reshape(B, C, -1)
        else:
            candidates = candidate_vp[0]
        # the slate of the first max_tgt_seq_len candidates (ref :786-812)
        T = self.max_tgt_seq_len
        tgt_out_idx = torch.arange(T, device=candidates.device)[None, :].expand(B, T)
        ranking_input = rlt.PreprocessedRankingInput(
            state=rlt.FeatureData(float_features=state),
            src_seq=rlt.FeatureData(float_features=candidates),
            tgt_out_seq=rlt.FeatureData(float_features=candidates[:, :T]),
            tgt_out_idx=tgt_out_idx + 2,
        )
        out = functional.apply(self.model, self.params, ranking_input)
        return out[:, 0] if out.ndim == 2 else out


class RankingActorWithPreprocessor:
    """An actor over (state, candidate docs) with a preprocessor each
    (reference prediction/predictor_wrapper.py:376-424)."""

    def __init__(self, model: nn.Module, params, state_preprocessor, candidate_preprocessor,
                 num_candidates: int, action_postprocessor=None):
        self.model = model
        self.params = params
        self.state_preprocessor = state_preprocessor
        self.candidate_preprocessor = candidate_preprocessor
        self.num_candidates = num_candidates
        self.action_postprocessor = action_postprocessor

    @torch.no_grad()
    def __call__(self, state_vp, candidate_vp) -> Tensor:
        B, C, F = candidate_vp[0].shape
        if C != self.num_candidates:
            raise ValueError(f"{C} candidates, the actor takes {self.num_candidates}")
        state = self.state_preprocessor(*state_vp)
        candidates = self.candidate_preprocessor(
            candidate_vp[0].reshape(B * C, F), candidate_vp[1].reshape(B * C, F)
        ).reshape(B, C, -1)
        feat = rlt.FeatureData(float_features=state,
                               candidate_docs=rlt.DocList(float_features=candidates))
        out = functional.apply(self.model, self.params, feat)
        action = out.action if hasattr(out, "action") else out
        if self.action_postprocessor is not None:
            action = self.action_postprocessor(action)
        return action


class RankingActorPredictorWrapper:
    """The serving facade over ``RankingActorWithPreprocessor`` (reference
    :427-450)."""

    def __init__(self, actor_with_preprocessor: RankingActorWithPreprocessor,
                 action_feature_ids: Optional[list] = None):
        self.model = actor_with_preprocessor
        self.action_feature_ids = action_feature_ids or []

    def __call__(self, state_vp, candidate_vp) -> Tensor:
        return self.model(state_vp, candidate_vp)
