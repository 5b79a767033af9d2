"""Slate-ranking net builders.

Port of ``reagent_tpu/net_builder/slate_ranking.py`` (``SlateRankingTransformer``
:16, ``SlateRankingScorer`` :45; reference net_builder/slate_ranking/).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from reagent_tpu_torch.core.registry import SLATE_RANKING_NET_BUILDERS
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.seq2slate import Seq2SlateOutputArch, Seq2SlateTransformerModel


@SLATE_RANKING_NET_BUILDERS.register()
@dataclasses.dataclass
class SlateRankingTransformer:
    num_stacked_layers: int = 2
    num_heads: int = 2
    dim_model: int = 64
    dim_feedforward: int = 32
    output_arch: str = "autoregressive"
    temperature: float = 1.0
    compute_dtype: str = "float32"  # "bfloat16": activations in bf16, parameters f32

    def build_slate_ranking_network(
        self, state_dim: int, candidate_dim: int, candidate_size: int, slate_size: int
    ) -> Seq2SlateTransformerModel:
        return Seq2SlateTransformerModel(
            state_dim=state_dim,
            candidate_dim=candidate_dim,
            num_stacked_layers=self.num_stacked_layers,
            num_heads=self.num_heads,
            dim_model=self.dim_model,
            dim_feedforward=self.dim_feedforward,
            max_src_seq_len=candidate_size,
            max_tgt_seq_len=slate_size,
            output_arch=Seq2SlateOutputArch(self.output_arch),
            compute_dtype=getattr(torch, self.compute_dtype),
            temperature=self.temperature,
        )


@SLATE_RANKING_NET_BUILDERS.register()
@dataclasses.dataclass
class SlateRankingScorer:
    """A pointwise scorer ranked by sort (reference slate_ranking_scorer.py):
    a float32 dense critic, so ``training.functional.score`` runs its
    forward as one K3 launch on the card."""

    hidden_layers: List[int] = dataclasses.field(default_factory=lambda: [64, 32])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])

    def build_slate_ranking_network(
        self, state_dim: int, candidate_dim: int, candidate_size: int, slate_size: int
    ) -> FullyConnectedCritic:
        return FullyConnectedCritic(
            state_dim=state_dim,
            action_dim=candidate_dim,
            sizes=list(self.hidden_layers),
            activations=list(self.activations),
        )
