"""MLP slate scorer: a score per candidate.

Port of ``reagent_tpu/models/mlp_scorer.py:17`` (reference
reagent/models/mlp_scorer.py:12-41).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork


class MLPScorer(nn.Module):
    """Scores each candidate doc with an MLP ([B, D, cdim] -> [B, D]), or,
    with ``has_user_feat``, the user's features and every doc concatenated
    as one vector ([B, user + docs] -> [B])."""

    def __init__(self, input_dim: int, sizes: Sequence[int], activations: Sequence[str],
                 has_user_feat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.has_user_feat = has_user_feat
        self.net = FullyConnectedNetwork([input_dim, *sizes, 1], [*activations, "linear"],
                                         generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, obs: rlt.FeatureData) -> torch.Tensor:
        return self.net(obs.get_ranking_state(self.has_user_feat)).squeeze(-1)
