"""Synthetic-reward net over dense and sparse (ID-list) features.

Port of ``reagent_tpu/models/synthetic_reward_sparse.py``
(``SparseArchSyntheticRewardNet`` :31, ``SyntheticRewardSparseArchNet``
:99; reference reagent/models/synthetic_reward_sparse_arch.py:43-299): a
dense tower MLP(cat(state, action)) -> F, one embedding bag a sparse feature
-> F each (the port's ``EmbeddingBag``, hashed ids, mean pooling), the
pairwise dot products of those ``K`` vectors (DLRM's interaction, the upper
triangle in row order) beside the dense tower's output, then an over-arch
MLP to one per-step scalar and ``last_layer_activation``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.embedding_bag import EmbeddingBag
from reagent_tpu_torch.models.fully_connected_network import (
    FullyConnectedNetwork,
    apply_activation,
)
from reagent_tpu_torch.models.synthetic_reward import (
    SyntheticRewardNetworkOutput,
    gen_mask,
)

Tensor = torch.Tensor


class SparseArchSyntheticRewardNet(nn.Module):
    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        dense_sizes: Sequence[int],
        dense_activations: Sequence[str],
        overall_sizes: Sequence[int],
        overall_activations: Sequence[str],
        embedding_configs: Tuple[Tuple[str, int, int], ...],  # (name, vocab, F)
        last_layer_activation: str = "sigmoid",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        f_dim = dense_sizes[-1]
        for name, _, dim in embedding_configs:
            if dim != f_dim:
                raise ValueError("sparse embedding dim must match dense tower output "
                                 f"({name}: {dim} != {f_dim})")
        self.embedding_configs = tuple(tuple(c) for c in embedding_configs)
        self.last_layer_activation = last_layer_activation
        self.dense = FullyConnectedNetwork([state_dim + action_dim, *dense_sizes],
                                           list(dense_activations), generator=generator)
        self.bags = nn.ModuleDict({name: EmbeddingBag(vocab, dim)
                                   for name, vocab, dim in self.embedding_configs})
        k = 1 + len(self.embedding_configs)
        self.over = FullyConnectedNetwork([f_dim + k * (k - 1) // 2, *overall_sizes, 1],
                                          [*overall_activations, "linear"], generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.dense.reset_parameters(generator)
        for bag in self.bags.values():
            bag.reset_parameters(generator)
        self.over.reset_parameters(generator)

    def forward(self, state: Tensor, action: Tensor,
                id_list_features: Dict[str, rlt.IdListFeature]) -> Tensor:
        """state [T, B, S], action [T, B, A], ids [T, B, L] -> [B, T]."""
        T, B = action.shape[0], action.shape[1]
        dense = self.dense(torch.cat([state, action], dim=-1))  # [T, B, F]
        towers = [dense]
        for name, _, _ in self.embedding_configs:
            feat = id_list_features[name]
            flat = rlt.IdListFeature(ids=feat.ids.reshape(T * B, -1),
                                     mask=feat.mask.reshape(T * B, -1))
            towers.append(self.bags[name](flat).reshape(T, B, -1))
        stack = torch.stack(towers, dim=2)  # [T, B, K, F]
        inter = torch.einsum("tbkf,tblf->tbkl", stack, stack)
        iu, ju = torch.triu_indices(stack.shape[2], stack.shape[2], offset=1,
                                    device=stack.device)
        combined = torch.cat([dense, inter[:, :, iu, ju]], dim=-1)
        out = apply_activation(self.last_layer_activation, self.over(combined)[..., 0])
        return out.T


class SyntheticRewardSparseArchNet(nn.Module):
    """The masked sum over the last valid steps, the state's ID-list
    features passed through (ref :43-118)."""

    def __init__(self, net: SparseArchSyntheticRewardNet):
        super().__init__()
        self.net = net

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, batch: rlt.MemoryNetworkInput) -> SyntheticRewardNetworkOutput:
        state = batch.state.float_features
        action = batch.action.float_features
        T, B = action.shape[0], action.shape[1]
        output = self.net(state, action, batch.state.id_list_features or {})
        mask = gen_mask(batch.valid_step, B, T)
        pred = torch.sum(output * mask, dim=1, keepdim=True)
        return SyntheticRewardNetworkOutput(predicted_reward=pred, mask=mask, output=output)
