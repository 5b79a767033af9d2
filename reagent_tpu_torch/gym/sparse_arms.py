"""The sparse changing-arms Q-network: ``ChangingArms``' observation as dense
and ID-list features.

Port of the network and mask of the JAX package's sparse changing-arms DQN
job (``tests/test_sparse_models.py:157-251``; reference
gym/tests/configs/sparse/discrete_dqn_changing_arms_online.yaml).  The
observation ``[mus, legal, changes]`` (``3K``) is re-expressed as the dense
``[mus, changes]`` and the ID list of the legal arms (ids ``0..K-1``, masked
by ``legal``), which feed a ``SparseDQN``.  Its act step runs the bag concat
in torch and the dense overarch as one K3 launch
(``training/functional.py::score``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.embedding_bag import SparseDQN

Tensor = torch.Tensor


def legal_actions_mask(obs: Tensor, num_arms: int) -> Tensor:
    """float32 ``[..., K + 1]``: the legal arms of ``obs [..., 3K]``, and the
    always-legal pass."""
    legal = obs[..., num_arms:2 * num_arms] > 0.5
    always_pass = torch.ones(obs.shape[:-1] + (1,), dtype=torch.bool, device=obs.device)
    return torch.cat([legal, always_pass], dim=-1).to(torch.float32)


class ArmsSparseQNet(nn.Module):
    """``obs [B, 3K]`` -> ``FeatureData(dense [mus, changes], id-list
    "legal")`` -> ``SparseDQN`` -> Q ``[B, K + 1]``; the table of
    ``"legal"`` has ``K + 1`` rows, the ids are hashed into it (``SparseDQN``'s
    bags hash, as JAX's)."""

    overarch_prefix = "sparse_dqn.net"  # the dense chain K3 runs

    def __init__(self, num_arms: int = 5, embedding_dim: int = 8,
                 overarch_dims: Sequence[int] = (64,), activation: str = "leaky_relu"):
        super().__init__()
        self.num_arms = num_arms
        self.sparse_dqn = SparseDQN(
            state_dense_dim=2 * num_arms, action_dim=num_arms + 1,
            configs=(("legal", num_arms + 1, embedding_dim),),
            overarch_dims=list(overarch_dims), activation=activation)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.sparse_dqn.reset_parameters(generator)

    def state_of(self, obs: Tensor) -> rlt.FeatureData:
        K = self.num_arms
        mus, legal, changes = obs[:, :K], obs[:, K:2 * K], obs[:, 2 * K:]
        ids = torch.arange(K, device=obs.device).expand(obs.shape[0], K)
        return rlt.FeatureData(
            float_features=torch.cat([mus, changes], dim=1),
            id_list_features={"legal": rlt.IdListFeature(ids=ids, mask=legal > 0.5)})

    def overarch_input(self, obs: Tensor) -> Tensor:
        return self.sparse_dqn.overarch_input(self.state_of(obs))

    def forward(self, obs: Tensor, training: bool = False) -> Tensor:
        return self.sparse_dqn(self.state_of(obs), training=training)
