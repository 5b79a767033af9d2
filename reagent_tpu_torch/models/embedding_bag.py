"""Sparse (ID-list) embedding models.

Port of ``reagent_tpu/models/embedding_bag.py`` (``hash_ids`` :28,
``EmbeddingBag`` :39, ``EmbeddingBagCollection`` :66,
``EmbeddingBagConcat`` :85, ``SparseDQN`` :101; reference:
reagent/models/sparse_dqn.py, embedding_bag_concat.py).  A jagged ID list
is a padded ``IdListFeature`` (ids and a mask); a bag gathers its rows and
pools them with a masked sum, divided by ``max(Σmask, 1)`` for ``"mean"``.

The tables are dense ``nn.Parameter``s with a dense gradient, trained by the
trainer's optimizer as flax's are, and each is named ``...bag_<name>.embedding``
as flax's ``bag_<name>/embedding``, so that a predicate on ``embedding``
(``optim.soft_update.soft_update_excluding``) picks the same leaves in both
packages.

Ids out of the table's range: JAX's gather ``table[ids]`` wraps a negative id
once (``-1`` is the last row) and clamps the rest into ``[0, size)``, where a
CUDA gather would assert on the device.  ``clamp_ids`` does what JAX does,
on the host's and the card's tensors alike.

Under a model-parallel step (``parallel/model_parallel.py``) a bag's table
holds one block of its rows (``row_shard``): the ids are hashed or clamped
against the global table size, an id outside the block contributes zero,
the masked sum is all-reduced over the model group (its backward the
identity: the ranks' upstream gradients are the same), and a mean divides
by the global count, which the replicated mask gives on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork

Tensor = torch.Tensor
EmbeddingConfigs = Tuple[Tuple[str, int, int], ...]  # (name, table_size, dim)

TABLE_INIT_STD = 0.01  # flax's nn.initializers.normal(0.01)
_U32 = 0xFFFFFFFF
_MIX = 0x45D9F3B


def hash_ids(raw_ids: Tensor, table_size: int, salt: int = 0) -> Tensor:
    """JAX's in-model mix hash into ``[0, table_size)``, bit for bit.

    JAX computes in ``uint32``: a negative ``int32`` id wraps into the
    ``uint32`` range, and each product wraps mod 2^32.  torch has no
    dependable ``uint32`` arithmetic on CUDA, so this computes in ``int64``
    and masks to 32 bits after each sum and product; a product of two
    values under 2^32 and 0x45D9F3B (< 2^27) stays under 2^63.  Returns
    ``int64`` rows (torch's index type)."""
    x = (raw_ids.to(torch.int64) + salt) & _U32
    x = ((x ^ (x >> 16)) * _MIX) & _U32
    x = ((x ^ (x >> 16)) * _MIX) & _U32
    x = x ^ (x >> 16)
    return torch.remainder(x, table_size)


def clamp_ids(ids: Tensor, table_size: int) -> Tensor:
    """JAX's gather indices: a negative id plus ``table_size`` once, then
    clamped into ``[0, table_size)``."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + table_size, ids).clamp(0, table_size - 1)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A table's rows ``[start, start + rows)`` on this rank, the rest on
    the other ranks of ``group``."""

    start: int
    rows: int
    group: Any


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group whose backward is the
    identity: every rank's upstream gradient is the gradient of the sum.
    (``torch.distributed.nn``'s all-reduce sums the ranks' identical
    upstream gradients again, which would scale the table's gradient by the
    group's size.)"""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class EmbeddingBag(nn.Module):
    """Pooled embedding of one padded ID-list feature: ``[B, L]`` ids ->
    ``[B, D]``.  ``row_shard`` set (by a model-parallel step) looks up this
    rank's block of rows and sums the pools over the model group."""

    row_shard: Optional[RowShard] = None

    def __init__(self, table_size: int, embedding_dim: int, pooling: str = "mean",
                 hashing: bool = True):
        super().__init__()
        if pooling not in ("mean", "sum"):
            raise ValueError(f"pooling {pooling!r}: 'mean' or 'sum'")
        self.table_size = table_size
        self.embedding_dim = embedding_dim
        self.pooling = pooling
        self.hashing = hashing
        self.embedding = nn.Parameter(torch.empty(table_size, embedding_dim))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            draw = torch.randn(self.embedding.shape, generator=generator)
            self.embedding.copy_(draw * TABLE_INIT_STD)

    def forward(self, feature: rlt.IdListFeature) -> Tensor:
        ids = (hash_ids(feature.ids, self.table_size) if self.hashing
               else clamp_ids(feature.ids, self.table_size))
        mask = feature.mask.to(torch.float32)[..., None]
        shard = self.row_shard
        if shard is None:
            emb = F.embedding(ids, self.embedding)  # [B, L, D], a dense gradient
            pooled = torch.sum(emb * mask, dim=1)
        else:
            local = ids - shard.start
            inside = (local >= 0) & (local < shard.rows)
            emb = F.embedding(torch.where(inside, local, 0), self.embedding)
            pooled = torch.sum(emb * (mask * inside[..., None].to(torch.float32)), dim=1)
            pooled = _SumOverGroup.apply(pooled, shard.group)
        if self.pooling == "mean":
            pooled = pooled / torch.clamp(torch.sum(mask, dim=1), min=1.0)
        return pooled


class EmbeddingBagCollection(nn.Module):
    """One bag per named sparse feature (torchrec's EBC), concatenated in
    the configs' order; bag ``name`` is the submodule ``bag_<name>``."""

    def __init__(self, configs: EmbeddingConfigs, hashing: bool = True):
        super().__init__()
        self.configs = tuple(tuple(c) for c in configs)
        for name, table_size, dim in self.configs:
            self.add_module(f"bag_{name}", EmbeddingBag(table_size, dim, hashing=hashing))

    def bag(self, name: str) -> EmbeddingBag:
        return getattr(self, f"bag_{name}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, _, _ in self.configs:
            self.bag(name).reset_parameters(generator)

    def forward(self, id_list_features: Dict[str, rlt.IdListFeature]) -> Tensor:
        return torch.cat([self.bag(name)(id_list_features[name])
                          for name, _, _ in self.configs], dim=1)


class EmbeddingBagConcat(nn.Module):
    """Dense features ++ pooled sparse embeddings (reference
    embedding_bag_concat.py)."""

    def __init__(self, state_dense_dim: int, configs: EmbeddingConfigs):
        super().__init__()
        self.state_dense_dim = state_dense_dim
        self.collection = EmbeddingBagCollection(configs)

    @property
    def output_dim(self) -> int:
        return self.state_dense_dim + sum(c[2] for c in self.collection.configs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.collection.reset_parameters(generator)

    def forward(self, state: rlt.FeatureData) -> Tensor:
        sparse = self.collection(state.id_list_features)
        return torch.cat([state.float_features, sparse], dim=1)


class SparseDQN(nn.Module):
    """Q-network over dense and sparse state features (reference
    sparse_dqn.py): the bag concat, then the dense overarch
    ``[dense + Σ dims, *overarch_dims, action_dim]`` with ``activation`` on
    each hidden layer.  ``overarch_input`` is the concat alone: the act step
    runs it in torch and the overarch, a dense chain, as one K3 launch
    (``training/functional.py::score``)."""

    overarch_prefix = "net"  # the dense chain K3 runs

    def __init__(
        self,
        state_dense_dim: int,
        action_dim: int,
        configs: EmbeddingConfigs,
        overarch_dims: Sequence[int],
        activation: str = "relu",
    ):
        super().__init__()
        self.state_dense_dim = state_dense_dim
        self.action_dim = action_dim
        self.concat = EmbeddingBagConcat(state_dense_dim, configs)
        self.net = FullyConnectedNetwork(
            [self.concat.output_dim, *overarch_dims, action_dim],
            [activation] * len(overarch_dims) + ["linear"],
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The tables (N(0, 0.01)), then the overarch."""
        self.concat.reset_parameters(generator)
        self.net.reset_parameters(generator)

    def overarch_input(self, state: rlt.FeatureData) -> Tensor:
        return self.concat(state)

    def forward(self, state: rlt.FeatureData, training: bool = False) -> Tensor:
        return self.net(self.concat(state), training=training)


# The jagged-feature ETL lives in preprocessing/sparse_preprocessor.py; it is
# re-exported here, as the JAX module does.
from reagent_tpu_torch.preprocessing.sparse_preprocessor import (  # noqa: E402,F401
    SparsePreprocessor,
    make_sparse_preprocessor,
)
