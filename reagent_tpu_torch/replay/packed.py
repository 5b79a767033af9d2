"""Packed-row replay buffer: every field of a transition in one float32 row.

Port of ``reagent_tpu/replay/packed.py`` (``PackedReplayBuffer``,
``PackedReplayBufferState``, :41-228).  The row layout is the JAX package's:
fields sorted by name, each flattened to float32, the row padded to a
multiple of 8 columns; bools read back as ``> 0.5`` and integers cast back.
Rows written by the JAX buffer can therefore be copied across unchanged
(``utils/interop.py``).

``add`` writes one row in place; ``sample`` is two row gathers (indices and
indices + 1) plus column slicing and returns the same dict as the JAX
buffer.  Index arithmetic on device tensors uses ``torch.remainder`` (the
sign of the divisor, as ``%`` in ``jnp``), never ``fmod``.  Semantics are
``ReplayBuffer(stack_size=1, update_horizon=1)``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PackedReplayBufferState:
    rows: Tensor  # [capacity, row_width] float32
    add_count: Tensor  # int32 scalar
    episode_len: Tensor  # int32 scalar

    @property
    def size(self) -> Tensor:
        return torch.clamp(self.add_count, max=self.rows.shape[0])


def closed_form_indices(cur: Tensor, t: Tensor, valid_count: Tensor, u: Tensor, capacity: int) -> Tensor:
    """Uniform sample over the valid circular range ending ``t + 1`` before
    the cursor: ``u`` [B] uniforms in [0, 1) -> int64 indices.
    ``floor(u * valid_count)`` is taken in float32 (below ``valid_count`` for
    any count under 2^24), as the JAX fused loop computes it."""
    k = torch.floor(u * valid_count.to(torch.float32)).to(torch.int64)
    return torch.remainder(cur.to(torch.int64) - t - 1 - k, capacity)


class PackedReplayBuffer:
    """Single-array replay for dense 1-step transitions (``init``, ``add``,
    ``sample`` as ``ReplayBuffer``'s)."""

    REQUIRED_KEYS = ("observation", "action", "reward", "terminal")

    def __init__(
        self,
        replay_capacity: int = 10000,
        batch_size: int = 32,
        device="cuda",
    ) -> None:
        self._capacity = int(replay_capacity)
        self._batch_size = int(batch_size)
        self.device = resolve_device(device)
        # field name -> (col_start, flat_size, shape, dtype); built by init()
        self._layout: Optional[Dict[str, Tuple[int, int, Tuple[int, ...], torch.dtype]]] = None
        self._row_width = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def update_horizon(self) -> int:
        return 1

    @property
    def stack_size(self) -> int:
        return 1

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def row_width(self) -> int:
        return self._row_width

    def column(self, name: str) -> int:
        """First column of field ``name`` in a row."""
        return self._layout[name][0]

    def field_size(self, name: str) -> int:
        """Number of columns field ``name`` takes in a row."""
        return self._layout[name][1]

    def init(self, **example_transition: Any) -> PackedReplayBufferState:
        for k in self.REQUIRED_KEYS:
            if k not in example_transition:
                raise ValueError(f"example transition missing required key {k!r}")
        layout = {}
        col = 0
        for name in sorted(example_transition):
            t = torch.as_tensor(example_transition[name])
            n = t.numel()
            layout[name] = (col, n, tuple(t.shape), t.dtype)
            col += n
        self._layout = layout
        self._row_width = _round_up(max(col, 1), 8)
        return PackedReplayBufferState(
            rows=torch.zeros((self._capacity, self._row_width), dtype=torch.float32,
                             device=self.device),
            add_count=torch.zeros((), dtype=torch.int32, device=self.device),
            episode_len=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _pack(self, transition: Dict[str, Any]) -> Tensor:
        if self._layout is None:
            raise RuntimeError("init() first")
        parts = [
            torch.as_tensor(transition[name], device=self.device).to(torch.float32).reshape(n)
            for name, (_, n, _, _) in sorted(self._layout.items())
        ]
        pad = self._row_width - sum(p.numel() for p in parts)
        if pad:
            parts.append(torch.zeros((pad,), dtype=torch.float32, device=self.device))
        return torch.cat(parts)

    def _unpack(self, rows: Tensor, name: str) -> Tensor:
        start, n, shape, dtype = self._layout[name]
        v = rows[:, start:start + n]
        v = v.reshape(rows.shape[0], *shape) if shape else v[:, 0]
        if dtype == torch.bool:
            return v > 0.5
        return v if dtype.is_floating_point else v.to(dtype)

    def _last_terminal(self, state: PackedReplayBufferState) -> Tensor:
        """Whether the latest row ended an episode (False before any add)."""
        prev = torch.remainder(state.add_count - 1, self._capacity).to(torch.int64)
        term = state.rows[:, self.column("terminal")].index_select(0, prev.reshape(1))[0]
        return (term > 0.5) & (state.add_count > 0)

    def add(self, state: PackedReplayBufferState, **transition: Any) -> PackedReplayBufferState:
        """One row written in place; returns the state with the counters advanced."""
        new_episode = (state.add_count == 0) | self._last_terminal(state)
        episode_len = torch.where(new_episode, 0, state.episode_len) + 1
        cur = torch.remainder(state.add_count, self._capacity).to(torch.int64)
        state.rows.index_copy_(0, cur.reshape(1), self._pack(transition)[None, :])
        return PackedReplayBufferState(
            rows=state.rows, add_count=state.add_count + 1, episode_len=episode_len)

    def sample_index_batch(
        self, state: PackedReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> Tensor:
        """Uniform over valid indices in closed form: the only written indices
        that cannot be sampled are the trailing ``min(episode_len, 1)`` of an
        unterminated episode."""
        cap = self._capacity
        cur = torch.remainder(state.add_count, cap)
        written = torch.clamp(state.add_count, max=cap)
        t = torch.where(self._last_terminal(state) | (state.add_count == 0), 0,
                        torch.clamp(state.episode_len, max=1))
        valid_count = torch.clamp(written - t, min=1)
        u = torch.rand((batch_size,), generator=generator, device=self.device)
        return closed_form_indices(cur, t, valid_count, u, cap)

    def sample(
        self,
        state: PackedReplayBufferState,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        indices: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """Two row gathers + column slicing; the same dict as ``ReplayBuffer``."""
        bs = batch_size or self._batch_size
        if indices is None:
            indices = self.sample_index_batch(state, generator, bs)
        indices = indices.to(device=self.device, dtype=torch.int64)
        rows = state.rows.index_select(0, indices)
        next_rows = state.rows.index_select(0, torch.remainder(indices + 1, self._capacity))
        batch: Dict[str, Tensor] = {
            "state": self._unpack(rows, "observation"),
            "action": self._unpack(rows, "action"),
            "reward": self._unpack(rows, "reward"),
            "next_state": self._unpack(next_rows, "observation"),
            "next_action": self._unpack(next_rows, "action"),
            "terminal": self._unpack(rows, "terminal"),
            "indices": indices.to(torch.int32),
            "step": torch.ones((indices.shape[0],), dtype=torch.int32, device=self.device),
        }
        for key in self._layout:
            if key in self.REQUIRED_KEYS:
                continue
            batch[key] = self._unpack(rows, key)
            batch["next_" + key] = self._unpack(next_rows, key)
        return {k: v[:, None] if v.ndim == 1 else v for k, v in batch.items()}
