"""On-device circular replay buffer.

Port of ``reagent_tpu/replay/circular.py`` (``ReplayBuffer``,
``ReplayBufferState``, :39-367).  The store is a dict of preallocated
``[capacity, ...]`` tensors on the buffer's device; ``add`` writes in place
and ``sample`` gathers, so an actor-learner loop never reads a value back to
the host.  Semantics kept from the JAX buffer (and the reference it follows):

  * episode starts insert ``stack_size - 1`` zero frames;
  * an index is invalid while it is within ``update_horizon`` of the cursor,
    until enough of the episode has been seen;
  * on terminal, the trailing ``min(episode_len, update_horizon)`` indices
    become valid at once;
  * the n-step reward, the step count to the first terminal and the
    terminal flag come from K4 (``ops/nstep_replay.py::nstep_rewards``), in
    place of the JAX buffer's inline window sum (:310-324, :343-344);
  * states are stacked at sample time: ``[B, *obs, stack]``.

Where the JAX buffer branches on a traced value (the stack padding at an
episode start), the port writes with ``torch.where`` so that no branch
needs the value on the host.  Sampling draws float32 uniforms from a
``torch.Generator`` and maps them onto the valid indices: uniform over the
same set as the JAX buffer's ``randint``, but not its stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from reagent_tpu_torch.ops.nstep_replay import nstep_rewards
from reagent_tpu_torch.replay.packed import closed_form_indices
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class ReplayBufferState:
    store: Dict[str, Tensor]  # each [capacity, ...]
    add_count: Tensor  # int32 scalar: total adds incl. zero-padding frames
    is_valid: Tensor  # bool [capacity]
    episode_len: Tensor  # int32 scalar: transitions in the current episode

    @property
    def size(self) -> Tensor:
        return torch.sum(self.is_valid.to(torch.int32))


def _put(t: Tensor, idx: Tensor, values: Tensor) -> None:
    """``t[idx] = values`` in place with device indices (no host read)."""
    t.index_put_((idx.to(torch.int64),), values)


def _take(t: Tensor, idx: Tensor) -> Tensor:
    return t.index_select(0, idx.to(torch.int64).reshape(-1)).reshape(idx.shape + t.shape[1:])


class ReplayBuffer:
    """Static configuration + ops over ``ReplayBufferState``.

    Usage::

        rb = ReplayBuffer(replay_capacity=10000, update_horizon=3, gamma=0.99)
        state = rb.init(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                        reward=torch.tensor(0.0), terminal=torch.tensor(False))
        state = rb.add(state, observation=obs, action=a, reward=r, terminal=d)
        batch = rb.sample(state, generator, batch_size=256)
    """

    REQUIRED_KEYS = ("observation", "action", "reward", "terminal")

    def __init__(
        self,
        stack_size: int = 1,
        replay_capacity: int = 10000,
        batch_size: int = 32,
        update_horizon: int = 1,
        gamma: float = 0.99,
        return_as_timeline_format: bool = False,
        device="cuda",
    ) -> None:
        if replay_capacity < update_horizon + stack_size:
            raise ValueError(
                "There is not enough capacity to cover update_horizon and stack_size."
            )
        self._stack_size = int(stack_size)
        self._capacity = int(replay_capacity)
        self._batch_size = int(batch_size)
        self._update_horizon = int(update_horizon)
        self._gamma = float(gamma)
        self._return_as_timeline_format = bool(return_as_timeline_format)
        self.device = resolve_device(device)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def update_horizon(self) -> int:
        return self._update_horizon

    @property
    def stack_size(self) -> int:
        return self._stack_size

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def init(self, **example_transition: Any) -> ReplayBufferState:
        """Allocate zeroed storage from one example transition (shapes+dtypes)."""
        for k in self.REQUIRED_KEYS:
            if k not in example_transition:
                raise ValueError(f"example transition missing required key {k!r}")
        store: Dict[str, Tensor] = {}
        for name, example in example_transition.items():
            t = torch.as_tensor(example)
            dtype = t.dtype
            if dtype == torch.float64:
                dtype = torch.float32
            if name == "terminal":
                dtype = torch.bool
            store[name] = torch.zeros((self._capacity, *t.shape), dtype=dtype, device=self.device)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return ReplayBufferState(
            store=store, add_count=zero, episode_len=zero.clone(),
            is_valid=torch.zeros((self._capacity,), dtype=torch.bool, device=self.device),
        )

    # ------------------------------------------------------------------- add

    def add(self, state: ReplayBufferState, **transition: Any) -> ReplayBufferState:
        """Append one transition, writing ``state``'s tensors in place."""
        cap, ss, h = self._capacity, self._stack_size, self._update_horizon
        dev = self.device
        store, is_valid = state.store, state.is_valid
        prev = torch.remainder(state.add_count - 1, cap)
        new_episode = (state.add_count == 0) | _take(store["terminal"], prev)
        add_count = state.add_count

        # Episode start: stack_size - 1 zero frames, written only where
        # new_episode holds (elsewhere the same slots are rewritten unchanged).
        if ss > 1:
            pad = torch.remainder(add_count + torch.arange(ss - 1, device=dev), cap)
            for v in store.values():
                _put(v, pad, torch.where(
                    new_episode.reshape((1,) * v.ndim), torch.zeros((), dtype=v.dtype, device=dev),
                    _take(v, pad)))
            _put(is_valid, pad, _take(is_valid, pad) & ~new_episode)
            add_count = add_count + new_episode.to(torch.int32) * (ss - 1)
        episode_len = torch.where(new_episode, 0, state.episode_len)

        cur = torch.remainder(add_count, cap)
        _put(is_valid, cur.reshape(1), torch.zeros((1,), dtype=torch.bool, device=dev))
        # The index update_horizon behind becomes sampleable once the episode
        # has produced at least update_horizon transitions.
        behind = torch.remainder(cur - h, cap).reshape(1)
        _put(is_valid, behind, _take(is_valid, behind) | (episode_len >= h))

        for k, v in store.items():
            x = torch.as_tensor(transition[k], device=dev).to(v.dtype)
            _put(v, cur.reshape(1), x.reshape((1,) + v.shape[1:]))
        episode_len = episode_len + 1

        # Invalidate the stack_size - 1 indices after the (advanced) cursor.
        if ss > 1:
            nxt = torch.remainder(cur + 1 + torch.arange(ss - 1, device=dev), cap)
            _put(is_valid, nxt, torch.zeros((ss - 1,), dtype=torch.bool, device=dev))

        # Terminal: the trailing min(episode_len, H) indices become valid now.
        terminal = torch.as_tensor(transition["terminal"], device=dev).to(torch.bool)
        back = torch.arange(h, device=dev)
        back_idx = torch.remainder(cur - back, cap)
        back_mask = terminal & (back < torch.clamp(episode_len, max=h))
        _put(is_valid, back_idx, _take(is_valid, back_idx) | back_mask)

        return ReplayBufferState(
            store=store, add_count=add_count + 1, is_valid=is_valid, episode_len=episode_len)

    # ----------------------------------------------------------------- sample

    def sample_index_batch(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> Tensor:
        """Uniform over valid indices, int64 [batch_size].

        With ``stack_size == 1`` the invalid written region is exactly the
        trailing ``t = min(episode_len, H)`` entries of the current
        unterminated episode (0 right after a terminal), so the valid
        indices are the circular range ending ``t + 1`` before the cursor: a
        closed form, no pass over the validity array.  Otherwise the
        ``(pick + 1)``-th valid index is found from a prefix count.
        """
        cap = self._capacity
        u = torch.rand((batch_size,), generator=generator, device=self.device)
        if self._stack_size == 1:
            cur = torch.remainder(state.add_count, cap)
            written = torch.clamp(state.add_count, max=cap)
            prev = torch.remainder(state.add_count - 1, cap)
            last_terminal = (state.add_count == 0) | _take(state.store["terminal"], prev)
            t = torch.where(last_terminal, 0, torch.clamp(state.episode_len, max=self._update_horizon))
            return closed_form_indices(cur, t, torch.clamp(written - t, min=1), u, cap)
        csum = torch.cumsum(state.is_valid.to(torch.int64), dim=0)
        total = torch.clamp(csum[-1], min=1)
        picks = torch.floor(u * total.to(torch.float32)).to(torch.int64)
        return torch.remainder(torch.searchsorted(csum, picks + 1), cap)

    def _stack_for(self, state: ReplayBufferState, key: str, indices: Tensor) -> Tensor:
        """Gather with frame stacking: ``[B, *shape, stack]`` (``[B, *shape]``
        for stack_size 1)."""
        if self._stack_size == 1:
            return _take(state.store[key], indices)
        offsets = torch.arange(-self._stack_size + 1, 1, device=self.device)
        stack_idx = torch.remainder(indices[:, None] + offsets, self._capacity)
        return torch.movedim(_take(state.store[key], stack_idx), 1, -1)

    def sample(
        self,
        state: ReplayBufferState,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        indices: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """A transition batch as a dict of device tensors.

        Keys: state, action, reward, next_state, next_action, terminal,
        indices, step, plus every extra storage key K and its ``next_K``.  In
        timeline format next_* carry the full horizon ``[B, H, ...]`` plus a
        ``valid_step`` count.
        """
        bs = batch_size or self._batch_size
        if indices is None:
            indices = self.sample_index_batch(state, generator, bs)
        indices = indices.to(device=self.device, dtype=torch.int64)
        cap, h = self._capacity, self._update_horizon
        store = state.store

        rewards = store["reward"]
        if rewards.dtype != torch.float32:
            rewards = rewards.to(torch.float32)
        nstep_reward, steps, terminal = nstep_rewards(
            rewards, store["terminal"], indices, h, self._gamma)
        next_indices = torch.remainder(indices + steps, cap)
        timeline = self._return_as_timeline_format

        def window(key):
            """[B, H, ...] horizon window gather for timeline output."""
            w = torch.remainder(indices[:, None] + 1 + torch.arange(h, device=self.device), cap)
            return _take(store[key], w)

        batch: Dict[str, Tensor] = {
            "state": self._stack_for(state, "observation", indices),
            "action": self._stack_for(state, "action", indices),
        }
        if timeline:
            multistep = torch.remainder(indices[:, None] + torch.arange(h, device=self.device), cap)
            batch["next_state"] = window("observation")
            batch["next_action"] = window("action")
            batch["reward"] = _take(store["reward"], multistep)
            batch["valid_step"] = steps[:, None]
        else:
            batch["next_state"] = self._stack_for(state, "observation", next_indices)
            batch["next_action"] = self._stack_for(state, "action", next_indices)
            batch["reward"] = nstep_reward
        batch["terminal"] = terminal
        batch["indices"] = indices.to(torch.int32)
        batch["step"] = steps

        for key in store:
            if key in self.REQUIRED_KEYS:
                continue
            batch[key] = self._stack_for(state, key, indices)
            batch["next_" + key] = (
                window(key) if timeline else self._stack_for(state, key, next_indices))
        # the reference's shape convention: rank-1 -> [B, 1]
        return {k: v[:, None] if v.ndim == 1 else v for k, v in batch.items()}
