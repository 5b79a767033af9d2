"""MDN-RNN world model (Ha & Schmidhuber "World Models").

Port of ``reagent_tpu/models/mdn_rnn.py`` (``StackedLSTM``, ``MDNRNN``,
``gmm_loss``, ``MemoryNetwork``, ``MDNRNNMemorySample``,
``MDNRNNMemoryPool``, :23-193; reference reagent/models/mdn_rnn.py:21-170).
Sequences are time-major, ``[seq_len, batch, ...]``.

The LSTM cell is written out as flax's ``OptimizedLSTMCell`` computes it,
not ``torch.nn.LSTM``: two products, ``h @ W_h + b`` then ``x @ W_i``, their
sum split into the i, f, g, o gates (sigmoid, sigmoid, tanh, sigmoid), then
``c' = f * c + i * g`` and ``h' = o * tanh(c')``, from a zero carry.  Each
layer keeps the four gates' kernels side by side, ``input_kernel`` [in, 4H]
(no bias, as flax's ``ii``..``io``) and ``hidden_kernel`` [H, 4H] with
``hidden_bias`` [4H] (``hi``..``ho``), so a flax tree maps onto it one
kernel per gate (``utils/interop.py::memory_network_state_from_flax``), and
no cuDNN kernel picks its own algorithm on the card.  The LSTM and the
mixture head are plain XLA in the JAX package, not Pallas, so they are plain
torch here.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.fully_connected_network import orthogonal_fill

Tensor = torch.Tensor
Carry = Tuple[Tensor, Tensor]  # (c, h), each [B, H]


def _lecun_normal_fill(weight: Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init on an ``[in, out]`` kernel: a normal
    truncated at 2 standard deviations, scaled to variance 1 / fan_in."""
    fan_in = weight.shape[0]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std
    draw = torch.randn(weight.shape, generator=generator, dtype=torch.float32)
    while True:  # resample the tails
        bad = draw.abs() > 2.0
        if not bool(bad.any()):
            break
        draw[bad] = torch.randn((int(bad.sum()),), generator=generator, dtype=torch.float32)
    with torch.no_grad():
        weight.copy_(draw * std)


class LSTMLayer(nn.Module):
    """One ``OptimizedLSTMCell`` scanned over time."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        self.hidden_size = int(hidden_size)
        H4 = 4 * self.hidden_size
        self.input_kernel = nn.Parameter(torch.zeros((input_size, H4)))
        self.hidden_kernel = nn.Parameter(torch.zeros((self.hidden_size, H4)))
        self.hidden_bias = nn.Parameter(torch.zeros((H4,)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal input kernels, orthogonal recurrent
        kernels (each gate's own), zero biases."""
        H = self.hidden_size
        _lecun_normal_fill(self.input_kernel, generator)
        with torch.no_grad():
            for g in range(4):
                gate = torch.empty((H, H))
                orthogonal_fill(gate, 1.0, generator)  # [out, in] -> kernel [in, out]
                self.hidden_kernel[:, g * H:(g + 1) * H] = gate.T
            self.hidden_bias.zero_()

    def forward(self, xs: Tensor, carry: Optional[Carry] = None) -> Tuple[Carry, Tensor]:
        """``xs`` [T, B, in] -> ((c, h) after the last step, hidden [T, B, H])."""
        T, B = xs.shape[0], xs.shape[1]
        H = self.hidden_size
        if carry is None:
            zeros = torch.zeros((B, H), dtype=xs.dtype, device=xs.device)
            carry = (zeros, zeros)
        c, h = carry
        # every step's input product at once: each row is its own dot product
        x_all = (xs.reshape(T * B, -1) @ self.input_kernel).reshape(T, B, 4 * H)
        hs = []
        for t in range(T):
            z = (h @ self.hidden_kernel + self.hidden_bias) + x_all[t]
            i, f, g, o = z.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return (c, h), torch.stack(hs)


class StackedLSTM(nn.Module):
    """Multi-layer LSTM over [T, B, D] sequences, returning all hidden states."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int) -> None:
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.layers = nn.ModuleList(
            LSTMLayer(input_size if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, xs: Tensor, initial_carry: Optional[List[Carry]] = None):
        """-> (hidden of the last layer [T, B, H], each layer's final (c, h))."""
        h = xs
        last_carries = []
        for i, layer in enumerate(self.layers):
            carry, h = layer(h, None if initial_carry is None else initial_carry[i])
            last_carries.append(carry)
        return h, last_carries


class MDNRNN(nn.Module):
    """Reference: mdn_rnn.py:21.  ``predict_delta=True`` makes the mixture's
    means ``state + delta`` (JAX's option; the output contract is unchanged:
    ``mus`` are absolute next-state means)."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        num_hiddens: int,
        num_hidden_layers: int,
        num_gaussians: int,
        predict_delta: bool = False,
    ) -> None:
        super().__init__()
        self.state_dim, self.action_dim = int(state_dim), int(action_dim)
        self.num_hiddens, self.num_gaussians = int(num_hiddens), int(num_gaussians)
        self.predict_delta = bool(predict_delta)
        self.rnn = StackedLSTM(self.action_dim + self.state_dim, num_hiddens, num_hidden_layers)
        G, S = self.num_gaussians, self.state_dim
        self.head = nn.Linear(self.num_hiddens, (2 * S + 1) * G + 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: the LSTM's, then the head's lecun-normal kernel and
        zero bias."""
        self.rnn.reset_parameters(generator)
        kernel = torch.empty((self.head.in_features, self.head.out_features))
        _lecun_normal_fill(kernel, generator)
        with torch.no_grad():
            self.head.weight.copy_(kernel.T)
            self.head.bias.zero_()

    def forward(self, actions: Tensor, states: Tensor, initial_carry=None):
        """actions/states: [T, B, dim] -> GMM params + reward + not_terminal."""
        T, B = actions.shape[0], actions.shape[1]
        ins = torch.cat([actions, states], dim=-1)
        all_hidden, last_carries = self.rnn(ins, initial_carry)
        G, S = self.num_gaussians, self.state_dim
        out = self.head(all_hidden)
        stride = G * S
        mus = out[..., :stride].reshape(T, B, G, S)
        if self.predict_delta:
            mus = mus + states[..., None, :]
        sigmas = torch.exp(out[..., stride:2 * stride]).reshape(T, B, G, S)
        logpi = F.log_softmax(out[..., 2 * stride:2 * stride + G].reshape(T, B, G), dim=-1)
        reward = out[..., -2]
        not_terminal = out[..., -1]
        return mus, sigmas, logpi, reward, not_terminal, all_hidden, last_carries


_LOG_2PI = np.log(np.float32(2 * np.pi))  # float32, as jnp.log(2 * jnp.pi)


def gmm_loss(batch: Tensor, mus: Tensor, sigmas: Tensor, logpi: Tensor,
             reduce: bool = True) -> Tensor:
    """Negative log-likelihood under a factored GMM (reference mdn_rnn.py:188)."""
    batch = batch[..., None, :]  # [..., 1, fs]
    log_norm = -0.5 * (((batch - mus) / sigmas) ** 2 + 2 * torch.log(sigmas)
                       + _LOG_2PI)
    g_log_probs = logpi + torch.sum(log_norm, dim=-1)
    log_prob = torch.logsumexp(g_log_probs, dim=-1)
    if reduce:
        return -torch.mean(log_prob)
    return -log_prob


class MemoryNetwork(nn.Module):
    """``MDNRNN`` returning a typed output (reference models/world_model.py:12)."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        num_hiddens: int,
        num_hidden_layers: int,
        num_gaussians: int,
        predict_delta: bool = False,
    ) -> None:
        super().__init__()
        self.state_dim, self.action_dim = int(state_dim), int(action_dim)
        self.num_hiddens = int(num_hiddens)
        self.num_hidden_layers = int(num_hidden_layers)
        self.num_gaussians = int(num_gaussians)
        self.predict_delta = bool(predict_delta)
        self.mdnrnn = MDNRNN(state_dim, action_dim, num_hiddens, num_hidden_layers,
                             num_gaussians, predict_delta)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mdnrnn.reset_parameters(generator)

    def forward(self, state: rlt.FeatureData, action: rlt.FeatureData) -> rlt.MemoryNetworkOutput:
        mus, sigmas, logpi, reward, not_terminal, all_hidden, carries = self.mdnrnn(
            action.float_features, state.float_features)
        last_c, last_h = carries[-1]
        return rlt.MemoryNetworkOutput(
            mus=mus,
            sigmas=sigmas,
            logpi=logpi,
            reward=reward,
            not_terminal=not_terminal,
            last_step_hidden=last_h,
            last_step_cell=last_c,
            all_steps_hidden=all_hidden,
        )


class MDNRNNMemorySample(NamedTuple):
    """One world-model transition sequence (reference models/mdn_rnn.py:108-117)."""

    state: np.ndarray
    action: np.ndarray
    next_state: np.ndarray
    reward: np.ndarray
    not_terminal: np.ndarray


class MDNRNNMemoryPool:
    """Ring buffer of world-model sequences (reference models/mdn_rnn.py:121-170).

    Batches come out [seq_len, batch, ...], assembled on the host in numpy
    and sent to ``device`` once."""

    def __init__(self, max_replay_memory_size: int, device="cuda"):
        from reagent_tpu_torch.utils.device import resolve_device

        self.replay_memory = deque(maxlen=max_replay_memory_size)
        self.max_replay_memory_size = max_replay_memory_size
        self.device = resolve_device(device)

    @property
    def memory_size(self) -> int:
        return len(self.replay_memory)

    def insert_into_memory(self, state, action, next_state, reward, not_terminal):
        self.replay_memory.append(
            MDNRNNMemorySample(
                state=np.asarray(state, np.float32),
                action=np.asarray(action, np.float32),
                next_state=np.asarray(next_state, np.float32),
                reward=np.asarray(reward, np.float32),
                not_terminal=np.asarray(not_terminal, np.float32),
            )
        )

    def sample_memories(self, batch_size: int, rng=None) -> rlt.MemoryNetworkInput:
        """``batch_size`` sequences drawn with ``rng.integers`` (a numpy
        ``Generator``, as the JAX pool draws)."""
        rng = rng or np.random.default_rng()
        idx = rng.integers(0, self.memory_size, batch_size)
        samples = [self.replay_memory[i] for i in idx]
        state, action, next_state, reward, not_terminal = (
            np.stack([getattr(s, f) for s in samples])
            for f in ("state", "action", "next_state", "reward", "not_terminal")
        )

        def tm(x):  # [batch, seq_len, ...] -> time-major, on the device
            return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 0, 1))).to(self.device)

        reward_tm = tm(reward)
        return rlt.MemoryNetworkInput(
            state=rlt.FeatureData(float_features=tm(state)),
            action=rlt.FeatureData(float_features=tm(action)),
            next_state=rlt.FeatureData(float_features=tm(next_state)),
            reward=reward_tm,
            not_terminal=tm(not_terminal),
            time_diff=torch.ones_like(reward_tm),
            step=None,
        )
