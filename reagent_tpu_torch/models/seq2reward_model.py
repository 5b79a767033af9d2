"""Seq2Reward: the accumulated reward of an action sequence from a state.

Port of ``reagent_tpu/models/seq2reward_model.py`` (``Seq2RewardNetwork``
:20, ``get_Q`` :57, ``gen_permutations`` :86; reference
reagent/models/seq2reward_model.py:14).  Each stacked LSTM layer is the
MDN-RNN's written-out ``OptimizedLSTMCell`` (``models/mdn_rnn.py``) and
starts from flax's carry ``(c, h) = (0, map_linear(states[0]))``; the inputs
are the actions alone.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.mdn_rnn import LSTMLayer
from reagent_tpu_torch.models.seq2slate_reward import _lecun_linear_
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class Seq2RewardNetwork(nn.Module):
    def __init__(self, state_dim: int, action_dim: int, num_hiddens: int,
                 num_hidden_layers: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.state_dim, self.action_dim = int(state_dim), int(action_dim)
        self.num_hiddens = int(num_hiddens)
        self.num_hidden_layers = int(num_hidden_layers)
        self.map_linear = nn.Linear(self.state_dim, self.num_hiddens)
        self.layers = nn.ModuleList(
            LSTMLayer(self.action_dim if i == 0 else self.num_hiddens, self.num_hiddens)
            for i in range(self.num_hidden_layers))
        self.lstm_linear = nn.Linear(self.num_hiddens, 1)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal Dense kernels and zero biases, the LSTM
        layers' own."""
        _lecun_linear_(self.map_linear, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        _lecun_linear_(self.lstm_linear, generator)

    def forward(self, state: rlt.FeatureData, action: rlt.FeatureData,
                valid_reward_len: Optional[Tensor] = None) -> rlt.Seq2RewardOutput:
        """states [T, B, S], actions [T, B, A] -> acc_reward [B, 1], read at
        step ``valid_reward_len - 1`` of each row (the last step where None)."""
        states = state.float_features
        B = states.shape[1]
        state_embed = self.map_linear(states[0])
        h = action.float_features
        for layer in self.layers:
            carry = (torch.zeros((B, self.num_hiddens), dtype=h.dtype, device=h.device),
                     state_embed)
            _, h = layer(h, carry)
        if valid_reward_len is None:
            last_hidden = h[-1]
        else:
            idx = (valid_reward_len - 1).to(torch.int64)
            last_hidden = h[idx, torch.arange(B, device=h.device)]
        return rlt.Seq2RewardOutput(acc_reward=self.lstm_linear(last_hidden))


def get_Q(seq2reward_network: Seq2RewardNetwork, params, cur_state: Tensor,
          all_permut: Tensor) -> Tensor:
    """The best accumulated reward over the action sequences that start with
    each action: ``cur_state`` [B, S], ``all_permut`` [T, P, A] in lexical
    order -> [B, A].  Row ``b * P + p`` pairs state ``b`` with permutation
    ``p`` (JAX's ``jnp.repeat`` of the states, ``jnp.tile`` of the
    permutations).  ``params`` None runs the module's own."""
    B, S = cur_state.shape
    T, P, A = all_permut.shape
    state = cur_state.repeat_interleave(P, dim=0)[None].expand(T, B * P, S)
    action = all_permut.repeat(1, B, 1)
    inputs = (rlt.FeatureData(float_features=state), rlt.FeatureData(float_features=action))
    if params is None:
        out = seq2reward_network(*inputs)
    else:
        out = torch.func.functional_call(seq2reward_network, params, inputs)
    return out.acc_reward.reshape(B, A, P // A).amax(dim=2)


def gen_permutations(seq_len: int, num_action: int, device="cuda") -> Tensor:
    """Every action sequence of length ``seq_len``, one-hot, in lexical
    order: [seq_len, num_action ** seq_len, num_action] float32."""
    perms = np.array(list(itertools.product(range(num_action), repeat=seq_len)))
    onehot = np.eye(num_action, dtype=np.float32)[perms]  # [P, T, A]
    return torch.from_numpy(np.ascontiguousarray(onehot.transpose(1, 0, 2))).to(
        resolve_device(device))
