"""State-embedding POMDP wrapper: the MDN-RNN's hidden state as observation.

Port of ``reagent_tpu/gym/envs/state_embed.py`` (``StateEmbedState``,
``StateEmbedEnv``, :30-115; reference reagent/gym/envs/pomdp/
state_embed_env.py:30-126): each observation becomes [lstm hidden over the
history, raw obs], the history being the last ``max_embed_seq_len`` (obs,
action) pairs fed through a trained ``MemoryNetwork``.

As in JAX, the history is a fixed-length buffer in the env state, oldest
first: it fills from the left and, once full, shifts left by one at each
step; the whole history is re-embedded at every step and the embedding is
the hidden state at index ``max(hist_len, 1) - 1``, so an empty history
embeds one zero step (the reference's ``np.zeros`` fallback) and the zero
tail cannot leak in (the LSTM is causal).  Takes a leading batch dimension
where the wrapped env does: the envs of a batch are the LSTM's batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.gym.envs.functional import FunctionalEnv
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor


@dataclasses.dataclass
class StateEmbedState:
    inner: Any  # the wrapped env's state
    obs_hist: Tensor  # [..., L, obs_dim], oldest first
    act_hist: Tensor  # [..., L, act_dim]
    hist_len: Tensor  # int32 [...] in [0, L]
    cur_raw_obs: Tensor  # [..., obs_dim]


class StateEmbedEnv(FunctionalEnv):
    """obs -> concat([mdnrnn hidden over the history, raw obs]).

    ``memory_params``: the ``MemoryNetwork``'s parameters by name (a trained
    ``MDNRNNTrainerState.params``).  Draws and ``noise`` pass through to the
    wrapped env."""

    def __init__(
        self,
        env: FunctionalEnv,
        memory_network,
        memory_params: Dict[str, Tensor],
        max_embed_seq_len: int,
    ):
        self.env = env
        self.mdnrnn = memory_network
        self.mdnrnn_params = memory_params
        self.seq_len = int(max_embed_seq_len)
        self.embed_dim = int(memory_network.num_hiddens)
        self.raw_obs_dim = int(env.observation_dim)
        self.observation_dim = self.embed_dim + self.raw_obs_dim
        self.action_dim = env.action_dim
        self.discrete = env.discrete
        self.max_steps = env.max_steps
        self.device = env.device
        # action features fed to the world model: one-hot if discrete
        self._act_feat_dim = env.action_dim

    def _embed(self, obs_hist: Tensor, act_hist: Tensor, hist_len: Tensor) -> Tensor:
        """Hidden state after the last valid history step (ref :75-104)."""
        batched = obs_hist.ndim == 3
        obs = obs_hist.transpose(0, 1) if batched else obs_hist[:, None, :]  # [L, B, D]
        act = act_hist.transpose(0, 1) if batched else act_hist[:, None, :]
        with torch.no_grad():
            out = functional.apply(self.mdnrnn, self.mdnrnn_params,
                                   rlt.FeatureData(float_features=obs),
                                   rlt.FeatureData(float_features=act))
        # empty history -> one zero step; all_steps_hidden [L, B, H] is causal in
        # L; a gather, so that no index is read on the host
        n = torch.clamp(hist_len, min=1).to(torch.int64) - 1
        hidden = out.all_steps_hidden
        picked = hidden.gather(0, n.reshape(1, -1, 1).expand(1, -1, hidden.shape[2]))[0]
        return picked if batched else picked[0]

    def _append(self, state: StateEmbedState, action_feat: Tensor) -> StateEmbedState:
        L = self.seq_len
        full = (state.hist_len >= L)[..., None, None]
        # not full: write at hist_len; full: shift left, write at L - 1
        at = (torch.arange(L, device=state.obs_hist.device)
              == torch.clamp(state.hist_len, max=L - 1)[..., None])[..., None]
        obs_ins = torch.where(at, state.cur_raw_obs[..., None, :], state.obs_hist)
        act_ins = torch.where(at, action_feat[..., None, :], state.act_hist)
        obs_shift = torch.cat([state.obs_hist[..., 1:, :], state.cur_raw_obs[..., None, :]], -2)
        act_shift = torch.cat([state.act_hist[..., 1:, :], action_feat[..., None, :]], -2)
        return dataclasses.replace(
            state,
            obs_hist=torch.where(full, obs_shift, obs_ins),
            act_hist=torch.where(full, act_shift, act_ins),
            hist_len=torch.clamp(state.hist_len + 1, max=L),
        )

    def reset(self, generator=None, batch_size=None, noise=None) -> Tuple[StateEmbedState, Tensor]:
        kw = {} if noise is None else {"noise": noise}
        inner, raw_obs = self.env.reset(generator, batch_size, **kw)
        lead = raw_obs.shape[:-1]
        dev = raw_obs.device
        state = StateEmbedState(
            inner=inner,
            obs_hist=torch.zeros(lead + (self.seq_len, self.raw_obs_dim), device=dev),
            act_hist=torch.zeros(lead + (self.seq_len, self._act_feat_dim), device=dev),
            hist_len=torch.zeros(lead, dtype=torch.int32, device=dev),
            cur_raw_obs=raw_obs,
        )
        embed = self._embed(state.obs_hist, state.act_hist, state.hist_len)
        return state, torch.cat([embed, raw_obs], dim=-1)

    def step(self, state: StateEmbedState, action: Tensor, generator=None, noise=None):
        if self.discrete:
            action_feat = F.one_hot(action.to(torch.int64), self.action_dim).to(torch.float32)
        else:
            action_feat = action.to(torch.float32)
        state = self._append(state, action_feat)
        kw = {} if noise is None else {"noise": noise}
        inner, raw_obs, reward, done = self.env.step(state.inner, action, generator, **kw)
        state = dataclasses.replace(state, inner=inner, cur_raw_obs=raw_obs)
        embed = self._embed(state.obs_hist, state.act_hist, state.hist_len)
        return state, torch.cat([embed, raw_obs], dim=-1), reward, done
