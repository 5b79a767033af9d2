"""Synthetic-reward serving wrapper: a (state | action, presence) window ->
per-step rewards.

Port of ``reagent_tpu/prediction/synthetic_reward/
synthetic_reward_predictor_wrapper.py`` (``split_features`` :20,
``SyntheticRewardPredictorWrapper`` :34; reference
reagent/prediction/synthetic_reward/synthetic_reward_predictor_wrapper.py
:13-75): the concatenated value and presence columns are split, each side
goes through its preprocessor, and the reward net scores the ``seq_len``
window as one trajectory.

A single-step net whose MLP is a float32 dense chain with K3's activations
(relu, leaky_relu, tanh, linear) scores the window's rows as one K3 launch
on the card (``training/functional.py::score``), where JAX applies the
flax module in XLA; any other net runs its own forward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.synthetic_reward import SingleStepSyntheticRewardNet
from reagent_tpu_torch.training import functional

Tensor = torch.Tensor

_STEP_MLP = "net.net"  # a SyntheticRewardNet's single-step MLP, in its parameters


def split_features(state_and_action_with_presence: Tuple[Tensor, Tensor],
                   state_feat_num: int, action_feat_num: int):
    """(values, presence) -> ((state values, presence), (action values,
    presence)), by column (reference :13-27)."""
    values, presence = state_and_action_with_presence
    end = state_feat_num + action_feat_num
    return ((values[:, :state_feat_num], presence[:, :state_feat_num]),
            (values[:, state_feat_num:end], presence[:, state_feat_num:end]))


class SyntheticRewardPredictorWrapper:
    def __init__(self, seq_len: int, state_preprocessor, action_preprocessor, net,
                 net_params) -> None:
        self.seq_len = seq_len
        self.state_preprocessor = state_preprocessor
        self.action_preprocessor = action_preprocessor
        self.net = net
        self.net_params = functional.params_of(net) if net_params is None else net_params
        self.state_feat_num = len(state_preprocessor.sorted_features)
        self.action_feat_num = len(action_preprocessor.sorted_features)

    @torch.no_grad()
    def __call__(self, state_and_action_with_presence: Tuple[Tensor, Tensor]) -> Tensor:
        values, presence = state_and_action_with_presence
        if values.shape[0] != self.seq_len:
            raise ValueError(f"expected seq_len {self.seq_len}, got {values.shape[0]}")
        (sv, sp), (av, ap) = split_features((values, presence), self.state_feat_num,
                                            self.action_feat_num)
        state = self.state_preprocessor(sv, sp)
        action = self.action_preprocessor(av, ap)
        if isinstance(self.net.net, SingleStepSyntheticRewardNet):
            mlp = self.net.net.net
            mlp_params = {k[len(_STEP_MLP) + 1:]: v for k, v in self.net_params.items()}
            return functional.score(mlp, mlp_params, torch.cat([state, action], dim=1))[:, 0]
        # [seq_len, 1, dim]: a batch of one trajectory (ref :56-64)
        T = self.seq_len
        batch = rlt.MemoryNetworkInput(
            state=rlt.FeatureData(float_features=state[:, None, :]),
            action=rlt.FeatureData(float_features=action[:, None, :]),
            next_state=rlt.FeatureData(float_features=state[:, None, :]),
            reward=torch.zeros((T, 1), device=state.device),
            not_terminal=torch.ones((T, 1), device=state.device),
            time_diff=None,
            step=None,
            valid_step=torch.full((1, 1), T, dtype=torch.int32, device=state.device),
        )
        out = functional.apply(self.net, self.net_params, batch)
        return out.output.reshape(-1)[-T:]
