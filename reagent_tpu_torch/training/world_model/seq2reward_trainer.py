"""Seq2Reward trainer and the compress-model trainer.

Port of ``reagent_tpu/training/world_model/seq2reward_trainer.py``
(``Seq2RewardTrainerState`` :28, ``Seq2RewardTrainer`` :36,
``CompressModelTrainerState`` :130, ``CompressModelTrainer`` :136; reference
reagent/training/world_model/seq2reward_trainer.py:68-270 and
compress_model_trainer.py).  The first fits the LSTM to the discounted
cumulative reward of logged action sequences, read at each row's last valid
step, beside a step-count classifier (an MLP from the first state to
``multi_steps`` logits, softmax cross entropy with integer labels
``valid_step - 1``, averaged over the batch); each has its own Adam rule.
The second fits a feed-forward net to the planning Q that ``get_Q`` reads
from a trained Seq2Reward network.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import Seq2RewardTrainerParameters
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.models.seq2reward_model import (
    Seq2RewardNetwork,
    gen_permutations,
    get_Q,
)
from reagent_tpu_torch.optim import Adam, OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Seq2RewardTrainerState:
    params: Dict[str, Tensor]  # the Seq2RewardNetwork's, by name
    opt_state: OptState
    step_params: Dict[str, Tensor]  # the step classifier's
    step_opt_state: OptState
    step: Tensor  # int32 scalar


def _pow_range(gamma: float, n: int, device) -> Tensor:
    """``gamma ** jnp.arange(n)`` in float32."""
    return torch.pow(torch.tensor(gamma, dtype=torch.float32, device=device),
                     torch.arange(n, dtype=torch.float32, device=device))


class Seq2RewardTrainer:
    def __init__(
        self,
        seq2reward_network: Seq2RewardNetwork,
        params: Seq2RewardTrainerParameters = Seq2RewardTrainerParameters(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.seq2reward_network = seq2reward_network.to(self.device)
        self.params = params
        self.optimizer = make_optimizer(Adam(lr=params.learning_rate))
        size = params.step_predict_net_size
        self.step_predict_network = FullyConnectedNetwork(
            sizes=[seq2reward_network.state_dim, size, size, params.multi_steps],
            activations=["relu", "relu", "linear"],
        ).to(self.device)

    def init(self, generator: torch.Generator) -> Seq2RewardTrainerState:
        """Fresh weights of both nets from ``generator`` (on the CPU)."""
        self.seq2reward_network.reset_parameters(generator)
        self.step_predict_network.reset_parameters(generator)
        return self.state_from_networks()

    def state_from_networks(self) -> Seq2RewardTrainerState:
        params = functional.params_of(self.seq2reward_network)
        step_params = functional.params_of(self.step_predict_network)
        return Seq2RewardTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step_params=step_params, step_opt_state=self.optimizer.init(step_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def get_mse_loss(self, params, batch: rlt.MemoryNetworkInput) -> Tensor:
        valid_step = batch.valid_step.reshape(-1)
        out = functional.apply(self.seq2reward_network, params, batch.state, batch.action,
                               valid_step)
        T, B = batch.reward.shape
        gammas = _pow_range(self.params.gamma, T, batch.reward.device)
        acc = torch.cumsum(batch.reward * gammas[:, None], dim=0)  # [T, B]
        target = acc[(valid_step - 1).to(torch.int64),
                     torch.arange(B, device=acc.device)][:, None]
        return torch.mean((out.acc_reward - target) ** 2)

    def train_step(
        self, state: Seq2RewardTrainerState, batch: rlt.MemoryNetworkInput
    ) -> Tuple[Seq2RewardTrainerState, Dict[str, Tensor]]:
        mse_loss, grads, _ = functional.value_and_grad(
            lambda p: self.get_mse_loss(p, batch), state.params)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)

        first_state = batch.state.float_features[0]
        labels = (batch.valid_step.reshape(-1) - 1).to(torch.int64)

        def step_loss_fn(sp):
            logits = functional.apply(self.step_predict_network, sp, first_state)
            return F.cross_entropy(logits, labels)

        step_loss, s_grads, _ = functional.value_and_grad(step_loss_fn, state.step_params)
        with torch.no_grad():
            step_params, step_opt_state = self.optimizer.update(
                s_grads, state.step_opt_state, state.step_params)
        return (
            Seq2RewardTrainerState(params=params, opt_state=opt_state, step_params=step_params,
                                   step_opt_state=step_opt_state, step=state.step + 1),
            {"mse_loss": mse_loss, "step_entropy_loss": step_loss},
        )


@dataclasses.dataclass
class CompressModelTrainerState:
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class CompressModelTrainer:
    """Fit ``compress_model_network`` (state -> [B, num_actions]) to the
    Seq2Reward planning Q (reference compress_model_trainer.py)."""

    def __init__(
        self,
        compress_model_network: nn.Module,
        seq2reward_network: Seq2RewardNetwork,
        params: Seq2RewardTrainerParameters = Seq2RewardTrainerParameters(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.compress_model_network = compress_model_network.to(self.device)
        self.seq2reward_network = seq2reward_network.to(self.device)
        self.params = params
        self.optimizer = make_optimizer(Adam(lr=params.compress_model_learning_rate))
        self.num_actions = len(params.action_names) or seq2reward_network.action_dim
        self.all_permut = gen_permutations(params.multi_steps, self.num_actions, self.device)

    def init(self, generator: torch.Generator) -> CompressModelTrainerState:
        """Fresh weights from ``generator`` (on the CPU)."""
        self.compress_model_network.reset_parameters(generator)
        return self.state_from_network()

    def state_from_network(self) -> CompressModelTrainerState:
        params = functional.params_of(self.compress_model_network)
        return CompressModelTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(
        self,
        state: CompressModelTrainerState,
        batch: rlt.MemoryNetworkInput,
        seq2reward_params=None,
    ) -> Tuple[CompressModelTrainerState, Dict[str, Tensor]]:
        first_state = batch.state.float_features[0]
        with torch.no_grad():
            target_q = get_Q(self.seq2reward_network, seq2reward_params, first_state,
                             self.all_permut)

        def loss_fn(p):
            q = functional.apply(self.compress_model_network, p, first_state)
            return torch.mean((q - target_q) ** 2)

        loss, grads, _ = functional.value_and_grad(loss_fn, state.params)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (
            CompressModelTrainerState(params=params, opt_state=opt_state, step=state.step + 1),
            {"mse_loss": loss},
        )
