"""MDN-RNN trainer.

Port of ``reagent_tpu/training/world_model/mdnrnn_trainer.py``
(``MDNRNNTrainerState``, ``MDNRNNTrainer``, :25-92; reference
reagent/training/world_model/mdnrnn_trainer.py:21-180).  Loss =
gmm / (state_dim + 2) + bce(not_terminal) + mse(reward), each term times its
weight; ``fit_only_one_next_step`` fits the last step only.  As in JAX, the
batch's ``valid_step`` is not read.  Adam at ``learning_rate``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import MDNRNNTrainerParameters
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork, gmm_loss
from reagent_tpu_torch.optim import Adam, OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class MDNRNNTrainerState:
    params: Dict[str, Tensor]  # the MemoryNetwork's, by name
    opt_state: OptState
    step: Tensor  # int32 scalar


def sigmoid_binary_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """optax's elementwise ``-labels log p - (1 - labels) log(1 - p)``, from
    the log-sigmoids of the logits."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class MDNRNNTrainer:
    def __init__(
        self,
        memory_network: MemoryNetwork,
        params: MDNRNNTrainerParameters = MDNRNNTrainerParameters(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.memory_network = memory_network.to(self.device)
        self.params = params
        self.optimizer = make_optimizer(Adam(lr=params.learning_rate))

    def init(self, generator: torch.Generator) -> MDNRNNTrainerState:
        """Fresh weights from ``generator`` (on the CPU) and Adam's state."""
        self.memory_network.reset_parameters(generator)
        return self.state_from_memory_network()

    def state_from_memory_network(self) -> MDNRNNTrainerState:
        net_params = functional.params_of(self.memory_network)
        return MDNRNNTrainerState(
            params=net_params,
            opt_state=self.optimizer.init(net_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def get_loss(self, net_params, batch: rlt.MemoryNetworkInput) -> Dict[str, Tensor]:
        state_dim = batch.state.float_features.shape[2]
        out = functional.apply(self.memory_network, net_params, batch.state, batch.action)
        mus, sigmas, logpi = out.mus, out.sigmas, out.logpi
        rs, nts = out.reward, out.not_terminal

        next_state = batch.next_state.float_features
        not_terminal = batch.not_terminal.to(torch.float32)
        reward = batch.reward
        if self.params.fit_only_one_next_step:
            next_state, not_terminal, reward = next_state[-1:], not_terminal[-1:], reward[-1:]
            mus, sigmas, logpi, nts, rs = mus[-1:], sigmas[-1:], logpi[-1:], nts[-1:], rs[-1:]

        gmm = gmm_loss(next_state, mus, sigmas, logpi) * self.params.next_state_loss_weight
        bce = (torch.mean(sigmoid_binary_cross_entropy(nts, not_terminal))
               * self.params.not_terminal_loss_weight)
        mse = torch.mean((rs - reward) ** 2) * self.params.reward_loss_weight
        loss = gmm / (state_dim + 2) + bce + mse
        return {"gmm": gmm, "bce": bce, "mse": mse, "loss": loss}

    def train_step(
        self, state: MDNRNNTrainerState, batch: rlt.MemoryNetworkInput
    ) -> Tuple[MDNRNNTrainerState, Dict[str, Tensor]]:
        def loss_fn(p):
            losses = self.get_loss(p, batch)
            return losses["loss"], losses

        _, grads, losses = functional.value_and_grad(loss_fn, state.params, has_aux=True)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (
            MDNRNNTrainerState(params=params, opt_state=opt_state, step=state.step + 1),
            {k: v.detach() for k, v in losses.items()},
        )
