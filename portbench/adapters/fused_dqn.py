"""Double-Q DQN through ``FusedDQNTrainer``: each update is one call of K1
(``ops.fused_dqn_offline``), and the loop is the trainer's
``make_packed_sampled_train_fn`` over the table packed once on the device."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor

MATMUL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dataset_of(table: Dict[str, Tensor]):
    from reagent_tpu_torch.core import types as rlt

    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=table["state"]),
        next_state=rlt.FeatureData(float_features=table["next_state"]),
        reward=table["reward"], time_diff=None, step=None,
        not_terminal=table["not_terminal"], action=table["action"],
        possible_actions_mask=table["possible_actions_mask"],
        possible_next_actions_mask=table["possible_next_actions_mask"],
    )


def q_network(cfg: dict, weights, device, action_dim: int):
    """The port's ``FullyConnectedDQN`` at the configuration's widths, holding
    ``weights``."""
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN

    hidden = cfg["hidden_sizes"]
    net = FullyConnectedDQN(state_dim=cfg["state_dim"], action_dim=action_dim,
                            sizes=hidden, activations=[cfg["activation"]] * len(hidden))
    net = net.to(device)
    with torch.no_grad():
        for layer, (w, b) in zip(net.net.layers, weights):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return net


class Program:
    def __init__(self, cfg, traffic, table, weights, device, precision: str) -> None:
        from reagent_tpu_torch.core.parameters import RLParameters
        from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

        if precision not in MATMUL_DTYPES:
            raise ValueError(f"the fused update runs float32 or bfloat16, not {precision!r}")
        self.trainer = FusedDQNTrainer(
            q_network(cfg, weights, device, cfg["num_actions"]),
            RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["target_update_rate"],
                         q_network_loss=cfg["loss"]),
            double_q_learning=cfg["double_q_learning"], optimizer=cfg["optimizer"],
            minibatch_size=traffic["minibatch"], block_size=cfg["block_size"],
            matmul_dtype=MATMUL_DTYPES[precision], device=device)
        self.state = self.trainer.state_from_q_network()
        self.dataset = dataset_of(table)

    def run_fn(self, num_steps: int):
        return self.trainer.make_packed_sampled_train_fn(self.dataset, num_steps=num_steps)

    @staticmethod
    def _named(W, b) -> Dict[str, Tensor]:
        out = {}
        for i, (w, bias) in enumerate(zip(W, b)):
            out[f"layer{i}.weight"] = w.clone()
            out[f"layer{i}.bias"] = bias.reshape(-1).clone()
        return out

    def first_moments(self, state) -> Dict[str, Tensor]:
        return self._named(state.mW, state.mb)

    def online_target(self, state) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        return self._named(state.W, state.b), self._named(state.Wt, state.bt)
