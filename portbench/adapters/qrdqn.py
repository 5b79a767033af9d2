"""Double-Q QR-DQN through ``QRDQNTrainer``: the forwards and the backward by
autograd on cuBLAS products, the quantile-Huber loss through K5
(``ops.quantile_huber``), Adam from ``optim/``; the loop is
``training.scan_loop.make_sampled_train_fn`` over the table on the device."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.adapters.fused_dqn import dataset_of, q_network

Tensor = torch.Tensor


class Program:
    def __init__(self, cfg, traffic, table, weights, device, precision: str) -> None:
        from reagent_tpu_torch.core.parameters import RLParameters
        from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

        if precision not in ("float32", "tfloat32"):
            raise ValueError(f"the autograd update runs float32 or tfloat32, not {precision!r}")
        self.minibatch = traffic["minibatch"]
        self.trainer = QRDQNTrainer(
            q_network(cfg, weights, device, cfg["num_actions"] * cfg["num_atoms"]),
            num_atoms=cfg["num_atoms"],
            rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["target_update_rate"]),
            double_q_learning=cfg["double_q_learning"], optimizer=cfg["optimizer"],
            device=device)
        self.state = self.trainer.state_from_q_network()
        self.names = list(self.state.q_params)  # layer order: weight, bias, ...
        self.dataset = dataset_of(table)

    def run_fn(self, num_steps: int):
        from reagent_tpu_torch.training.scan_loop import make_sampled_train_fn

        return make_sampled_train_fn(self.trainer, self.dataset, self.minibatch, num_steps)

    def _named(self, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {f"layer{i // 2}.{'weight' if i % 2 == 0 else 'bias'}": params[k].clone()
                for i, k in enumerate(self.names)}

    def first_moments(self, state) -> Dict[str, Tensor]:
        return self._named(state.opt_state.mu)

    def online_target(self, state) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        return self._named(state.q_params), self._named(state.q_target_params)
