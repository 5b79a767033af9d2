"""DQN trainer whose whole update is one fused call (K1 or K2).

Port of ``reagent_tpu/training/fused_dqn_trainer.py``.  Parameters, target
parameters and Adam moments are carried in the kernels' layout (weights
``[out, in]``, biases ``[1, out]``) for the whole run; conversion to the
q-network's own parameters happens only at init and export.  ``train_step``
is one call of ``ops.fused_dqn.fused_dqn_update`` (K2) or, when
``block_size`` is set, ``ops.fused_dqn_offline.fused_dqn_offline_update``
(K1).  The update writes the state's tensors in place (the JAX trainer
donates them), so a state passed to ``train_step`` must not be reused.

Constraints (checked): plain Adam (no weight decay / amsgrad), mse loss,
scalar-gamma discount (no time_diff exponents), no CPE heads, a dense MLP
q-network with a linear output layer.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.ops.fused_dqn import (
    extract_mlp_layout,
    fused_dqn_update,
    mlp_forward_transposed,
    params_to_kernel_layout,
)
from reagent_tpu_torch.ops.fused_dqn_offline import (
    check_block_size,
    fused_dqn_offline_update,
)
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class FusedDQNTrainerState:
    """Kernel-layout training state."""

    W: Tuple[Tensor, ...]  # [out, in] per layer
    b: Tuple[Tensor, ...]  # [1, out]
    Wt: Tuple[Tensor, ...]
    bt: Tuple[Tensor, ...]
    mW: Tuple[Tensor, ...]
    mb: Tuple[Tensor, ...]
    vW: Tuple[Tensor, ...]
    vb: Tuple[Tensor, ...]
    step: Tensor  # int32 scalar on the device — also the Adam count

    def params8(self):
        return [*self.W, *self.b, *self.Wt, *self.bt,
                *self.mW, *self.mb, *self.vW, *self.vb]


class FusedDQNTrainer:
    """DQN with a fully fused update.

    ``device`` defaults to ``"cuda"`` and raises if no card is present;
    ``block_size`` selects K1 (and must divide ``minibatch_size``).
    """

    def __init__(
        self,
        q_network: nn.Module,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        optimizer: Any = None,
        minibatch_size: int = 512,
        block_size: Optional[int] = None,
        device="cuda",
    ) -> None:
        if rl.q_network_loss != "mse":
            raise ValueError("the fused update supports mse loss only")
        if rl.use_seq_num_diff_as_time_diff or rl.multi_steps is not None:
            raise ValueError("the fused update uses a scalar gamma discount")
        opt_cfg = dict(optimizer or {"Adam": {}})
        if list(opt_cfg) != ["Adam"]:
            raise ValueError(f"the fused update supports Adam only, got {list(opt_cfg)}")
        kw = dict(opt_cfg["Adam"] or {})
        if kw.get("weight_decay") or kw.get("amsgrad"):
            raise ValueError("the fused update supports plain Adam only")
        self.lr = float(kw.get("lr", 1e-3))
        self.b1, self.b2 = (float(x) for x in kw.get("betas", (0.9, 0.999)))
        self.eps = float(kw.get("eps", 1e-8))
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.double_q_learning = double_q_learning
        self.minibatch_size = int(minibatch_size)
        check_block_size(self.minibatch_size, block_size)
        self.block_size = block_size
        self.device = resolve_device(device)
        self.q_network = q_network.to(self.device)
        _, self.dims = extract_mlp_layout(q_network)
        acts = list(getattr(q_network, "activations", []))
        acts += ["linear"] * (len(self.dims) - len(acts))
        if acts[-1] not in ("linear", "identity"):
            raise ValueError(
                "the fused update's analytic backward assumes a linear output "
                f"layer; got final activation {acts[-1]!r}"
            )
        self.activations = acts
        kernel_kw = dict(
            activations=acts, gamma=self.gamma, tau=self.tau,
            double_q_learning=double_q_learning, b1=self.b1, b2=self.b2,
        )
        if block_size is not None:
            self._update = functools.partial(
                fused_dqn_offline_update, block_size=block_size, **kernel_kw)
        else:
            self._update = functools.partial(fused_dqn_update, **kernel_kw)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> FusedDQNTrainerState:
        """Draw fresh q-network weights from ``generator`` and build the state."""
        self.q_network.reset_parameters(generator)
        return self.state_from_q_network()

    def state_from_q_network(self) -> FusedDQNTrainerState:
        """The training state for the q-network's current weights (fresh Adam).

        A one-time numeric probe checks that the kernels' forward, with the
        activation list read from the network, matches the network's own
        forward.  It catches networks whose ``activations`` attribute is
        absent or mismatched before they train with wrong gradients.  The
        probe input is a fixed NONZERO ramp: at zero input with zero biases
        every activation agrees and the probe proves nothing.
        """
        W, b = params_to_kernel_layout(self.q_network)
        obs_dim = self.dims[0][0]
        probe_x = torch.linspace(-1.0, 1.0, obs_dim, device=self.device).reshape(1, -1)
        with torch.no_grad():
            probe = mlp_forward_transposed(probe_x, W, b, self.activations)
            want = self.q_network(probe_x).reshape(probe.shape)
        if not torch.allclose(probe, want, atol=1e-4, rtol=1e-4):
            raise ValueError(
                "FusedDQNTrainer activation mismatch: kernel forward with "
                f"activations {self.activations} disagrees with the q-network's "
                f"forward (max abs diff {float((probe - want).abs().max()):.3e}). "
                "Ensure the q-network exposes an `activations` list matching "
                "its layers and has a linear output layer."
            )

        def zeros(xs):
            return tuple(torch.zeros_like(x) for x in xs)

        return FusedDQNTrainerState(
            W=tuple(W), b=tuple(b),
            Wt=tuple(w.clone() for w in W), bt=tuple(x.clone() for x in b),
            mW=zeros(W), mb=zeros(b), vW=zeros(W), vb=zeros(b),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # ------------------------------------------------------------ train step

    def train_step(
        self, state: FusedDQNTrainerState, batch: rlt.DiscreteDqnInput
    ) -> Tuple[FusedDQNTrainerState, Dict[str, Tensor]]:
        """One fused update.  Writes ``state``'s tensors in place and returns
        it with the step advanced, plus the metrics as device scalars."""
        B = self.minibatch_size
        rows = batch.state.float_features.shape[0]
        if rows != B:
            raise ValueError(
                f"batch has {rows} rows but the trainer was built for "
                f"minibatch_size={B}; the fused update takes one batch size"
            )
        t = (state.step + 1).to(torch.float32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        lr_t = (self.lr * torch.sqrt(bc2) / bc1).to(torch.float32)
        eps_t = (self.eps * torch.sqrt(bc2)).to(torch.float32)

        def f32(x, shape=None):
            x = x.to(device=self.device, dtype=torch.float32)
            return (x.reshape(shape) if shape else x).contiguous()

        m = self._update(
            lr_t, eps_t,
            f32(batch.state.float_features),
            f32(batch.next_state.float_features),
            f32(batch.action),
            f32(batch.reward, (B, 1)),
            f32(batch.not_terminal, (B, 1)),
            f32(batch.possible_next_actions_mask),
            state.params8(),
        )
        state = dataclasses.replace(state, step=state.step + 1)
        metrics = {
            "td_loss": m[0, 0],
            "q_values_mean": m[0, 1],
            "q_taken_mean": m[0, 2],
            "reward_mean": m[0, 3],
        }
        return state, metrics

    def _run_steps(self, state, num_steps, generator, num_rows, batch_of):
        outs = []
        for _ in range(num_steps):
            idx = torch.randint(
                0, num_rows, (self.minibatch_size,), generator=generator,
                device=self.device,
            )
            state, m = self.train_step(state, batch_of(idx))
            outs.append(m)
        return state, {k: torch.stack([m[k] for m in outs]) for k in outs[0]}

    def make_sampled_train_fn(
        self, dataset: rlt.DiscreteDqnInput, num_steps: int,
        num_rows: Optional[int] = None,
    ):
        """``(state, generator) -> (state, metrics)``: ``num_steps`` updates,
        each on a minibatch sampled with replacement from the device-resident
        ``dataset`` (``generator`` lives on the trainer's device)."""
        fields = {
            "state": dataset.state.float_features,
            "next_state": dataset.next_state.float_features,
            "action": dataset.action,
            "reward": dataset.reward,
            "not_terminal": dataset.not_terminal,
            "possible_next_actions_mask": dataset.possible_next_actions_mask,
        }
        if num_rows is None:
            num_rows = fields["state"].shape[0]
        # a field with the wrong leading dim would be gathered with the wrong
        # rows and train silently on garbage
        bad = [(k, tuple(x.shape)) for k, x in fields.items()
               if x.ndim < 1 or x.shape[0] != num_rows]
        if bad:
            raise ValueError(
                f"dataset fields {bad} do not have leading dim num_rows={num_rows}")

        def batch_of(idx):
            g = {k: x[idx] for k, x in fields.items()}
            return _batch(g["state"], g["next_state"], g["action"], g["reward"],
                          g["not_terminal"], g["possible_next_actions_mask"])

        def run(state, generator):
            return self._run_steps(state, num_steps, generator, num_rows, batch_of)

        return run

    def make_packed_sampled_train_fn(
        self, dataset: rlt.DiscreteDqnInput, num_steps: int,
        num_rows: Optional[int] = None,
    ):
        """Like ``make_sampled_train_fn``, but the dataset is packed ONCE into
        a single [N, 2S + 2A + 2] row matrix so each step does one row gather
        instead of six."""
        S = dataset.state.float_features.shape[1]
        A = dataset.action.shape[1]
        if num_rows is None:
            num_rows = dataset.state.float_features.shape[0]
        packed = torch.cat(
            [
                dataset.state.float_features.to(torch.float32),
                dataset.next_state.float_features.to(torch.float32),
                dataset.action.to(torch.float32),
                dataset.reward.to(torch.float32).reshape(num_rows, 1),
                dataset.not_terminal.to(torch.float32).reshape(num_rows, 1),
                dataset.possible_next_actions_mask.to(torch.float32),
            ],
            dim=1,
        ).to(self.device)

        def batch_of(idx):
            rows = packed[idx]
            return _batch(
                rows[:, :S], rows[:, S:2 * S], rows[:, 2 * S:2 * S + A],
                rows[:, 2 * S + A:2 * S + A + 1],
                rows[:, 2 * S + A + 1:2 * S + A + 2], rows[:, 2 * S + A + 2:],
            )

        def run(state, generator):
            return self._run_steps(state, num_steps, generator, num_rows, batch_of)

        return run

    # ------------------------------------------------------------- inference

    def q_values(self, state: FusedDQNTrainerState, obs: Tensor) -> Tensor:
        with torch.no_grad():
            return mlp_forward_transposed(obs, state.W, state.b, self.activations)

    # ------------------------------------------------------------- export

    def export_q_network(self, state: FusedDQNTrainerState) -> nn.Module:
        """A copy of the q-network holding the state's online weights (for
        the serving module and the exported artifact)."""
        net = copy.deepcopy(self.q_network)
        linears, _ = extract_mlp_layout(net)
        with torch.no_grad():
            for layer, w, b in zip(linears, state.W, state.b):
                layer.weight.copy_(w)
                layer.bias.copy_(b.reshape(-1))
        return net


def _batch(s, ns, a, r, nt, mask) -> rlt.DiscreteDqnInput:
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=s),
        next_state=rlt.FeatureData(float_features=ns),
        action=a, next_action=a, reward=r, time_diff=None, step=None,
        not_terminal=nt, possible_actions_mask=mask,
        possible_next_actions_mask=mask,
    )
