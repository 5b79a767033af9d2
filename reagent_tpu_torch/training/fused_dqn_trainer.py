"""DQN trainer whose whole update is one fused call (K1 or K2).

Port of ``reagent_tpu/training/fused_dqn_trainer.py``.  Parameters, target
parameters and Adam moments are carried in the kernels' layout (weights
``[out, in]``, biases ``[1, out]``) for the whole run; conversion to the
q-network's own parameters happens only at init and export.  ``train_step``
is one call of ``ops.fused_dqn.fused_dqn_update`` (K2) or, when
``block_size`` is set, ``ops.fused_dqn_offline.fused_dqn_offline_update``
(K1); ``train_step_packed`` is one call of K2's packed interface on raw
``PackedReplayBuffer`` rows (the fused online loop's update).  The update
writes the state's tensors in place (the JAX trainer donates them), so a
state passed to a train step must not be reused.  ``q_values`` is one K3
launch (``ops.fused_mlp.fused_mlp_forward``): the online loops' act step.

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
    check_kernel_dtype,
    extract_mlp_layout,
    fused_dqn_update,
    fused_dqn_update_packed,
    mlp_forward_transposed,
    params_to_kernel_layout,
)
from reagent_tpu_torch.ops.fused_dqn_offline import (
    check_block_size,
    fused_dqn_offline_update,
)
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward
from reagent_tpu_torch.training.scan_loop import check_num_steps, run_sampled_steps
from reagent_tpu_torch.utils.device import resolve_device
from reagent_tpu_torch.utils.profiling import annotate

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
    ``block_size`` selects K1 (and must divide ``minibatch_size``), so that
    ``minibatch_size`` can be offline-sized (4096+).  With K1,
    ``matmul_dtype=torch.bfloat16`` runs the update's matrix products on the
    tensor cores in bfloat16 with float32 accumulation and keeps the saved
    activations in bfloat16 (``None`` means float32).  K2 has no such option:
    asking for it without ``block_size`` raises, where the JAX trainer drops
    it silently.
    """

    def __init__(
        self,
        q_network: nn.Module,
        rl: RLParameters = RLParameters(),
        double_q_learning: bool = True,
        optimizer: Any = None,
        minibatch_size: int = 512,
        block_size: Optional[int] = None,
        matmul_dtype: Optional[torch.dtype] = None,
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
        self.matmul_dtype = torch.float32 if matmul_dtype is None else matmul_dtype
        check_kernel_dtype("matmul_dtype", self.matmul_dtype)
        if block_size is None and self.matmul_dtype != torch.float32:
            raise ValueError(
                f"matmul_dtype={self.matmul_dtype} needs block_size: only the "
                "offline fused update (K1) has reduced-precision products")
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
                fused_dqn_offline_update, block_size=block_size,
                matmul_dtype=self.matmul_dtype, **kernel_kw)
        else:
            self._update = functools.partial(fused_dqn_update, **kernel_kw)
        self._update_packed = functools.partial(fused_dqn_update_packed, **kernel_kw)

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
        lr_t, eps_t = self._adam_scalars(state)

        def f32(x, shape=None):
            x = x.to(device=self.device, dtype=torch.float32)
            return (x.reshape(shape) if shape else x).contiguous()

        with annotate("reagent.fused_dqn.stage"):
            fields = (
                f32(batch.state.float_features),
                f32(batch.next_state.float_features),
                f32(batch.action),
                f32(batch.reward, (B, 1)),
                f32(batch.not_terminal, (B, 1)),
                f32(batch.possible_next_actions_mask),
            )
        m = self._update(lr_t, eps_t, *fields, state.params8())
        return dataclasses.replace(state, step=state.step + 1), _metrics(m)

    def _adam_scalars(self, state: FusedDQNTrainerState) -> Tuple[Tensor, Tensor]:
        """This step's ``lr_t`` and ``eps_t`` (Adam's bias correction), on the
        device."""
        t = (state.step + 1).to(torch.float32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        lr_t = (self.lr * torch.sqrt(bc2) / bc1).to(torch.float32)
        eps_t = (self.eps * torch.sqrt(bc2)).to(torch.float32)
        return lr_t, eps_t

    # ------------------------------------------------- packed-row fast path

    def configure_packed(self, rb) -> Tuple[int, int, int, int]:
        """The ``(obs, action, reward, terminal)`` columns of a
        ``PackedReplayBuffer``'s rows, for ``train_step_packed``; call after
        ``rb.init`` (which sets the row layout)."""
        if self.block_size is not None:
            raise ValueError("the packed update is K2's; it takes no block_size")
        obs_dim = self.dims[0][0]
        if rb.field_size("observation") != obs_dim:
            raise ValueError(
                f"the buffer's observations have {rb.field_size('observation')} "
                f"columns; the q-network takes {obs_dim}")
        return tuple(rb.column(k) for k in ("observation", "action", "reward", "terminal"))

    def train_step_packed(
        self, state: FusedDQNTrainerState, rows: Tensor, next_rows: Tensor,
        cols: Tuple[int, int, int, int],
    ) -> Tuple[FusedDQNTrainerState, Dict[str, Tensor]]:
        """One fused update straight from gathered replay rows [B, row_width]
        (no batch assembly); every next action is possible.  Writes
        ``state``'s tensors in place, as ``train_step`` does."""
        if rows.shape[0] != self.minibatch_size:
            raise ValueError(
                f"rows hold {rows.shape[0]} transitions but the trainer was "
                f"built for minibatch_size={self.minibatch_size}")
        lr_t, eps_t = self._adam_scalars(state)
        m = self._update_packed(lr_t, eps_t, rows, next_rows, state.params8(), cols=cols)
        return dataclasses.replace(state, step=state.step + 1), _metrics(m)

    def make_sampled_train_fn(
        self, dataset: rlt.DiscreteDqnInput, num_steps: int,
        num_rows: Optional[int] = None,
    ):
        """``(state, generator) -> (state, metrics)``: ``num_steps`` updates,
        each on a minibatch sampled with replacement from the device-resident
        ``dataset`` (``generator`` lives on the trainer's device)."""
        check_num_steps(num_steps)
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
            return run_sampled_steps(
                self.train_step, state, batch_of, num_steps, self.minibatch_size,
                num_rows, generator)

        return run

    def make_packed_sampled_train_fn(
        self, dataset: rlt.DiscreteDqnInput, num_steps: int,
        num_rows: Optional[int] = None,
    ):
        """Like ``make_sampled_train_fn``, but the dataset is packed ONCE into
        a single [N, 2S + 2A + 2] row matrix so each step does one row gather
        instead of six."""
        check_num_steps(num_steps)
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
            return run_sampled_steps(
                self.train_step, state, batch_of, num_steps, self.minibatch_size,
                num_rows, generator)

        return run

    # ------------------------------------------------------------- inference

    def mlp_weights(self, state: FusedDQNTrainerState):
        """The online weights as K3's ``[(W [in, out], b [out])]``: views of
        the state's ``[out, in]`` / ``[1, out]`` tensors, no copy."""
        return [(w.T, b.reshape(-1)) for w, b in zip(state.W, state.b)]

    def q_values(self, state: FusedDQNTrainerState, obs: Tensor) -> Tensor:
        """Q [B, A] for obs [B, D]: one K3 launch on a CUDA tensor."""
        with torch.no_grad():
            return fused_mlp_forward(obs, self.mlp_weights(state), self.activations)

    # ------------------------------------------------------------- interop

    def from_dqn_state(self, dqn_state) -> FusedDQNTrainerState:
        """Adopt a ``DQNTrainerState`` of the same q-network: online and
        target weights and the Adam moments as copies in the kernels' layout,
        the step taken from Adam's count.  The state's optimizer must be
        plain Adam (it carries ``mu`` and ``nu``)."""
        opt = dqn_state.opt_state
        if opt.mu is None or opt.nu is None or opt.nu_max is not None:
            raise ValueError("from_dqn_state needs a plain Adam optimizer state (mu and nu)")
        names = [n for n, m in self.q_network.named_modules() if isinstance(m, nn.Linear)]

        def layout(tree):
            f32 = dict(device=self.device, dtype=torch.float32)
            return (tuple(tree[f"{n}.weight"].detach().to(**f32).clone() for n in names),
                    tuple(tree[f"{n}.bias"].detach().to(**f32).reshape(1, -1).clone()
                          for n in names))

        W, b = layout(dqn_state.q_params)
        Wt, bt = layout(dqn_state.q_target_params)
        mW, mb = layout(opt.mu)
        vW, vb = layout(opt.nu)
        return FusedDQNTrainerState(
            W=W, b=b, Wt=Wt, bt=bt, mW=mW, mb=mb, vW=vW, vb=vb,
            step=opt.count.detach().to(device=self.device, dtype=torch.int32).clone(),
        )

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


def _metrics(m: Tensor) -> Dict[str, Tensor]:
    return {
        "td_loss": m[0, 0],
        "q_values_mean": m[0, 1],
        "q_taken_mean": m[0, 2],
        "reward_mean": m[0, 3],
    }


def _batch(s, ns, a, r, nt, mask) -> rlt.DiscreteDqnInput:
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=s),
        next_state=rlt.FeatureData(float_features=ns),
        action=a, next_action=a, reward=r, time_diff=None, step=None,
        not_terminal=nt, possible_actions_mask=mask,
        possible_next_actions_mask=mask,
    )
