"""Sequential (RL) OPE estimators: DM, IPS, DR, MAGIC, NeuralDualDICE.

Port of ``reagent_tpu/ope/estimators/sequential_estimators.py``: the numpy
estimators copied, MAGIC on the port's WSDR estimator and evaluation page,
``NeuralDualDICE`` in torch.

Reference: reagent/ope/estimators/sequential_estimators.py:221-533.
Inputs are padded trajectory arrays (the vectorized form of the reference's
per-transition Transition/MDPSequence objects).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from reagent_tpu_torch.ope.estimators.estimator import Estimator, EstimatorResult


@dataclasses.dataclass
class RLEstimatorInput:
    """Padded trajectories over N episodes and horizon T, A discrete actions.

    actions: [N, T] int; rewards: [N, T]; log_propensities: [N, T] of logged
    action; tgt_propensities: [N, T, A]; mask: [N, T] valid steps;
    q_values: [N, T, A] model Q for the target policy (optional);
    states: [N, T, S] raw features (optional, for DICE).
    """

    gamma: float
    actions: np.ndarray
    rewards: np.ndarray
    log_propensities: np.ndarray
    tgt_propensities: np.ndarray
    mask: np.ndarray
    q_values: Optional[np.ndarray] = None
    states: Optional[np.ndarray] = None
    ground_truth_reward: Optional[float] = None

    @property
    def n(self):
        return self.actions.shape[0]

    @property
    def horizon(self):
        return self.actions.shape[1]

    def discounts(self) -> np.ndarray:
        return self.gamma ** np.arange(self.horizon)

    def log_value(self) -> float:
        return float(np.mean(np.sum(self.rewards * self.mask * self.discounts(), axis=1)))

    def tgt_prop_of_logged(self) -> np.ndarray:
        n, t = self.actions.shape
        return self.tgt_propensities[
            np.arange(n)[:, None], np.arange(t)[None, :], self.actions
        ]

    def cum_importance_weights(self, self_normalize: bool = True) -> np.ndarray:
        """rho = cumprod(pi_e/pi_b) zeroed at masked steps, normalized per
        timestep column — by the column weight-sum ("weighted", the reference
        default) or the column valid-count; near-zero denominators get +N
        (reference sequential_estimators.py:266-298 _calc_weights)."""
        ratio = np.where(
            self.mask > 0,
            self.tgt_prop_of_logged() / np.maximum(self.log_propensities, 1e-12),
            1.0,
        )
        w = np.cumprod(ratio, axis=1) * self.mask
        if self_normalize:
            denom = np.sum(w, axis=0, keepdims=True)
        else:
            denom = np.sum(self.mask, axis=0, keepdims=True)
        denom = denom + (denom < 1.0e-15) * len(w)
        return w / denom


    def with_absorbing_padding(self) -> "RLEstimatorInput":
        """Replace masked (post-termination) steps with absorbing transitions:
        reward 0, importance ratio 1, Q = V = 0, mask 1.

        The reference weighting (sequential_estimators.py:290-298) gives the
        episodes surviving at step t the FULL column weight, so logs of
        episodes that simply end overweight long survivors; padding episodic
        logs with an absorbing state keeps every episode in the per-step
        denominator and is the statistically sound preparation for the
        reference semantics.
        """
        dead = self.mask <= 0
        A = self.tgt_propensities.shape[2]
        actions = np.where(dead, 0, self.actions)
        rewards = np.where(dead, 0.0, self.rewards)
        log_prop = np.where(dead, 1.0, self.log_propensities)
        tgt_prop = np.where(
            dead[:, :, None], np.eye(A)[np.zeros_like(self.actions)],
            self.tgt_propensities,
        )
        q_values = (
            None
            if self.q_values is None
            else np.where(dead[:, :, None], 0.0, self.q_values)
        )
        return dataclasses.replace(
            self,
            actions=actions,
            rewards=rewards,
            log_propensities=log_prop,
            tgt_propensities=tgt_prop,
            mask=np.ones_like(self.mask),
            q_values=q_values,
        )


def _res(input: RLEstimatorInput, est_per_traj: np.ndarray) -> EstimatorResult:
    return EstimatorResult(
        log_reward=input.log_value(),
        estimated_reward=float(np.sum(est_per_traj)) if est_per_traj.ndim else float(est_per_traj),
        ground_truth_reward=input.ground_truth_reward,
    )


class DMEstimator(Estimator):
    """Direct method (reference :221-246): the reference's _estimate_value
    (:205-218) sums the model state value along the LOGGED trajectory,
    mean_episodes[ Σ_t γ^t V(s_t) ], with V(s) = Σ_a π_tgt(a|s) Q(s, a) —
    not just V(s_0)."""

    def evaluate(self, input: RLEstimatorInput, **kwargs) -> EstimatorResult:
        assert input.q_values is not None
        v = np.sum(input.tgt_propensities * input.q_values, axis=2)  # [N, T]
        est = np.sum(v * input.mask * input.discounts(), axis=1)
        return EstimatorResult(
            log_reward=input.log_value(),
            estimated_reward=float(np.mean(est)),
            ground_truth_reward=input.ground_truth_reward,
        )


class IPSEstimator(Estimator):
    """Per-step weighted IS (reference :250-340)."""

    def __init__(self, self_normalize: bool = True):
        self.self_normalize = self_normalize

    def evaluate(self, input: RLEstimatorInput, **kwargs) -> EstimatorResult:
        w = input.cum_importance_weights(self.self_normalize)
        est = np.sum(w * input.rewards * input.mask * input.discounts(), axis=1)
        return _res(input, est)


class DoublyRobustEstimator(Estimator):
    """Per-step DR (reference :349-430); the same step-return math as the
    evaluation-side MAGIC j=inf case."""

    def __init__(self, self_normalize: bool = True):
        self.self_normalize = self_normalize

    def evaluate(self, input: RLEstimatorInput, **kwargs) -> EstimatorResult:
        assert input.q_values is not None
        n, t = input.actions.shape
        w = input.cum_importance_weights(self.self_normalize)
        w_prev = np.hstack([np.full((n, 1), 1.0 / n), w[:, :-1]])
        disc = input.discounts()
        q_logged = input.q_values[
            np.arange(n)[:, None], np.arange(t)[None, :], input.actions
        ]
        v = np.sum(input.tgt_propensities * input.q_values, axis=2)
        est = np.sum(
            (w * input.rewards * input.mask - (w * q_logged - w_prev * v) * input.mask)
            * disc,
            axis=1,
        )
        return _res(input, est)


class MAGICEstimator(Estimator):
    """Blend of j-step returns (reference :430-533); delegates to the
    evaluation-side implementation on the same padded arrays."""

    def __init__(self, num_j_steps: int = 25):
        self.num_j_steps = num_j_steps

    def evaluate(self, input: RLEstimatorInput, **kwargs) -> EstimatorResult:
        from reagent_tpu_torch.evaluation.weighted_sequential_doubly_robust_estimator import (
            WeightedSequentialDoublyRobustEstimator,
        )
        from reagent_tpu_torch.evaluation.evaluation_data_page import EvaluationDataPage

        n, t = input.actions.shape
        A = input.tgt_propensities.shape[2]
        # flatten padded trajectories into an EDP-shaped table
        keep = input.mask.reshape(-1) > 0
        mdp_id = np.repeat(np.arange(n), t).reshape(-1, 1)[keep]
        action_mask = np.eye(A)[input.actions.reshape(-1)][keep]
        edp = EvaluationDataPage(
            mdp_id=mdp_id,
            sequence_number=np.tile(np.arange(t), n).reshape(-1, 1)[keep],
            logged_propensities=input.log_propensities.reshape(-1, 1)[keep],
            logged_rewards=input.rewards.reshape(-1, 1)[keep],
            action_mask=action_mask,
            model_propensities=input.tgt_propensities.reshape(-1, A)[keep],
            model_rewards=np.zeros_like(action_mask),
            model_rewards_for_logged_action=np.zeros((int(keep.sum()), 1)),
            model_values=input.q_values.reshape(-1, A)[keep],
        )
        est = WeightedSequentialDoublyRobustEstimator(input.gamma).estimate(
            edp, num_j_steps=self.num_j_steps,
            whether_self_normalize_importance_weights=True,
        )
        return EstimatorResult(
            log_reward=input.log_value(),
            estimated_reward=est.raw,
            ground_truth_reward=input.ground_truth_reward,
            estimated_reward_std_error=est.raw_std_error,
        )


@dataclasses.dataclass
class DualDICEData:
    """The logged transitions ``NeuralDualDICE`` trains on, on its device:
    the valid steps' states ``s`` [n, S], actions ``a`` [n], rewards ``r``
    [n], next states ``ns`` [n, S] (the last step maps to itself) and the
    target policy there ``tgt_next`` [n, A]; the episodes' first states
    ``s0`` [N, S] and the target policy there ``tgt0`` [N, A]."""

    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    ns: torch.Tensor
    tgt_next: torch.Tensor
    s0: torch.Tensor
    tgt0: torch.Tensor
    gamma: float


@dataclasses.dataclass
class DualDICEState:
    """The nu and zeta nets' parameters (``FullyConnectedNetwork`` names) and
    their Adam states."""

    nu: Dict[str, torch.Tensor]
    zeta: Dict[str, torch.Tensor]
    nu_opt: Any
    zeta_opt: Any


class NeuralDualDICE(Estimator):
    """DualDICE stationary-distribution correction (Nachum et al. 2019).

    Reference: sequential_estimators.py:533+ (torch MLPs there).  Learns
    nu(s, a) and zeta(s, a) by the saddle-point objective; the estimate is
    E_log[zeta * reward] / (1 - gamma)-normalized.

    The JAX package's estimator (``reagent_tpu/ope/estimators/
    sequential_estimators.py:243-340``) in torch: the nets are
    Dense(hidden)-relu-Dense(hidden)-relu-Dense(A) ``FullyConnectedNetwork``s
    initialized as flax's ``nn.Dense`` (lecun-normal kernels, zero biases);
    each step is autograd of the objective, nu descending it and zeta
    ascending it, each with the port's Adam rule (optax's).  Where JAX draws
    the init and each step's batch indices from ``PRNGKey(0)``, ``evaluate``
    takes them as values (``params``: the two nets' parameters;
    ``indices``: ``[training_samples, batch_size]`` rows of the logged steps
    and of the first states) or draws them from a CPU ``torch.Generator``
    (seed 0 by default).  The training loop reads nothing back to the host;
    the final ``zeta(s)[a] * r / (1 - gamma)`` forward is one K3 launch on a
    CUDA tensor (``training/functional.py::score``).
    """

    def __init__(
        self,
        state_dim: int,
        num_actions: int,
        hidden_dim: int = 64,
        training_samples: int = 2000,
        batch_size: int = 256,
        lr: float = 1e-3,
        zeta_lr: float = 1e-3,
        device="cuda",
    ):
        from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
        from reagent_tpu_torch.optim.union import AdamRule
        from reagent_tpu_torch.utils.device import resolve_device

        self.state_dim = state_dim
        self.num_actions = num_actions
        self.hidden_dim = hidden_dim
        self.training_samples = training_samples
        self.batch_size = batch_size
        self.lr = lr
        self.zeta_lr = zeta_lr
        self.device = resolve_device(device)
        self.net = FullyConnectedNetwork(
            [state_dim, hidden_dim, hidden_dim, num_actions], ["relu", "relu", "linear"]
        ).to(self.device)
        self.nu_opt = AdamRule(lr, 0.9, 0.999, 1e-8)
        self.zeta_opt = AdamRule(zeta_lr, 0.9, 0.999, 1e-8)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One net's parameters as flax's ``nn.Dense`` draws them, from a CPU
        ``generator``."""
        from reagent_tpu_torch.models.mdn_rnn import _lecun_normal_fill

        params = {}
        for i, layer in enumerate(self.net.layers):
            kernel = torch.empty((layer.in_features, layer.out_features))
            _lecun_normal_fill(kernel, generator)
            params[f"layers.{i}.weight"] = kernel.T.contiguous().to(self.device)
            params[f"layers.{i}.bias"] = torch.zeros(layer.out_features, device=self.device)
        return params

    def init(self, nu, zeta) -> DualDICEState:
        return DualDICEState(nu=nu, zeta=zeta, nu_opt=self.nu_opt.init(nu),
                             zeta_opt=self.zeta_opt.init(zeta))

    def data(self, input: RLEstimatorInput) -> DualDICEData:
        assert input.states is not None
        n, t = input.actions.shape
        keep = input.mask.reshape(-1) > 0
        ns_full = np.concatenate(
            [input.states[:, 1:], input.states[:, -1:]], axis=1
        ).reshape(n * t, -1)
        tgt_next = np.concatenate(
            [input.tgt_propensities[:, 1:], input.tgt_propensities[:, -1:]], axis=1
        ).reshape(n * t, -1)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x)).to(self.device, dtype)

        return DualDICEData(
            s=dev(input.states.reshape(n * t, -1)[keep]),
            a=dev(input.actions.reshape(-1)[keep], torch.int64),
            r=dev(input.rewards.reshape(-1)[keep]),
            ns=dev(ns_full[keep]),
            tgt_next=dev(tgt_next[keep]),
            s0=dev(input.states[:, 0]),
            tgt0=dev(input.tgt_propensities[:, 0]),
            gamma=input.gamma,
        )

    def draw_indices(self, data: DualDICEData, generator: torch.Generator):
        """Each step's rows of the logged steps and of the first states,
        ``[training_samples, batch_size]`` each, from a CPU ``generator``."""
        shape = (self.training_samples, self.batch_size)
        idx = torch.randint(0, data.s.shape[0], shape, generator=generator)
        i0 = torch.randint(0, data.s0.shape[0], shape, generator=generator)
        return idx.to(self.device), i0.to(self.device)

    def objective(self, data: DualDICEData, nu, zeta, idx, i0) -> torch.Tensor:
        from reagent_tpu_torch.training.functional import apply

        bs, ba, bns, btn = data.s[idx], data.a[idx], data.ns[idx], data.tgt_next[idx]
        bs0, bt0 = data.s0[i0], data.tgt0[i0]
        B = bs.shape[0]
        nu_out = apply(self.net, nu, torch.cat([bs, bns, bs0]))
        nu_sa = torch.gather(nu_out[:B], 1, ba[:, None])[:, 0]
        nu_next = torch.sum(nu_out[B:2 * B] * btn, dim=1)
        nu0 = torch.sum(nu_out[2 * B:] * bt0, dim=1)
        zeta_sa = torch.gather(apply(self.net, zeta, bs), 1, ba[:, None])[:, 0]
        bellman_residual = nu_sa - data.gamma * nu_next
        # f(x) = x^2/2 convex conjugate form (DualDICE eq. 6)
        return torch.mean(bellman_residual * zeta_sa - 0.5 * zeta_sa**2) - (
            1 - data.gamma) * torch.mean(nu0)

    def step(self, data: DualDICEData, state: DualDICEState, idx, i0) -> DualDICEState:
        """One step on batch rows ``idx`` and first-state rows ``i0`` (device
        tensors [batch_size]): nu minimizes the objective, zeta maximizes it,
        both from the same parameters."""
        nu = {k: v.detach().requires_grad_(True) for k, v in state.nu.items()}
        zeta = {k: v.detach().requires_grad_(True) for k, v in state.zeta.items()}
        obj = self.objective(data, nu, zeta, idx, i0)
        grads = torch.autograd.grad(obj, [*nu.values(), *zeta.values()])
        g_nu = dict(zip(nu, grads[:len(nu)]))
        g_zeta = {k: -g for k, g in zip(zeta, grads[len(nu):])}
        new_nu, nu_opt = self.nu_opt.update(g_nu, state.nu_opt, state.nu)
        new_zeta, zeta_opt = self.zeta_opt.update(g_zeta, state.zeta_opt, state.zeta)
        return DualDICEState(nu=new_nu, zeta=new_zeta, nu_opt=nu_opt, zeta_opt=zeta_opt)

    def estimate(self, data: DualDICEData, state: DualDICEState) -> float:
        """``mean(zeta(s)[a] * r) / (1 - gamma)``: the zeta forward is one K3
        launch on the card."""
        from reagent_tpu_torch.training.functional import score

        zeta_all = torch.gather(score(self.net, state.zeta, data.s), 1, data.a[:, None])[:, 0]
        return float(torch.mean(zeta_all * data.r) / (1 - data.gamma))

    def evaluate(
        self,
        input: RLEstimatorInput,
        params: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]] = None,
        indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> EstimatorResult:
        data = self.data(input)
        if generator is None and (params is None or indices is None):
            generator = torch.Generator().manual_seed(0)
        if params is None:
            params = (self.init_params(generator), self.init_params(generator))
        nu, zeta = ({k: v.to(self.device, torch.float32) for k, v in p.items()}
                    for p in params)
        idx, i0 = (indices if indices is not None else self.draw_indices(data, generator))
        idx, i0 = idx.to(self.device), i0.to(self.device)
        if idx.shape[0] != self.training_samples or i0.shape[0] != self.training_samples:
            raise ValueError(
                f"{self.training_samples} steps need as many rows of indices, got "
                f"{idx.shape[0]} and {i0.shape[0]}")
        state = self.init(nu, zeta)
        for i in range(self.training_samples):
            state = self.step(data, state, idx[i], i0[i])
        self.last_state = state
        return EstimatorResult(
            log_reward=input.log_value(),
            estimated_reward=self.estimate(data, state),
            ground_truth_reward=input.ground_truth_reward,
        )
