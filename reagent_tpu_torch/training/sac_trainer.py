"""Soft Actor-Critic trainer.

Port of ``reagent_tpu/training/sac_trainer.py:28-315`` (reference:
reagent/training/sac_trainer.py:51,196-386): twin critics, an optional
value network, the entropy temperature fixed or auto-tuned through
log-alpha, and continuous CRR.

One ``train_step`` takes the JAX trainer's steps in its order: the target
(the value target net, or the actor on the next state against the target
critics), the critics' updates, the actor's update against the critics from
BEFORE theirs, the temperature's update on the log-prob with its gradient
stopped, the value net's update against the critics from AFTER theirs, and
the soft updates last; every log-prob is clipped to [-2, 2].  It reads no
value on the host, returns a new state and leaves the one it was given
untouched.

The JAX state carries a key that the step splits three ways; here the two
standard-normal draws (the next state's action, the actor's) come from the
trainer's ``torch.Generator`` on its device, or from ``noise`` where the
caller gives it (the parity tests feed JAX's draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import RLParameters
from reagent_tpu_torch.models.actor import LOG_PROB_MAX, LOG_PROB_MIN
from reagent_tpu_torch.optim import OptState, make_optimizer, soft_update
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class CRRWeightFn:
    """Advantage -> actor-loss weight (reference parameters.py CRRWeightFn;
    sac_trainer.py:269-277 uses it for continuous CRR): exp(A / beta),
    clipped to ``exponent_clamp`` where set, or the indicator A >= threshold."""

    indicator_fn_threshold: Optional[float] = None
    exponent_beta: Optional[float] = None
    exponent_clamp: Optional[float] = None

    def __post_init__(self):
        # `is not None`: a 0.0 indicator threshold (advantage >= 0) is valid
        has_beta = self.exponent_beta is not None
        has_thresh = self.indicator_fn_threshold is not None
        if has_beta == has_thresh:
            raise ValueError("CRRWeightFn takes exactly one of exponent_beta and "
                             "indicator_fn_threshold")

    def get_weight_from_advantage(self, advantage: Tensor) -> Tensor:
        if self.exponent_beta is not None:
            w = torch.exp(advantage / self.exponent_beta)
            if self.exponent_clamp:
                w = torch.clamp(w, 0.0, self.exponent_clamp)
            return w
        return (advantage >= self.indicator_fn_threshold).to(torch.float32)


@dataclasses.dataclass
class SACTrainerState:
    actor_params: Params
    q1_params: Params
    q1_target_params: Params
    actor_opt_state: OptState
    q1_opt_state: OptState
    step: Tensor  # int32 scalar on the device
    q2_params: Optional[Params] = None
    q2_target_params: Optional[Params] = None
    q2_opt_state: Optional[OptState] = None
    log_alpha: Optional[Tensor] = None  # float32 scalar; None: fixed temperature
    alpha_opt_state: Optional[OptState] = None  # over {"log_alpha": log_alpha}
    value_params: Optional[Params] = None
    value_target_params: Optional[Params] = None
    value_opt_state: Optional[OptState] = None


class SACTrainer:
    """``alpha_optimizer`` None fixes the temperature at
    ``entropy_temperature``; ``"default"`` (JAX's default) tunes log-alpha
    with Adam at lr 1e-3.  ``crr_config`` (a ``CRRWeightFn`` or its kwargs)
    needs ``value_network``.  ``device`` defaults to ``"cuda"`` and raises if
    no card is present."""

    def __init__(
        self,
        actor_network: nn.Module,
        q1_network: nn.Module,
        q2_network: Optional[nn.Module] = None,
        value_network: Optional[nn.Module] = None,
        rl: RLParameters = RLParameters(gamma=0.9, target_update_rate=0.005),
        q_network_optimizer: Any = None,
        actor_network_optimizer: Any = None,
        value_network_optimizer: Any = None,
        alpha_optimizer: Any = "default",
        entropy_temperature: float = 0.2,
        target_entropy: float = -1.0,
        backprop_through_log_prob: bool = True,
        crr_config: Optional[CRRWeightFn] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.actor_network = actor_network.to(self.device)
        self.q1_network = q1_network.to(self.device)
        self.q2_network = None if q2_network is None else q2_network.to(self.device)
        self.value_network = None if value_network is None else value_network.to(self.device)
        self.rl = rl
        self.gamma = rl.gamma
        self.tau = rl.target_update_rate
        self.q_opt = make_optimizer(q_network_optimizer)
        self.actor_opt = make_optimizer(actor_network_optimizer)
        self.value_opt = make_optimizer(value_network_optimizer)
        self.autotune_alpha = alpha_optimizer is not None
        self.alpha_opt = make_optimizer(None if alpha_optimizer == "default" else alpha_optimizer)
        self.entropy_temperature = entropy_temperature
        self.target_entropy = target_entropy
        self.backprop_through_log_prob = backprop_through_log_prob
        if isinstance(crr_config, dict):
            crr_config = CRRWeightFn(**crr_config)
        self.crr_config = crr_config
        if crr_config is not None and value_network is None:
            raise ValueError("continuous CRR needs a value network")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> SACTrainerState:
        """Draw fresh weights from ``generator`` (the actor, q1, q2, then the
        value net), seed the trainer's noise stream from it and build the
        state."""
        for net in (self.actor_network, self.q1_network, self.q2_network, self.value_network):
            if net is not None:
                net.reset_parameters(generator)
        self.generator.manual_seed(int(torch.randint(2**62, (), generator=generator)))
        return self.state_from_networks()

    def state_from_networks(self) -> SACTrainerState:
        """The training state for the networks' current weights (targets
        copies, fresh optimizer states, log-alpha at log(entropy_temperature)
        when tuned)."""
        def with_target(net, opt):
            params = functional.params_of(net)
            return params, {k: v.clone() for k, v in params.items()}, opt.init(params)

        actor_params = functional.params_of(self.actor_network)
        q1, q1_t, q1_opt = with_target(self.q1_network, self.q_opt)
        state = SACTrainerState(
            actor_params=actor_params, q1_params=q1, q1_target_params=q1_t,
            actor_opt_state=self.actor_opt.init(actor_params), q1_opt_state=q1_opt,
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        if self.q2_network is not None:
            q2, q2_t, q2_opt = with_target(self.q2_network, self.q_opt)
            state = dataclasses.replace(
                state, q2_params=q2, q2_target_params=q2_t, q2_opt_state=q2_opt)
        if self.autotune_alpha:
            log_alpha = torch.tensor(math.log(self.entropy_temperature), dtype=torch.float32,
                                     device=self.device)
            state = dataclasses.replace(
                state, log_alpha=log_alpha,
                alpha_opt_state=self.alpha_opt.init({"log_alpha": log_alpha}))
        if self.value_network is not None:
            v, v_t, v_opt = with_target(self.value_network, self.value_opt)
            state = dataclasses.replace(
                state, value_params=v, value_target_params=v_t, value_opt_state=v_opt)
        return state

    # ------------------------------------------------------------ train step

    def _min_q(self, q1_params, q2_params, obs, action) -> Tensor:
        q = functional.apply(self.q1_network, q1_params, obs, action)
        if self.q2_network is not None:
            q = torch.minimum(q, functional.apply(self.q2_network, q2_params, obs, action))
        return q

    def train_step(
        self, state: SACTrainerState, batch: rlt.PolicyNetworkInput,
        noise: Optional[Tensor] = None,
    ) -> Tuple[SACTrainerState, Dict[str, Tensor]]:
        """One update.  ``noise`` [2, B, action_dim]: the standard-normal
        draws for the actor on the next state and on the state; drawn from
        the trainer's generator when not given."""
        obs = batch.state.float_features
        action = batch.action.float_features
        next_obs = batch.next_state.float_features
        not_done = batch.not_terminal.to(torch.float32)
        if noise is None:
            noise = torch.randn((2, *action.shape), generator=self.generator,
                                device=action.device)
        r_next, r_actor = noise[0], noise[1]
        zero = torch.zeros((), device=obs.device)
        alpha = (torch.exp(state.log_alpha) if state.log_alpha is not None
                 else torch.full((), self.entropy_temperature, device=obs.device))

        # ---- target value (ref sac_trainer.py:215-237)
        with torch.no_grad():
            if self.value_network is not None:
                next_v = functional.apply(self.value_network, state.value_target_params, next_obs)
            else:
                next_out = functional.apply(
                    self.actor_network, state.actor_params, next_obs, r_next)
                next_v = self._min_q(state.q1_target_params, state.q2_target_params, next_obs,
                                     next_out.action)
                log_prob_a = torch.clamp(next_out.log_prob, LOG_PROB_MIN, LOG_PROB_MAX)
                next_v = next_v - alpha * log_prob_a
            target_q = batch.reward + self.gamma * next_v * not_done

        # ---- critic updates
        def q_loss(net):
            return lambda params: torch.mean(
                (functional.apply(net, params, obs, action) - target_q) ** 2)

        q1_loss, q1_grads, _ = functional.value_and_grad(q_loss(self.q1_network), state.q1_params)
        q2_loss, q2_grads = zero, None
        if self.q2_network is not None:
            q2_loss, q2_grads, _ = functional.value_and_grad(
                q_loss(self.q2_network), state.q2_params)
        with torch.no_grad():
            q1_params, q1_opt_state = self.q_opt.update(
                q1_grads, state.q1_opt_state, state.q1_params)
            q2_params, q2_opt_state = state.q2_params, state.q2_opt_state
            if q2_grads is not None:
                q2_params, q2_opt_state = self.q_opt.update(
                    q2_grads, state.q2_opt_state, state.q2_params)

        # ---- actor update (the critics from before their update, ref order)
        def actor_loss_fn(a_params):
            out = functional.apply(self.actor_network, a_params, obs, r_actor)
            min_q = self._min_q(state.q1_params, state.q2_params, obs, out.action)
            log_prob = torch.clamp(out.log_prob, LOG_PROB_MIN, LOG_PROB_MAX)
            if not self.backprop_through_log_prob:
                log_prob = log_prob.detach()
            if self.crr_config is None:
                return torch.mean(alpha * log_prob - min_q), out
            # continuous CRR (Wang et al. 2020): advantage-weighted regression
            # toward the LOGGED action, A = Q(s, a_log) - V(s)
            with torch.no_grad():
                q_logged = self._min_q(state.q1_params, state.q2_params, obs, action)
                cur_value = functional.apply(self.value_network, state.value_params, obs)
                crr_weight = self.crr_config.get_weight_from_advantage(q_logged - cur_value)
            logged_lp = functional.apply_method(
                self.actor_network, a_params, "get_log_prob", obs, action)
            return -torch.mean(logged_lp * crr_weight), out

        actor_loss, actor_grads, actor_out = functional.value_and_grad(
            actor_loss_fn, state.actor_params, has_aux=True)
        with torch.no_grad():
            actor_params, actor_opt_state = self.actor_opt.update(
                actor_grads, state.actor_opt_state, state.actor_params)
            lp = torch.clamp(actor_out.log_prob, LOG_PROB_MIN, LOG_PROB_MAX)

        # ---- alpha update (ref :311-322), the log-prob's gradient stopped
        log_alpha, alpha_opt_state, alpha_loss = state.log_alpha, state.alpha_opt_state, zero
        if state.log_alpha is not None:
            alpha_loss, alpha_grads, _ = functional.value_and_grad(
                lambda p: -torch.mean(p["log_alpha"] * (lp + self.target_entropy)),
                {"log_alpha": state.log_alpha})
            with torch.no_grad():
                new_alpha, alpha_opt_state = self.alpha_opt.update(
                    alpha_grads, state.alpha_opt_state, {"log_alpha": state.log_alpha})
            log_alpha = new_alpha["log_alpha"]

        # ---- value net update (ref :329-352), the critics from after theirs
        value_params, value_target_params, value_opt_state, value_loss = (
            state.value_params, state.value_target_params, state.value_opt_state, zero)
        if self.value_network is not None:
            with torch.no_grad():
                v_target = self._min_q(q1_params, q2_params, obs, actor_out.action) - alpha * lp
            value_loss, v_grads, _ = functional.value_and_grad(
                lambda vp: torch.mean(
                    (functional.apply(self.value_network, vp, obs) - v_target) ** 2),
                state.value_params)
            with torch.no_grad():
                value_params, value_opt_state = self.value_opt.update(
                    v_grads, state.value_opt_state, state.value_params)
                value_target_params = soft_update(value_params, state.value_target_params,
                                                  self.tau)

        with torch.no_grad():
            new_state = SACTrainerState(
                actor_params=actor_params,
                q1_params=q1_params,
                q1_target_params=soft_update(q1_params, state.q1_target_params, self.tau),
                actor_opt_state=actor_opt_state,
                q1_opt_state=q1_opt_state,
                step=state.step + 1,
                q2_params=q2_params,
                q2_target_params=(
                    soft_update(q2_params, state.q2_target_params, self.tau)
                    if self.q2_network is not None else state.q2_target_params),
                q2_opt_state=q2_opt_state,
                log_alpha=log_alpha,
                alpha_opt_state=alpha_opt_state,
                value_params=value_params,
                value_target_params=value_target_params,
                value_opt_state=value_opt_state,
            )
            metrics = {
                "q1_loss": q1_loss,
                "q2_loss": q2_loss,
                "actor_loss": actor_loss,
                "alpha_loss": alpha_loss,
                "value_loss": value_loss,
                "entropy_temperature": alpha,
                "target_q_mean": torch.mean(target_q),
            }
        return new_state, metrics

    # ------------------------------------------------------------- inference

    def export_actor(self, state: SACTrainerState) -> nn.Module:
        """A copy of the actor holding the state's weights."""
        return functional.module_with(self.actor_network, state.actor_params)
