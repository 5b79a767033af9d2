"""CEM planner over an ensemble of MDN-RNN world models.

Port of ``reagent_tpu/models/cem_planner.py`` (``CEMPlannerNetwork`` :30;
reference reagent/models/cem_planner.py:35-310).  JAX rolls every solution
out under ``vmap`` over the P solutions and ``scan`` over the horizon; here
each horizon step is one batched forward over all P rows.  Each step runs
the world model on a length-1 sequence from a fresh (zero) LSTM state, as
JAX's does: no LSTM state is carried across the horizon.  Each solution is
simulated by one ensemble member, drawn per solution; every member runs over
all rows and each row reads its own member's outputs, so the rollout needs no
host read and no shape that depends on the draws.

JAX draws inside the rollout from a key.  Here the draws are values
(``RolloutDraws``: the member of each solution, the gumbels that pick a
mixture component, the normals of the sampled next state, the uniforms of
the not-terminal bernoulli), or come from a ``torch.Generator`` in the same
distributions.  The planning loops take theirs the same way: the continuous
planner's truncated normals ``[iterations, P, H * A]`` and the discrete
planner's action sequences ``[P, H]``.

CEM's host arithmetic is JAX's: the mean, the variance and the solutions
are float64 numpy, cast to float32 only for the simulation, and the elites
come from ``np.argsort`` of the float32 returns.  The discrete planner
scores each first action by its mean return (``-inf`` where it was never
first) and takes the first maximum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import CONTINUOUS_TRAINING_ACTION_RANGE
from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.training.utils import rescale_actions
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class RolloutDraws:
    """The draws of one simulation of P solutions over H steps.  ``gumbel``
    [H, P, G] is read where next states are sampled, ``normal`` [H, P, S]
    likewise, ``uniform`` [H, P] where the not-terminal flag is sampled."""

    member: Tensor  # [P] int, each solution's ensemble member
    gumbel: Optional[Tensor] = None
    normal: Optional[Tensor] = None
    uniform: Optional[Tensor] = None


def truncated_normal(shape, generator: torch.Generator, device) -> Tensor:
    """Standard normals truncated to [-2, 2] (``jax.random.truncated_normal``'s
    distribution), by the inverse CDF of uniforms in [Phi(-2), Phi(2)]."""
    lo, hi = (float(torch.special.ndtr(torch.tensor(v))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo
    return torch.clamp(math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0), -2.0, 2.0)


class CEMPlannerNetwork:
    def __init__(
        self,
        mem_net: MemoryNetwork,
        mem_net_params_list: List[Any],
        cem_num_iterations: int,
        cem_population_size: int,
        ensemble_population_size: int,
        num_elites: int,
        plan_horizon_length: int,
        state_dim: int,
        action_dim: int,
        discrete_action: bool,
        terminal_effective: bool,
        gamma: float,
        alpha: float = 0.25,
        epsilon: float = 0.001,
        action_upper_bounds: Optional[np.ndarray] = None,
        action_lower_bounds: Optional[np.ndarray] = None,
        sample_next_state: bool = True,
        sample_not_terminal: bool = True,
        device="cuda",
    ):
        """``mem_net_params_list`` holds each member's parameters (by the
        module's names).  ``sample_next_state=False`` propagates the
        mixture's expected next state, ``sample_not_terminal=False`` weights
        each step by the expected survival probability, as in JAX."""
        self.device = resolve_device(device)
        self.mem_net = mem_net.to(self.device)
        self.ensemble_params = [
            None if p is None else {k: v.to(self.device) for k, v in p.items()}
            for p in mem_net_params_list]
        self.num_ensemble = len(mem_net_params_list)
        self.cem_num_iterations = cem_num_iterations
        self.cem_pop_size = cem_population_size
        self.ensemble_pop_size = ensemble_population_size
        self.num_elites = num_elites
        self.plan_horizon_length = plan_horizon_length
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.discrete_action = discrete_action
        self.sample_next_state = sample_next_state
        self.sample_not_terminal = sample_not_terminal
        self.terminal_effective = terminal_effective
        self.gamma = gamma
        self.alpha = alpha
        self.epsilon = epsilon
        if not discrete_action:
            if action_upper_bounds is None or action_lower_bounds is None:
                raise ValueError("continuous planning needs action_upper_bounds and "
                                 "action_lower_bounds")
            self.action_upper_bounds = np.tile(action_upper_bounds, plan_horizon_length)
            self.action_lower_bounds = np.tile(action_lower_bounds, plan_horizon_length)
            self.orig_action_upper = torch.tensor(np.asarray(action_upper_bounds, np.float32),
                                                  device=self.device)
            self.orig_action_lower = torch.tensor(np.asarray(action_lower_bounds, np.float32),
                                                  device=self.device)

    # ------------------------------------------------------- world-model sim

    def draw_rollout(self, P: int, generator: torch.Generator) -> RolloutDraws:
        """The draws one simulation of ``P`` solutions reads, from
        ``generator`` (on the planner's device)."""
        H, dev = self.plan_horizon_length, self.device
        draws = RolloutDraws(member=torch.randint(0, self.num_ensemble, (P,), generator=generator,
                                                  device=dev))
        if self.sample_next_state:
            u = torch.rand((H, P, self.mem_net.num_gaussians), generator=generator, device=dev)
            tiny = torch.finfo(torch.float32).tiny
            draws.gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
            draws.normal = torch.randn((H, P, self.state_dim), generator=generator, device=dev)
        if self.terminal_effective and self.sample_not_terminal:
            draws.uniform = torch.rand((H, P), generator=generator, device=dev)
        return draws

    def _members_step(self, state: Tensor, action: Tensor, member: Tensor):
        """Each row's member's (mus, sigmas, logpi, reward, not_terminal) of
        one world-model step from a fresh LSTM state: state [P, S], action
        [P, A]."""
        if any(p is None for p in self.ensemble_params):
            raise ValueError("the planner's world-model parameters are not set")
        inputs = (rlt.FeatureData(float_features=state[None]),
                  rlt.FeatureData(float_features=action[None]))
        outs = [functional.apply(self.mem_net, params, *inputs)
                for params in self.ensemble_params]
        fields = [(o.mus[0], o.sigmas[0], o.logpi[0], o.reward[0], o.not_terminal[0])
                  for o in outs]
        if len(fields) == 1:
            return fields[0]
        rows = torch.arange(state.shape[0], device=state.device)
        return tuple(torch.stack(f)[member, rows] for f in zip(*fields))

    def acc_rewards_of_all_solutions(
        self, init_state: Tensor, solutions: Tensor, draws: Optional[RolloutDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """The discounted return of each solution: ``init_state``
        [state_dim], ``solutions`` [P, H, action_dim] -> [P]; ``draws`` or
        else draws from ``generator``."""
        P, H = solutions.shape[0], solutions.shape[1]
        if draws is None:
            draws = self.draw_rollout(P, generator)
        with torch.no_grad():
            state = init_state.to(torch.float32).reshape(1, -1).expand(P, self.state_dim)
            alive = torch.ones((P,), dtype=torch.float32, device=solutions.device)
            rows = torch.arange(P, device=solutions.device)
            rewards = []
            for t in range(H):
                mus, sigmas, logpi, reward, not_terminal = self._members_step(
                    state, solutions[:, t], draws.member)
                if self.sample_next_state:
                    mix = torch.argmax(logpi + draws.gumbel[t], dim=-1)
                    next_state = mus[rows, mix] + sigmas[rows, mix] * draws.normal[t]
                else:
                    next_state = torch.sum(torch.exp(logpi)[..., None] * mus, dim=1)
                rewards.append(reward * alive)
                if not self.terminal_effective:
                    not_term = torch.ones_like(alive)
                elif self.sample_not_terminal:
                    not_term = (draws.uniform[t] < torch.sigmoid(not_terminal)).to(torch.float32)
                else:
                    not_term = torch.sigmoid(not_terminal)
                state, alive = next_state, alive * not_term
            gammas = torch.pow(torch.tensor(self.gamma, dtype=torch.float32, device=rows.device),
                               torch.arange(H, dtype=torch.float32, device=rows.device))
            return torch.sum(torch.stack(rewards, dim=1) * gammas, dim=1)

    # --------------------------------------------------------------- planning

    def continuous_planning(
        self, state: Tensor, generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[Tuple[Any, RolloutDraws]]] = None,
    ) -> Tensor:
        """CEM (reference :225-272): ``noise`` holds each iteration's
        (truncated normals in [-2, 2] [P, H * A], rollout draws); else they
        come from ``generator``."""
        P, D = self.cem_pop_size, self.action_upper_bounds.shape[0]
        if noise is None:
            trunc = truncated_normal((self.cem_num_iterations, P, D), generator,
                                     self.device).cpu().numpy()
            noise = [(trunc[i], self.draw_rollout(P, generator))
                     for i in range(self.cem_num_iterations)]
        mean = (self.action_upper_bounds + self.action_lower_bounds) / 2
        var = (self.action_upper_bounds - self.action_lower_bounds) ** 2 / 16
        for i in range(self.cem_num_iterations):
            trunc_i, draws = noise[i]
            lb_dist = mean - self.action_lower_bounds
            ub_dist = self.action_upper_bounds - mean
            const_var = np.minimum(np.minimum((lb_dist / 2) ** 2, (ub_dist / 2) ** 2), var)
            solutions = np.asarray(trunc_i, np.float32) * np.sqrt(const_var) + mean
            action_solutions = torch.tensor(
                solutions.reshape(P, self.plan_horizon_length, self.action_dim),
                dtype=torch.float32, device=self.device)
            acc = self.acc_rewards_of_all_solutions(state, action_solutions, draws).cpu().numpy()
            elites = solutions[np.argsort(acc)][-self.num_elites:]
            mean = self.alpha * mean + (1 - self.alpha) * elites.mean(axis=0)
            var = self.alpha * var + (1 - self.alpha) * elites.var(axis=0)
            if var.max() <= self.epsilon:
                break
        raw_action = torch.tensor(mean[: self.action_dim], dtype=torch.float32,
                                  device=self.device)
        lo, hi = CONTINUOUS_TRAINING_ACTION_RANGE
        return rescale_actions(
            raw_action,
            new_min=torch.tensor(lo, dtype=torch.float32, device=self.device),
            new_max=torch.tensor(hi, dtype=torch.float32, device=self.device),
            prev_min=self.orig_action_lower,
            prev_max=self.orig_action_upper,
        )

    def discrete_planning(
        self, state: Tensor, generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[Tensor, RolloutDraws]] = None,
    ) -> Tuple[int, Tensor]:
        """Random shooting with first-action tallies (reference :273-310):
        ``noise`` holds (the action sequences [P, H], the rollout draws);
        else they come from ``generator``."""
        P, H, A = self.cem_pop_size, self.plan_horizon_length, self.action_dim
        if noise is None:
            noise = (torch.randint(0, A, (P, H), generator=generator, device=self.device),
                     self.draw_rollout(P, generator))
        seqs, draws = noise
        seqs = seqs.to(self.device, torch.int64)
        action_solutions = F.one_hot(seqs, A).to(torch.float32)
        acc = self.acc_rewards_of_all_solutions(state, action_solutions, draws)
        onehot_first = F.one_hot(seqs[:, 0], A).to(torch.float32)
        tally = torch.sum(onehot_first, dim=0)
        reward_tally = torch.sum(onehot_first * acc[:, None], dim=0)
        avg = torch.where(tally > 0, reward_tally / torch.clamp(tally, min=1.0),
                          torch.tensor(-float("inf"), device=tally.device))
        best = int(torch.argmax(avg))
        return best, F.one_hot(torch.tensor(best, device=self.device), A).to(torch.float32)

    def __call__(self, state: rlt.FeatureData, generator: Optional[torch.Generator] = None,
                 noise=None):
        sf = state.float_features.reshape(-1).to(self.device)
        if self.discrete_action:
            return self.discrete_planning(sf, generator, noise)
        return self.continuous_planning(sf, generator, noise)
