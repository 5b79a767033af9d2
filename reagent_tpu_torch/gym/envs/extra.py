"""More benchmark environments as tensor step functions.

Port of ``reagent_tpu/gym/envs/extra.py`` (``LinDyna`` :28, ``OpenGridworld``
:61, ``StringGame`` :103, ``StringGameV1`` :131, ``ChangingArms`` :170,
``RecSimState`` and ``RecSimSlate`` :228-311):

  * LinDyna        - reagent/gym/envs/dynamics/linear_dynamics.py (LQR system)
  * OpenGridworld  - MiniGrid-Empty-5x5's playable 3x3 (gym/tests/configs/
                     open_gridworld/)
  * StringGame     - reagent/gym/envs/pomdp/string_game.py ("ABB" +5, "BBB" -5)
  * StringGameV1   - pomdp/string_game_v1.py (state-dependent survival)
  * ChangingArms   - reagent/gym/envs/changing_arms.py (sparse-feature bandit)
  * RecSimSlate    - a small interest-evolution slate env (its own state and
                     slate API, not a ``FunctionalEnv``)

The JAX envs draw inside ``reset``/``step`` from a key.  Here every draw is
explicit: an env's ``noise`` holds the values of the JAX env's random calls,
in its order (each env's ``reset_noise``/``step_noise`` says which), and a
call without ``noise`` draws the same distributions from ``generator``.  So
the same numbers give the same episode on both packages.  The functional
envs here take a leading batch dimension, as CartPole does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.gym.envs.functional import FunctionalEnv, FunctionalEnvState
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _shape(batch_size: Optional[int]) -> Tuple[int, ...]:
    return () if batch_size is None else (batch_size,)


def _zeros_t(shape, device) -> Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _uniform(shape, generator, device, low=0.0, high=1.0) -> Tensor:
    """``jax.random.uniform(key, shape, minval=low, maxval=high)``'s
    distribution: ``max(low, u * (high - low) + low)``."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u * (high - low) + low, min=low)


def _one_hot(idx: Tensor, n: int) -> Tensor:
    return F.one_hot(idx.to(torch.int64), n).to(torch.float32)


class LinDyna(FunctionalEnv):
    """x' = Ax + Bu; reward = -(x'Qx + u'Ru); 4-step episodes (ref
    linear_dynamics.py).  ``reset_noise``: x0 in {-1, 0, 1}^3 (JAX's
    ``randint(rng, (3,), -1, 2)``)."""

    observation_dim = 3
    action_dim = 2
    discrete = False
    max_steps = 4

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

        def mat(rows):
            return 0.2 * torch.tensor(rows, dtype=torch.float32, device=self.device)

        self.A = mat([[-1.0, -1.0, 1.0], [2.0, 0.0, 2.0], [0.0, -1.0, 2.0]])
        self.B = mat([[2.0, 2.0], [2.0, 2.0], [0.0, 1.0]])
        self.Q = mat([[1.0, 0.0, 0.0], [0.0, 2.0, 0.5], [0.0, 0.5, 1.0]])
        self.R = mat([[1.0, -1.0], [-1.0, 2.0]])

    def reset_noise(self, generator, batch_size=None):
        return torch.randint(-1, 2, _shape(batch_size) + (3,), generator=generator,
                             device=self.device)

    def reset(self, generator=None, batch_size=None, noise=None):
        x = (self.reset_noise(generator, batch_size) if noise is None else noise)
        x = x.to(device=self.device, dtype=torch.float32)
        return FunctionalEnvState(physics=x, t=_zeros_t(x.shape[:-1], self.device)), x

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None):
        x = state.physics
        u = torch.clamp(action.reshape(x.shape[:-1] + (2,)).to(torch.float32), -3.0, 3.0)
        # cost is positive-definite quadratic; reward is its negation
        cost = ((x @ self.Q) * x).sum(-1) + ((u @ self.R) * u).sum(-1)
        nx = x @ self.A.T + u @ self.B.T
        t = state.t + 1
        return FunctionalEnvState(physics=nx, t=t), nx, -cost, t >= self.max_steps


class OpenGridworld(FunctionalEnv):
    """Empty gridworld: actions {left, right, up, down}; reach the goal.

    MiniGrid-Empty-5x5 semantics: the playable area is ``size`` x ``size``
    (3), max_steps = 4*5*5 = 100, success reward 1 - 0.9 * t / max_steps.
    Observation: one-hot of (x, y).  Deterministic."""

    discrete = True

    def __init__(self, size: int = 3, max_steps: int = 100, device="cuda"):
        self.size = size
        self.max_steps = max_steps
        self.observation_dim = 2 * size
        self.action_dim = 4
        self.device = resolve_device(device)

    def _obs(self, physics: Tensor) -> Tensor:
        return torch.cat([_one_hot(physics[..., 0], self.size),
                          _one_hot(physics[..., 1], self.size)], dim=-1)

    def reset(self, generator=None, batch_size=None, noise=None):
        shape = _shape(batch_size)
        physics = torch.zeros(shape + (2,), dtype=torch.float32, device=self.device)
        return (FunctionalEnvState(physics=physics, t=_zeros_t(shape, self.device)),
                self._obs(physics))

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None):
        a = action.to(torch.int32)
        dx = torch.where(a == 0, -1, torch.where(a == 1, 1, 0))
        dy = torch.where(a == 2, -1, torch.where(a == 3, 1, 0))
        x = torch.clamp(state.physics[..., 0] + dx, 0, self.size - 1)
        y = torch.clamp(state.physics[..., 1] + dy, 0, self.size - 1)
        physics = torch.stack([x, y], dim=-1).to(torch.float32)
        t = state.t + 1
        at_goal = (x == self.size - 1) & (y == self.size - 1)
        reward = torch.where(at_goal, 1.0 - 0.9 * t.to(torch.float32) / self.max_steps, 0.0)
        done = at_goal | (t >= self.max_steps)
        return FunctionalEnvState(physics=physics, t=t), self._obs(physics), reward, done


class StringGame(FunctionalEnv):
    """POMDP string game (ref pomdp/string_game.py): 2 actions (A=0, B=1);
    reward +5 for the trailing window 'ABB', -5 for 'BBB'; 6-step episodes.
    Observation: one-hot of the last action.  Deterministic; the physics is
    [a_{t-2}, a_{t-1}, a_t], -1 for none."""

    observation_dim = 2
    action_dim = 2
    discrete = True
    max_steps = 6

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._abb = torch.tensor([0.0, 1.0, 1.0], device=self.device)

    def reset(self, generator=None, batch_size=None, noise=None):
        shape = _shape(batch_size)
        physics = torch.full(shape + (3,), -1.0, device=self.device)
        return (FunctionalEnvState(physics=physics, t=_zeros_t(shape, self.device)),
                torch.zeros(shape + (2,), device=self.device))

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None):
        a = action.to(torch.float32)
        physics = torch.stack([state.physics[..., 1], state.physics[..., 2], a], dim=-1)
        is_abb = (physics == self._abb).all(-1)
        is_bbb = (physics == 1.0).all(-1)
        reward = torch.where(is_abb, 5.0, torch.where(is_bbb, -5.0, 0.0))
        t = state.t + 1
        return (FunctionalEnvState(physics=physics, t=t), _one_hot(a, 2), reward,
                t >= self.max_steps)


class StringGameV1(FunctionalEnv):
    """Stochastic-length string game (ref pomdp/string_game_v1.py:46): at
    most 3 steps; after A the episode goes on with p=0.5, after B with 0.9;
    terminal reward +5 for 'AAA', +4 for 'BA', else 0.  ``step_noise``: one
    uniform (JAX's ``uniform(rng)``); the episode survives where it is below
    the action's p."""

    observation_dim = 2
    action_dim = 2
    discrete = True
    max_steps = 3

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._ba = torch.tensor([1.0, 0.0], device=self.device)

    def reset(self, generator=None, batch_size=None, noise=None):
        shape = _shape(batch_size)
        physics = torch.full(shape + (3,), -1.0, device=self.device)  # action history
        return (FunctionalEnvState(physics=physics, t=_zeros_t(shape, self.device)),
                torch.zeros(shape + (2,), device=self.device))

    def step_noise(self, generator, batch_shape=()):
        return torch.rand(tuple(batch_shape), generator=generator, device=self.device)

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None, noise=None):
        a = action.to(torch.float32)
        u = self.step_noise(generator, a.shape) if noise is None else noise
        t = state.t
        slot = torch.arange(3, device=a.device) == t[..., None]
        physics = torch.where(slot, a[..., None], state.physics)
        t1 = t + 1
        p_continue = torch.where(a == 0.0, 0.5, 0.9)
        survived = u < p_continue
        done = (t1 >= self.max_steps) | ~survived
        is_aaa = (t1 == 3) & (physics == 0.0).all(-1)
        is_ba = (t1 == 2) & (physics[..., :2] == self._ba).all(-1)
        reward = torch.where(done, torch.where(is_aaa, 5.0, torch.where(is_ba, 4.0, 0.0)), 0.0)
        return FunctionalEnvState(physics=physics, t=t1), _one_hot(a, 2), reward, done


class ChangingArms(FunctionalEnv):
    """Sparse-feature bandit (ref changing_arms.py): each arm's mean drifts;
    obs stacks [mu, legal mask, mu changes]; an illegal arm ends the episode
    with 0; action ``num_arms`` is a no-op "pass".

    ``reset_noise``: (mu draws in [-1, 1) [K], legality uniforms [K]);
    ``step_noise``: (changes, standard normal [K]; legality uniforms [K])."""

    discrete = True

    def __init__(self, num_arms: int = 5, max_steps: int = 200, device="cuda"):
        self.num_arms = num_arms
        self.max_steps = max_steps
        self.observation_dim = 3 * num_arms
        self.action_dim = num_arms + 1
        self.device = resolve_device(device)

    def reset_noise(self, generator, batch_size=None):
        shape = _shape(batch_size) + (self.num_arms,)
        return (_uniform(shape, generator, self.device, -1.0, 1.0),
                torch.rand(shape, generator=generator, device=self.device))

    def reset(self, generator=None, batch_size=None, noise=None):
        u_mu, u_legal = self.reset_noise(generator, batch_size) if noise is None else noise
        mus = u_mu * 5
        legal = (u_legal > 0.5).to(torch.float32)
        changes = torch.zeros_like(mus)
        physics = torch.cat([mus, legal, changes, torch.zeros_like(mus[..., :1])], dim=-1)
        return (FunctionalEnvState(physics=physics, t=_zeros_t(mus.shape[:-1], self.device)),
                torch.cat([mus, legal, changes], dim=-1))

    def step_noise(self, generator, batch_shape=()):
        shape = tuple(batch_shape) + (self.num_arms,)
        return (torch.randn(shape, generator=generator, device=self.device),
                torch.rand(shape, generator=generator, device=self.device))

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None, noise=None):
        K = self.num_arms
        mus = state.physics[..., :K]
        legal = state.physics[..., K:2 * K]
        a = action.to(torch.int64)
        changes, u_legal = self.step_noise(generator, a.shape) if noise is None else noise
        is_pass = a >= K
        arm = torch.clamp(a, max=K - 1)[..., None]
        chosen_legal = torch.where(is_pass, 1.0, legal.gather(-1, arm)[..., 0])
        reward = torch.where(is_pass, 0.0,
                             torch.where(chosen_legal > 0, mus.gather(-1, arm)[..., 0], 0.0))
        new_mus = torch.clamp(mus + changes, -10.0, 10.0)
        new_legal = (u_legal > 0.5).to(torch.float32)
        t = state.t + 1
        done = (t >= self.max_steps) | (~is_pass & (chosen_legal == 0))
        physics = torch.cat([new_mus, new_legal, changes, torch.zeros_like(mus[..., :1])], dim=-1)
        return (FunctionalEnvState(physics=physics, t=t),
                torch.cat([new_mus, new_legal, changes], dim=-1), reward, done)


@dataclasses.dataclass
class RecSimState:
    user_interest: Tensor  # [num_topics]
    docs: Tensor  # [num_candidates, num_topics]
    doc_quality: Tensor  # [num_candidates]
    t: Tensor
    budget: Tensor
    last_clicked: Tensor = None  # slate position clicked last step, -1 = no click


class RecSimSlate:
    """A small interest-evolution slate env (SlateQ benchmark): a softmax
    choice over the slate and a skip option; a click drifts the user's
    interest toward the doc, consumes budget and pays watch time.  One env,
    its own state and slate API (``step(state, slate [S])``).

    ``reset_noise``: (interest in [-1, 1) [T], docs [C, T] Dirichlet(1),
    quality in [0.5, 1.5) [C]); ``step_noise``: standard gumbels [S + 1]
    (JAX's ``categorical`` is the argmax of logits plus gumbels)."""

    discrete = False

    def __init__(
        self,
        num_candidates: int = 10,
        slate_size: int = 3,
        num_topics: int = 5,
        max_steps: int = 40,
        device="cuda",
    ):
        self.num_candidates = num_candidates
        self.slate_size = slate_size
        self.num_topics = num_topics
        self.max_steps = max_steps
        self.observation_dim = num_topics
        self.device = resolve_device(device)

    def reset_noise(self, generator):
        C, T = self.num_candidates, self.num_topics
        # Dirichlet(1, ..., 1): exponentials normalized
        e = -torch.log1p(-torch.rand((C, T), generator=generator, device=self.device))
        return (_uniform((T,), generator, self.device, -1.0, 1.0),
                e / e.sum(-1, keepdim=True),
                _uniform((C,), generator, self.device, 0.5, 1.5))

    def reset(self, generator=None, noise=None):
        interest, docs, quality = self.reset_noise(generator) if noise is None else noise
        state = RecSimState(
            user_interest=interest,
            docs=docs,
            doc_quality=quality,
            t=torch.zeros((), dtype=torch.int32, device=self.device),
            budget=torch.full((), float(self.max_steps), device=self.device),
            last_clicked=torch.full((), -1, dtype=torch.int32, device=self.device),
        )
        return state, self._obs(state)

    def _obs(self, state: RecSimState):
        return {"user": state.user_interest, "doc_features": state.docs,
                "doc_quality": state.doc_quality}

    def step_noise(self, generator):
        from reagent_tpu_torch.gym.policies.samplers import gumbel

        return gumbel((self.slate_size + 1,), generator, self.device)

    def step(self, state: RecSimState, slate: Tensor, generator=None, noise=None):
        """slate: [slate_size] candidate indices."""
        g = self.step_noise(generator) if noise is None else noise
        slate = slate.to(torch.int64)
        slate_docs = state.docs[slate]  # [S, T]
        scores = 3.0 * (slate_docs @ state.user_interest)  # [S] sharpened choice
        # the no-click option has score 0
        logits = torch.cat([scores, torch.zeros(1, device=scores.device)])
        choice = torch.argmax(logits + g)
        clicked = choice < self.slate_size
        doc_idx = torch.where(clicked, slate[torch.clamp(choice, max=self.slate_size - 1)], 0)
        # watch time scales with both quality and interest alignment
        alignment = torch.sigmoid(2.0 * state.docs[doc_idx] @ state.user_interest)
        watch_time = torch.where(clicked, state.doc_quality[doc_idx] * (0.5 + alignment), 0.0)
        # interest drift toward the clicked doc
        drift = torch.where(clicked, 0.1, 0.0)
        new_interest = state.user_interest + drift * (state.docs[doc_idx] - state.user_interest)
        budget = state.budget - torch.where(clicked, watch_time * 0.5, 1.0)
        t = state.t + 1
        done = (budget <= 0) | (t >= self.max_steps)
        new_state = dataclasses.replace(
            state, user_interest=new_interest, t=t, budget=budget,
            last_clicked=torch.where(clicked, choice, -1).to(torch.int32))
        return new_state, self._obs(new_state), watch_time, done
