"""Functional environments: classic-control dynamics as tensor step functions.

Port of ``reagent_tpu/gym/envs/functional.py`` (``FunctionalEnv``,
``FunctionalEnvState``, ``CartPole`` and ``Pendulum``, :22-171).  The physics
is a float32 tensor on the env's device, so the online loops step the env,
insert into replay and train without the host reading a value.  ``reset``,
``reset_from_uniform`` and ``step`` also take a leading batch dimension
(physics ``[E, 4]`` for CartPole, ``[E, 2]`` for Pendulum), which stands in
for the JAX package's ``vmap`` (``evaluate_policy`` steps all its episodes
as one batch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class FunctionalEnvState:
    physics: Tensor  # [..., physics_dim] float32
    t: Tensor  # [...] int32 step counter


def where_state(cond: Tensor, a, b):
    """``a`` where ``cond`` [...] holds, else ``b`` (the auto-reset select),
    field by field over any env state dataclass (nested ones included), each
    tensor's trailing dims broadcast against ``cond``; a field that is not a
    tensor is static and comes from ``a``."""
    if isinstance(a, Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: where_state(cond, getattr(a, f.name), getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    return a


class FunctionalEnv:
    """Protocol: static config + reset/step on device tensors."""

    observation_dim: int
    action_dim: int  # num discrete actions, or continuous action dim
    discrete: bool
    max_steps: int
    device: torch.device

    #: uniforms consumed by ``reset_from_uniform`` (noise-tape fast path)
    reset_noise_dim: int = 0

    def reset(
        self, generator: torch.Generator, batch_size: Optional[int] = None
    ) -> Tuple[FunctionalEnvState, Tensor]:
        """Reset from ``reset_noise_dim`` uniforms drawn from ``generator``
        (one env, or ``batch_size`` of them)."""
        shape = (self.reset_noise_dim,) if batch_size is None else (batch_size, self.reset_noise_dim)
        u = torch.rand(shape, generator=generator, device=self.device)
        return self.reset_from_uniform(u)

    def reset_from_uniform(self, u: Tensor) -> Tuple[FunctionalEnvState, Tensor]:
        """Reset from pre-drawn U[0,1) values ``u`` [..., reset_noise_dim]."""
        raise NotImplementedError

    def step(
        self, state: FunctionalEnvState, action: Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[FunctionalEnvState, Tensor, Tensor, Tensor]:
        """-> (new_state, obs, reward, done)."""
        raise NotImplementedError


class CartPole(FunctionalEnv):
    """CartPole with the classic dynamics (euler integration).

    Matches gymnasium CartPole-v1 semantics: reward 1 per step, termination at
    |x| > 2.4 or |theta| > 12 deg, truncation at ``max_steps``.  The float32
    operations are those of the JAX env, in its order.
    """

    observation_dim = 4
    action_dim = 2
    discrete = True

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * math.pi / 360
    X_THRESHOLD = 2.4

    reset_noise_dim = 4

    def __init__(self, max_steps: int = 500, device="cuda"):
        self.max_steps = max_steps
        self.device = resolve_device(device)

    def reset_from_uniform(self, u: Tensor):
        physics = -0.05 + 0.1 * u
        t = torch.zeros(u.shape[:-1], dtype=torch.int32, device=u.device)
        return FunctionalEnvState(physics=physics, t=t), physics

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None):
        x, x_dot, theta, theta_dot = state.physics.unbind(-1)
        force = torch.where(action.to(torch.int32) == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state.t + 1
        terminated = (torch.abs(x) > self.X_THRESHOLD) | (torch.abs(theta) > self.THETA_THRESHOLD)
        done = terminated | (t >= self.max_steps)
        reward = torch.ones(t.shape, dtype=torch.float32, device=t.device)
        return FunctionalEnvState(physics=physics, t=t), physics, reward, done


class Pendulum(FunctionalEnv):
    """Pendulum-v1 swing-up: obs [cos th, sin th, thdot], torque in [-2, 2],
    reward minus the cost, truncation at ``max_steps``.  The physics is
    [th, thdot]; the float32 operations are those of the JAX env, in its
    order."""

    observation_dim = 3
    action_dim = 1
    discrete = False

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    reset_noise_dim = 2

    def __init__(self, max_steps: int = 200, device="cuda"):
        self.max_steps = max_steps
        self.device = resolve_device(device)

    @staticmethod
    def _obs(physics: Tensor) -> Tensor:
        th, thdot = physics.unbind(-1)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def reset_from_uniform(self, u: Tensor):
        th = -math.pi + 2.0 * math.pi * u[..., 0]
        thdot = -1.0 + 2.0 * u[..., 1]
        physics = torch.stack([th, thdot], dim=-1)
        t = torch.zeros(u.shape[:-1], dtype=torch.int32, device=u.device)
        return FunctionalEnvState(physics=physics, t=t), self._obs(physics)

    def step(self, state: FunctionalEnvState, action: Tensor, generator=None):
        """``action`` holds one torque per env (``[E]``, ``[E, 1]``, or one
        value for an unbatched env)."""
        th, thdot = state.physics.unbind(-1)
        u = torch.clamp(action.reshape(th.shape).to(th.dtype), -self.MAX_TORQUE, self.MAX_TORQUE)
        angle_norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = angle_norm**2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3.0 * self.G / (2.0 * self.L) * torch.sin(th)
            + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        physics = torch.stack([newth, newthdot], dim=-1)
        t = state.t + 1
        done = t >= self.max_steps
        return FunctionalEnvState(physics=physics, t=t), self._obs(physics), -cost, done
