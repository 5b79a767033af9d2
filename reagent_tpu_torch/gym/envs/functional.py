"""Functional environments: classic-control dynamics as tensor step functions.

Port of ``reagent_tpu/gym/envs/functional.py`` (``FunctionalEnv``,
``FunctionalEnvState`` and ``CartPole``, :22-114).  The physics is a float32
tensor on the env's device, so the online loops step the env, insert into
replay and train without the host reading a value.  ``reset``,
``reset_from_uniform`` and ``step`` also take a leading batch dimension
(physics ``[E, 4]``), which stands in for the JAX package's ``vmap``
(``evaluate_policy`` steps all its episodes as one batch).
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


def where_state(cond: Tensor, a: FunctionalEnvState, b: FunctionalEnvState) -> FunctionalEnvState:
    """``a`` where ``cond`` [...] holds, else ``b`` (the auto-reset select)."""
    return FunctionalEnvState(
        physics=torch.where(cond[..., None], a.physics, b.physics),
        t=torch.where(cond, a.t, b.t),
    )


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
