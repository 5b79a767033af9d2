"""Actor networks.

Port of ``reagent_tpu/models/actor.py`` (reference: reagent/models/actor.py):
``FullyConnectedActor`` (:28, a deterministic tanh actor with optional
gaussian exploration), ``GaussianFullyConnectedActor`` (:71, tanh-squashed
gaussian with the exact log-prob and ``get_log_prob``) and
``DirichletFullyConnectedActor`` (:155, actions on the simplex) with
``dirichlet_log_prob`` (:189).

Where the JAX modules take a key and draw inside, the gaussian actors take
the standard-normal draw itself (``noise``, shaped like the action), so a
caller can feed JAX's draw and compare; ``noise=None`` is the JAX module
called without a key (no exploration, the mean action).  The Dirichlet
actor samples with ``torch._sample_dirichlet`` from a ``generator``, a
stream that cannot match ``jax.random.dirichlet``.  The deterministic
actor takes the network's batch norm; the gaussian actor's layer norm
(``loc_ln``, ``scale_ln``) runs after its trunk on the location and the
log-scale, as JAX's (:89-100): on ``action_dim = 1`` it returns its bias.
``training`` is flax's flag, passed to the trunk.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from reagent_tpu_torch.core.types import ActorOutput
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork, LayerNorm

Tensor = torch.Tensor
LOG_PROB_MIN = -2.0
LOG_PROB_MAX = 2.0
_EPS = 1e-6


class FullyConnectedActor(nn.Module):
    """Deterministic actor with optional gaussian exploration noise."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        use_batch_norm: bool = False,
        action_activation: str = "tanh",
        exploration_variance: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.sizes, self.activations = list(sizes), list(activations)
        self.action_activation = action_activation
        self.exploration_variance = exploration_variance
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, action_dim], [*activations, action_activation],
            use_batch_norm=use_batch_norm, generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: Tensor, noise: Optional[Tensor] = None,
                training: bool = False) -> ActorOutput:
        """``noise`` [B, action_dim] standard normal: exploration of scale
        ``exploration_variance`` (ignored without one)."""
        return self.output_of(self.net(state, training=training), noise)

    def output_of(self, action: Tensor, noise: Optional[Tensor] = None) -> ActorOutput:
        """The actor's output from its net's ``[B, action_dim]`` action."""
        B = action.shape[0]
        if self.exploration_variance is None or noise is None:
            return ActorOutput(action=action, log_prob=torch.zeros(
                (B, 1), dtype=action.dtype, device=action.device))
        # a fill on the device, not a copy from the host (which would wait for
        # the queue at every act step)
        scale = torch.full((), self.exploration_variance, dtype=action.dtype,
                           device=action.device)
        noise = noise * scale
        log_prob = torch.clamp(
            torch.sum(
                -(noise / scale) ** 2 / 2 - torch.log(scale) - 0.5 * math.log(2 * math.pi),
                dim=1, keepdim=True,
            ),
            LOG_PROB_MIN, LOG_PROB_MAX,
        )
        return ActorOutput(action=torch.clamp(action + noise, -1.0, 1.0), log_prob=log_prob)


def _normal_log_prob(r: Tensor, scale_log: Tensor) -> Tensor:
    """log N(loc + r*scale; loc, scale) in terms of r (ref actor.py:167-182)."""
    return -(r**2) / 2 - scale_log - 0.5 * math.log(2 * math.pi)


def _squash_correction(squashed: Tensor) -> Tensor:
    """d tanh^-1 correction: log(1 - a^2) (ref actor.py:184-189)."""
    return torch.log(1 - squashed**2 + _EPS)


def _squash(raw: Tensor) -> Tensor:
    return torch.clamp(torch.tanh(raw), -1.0 + _EPS, 1.0 - _EPS)


class GaussianFullyConnectedActor(nn.Module):
    """Tanh-squashed gaussian policy (SAC-style) with exact log-prob: one MLP
    emits the location and the log-scale (clipped to [-2, 2]) of each
    action dimension."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        use_layer_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.sizes, self.activations = list(sizes), list(activations)
        self.use_layer_norm = bool(use_layer_norm)
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, action_dim * 2], [*activations, "linear"], generator=generator)
        if self.use_layer_norm:
            self.loc_ln = LayerNorm(action_dim)
            self.scale_ln = LayerNorm(action_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)
        if self.use_layer_norm:
            self.loc_ln.reset_parameters()
            self.scale_ln.reset_parameters()

    def loc_and_scale_log_of(self, out: Tensor):
        """The trunk's ``[B, 2 * action_dim]`` output -> (loc, clipped
        log-scale), each through its layer norm where the actor has one."""
        loc = out[:, : self.action_dim]
        scale_log = out[:, self.action_dim:]
        if self.use_layer_norm:
            loc, scale_log = self.loc_ln(loc), self.scale_ln(scale_log)
        return loc, torch.clamp(scale_log, LOG_PROB_MIN, LOG_PROB_MAX)

    def _loc_and_scale_log(self, state: Tensor, training: bool = False):
        return self.loc_and_scale_log_of(self.net(state, training=training))

    def forward(self, state: Tensor, noise: Optional[Tensor] = None,
                training: bool = False) -> ActorOutput:
        """``noise`` [B, action_dim] standard normal, the reparameterized
        draw; None gives the squashed mean."""
        return self.output_of(*self._loc_and_scale_log(state, training), noise)

    def output_of(self, loc: Tensor, scale_log: Tensor,
                  noise: Optional[Tensor] = None) -> ActorOutput:
        """The squashed draw and its log-prob from (loc, log-scale)."""
        r = torch.zeros_like(scale_log) if noise is None else noise
        squashed = _squash(loc + r * torch.exp(scale_log))
        log_prob = torch.sum(
            _normal_log_prob(r, scale_log) - _squash_correction(squashed), dim=1, keepdim=True)
        return ActorOutput(action=squashed, log_prob=log_prob, squashed_mean=_squash(loc))

    def get_log_prob(self, state: Tensor, squashed_action: Tensor,
                     training: bool = False) -> Tensor:
        """Log-prob [B, 1] of an externally supplied (tanh-squashed) action."""
        loc, scale_log = self._loc_and_scale_log(state, training)
        raw = torch.atanh(torch.clamp(squashed_action, -1.0 + _EPS, 1.0 - _EPS))
        r = (raw - loc) / torch.exp(scale_log)
        return torch.sum(
            _normal_log_prob(r, scale_log) - _squash_correction(_squash(raw)),
            dim=1, keepdim=True)


class DirichletFullyConnectedActor(nn.Module):
    """Actions on the simplex via a Dirichlet policy (ref actor.py:264)."""

    def __init__(
        self,
        state_dim: int,
        action_dim: int,
        sizes: Sequence[int],
        activations: Sequence[str],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.sizes, self.activations = list(sizes), list(activations)
        self.net = FullyConnectedNetwork(
            [state_dim, *sizes, action_dim], [*activations, "linear"], generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, state: Tensor, generator: Optional[torch.Generator] = None,
                training: bool = False) -> ActorOutput:
        """A sample drawn from ``generator`` (on the state's device), or the
        mean without one."""
        out = self.net(state, training=training)
        # softplus + 1 keeps the concentration above 1 so the log-prob is
        # bounded (reference actor.py:289-296); softplus as flax's logaddexp
        concentration = torch.logaddexp(out, torch.zeros_like(out)) + 1.0
        if generator is None:
            action = concentration / torch.sum(concentration, dim=1, keepdim=True)
        else:
            action = torch._sample_dirichlet(concentration, generator=generator)
        log_prob = dirichlet_log_prob(concentration, action)
        return ActorOutput(action=action, log_prob=log_prob[:, None])


def dirichlet_log_prob(conc: Tensor, x: Tensor) -> Tensor:
    """log Dir(x; conc) [B] of rows ``x`` on the simplex, clipped to eps."""
    x = torch.clamp(x, _EPS, 1.0)
    log_norm = torch.sum(torch.lgamma(conc), dim=1) - torch.lgamma(torch.sum(conc, dim=1))
    return torch.sum((conc - 1.0) * torch.log(x), dim=1) - log_norm
