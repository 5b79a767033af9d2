"""Probabilistic (Bayes-by-backprop) fully connected network.

Port of ``reagent_tpu/models/probabilistic_fully_connected_network.py``
(``LinearBBB`` :31, ``FullyConnectedProbabilisticNetwork`` :55,
``sample_elbo`` :85; reference reagent/models/
probabilistic_fully_connected_network.py:26, :110): mean-field gaussian
weights, one posterior draw a forward.  The standard normal draws are
explicit (``noise``: per layer the weight's [in, out] and the bias's [out]
draws) or come from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from reagent_tpu_torch.models.mdn_rnn import _lecun_normal_fill

Tensor = torch.Tensor
Noise = Tuple[Tensor, Tensor]  # (weight draw [in, out], bias draw [out])


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _gaussian_kl(mu: Tensor, sigma: Tensor, prior_sigma: float) -> Tensor:
    """KL(N(mu, sigma) || N(0, prior_sigma)), summed over the elements."""
    return torch.sum(torch.log(prior_sigma / sigma)
                     + (sigma ** 2 + mu ** 2) / (2 * prior_sigma ** 2) - 0.5)


class LinearBBB(nn.Module):
    """A variational linear layer (reference :26-108): ``w_mu`` and
    ``w_rho`` [in, out], ``b_mu`` and ``b_rho`` [out]."""

    def __init__(self, in_dim: int, out_dim: int, prior_sigma: float = 1.0):
        super().__init__()
        self.prior_sigma = prior_sigma
        self.w_mu = nn.Parameter(torch.zeros((in_dim, out_dim)))
        self.w_rho = nn.Parameter(torch.full((in_dim, out_dim), -3.0))
        self.b_mu = nn.Parameter(torch.zeros((out_dim,)))
        self.b_rho = nn.Parameter(torch.full((out_dim,), -3.0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_fill(self.w_mu, generator)
        with torch.no_grad():
            self.w_rho.fill_(-3.0)
            self.b_mu.zero_()
            self.b_rho.fill_(-3.0)

    def draw(self, generator: Optional[torch.Generator]) -> Noise:
        dev = self.w_mu.device
        return (torch.randn(self.w_mu.shape, generator=generator, device=dev),
                torch.randn(self.b_mu.shape, generator=generator, device=dev))

    def forward(self, x: Tensor, noise: Optional[Noise] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        eps_w, eps_b = self.draw(generator) if noise is None else noise
        w_sigma, b_sigma = _softplus(self.w_rho), _softplus(self.b_rho)
        w = self.w_mu + w_sigma * eps_w
        b = self.b_mu + b_sigma * eps_b
        kl = (_gaussian_kl(self.w_mu, w_sigma, self.prior_sigma)
              + _gaussian_kl(self.b_mu, b_sigma, self.prior_sigma))
        return x @ w + b, kl


class FullyConnectedProbabilisticNetwork(nn.Module):
    """A stack of ``LinearBBB`` layers (reference :110-214): ``forward``
    returns one posterior draw's prediction and the total KL;
    ``sample_elbo`` is the Bayes-by-backprop training loss."""

    def __init__(self, sizes: Sequence[int], activations: Sequence[str],
                 prior_sigma: float = 1.0, noise_tol: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sizes, self.activations = list(sizes), list(activations)
        self.noise_tol = noise_tol
        self.layers = nn.ModuleList(LinearBBB(sizes[i], sizes[i + 1], prior_sigma)
                                    for i in range(len(sizes) - 1))
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x: Tensor, noise: Optional[List[Noise]] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        total_kl = 0.0
        h = x
        for i, layer in enumerate(self.layers):
            h, kl = layer(h, None if noise is None else noise[i], generator)
            total_kl = total_kl + kl
            act = self.activations[i] if i < len(self.activations) else "linear"
            if act == "relu":
                h = torch.relu(h)
            elif act == "tanh":
                h = torch.tanh(h)
            elif act == "sigmoid":
                h = torch.sigmoid(h)
        return h, total_kl

    def sample_elbo(self, params, x: Tensor, target: Tensor, num_samples: int,
                    noises: Optional[List[List[Noise]]] = None,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        """The Monte-Carlo ELBO loss over ``num_samples`` posterior draws
        (reference :190-214), on the parameter dict ``params`` (the module's
        own where None); ``noises[s]`` is draw s's per-layer noise."""
        from reagent_tpu_torch.training import functional

        nlls, kls = [], []
        for s in range(num_samples):
            noise = None if noises is None else noises[s]
            pred, kl = functional.apply(self, params, x, noise, generator)
            nlls.append(0.5 * torch.sum((pred.reshape(target.shape) - target) ** 2)
                        / self.noise_tol ** 2)
            kls.append(kl)
        return torch.stack(nlls).mean() + torch.stack(kls).mean()
