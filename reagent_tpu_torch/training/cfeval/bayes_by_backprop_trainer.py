"""Bayes-by-backprop reward-uncertainty trainer.

Port of ``reagent_tpu/training/cfeval/bayes_by_backprop_trainer.py``
(``BayesianMLP`` :25-57, the trainer :60-121; reference
reagent/training/cfeval/bayes_by_backprop_trainer.py:15): a mean-field
gaussian MLP on logged bandit rewards, trained on the ELBO, the sampled NLL
plus the KL to the prior (Blundell et al. 2015).

JAX folds a key per layer (and per sample in ``predict_with_uncertainty``)
to draw each layer's weight noise.  Here the noise is a value: each train
step takes ``eps`` (one ``[din, dout]`` standard normal a layer) and
``predict_with_uncertainty`` takes ``eps`` (one ``[S, din, dout]`` a layer),
or draws them from the trainer's ``torch.Generator`` on its device.  Each
sample of ``predict_with_uncertainty`` is one K3 launch on a CUDA tensor:
the sampled weights ``mu + sigma * eps`` of both layers, relu then linear.
The predictive std is the population std (``jnp.std``), not Bessel's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.mdn_rnn import _lecun_normal_fill
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward
from reagent_tpu_torch.optim import OptState, make_optimizer
from reagent_tpu_torch.training import functional
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
ACTIVATIONS = ("relu", "linear")
RHO_INIT = -5.0  # flax's constant(-5.0) for every w{i}_rho


class BayesianMLP(nn.Module):
    """Mean-field gaussian weights ``w{i}_mu``, ``w{i}_rho`` ``[din, dout]``
    (flax's layout) and biases ``b{i}``: ``in_dim -> hidden`` (relu) ``->
    out_dim``.  ``forward(x, eps)`` samples ``w = mu + softplus(rho) * eps``
    and returns (prediction, KL to ``N(0, prior_sigma^2)``)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, prior_sigma: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.hidden, self.out_dim = in_dim, hidden, out_dim
        self.prior_sigma = prior_sigma
        for li, (din, dout) in enumerate(self.dims):
            self.register_parameter(f"w{li}_mu", nn.Parameter(torch.empty(din, dout)))
            self.register_parameter(f"w{li}_rho", nn.Parameter(torch.empty(din, dout)))
            self.register_parameter(f"b{li}", nn.Parameter(torch.empty(dout)))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @property
    def dims(self) -> List[Tuple[int, int]]:
        return [(self.in_dim, self.hidden), (self.hidden, self.out_dim)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal means, rho -5, zero biases."""
        with torch.no_grad():
            for li in range(len(self.dims)):
                _lecun_normal_fill(getattr(self, f"w{li}_mu"), generator)
                getattr(self, f"w{li}_rho").fill_(RHO_INIT)
                getattr(self, f"b{li}").zero_()

    def draw_noise(self, generator: torch.Generator, samples: Optional[int] = None
                   ) -> List[Tensor]:
        """Standard normals for each layer's weights, ``[din, dout]`` (or
        ``[samples, din, dout]``), on the generator's device."""
        lead = () if samples is None else (samples,)
        return [torch.randn((*lead, din, dout), generator=generator, device=generator.device)
                for din, dout in self.dims]

    def forward(self, x: Tensor, eps: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
        kl = 0.0
        h = x
        for li in range(len(self.dims)):
            mu, rho = getattr(self, f"w{li}_mu"), getattr(self, f"w{li}_rho")
            sigma = F.softplus(rho)
            h = h @ (mu + sigma * eps[li]) + getattr(self, f"b{li}")
            if li == 0:
                h = torch.relu(h)
            # KL(q || N(0, prior_sigma^2)) per weight, summed
            kl = kl + torch.sum(torch.log(self.prior_sigma / sigma)
                                + (sigma ** 2 + mu ** 2) / (2 * self.prior_sigma ** 2) - 0.5)
        return h, kl


@dataclasses.dataclass
class BayesByBackpropTrainerState(rlt._TensorDataClass):
    params: Dict[str, Tensor]
    opt_state: OptState
    step: Tensor  # int32 scalar


class BayesByBackpropTrainer:
    def __init__(self, net: BayesianMLP, optimizer: Any = None, kl_weight: float = 1e-3,
                 device="cuda"):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.optimizer = make_optimizer(optimizer)
        self.kl_weight = kl_weight
        self.generator = torch.Generator(device=self.device)

    def init(self, generator: torch.Generator) -> BayesByBackpropTrainerState:
        """Fresh weights from ``generator`` (on the CPU); the trainer's noise
        stream is seeded from it."""
        self.net.reset_parameters(generator)
        self.generator.manual_seed(int(torch.randint(2**62, (), generator=generator)))
        return self.state_from_network()

    def state_from_network(self) -> BayesByBackpropTrainerState:
        params = functional.params_of(self.net)
        return BayesByBackpropTrainerState(
            params=params, opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def train_step(self, state: BayesByBackpropTrainerState, batch: rlt.BanditRewardModelInput,
                   eps: Optional[Sequence[Tensor]] = None
                   ) -> Tuple[BayesByBackpropTrainerState, Dict[str, Tensor]]:
        """One ELBO step on ``cat([state, action])``; ``eps`` the weight noise
        (``BayesianMLP.draw_noise``), else drawn from the trainer's generator."""
        if eps is None:
            eps = self.net.draw_noise(self.generator)
        x = torch.cat([batch.state.float_features, batch.action], dim=1)
        y = batch.reward.reshape(-1, 1)

        def loss_fn(params):
            pred, kl = functional.apply(self.net, params, x, list(eps))
            nll = torch.mean((pred - y) ** 2)
            return nll + self.kl_weight * kl / x.shape[0], (nll, kl)

        loss, grads, (nll, kl) = functional.value_and_grad(loss_fn, state.params, has_aux=True)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return (state.replace(params=params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss, "nll": nll.detach(), "kl": kl.detach()})

    def sampled_weights(self, params: Dict[str, Tensor], eps: Sequence[Tensor], s: int
                        ) -> List[Tuple[Tensor, Tensor]]:
        """K3's ``[(W [din, dout], b)]`` of sample ``s``: ``mu + sigma * eps[s]``."""
        return [(params[f"w{li}_mu"] + F.softplus(params[f"w{li}_rho"]) * e[s],
                 params[f"b{li}"]) for li, e in enumerate(eps)]

    def predict_with_uncertainty(self, state: BayesByBackpropTrainerState, x: Tensor,
                                 num_samples: int = 32,
                                 eps: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, Tensor]:
        """Monte-Carlo mean and population std of the predictive distribution
        over ``num_samples`` weight draws (``eps``: one ``[S, din, dout]`` a
        layer, else drawn from the trainer's generator); each sample's
        forward is one K3 launch on a CUDA tensor."""
        if eps is None:
            eps = self.net.draw_noise(self.generator, num_samples)
        with torch.no_grad():
            x = x.to(torch.float32).contiguous()
            preds = torch.stack([
                fused_mlp_forward(x, self.sampled_weights(state.params, eps, s), ACTIVATIONS)
                for s in range(num_samples)])
            return torch.mean(preds, dim=0), torch.std(preds, dim=0, correction=0)
