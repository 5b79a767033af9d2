"""A network as a pure function of a parameter dict.

The unfused trainers keep their parameters in the training state, as the JAX
trainers do (``{name: tensor}``, the module's ``named_parameters`` names),
and run the module on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import torch
from torch import nn

from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def params_of(q_network: nn.Module) -> Params:
    """Copies of the module's parameters, by name."""
    return {k: p.detach().clone() for k, p in q_network.named_parameters()}


def apply(module: nn.Module, params: Params, *inputs):
    """The module's forward on ``params`` (differentiable through them)."""
    return torch.func.functional_call(module, params, inputs)


class _Method(nn.Module):
    """Calls one named method of ``module`` as its forward."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *inputs):
        return getattr(self.module, self.method)(*inputs)


def apply_method(module: nn.Module, params: Params, method: str, *inputs):
    """``module.<method>(*inputs)`` on ``params`` (flax's ``apply(...,
    method=...)``), differentiable through them."""
    return torch.func.functional_call(
        _Method(module, method), {f"module.{k}": v for k, v in params.items()}, inputs)


def value_and_grad(loss_fn, params: Params, has_aux: bool = False):
    """``(loss, gradients by name, aux)`` of ``loss_fn(params)`` (which
    returns ``(loss, aux)`` where ``has_aux``), as ``jax.value_and_grad``;
    ``loss`` comes back detached from the graph."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = loss_fn(leaves)
    loss, aux = out if has_aux else (out, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.detach(), grads, aux


def select(flag: Tensor, new, old):
    """``new`` where the device bool ``flag`` holds, else ``old``, leaf by
    leaf (tensors, dicts of them, an ``OptState``), as ``jnp.where`` over a
    tree: a delayed update takes no branch on the host."""
    if old is None:
        return None
    if isinstance(old, Tensor):
        return torch.where(flag, new, old)
    if isinstance(old, dict):
        return {k: select(flag, new[k], v) for k, v in old.items()}
    return dataclasses.replace(old, **{
        f.name: select(flag, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def score(q_network: nn.Module, params: Params, obs: Tensor) -> Tensor:
    """The forward for acting and scoring, without a graph.  A dense MLP
    (``FullyConnectedDQN``) in float32 goes through K3, one launch on a CUDA
    tensor; any other module, and one with a reduced ``compute_dtype`` (K3 is
    float32), runs its own forward, as the JAX package computes it outside
    any kernel."""
    with torch.no_grad():
        if (isinstance(q_network, FullyConnectedDQN)
                and q_network.compute_dtype == torch.float32):
            n = len(q_network.net.layers)
            weights = [(params[f"net.layers.{i}.weight"].T, params[f"net.layers.{i}.bias"])
                       for i in range(n)]
            return fused_mlp_forward(obs, weights, q_network.activations)
        return apply(q_network, params, obs)


def module_with(q_network: nn.Module, params: Params) -> nn.Module:
    """A copy of the module holding ``params`` (for serving and export)."""
    net = copy.deepcopy(q_network)
    net.load_state_dict({k: v.detach() for k, v in params.items()})
    return net
