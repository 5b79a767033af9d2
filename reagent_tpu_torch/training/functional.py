"""A q-network as a pure function of a parameter dict.

The unfused trainers keep their parameters in the training state, as the JAX
trainers do (``{name: tensor}``, the module's ``named_parameters`` names),
and run the module on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

import copy
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


def apply(q_network: nn.Module, params: Params, obs: Tensor) -> Tensor:
    """The module's forward on ``params`` (differentiable through them)."""
    return torch.func.functional_call(q_network, params, (obs,))


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
