"""A network as a pure function of a parameter dict.

The unfused trainers keep their parameters in the training state, as the JAX
trainers do (``{name: tensor}``, the module's ``named_parameters`` names),
and run the module on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.models.actor import FullyConnectedActor, GaussianFullyConnectedActor
from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork
from reagent_tpu_torch.ops.fused_dqn import _ACT_CODES
from reagent_tpu_torch.ops.fused_mlp import fused_mlp_forward

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def params_of(q_network: nn.Module) -> Params:
    """Copies of the module's parameters, by name."""
    return {k: p.detach().clone() for k, p in q_network.named_parameters()}


def apply(module: nn.Module, params: Optional[Params], *inputs, **kwargs):
    """The module's forward on ``params`` (differentiable through them);
    ``params`` None runs the module's own."""
    if params is None:
        return module(*inputs, **kwargs)
    return torch.func.functional_call(module, params, inputs, kwargs)


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


def takes_k3(module: nn.Module) -> bool:
    """Whether ``score`` runs ``module``'s MLP as one K3 launch: a float32
    dense ``FullyConnectedDQN``, ``CategoricalDQN`` or
    ``FullyConnectedCritic``, a bare ``FullyConnectedNetwork``, or a module
    with a float32 dense overarch (``overarch_prefix``: a ``SparseDQN``, or a
    module holding one), each with K3's activations only."""
    prefix = getattr(module, "overarch_prefix", None)
    if prefix is not None:
        return _dense_f32(module.get_submodule(prefix))
    if isinstance(module, FullyConnectedNetwork):
        return _dense_f32(module)
    return (isinstance(module, (FullyConnectedDQN, CategoricalDQN, FullyConnectedCritic))
            and _dense_f32(module.net))


def k3_weights(params: Params, prefix: str, n_layers: int):
    """K3's ``[(W [in, out], b [out])]`` of the dense net at ``prefix`` in a
    parameter dict ("" for a bare net; transposed views: no copy)."""
    base = f"{prefix}.layers" if prefix else "layers"
    return [(params[f"{base}.{i}.weight"].T, params[f"{base}.{i}.bias"])
            for i in range(n_layers)]


def score(q_network: nn.Module, params: Params, *inputs: Tensor) -> Tensor:
    """The forward for acting and scoring, without a graph.  In float32 the
    MLP of these modules is one K3 launch on a CUDA tensor:

    - ``FullyConnectedDQN``: the Q-values;
    - ``CategoricalDQN``: the ``[B, A * N]`` logits, then the log-softmax
      over atoms and E[Z] in torch, as JAX computes them outside any kernel;
    - ``FullyConnectedCritic`` (state, action): the MLP on ``cat([state,
      action])``, the ``[B * A, S + A]`` tiled rows of a parametric scorer.

    - a module with an ``overarch_prefix`` (``SparseDQN``): its
      ``overarch_input`` (the embedding-bag concat) in torch, then the dense
      overarch at that prefix.

    - a bare ``FullyConnectedNetwork``: its output.

    Any other module, one with a reduced ``compute_dtype`` (K3 is float32),
    one whose network is not a dense chain (a batch or layer norm, a skip
    connection: ``FullyConnectedNetwork.is_dense``) and one with an
    activation K3 lacks (sigmoid, softplus) runs its own forward, as the JAX
    package computes it outside any kernel."""
    with torch.no_grad():
        if not takes_k3(q_network):
            return apply(q_network, params, *inputs)
        prefix = getattr(q_network, "overarch_prefix", None)
        if prefix is not None:
            x = apply_method(q_network, params, "overarch_input", *inputs)
            net = q_network.get_submodule(prefix)
            return fused_mlp_forward(x, k3_weights(params, prefix, len(net.layers)),
                                     net.activations)
        net = q_network if isinstance(q_network, FullyConnectedNetwork) else q_network.net
        weights = k3_weights(params, "" if net is q_network else "net", len(net.layers))
        x = inputs[0] if len(inputs) == 1 else torch.cat(inputs, dim=1)
        out = fused_mlp_forward(x, weights, net.activations)
        return q_network.q_of_logits(out) if isinstance(q_network, CategoricalDQN) else out


def _dense_f32(net: nn.Module) -> bool:
    return (net.compute_dtype == torch.float32 and net.is_dense
            and all(a in _ACT_CODES for a in net.activations))


def loc_and_scale_log(actor: GaussianFullyConnectedActor, params: Params,
                      obs: Tensor) -> Tuple[Tensor, Tensor]:
    """A gaussian actor's (loc, clipped log-scale) on ``params`` without a
    graph.  Its float32 dense trunk is one K3 launch on a CUDA tensor; the
    split, the layer norms and the clip follow in torch, as the module
    computes them.  A trunk with a norm or a skip runs the module's own."""
    with torch.no_grad():
        if not _dense_f32(actor.net):
            return apply_method(actor, params, "_loc_and_scale_log", obs)
        out = fused_mlp_forward(obs, k3_weights(params, "net", len(actor.net.layers)),
                                actor.net.activations)
        return apply_method(actor, {k: v for k, v in params.items() if not k.startswith("net.")},
                            "loc_and_scale_log_of", out)


def actor_act(actor: nn.Module, params: Params, obs: Tensor,
              noise: Optional[Tensor] = None) -> rlt.ActorOutput:
    """A continuous actor's output on ``params`` without a graph (the act
    step): the gaussian actor's (loc, log-scale) as ``loc_and_scale_log``,
    then its squashed draw; the deterministic actor's dense float32 net one
    K3 launch, then its exploration noise.  Any other actor runs its own
    forward."""
    with torch.no_grad():
        if isinstance(actor, GaussianFullyConnectedActor):
            return actor.output_of(*loc_and_scale_log(actor, params, obs), noise)
        if isinstance(actor, FullyConnectedActor) and _dense_f32(actor.net):
            out = fused_mlp_forward(obs, k3_weights(params, "net", len(actor.net.layers)),
                                    actor.net.activations)
            return actor.output_of(out, noise)
        return apply(actor, params, obs, noise)


def module_with(q_network: nn.Module, params: Params) -> nn.Module:
    """A copy of the module holding ``params`` (for serving and export)."""
    net = copy.deepcopy(q_network)
    net.load_state_dict({k: v.detach() for k, v in params.items()})
    return net
