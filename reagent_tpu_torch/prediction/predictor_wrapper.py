"""Predictor wrapper: preprocessor + q-network in one exportable module.

Port of the discrete-DQN part of ``reagent_tpu/prediction/predictor_wrapper.py``
(``DiscreteDqnWithPreprocessor`` :57, ``DiscreteDqnPredictorWrapper`` :74),
of its distributional wrapper (``CategoricalDqnPredictorWrapper`` :323,
``make_quantile_dqn_predictor_wrapper`` :401), described at that class, of
the actor's (``ActorWithPreprocessor`` :185, ``ActorPredictorWrapper`` :209),
described at that class, the parametric DQN's in-process scorer
(``ParametricDqnWithPreprocessor`` :155, ``ParametricDqnPredictorWrapper``
:177; no artifact, as in JAX), and ``load_predictor`` (:273), which loads a
discrete-DQN or an actor artifact by its manifest's ``model_type``.

Export format (framework-free, loaded unchanged by the C++ scorer in
``serving/``, and the same files the JAX package writes):
  <dir>/manifest.json   — model_type, action_names, normalization spec,
                          sorted_features, layer shapes + activations
  <dir>/weights.bin     — float32 little-endian [W1 | b1 | W2 | b2 | ...]
                          (row-major W: [in, out])
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from reagent_tpu_torch.ops.fused_dqn import extract_mlp_layout
from reagent_tpu_torch.preprocessing.normalization import deserialize, serialize
from reagent_tpu_torch.preprocessing.postprocessor import Postprocessor
from reagent_tpu_torch.preprocessing.preprocessor import Preprocessor


class DiscreteDqnWithPreprocessor(nn.Module):
    """raw (values, presence) -> q-values (reference :94-116)."""

    def __init__(self, q_network: nn.Module, state_preprocessor: Preprocessor):
        super().__init__()
        self.q_network = q_network
        self.preprocessor = state_preprocessor

    @torch.no_grad()
    def forward(self, values: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        return self.q_network(self.preprocessor(values, presence))


class DiscreteDqnPredictorWrapper:
    """Named-action scoring + export (reference :117-150).

    ``activations`` is written to the manifest; the model manager passes the
    q-network's true per-layer list.
    """

    def __init__(
        self,
        dqn_with_preprocessor: DiscreteDqnWithPreprocessor,
        action_names: Sequence[str],
        activations: Optional[Sequence[str]] = None,
    ):
        self.model = dqn_with_preprocessor
        self.action_names = list(action_names)
        self.activations = list(activations) if activations else None

    def __call__(self, values, presence) -> Tuple[List[str], torch.Tensor]:
        return self.action_names, self.model(values, presence)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        linears, _ = extract_mlp_layout(self.model.q_network)
        layers = [
            (l.weight.detach().cpu().numpy().T, l.bias.detach().cpu().numpy())
            for l in linears
        ]
        pre = self.model.preprocessor
        manifest: Dict[str, Any] = {
            "model_type": "discrete_dqn",
            "action_names": self.action_names,
            "normalization": _normalization_json(pre.normalization_parameters),
            "sorted_features": pre.sorted_features,
            "layers": [
                {"in": int(k.shape[0]), "out": int(k.shape[1])} for k, _ in layers
            ],
            "activations": self.activations
            or (["relu"] * (len(layers) - 1) + ["linear"]),
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        blob = b"".join(
            np.ascontiguousarray(a, np.float32).astype("<f4").tobytes()
            for k, b in layers
            for a in (k, b)
        )
        with open(os.path.join(path, "weights.bin"), "wb") as f:
            f.write(blob)

    @staticmethod
    def load(path: str):
        """Rebuild a numpy forward fn (CPU preprocessing) from an artifact."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        raw = np.fromfile(os.path.join(path, "weights.bin"), "<f4")
        layers = []
        off = 0
        for spec in manifest["layers"]:
            n = spec["in"] * spec["out"]
            k = raw[off: off + n].reshape(spec["in"], spec["out"])
            off += n
            b = raw[off: off + spec["out"]]
            off += spec["out"]
            layers.append((k, b))
        if off != raw.size:
            raise ValueError(
                f"weights.bin holds {raw.size} floats, the manifest's layers {off}")

        pre = Preprocessor(deserialize(manifest["normalization"]))
        acts = manifest["activations"]

        def forward(values, presence):
            with torch.no_grad():
                x = pre(
                    torch.as_tensor(np.asarray(values, np.float32)),
                    torch.as_tensor(np.asarray(presence, np.float32)),
                ).numpy()
            for (k, b), act in zip(layers, acts):
                x = x @ k + b
                if act == "relu":
                    x = np.maximum(x, 0)
                elif act == "leaky_relu":
                    x = np.where(x > 0, x, 0.01 * x)
                elif act == "tanh":
                    x = np.tanh(x)
            return manifest["action_names"], x

        return forward


class ParametricDqnWithPreprocessor(nn.Module):
    """raw state and action (values, presence) -> Q(s, a) [B, 1] (reference
    :214-250)."""

    def __init__(self, q_network: nn.Module, state_preprocessor: Preprocessor,
                 action_preprocessor: Preprocessor):
        super().__init__()
        self.q_network = q_network
        self.state_preprocessor = state_preprocessor
        self.action_preprocessor = action_preprocessor

    @torch.no_grad()
    def forward(self, sv: torch.Tensor, sp: torch.Tensor, av: torch.Tensor,
                ap: torch.Tensor) -> torch.Tensor:
        return self.q_network(self.state_preprocessor(sv, sp), self.action_preprocessor(av, ap))


class ParametricDqnPredictorWrapper:
    """In-process scoring of (state, action) rows.  It has no ``save``, as
    JAX's has none: the workflow writes no artifact for a parametric DQN and
    reports ``default_model`` as ``""``."""

    def __init__(self, dqn_with_preprocessor: ParametricDqnWithPreprocessor):
        self.model = dqn_with_preprocessor

    def __call__(self, sv, sp, av, ap) -> Tuple[List[str], torch.Tensor]:
        return ["Q"], self.model(sv, sp, av, ap)


class _QuantileMeanHead(nn.Module):
    """[B, A * N] or [B, A, N] quantile outputs -> mean over atoms [B, A]."""

    def __init__(self, module: nn.Module, num_actions: int, num_atoms: int):
        super().__init__()
        self.module = module
        self.num_actions = num_actions
        self.num_atoms = num_atoms

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        out = self.module(obs)
        return out.reshape(obs.shape[0], self.num_actions, self.num_atoms).mean(dim=2)


# module classes an artifact may name; load() builds nothing else
def _artifact_modules() -> Dict[str, type]:
    from reagent_tpu_torch.models.actor import (
        DirichletFullyConnectedActor,
        FullyConnectedActor,
        GaussianFullyConnectedActor,
    )
    from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.models.dueling_q_network import DuelingQNetwork

    return {"FullyConnectedDQN": FullyConnectedDQN, "DuelingQNetwork": DuelingQNetwork,
            "CategoricalDQN": CategoricalDQN,
            "GaussianFullyConnectedActor": GaussianFullyConnectedActor,
            "FullyConnectedActor": FullyConnectedActor,
            "DirichletFullyConnectedActor": DirichletFullyConnectedActor}


# an actor's constructor arguments, kept on the module as attributes
_ACTOR_KWARGS = ("state_dim", "action_dim", "sizes", "activations")


def _module_spec(module: nn.Module) -> Dict[str, Any]:
    """The constructor arguments that rebuild ``module`` (one of
    ``_artifact_modules``), as JSON values."""
    name = type(module).__name__
    if name not in _artifact_modules():
        raise ValueError(f"cannot export a {name}; known: {sorted(_artifact_modules())}")
    if name == "FullyConnectedDQN":
        linears = list(module.net.layers)
        kwargs = {
            "state_dim": module.state_dim, "action_dim": module.action_dim,
            "sizes": [l.out_features for l in linears[:-1]],
            "activations": list(module.activations[:-1]),
        }
    elif name == "DuelingQNetwork":
        kwargs = {
            "state_dim": module.state_dim, "action_dim": module.action_dim,
            "layers": [l.out_features for l in module.shared.layers],
            "activations": list(module.shared.activations),
            "num_atoms": module.num_atoms,
        }
    elif name == "CategoricalDQN":
        kwargs = {
            "state_dim": module.state_dim, "action_dim": module.action_dim,
            "num_atoms": module.num_atoms, "qmin": module.qmin, "qmax": module.qmax,
            "sizes": module.sizes, "activations": list(module.activations[:-1]),
        }
    else:
        extra = (("action_activation", "exploration_variance")
                 if name == "FullyConnectedActor" else ())
        kwargs = {k: getattr(module, k) for k in _ACTOR_KWARGS + extra}
    return {"class": name, "kwargs": kwargs}


def _normalization_json(normalization_parameters) -> Dict[str, str]:
    return {str(k): v for k, v in serialize(normalization_parameters).items()}


class CategoricalDqnPredictorWrapper:
    """Serving for distributional heads whose module emits expected Q
    ``[B, A]`` (reference: ``reagent_tpu/prediction/predictor_wrapper.py``
    :323-385).  The head is no flat MLP, so the artifact is
    ``manifest.json`` (the JAX artifact's keys: ``model_type``,
    ``action_names``) plus ``model.pt``: the normalization spec, the
    module's class name and constructor arguments, and its ``state_dict`` —
    tensors and JSON values only, read back with ``weights_only=True``.  The
    JAX artifact pickles a flax module; the two payloads are not
    interchangeable.
    """

    def __init__(self, q_network: nn.Module, state_preprocessor: Preprocessor,
                 action_names: Sequence[str]):
        self.q_network = q_network
        self.preprocessor = state_preprocessor
        self.action_names = list(action_names)

    @torch.no_grad()
    def _forward(self, values: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        return self.q_network(self.preprocessor(values, presence))  # expected Q [B, A]

    def __call__(self, values, presence) -> Tuple[List[str], torch.Tensor]:
        return self.action_names, self._forward(values, presence)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(
                {"model_type": "categorical_dqn", "action_names": self.action_names},
                f, indent=2,
            )
        head = self.q_network
        payload: Dict[str, Any] = {
            "normalization": _normalization_json(self.preprocessor.normalization_parameters),
            "action_names": self.action_names,
        }
        if isinstance(head, _QuantileMeanHead):
            payload["quantile_head"] = {
                "num_actions": head.num_actions, "num_atoms": head.num_atoms}
            head = head.module
        payload["module"] = _module_spec(head)
        payload["state_dict"] = {k: v.detach().cpu() for k, v in head.state_dict().items()}
        torch.save(payload, os.path.join(path, "model.pt"))

    @staticmethod
    def load(path: str):
        """``forward(values, presence) -> (action_names, q [B, A] numpy)``
        from an artifact, on the CPU."""
        payload = torch.load(
            os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
        spec = payload["module"]
        module = _artifact_modules()[spec["class"]](**spec["kwargs"])
        module.load_state_dict(payload["state_dict"])
        if "quantile_head" in payload:
            module = _QuantileMeanHead(module, **payload["quantile_head"])
        pre = Preprocessor(deserialize(payload["normalization"]))

        def forward(values, presence):
            with torch.no_grad():
                q = module(pre(
                    torch.as_tensor(np.asarray(values, np.float32)),
                    torch.as_tensor(np.asarray(presence, np.float32)),
                ))
            return payload["action_names"], q.numpy()

        return forward


def make_quantile_dqn_predictor_wrapper(
    q_network: nn.Module, state_preprocessor: Preprocessor, action_names: Sequence[str],
    num_atoms: int,
) -> CategoricalDqnPredictorWrapper:
    """QR-DQN serving: Q(s, a) = mean of the quantile atoms (reference
    :401-408).  ``q_network`` holds the weights to serve."""
    head = _QuantileMeanHead(q_network, len(action_names), num_atoms)
    return CategoricalDqnPredictorWrapper(head, state_preprocessor, action_names)


class ActorWithPreprocessor(nn.Module):
    """raw (values, presence) -> the actor's action in serving units
    (reference :260-300): the state preprocessor, the actor without noise
    (the squashed mean of a gaussian actor), the action postprocessor."""

    def __init__(self, actor_network: nn.Module, state_preprocessor: Preprocessor,
                 action_postprocessor: Optional[Postprocessor] = None):
        super().__init__()
        self.actor_network = actor_network
        self.preprocessor = state_preprocessor
        self.action_postprocessor = action_postprocessor

    @torch.no_grad()
    def forward(self, values: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        action = self.actor_network(self.preprocessor(values, presence)).action
        if self.action_postprocessor is not None:
            action = self.action_postprocessor(action)
        return action


class ActorPredictorWrapper:
    """Serving for actors (reference :209-271).  The artifact is
    ``manifest.json`` (``{"model_type": "actor"}``, as JAX writes it) plus
    ``actor.pt``: the state normalization spec, the actor's class name and
    constructor arguments, its ``state_dict`` and, where there is one, the
    action normalization spec — tensors and JSON values only, read back with
    ``weights_only=True``.  The JAX artifact pickles a flax module
    (``actor.pkl``); the two payloads are not interchangeable."""

    def __init__(self, actor_with_preprocessor: ActorWithPreprocessor):
        self.model = actor_with_preprocessor

    def __call__(self, values, presence) -> torch.Tensor:
        return self.model(values, presence)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"model_type": "actor"}, f, indent=2)
        actor = self.model.actor_network
        payload: Dict[str, Any] = {
            "normalization": _normalization_json(self.model.preprocessor.normalization_parameters),
            "module": _module_spec(actor),
            "state_dict": {k: v.detach().cpu() for k, v in actor.state_dict().items()},
        }
        post = self.model.action_postprocessor
        if post is not None:
            payload["action_normalization"] = _normalization_json(post.normalization_parameters)
        torch.save(payload, os.path.join(path, "actor.pt"))

    @staticmethod
    def load(path: str):
        """``(forward(values, presence) -> action [B, action_dim] numpy,
        sorted state features)`` from an artifact, on the CPU."""
        payload = torch.load(
            os.path.join(path, "actor.pt"), map_location="cpu", weights_only=True)
        spec = payload["module"]
        actor = _artifact_modules()[spec["class"]](**spec["kwargs"])
        actor.load_state_dict(payload["state_dict"])
        pre = Preprocessor(deserialize(payload["normalization"]))
        post = None
        if "action_normalization" in payload:
            post = Postprocessor(deserialize(payload["action_normalization"]))
        model = ActorWithPreprocessor(actor, pre, post)

        def forward(values, presence):
            return model(
                torch.as_tensor(np.asarray(values, np.float32)),
                torch.as_tensor(np.asarray(presence, np.float32)),
            ).numpy()

        return forward, pre.sorted_features


class Predictor:
    """A loaded artifact: ``predict(features)`` scores one row given as a
    sparse feature dict ``{fid: value}`` and returns ``(action_names, q
    [1, A])``, or for an actor the action ``[1, action_dim]`` in serving
    units."""

    def __init__(self, forward, sorted_features: Sequence[int], model_type: str):
        self._forward = forward
        self.sorted_features = list(sorted_features)
        self.model_type = model_type

    def predict(self, features: Dict[int, float]):
        values = np.array([[features.get(f, 0.0) for f in self.sorted_features]], np.float32)
        presence = np.array([[f in features for f in self.sorted_features]], np.bool_)
        return self._forward(values, presence)


def load_predictor(path: str) -> Predictor:
    """Load an exported artifact by its manifest's ``model_type`` (reference
    :273-320): ``discrete_dqn`` through ``DiscreteDqnPredictorWrapper.load``
    (a numpy forward on the host, as the C++ scorer's), ``actor`` through
    ``ActorPredictorWrapper.load`` (the actor on the host's CPU)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    model_type = manifest.get("model_type", "discrete_dqn")
    if model_type == "actor":
        return Predictor(*ActorPredictorWrapper.load(path), model_type)
    if model_type != "discrete_dqn":
        raise ValueError(f"{path}: load_predictor reads discrete_dqn and actor artifacts, "
                         f"not {model_type!r}")
    return Predictor(DiscreteDqnPredictorWrapper.load(path), manifest["sorted_features"],
                     model_type)
