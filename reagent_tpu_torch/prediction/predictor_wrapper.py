"""Predictor wrapper: preprocessor + q-network in one exportable module.

Port of the discrete-DQN part of ``reagent_tpu/prediction/predictor_wrapper.py``
(``DiscreteDqnWithPreprocessor`` :57, ``DiscreteDqnPredictorWrapper`` :74).

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
            "normalization": {
                str(k): v for k, v in serialize(pre.normalization_parameters).items()
            },
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
