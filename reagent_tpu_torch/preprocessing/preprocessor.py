"""The dense-feature Preprocessor as an ``nn.Module``.

Port of ``reagent_tpu/preprocessing/preprocessor.py`` (``Preprocessor`` :46,
``make_preprocessor`` :239, ``presence_from_missing`` :248).  The normalization
spec is compiled at construction into per-type float32 parameter tables
(registered buffers, so ``.to(device)`` moves them) and static column
ranges; ``forward(values, presence)`` applies one vectorized transform per
feature type and concatenates the blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from reagent_tpu_torch.core.parameters import NormalizationParameters
from reagent_tpu_torch.preprocessing.identify_types import (
    BOXCOX,
    CONTINUOUS,
    CONTINUOUS_ACTION,
    DO_NOT_PREPROCESS,
    ENUM,
    FEATURE_TYPES,
    QUANTILE,
)
from reagent_tpu_torch.preprocessing.normalization import (
    EPS,
    MAX_FEATURE_VALUE,
    MIN_FEATURE_VALUE,
    MISSING_VALUE,
    sort_features_by_normalization,
)


class Preprocessor(nn.Module):
    """``values`` [B, F] raw features in sorted-by-(type, id) column order and
    ``presence`` [B, F] (bool/0-1) -> [B, D] normalized features, where ENUM
    features expand into one-hot blocks."""

    def __init__(
        self,
        normalization_parameters: Dict[int, NormalizationParameters],
        clamp: bool = True,
        device="cpu",
    ):
        super().__init__()
        self.normalization_parameters = normalization_parameters
        self.sorted_features, _ = sort_features_by_normalization(normalization_parameters)
        self.clamp = clamp

        self._type_ranges: List[Tuple[str, int, int]] = []
        start = 0
        for ftype in FEATURE_TYPES:
            n = sum(
                1 for f in self.sorted_features
                if normalization_parameters[f].feature_type == ftype
            )
            if n:
                self._type_ranges.append((ftype, start, start + n))
                start += n
        self.num_input_features = start

        def p_of(ftype):
            return [
                normalization_parameters[f]
                for f in self.sorted_features
                if normalization_parameters[f].feature_type == ftype
            ]

        def table(name, values):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(values), dtype=torch.float32)
            )

        cont = p_of(CONTINUOUS)
        if cont:
            table("cont_mean", [p.mean for p in cont])
            table("cont_stddev", [p.stddev for p in cont])
        bc = p_of(BOXCOX)
        if bc:
            for p in bc:
                if p.boxcox_lambda is None or abs(p.boxcox_lambda) <= 1e-6:
                    raise ValueError(f"invalid boxcox lambda: {p.boxcox_lambda}")
            table("bc_shift", [p.boxcox_shift for p in bc])
            table("bc_lmbda", [p.boxcox_lambda for p in bc])
            table("bc_mean", [p.mean for p in bc])
            table("bc_stddev", [p.stddev for p in bc])
        ca = p_of(CONTINUOUS_ACTION)
        if ca:
            mins = np.array([p.min_value for p in ca])
            maxs = np.array([p.max_value for p in ca])
            table("ca_min_serving", mins)
            # train range is (-1+eps, 1-eps) (reference preprocessor.py:248-273)
            table("ca_min_training", np.full((len(ca),), -1.0 + EPS))
            table("ca_scale", (1.0 - EPS) * 2.0 / (maxs - mins))
        qt = p_of(QUANTILE)
        if qt:
            width = max(len(p.quantiles) for p in qt)
            bounds = np.zeros((len(qt), width))
            for i, p in enumerate(qt):
                q = np.asarray(p.quantiles, dtype=np.float64)
                bounds[i, :] = q[-1]
                bounds[i, : len(q)] = q
            table("q_bounds", bounds)  # [F, width]
            table("q_num_quantiles", [len(p.quantiles) - 1 for p in qt])
            table("q_min", [min(p.quantiles) for p in qt])
            table("q_max", [max(p.quantiles) for p in qt])
        en = p_of(ENUM)
        if en:
            width = max(len(p.possible_values) for p in en)
            enum_vals = np.full((len(en), width), np.nan)
            keep_cols = []  # flat indices of the valid one-hot slots
            for i, p in enumerate(en):
                pv = np.asarray(p.possible_values, dtype=np.float64)
                enum_vals[i, : len(pv)] = pv
                keep_cols.extend(i * width + j for j in range(len(pv)))
            table("enum_values", enum_vals)  # [F, width], NaN-padded
            self.register_buffer(
                "enum_keep_cols", torch.as_tensor(keep_cols, dtype=torch.long)
            )

        self.num_output_features = sum(
            len(p.possible_values) if p.feature_type == ENUM else 1
            for p in normalization_parameters.values()
        )
        self.to(device)

    # -- per-type transforms (each: [B, f] -> [B, out]) ---------------------

    def _t_DO_NOT_PREPROCESS(self, x):
        return x

    def _t_BINARY(self, x):
        return (x != 0).to(x.dtype)

    def _t_CLIP_LOG(self, x):
        return torch.log(torch.clamp(x, min=EPS))

    def _t_PROBABILITY(self, x):
        c = torch.clamp(x, 1e-5, 1 - 1e-5)
        return -torch.log(1.0 / c - 1.0)

    def _t_CONTINUOUS(self, x):
        return (x - self.cont_mean) / self.cont_stddev

    def _t_BOXCOX(self, x):
        bx = (
            torch.pow(torch.clamp(x + self.bc_shift, min=1e-6), self.bc_lmbda) - 1.0
        ) / self.bc_lmbda
        return (bx - self.bc_mean) / self.bc_stddev

    def _t_CONTINUOUS_ACTION(self, x):
        out = (x - self.ca_min_serving) * self.ca_scale + self.ca_min_training
        return torch.clamp(out, -1 + EPS, 1 - EPS)

    def _t_DISCRETE_ACTION(self, x):
        return x

    def _t_QUANTILE(self, x):
        """Percentile with linear interpolation between quantile boundaries
        (reference preprocessor.py:434-505), over a NaN-free padded [F, W]
        boundary matrix."""
        bounds = self.q_bounds
        xe = x[:, :, None]
        ge = (xe >= bounds).to(x.dtype)
        lt = (xe < bounds).to(x.dtype)
        set_to_max = (x >= self.q_max).to(x.dtype)
        set_to_min = (x <= self.q_min).to(x.dtype)
        interpolate = ((set_to_min + set_to_max) < 0.01).to(x.dtype)
        big = torch.tensor(1e20, dtype=x.dtype, device=x.device)
        left = torch.amax(ge * bounds + lt * (-big), dim=2)
        right = torch.amin(lt * bounds + ge * big, dim=2)
        left_start = torch.sum(ge, dim=2) - 1.0
        interpolated = (
            left_start + (x - left) / ((right + 1e-6) - left)
        ) / self.q_num_quantiles
        return set_to_max + interpolate * interpolated

    def _t_ENUM(self, x, presence):
        onehot = (x[:, :, None] == self.enum_values).to(x.dtype)  # [B, F, W]
        onehot = onehot * presence[:, :, None]
        return onehot.reshape(x.shape[0], -1)[:, self.enum_keep_cols]

    # -- forward ------------------------------------------------------------

    def forward(self, values: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        if values.shape != presence.shape:
            raise ValueError(f"{tuple(values.shape)} != {tuple(presence.shape)}")
        values = values.to(torch.float32)
        presence = presence.to(torch.float32)
        outputs = []
        for ftype, s, e in self._type_ranges:
            x = values[:, s:e]
            pres = presence[:, s:e]
            if ftype == ENUM:
                out = self._t_ENUM(x, pres)  # presence baked in
            else:
                out = getattr(self, "_t_" + ftype)(x) * pres
                if self.clamp and ftype != DO_NOT_PREPROCESS:
                    out = torch.clamp(out, MIN_FEATURE_VALUE, MAX_FEATURE_VALUE)
            outputs.append(out)
        return torch.cat(outputs, dim=1)


def make_preprocessor(
    normalization_parameters: Dict[int, NormalizationParameters],
    clamp: bool = True,
    device="cpu",
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], torch.Tensor], Preprocessor]:
    """``(fn, preprocessor)``: ``fn(values, presence) -> normalized`` is the
    module's forward without a graph (JAX's returns a jitted function)."""
    p = Preprocessor(normalization_parameters, clamp=clamp, device=device)

    def fn(values: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return p(values, presence)

    return fn, p


def presence_from_missing(values: torch.Tensor) -> torch.Tensor:
    """Float32 presence from the ``MISSING_VALUE`` sentinel convention."""
    return (values != MISSING_VALUE).to(torch.float32)
