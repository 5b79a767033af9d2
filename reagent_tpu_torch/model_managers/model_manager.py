"""ModelManager base: ties net builder + trainer + data + reporter + export.

Port of ``reagent_tpu/model_managers/model_manager.py``, and the feature
identification the DQN and actor-critic managers share
(``reagent_tpu/model_managers/actor_critic.py:40``, the same fit inline in
``discrete_dqn.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import pandas as pd

from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationParameters
from reagent_tpu_torch.preprocessing.identify_types import DO_NOT_PREPROCESS
from reagent_tpu_torch.preprocessing.normalization import get_feature_norm_metadata


class ModelManager:
    def build_trainer(
        self,
        normalization_data_map: Dict[str, NormalizationData],
        use_gpu: bool = False,
        device="cuda",
    ):
        raise NotImplementedError

    def build_serving_module(
        self, trainer, trainer_state, normalization_data_map: Dict[str, NormalizationData]
    ):
        raise NotImplementedError

    def run_feature_identification(self, df) -> Dict[str, NormalizationData]:
        raise NotImplementedError

    def get_reporter(self):
        """Per-algorithm reporter for the training loop; None = no reporting."""
        return None


def identify_dense(column: pd.Series, skip_preprocess: bool = False
                   ) -> Dict[int, NormalizationParameters]:
    """Normalization of a map<fid, value> column, fitted on its values
    (reference identify_types_flow.py:24); ``skip_preprocess`` marks every
    feature ``DO_NOT_PREPROCESS``."""
    by_feature: Dict[int, List[float]] = {}
    for d in column:
        if not d:
            continue
        for fid, v in d.items():
            by_feature.setdefault(int(fid), []).append(float(v))
    out = {}
    for fid, values in by_feature.items():
        p = get_feature_norm_metadata(
            str(fid),
            values,
            {
                "feature_overrides": None,
                "max_unique_enum_values": 10,
                "quantile_size": 20,
                "quantile_k2_threshold": 1000.0,
                "skip_box_cox": False,
                "skip_quantiles": True,
            },
        )
        if p is not None:
            if skip_preprocess:
                p = dataclasses.replace(p, feature_type=DO_NOT_PREPROCESS)
            out[fid] = p
    return out
