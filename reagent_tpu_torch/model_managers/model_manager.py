"""ModelManager base: ties net builder + trainer + data + reporter + export.

Port of ``reagent_tpu/model_managers/model_manager.py``.
"""

from __future__ import annotations

from typing import Dict

from reagent_tpu_torch.core.parameters import NormalizationData


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
