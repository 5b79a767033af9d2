"""Slate-ranking serving wrappers (the port of ``reagent_tpu/prediction/ranking/``)."""

from reagent_tpu_torch.prediction.ranking.predictor_wrapper import (
    DeterminantalPointProcessPredictorWrapper,
    Kernel,
)

__all__ = ["DeterminantalPointProcessPredictorWrapper", "Kernel"]
