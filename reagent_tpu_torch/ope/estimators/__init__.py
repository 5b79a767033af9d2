from reagent_tpu_torch.ope.estimators.estimator import (
    Estimator,
    EstimatorResult,
    EstimatorResults,
    Evaluator,
)

__all__ = ["Estimator", "EstimatorResult", "EstimatorResults", "Evaluator"]
