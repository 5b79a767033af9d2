"""Permutation feature importance (port of
``reagent_tpu/evaluation/feature_importance/__init__.py``)."""

from reagent_tpu_torch.evaluation.feature_importance.feature_importance_perturbation import (
    FeatureImportanceBase,
    FeatureImportancePerturbation,
    create_default_perturb_fn,
)

__all__ = [
    "FeatureImportanceBase",
    "FeatureImportancePerturbation",
    "create_default_perturb_fn",
]
