"""The bandit models (the port of ``reagent_tpu/models/__init__.py``'s
LinUCB imports); the other models are imported from their modules."""

from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinearRegressionUCB
from reagent_tpu_torch.models.linear_regression import (
    DisjointLinearRegressionUCB,
    LinearRegressionUCB,
)

__all__ = ["LinearRegressionUCB", "DisjointLinearRegressionUCB",
           "DeepRepresentLinearRegressionUCB"]
