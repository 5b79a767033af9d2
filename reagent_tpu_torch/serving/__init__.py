"""Python-side serving config DSL + client for the C++ decision service.

Port of ``reagent_tpu/serving/`` (the DSL and the client are copies; the JSON
they write is JAX's byte for byte), with ``native``: the C++ service built
from the repo's sources and run on the port's artifacts.
Reference: serving/reagent/serving/config/ (builder.py:21 DecisionPlanBuilder,
operators.py operator stubs, applications/example/); the runtime itself is the
dependency-free C++ service under /serving.
"""

from reagent_tpu_torch.serving.builder import DecisionPlanBuilder, export_plan
from reagent_tpu_torch.serving.operators import (
    ActionValueScoring,
    EpsilonGreedyRanker,
    Expression,
    Frechet,
    InputFromRequest,
    PropensityFit,
    Softmax,
    SoftmaxRanker,
    Ucb,
)
from reagent_tpu_torch.serving.client import DecisionServiceClient
from reagent_tpu_torch.serving.native import build_decision_service, decision_service

__all__ = [
    "DecisionPlanBuilder",
    "export_plan",
    "Ucb",
    "Softmax",
    "SoftmaxRanker",
    "EpsilonGreedyRanker",
    "Frechet",
    "Expression",
    "PropensityFit",
    "ActionValueScoring",
    "InputFromRequest",
    "DecisionServiceClient",
    "build_decision_service",
    "decision_service",
]
