"""Operator stubs for authoring decision plans in python.

Port of ``reagent_tpu/serving/operators.py``, a copy.

Reference: serving/reagent/serving/config/operators.py:15-89 — each stub
records its op name and named inputs; the builder serializes the DAG.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class DecisionOperator:
    op_name: str = ""

    def __init__(self, **inputs: Any):
        self.inputs = {k: v for k, v in inputs.items() if v is not None}
        self.name: Optional[str] = None

    def arguments(self) -> Dict[str, Any]:
        return self.inputs


class Ucb(DecisionOperator):
    op_name = "Ucb"

    def __init__(self, method: str = "UCB1", batch_size: Optional[int] = None):
        super().__init__(method=method, batch_size=batch_size)


class Softmax(DecisionOperator):
    op_name = "Softmax"

    def __init__(self, values: Any = None, temperature: float = 1.0):
        super().__init__(values=values, temperature=temperature)


class SoftmaxRanker(DecisionOperator):
    op_name = "SoftmaxRanker"

    def __init__(self, values: Any = None, temperature: float = 1.0):
        super().__init__(values=values, temperature=temperature)


class EpsilonGreedyRanker(DecisionOperator):
    op_name = "EpsilonGreedyRanker"

    def __init__(self, values: Any = None, epsilon: float = 0.1):
        super().__init__(values=values, epsilon=epsilon)


class Frechet(DecisionOperator):
    op_name = "Frechet"

    def __init__(self, values: Any = None, rho: float = 1.0, gamma: float = 1.0):
        super().__init__(values=values, rho=rho, gamma=gamma)


class Expression(DecisionOperator):
    op_name = "Expression"

    def __init__(self, equation: str = "", **variables: Any):
        super().__init__(equation=equation, **variables)


class PropensityFit(DecisionOperator):
    op_name = "PropensityFit"

    def __init__(self, input: Any = None, targets: Any = None):
        super().__init__(input=input, targets=targets)


class ActionValueScoring(DecisionOperator):
    op_name = "ActionValueScoring"

    def __init__(self, model_path: str = ""):
        super().__init__(model_path=model_path)


class InputFromRequest(DecisionOperator):
    op_name = "InputFromRequest"

    def __init__(self):
        super().__init__()
