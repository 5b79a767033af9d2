"""DecisionPlanBuilder: author a plan as a python operator DAG, serialize to JSON.

Port of ``reagent_tpu/serving/builder.py``, a copy.

Reference: serving/reagent/serving/config/builder.py:21-96.  The output JSON
matches the C++ service's DecisionConfig schema (serving/include/
reagent_serving/containers.h).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from reagent_tpu_torch.serving.operators import DecisionOperator


class DecisionPlanBuilder:
    def __init__(self):
        self.operators = []
        self.constants: Dict[str, Any] = {}
        self.root_op: Optional[DecisionOperator] = None
        self.num_actions_to_choose = 1
        self.reward_function = ""
        self.reward_aggregator = "max"

    def set_root(self, op: DecisionOperator) -> "DecisionPlanBuilder":
        self.root_op = op
        return self

    def set_num_actions_to_choose(self, num: int) -> "DecisionPlanBuilder":
        self.num_actions_to_choose = num
        return self

    def set_reward_function(self, reward_function: str) -> "DecisionPlanBuilder":
        self.reward_function = reward_function
        return self

    def set_reward_aggregator(self, agg: str) -> "DecisionPlanBuilder":
        self.reward_aggregator = agg
        return self

    def build(self) -> Dict[str, Any]:
        assert self.root_op is not None, "Need to set root operator before exporting"
        self.operators = []
        self.constants = {}
        visited = set()
        counter = [0]

        def nid() -> int:
            counter[0] += 1
            return counter[0]

        def create_node(node) -> str:
            if isinstance(node, DecisionOperator):
                if id(node) in visited:
                    return node.name
                node.name = f"{node.op_name}_{nid()}"
                visited.add(id(node))
                dep_map = {
                    name: create_node(arg) for name, arg in node.arguments().items()
                }
                self.operators.append(
                    {"name": node.name, "op_name": node.op_name, "input_dep_map": dep_map}
                )
                return node.name
            cname = f"constant_{nid()}"
            self.constants[cname] = node
            return cname

        create_node(self.root_op)
        # topological: dependencies were appended before dependents by the
        # post-order recursion; the output node must be last
        return {
            "operators": self.operators,
            "constants": self.constants,
            "num_actions_to_choose": self.num_actions_to_choose,
            "reward_function": self.reward_function,
            "reward_aggregator": self.reward_aggregator,
        }


def export_plan(builder, path: str) -> None:
    """Write a plan (builder or already-built dict) as JSON for the service."""
    plan = builder.build() if hasattr(builder, "build") else builder
    with open(path, "w") as f:
        json.dump(plan, f, indent=2)
