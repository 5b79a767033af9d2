"""Workflow result types (port of ``reagent_tpu/workflow/types.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from reagent_tpu_torch.data.data_module import TableSpec  # noqa: F401 re-export


@dataclasses.dataclass
class RLTrainingReport:
    td_loss: Optional[float] = None
    mean_reward: Optional[float] = None
    cpe_details: Optional[Any] = None


@dataclasses.dataclass
class RLTrainingOutput:
    output_paths: Dict[str, str] = dataclasses.field(default_factory=dict)
    validation_result: Optional[Any] = None
    publishing_result: Optional[Any] = None
    training_report: Optional[RLTrainingReport] = None
    logger_data: Dict[str, Any] = dataclasses.field(default_factory=dict)
