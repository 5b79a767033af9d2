"""Model validators (port of ``reagent_tpu/validators/``; reference: reagent/validators/)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from reagent_tpu_torch.core.registry import VALIDATORS


@dataclasses.dataclass
class ValidationResult:
    should_publish: bool = True
    reason: Optional[str] = None


@VALIDATORS.register()
@dataclasses.dataclass
class NoValidation:
    """Reference: validators/noop_validator.py — always passes."""

    def validate(self, training_output) -> ValidationResult:
        return ValidationResult(should_publish=True)


@VALIDATORS.register()
@dataclasses.dataclass
class RewardThresholdValidator:
    """Publish only if the training report clears a reward / loss bar."""

    max_td_loss: Optional[float] = None
    min_mean_reward: Optional[float] = None

    def validate(self, training_output) -> ValidationResult:
        report = training_output.training_report
        if report is None:
            return ValidationResult(False, "no training report")
        if self.max_td_loss is not None and (
            report.td_loss is None or report.td_loss > self.max_td_loss
        ):
            return ValidationResult(False, f"td_loss {report.td_loss} > {self.max_td_loss}")
        if self.min_mean_reward is not None and (
            report.mean_reward is None or report.mean_reward < self.min_mean_reward
        ):
            return ValidationResult(False, f"mean_reward below {self.min_mean_reward}")
        return ValidationResult(True)
