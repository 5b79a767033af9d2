"""Workflow option and result types (port of ``reagent_tpu/workflow/types.py``:
``ReaderOptions`` :12, ``ResourceOptions`` :18, ``PreprocessingOptions`` :25,
``ModelFeatureConfigProvider`` :63, the training report and output)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from reagent_tpu_torch.data.data_module import Dataset, TableSpec  # noqa: F401 re-export


@dataclasses.dataclass
class ReaderOptions:
    minibatch_size: int = 512
    reader_pool_type: str = "thread"


@dataclasses.dataclass
class ResourceOptions:
    gpu: int = 0
    min_nodes: Optional[int] = None
    max_nodes: Optional[int] = None


@dataclasses.dataclass
class PreprocessingOptions:
    """Feature-identification knobs (reference workflow/types.py:106-123);
    ``normalization_kwargs`` are the keywords of
    ``workflow.identify_types_flow.normalization_helper``."""

    num_samples: Optional[int] = None  # defaults resolved in normalization.py
    max_unique_enum_values: Optional[int] = None
    quantile_size: Optional[int] = None
    quantile_k2_threshold: Optional[float] = None
    skip_box_cox: bool = False
    skip_quantiles: bool = True
    feature_overrides: Optional[Dict[int, str]] = None
    tablesample: Optional[float] = None
    set_missing_value_to_zero: Optional[bool] = False
    allowedlist_features: Optional[List[int]] = None
    assert_allowedlist_feature_coverage: bool = True

    def normalization_kwargs(self) -> Dict[str, Any]:
        """Keyword args for normalization_helper, dropping unset fields."""
        from reagent_tpu_torch.preprocessing.identify_types import DEFAULT_MAX_UNIQUE_ENUM
        from reagent_tpu_torch.preprocessing.normalization import (
            DEFAULT_MAX_QUANTILE_SIZE,
            DEFAULT_QUANTILE_K2_THRESHOLD,
        )

        return dict(
            max_unique_enum_values=self.max_unique_enum_values or DEFAULT_MAX_UNIQUE_ENUM,
            quantile_size=self.quantile_size or DEFAULT_MAX_QUANTILE_SIZE,
            quantile_k2_threshold=self.quantile_k2_threshold
            or DEFAULT_QUANTILE_K2_THRESHOLD,
            skip_box_cox=self.skip_box_cox,
            skip_quantiles=self.skip_quantiles,
            feature_overrides=self.feature_overrides,
            allowedlist_features=self.allowedlist_features,
        )


@dataclasses.dataclass
class ModelFeatureConfigProvider:
    """Registry of ModelFeatureConfig sources (reference
    models/model_feature_config_provider.py:12-23).  The 'raw' provider simply
    returns the config it was constructed with."""

    raw: Optional[Any] = None  # a core.types.ModelFeatureConfig

    def get_model_feature_config(self):
        from reagent_tpu_torch.core import types as rlt

        return self.raw if self.raw is not None else rlt.ModelFeatureConfig()


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
