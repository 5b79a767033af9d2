"""Reward shaping on queried tables before training.

Port of ``reagent_tpu/data/reward_options.py``, line for line (reference:
reagent/workflow/types.py:79 ``RewardOptions`` +
reagent/data/oss_data_fetcher.py:35-63 — Spark-SQL reward expressions
(``calc_custom_reward``), metric-weighted rewards, and multi-step discounted
reward folding.  Here the Spark SQL dissolves into vectorized pandas/numpy:
expressions use pandas.eval syntax over the columns, with each metrics-map
key exposed as ``metrics_<key>``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import pandas as pd


@dataclasses.dataclass
class RewardOptions:
    """custom_reward_expression: pandas.eval expression over columns
    (``reward``, ``metrics_<key>``, ...), e.g. ``"reward * 2 + metrics_ctr"``.
    metric_reward_values: {metric_name: weight} -> reward = sum w*metric.
    """

    custom_reward_expression: Optional[str] = None
    metric_reward_values: Optional[Dict[str, float]] = None


def _metrics_frame(df: pd.DataFrame) -> pd.DataFrame:
    if "metrics" not in df.columns:
        return pd.DataFrame(index=df.index)
    metrics = pd.DataFrame(list(df["metrics"].fillna({}).apply(dict)), index=df.index)
    return metrics.fillna(0.0)


def calc_custom_reward(df: pd.DataFrame, custom_reward_expression: str) -> pd.DataFrame:
    """Overwrite ``reward`` with the expression (ref oss_data_fetcher.py:35-46;
    NULL-coalescing there becomes fillna(0) here)."""
    local = {c: df[c] for c in df.columns if df[c].dtype != object}
    if "reward" in df.columns:
        local["reward"] = pd.to_numeric(df["reward"], errors="coerce")
    for k, col in _metrics_frame(df).items():
        local[f"metrics_{k}"] = col
    out = df.copy()
    result = pd.eval(custom_reward_expression, local_dict=local, engine="python")
    out["reward"] = (
        pd.Series(np.asarray(result, np.float32).reshape(-1), index=df.index)
        .fillna(0.0)
        .astype(np.float32)
    )
    return out


def calc_metric_reward(df: pd.DataFrame, metric_reward_values: Dict[str, float]) -> pd.DataFrame:
    """reward = sum_k w_k * metrics[k] (the reference's metric_reward_values)."""
    metrics = _metrics_frame(df)
    reward = np.zeros(len(df), np.float32)
    for k, w in metric_reward_values.items():
        if k in metrics.columns:
            reward += np.float32(w) * metrics[k].to_numpy(np.float32)
    out = df.copy()
    out["reward"] = reward
    return out


def calc_reward_multi_steps(df: pd.DataFrame, gamma: float) -> pd.DataFrame:
    """Fold list-valued rewards to r_0 + g*(r_1 + g*(...)) (ref :48-52)."""

    def fold(r) -> float:
        if isinstance(r, (list, tuple, np.ndarray)):
            acc = 0.0
            for x in reversed(list(r)):
                acc = gamma * acc + float(x)
            return acc
        return float(r)

    out = df.copy()
    out["reward"] = df["reward"].apply(fold).astype(np.float32)
    return out


def apply_reward_options(
    df: pd.DataFrame, reward_options: Optional[RewardOptions]
) -> pd.DataFrame:
    if reward_options is None:
        return df
    if reward_options.metric_reward_values:
        df = calc_metric_reward(df, reward_options.metric_reward_values)
    if reward_options.custom_reward_expression:
        df = calc_custom_reward(df, reward_options.custom_reward_expression)
    return df
