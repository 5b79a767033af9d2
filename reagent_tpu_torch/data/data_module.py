"""Dataset plumbing: table specs, mdp-hash train/eval split, batch iteration.

Port of the parts of ``reagent_tpu/data/data_module.py`` the offline DQN path
uses.  A "table" is a parquet or pickle file read into a pandas DataFrame;
the same numpy shuffle gives the same minibatches as the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd


@dataclasses.dataclass
class TableSpec:
    table_name: str = ""
    table_sample: Optional[float] = None
    eval_table_sample: Optional[float] = None
    path: Optional[str] = None  # parquet/pickle path


class TrainEvalSampleRanges(NamedTuple):
    train_sample_range: Tuple[float, float]
    eval_sample_range: Tuple[float, float]


def get_sample_range(
    input_table_spec: TableSpec, calc_cpe_in_training: bool
) -> TrainEvalSampleRanges:
    """Reference: manual_data_module.py:47-83."""
    table_sample = input_table_spec.table_sample
    eval_table_sample = input_table_spec.eval_table_sample

    if not calc_cpe_in_training:
        train_range = (0.0, 100.0) if table_sample is None else (0.0, table_sample)
        return TrainEvalSampleRanges(train_range, (0.0, 0.0))

    if (
        table_sample is None
        or eval_table_sample is None
        or eval_table_sample + table_sample > 100.0 + 1e-3
    ):
        raise ValueError(
            "calc_cpe_in_training requires table_sample + eval_table_sample <= 100"
        )
    return TrainEvalSampleRanges(
        (0.0, table_sample), (100.0 - eval_table_sample, 100.0)
    )


def mdp_id_hash_fraction(mdp_id: str) -> float:
    """Deterministic [0, 100) bucket per mdp (the Spark hash-split equivalent)."""
    h = int(hashlib.md5(str(mdp_id).encode()).hexdigest()[:8], 16)
    return (h % 10000) / 100.0


def split_by_sample_range(
    df: pd.DataFrame, sample_range: Tuple[float, float]
) -> pd.DataFrame:
    lo, hi = sample_range
    frac = df["mdp_id"].map(mdp_id_hash_fraction)
    return df[(frac >= lo) & (frac < hi)].reset_index(drop=True)


def iterate_minibatches(
    df: pd.DataFrame, batch_size: int, drop_last: bool = True, seed: Optional[int] = None
) -> Iterator[pd.DataFrame]:
    """Shuffled fixed-size minibatches (the fused kernels take one batch size)."""
    idx = np.arange(len(df))
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    end = len(df) - (len(df) % batch_size) if drop_last else len(df)
    for start in range(0, end, batch_size):
        yield df.iloc[idx[start : start + batch_size]]
