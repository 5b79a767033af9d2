"""Dataset plumbing: table specs, mdp-hash train/eval split, batch iteration.

Port of ``reagent_tpu/data/data_module.py`` (``TableSpec``, ``Dataset``, the
sample ranges and minibatches, ``ReAgentDataModule`` :89 and
``ManualDataModule`` :105).  A "table" is a parquet or pickle file read into
a pandas DataFrame; the same numpy shuffle gives the same minibatches as the
JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd


@dataclasses.dataclass
class TableSpec:
    table_name: str = ""
    table_sample: Optional[float] = None
    eval_table_sample: Optional[float] = None
    path: Optional[str] = None  # parquet/pickle path


@dataclasses.dataclass
class Dataset:
    parquet_url: str = ""

    def read(self) -> pd.DataFrame:
        if self.parquet_url.endswith((".pkl", ".pickle")):
            return pd.read_pickle(self.parquet_url)
        return pd.read_parquet(self.parquet_url)


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


class ReAgentDataModule:
    """Data-module contract: identify -> query -> batch (ref reagent_data_module.py)."""

    def get_normalization_data_map(self):
        raise NotImplementedError

    def prepare_data(self):
        raise NotImplementedError

    def train_dataset(self):
        raise NotImplementedError

    def eval_dataset(self):
        raise NotImplementedError


class ManualDataModule(ReAgentDataModule):
    """Pandas-backed data module mirroring the reference's petastorm flow.

    Reference: reagent/data/manual_data_module.py:85-250 — prepare_data fits
    normalization (or reuses pickled setup data), splits train/eval by mdp-id
    hash ranges, and exposes per-split minibatch iterators.  Spark/petastorm
    dissolve into pandas: query_data filters/transforms the timeline table.
    The batches are the model manager's batch preprocessor's, on ``device``.
    """

    def __init__(
        self,
        *,
        input_table_spec: Optional[TableSpec] = None,
        model_manager=None,
        setup_data: Optional[Dict[str, bytes]] = None,
        calc_cpe_in_training: bool = True,
        device="cuda",
    ):
        self.input_table_spec = input_table_spec
        self.model_manager = model_manager
        self.setup_data = setup_data or {}
        self.calc_cpe_in_training = calc_cpe_in_training
        self.device = device
        self._setup_done = False
        self._normalization_data_map = None
        self._train_df = None
        self._eval_df = None

    # -------- overridable hooks (ref :140-214) --------

    def run_feature_identification(self, df):
        assert self.model_manager is not None
        return self.model_manager.run_feature_identification(df)

    def query_data(self, df, sample_range) -> "pd.DataFrame":
        return split_by_sample_range(df, sample_range)

    def build_batch_preprocessor(self):
        assert self.model_manager is not None
        return self.model_manager.build_batch_preprocessor(
            self._normalization_data_map, device=self.device
        )

    # -------- lifecycle --------

    def prepare_data(self) -> None:
        if self._setup_done:
            return
        df = pd.read_pickle(self.input_table_spec.path)
        key = "normalization_data_map"
        if key in self.setup_data:
            self._normalization_data_map = pickle.loads(self.setup_data[key])
        else:
            self._normalization_data_map = self.run_feature_identification(df)
        ranges = get_sample_range(self.input_table_spec, self.calc_cpe_in_training)
        self._train_df = self.query_data(df, ranges.train_sample_range)
        self._eval_df = (
            self.query_data(df, ranges.eval_sample_range)
            if ranges.eval_sample_range is not None
            else df.iloc[0:0]
        )
        self._setup_done = True

    def get_normalization_data_map(self):
        assert self._setup_done, "call prepare_data() first"
        return self._normalization_data_map

    def train_dataset(self, batch_size: int = 512, seed: int = 0):
        assert self._setup_done, "call prepare_data() first"
        pre = self.build_batch_preprocessor()
        for batch_df in iterate_minibatches(self._train_df, batch_size, seed=seed):
            yield pre(batch_df)

    def eval_dataset(self, batch_size: int = 512):
        assert self._setup_done, "call prepare_data() first"
        if len(self._eval_df) == 0:
            return
        pre = self.build_batch_preprocessor()
        for batch_df in iterate_minibatches(
            self._eval_df, min(batch_size, len(self._eval_df)), drop_last=False
        ):
            yield pre(batch_df)
