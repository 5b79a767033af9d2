"""Timeline operator: logged rows -> adjacent-pair MDP transitions.

Port of ``reagent_tpu/data/timeline.py``, line for line.  Reference:
preprocessing/src/main/scala/com/facebook/spark/rl/Timeline.scala:124-427
(Hive SQL with LEAD window functions over (mdp_id, sequence_number)) and
MultiStepTimeline.scala:8-324 (n-step lists).

Schema contract (docs/usage.rst:115-145): input columns
  mdp_id, sequence_number, state_features (dict), action,
  action_probability, reward, possible_actions [, metrics, ds]
output adds
  next_state_features, next_action, possible_next_actions, time_diff,
  sequence_number_ordinal, time_since_first.

The Spark cluster dissolves into a pandas groupby-shift over a local or
distributed parquet store, not a Hive warehouse.
"""

from __future__ import annotations

import os

from typing import List, Optional

import numpy as np
import pandas as pd


def timeline_transform(
    df: pd.DataFrame,
    multi_steps: Optional[int] = None,
    percentile: float = 1.0,
    shuffle: bool = True,
    seed: int = 0,
) -> pd.DataFrame:
    """Single-step timeline (Timeline.scala:124-427 semantics).

    ``percentile`` < 1 drops outlier-length episodes, mirroring the Scala
    job's percentile_approx filtering (Timeline.scala:131-160).
    """
    if multi_steps is not None:
        return multi_step_timeline_transform(df, multi_steps, percentile, shuffle, seed)
    df = df.sort_values(["mdp_id", "sequence_number"], kind="stable").reset_index(drop=True)

    if percentile < 1.0:
        ep_len = df.groupby("mdp_id")["sequence_number"].transform("size")
        cutoff = df.groupby("mdp_id")["sequence_number"].size().quantile(percentile)
        df = df[ep_len <= cutoff].reset_index(drop=True)

    g = df.groupby("mdp_id", sort=False)
    out = df.copy()
    out["next_state_features"] = g["state_features"].shift(-1)
    out["next_action"] = g["action"].shift(-1)
    if "possible_actions" in df.columns:
        out["possible_next_actions"] = g["possible_actions"].shift(-1)
    next_seq = g["sequence_number"].shift(-1)
    out["time_diff"] = (next_seq - df["sequence_number"]).fillna(1).astype(int)
    out["sequence_number_ordinal"] = g.cumcount() + 1
    first_seq = g["sequence_number"].transform("first")
    out["time_since_first"] = df["sequence_number"] - first_seq

    # terminal rows: no next state; fill consistent empties
    is_terminal = out["next_state_features"].isna()
    out.loc[is_terminal, "next_state_features"] = out.loc[is_terminal, "next_state_features"].apply(
        lambda _: {}
    )
    empty_action = "" if df["action"].dtype == object else -1
    out["next_action"] = out["next_action"].where(~out["next_action"].isna(), empty_action)
    if "possible_next_actions" in out.columns:
        pna_terminal = out["possible_next_actions"].isna()
        out.loc[pna_terminal, "possible_next_actions"] = out.loc[
            pna_terminal, "possible_next_actions"
        ].apply(lambda _: [])
    out["not_terminal"] = (~is_terminal).astype(int)

    if shuffle:
        out = out.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    return out


def multi_step_timeline_transform(
    df: pd.DataFrame,
    multi_steps: int,
    percentile: float = 1.0,
    shuffle: bool = True,
    seed: int = 0,
) -> pd.DataFrame:
    """n-step timeline: next_* become lists of up to ``multi_steps`` entries.

    Reference: MultiStepTimeline.scala:8-324.
    """
    df = df.sort_values(["mdp_id", "sequence_number"], kind="stable").reset_index(drop=True)
    rows = []
    for mdp_id, ep in df.groupby("mdp_id", sort=False):
        ep = ep.reset_index(drop=True)
        n = len(ep)
        first_seq = ep["sequence_number"].iloc[0]
        for i in range(n):
            horizon = min(multi_steps, n - 1 - i)
            row = ep.iloc[i].to_dict()
            row["sequence_number_ordinal"] = i + 1
            row["time_since_first"] = ep["sequence_number"].iloc[i] - first_seq
            if horizon == 0:
                row["next_state_features"] = []
                row["next_action"] = []
                row["possible_next_actions"] = []
                row["reward"] = [row["reward"]]
                row["time_diff"] = [1]
                row["not_terminal"] = 0
            else:
                idx = list(range(i + 1, i + 1 + horizon))
                row["next_state_features"] = [ep["state_features"].iloc[j] for j in idx]
                row["next_action"] = [ep["action"].iloc[j] for j in idx]
                if "possible_actions" in ep.columns:
                    row["possible_next_actions"] = [
                        ep["possible_actions"].iloc[j] for j in idx
                    ]
                # rewards r_i .. r_{i+horizon-1}: the n-step return numerators
                row["reward"] = [ep["reward"].iloc[j] for j in range(i, i + horizon)]
                row["time_diff"] = [
                    int(ep["sequence_number"].iloc[j] - ep["sequence_number"].iloc[j - 1])
                    for j in idx
                ]
                row["not_terminal"] = int(i + horizon < n - 1)
            rows.append(row)
    out = pd.DataFrame(rows)
    if shuffle:
        out = out.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    return out


def _transform_shard(args):
    df_shard, multi_steps, percentile = args
    return timeline_transform(
        df_shard, multi_steps=multi_steps, percentile=percentile, shuffle=False
    )


def partitioned_timeline_transform(
    df: pd.DataFrame,
    num_partitions: int = 8,
    multi_steps: Optional[int] = None,
    percentile: float = 1.0,
    shuffle: bool = True,
    seed: int = 0,
    pool=None,
) -> pd.DataFrame:
    """Scale-out timeline: episodes hashed into ``num_partitions`` shards,
    each transformed in parallel, results concatenated + shuffled.

    This is the data-plane-parallel equivalent of the reference's Spark
    cluster execution (Timeline.scala runs as a distributed SQL job;
    Helper.scala hash-partitions by mdp_id).  Episodes never span shards, so
    the result equals the single-shard transform up to row order.

    ``pool``: any Executor with ``map`` (default: process pool sized
    ``num_partitions``); pass a distributed executor to run across hosts.
    """
    if num_partitions <= 1 or len(df) == 0:
        return timeline_transform(
            df, multi_steps=multi_steps, percentile=percentile, shuffle=shuffle, seed=seed
        )
    # percentile filtering needs the GLOBAL episode-length distribution;
    # apply it before sharding so shards agree with the unsharded output
    if percentile < 1.0:
        ep_len = df.groupby("mdp_id")["sequence_number"].transform("size")
        cutoff = df.groupby("mdp_id")["sequence_number"].size().quantile(percentile)
        df = df[ep_len <= cutoff].reset_index(drop=True)

    shard_of = pd.util.hash_array(df["mdp_id"].astype(str).to_numpy()) % num_partitions
    shards = [df[shard_of == p] for p in range(num_partitions)]
    work = [(s, multi_steps, 1.0) for s in shards if len(s)]

    if pool is None:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=min(num_partitions, os.cpu_count() or 8)) as ex:
            parts = list(ex.map(_transform_shard, work))
    else:
        parts = list(pool.map(_transform_shard, work))
    out = pd.concat(parts, ignore_index=True)
    if shuffle:
        out = out.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    return out
