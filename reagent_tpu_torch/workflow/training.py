"""End-to-end offline training pipeline.

Port of ``reagent_tpu/workflow/training.py`` (reference:
reagent/workflow/training.py:59-323): feature identification -> query/split
data -> train -> export the serving artifact.  This slice trains through the
fused DQN update; CPE, warm start, reward options, validators and
publishers are not ported yet (``ROADMAP.md`` §1).

Every entry point takes ``device`` (default ``"cuda"``; raises when no card
is present rather than dropping to the CPU).  ``use_gpu`` is accepted so the
JAX package's calls and configs carry over; it has no effect.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import pandas as pd
import torch

import reagent_tpu_torch.model_managers  # noqa: F401 — registers model managers
from reagent_tpu_torch.core.registry import MODEL_MANAGERS
from reagent_tpu_torch.data.data_module import (
    TableSpec,
    get_sample_range,
    iterate_minibatches,
    split_by_sample_range,
)
from reagent_tpu_torch.utils.device import resolve_device
from reagent_tpu_torch.workflow.types import RLTrainingOutput, RLTrainingReport

logger = logging.getLogger(__name__)


def identify_and_train_network(
    input_table_spec: TableSpec,
    model: Dict[str, Any],
    num_epochs: int,
    output_dir: str,
    use_gpu: bool = False,
    seed: int = 0,
    minibatch_size: Optional[int] = None,
    warm_start_path: Optional[str] = None,
    reward_options: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> RLTrainingOutput:
    """Reference: training.py:59-122."""
    device = resolve_device(device)
    manager = MODEL_MANAGERS.build(model)
    df = _load_table(input_table_spec)
    normalization_data_map = manager.run_feature_identification(df)
    return query_and_train(
        input_table_spec,
        model,
        num_epochs,
        output_dir=output_dir,
        use_gpu=use_gpu,
        seed=seed,
        normalization_data_map=normalization_data_map,
        warm_start_path=warm_start_path,
        reward_options=reward_options,
        minibatch_size=minibatch_size,
        _df=df,
        _manager=manager,
        device=device,
    )


def _load_table(spec: TableSpec) -> pd.DataFrame:
    if not spec.path:
        raise ValueError("TableSpec.path (parquet/pickle) required")
    if spec.path.endswith((".pkl", ".pickle")):
        return pd.read_pickle(spec.path)
    return pd.read_parquet(spec.path)


def query_and_train(
    input_table_spec: TableSpec,
    model: Dict[str, Any],
    num_epochs: int,
    output_dir: str,
    use_gpu: bool = False,
    seed: int = 0,
    normalization_data_map=None,
    minibatch_size: Optional[int] = None,
    warm_start_path: Optional[str] = None,
    reward_options: Optional[Dict[str, Any]] = None,
    _df: Optional[pd.DataFrame] = None,
    _manager=None,
    device="cuda",
) -> RLTrainingOutput:
    """Reference: training.py:106-213."""
    device = resolve_device(device)
    if reward_options:
        raise NotImplementedError(
            "reward_options (data/reward_options.py) are not ported yet (ROADMAP.md §1)")
    manager = _manager or MODEL_MANAGERS.build(model)
    df = _df if _df is not None else _load_table(input_table_spec)
    calc_cpe = getattr(manager, "eval_params", None) and manager.eval_params.calc_cpe_in_training
    sample_range = get_sample_range(input_table_spec, bool(calc_cpe))
    train_df = split_by_sample_range(df, sample_range.train_sample_range)
    eval_df = split_by_sample_range(df, sample_range.eval_sample_range)
    logger.info("train rows=%d eval rows=%d", len(train_df), len(eval_df))
    return train_workflow(
        manager,
        train_df,
        eval_df,
        num_epochs=num_epochs,
        output_dir=output_dir,
        seed=seed,
        normalization_data_map=normalization_data_map,
        minibatch_size=minibatch_size,
        warm_start_path=warm_start_path,
        device=device,
    )


def train_workflow(
    manager,
    train_df: pd.DataFrame,
    eval_df: pd.DataFrame,
    num_epochs: int,
    output_dir: str,
    seed: int = 0,
    normalization_data_map=None,
    minibatch_size: Optional[int] = None,
    warm_start_path: Optional[str] = None,
    device="cuda",
) -> RLTrainingOutput:
    """Reference: training.py:214-323.

    The trainer state comes from ``manager.init_trainer_state(trainer,
    generator, state_dim)`` where the manager defines it, else from
    ``trainer.init(generator)``; ``generator`` is a CPU ``torch.Generator``
    seeded with ``seed``.  ``eval_df`` feeds CPE, which the fused trainer
    does not run.
    """
    device = resolve_device(device)
    if warm_start_path:
        raise NotImplementedError(
            "warm-start checkpointing (utils/checkpointing.py) is not ported yet "
            "(ROADMAP.md §1)")
    if normalization_data_map is None:
        normalization_data_map = manager.run_feature_identification(train_df)

    trainer = manager.build_trainer(normalization_data_map, device=device)
    batch_preprocessor = manager.build_batch_preprocessor(normalization_data_map, device=device)
    bs = minibatch_size or manager._param.minibatch_size

    generator = torch.Generator().manual_seed(seed)
    state_dim = manager.state_dim(normalization_data_map)
    if hasattr(manager, "init_trainer_state"):
        trainer_state = manager.init_trainer_state(trainer, generator, state_dim)
    else:
        trainer_state = trainer.init(generator)

    reporter = manager.get_reporter()
    t0 = time.perf_counter()
    last_loss = None
    train_steps = 0
    for epoch in range(num_epochs):
        metrics = None
        for batch_df in iterate_minibatches(train_df, bs, seed=seed + epoch):
            batch = batch_preprocessor(batch_df)
            trainer_state, metrics = trainer.train_step(trainer_state, batch)
            train_steps += 1
            if reporter is not None:
                reporter.log(**metrics)
        if reporter is not None:
            reporter.flush(epoch)
        if metrics is None:
            raise ValueError(
                f"epoch {epoch}: {len(train_df)} training rows make no minibatch "
                f"of {bs}")
        last_loss = float(metrics["td_loss"])
        logger.info("epoch %d td_loss=%.4f", epoch, last_loss)
    train_seconds = time.perf_counter() - t0  # float() above waited for the device
    logger.info("training took %.1fs", train_seconds)

    serving = manager.build_serving_module(trainer, trainer_state, normalization_data_map)
    os.makedirs(output_dir, exist_ok=True)
    model_path = os.path.join(output_dir, "serving_model")
    serving.save(model_path)
    return RLTrainingOutput(
        output_paths={"default_model": model_path},
        training_report=RLTrainingReport(td_loss=last_loss),
        logger_data={"train_steps": train_steps, "train_seconds": train_seconds},
    )
