"""End-to-end offline training pipeline.

Port of ``reagent_tpu/workflow/training.py`` (reference:
reagent/workflow/training.py:59-323): feature identification -> query/split
data -> train -> counterfactual policy evaluation (CPE) on the eval split ->
export the serving artifact -> validate -> publish, for the managers the
port has (``DiscreteDQN``, fused or unfused, and ``DiscreteQRDQN``), with
reward options, warm start from a checkpoint (``utils/checkpointing.py``)
and the manager's reporter, which every train step's metrics go through.

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
import reagent_tpu_torch.publishers  # noqa: F401 — registers publishers
import reagent_tpu_torch.validators  # noqa: F401 — registers validators
from reagent_tpu_torch.core.registry import MODEL_MANAGERS, PUBLISHERS, VALIDATORS
from reagent_tpu_torch.data.data_module import (
    TableSpec,
    get_sample_range,
    iterate_minibatches,
    split_by_sample_range,
)
from reagent_tpu_torch.data.reward_options import RewardOptions, apply_reward_options
from reagent_tpu_torch.evaluation import EvaluationDataPage, Evaluator
from reagent_tpu_torch.utils.checkpointing import restore_checkpoint, save_checkpoint
from reagent_tpu_torch.utils.device import resolve_device
from reagent_tpu_torch.workflow.types import RLTrainingOutput, RLTrainingReport

logger = logging.getLogger(__name__)


def identify_and_train_network(
    input_table_spec: TableSpec,
    model: Dict[str, Any],
    num_epochs: int,
    output_dir: str = "/tmp/reagent_tpu_model",
    use_gpu: bool = False,
    seed: int = 0,
    minibatch_size: Optional[int] = None,
    warm_start_path: Optional[str] = None,
    reward_options: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> RLTrainingOutput:
    """Reference: training.py:59-122 (``output_dir``'s default is the JAX
    package's, so the two CLIs print one schema apart from ``device``)."""
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
    manager = _manager or MODEL_MANAGERS.build(model)
    df = _df if _df is not None else _load_table(input_table_spec)
    if reward_options:
        opts = (
            reward_options
            if isinstance(reward_options, RewardOptions)
            else RewardOptions(**reward_options)
        )
        df = apply_reward_options(df, opts)
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

    ``warm_start_path``: incremental training — if the file exists, the
    trainer state (params, optimizer state, targets, step) is restored from
    it before training, and it is OVERWRITTEN with the final state after
    (the reference's resume_from_checkpoint + save-after-fit semantics,
    workflow/utils.py:161,173-176 there).

    The trainer state comes from ``manager.init_trainer_state(trainer,
    generator, state_dim)`` where the manager defines it, else from
    ``trainer.init(generator)``; ``generator`` is a CPU ``torch.Generator``
    seeded with ``seed``.  Where the trainer has CPE heads and ``eval_df``
    rows, the report's ``cpe_details`` come from the ``Evaluator`` on the
    eval split; ``logger_data`` holds ``eval_seconds`` beside
    ``train_seconds`` (0.0 without CPE) and ``report_seconds``, the part of
    ``train_seconds`` spent in the reporter (its copy of each step's metrics
    to the host waits for the step).
    """
    device = resolve_device(device)
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

    if warm_start_path and os.path.exists(warm_start_path):
        trainer_state = restore_checkpoint(warm_start_path, trainer_state)
        logger.info("warm-started trainer state from %s", warm_start_path)

    reporter = manager.get_reporter()
    t0 = time.perf_counter()
    last_loss = None
    train_steps = 0
    report_seconds = 0.0
    for epoch in range(num_epochs):
        metrics = None
        for batch_df in iterate_minibatches(train_df, bs, seed=seed + epoch):
            batch = batch_preprocessor(batch_df)
            trainer_state, metrics = trainer.train_step(trainer_state, batch)
            train_steps += 1
            if reporter is not None:
                t_report = time.perf_counter()
                reporter.log(**metrics)
                report_seconds += time.perf_counter() - t_report
        if reporter is not None:
            t_report = time.perf_counter()
            reporter.flush(epoch)
            report_seconds += time.perf_counter() - t_report
        if metrics is None:
            raise ValueError(
                f"epoch {epoch}: {len(train_df)} training rows make no minibatch "
                f"of {bs}")
        loss_key = "td_loss" if "td_loss" in metrics else (
            "q1_loss" if "q1_loss" in metrics else next(iter(metrics))
        )
        last_loss = float(metrics[loss_key])
        logger.info("epoch %d td_loss=%.4f", epoch, last_loss)
    train_seconds = time.perf_counter() - t0  # float() above waited for the device
    logger.info("training took %.1fs", train_seconds)

    report = RLTrainingReport(td_loss=last_loss)
    eval_seconds = 0.0
    if len(eval_df) > 0 and getattr(trainer, "calc_cpe_in_training", False):
        t0 = time.perf_counter()
        edp = _build_edp(trainer, trainer_state, batch_preprocessor, eval_df, bs)
        evaluator = Evaluator(manager.action_names, trainer.gamma, device=trainer.device)
        report.cpe_details = evaluator.evaluate_post_training(edp)
        eval_seconds = time.perf_counter() - t0  # the estimates are host floats

    if warm_start_path:
        os.makedirs(os.path.dirname(warm_start_path) or ".", exist_ok=True)
        save_checkpoint(warm_start_path, trainer_state)
        logger.info("saved warm-start state to %s", warm_start_path)

    serving = manager.build_serving_module(trainer, trainer_state, normalization_data_map)
    os.makedirs(output_dir, exist_ok=True)
    model_path = os.path.join(output_dir, "serving_model")
    if hasattr(serving, "save"):
        serving.save(model_path)
    else:
        model_path = ""
    return RLTrainingOutput(
        output_paths={"default_model": model_path},
        training_report=report,
        logger_data={"train_steps": train_steps, "train_seconds": train_seconds,
                     "report_seconds": report_seconds, "eval_seconds": eval_seconds},
    )


def _build_edp(trainer, trainer_state, batch_preprocessor, eval_df, bs) -> EvaluationDataPage:
    """An EvaluationDataPage over the eval split, in order, in minibatches of
    at most ``bs`` rows (reference dqn_trainer_base.py:455-495)."""
    edp = None
    for batch_df in iterate_minibatches(eval_df, min(bs, len(eval_df)), drop_last=False):
        batch = batch_preprocessor(batch_df)
        page = EvaluationDataPage.create_from_tensors_dqn(
            trainer,
            trainer_state,
            batch.extras.mdp_id,
            batch.extras.sequence_number,
            batch.state.float_features,
            batch.action,
            torch.clamp(batch.extras.action_probability, min=1e-6),
            batch.reward,
            batch.possible_actions_mask,
        )
        edp = page if edp is None else edp.append(page)
    edp = edp.sort().compute_values(trainer.gamma)
    edp.validate()
    return edp


def run_validator(validator_config, training_output: RLTrainingOutput) -> RLTrainingOutput:
    """Reference: training.py:326-336."""
    validator = VALIDATORS.build(validator_config)
    result = validator.validate(training_output)
    return RLTrainingOutput(
        output_paths=training_output.output_paths,
        validation_result=result,
        training_report=training_output.training_report,
    )


def run_publisher(
    publisher_config, model_config, training_output: RLTrainingOutput, recurring_period=None
) -> RLTrainingOutput:
    """Reference: training.py:337-360."""
    publisher = PUBLISHERS.build(publisher_config)
    result = publisher.publish(model_config, training_output, recurring_period)
    return RLTrainingOutput(
        output_paths=training_output.output_paths,
        validation_result=training_output.validation_result,
        publishing_result=result,
        training_report=training_output.training_report,
    )
