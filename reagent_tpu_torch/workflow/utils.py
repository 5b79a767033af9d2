"""Workflow utilities: rank detection and the generic train/eval driver.

Port of ``reagent_tpu/workflow/utils.py`` (reference:
reagent/workflow/utils.py:64-177 — petastorm readers +
``train_eval_lightning``): the data reader is the pandas minibatcher
(data_module.iterate_minibatches — petastorm's role), the rank comes from
``torch.distributed`` where the JAX package reads ``jax.process_index``, and
the per-epoch loop drives the trainer directly (Lightning's role).  The
reporter brings each step's metrics to the host; the epoch summary reads
the last step's.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from reagent_tpu_torch.core.tracker import values_to_host

logger = logging.getLogger(__name__)


def get_rank() -> int:
    """This process's rank in the initialized default process group, else 0
    (ref workflow/utils.py:121-132)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def train_eval(
    trainer,
    trainer_state,
    train_batches: Iterable,
    num_epochs: int,
    eval_batches: Optional[Iterable] = None,
    eval_step: Optional[Callable[[Any, Any], Dict[str, float]]] = None,
    reporter=None,
    on_epoch_end: Optional[Callable[[Any, int], Any]] = None,
) -> Tuple[Any, Dict[str, float]]:
    """Epoch loop over pre-built typed batches (ref train_eval_lightning:135-177).

    ``train_batches``/``eval_batches`` may be lists (re-iterated per epoch) or
    callables returning fresh iterators.
    """
    last_metrics: Dict[str, float] = {}
    t0 = time.perf_counter()
    for epoch in range(num_epochs):
        it = train_batches() if callable(train_batches) else train_batches
        for batch in it:
            trainer_state, metrics = trainer.train_step(trainer_state, batch)
            if reporter is not None:
                reporter.log(**{k: v for k, v in metrics.items()})
        # scalar summary only — array metrics (action/value histograms)
        # are for the reporter's aggregators
        last_metrics = {
            k: float(np.mean(v)) for k, v in values_to_host(metrics).items()
        }
        if reporter is not None:
            reporter.flush(epoch)
        if on_epoch_end is not None:
            trainer_state = on_epoch_end(trainer_state, epoch) or trainer_state
        if get_rank() == 0:
            logger.info("epoch %d %s", epoch, last_metrics)

    if eval_batches is not None and eval_step is not None and get_rank() == 0:
        it = eval_batches() if callable(eval_batches) else eval_batches
        evals = [eval_step(trainer_state, batch) for batch in it]
        if evals:
            keys = evals[0].keys()
            last_metrics.update(
                {f"eval_{k}": sum(float(e[k]) for e in evals) / len(evals) for k in keys}
            )
    logger.info("train_eval took %.1fs", time.perf_counter() - t0)
    return trainer_state, last_metrics
