"""TensorBoard logger collecting line plots for training reports.

Port of ``reagent_tpu/core/oss_tensorboard_logger.py`` (reference
reagent/core/oss_tensorboard_logger.py), a copy: a Lightning-style logger
that both writes TB events (through tensorboardX where it imports) and
accumulates (key -> [(x, y)]) line series returned in
``RLTrainingOutput.logger_data``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class OssTensorboardLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self._writer = None
        if log_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(log_dir)
            except ImportError:
                pass
        self.line_plot_buffer: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for key, value in metrics.items():
            v = float(value)
            self.line_plot_buffer[key].append((float(step), v))
            if self._writer is not None:
                self._writer.add_scalar(key, v, global_step=step)

    def get_logger_data(self) -> Dict[str, List[Tuple[float, float]]]:
        return dict(self.line_plot_buffer)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
