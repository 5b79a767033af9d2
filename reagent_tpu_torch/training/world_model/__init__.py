"""World-model trainers (reference: reagent/training/world_model/).

Port of ``reagent_tpu/training/world_model/__init__.py``: the MDN-RNN
trainer, the Seq2Reward trainer and the compress-model trainer.
"""

from reagent_tpu_torch.training.world_model.mdnrnn_trainer import (
    MDNRNNTrainer,
    MDNRNNTrainerState,
)
from reagent_tpu_torch.training.world_model.seq2reward_trainer import (
    CompressModelTrainer,
    CompressModelTrainerState,
    Seq2RewardTrainer,
    Seq2RewardTrainerState,
)

__all__ = [
    "MDNRNNTrainer",
    "MDNRNNTrainerState",
    "Seq2RewardTrainer",
    "Seq2RewardTrainerState",
    "CompressModelTrainer",
    "CompressModelTrainerState",
]
