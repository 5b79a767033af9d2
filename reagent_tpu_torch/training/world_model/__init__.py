"""World-model trainers (reference: reagent/training/world_model/).

Port of ``reagent_tpu/training/world_model/__init__.py`` for the MDN-RNN
trainer; seq2reward and the compress model wait for ROADMAP.md §1 item 11.
"""

from reagent_tpu_torch.training.world_model.mdnrnn_trainer import (
    MDNRNNTrainer,
    MDNRNNTrainerState,
)

__all__ = ["MDNRNNTrainer", "MDNRNNTrainerState"]
