"""C51 net builder.

Port of ``reagent_tpu/net_builder/categorical_dqn.py`` (reference:
net_builder/categorical_dqn/categorical.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import CATEGORICAL_DQN_NET_BUILDERS
from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
from reagent_tpu_torch.net_builder.base import state_dim_of


@CATEGORICAL_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class Categorical:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    num_atoms: int = 51
    qmin: float = -100.0
    qmax: float = 200.0

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        output_dim: int,
        state_dim: Optional[int] = None,
    ) -> CategoricalDQN:
        return CategoricalDQN(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=output_dim,
            num_atoms=self.num_atoms,
            qmin=self.qmin,
            qmax=self.qmax,
            sizes=list(self.sizes),
            activations=list(self.activations),
        )
