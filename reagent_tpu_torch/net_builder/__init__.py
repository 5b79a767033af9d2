from reagent_tpu_torch.net_builder import (  # noqa: F401 — registers builders
    categorical_dqn,
    continuous_actor,
    discrete_actor,
    discrete_dqn,
    parametric_dqn,
    quantile_dqn,
    slate_ranking,
    slate_reward,
    synthetic_reward,
    value,
)
