from reagent_tpu_torch.model_managers import (  # noqa: F401 — registers managers
    actor_critic,
    discrete,
    discrete_dqn,
)
