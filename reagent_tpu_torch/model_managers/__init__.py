from reagent_tpu_torch.model_managers import discrete_dqn  # noqa: F401 — registers managers
