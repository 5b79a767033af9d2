from reagent_tpu_torch.model_managers import discrete, discrete_dqn  # noqa: F401 — registers managers
