from reagent_tpu_torch.net_builder import discrete_dqn, quantile_dqn  # noqa: F401 — registers builders
