from reagent_tpu_torch.gym.agents.agent import Agent

__all__ = ["Agent"]
