from reagent_tpu_torch.gym.runners.gymrunner import (
    Trajectory,
    evaluate_for_n_episodes,
    run_episode,
)

__all__ = ["Trajectory", "evaluate_for_n_episodes", "run_episode"]
