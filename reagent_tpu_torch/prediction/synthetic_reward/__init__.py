from reagent_tpu_torch.prediction.synthetic_reward.synthetic_reward_predictor_wrapper import (
    SyntheticRewardPredictorWrapper,
    split_features,
)

__all__ = ["SyntheticRewardPredictorWrapper", "split_features"]
