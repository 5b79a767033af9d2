from reagent_tpu_torch.prediction.cfeval.predictor_wrapper import (
    BanditRewardNetPredictorWrapper,
)

__all__ = ["BanditRewardNetPredictorWrapper"]
