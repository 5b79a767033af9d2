"""Standalone off-policy-evaluation research library.

Port of ``reagent_tpu/ope/`` (reference: reagent/ope/): contextual-bandit
estimators (DM/IPS/DR/Switch/SwitchDR), sequential estimators (DM/IPS/DR/
MAGIC/NeuralDualDICE), slate estimators (PBM/IPS/pseudo-inverse), tabular,
linear and neural reward-model trainers, and benchmark harnesses.  The
estimators are the JAX package's numpy, copied; the nets (``NNTrainer``,
``NeuralDualDICE``, the CartPole harness's Q-network) train and score in
torch, their dense float32 forwards one K3 launch on a CUDA tensor.
Nothing here imports sklearn or pandas at import time.
"""
