"""PyTorch/CUDA port of ``reagent_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference.  It
imports ``torch`` and never JAX or anything of ``reagent_tpu``.  This slice
holds the offline DQN workflow through the fused DQN update kernels
(``ops/csrc/fused_dqn.cu``); ``ROADMAP.md`` lists what is still to port.
"""
