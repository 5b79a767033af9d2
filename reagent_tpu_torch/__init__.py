"""PyTorch/CUDA port of ``reagent_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference.  It
imports ``torch`` and never JAX or anything of ``reagent_tpu``.  It holds
the offline DQN workflow through the fused DQN update kernels
(``ops/csrc/fused_dqn.cu``) and online DQN on the functional CartPole
(``gym/``, ``replay/``) through the same update, the fused MLP forward
(``ops/csrc/fused_mlp.cu``) and the n-step replay kernel
(``ops/csrc/nstep_replay.cu``); ``ROADMAP.md`` lists what is still to port.
"""
