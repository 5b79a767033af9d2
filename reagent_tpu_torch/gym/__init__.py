"""Online RL on functional environments: envs, policies, the online loops.

Port of the online-DQN part of ``reagent_tpu/gym/``: the functional CartPole,
the softmax and greedy samplers, the DQN scorer, the discrete-DQN batch
maker, the generic actor-learner loop (``online_loop.py``) and the fused
noise-tape loop (``fused_dqn_loop.py``).  ``ROADMAP.md`` lists the rest.
"""
