"""Online RL on functional environments: envs, policies, the online loops.

Port of ``reagent_tpu/gym/``: every env of the JAX union (``envs/``), the
samplers, scorers and random policies, the batch makers, the generic
actor-learner loop (``online_loop.py``), the fused noise-tape loop
(``fused_dqn_loop.py``), the padded-episode collection of the
policy-gradient trainers (``episodic.py``), and the host side: the
``Agent``, the episode runners, the datasets and the gym utils.
"""
