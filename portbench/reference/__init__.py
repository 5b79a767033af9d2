"""Plain float32 PyTorch references, written from the algorithms' equations.

Each module ``<name>.py`` exposes ``follow(cfg, table, weights, sampler_seed,
minibatch, steps, device)``: it draws the minibatch indices again from the
sampler's seed, gathers the rows, and runs ``steps`` updates from the given
weights (``common.follow_steps`` says what it returns).  Nothing here
imports ``reagent_tpu_torch`` or JAX; the products run with TF32 off.
"""
