"""Trainer adapters of the kind ``offline_q``: ``<name>.py`` builds the
program's trainer for a configuration whose ``adapter`` is ``<name>``.

An adapter module exposes ``Program(cfg, traffic, table, weights, device,
precision)`` with:

- ``state``: the trainer's state, built from the given weights;
- ``run_fn(num_steps)``: the program's own loop entry, ``(state, generator)
  -> (state, metrics)`` with ``metrics["td_loss"]`` stacked per step;
- ``first_moments(state)`` and ``online_target(state)``: copies of the
  state's Adam first moment and of its online and target weights, as named
  leaves ``layer<i>.weight`` / ``layer<i>.bias`` shaped as the reference
  holds them.

``precision`` is the configuration's ``precision`` or its ``control``.
"""
