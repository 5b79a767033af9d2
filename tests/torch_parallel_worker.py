"""A rank of the port's parallel package on the gloo backend, for
``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RANK WORLD PORT IN_DIR OUT_DIR

Every rank joins one default process group of WORLD processes on the CPU
and runs each case in turn (all ranks build every mesh: ``new_group`` is
collective), writing what it holds to ``OUT_DIR/<case>_<rank>.npz``:

- ``dp``: ``make_data_parallel_train_step`` of ``DQNTrainer`` over the
  first 2 ranks (rank 1 starts from zeros; ``replicate`` gives it rank 0's
  state), one step on ``tests/test_parallel.py``'s batch;
- ``host``: ``host_shard_batch`` over the first 2 ranks, each passing its
  own half of the rows, 3 Adam steps; then rows of unequal counts;
- ``mp``: ``make_model_parallel_train_step`` on a 2 x 2 (data, model) mesh
  of ``tests/test_model_parallel.py``'s sparse DQN;
- ``fused``: the data-parallel step of ``FusedDQNTrainer`` (K2's plain
  version on the CPU) over the first 2 ranks;
- ``es``: ``EsWorker.run_epoch`` over the first 2 ranks, 3 epochs;
- ``scaling``: ``measure_scaling_efficiency`` at 1, 2 and 4 ranks.

The shared inputs (batches, modules) are the functions below; the test
imports them for its single-process references.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from reagent_tpu_torch.core import types as rlt
from reagent_tpu_torch.core.parameters import EvolutionParameters, RLParameters
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.embedding_bag import SparseDQN

TABLE, DIM, MP_B = 64, 8, 16
ES = dict(population_size=8, mutation_power=0.3, learning_rate=0.05)
ES_SIZES = {"w": [3], "m": [2, 4]}


def dqn_arrays(B: int = 64):
    """``tests/test_parallel.py``'s ``_batch(B)``, numpy."""
    rng = np.random.default_rng(0)
    return dict(state=rng.normal(size=(B, 4)).astype(np.float32),
                next_state=rng.normal(size=(B, 4)).astype(np.float32),
                action=np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)],
                next_action=np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)],
                reward=rng.normal(size=(B, 1)).astype(np.float32),
                time_diff=np.ones((B, 1), np.float32), step=np.ones((B, 1), np.int32),
                not_terminal=np.zeros((B, 1), np.float32),
                possible_actions_mask=np.ones((B, 2), np.float32),
                possible_next_actions_mask=np.ones((B, 2), np.float32))


def sparse_arrays(B: int = MP_B):
    """``tests/test_model_parallel.py``'s ``_make_batch(B)``, numpy: the
    observations are [4 dense, 5 ids] (state and next state alike)."""

    def proto():
        rng = np.random.default_rng(0)
        dense = rng.normal(size=(B, 4)).astype(np.float32)
        ids = rng.integers(0, TABLE, (B, 5)).astype(np.float32)
        return np.concatenate([dense, ids], axis=1)

    rng = np.random.default_rng(1)
    act = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    return dict(state=proto(), next_state=proto(), action=act, next_action=act,
                reward=rng.normal(size=(B, 1)).astype(np.float32),
                time_diff=np.ones((B, 1), np.float32), step=np.ones((B, 1), np.int32),
                not_terminal=np.ones((B, 1), np.float32),
                possible_actions_mask=np.ones((B, 2), np.float32),
                possible_next_actions_mask=np.ones((B, 2), np.float32))


def dqn_input(a) -> rlt.DiscreteDqnInput:
    t = torch.as_tensor
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(float_features=t(a["state"])),
        next_state=rlt.FeatureData(float_features=t(a["next_state"])),
        reward=t(a["reward"]), time_diff=t(a["time_diff"]), step=t(a["step"]),
        not_terminal=t(a["not_terminal"]), action=t(a["action"]),
        next_action=t(a["next_action"]), possible_actions_mask=t(a["possible_actions_mask"]),
        possible_next_actions_mask=t(a["possible_next_actions_mask"]))


class SparseQNet(nn.Module):
    """``tests/test_model_parallel.py``'s ``_SparseQNet`` on the port: flat
    observations [4 dense, 5 ids] -> ``SparseDQN`` (table 64 x 8, overarch
    32); its flax scope ``SparseDQN_0`` is the port's ``sparse_dqn``."""

    def __init__(self):
        super().__init__()
        self.sparse_dqn = SparseDQN(state_dense_dim=4, action_dim=2,
                                    configs=(("page", TABLE, DIM),), overarch_dims=[32])

    def reset_parameters(self, generator):
        self.sparse_dqn.reset_parameters(generator)

    def forward(self, obs, training: bool = False):
        ids = obs[:, 4:].to(torch.int64)
        state = rlt.FeatureData(float_features=obs[:, :4], id_list_features={
            "page": rlt.IdListFeature(ids=ids, mask=torch.ones_like(ids, dtype=torch.bool))})
        return self.sparse_dqn(state, training=training)


def dqn_trainer(optimizer):
    from reagent_tpu_torch.training import DQNTrainer

    return DQNTrainer(q_network=FullyConnectedDQN(4, 2, [16], ["relu"]),
                      rl=RLParameters(gamma=0.9), optimizer=optimizer, device="cpu")


def sparse_trainer():
    from reagent_tpu_torch.training import DQNTrainer

    return DQNTrainer(q_network=SparseQNet(), rl=RLParameters(gamma=0.99, target_update_rate=0.5),
                      optimizer={"Adam": {"lr": 0.01}}, device="cpu")


def fused_trainer(B: int = 64):
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    return FusedDQNTrainer(FullyConnectedDQN(4, 2, [16], ["relu"]), rl=RLParameters(gamma=0.9),
                           optimizer={"Adam": {"lr": 0.01}}, minibatch_size=B, device="cpu")


def es_reward(ind):
    return -torch.sum((ind["w"] - 1.0) ** 2) - torch.sum(ind["m"] ** 2)


def _np(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def main(rank: int, world: int, port: str, in_dir: str, out_dir: str) -> None:
    from reagent_tpu_torch import parallel
    from reagent_tpu_torch.parallel import model_parallel
    from reagent_tpu_torch.training.gradient_free import EsWorker, EvolutionPool

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    inputs = np.load(os.path.join(in_dir, "inputs.npz"))

    def save(case, **arrays):
        np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **arrays)

    def weights(prefix):
        return {k[len(prefix):]: torch.tensor(v) for k, v in inputs.items()
                if k.startswith(prefix)}

    # dp: one SGD step over 2 ranks; rank 1's own state is zeros
    mesh = parallel.make_mesh(n_devices=2, device="cpu")
    if mesh.contains_rank:
        trainer = dqn_trainer({"SGD": {"lr": 0.1}})
        trainer.q_network.load_state_dict(weights("dp."))
        state = trainer.state_from_q_network()
        if rank:
            state = parallel.data_parallel.map_leaves(lambda x, _: torch.zeros_like(x), state)
        state = parallel.replicate(state, mesh)
        step = parallel.make_data_parallel_train_step(trainer, mesh)
        state, m = step(state, parallel.shard_batch(dqn_input(dqn_arrays()), mesh))
        save("dp", td_loss=m["td_loss"].numpy(), **_np(state.q_params))

    # host: each rank loads its own rows, 3 Adam steps; then unequal rows
    mesh = parallel.make_mesh(n_devices=2, device="cpu")
    if mesh.contains_rank:
        trainer = dqn_trainer({"Adam": {"lr": 0.01}})
        trainer.q_network.load_state_dict(weights("dp."))
        state = parallel.replicate(trainer.state_from_q_network(), mesh)
        whole = dqn_arrays()
        local = {k: v[rank * 32:(rank + 1) * 32] for k, v in whole.items()}
        batch = dqn_input(parallel.host_shard_batch(local, mesh))
        step = parallel.make_data_parallel_train_step(trainer, mesh)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["td_loss"]))
        try:
            parallel.host_shard_batch({"x": np.zeros((4 + rank, 2))}, mesh)
            unequal = "accepted"
        except ValueError as e:
            unequal = str(e)
        save("host", losses=np.array(losses), unequal=np.array(unequal), **_np(state.q_params),
             **_moments(state.opt_state))

    # mp: a 2 x 2 (data, model) mesh over all 4 ranks
    mesh = model_parallel.make_2d_mesh(n_devices=4, data_parallel=2, device="cpu")
    trainer = sparse_trainer()
    trainer.q_network.load_state_dict(weights("mp."))
    state = parallel.shard_state(trainer.state_from_q_network(), mesh)
    rows = {".".join(p): x.shape[0] for x, p in _with_paths(state)
            if "embedding" in ".".join(p).split(".")}
    step = parallel.make_model_parallel_train_step(trainer, mesh)
    state, m = step(state, parallel.shard_batch(dqn_input(sparse_arrays()), mesh))
    save("mp", td_loss=m["td_loss"].numpy(), data=np.array(mesh.axis_index("data")),
         model=np.array(mesh.axis_index("model")),
         table_rows=np.array(list(rows.values())), table_leaves=np.array(list(rows)),
         **_np(state.q_params), **_moments(state.opt_state))

    # fused: K2's plain version on the whole batch, all-gathered over 2 ranks
    mesh = parallel.make_mesh(n_devices=2, device="cpu")
    if mesh.contains_rank:
        trainer = fused_trainer()
        trainer.q_network.load_state_dict(weights("dp."))
        state = parallel.replicate(trainer.state_from_q_network(), mesh)
        step = parallel.make_data_parallel_train_step(trainer, mesh)
        state, m = step(state, parallel.shard_batch(dqn_input(dqn_arrays()), mesh))
        save("fused", td_loss=m["td_loss"].numpy(),
             **{f"p{i}": p.numpy() for i, p in enumerate(state.params8())})

    # es: the population split over 2 ranks
    mesh = parallel.make_mesh(n_devices=2, device="cpu")
    if mesh.contains_rank:
        es = EvolutionParameters(**ES)
        worker = EsWorker(EvolutionPool(0, es, ES_SIZES, device="cpu"), es, mesh.groups["data"])
        means = [worker.run_epoch(es_reward, it) for it in range(3)]
        save("es", means=np.array(means), **_np(worker.pool.parent_tensors))

    # scaling: the DP step at 1, 2 and 4 ranks
    trainer = dqn_trainer({"Adam": {"lr": 0.001}})
    res = parallel.measure_scaling_efficiency(
        trainer, trainer.state_from_q_network(),
        lambda n: dqn_input(dqn_arrays(32 * n)), device_counts=[1, 2, 4], num_steps=3,
        device="cpu")
    save("scaling", counts=np.array(sorted(res)),
         rates=np.array([[res[n][k] for k in ("steps_per_s", "samples_per_s", "efficiency")]
                         for n in sorted(res)]))
    dist.barrier()
    dist.destroy_process_group()


def _moments(opt_state):
    """Adam's moments by ``mu.<name>`` and ``nu.<name>``: a gradient scaled
    by a constant moves Adam's step little, its moments by that constant."""
    return {f"{m}.{k}": v.numpy() for m in ("mu", "nu")
            for k, v in getattr(opt_state, m).items()}


def _with_paths(state):
    from reagent_tpu_torch.parallel.data_parallel import map_leaves

    out = []
    map_leaves(lambda x, p: out.append((x, p)), state)
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
