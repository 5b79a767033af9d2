"""The port's parallel package against the JAX package's single-device
steps: four gloo processes on the CPU (``tests/torch_parallel_worker.py``)
run the data-parallel step over two ranks (``tests/test_parallel.py``'s
case), ``host_shard_batch`` over two, the model-parallel step on a 2 x 2
(data, model) mesh (``tests/test_model_parallel.py``'s case: a 64 x 8 table,
32 rows a model rank), the fused trainer's data-parallel step, the ES worker
over two and the scaling sweep; the references run here in one process.

Tolerances, the JAX tests': the DP step's td_loss rtol 1e-5 and parameters
rtol 1e-5, atol 1e-6; the MP step's td_loss rtol 1e-5 and parameters rtol
1e-4, atol 1e-5 (the table's pools summed over two ranks in another
order).  The fused trainer and the ES worker repeat the one-process run
bit for bit (the same batch, or the same rewards, in the same order).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_parallel_worker as W
from reagent_tpu.core import types as jrlt
from reagent_tpu.core.parameters import RLParameters as JaxRL
from reagent_tpu.models import FullyConnectedDQN as JaxDQN
from reagent_tpu.models.embedding_bag import SparseDQN as JaxSparseDQN
from reagent_tpu.parallel.scaling import analytic_dp_allreduce_model as jax_analytic
from reagent_tpu.training import DQNTrainer as JaxDQNTrainer
from reagent_tpu_torch import parallel
from reagent_tpu_torch.core.parameters import EvolutionParameters
from reagent_tpu_torch.parallel import data_parallel
from reagent_tpu_torch.training.gradient_free import EsWorker, EvolutionPool
from reagent_tpu_torch.utils import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 4
DP = dict(rtol=1e-5, atol=1e-6)
MP = dict(rtol=1e-4, atol=1e-5)
TABLE_KEY = "sparse_dqn.concat.collection.bag_page.embedding"


class _JaxSparseQNet(nn.Module):
    """``tests/test_model_parallel.py``'s ``_SparseQNet``."""

    @nn.compact
    def __call__(self, obs, training: bool = False):
        dense, ids = obs[:, :4], obs[:, 4:].astype(jnp.int32)
        state = jrlt.FeatureData(float_features=dense, id_list_features={
            "page": jrlt.IdListFeature(ids=ids, mask=jnp.ones_like(ids, bool))})
        return JaxSparseDQN(state_dense_dim=4, action_dim=2, configs=(("page", W.TABLE, W.DIM),),
                            overarch_dims=[32])(state, training=training)


def jax_batch(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return jrlt.DiscreteDqnInput(
        state=jrlt.FeatureData(float_features=j["state"]),
        next_state=jrlt.FeatureData(float_features=j["next_state"]),
        action=j["action"], next_action=j["next_action"], reward=j["reward"],
        time_diff=j["time_diff"], step=j["step"], not_terminal=j["not_terminal"],
        possible_actions_mask=j["possible_actions_mask"],
        possible_next_actions_mask=j["possible_next_actions_mask"])


def host(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def jax_dqn():
    q_net = JaxDQN(state_dim=4, action_dim=2, sizes=[16], activations=["relu"])
    trainer = JaxDQNTrainer(q_network=q_net, rl=JaxRL(gamma=0.9), optimizer={"SGD": {"lr": 0.1}})
    return trainer, trainer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))


def jax_sparse():
    trainer = JaxDQNTrainer(q_network=_JaxSparseQNet(),
                            rl=JaxRL(gamma=0.99, target_update_rate=0.5),
                            optimizer={"Adam": {"lr": 0.01}})
    proto = jnp.asarray(W.sparse_arrays(1)["state"])
    return trainer, trainer.init(jax.random.PRNGKey(0), proto)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the four ranks once; ``load(case, rank)`` reads what a rank
    wrote."""
    in_dir, out_dir = tmp_path_factory.mktemp("in"), tmp_path_factory.mktemp("out")
    _, dp_state = jax_dqn()
    _, mp_state = jax_sparse()
    inputs = {f"dp.{k}": v.numpy() for k, v in interop.q_network_state_from_flax(
        host(dp_state.q_params)).items()}
    inputs.update({f"mp.{k}": v.numpy() for k, v in interop.sparse_dqn_state_from_flax(
        host(mp_state.q_params)).items()})
    np.savez(in_dir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), port, str(in_dir),
                               str(out_dir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return lambda case, rank: dict(np.load(out_dir / f"{case}_{rank}.npz"))


def test_data_parallel_step_matches_jax_single_device(runs):
    """Two ranks, each with half of the 64 rows, against JAX's one step on
    all of them; rank 1 started from zeros and ``replicate`` gave it rank 0's
    state."""
    trainer, state = jax_dqn()
    ref, m = trainer.train_step(state, jax_batch(W.dqn_arrays()))
    want = interop.q_network_state_from_flax(host(ref.q_params))
    for rank in range(2):
        got = runs("dp", rank)
        np.testing.assert_allclose(got["td_loss"], float(m["td_loss"]), rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), **DP)


def test_host_shard_batch_three_steps_match_one_process(runs):
    """Each of two ranks passes its own 32 rows to ``host_shard_batch``; 3
    Adam steps equal one process's on the 64 rows.  Unequal row counts raise
    ``ValueError`` on both ranks."""
    trainer = W.dqn_trainer({"Adam": {"lr": 0.01}})
    trainer.q_network.load_state_dict(interop.q_network_state_from_flax(
        host(jax_dqn()[1].q_params)))
    state = trainer.state_from_q_network()
    batch = W.dqn_input(W.dqn_arrays())
    losses = []
    for _ in range(3):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["td_loss"]))
    for rank in range(2):
        got = runs("host", rank)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in state.q_params.items():
            np.testing.assert_allclose(got[k], v.numpy(), **DP)
            for name in ("mu", "nu"):
                want = getattr(state.opt_state, name)[k].numpy()
                np.testing.assert_allclose(got[f"{name}.{k}"], want, rtol=1e-5,
                                           atol=1e-6 * np.abs(want).max())
        assert "each must pass as many" in str(got["unequal"])


def test_model_parallel_step_matches_jax_single_device(runs):
    """The 2 x 2 mesh: every table leaf (parameters, targets, Adam moments)
    holds 32 of the 64 rows on every rank; the td_loss, the dense parameters
    and the table reassembled from the model ranks' blocks, and their Adam
    moments (which a gradient scaled by the model size would scale: Adam's
    first step would not show it), equal JAX's single-device step."""
    trainer, state = jax_sparse()
    raw = getattr(type(trainer).train_step, "__wrapped__", type(trainer).train_step)
    ref, m = jax.jit(lambda s, b: raw(trainer, s, b))(state, jax_batch(W.sparse_arrays()))
    want = {k: v.numpy() for k, v in interop.sparse_dqn_state_from_flax(
        host(ref.q_params)).items()}
    moments = interop.opt_state_from_optax(host(ref.opt_state))
    for name in ("mu", "nu"):
        want.update({f"{name}.{k}": v.numpy() for k, v in getattr(moments, name).items()})
    got = [runs("mp", rank) for rank in range(WORLD)]
    for g in got:
        leaves = sorted(str(x) for x in g["table_leaves"])
        assert leaves == sorted(f"{f}.{TABLE_KEY}" for f in (
            "q_params", "q_target_params", "opt_state.mu", "opt_state.nu")), leaves
        assert (g["table_rows"] == W.TABLE // 2).all()
        assert g[TABLE_KEY].shape == (W.TABLE // 2, W.DIM)
        np.testing.assert_allclose(g["td_loss"], float(m["td_loss"]), rtol=1e-5)
        for k, v in want.items():
            if not k.endswith(TABLE_KEY):
                np.testing.assert_allclose(g[k], v, rtol=MP["rtol"],
                                           atol=MP["atol"] * max(1.0, np.abs(v).max()))
    for data in range(2):
        for key in (TABLE_KEY, f"mu.{TABLE_KEY}", f"nu.{TABLE_KEY}"):
            blocks = sorted((int(g["model"]), g[key]) for g in got if int(g["data"]) == data)
            assert [b[0] for b in blocks] == [0, 1]
            whole = np.concatenate([b[1] for b in blocks])
            # the moments at the parameters' tolerance, scaled to their size
            np.testing.assert_allclose(whole, want[key], rtol=MP["rtol"],
                                       atol=MP["atol"] * max(1.0, np.abs(want[key]).max()))


def test_fused_data_parallel_step_repeats_one_process(runs):
    """``FusedDQNTrainer`` has no gradient to reduce: its step gathers the
    rows and runs the whole update on each rank, bit for bit the one-process
    update (JAX's DP step of the fused trainer gives its single-device one)."""
    trainer = W.fused_trainer()
    trainer.q_network.load_state_dict(interop.q_network_state_from_flax(
        host(jax_dqn()[1].q_params)))
    state, m = trainer.train_step(trainer.state_from_q_network(), W.dqn_input(W.dqn_arrays()))
    for rank in range(2):
        got = runs("fused", rank)
        np.testing.assert_array_equal(got["td_loss"], m["td_loss"].numpy())
        for i, p in enumerate(state.params8()):
            np.testing.assert_array_equal(got[f"p{i}"], p.numpy())


def test_es_worker_over_two_processes_repeats_the_local_pool(runs):
    """Each rank evaluates 4 of the 8 children and gathers the rewards in
    rank order: the mean rewards and the parent of the local worker, bit
    for bit, on both ranks."""
    es = EvolutionParameters(**W.ES)
    worker = EsWorker(EvolutionPool(0, es, W.ES_SIZES, device="cpu"), es)
    means = [worker.run_epoch(W.es_reward, it) for it in range(3)]
    for rank in range(2):
        got = runs("es", rank)
        np.testing.assert_array_equal(got["means"], means)
        for k, v in worker.pool.parent_tensors.items():
            np.testing.assert_array_equal(got[k], v.numpy())


def test_scaling_sweep_over_one_two_and_four_ranks(runs):
    """Rank 0 times every count; rank 3 joins only the four-rank mesh.  The
    rates are CPU rates of gloo processes, checked for structure only."""
    first, last = runs("scaling", 0), runs("scaling", 3)
    assert first["counts"].tolist() == [1, 2, 4] and last["counts"].tolist() == [4]
    assert (first["rates"] > 0).all()
    assert first["rates"][0, 2] == 1.0


# ----------------------------------------------------- one process, no group


def test_embedding_specs_only_tables_sharded():
    """The parameters', the targets' and both Adam moments' tables, and
    nothing else, are row-sharded over the model axis."""
    specs = parallel.embedding_specs(W.sparse_trainer().state_from_q_network())
    flat = {}

    def walk(node, path=()):
        if isinstance(node, tuple) and (not node or node[0] in ("model", None)):
            flat[".".join(path)] = node
        elif hasattr(node, "__dataclass_fields__"):
            for f in node.__dataclass_fields__:
                walk(getattr(node, f), path + (f,))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))

    walk(specs)
    sharded = {k for k, s in flat.items() if s}
    assert sharded == {f"{f}.{TABLE_KEY}" for f in (
        "q_params", "q_target_params", "opt_state.mu", "opt_state.nu")}
    assert all(flat[k] == ("model", None) for k in sharded)


def test_analytic_model_keeps_jax_formula_with_a_given_rate():
    counts = [1, 2, 8, 16, 64]
    got = parallel.analytic_dp_allreduce_model(36e3, 1e-3, counts, link_bytes_per_s=9e10,
                                               hop_latency_s=1e-6)
    want = jax_analytic(36e3, 1e-3, counts, ici_bytes_per_s=9e10, hop_latency_s=1e-6)
    assert got.keys() == want.keys()
    for n in counts:
        for k in want[n]:
            assert got[n][k] == pytest.approx(want[n][k], rel=1e-12)
    with pytest.raises(TypeError):
        parallel.analytic_dp_allreduce_model(36e3, 1e-3, counts)


def test_mesh_and_shard_errors():
    with pytest.raises(ValueError, match="not divisible"):
        parallel.make_2d_mesh(n_devices=3, data_parallel=2)
    mesh = data_parallel.Mesh(("data",), (2,), 0, {"data": 0}, {}, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        parallel.shard_batch({"x": torch.zeros(3, 2)}, mesh)
    half = parallel.shard_batch({"x": torch.arange(8.0).reshape(4, 2), "s": torch.tensor(1.0)},
                                mesh)
    assert half["x"].tolist() == [[0.0, 1.0], [2.0, 3.0]] and float(half["s"]) == 1.0
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="initialised default process group"):
            parallel.make_mesh(1, device="cpu")
