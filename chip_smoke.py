#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reagent_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from reagent_tpu_torch/ops/csrc (nvcc, sm_90a);
  3. K1 (offline fused DQN update) against its plain PyTorch version at full
     width, double-Q and single-Q, 5 lockstep updates;
  4. K2 (fused DQN update, one launch per update) the same, at the CartPole
     sample config's shapes, and at the full offline width, which exceeds a
     block's shared memory and takes K2's launch sequence; each route's
     CUDA kernels per update checked (1; 3L + 1 = 10 on the sequence);
  5. CUDA-event timing of each kernel (K2 on both routes) and its plain
     version, beside the bound and K1's products through torch.matmul (a
     yardstick only), and each update's device time by CUDA kernel
     (torch.profiler);
  6. the offline workflow (identify_and_train_network) at full width through
     K1 (8 updates: 8,192 rows, 4 epochs), with the exported artifact scored
     against the in-process module and the host's batch preprocessing timed
     beside the train step;
  7. the workflow at the sample config's shapes through K2;
  8. K2's packed interface (one launch), K3 (fused MLP forward) and K4
     (n-step replay rewards) against their plain versions at the online
     path's shapes;
  9. CUDA-event timing of those three and their plain versions, beside the
     bound and the queued launch floor (an empty kernel's time), K2's, K3's
     and K4's wrapper host time per call at the main path's shapes, K3's
     forward as one torch.addmm per layer (a yardstick only) and K2-packed's
     device time by CUDA kernel;
 10. the fused online DQN loop at bench.py's width (CartPole, 4-128-64-2,
     minibatch 512, packed replay of 100,000): prefill 1,000, a 32-step
     lockstep check against the plain versions on the CPU, then 1,500 steps
     through K2-packed and K3;
 11. the generic online loop (ReplayBuffer of 50,000, softmax acting through
     the K3 scorer, tensor K2, K4 in every sample) for 500 steps, then
     evaluate_policy over 20 greedy episodes through K3;
 12. K5 (pairwise quantile-Huber loss) against its plain versions at
     [4096, 51], [8192, 201], [512, 11], in bfloat16 and on inputs built to
     hit ties: each route of the forward (loss only; loss and gradient
     sums), the backward kernel that scales the sums, and the two under
     autograd;
 13. CUDA-event timing of K5's two forward routes, its backward and the
     trainer's pair (forward with sums, then backward), and of the plain
     versions, at the three shapes, beside the bound;
 14. the offline QR-DQN workflow at full width (D=128, 512, 256, A=8, 51
     atoms, minibatch 4096, 8 updates as phase 6) through K5, the artifact
     scored against the
     in-process module and against the trainer's q_values (K3), and a train
     step's time by CUDA kernel and host operator (torch.profiler);
 15. 5 QR-DQN train steps at that width on the card (K5) against 5 on the
     CPU (the plain version) from one state and the same batches;
 16. the online QR-DQN loop (dueling 64, 64 with 11 atoms, ReplayBuffer of
     50,000, minibatch 512) for 300 steps through K4 and K5, then
     evaluate_policy over 20 greedy episodes and a profiled window;
 17. K1 with its bfloat16 options against its plain version at full width,
     double-Q and single-Q, 5 updates each compared from one state, for
     (matmul, save) = (bf16, bf16) and (f32, bf16), each update's CUDA
     kernels counted (3L + 2 with bf16 products, 3L + 1 without);
 18. CUDA-event timing of K1-bf16, the f32 K1 and the plain bf16 version,
     beside the bound at the tensor cores' bf16 rate and K1-bf16's products
     through torch.matmul on bf16 operands (a yardstick only);
 19. the device-resident fused loop at bench.py's width: a 100,000-row table
     on the card, FusedDQNTrainer(minibatch 4096, block 1024, matmul_dtype
     bfloat16), make_packed_sampled_train_fn for 200 and 1,000 steps, a
     profiled window (device time by CUDA kernel, idle share, host reads),
     then its f32 twin, 5 steps on the card against 5 on the CPU from one
     state and the same indices, and q_values on 64 rows through K3;
 20. the unfused scan path: make_sampled_train_fn(DQNTrainer, ...) on the
     same table with compute_dtype float32 and bfloat16, 200 steps each;
 21. K3 against its plain version at the evaluation's shapes, a batch of
     512 rows of the sample config's net (resident route) and 4,096 rows of
     the full-width net (streamed), timed beside one torch.addmm per layer
     (a yardstick only) and the bound;
 22. the flagship sample config unchanged (4->128->64->2 leaky_relu,
     minibatch 512, Adam lr 0.01, gamma 0.99, tau 0.2, double-Q, CPE on, 20
     epochs, 90/10 split) through identify_and_train_network on a 4,096-row
     table with uniform(0, 1) rewards: the unfused DQNTrainer with its
     reward and CPE Q heads, then the eval split's page through K3 (three
     launches a batch) and DM, IPS, DR, seq-DR, WDR and MAGIC on the card;
     train steps/s, eval_seconds and the evaluation taken apart (host
     decode, the forwards, the page, each estimator), the estimates;
 23. the same at the full offline width (D=128, 512, 256, A=8, CPE heads
     as wide, minibatch 4096, 8,192 rows, 4 epochs);
 24. CPE card against CPU: 5 train steps with the CPE heads at full width
     from one state on the same batches, then the page and every estimate
     of phases 22 and 23's trained states on both, np.random seeded alike;
 25. the reference's dqn_cartpole_e2e job through the four functions reagent
     run calls, with the arguments it builds from the sample config and the
     job's overrides: 12,000 random CartPole transitions (gymnasium where it
     imports, else the port's functional CartPole on the host), the timeline
     operator, the sample config unchanged (20 epochs, CPE on) with the
     DiscreteDQNReporter writing to a recording summary writer (its tags
     checked), K3 three launches an eval batch, the artifact against the
     in-process module, device-to-host copies a step with and without the
     reporter (torch.profiler), then 20 greedy episodes of at most 200 steps
     through load_predictor against the 120 bar;
 26. warm start and reward options at full width: identify_and_train_network
     twice through K1 (8 updates a run) with a warm-start checkpoint and
     metric-weighted rewards (the saved step doubles, each run's final state
     restored bit for bit on the card, K1 launched 16 times), then phase
     24's DQNTrainerState with its five CPE fields saved and restored on the
     card;
 27. SAC and TD3 card against CPU: the sample config's SAC trainer (twin Q,
     autotuned temperature, actor and critics 64, 64 leaky_relu, minibatch
     1,024, Adam 1e-3, gamma 0.9, tau 0.5) for 5 train steps and its TD3
     twin for 4 (two delayed actor updates), from one state with the same
     batches and the same explicit noise; every metric and every state
     tensor compared, no K1-K5 launch;
 28. the reference's sac_pendulum_e2e job through the port's reagent run
     and sac_pendulum_offline.yaml (widths, minibatch, optimizers, gamma,
     tau, seed and bar unchanged; num_epochs, num_train_transitions,
     num_eval_episodes and max_steps cut to SAC_JOB_CUT): random Pendulum
     rows (gymnasium where it imports, else the port's functional Pendulum
     on the host), the timeline operator, SAC with the ActorCriticReporter,
     the actor artifact (model_type "actor", actions in [-2, 2], against
     the in-process module), then train steps/s, the host's decode against
     a train step, CUDA kernels a step and the device's idle share (a
     profiled window), device-to-host copies a step with and without the
     reporter, the greedy episodes' seconds and mean reward (the -1000 bar
     printed, not held at the cut depth);
 29. discrete CRR card against CPU: 5 train steps at the online config's
     widths (actor and q1 128, 64 leaky_relu, minibatch 256, gamma 0.99,
     tau 0.2, Adam 3e-3, beta 1) from one state on the same batches, every
     metric and state tensor compared, no K1-K5 launch;
 30. the offline CRR job (tests/test_offline_managers.py's flow): 10,000
     random CartPole transitions, the timeline with a 95/5 split,
     identify_and_train_network with the DiscreteCRR block (64, 64 relu
     actor and twin critics, Adam 3e-3, gamma 0.99, tau 0.1, beta 1) for
     CRR_OFFLINE["epochs"] epochs, the actor artifact against the
     in-process actor (and actor_logits through K3) on 64 raw rows, train
     steps/s, the host's decode, CUDA kernels a step and the idle share, 20
     greedy episodes through load_predictor (the 100 bar read at 20 epochs
     only);
 31. online discrete CRR through the generic loop (ReplayBuffer of 50,000,
     prefill 3,000, minibatch 256, the actor acting through K3, K4 in every
     sample) for CRR_ONLINE["steps"] steps, a profiled window (kernels a
     step, idle share, host reads), evaluate_policy of the actor;
 32. REINFORCE (64, 64 leaky_relu, Adam 5e-3, normalize, subtract_mean)
     and PPO (32, 32 leaky_relu, Adam 1e-3 with weight decay 1e-3, epsilon
     0.2, 1 epoch) on the functional CartPole with episodes padded to 200
     steps: 3 episodes each card against CPU from one noise tape (actions
     and returns exact), then PG_CONFIGS' episodes each: episodes/s, env
     steps/s, K3 launches an episode, a profiled episode (host reads: 0 or
     the script fails), evaluate_policy;
 33. C51 (128, 64 leaky_relu, 51 atoms on 0..200, minibatch 256, Adam
     3e-3, tau 0.2) and parametric DQN and SARSA (a critic 128, 64
     leaky_relu over state and one-hot action, minibatch 512, Adam 1e-3
     with amsgrad, tau 0.1): 5 train steps each at the online configs'
     widths card against CPU from one state, every metric and state tensor
     compared (phase 29's tolerances), no K1-K5 launch;
 34. K3 at those paths' four shapes (C51's act step [1, 4->128->64->102]
     and evaluate_policy [20, 4]; the parametric scorer's tiled rows [2,
     6->128->64->1] and [40, 6]), each on the resident route, and K4 at
     C51's minibatch of 256, against their plain versions and timed beside
     the launch floor and the bound;
 35. online C51, parametric DQN and parametric SARSA through the generic
     loop (ReplayBuffer of 50,000, prefill 1,000, 150 steps each; the
     reference's 3,000 / 10,000 and 15,000 / 20,000 in
     tools/dqn_family_jobs.py), K3 and K4 exactly once a step, a profiled
     window (kernels a step, idle share, host reads: 0 or the script
     fails), evaluate_policy over 20 greedy episodes through K3;
 36. the DiscreteC51DQN (64, 64 relu, 21 atoms, Adam 2e-3) and
     ParametricDQN (64, 64 relu, Adam 3e-3) managers through
     identify_and_train_network on random CartPole tables of 3,000 and
     10,000 transitions for 2 epochs each (the parametric test's 10 cut to
     2): train steps/s, td_loss, the C51 artifact against the in-process
     module and q_values (K3) on 64 raw rows within 1e-4, ParametricDQN's
     default_model "" (no artifact, as in JAX);
 37. one JSON line describing each ported kernel (K1's rows with the CUDA
     kernels per update, the products' yardstick and the kernel's own GEMM
     time; K2's rows with the CUDA kernels per update of each route and the
     wrapper's host time; K3's and K4's with the wrapper's host time, the
     launch floor and their other shapes, K3's with its torch.addmm
     yardstick and the evaluation's two shapes, K3's and K4's with their
     share of a step on the discrete-actor, C51 and parametric paths).
Each phase's heading carries the seconds since the script started.
Every path runs with the launch counts set to 0 just before it and read
just after; a path whose kernels did not launch once per step fails.
The last line is {"ok": true, "device": {...}}.  It needs no network, and it
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"

# Published peaks (NVIDIA data sheets): f32 outside the tensor cores, HBM
# rate, dense bf16 on the tensor cores.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12, 756e12),
    "H100": (67e12, 3.35e12, 989e12),  # SXM
}

FULL = dict(D=128, widths=[512, 256], A=8, B=4096, block=512, act="leaky_relu",
            gamma=0.99, tau=0.1, lr=1e-3)
CARTPOLE = dict(D=4, widths=[128, 64], A=2, B=512, block=None, act="leaky_relu",
                gamma=0.99, tau=0.2, lr=0.01)
# K2 at the full offline width: both nets' weights (1.6 MB) exceed a block's
# shared memory, so K2 takes its launch sequence instead of the one launch
K2_LARGE = dict(FULL, B=512, block=None)
ONE_LAUNCH = {True: 1, False: 1}       # CUDA kernels per K2 update, by double_q


def launch_sequence(n_layers, bf16_products=False):
    """CUDA kernels of one update on the launch sequence (K1, and K2 beyond
    a block's shared memory), double-Q or not: per layer one forward launch
    for every (net, input) pair and one weight-gradient launch (the bias
    gradient in extra blocks), dh past the first layer, the TD rows, one
    Adam, polyak and metrics launch; bf16 products add one launch that
    rounds the weights and observations to bf16 first."""
    return 3 * n_layers + 1 + int(bf16_products)


LAUNCH_SEQUENCE = {dq: launch_sequence(len(FULL["widths"]) + 1) for dq in (True, False)}
# bench.py's online_dqn runs 30,000 steps; cut to fit the time limit
FUSED_STEPS = 1500
GENERIC_STEPS = 500
# tests/test_gym_all_algos.py:98-115 prefills 20,000 and runs 30,000 steps; cut
# to fit the time limit
QR_ONLINE = dict(widths=[64, 64], act="leaky_relu", atoms=11, gamma=0.9, tau=0.05,
                 B=512, prefill=1000, steps=300)
# the offline workflows at full width: 8 updates of 4,096 rows from a table of
# 8,192 rows over 4 epochs (the host's feature identification, which takes
# most of such a phase, grows with the rows)
FULL_ROWS, FULL_EPOCHS = 8192, 4
QR_ATOMS = 51  # QuantileFullyConnected's default num_atoms
QR_OPTIMIZER = {"Adam": {"lr": 0.001, "amsgrad": True}}
K5_SHAPES = [(4096, 51), (8192, 201), (512, 11)]  # offline, the largest named, online
# K5's least FP32 instructions per (i, j) pair.  The loss alone: sub; m =
# min(|td|, kappa) (|td| an operand modifier); the Huber value m (|td| -
# 0.5 m) as an fma and a mul; the sign compare; the weight select; the fma
# into the sum.  With the gradient sums one more fma: clip(td) w = m sw,
# where the select picks the weight with td's sign, sw, and the loss's fma
# takes |sw| as an operand modifier.  Each takes one lane's issue slot, as an
# fma does, so the card issues them at half its peak FLOP/s: 33.5e12 a second
# on an H100 SXM (132 SMs x 128 lanes x 1.98 GHz), 2 FLOPs an instruction.
K5_LOSS_INSTR, K5_SUMS_INSTR = 7, 8
# bench.py:286-321, :395-412: the device-resident offline table and loops
TABLE_ROWS = 100_000
SCAN_BLOCK = 1024
SCAN_STEPS = (200, 1000)  # bench.py's two scan lengths
UNFUSED_STEPS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def phase(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"{msg}  [{time.perf_counter() - _START:.1f} s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks_for(name: str):
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peak rates recorded for {name!r}")


# ------------------------------------------------------------ kernel inputs


def make_inputs(cfg, seed, torch, device):
    """Batch and params8 from a numpy seed: ~20% of next actions impossible,
    ~10% terminals, nonzero Adam moments."""
    rng = np.random.default_rng(seed)
    D, A, B = cfg["D"], cfg["A"], cfg["B"]
    sizes = [D, *cfg["widths"], A]
    dims = list(zip(sizes[:-1], sizes[1:]))
    W = [(rng.normal(size=(o, i)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims]
    b = [(rng.normal(size=(1, o)) * 0.1).astype(np.float32) for _, o in dims]
    Wt = [(w + rng.normal(size=w.shape) * 0.02).astype(np.float32) for w in W]
    bt = [(x + rng.normal(size=x.shape) * 0.02).astype(np.float32) for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    params8 = W + b + Wt + bt + zeros + zeros
    act = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    mask = (rng.random((B, A)) > 0.2).astype(np.float32)
    mask[np.arange(B), rng.integers(0, A, B)] = 1.0  # at least one possible
    batch = [
        rng.normal(size=(B, D)).astype(np.float32),
        rng.normal(size=(B, D)).astype(np.float32),
        act,
        rng.normal(size=(B, 1)).astype(np.float32),
        (rng.random((B, 1)) > 0.1).astype(np.float32),
        mask,
    ]
    put = lambda a: torch.tensor(a, device=device)
    return dims, [put(x) for x in batch], [put(p) for p in params8]


def step_scalars(torch, step, lr, device, b1=0.9, b2=0.999, eps=1e-8):
    t = torch.tensor(float(step + 1), device=device)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    return (lr * torch.sqrt(bc2) / bc1).float(), (eps * torch.sqrt(bc2)).float()


def kernel_fns(cfg, double_q, dtypes=None):
    """(kernel wrapper, plain version, keyword arguments); ``dtypes`` =
    K1's (matmul_dtype, save_dtype)."""
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    acts = [cfg["act"]] * len(cfg["widths"]) + ["linear"]
    kw = dict(activations=acts, gamma=cfg["gamma"], tau=cfg["tau"],
              double_q_learning=double_q)
    if dtypes is not None:
        kw.update(matmul_dtype=dtypes[0], save_dtype=dtypes[1])
    if cfg["block"] is not None:
        kw["block_size"] = cfg["block"]
        return (fused_dqn_offline.fused_dqn_offline_update,
                fused_dqn_offline.fused_dqn_offline_update_reference, kw)
    return fused_dqn.fused_dqn_update, fused_dqn.fused_dqn_update_reference, kw


def compare_kernel(name, cfg, torch, kernels=None):
    """5 lockstep updates of the kernel and its plain version from one state,
    double-Q and single-Q.  Tolerances: float32 sums taken in another order,
    which Adam amplifies where |g| is small (td_loss/metrics rtol 2e-4,
    atol 2e-5; final params rtol 5e-4, atol 5e-5).  ``kernels``: the CUDA
    kernels per update the route must launch, by double_q."""
    worst = 0.0
    for double_q in (True, False):
        kern, plain, kw = kernel_fns(cfg, double_q)
        _, batch, p_kern = make_inputs(cfg, 1234, torch, DEVICE)
        p_plain = [p.clone() for p in p_kern]
        for step in range(5):
            lr_t, eps_t = step_scalars(torch, step, cfg["lr"], DEVICE)
            mk = kern(lr_t, eps_t, *batch, p_kern, **kw)
            if kernels is not None and kern.kernels_per_update != kernels[double_q]:
                raise AssertionError(f"{name} double_q={double_q} launched "
                                     f"{kern.kernels_per_update} CUDA kernels, not {kernels[double_q]}")
            mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
            diff = (mk - mp).abs().max().item()
            rel = ((mk - mp).abs() / mp.abs().clamp_min(1e-30)).max().item()
            log(f"  {name} double_q={double_q} step {step}: metrics "
                f"{mk.flatten().tolist()} max abs {diff:.3e} rel {rel:.3e}")
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst = max(worst, diff)
        for i, (a, b) in enumerate(zip(p_kern, p_plain)):
            d = (a - b).abs().max().item()
            r = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            worst = max(worst, d)
            if i % len(cfg["widths"] + [0]) == 0:
                log(f"  {name} double_q={double_q} params8[{i}] {tuple(a.shape)}: "
                    f"max abs {d:.3e} rel {r:.3e}")
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
    return worst


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, warmup=3, iters=20):
    """Median device time of one call: CUDA events around each call, all
    calls queued behind a GPU sleep so host work does not show as gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(2_000_000_000)  # ~1 s at H100 clocks: outlasts the host enqueue
    for s, e in events:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profiled_rows(prof, n):
    """(device rows, host rows) of a profiled window of ``n`` steps, each row
    (us per step, count per step, name), largest first.  Device rows are the
    CUDA kernels and copies themselves: an operator's row repeats the time of
    the kernels it launched, and counting both would count them twice."""
    from torch.autograd import DeviceType

    device_us, cpu_us = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            if dev > 0:
                device_us.append((dev / n, ev.count / n, ev.key))
        elif ev.self_cpu_time_total > 0:
            cpu_us.append((ev.self_cpu_time_total / n, ev.count / n, ev.key))
    return sorted(device_us, reverse=True), sorted(cpu_us, reverse=True)


def profile_update(cfg, torch, n=5, dtypes=None):
    """Device time of one update by CUDA kernel (torch.profiler over n
    updates, averaged); returns (total us, us in the GEMM kernels)."""
    kern, _, kw = kernel_fns(cfg, True, dtypes)
    _, batch, params = make_inputs(cfg, 5, torch, "cuda")
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    return profile_calls(torch, lambda: kern(lr_t, eps_t, *batch, params, **kw), n)


def profile_calls(torch, fn, n=5):
    """Device time of one call of ``fn`` by CUDA kernel (torch.profiler over
    n calls, averaged), one row per kernel; returns (total us, us in the
    kernels named *gemm*)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows, _ = profiled_rows(prof, n)
    total = sum(r[0] for r in rows)
    for us, count, key in rows:
        log(f"    {us:9.2f} us  x{count:<5.1f} {key[:90]}")
    gemm = sum(r[0] for r in rows if "gemm" in r[2])
    log(f"    {total:9.2f} us  device time per update (sum of kernels), "
        f"{gemm:.2f} us of it in GEMMs")
    return total, gemm


def roofline(flops, nbytes, name, tensor_cores=False):
    """The larger of the operations over the card's peak (f32 outside the
    tensor cores, or dense bf16 on them) and bytes over its memory rate, in
    ms, and which of the two it is."""
    peak_f32, peak_bw, peak_bf16 = peaks_for(name)
    peak_flops = peak_bf16 if tensor_cores else peak_f32
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def update_work(cfg, double_q):
    """One update's f32 operations and the parameter count P of one net."""
    B, D, A = cfg["B"], cfg["D"], cfg["A"]
    sizes = [D, *cfg["widths"], A]
    macs_layer = [i * o for i, o in zip(sizes[:-1], sizes[1:])]
    F = sum(macs_layer)
    n_fwd = 3 if double_q else 2
    flops = 2.0 * B * (n_fwd * F + F + (F - macs_layer[0]))
    return flops, F + sum(sizes[1:])


def bound(cfg, double_q, name, tensor_cores=False):
    """Least time for one update: the larger of its matmul operations over
    the card's peak (f32, or bf16 on the tensor cores) and its bytes (inputs
    read once, params8 read and written once, all float32 whatever the
    products' type) over the memory rate."""
    B, D, A = cfg["B"], cfg["D"], cfg["A"]
    flops, P = update_work(cfg, double_q)
    nbytes = 4.0 * (2 * B * D + 2 * B * A + 2 * B + 2 + 2 * 8 * P + 4)
    return (*roofline(flops, nbytes, name, tensor_cores), flops, nbytes)


def time_kernel(cfg, torch, name, dtypes=None):
    kern, plain, kw = kernel_fns(cfg, True, dtypes)
    _, batch, p_kern = make_inputs(cfg, 99, torch, "cuda")
    p_plain = [p.clone() for p in p_kern]
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    ms = time_ms(torch, lambda: kern(lr_t, eps_t, *batch, p_kern, **kw))
    plain_ms = time_ms(torch, lambda: plain(lr_t, eps_t, *batch, p_plain, **kw))
    tensor_cores = dtypes is not None and str(dtypes[0]).endswith("bfloat16")
    b_ms, b_by, flops, nbytes = bound(cfg, True, name, tensor_cores)
    return ms, plain_ms, b_ms, b_by, flops, nbytes


def products_library_ms(cfg, torch, bf16_products=False):
    """A yardstick only, which the port never calls: the products of one
    double-Q K1 update at its shapes as separate torch.matmul calls (cuBLAS):
    per layer three forwards x . W^T, the weight gradient dz^T . h over all
    B rows and, past the first layer, dh = dz . W.  float32 operands (the
    caller turns TF32 off), or bfloat16 ones for K1-bf16.  Median ms of the
    whole set."""
    dt = torch.bfloat16 if bf16_products else torch.float32
    sizes = [cfg["D"], *cfg["widths"], cfg["A"]]
    B = cfg["B"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE).to(dt)
    xs = [rnd(B, k) for k in sizes[:-1]]
    ws = [rnd(n, k) for k, n in zip(sizes[:-1], sizes[1:])]
    dzs = [rnd(B, n) for n in sizes[1:]]

    def run():
        for i in range(len(ws)):
            for _ in range(3):
                torch.matmul(xs[i], ws[i].t())
        for i in reversed(range(len(ws))):
            torch.matmul(dzs[i].t(), xs[i])
            if i:
                torch.matmul(dzs[i], ws[i])

    return time_ms(torch, run)


# ---------------------------------------------------------------- workflow


def make_table(path, n_rows, n_features, n_actions, seed, rewards="normal", metrics=False):
    """A logged-transition table (the timeline operator's columns) from a
    numpy seed: episodes of 10 steps, so ~10% terminals, and ~20% of the
    next actions impossible.  ``rewards`` "normal" draws N(0, 1), "uniform"
    uniform(0, 1) from the same place in the stream (CPE's normalised
    estimates need a logged policy worth more than 1e-6).  ``metrics`` adds
    a ``metrics`` column of {"ctr": uniform(0, 1), "watch": exponential}
    maps, drawn after every other column."""
    rng = np.random.default_rng(seed)
    import pandas as pd

    ep_len = 10
    states = rng.normal(size=(n_rows + 1, n_features)).astype(np.float32)
    seq = np.arange(n_rows) % ep_len
    terminal = seq == ep_len - 1
    actions = rng.integers(0, n_actions, n_rows + 1)
    names = [str(a) for a in range(n_actions)]

    def feats(row):
        return {i: float(v) for i, v in enumerate(row)}

    possible_next = []
    for r in range(n_rows):
        if terminal[r]:
            possible_next.append([])
            continue
        keep = rng.random(n_actions) > 0.2
        keep[actions[r + 1]] = True
        possible_next.append([n for n, k in zip(names, keep) if k])
    df = pd.DataFrame({
        "mdp_id": [f"ep{r // ep_len}" for r in range(n_rows)],
        "sequence_number": seq,
        "state_features": [feats(states[r]) for r in range(n_rows)],
        "next_state_features": [feats(states[r + 1]) for r in range(n_rows)],
        "action": [names[a] for a in actions[:n_rows]],
        "next_action": [names[a] for a in actions[1:n_rows + 1]],
        "reward": (rng.normal(size=n_rows) if rewards == "normal"
                   else rng.uniform(0.0, 1.0, size=n_rows)).astype(np.float32),
        "not_terminal": (~terminal).astype(np.int64),
        "time_diff": np.ones(n_rows, np.int64),
        "action_probability": np.full(n_rows, 1.0 / n_actions),
        "possible_next_actions": possible_next,
    })
    if metrics:
        ctr, watch = rng.uniform(0.0, 1.0, n_rows), rng.exponential(1.0, n_rows)
        df["metrics"] = [{"ctr": float(c), "watch": float(w)} for c, w in zip(ctr, watch)]
    df.to_pickle(path)
    return df


def run_workflow(cfg, n_rows, epochs, torch, tmp, label, model=None, split=None,
                 rewards="normal"):
    """identify_and_train_network on a synthetic table; returns the output,
    the table, the in-process serving module with the arguments it was built
    from (trainer, trainer state, normalization), the batch preprocessor and
    the wall time.  ``model`` defaults to the fused DiscreteDQN of ``cfg``;
    ``split`` is the table spec's (table_sample, eval_table_sample)."""
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    table = os.path.join(tmp, f"{label}.pkl")
    df = make_table(table, n_rows, cfg["D"], cfg["A"], seed=7, rewards=rewards)
    model = model or fused_model(cfg)
    with capturing_manager(model) as captured:
        t0 = time.perf_counter()
        out = identify_and_train_network(
            TableSpec(table_name=label, path=table, **table_split(split)), model,
            num_epochs=epochs,
            output_dir=os.path.join(tmp, label), seed=0, device=DEVICE)
        wall = time.perf_counter() - t0
    return (out, df, captured["build_serving_module"], captured["build_serving_module_args"],
            captured["build_batch_preprocessor"], wall)


def fused_model(cfg):
    """The fused DiscreteDQN of ``cfg`` (no CPE heads; K1 with ``block_size``
    where ``cfg`` has a block)."""
    model = {"DiscreteDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": cfg["gamma"], "target_update_rate": cfg["tau"],
                   "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": {"Adam": {"lr": cfg["lr"]}},
            "use_fused_kernel": True,
        },
        "net_builder": {"FullyConnected": {
            "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"])}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}
    if cfg["block"] is not None:
        model["DiscreteDQN"]["trainer_param"]["block_size"] = cfg["block"]
    return model


@contextlib.contextmanager
def capturing_manager(model):
    """Keep what the model manager of ``model`` builds in the block (the
    serving module with its arguments, the batch preprocessor, the
    reporter), to score and time it afterwards."""
    from unittest import mock

    from reagent_tpu_torch.core.registry import MODEL_MANAGERS

    manager_cls = MODEL_MANAGERS.get(next(iter(model)))
    captured = {}

    def capturing(method):
        original = getattr(manager_cls, method)

        def wrapper(self, *args, **kwargs):
            captured[method] = original(self, *args, **kwargs)
            captured[method + "_args"] = args
            return captured[method]
        return mock.patch.object(manager_cls, method, wrapper)

    with capturing("build_serving_module"), capturing("build_batch_preprocessor"), \
            capturing("get_reporter"):
        yield captured


def table_split(split):
    return {} if split is None else dict(zip(("table_sample", "eval_table_sample"), split))


def check_artifact(out, df, serving, torch):
    from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense

    path = out.output_paths["default_model"]
    sf = serving.model.preprocessor.sorted_features
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64], sf)
    _, q_artifact = DiscreteDqnPredictorWrapper.load(path)(values, presence)
    _, q_live = serving(torch.tensor(values, device=DEVICE),
                        torch.tensor(presence, device=DEVICE))
    q_live = q_live.cpu().numpy()
    diff = float(np.abs(q_artifact - q_live).max())
    np.testing.assert_allclose(q_artifact, q_live, atol=1e-4, rtol=0)
    assert q_artifact.shape == (64, serving.model.q_network.action_dim)
    assert np.isfinite(q_artifact).all()
    return diff


def counted():
    """(wrapper, plain version) of every kernel, by name."""
    from reagent_tpu_torch.ops import (
        fused_dqn,
        fused_dqn_offline,
        fused_mlp,
        nstep_replay,
        quantile_huber,
    )

    return {
        "quantile_huber_loss": (quantile_huber.quantile_huber_loss,
                                quantile_huber.quantile_huber_loss_reference),
        "fused_dqn_offline_update": (fused_dqn_offline.fused_dqn_offline_update,
                                     fused_dqn_offline.fused_dqn_offline_update_reference),
        "fused_dqn_update": (fused_dqn.fused_dqn_update, fused_dqn.fused_dqn_update_reference),
        "fused_dqn_update_packed": (fused_dqn.fused_dqn_update_packed,
                                    fused_dqn.fused_dqn_update_packed_reference),
        "fused_mlp_forward": (fused_mlp.fused_mlp_forward,
                              fused_mlp.fused_mlp_forward_reference),
        "nstep_rewards": (nstep_replay.nstep_rewards, nstep_replay.nstep_rewards_reference),
    }


def reset_counts():
    """Every kernel's launch count and every plain version's call count to 0."""
    for fn, plain in counted().values():
        fn.launches = 0
        plain.calls = 0
        for extra in ("backward_launches", "sums_launches", "bf16_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def read_counts():
    """(launches by kernel, plain-version calls in all) since reset_counts;
    K5's backward launches under ``quantile_huber_backward`` and its forward
    launches on the gradient route under ``quantile_huber_sums``, and K1's
    launches split into ``fused_dqn_offline_update`` (f32) and
    ``fused_dqn_offline_update_bf16`` (a bfloat16 option set)."""
    pairs = counted()
    launches = {k: fn.launches for k, (fn, _) in pairs.items()}
    launches["quantile_huber_backward"] = pairs["quantile_huber_loss"][0].backward_launches
    launches["quantile_huber_sums"] = pairs["quantile_huber_loss"][0].sums_launches
    k1_bf16 = pairs["fused_dqn_offline_update"][0].bf16_launches
    launches["fused_dqn_offline_update_bf16"] = k1_bf16
    launches["fused_dqn_offline_update"] -= k1_bf16
    return launches, sum(plain.calls for _, plain in pairs.values())


def workflow_phase(cfg, n_rows, epochs, kernel, torch, tmp, label):
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    reset_counts()
    out, df, serving, _, batch_pre, wall = run_workflow(cfg, n_rows, epochs, torch, tmp, label)
    launches = {
        "fused_dqn_offline_update": fused_dqn_offline.fused_dqn_offline_update.launches,
        "fused_dqn_update": fused_dqn.fused_dqn_update.launches,
    }
    plain_calls = (fused_dqn.fused_dqn_update_reference.calls
                   + fused_dqn_offline.fused_dqn_offline_update_reference.calls)
    steps = out.logger_data["train_steps"]
    secs = out.logger_data["train_seconds"]
    td = out.training_report.td_loss
    log(f"  {label}: {steps} train steps, launches {launches}, plain-version "
        f"calls {plain_calls}, td_loss {td}, training {secs:.3f} s "
        f"({steps / secs:.2f} steps/s host time included), whole workflow {wall:.1f} s")
    if launches[kernel] != steps or steps == 0:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls != 0:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td is None or not np.isfinite(td):
        raise AssertionError(f"td_loss is not finite: {td}")
    diff = check_artifact(out, df, serving, torch)
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}")
    # where a training step's time goes: the host builds each batch from the
    # logged columns before the one fused update runs on the card
    pre_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch_pre(df.iloc[: cfg["B"]])
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    log(f"  {label}: batch preprocessing of {cfg['B']} rows on the host: "
        f"{statistics.median(pre_s) * 1e3:.2f} ms (median of 3) of "
        f"{secs / steps * 1e3:.2f} ms per train step")
    return launches[kernel], steps, secs


# ------------------------------------------------------------ online slice

# bench.py:232-254: CartPole (200 steps), 4 -> 128 -> 64 -> 2 leaky_relu,
# gamma 0.99, tau 0.2, Adam lr 0.01, minibatch 512 (the CARTPOLE shapes)
PACKED_COLS = (1, 0, 5, 6)  # CartPole rows: action, observation 1-4, reward, terminal
ROW_WIDTH = 8
EVAL_EPISODES = 20
K4_SHAPES = {"loop": (50_000, 512, 1), "kernel phase": (100_000, 512, 3)}  # capacity, B, H


def example_transition(torch):
    return dict(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                reward=torch.tensor(0.0), terminal=torch.tensor(False))


def copy_state(state, device):
    """A deep copy of one of the port's state dataclasses on ``device``."""
    import dataclasses

    def cp(v):
        if v is None:
            return None
        if dataclasses.is_dataclass(v):
            return copy_state(v, device)
        if isinstance(v, tuple):
            return tuple(cp(x) for x in v)
        if isinstance(v, dict):
            return {k: cp(x) for k, x in v.items()}
        return v.detach().to(device).clone()

    return type(state)(**{f.name: cp(getattr(state, f.name)) for f in dataclasses.fields(state)})


def packed_rows(torch, seed, device):
    """Replay rows of CartPole transitions: ~5% terminals, as on the loop."""
    rng = np.random.default_rng(seed)
    B = CARTPOLE["B"]
    rows = np.zeros((B, ROW_WIDTH), np.float32)
    rows[:, 0] = rng.integers(0, 2, B)
    rows[:, 1:5] = rng.normal(size=(B, 4)) * 0.5
    rows[:, 5] = 1.0
    rows[:, 6] = rng.random(B) < 0.05
    return torch.tensor(rows, device=device)


def k2_packed_kw(double_q):
    cfg = CARTPOLE
    return dict(cols=PACKED_COLS, activations=[cfg["act"]] * 2 + ["linear"],
                gamma=cfg["gamma"], tau=cfg["tau"], double_q_learning=double_q)


def compare_k2_packed(torch):
    """5 lockstep updates of K2's packed interface and its plain version,
    double-Q and single-Q; K2's tolerances (metrics rtol 2e-4, atol 2e-5;
    final params rtol 5e-4, atol 5e-5)."""
    from reagent_tpu_torch.ops import fused_dqn

    worst = 0.0
    for double_q in (True, False):
        kw = k2_packed_kw(double_q)
        _, _, p_kern = make_inputs(CARTPOLE, 1234, torch, DEVICE)
        p_plain = [p.clone() for p in p_kern]
        for step in range(5):
            rows, next_rows = packed_rows(torch, step, DEVICE), packed_rows(torch, 100 + step, DEVICE)
            lr_t, eps_t = step_scalars(torch, step, CARTPOLE["lr"], DEVICE)
            mk = fused_dqn.fused_dqn_update_packed(lr_t, eps_t, rows, next_rows, p_kern, **kw)
            if fused_dqn.fused_dqn_update_packed.kernels_per_update != 1:
                raise AssertionError("K2-packed did not run as one launch: "
                                     f"{fused_dqn.fused_dqn_update_packed.kernels_per_update}")
            mp = fused_dqn.fused_dqn_update_packed_reference(
                lr_t, eps_t, rows, next_rows, p_plain, **kw)
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst = max(worst, (mk - mp).abs().max().item())
        for a, b in zip(p_kern, p_plain):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
            worst = max(worst, (a - b).abs().max().item())
        log(f"  K2-packed double_q={double_q}: 5 updates, last metrics "
            f"{mk.flatten().tolist()}, max abs {worst:.3e}")
    return worst


def k3_inputs(torch, rows, seed):
    """The act step's weights as the trainer passes them (W^T views of
    [out, in] tensors) and ``rows`` CartPole-scale observations."""
    _, _, params = make_inputs(CARTPOLE, seed, torch, DEVICE)
    L = len(CARTPOLE["widths"]) + 1
    weights = [(w.T, b.reshape(-1)) for w, b in zip(params[:L], params[L:2 * L])]
    rng = np.random.default_rng(seed)
    x = torch.tensor((rng.normal(size=(rows, CARTPOLE["D"])) * 0.05).astype(np.float32),
                     device=DEVICE)
    return x, weights, [CARTPOLE["act"]] * (L - 1) + ["linear"]


def compare_k3(torch):
    """The act step ([1, 4]) and evaluate_policy ([20, 4]) of the online
    loops, and the policy-gradient act steps ([1, 4] at PG_CONFIGS' widths);
    float32 sums in another order: rtol 1e-5, atol 1e-5."""
    from reagent_tpu_torch.ops import fused_mlp

    cases = [(f"[{rows}, 4]", *k3_inputs(torch, rows, 5 + rows)) for rows in (1, EVAL_EPISODES)]
    cases += [(f"{name}'s act step [1, 4→{'→'.join(map(str, cfg['widths']))}→2]",
               *k3_eval_inputs(torch, 1, [CARTPOLE["D"], *cfg["widths"], CARTPOLE["A"]], 41))
              for name, cfg in PG_CONFIGS.items()]
    worst = 0.0
    for label, x, weights, acts in cases:
        y = fused_mlp.fused_mlp_forward(x, weights, acts)
        yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        worst = max(worst, (y - yp).abs().max().item())
        log(f"  K3 {label}: {y[0].tolist()} max abs {(y - yp).abs().max().item():.3e}")
    return worst


def k4_inputs(torch, capacity, B, seed):
    """A store of CartPole-like rewards with ~5% terminals and B uniform
    start indices (some windows wrap the capacity)."""
    rng = np.random.default_rng(seed)
    rewards = torch.tensor(rng.normal(size=capacity).astype(np.float32), device=DEVICE)
    terminals = torch.tensor(rng.random(capacity) < 0.05, device=DEVICE)
    idx = rng.integers(0, capacity, B)
    idx[:4] = [capacity - 1, capacity - 2, capacity - 3, 0]
    return rewards, terminals, torch.tensor(idx, dtype=torch.int64, device=DEVICE)


def compare_k4(torch):
    """The kernel rounds as its plain version does, in its order: exact."""
    from reagent_tpu_torch.ops import nstep_replay

    worst = 0.0
    for label, (capacity, B, H) in K4_SHAPES.items():
        rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
        got = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)
        want = nstep_replay.nstep_rewards_reference(rewards, terminals, idx, H, 0.99)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        worst = max(worst, (got[0] - want[0]).abs().max().item())
        log(f"  K4 {label} capacity {capacity} B {B} H {H}: mean steps "
            f"{got[1].float().mean().item():.4f}, terminals {int(got[2].sum())}, exact")
    return worst


def k2_packed_call(torch, seed=99):
    """(K2-packed call, its plain version's call) on one state and batch at
    the online loop's shapes, double-Q."""
    from reagent_tpu_torch.ops import fused_dqn

    kw = k2_packed_kw(True)
    _, _, p_kern = make_inputs(CARTPOLE, seed, torch, DEVICE)
    p_plain = [p.clone() for p in p_kern]
    rows, next_rows = packed_rows(torch, 1, DEVICE), packed_rows(torch, 2, DEVICE)
    lr_t, eps_t = step_scalars(torch, 0, CARTPOLE["lr"], DEVICE)
    return (lambda: fused_dqn.fused_dqn_update_packed(lr_t, eps_t, rows, next_rows, p_kern, **kw),
            lambda: fused_dqn.fused_dqn_update_packed_reference(
                lr_t, eps_t, rows, next_rows, p_plain, **kw))


def time_k2_packed(torch, name):
    """K2-packed's and its plain version's CUDA-event times, the bound and
    its work (the batch is read as the raw [512, 8] rows)."""
    kern, plain = k2_packed_call(torch)
    flops, P = update_work(CARTPOLE, True)
    B = CARTPOLE["B"]
    nbytes = 4.0 * (2 * B * ROW_WIDTH + 2 + 2 * 8 * P + 4)
    return (time_ms(torch, kern), time_ms(torch, plain), *roofline(flops, nbytes, name),
            flops, nbytes, "rows [512, 8], double-Q")


def host_us_per_call(torch, fn, n=200):
    """Host time of one call in us: time.perf_counter over ``n`` calls with no
    sync between them.  With one launch per update, the ctypes wrapper's own
    checks and set-up are most of what an update costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_online_kernels(torch, name):
    """CUDA-event times (3 warm-ups, median of 20) of K2-packed, K3 and K4
    and their plain versions at the main path's shapes, with each bound."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {"K2-packed": time_k2_packed(torch, name)}

    for rows_k3 in (1, EVAL_EPISODES):
        x, weights, acts = k3_inputs(torch, rows_k3, 7)
        sizes = [CARTPOLE["D"], *CARTPOLE["widths"], CARTPOLE["A"]]
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        flops = 2.0 * rows_k3 * macs
        nbytes = 4.0 * (rows_k3 * sizes[0] + macs + sum(sizes[1:]) + rows_k3 * sizes[-1])
        plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
        out[f"K3 [{rows_k3}, 4]"] = (
            time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts)),
            time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(x, plain_w, acts)),
            *roofline(flops, nbytes, name), flops, nbytes, f"x [{rows_k3}, 4]")

    for label, (capacity, B, H) in K4_SHAPES.items():
        rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
        steps = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)[1]
        walked = int(steps.sum())  # this run's windows, as far as each is read
        flops = 2.0 * walked
        nbytes = 8.0 * B + 5.0 * walked + 9.0 * B
        out[f"K4 {label}"] = (
            time_ms(torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)),
            time_ms(torch, lambda: nstep_replay.nstep_rewards_reference(
                rewards, terminals, idx, H, 0.99)),
            *roofline(flops, nbytes, name), flops, nbytes,
            f"capacity {capacity}, B {B}, H {H}")
    return out


def k3_products_library_ms(torch, rows=1):
    """A yardstick only, which the port never calls: K3's forward at the act
    step as one torch.addmm per layer and the activation (cuBLAS and
    PyTorch's elementwise kernels), on the same inputs.  Median ms."""
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.ops.fused_dqn import _act

    x, weights, acts = k3_inputs(torch, rows, 7)

    def run():
        h = x
        for (w, b), a in zip(weights, acts):
            h = _act(a, torch.addmm(b, h, w))
        return h

    torch.testing.assert_close(run(), fused_mlp.fused_mlp_forward(x, weights, acts),
                               rtol=1e-5, atol=1e-5)
    return time_ms(torch, run)


def online_host_us(torch):
    """Wrapper host time per call (us) of K3 at the act step ([1, 4]) and at
    evaluate_policy's [20, 4], and of K4 at the loops' shape."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {}
    for rows in (1, EVAL_EPISODES):
        x, weights, acts = k3_inputs(torch, rows, 7)
        out[f"K3 [{rows}, 4]"] = host_us_per_call(
            torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts))
    capacity, B, H = K4_SHAPES["loop"]
    rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
    out["K4 loop"] = host_us_per_call(
        torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99))
    return out


def online_setup(torch, device, seed):
    """The bench's online DQN: env, q-network, trainer and a fresh state."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    cfg = CARTPOLE
    env = CartPole(max_steps=200, device=device)
    net = FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                            activations=[cfg["act"]] * len(cfg["widths"]))
    trainer = FusedDQNTrainer(
        q_network=net, rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        optimizer={"Adam": {"lr": cfg["lr"]}}, minibatch_size=cfg["B"], device=device)
    return env, net, trainer, trainer.init(torch.Generator().manual_seed(seed))


def fused_loop_against_cpu(torch, env, trainer, tstate, rb, rb_state, n=32):
    """``n`` steps of the fused loop on the card and on the CPU (the plain
    versions) from the same state and noise tape.  Per-step td_loss to rtol
    1e-3, atol 1e-4 and final params to rtol 1e-3, atol 1e-4: each update
    differs at K2's tolerances, and n steps of training feed that back;
    actions and terminals exactly, observations to atol 1e-4 (sin/cos of
    two libraries)."""
    from reagent_tpu_torch.gym.fused_dqn_loop import (
        FusedLoopConfig,
        draw_noise_tape,
        run_fused_loop_from_tape,
    )
    from reagent_tpu_torch.replay import PackedReplayBuffer

    cfg = FusedLoopConfig(num_steps=n, minibatch_size=CARTPOLE["B"])
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    env_state, obs = env.reset(gen)
    tape = draw_noise_tape(env, cfg, gen)
    env_c, _, trainer_c, _ = online_setup(torch, "cpu", 0)
    rb_c = PackedReplayBuffer(replay_capacity=rb.capacity, device="cpu")
    rb_c.init(**example_transition(torch))
    runs = {}
    for dev, e, tr, r in ((DEVICE, env, trainer, rb), ("cpu", env_c, trainer_c, rb_c)):
        runs[dev] = run_fused_loop_from_tape(
            e, tr, copy_state(tstate, dev), r, copy_state(rb_state, dev),
            copy_state(env_state, dev), obs.to(dev).clone(), tuple(x.to(dev) for x in tape), cfg)
    (ts_g, rs_g, aux_g), (ts_c, rs_c, aux_c) = runs[DEVICE], runs["cpu"]
    td_g, td_c = aux_g["td_losses"].cpu(), aux_c["td_losses"]
    torch.testing.assert_close(td_g, td_c, rtol=1e-3, atol=1e-4)
    rows_g, rows_c = rs_g.rows.cpu(), rs_c.rows
    for col in (PACKED_COLS[1], PACKED_COLS[3]):
        assert torch.equal(rows_g[:, col], rows_c[:, col]), f"column {col} differs"
    torch.testing.assert_close(rows_g[:, 1:5], rows_c[:, 1:5], rtol=0, atol=1e-4)
    for a, b in zip(ts_g.params8(), ts_c.params8()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    assert int(aux_g["episodes_completed"]) == int(aux_c["episodes_completed"])
    return (td_g - td_c).abs().max().item()


def fused_loop_phase(torch, steps):
    """Prefill 1,000 random transitions, then ``steps`` of the fused loop
    (bench.py's online_dqn, cut from 30,000 steps to ``steps``)."""
    from reagent_tpu_torch.gym.fused_dqn_loop import FusedLoopConfig, run_fused_online_dqn
    from reagent_tpu_torch.gym.online_loop import prefill_replay_buffer
    from reagent_tpu_torch.replay import PackedReplayBuffer

    env, _, trainer, tstate = online_setup(torch, DEVICE, 0)
    rb = PackedReplayBuffer(replay_capacity=100_000, device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, 1000)
    assert int(rb_state.add_count) == 1000
    err = fused_loop_against_cpu(torch, env, trainer, tstate, rb, rb_state)
    log(f"  card vs CPU plain versions, 32 lockstep steps: td_loss max abs {err:.3e}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_fused_online_dqn(
        env, trainer, tstate, rb, rb_state, gen,
        FusedLoopConfig(num_steps=steps, minibatch_size=CARTPOLE["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    episodes = int(aux["episodes_completed"])
    returns = aux["recent_episode_returns"].cpu()
    returns = returns[~torch.isnan(returns)]
    log(f"  fused loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s (each an env step and an update, host time "
        f"included), episodes completed {episodes}, mean of the last "
        f"{len(returns)} returns {returns.mean().item():.2f}, last td_loss "
        f"{td[-1].item():.6g}, launches {launches}, plain-version calls {plain_calls}")
    for kernel in ("fused_dqn_update_packed", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td.shape != (steps,) or not torch.isfinite(td).all() or episodes < 1:
        raise AssertionError(f"fused loop output: td {td.shape}, episodes {episodes}")
    if int(rb_state.add_count) != 1000 + steps or int(tstate.step) != steps:
        raise AssertionError("fused loop did not add and train once per step")

    # where a step's time goes: device time by CUDA kernel over a profiled
    # window, beside the unprofiled wall time per step
    n = 50
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_fused_online_dqn(env, trainer, tstate, rb, rb_state, gen,
                             FusedLoopConfig(num_steps=n, minibatch_size=CARTPOLE["B"]))
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    wall_step = wall / steps * 1e6
    log(f"  fused loop step: {wall_step:.1f} us wall (unprofiled), {dev_step:.1f} us of "
        f"device kernels (profiled window of {n} steps): the device is idle "
        f"{(1 - dev_step / wall_step) * 100:.1f}% of a step")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:8]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    # a value read back to the host shows as _local_scalar_dense; the one
    # expected is run_fused_online_dqn's prefill guard, before the loop
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    log(f"  host reads of device values in the {n}-step window: "
        f"{counts.get('aten::_local_scalar_dense', 0)} "
        f"(cudaStreamSynchronize: {counts.get('cudaStreamSynchronize', 0)})")
    return launches, steps / wall, err


def generic_loop_phase(torch, steps):
    """ReplayBuffer (capacity 50,000, update_horizon 1) prefilled with 1,000
    random transitions, ``steps`` env steps with softmax acting through the
    K3 scorer and one tensor-K2 update per step, then evaluate_policy over
    20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import (
        GreedyActionSampler,
        SoftmaxActionSampler,
        discrete_dqn_scorer,
    )
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    env, net, trainer, tstate = online_setup(torch, DEVICE, 2)
    rb = ReplayBuffer(replay_capacity=50_000, update_horizon=1, gamma=0.99, device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, 1000)
    scorer = discrete_dqn_scorer(net)
    softmax, greedy = SoftmaxActionSampler(temperature=1.0), GreedyActionSampler()

    def policy_act(ts, obs, g):
        out = softmax.sample_action(scorer(trainer.mlp_weights(ts), obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(greedy.sample_action(scorer(trainer.mlp_weights(ts), obs)).action, -1)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_online_training(
        env, trainer, tstate, rb, rb_state, policy_act,
        lambda d: make_discrete_dqn_batch(d, CARTPOLE["A"]), gen,
        OnlineLoopConfig(num_steps=steps, minibatch_size=CARTPOLE["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    log(f"  generic loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s, episodes completed {int(aux['episodes_completed'])}, "
        f"last td_loss {td[-1].item():.6g}, launches {loop_launches}, "
        f"plain-version calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward", "fused_dqn_update"):
        if loop_launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {loop_launches[kernel]} times for {steps} steps")
    if plain_calls or td.shape != (steps,) or not torch.isfinite(td).all():
        raise AssertionError(f"generic loop: plain calls {plain_calls}, td {td.shape}")
    if int(rb_state.add_count) != 1000 + steps:
        raise AssertionError("generic loop did not add once per step")

    # the sample the loop trained on, against the same state on the CPU (K4's
    # plain version), for 512 indices the buffer would draw
    idx = rb.sample_index_batch(rb_state, gen, CARTPOLE["B"])
    got = rb.sample(rb_state, indices=idx)
    from reagent_tpu_torch.replay import ReplayBuffer as CpuBuffer

    rb_c = CpuBuffer(replay_capacity=50_000, update_horizon=1, gamma=0.99, device="cpu")
    rb_c.init(**example_transition(torch))
    want = rb_c.sample(copy_state(rb_state, "cpu"), indices=idx.cpu())
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), f"sample[{k}] differs from the CPU buffer"

    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    wall_eval = time.perf_counter() - t0
    eval_launches, plain_calls = read_counts()
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes in {wall_eval:.3f} s, returns "
        f"{returns.tolist()} (mean {returns.mean().item():.2f}), launches {eval_launches}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"evaluate_policy launches {eval_launches}, plain {plain_calls}")
    if returns.shape != (EVAL_EPISODES,) or not ((returns >= 1) & (returns <= env.max_steps)).all():
        raise AssertionError(f"evaluate_policy returns {returns}")
    return loop_launches, eval_launches, steps / wall


# ------------------------------------------------------------ QR-DQN slice


def k5_inputs(torch, B, N, seed, dtype=None, ties=False):
    """Target and current quantiles [B, N] from a numpy seed.  ``ties``:
    quarter-step values (exact in float32), every third target row one value
    (a terminal row's reward) and one current row equal to its target, so td
    lands on 0, on +-0.5 and on +-1.0 = kappa."""
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(B, N)) * 2.0
    current = rng.normal(size=(B, N)) * 2.0
    if ties:
        target, current = np.round(target * 4) / 4, np.round(current * 4) / 4
        target[::3] = 1.0
        current[0] = target[0]
    put = lambda a: torch.tensor(a, dtype=torch.float32, device=DEVICE).to(dtype or torch.float32)
    return put(target), put(current)


def compare_k5(torch):
    """Each K5 kernel against its plain twin, then the two under autograd.

    The forward's loss-only route (under ``torch.no_grad()``) and its
    gradient route give the same per-sample losses bit for bit, within rtol
    1e-5, atol 1e-6 of the plain version (float32 sums in another order,
    with fma contraction); the gradient sums within rtol 1e-5, atol 1e-6 N^2
    (the gradient's bound below, in the sums' units).  The backward kernel
    scales the kernel's own sums within rtol 1e-6 of the plain scaling (a
    division against PyTorch's product with the reciprocal; in bfloat16 one
    more rounding to 8 bits: rtol 1.6e-2, atol 1e-5).  Under autograd the
    gradient of the mean, times B, within rtol 1e-5, atol 1e-6 (bfloat16
    rtol 1.6e-2, atol 1e-5).  Returns the largest float32 abs errors of the
    forward, of the sums route's gradient and of the scaling."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    worst_f = worst_g = worst_s = 0.0
    cases = [(B, N, None, False) for B, N in K5_SHAPES]
    cases += [(4096, 51, torch.bfloat16, False), (4096, 51, None, True)]
    for B, N, dtype, ties in cases:
        target, current = k5_inputs(torch, B, N, seed=B + N, dtype=dtype, ties=ties)
        with torch.no_grad():
            per_loss = qh.quantile_huber_per_sample(target, current.clone().requires_grad_(True))
        per_sums, sums = qh._launch_forward(target, current, 1.0, sums=True)
        weights = torch.linspace(-1.0, 2.0, B, device=DEVICE)
        grad = qh._launch_scale(sums, weights, current.dtype)
        c_kern = current.clone().requires_grad_(True)
        c_plain = current.clone().requires_grad_(True)
        per_kern = qh.quantile_huber_per_sample(target, c_kern, 1.0)
        per_plain = qh.quantile_huber_per_sample_reference(target, c_plain, 1.0)
        (g_kern,) = torch.autograd.grad(per_kern.mean(), c_kern)
        (g_plain,) = torch.autograd.grad(per_plain.mean(), c_plain)
        torch.cuda.synchronize()
        sums_plain = qh.quantile_huber_sums_reference(target, current, 1.0)
        grad_plain = qh.quantile_huber_scale_reference(sums, weights, current.dtype)
        g_kern, g_plain = g_kern.float() * B, g_plain.float() * B
        err_f = (per_kern - per_plain).abs().max().item()
        err_g = (g_kern - g_plain).abs().max().item()
        err_s = (grad.float() - grad_plain.float()).abs().max().item()
        label = f"[{B}, {N}] {'bf16' if dtype else 'f32'}{' ties' if ties else ''}"
        log(f"  K5 {label}: loss {per_kern.mean().item():.6f}, forward max abs {err_f:.3e} "
            f"(loss-only and gradient routes bit for bit: "
            f"{torch.equal(per_loss, per_sums) and torch.equal(per_sums, per_kern)}), sums max "
            f"abs {(sums - sums_plain).abs().max().item():.3e}, scaling max abs {err_s:.3e}, "
            f"gradient (x B) max abs {err_g:.3e} of max |g| {g_plain.abs().max().item():.3e}")
        if not (torch.equal(per_loss, per_sums) and torch.equal(per_sums, per_kern)):
            raise AssertionError(f"K5 {label}: the two forward routes differ")
        torch.testing.assert_close(per_kern, per_plain, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sums, sums_plain, rtol=1e-5, atol=1e-6 * N * N)
        if dtype is None:
            torch.testing.assert_close(grad, grad_plain, rtol=1e-6, atol=0.0)
            torch.testing.assert_close(g_kern, g_plain, rtol=1e-5, atol=1e-6)
            worst_f, worst_g = max(worst_f, err_f), max(worst_g, err_g)
            worst_s = max(worst_s, err_s)
        else:
            torch.testing.assert_close(grad, grad_plain, rtol=1.6e-2, atol=1e-5)
            torch.testing.assert_close(g_kern, g_plain, rtol=1.6e-2, atol=1e-5)
    return worst_f, worst_g, worst_s


def k5_bounds(B, N, name):
    """K5's bounds in ms at [B, N] float32, each (ms, "operations" or
    "bytes"): the loss-only forward (K5_LOSS_INSTR a pair; target and
    current read, the losses written), the forward with gradient sums
    (K5_SUMS_INSTR a pair; the sums written too), the backward (bytes: the
    sums and the incoming gradient read, the gradient written) and the
    trainer's pair as one function (K5_SUMS_INSTR a pair; target, current and
    the incoming gradient read, the losses and the gradient written)."""
    flops, row = 2.0 * B * N * N, 4.0 * B * N  # an instruction is 2 FLOPs
    return dict(
        loss=roofline(K5_LOSS_INSTR * flops, 2 * row + 4 * B, name),
        sums=roofline(K5_SUMS_INSTR * flops, 3 * row + 4 * B, name),
        bwd=roofline(0, 2 * row + 4 * B, name),
        pair=roofline(K5_SUMS_INSTR * flops, 3 * row + 8 * B, name))


def time_k5(torch, name):
    """CUDA-event times at the three shapes of K5's loss-only forward, its
    forward with gradient sums, its backward and the trainer's pair (the
    forward with sums, then the backward), and of the plain versions of
    each (the pair's: the plain forward and autograd's backward through it),
    with the bounds computed from this run's shapes."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    out = {}
    for B, N in K5_SHAPES:
        target, current = k5_inputs(torch, B, N, seed=N)
        grad_out = torch.full((B,), 1.0 / B, device=DEVICE)
        c_grad = current.clone().requires_grad_(True)
        _, sums = qh._launch_forward(target, current, 1.0, sums=True)

        def pair():
            qh._launch_scale(qh._launch_forward(target, current, 1.0, sums=True)[1],
                             grad_out, current.dtype)

        def plain_fwd_bwd():
            torch.autograd.grad(qh.quantile_huber_loss_reference(target, c_grad), c_grad)

        t = dict(
            loss=time_ms(torch, lambda: qh._launch_forward(target, current, 1.0, sums=False)),
            sums=time_ms(torch, lambda: qh._launch_forward(target, current, 1.0, sums=True)),
            bwd=time_ms(torch, lambda: qh._launch_scale(sums, grad_out, current.dtype)),
            pair=time_ms(torch, pair))
        with torch.no_grad():
            t["plain_loss"] = time_ms(
                torch, lambda: qh.quantile_huber_per_sample_reference(target, current))
            t["plain_sums"] = time_ms(torch, lambda: (
                qh.quantile_huber_per_sample_reference(target, current),
                qh.quantile_huber_sums_reference(target, current, 1.0)))
            t["plain_bwd"] = time_ms(
                torch, lambda: qh.quantile_huber_scale_reference(sums, grad_out, current.dtype))
        t["plain_pair"] = time_ms(torch, plain_fwd_bwd)
        t["bounds"] = k5_bounds(B, N, name)
        t["pairs"] = float(B) * N * N
        out[(B, N)] = t
    return out


def qr_offline_model():
    cfg = FULL
    return {"DiscreteQRDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": 0.9, "target_update_rate": 0.05},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": QR_OPTIMIZER,
        },
        "net_builder": {"QuantileFullyConnected": {
            "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"]),
            "num_atoms": QR_ATOMS}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}


def profile_qr_step(torch, trainer, tstate, batch_pre, df, B, n=5):
    """Where an offline QR-DQN train step's time goes: the host's batch
    preprocessing of ``B`` logged rows (median of 3), ``n`` train steps on
    one batch by the host clock, and the same steps' device time by CUDA
    kernel and host time by operator (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    pre_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = batch_pre(df.iloc[:B])
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    state, _ = trainer.train_step(tstate, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    k5_us = sum(us for us, _, key in device_us if "quantile_huber" in key)
    gemm_us = sum(us for us, _, key in device_us if "gemm" in key.lower())
    log(f"  QR-DQN train step at B={B}: batch preprocessing on the host "
        f"{statistics.median(pre_s) * 1e3:.2f} ms (median of 3); train_step {step_ms:.3f} ms "
        f"by the host clock (mean of {n}, one batch), of which {dev_step / 1e3:.3f} ms are "
        f"device kernels ({sum(r[1] for r in device_us):.0f} launches a step): K5 forward "
        f"and backward {k5_us / 1e3:.4f} ms, matrix products {gemm_us / 1e3:.4f} ms, "
        f"elementwise and reductions {(dev_step - k5_us - gemm_us) / 1e3:.4f} ms")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:6]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")


def qr_workflow_phase(torch, tmp, k5_step_ms):
    """identify_and_train_network with DiscreteQRDQN at full width: K5 once
    forward and once backward per train step, a finite loss, the loaded
    artifact against the in-process serving module on 64 raw rows (max abs
    1e-4), and the trainer's q_values (K3, then the mean over atoms) against
    the same module."""
    from reagent_tpu_torch.prediction.predictor_wrapper import CategoricalDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense

    cfg, label = FULL, "qr_full_width"
    reset_counts()
    out, df, serving, (trainer, tstate, _), batch_pre, wall = run_workflow(
        cfg, FULL_ROWS, FULL_EPOCHS, torch, tmp, label, model=qr_offline_model())
    launches, plain_calls = read_counts()
    steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
    td = out.training_report.td_loss
    log(f"  {label}: {steps} train steps, launches {launches}, plain-version calls "
        f"{plain_calls}, td_loss {td}, training {secs:.3f} s ({steps / secs:.2f} steps/s "
        f"host time included), whole workflow {wall:.1f} s; K5 forward with sums + backward "
        f"{k5_step_ms:.4f} ms = {k5_step_ms / (secs / steps * 1e3) * 100:.4f}% of a step")
    for kernel in ("quantile_huber_loss", "quantile_huber_sums", "quantile_huber_backward"):
        if launches[kernel] != steps or steps == 0:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td is None or not np.isfinite(td):
        raise AssertionError(f"td_loss is not finite: {td}")

    sf = serving.preprocessor.sorted_features
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64], sf)
    names, q_artifact = CategoricalDqnPredictorWrapper.load(
        out.output_paths["default_model"])(values, presence)
    v, p = torch.tensor(values, device=DEVICE), torch.tensor(presence, device=DEVICE)
    _, q_live = serving(v, p)
    diff = float(np.abs(q_artifact - q_live.cpu().numpy()).max())
    np.testing.assert_allclose(q_artifact, q_live.cpu().numpy(), atol=1e-4, rtol=0)
    assert q_artifact.shape == (64, cfg["A"]) and np.isfinite(q_artifact).all()
    assert names == [str(a) for a in range(cfg["A"])]
    q_k3 = trainer.q_values(tstate, serving.preprocessor(v, p))
    torch.cuda.synchronize()
    k3_launches = read_counts()[0]["fused_mlp_forward"]
    diff_k3 = (q_k3 - q_live).abs().max().item()
    torch.testing.assert_close(q_k3, q_live, rtol=1e-4, atol=1e-4)
    if k3_launches != 1:
        raise AssertionError(f"q_values launched K3 {k3_launches} times")
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"trainer.q_values (K3, mean over {QR_ATOMS} atoms) vs the module: max abs {diff_k3:.3e}")
    launches["fused_mlp_forward"] = k3_launches
    profile_qr_step(torch, trainer, tstate, batch_pre, df, cfg["B"])
    return launches, steps, secs


def qr_lockstep_phase(torch, n=5):
    """``n`` QRDQNTrainer steps at the offline width on the card (K5) and on
    the CPU (the plain version) from one initial state and the same batches.
    td_loss per step to rtol 1e-4, atol 1e-5; final parameters, target
    parameters and Adam moments to rtol 1e-3, atol 1e-4: float32 sums in
    another order, which amsgrad amplifies where |g| is small and ``n`` steps
    feed back."""
    import copy

    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.net_builder.quantile_dqn import QuantileFullyConnected
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    cfg = FULL
    net = QuantileFullyConnected(
        sizes=cfg["widths"], activations=[cfg["act"]] * len(cfg["widths"]),
        num_atoms=QR_ATOMS).build_q_network(None, cfg["A"], state_dim=cfg["D"])
    kw = dict(num_atoms=QR_ATOMS, rl=RLParameters(gamma=0.9, target_update_rate=0.05),
              optimizer=QR_OPTIMIZER)
    trainers = {"cpu": QRDQNTrainer(copy.deepcopy(net), device="cpu", **kw),
                DEVICE: QRDQNTrainer(net, device=DEVICE, **kw)}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(11))
    states = {dev: copy_state(first, dev) for dev in trainers}
    reset_counts()
    worst_td = 0.0
    for step in range(n):
        _, b, _ = make_inputs(cfg, 500 + step, torch, "cpu")
        obs, nobs, action, reward, not_terminal, mask = b
        td = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(obs), next_state=rlt.FeatureData(nobs), action=action,
                next_action=action, reward=reward, time_diff=None, step=None,
                not_terminal=not_terminal, possible_actions_mask=torch.ones_like(mask),
                possible_next_actions_mask=mask).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            td[dev] = m["td_loss"].cpu()
        torch.testing.assert_close(td[DEVICE], td["cpu"], rtol=1e-4, atol=1e-5)
        worst_td = max(worst_td, (td[DEVICE] - td["cpu"]).abs().item())
    launches, plain_calls = read_counts()
    k5 = [launches[k] for k in ("quantile_huber_loss", "quantile_huber_sums",
                                "quantile_huber_backward")]
    if k5 + [plain_calls] != [n] * 4:
        raise AssertionError(f"lockstep: launches {launches}, plain calls {plain_calls}")
    worst_p = 0.0
    g, c = states[DEVICE], states["cpu"]
    for a, b in ((g.q_params, c.q_params), (g.q_target_params, c.q_target_params),
                 (g.opt_state.mu, c.opt_state.mu), (g.opt_state.nu_max, c.opt_state.nu_max)):
        for k in b:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-3, atol=1e-4)
            worst_p = max(worst_p, (a[k].cpu() - b[k]).abs().max().item())
    log(f"  card (K5) vs CPU (plain version), {n} lockstep train steps: td_loss max abs "
        f"{worst_td:.3e} (last {td[DEVICE].item():.6f}), parameters and moments max abs "
        f"{worst_p:.3e}")
    return worst_td, worst_p


def qr_online_phase(torch):
    """tests/test_gym_all_algos.py:98-115 at the widths given there: QRDQNTrainer
    on a dueling 64, 64 net with 11 atoms, ReplayBuffer of 50,000, softmax
    acting on trainer.q_values, minibatch 512; prefill and steps cut to
    QR_ONLINE's.  Then evaluate_policy over 20 greedy episodes."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.net_builder.quantile_dqn import DuelingQuantile
    from reagent_tpu_torch.replay import ReplayBuffer
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    q = QR_ONLINE
    steps = q["steps"]
    env = CartPole(max_steps=200, device=DEVICE)
    net = DuelingQuantile(sizes=q["widths"], activations=[q["act"]] * 2,
                          num_atoms=q["atoms"]).build_q_network(None, 2, state_dim=4)
    trainer = QRDQNTrainer(
        net, q["atoms"], rl=RLParameters(gamma=q["gamma"], target_update_rate=q["tau"]),
        optimizer=QR_OPTIMIZER, device=DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(4))
    rb = ReplayBuffer(replay_capacity=50_000, update_horizon=1, gamma=q["gamma"], device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, q["prefill"])
    softmax = SoftmaxActionSampler(temperature=1.0)

    def policy_act(ts, obs, g):
        out = softmax.sample_action(trainer.q_values(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(trainer.q_values(ts, obs), dim=1).to(torch.int32)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_online_training(
        env, trainer, tstate, rb, rb_state, policy_act,
        lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=steps, minibatch_size=q["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    log(f"  online QR-DQN loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s, episodes completed {int(aux['episodes_completed'])}, "
        f"last td_loss {td[-1].item():.6g}, launches {launches}, "
        f"plain-version calls {plain_calls}")
    for kernel in ("nstep_rewards", "quantile_huber_loss", "quantile_huber_sums",
                   "quantile_huber_backward"):
        if launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls or td.shape != (steps,) or not torch.isfinite(td).all():
        raise AssertionError(f"online QR-DQN loop: plain calls {plain_calls}, td {td.shape}")
    if int(rb_state.add_count) != q["prefill"] + steps or int(tstate.step) != steps:
        raise AssertionError("online QR-DQN loop did not add and train once per step")

    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes, returns {returns.tolist()} "
        f"(mean {returns.mean().item():.2f})")
    if returns.shape != (EVAL_EPISODES,) or not ((returns >= 1) & (returns <= env.max_steps)).all():
        raise AssertionError(f"evaluate_policy returns {returns}")

    # where a step's time goes: a profiled window beside the unprofiled wall time
    from torch.profiler import ProfilerActivity, profile

    n = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_online_training(
            env, trainer, tstate, rb, rb_state, policy_act,
            lambda d: make_discrete_dqn_batch(d, 2), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=q["B"]))
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step, wall_step = sum(r[0] for r in device_us), wall / steps * 1e6
    k5_us = sum(us for us, _, key in device_us if "quantile_huber" in key)
    log(f"  online QR-DQN step: {wall_step:.1f} us wall (unprofiled), {dev_step:.1f} us of "
        f"device kernels in {sum(r[1] for r in device_us):.0f} launches (profiled window of "
        f"{n} steps), K5 forward and backward {k5_us:.1f} us of them: the device is idle "
        f"{(1 - dev_step / wall_step) * 100:.1f}% of a step")
    for us, count, key in device_us[:6]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:6]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    return launches, steps / wall


# ------------------------------------------- device-resident offline slice


def assert_first_moments_close(torch, got, want, label):
    """First moments ``b1 * m + 0.1 * g`` after one update from one state:
    rtol 1e-3, atol 5e-6, except in at most 16 rows of a weight's moment
    (elements of a bias's), where up to 2e-4 is allowed.  Those outliers are
    sign flips, not rounding: a hidden pre-activation within float32 rounding
    of 0 lands on the other side in the other summation order, leaky_relu's
    derivative there is 1 or 0.01, and that batch row's term (about
    0.1 * |dz| * |h_prev|, some 1e-5 at this width) enters one row of dW in
    full or at a hundredth.  Returns (max abs, outliers, rows holding them)."""
    diff = (got - want).abs()
    far = diff > 5e-6 + 1e-3 * want.abs()
    rows = int(far.any(dim=1).sum()) if got.shape[0] > 1 else int(far.sum())
    worst = diff.max().item()
    if rows > 16 or worst > 2e-4:
        raise AssertionError(f"{label}: first moments differ in {rows} rows "
                             f"({int(far.sum())} elements), max abs {worst:.3e}")
    return worst, int(far.sum()), rows


def compare_k1_bf16(torch, dtypes, label):
    """5 updates of K1 with ``dtypes`` = (matmul_dtype, save_dtype), each held
    against its plain version run from the SAME state: before every update
    the plain version is handed a copy of the kernel's state.  Two bfloat16
    trajectories left to themselves part within a few updates without either
    being wrong: both sides multiply bfloat16 values exactly but sum in
    another order, a last-bit difference in a pre-activation flips the
    bfloat16 rounding of a saved activation (2^-8 relative there, a few
    hundred of three million a step), that changes sign(g) for weights
    whose gradient is near 0, and Adam moves those by about lr either way.
    Per update: metrics rtol 2e-4, atol 2e-5; the first moments
    (b1 * m + 0.1 * g, linear in the gradient) as
    assert_first_moments_close says; parameters and targets atol
    2 * 3.2 * lr_t (Adam's largest step, from zero moments, is
    lr_t * 0.1 / sqrt(0.001)) with a mean abs difference under 1e-6.
    Double-Q and single-Q; each update launches launch_sequence(L, bf16 products)
    CUDA kernels.  Returns the largest abs error of the metrics and
    first moments."""
    cfg, worst = FULL, 0.0
    L = len(cfg["widths"]) + 1
    for double_q in (True, False):
        kern, plain, kw = kernel_fns(cfg, double_q, dtypes)
        _, batch, p_kern = make_inputs(cfg, 1234, torch, DEVICE)
        for step in range(5):
            p_plain = [p.clone() for p in p_kern]
            lr_t, eps_t = step_scalars(torch, step, cfg["lr"], DEVICE)
            mk = kern(lr_t, eps_t, *batch, p_kern, **kw)
            want = launch_sequence(L, dtypes[0] == torch.bfloat16)
            if kern.bf16_kernels_per_update != want:
                raise AssertionError(f"{label} launched {kern.bf16_kernels_per_update} CUDA "
                                     f"kernels per update, not {want}")
            mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
            diff = (mk - mp).abs().max().item()
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst_m = n_far = n_rows = 0
            for i in range(4 * L, 6 * L):
                d, far, rows = assert_first_moments_close(
                    torch, p_kern[i], p_plain[i], f"{label} step {step} params8[{i}]")
                worst_m, n_far, n_rows = max(worst_m, d), n_far + far, n_rows + rows
            far_p = mean_p = 0.0
            for a, b in zip(p_kern[:4 * L], p_plain[:4 * L]):
                torch.testing.assert_close(a, b, rtol=0, atol=2 * 3.2 * lr_t.item())
                far_p = max(far_p, (a - b).abs().max().item())
                mean_p = max(mean_p, (a - b).abs().mean().item())
            log(f"  {label} double_q={double_q} step {step}: metrics {mk.flatten().tolist()} "
                f"max abs {diff:.3e}; first moments max abs {worst_m:.3e} ({n_far} outliers in {n_rows} rows); "
                f"parameters max abs {far_p:.3e}, largest mean abs {mean_p:.3e}")
            if mean_p > 1e-6:
                raise AssertionError(f"{label}: parameters part by {mean_p:.3e} on average")
            worst = max(worst, diff, worst_m)
    return worst


def offline_dataset(torch, device):
    """bench.py:293-318's device-resident training table, drawn in its order
    from numpy.random.default_rng(0): TABLE_ROWS rows of D features, A
    actions, every row non-terminal, every action possible."""
    from reagent_tpu_torch.core import types as rlt

    S, A, N = FULL["D"], FULL["A"], TABLE_ROWS
    g = np.random.default_rng(0)
    put = lambda a: torch.tensor(a, device=device)
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(put(g.normal(size=(N, S)).astype(np.float32))),
        next_state=rlt.FeatureData(put(g.normal(size=(N, S)).astype(np.float32))),
        action=put(np.eye(A, dtype=np.float32)[g.integers(0, A, N)]),
        next_action=put(np.eye(A, dtype=np.float32)[g.integers(0, A, N)]),
        reward=put(g.normal(size=(N, 1)).astype(np.float32)),
        time_diff=put(np.ones((N, 1), np.float32)),
        step=put(np.ones((N, 1), np.int32)),
        not_terminal=put(np.ones((N, 1), np.float32)),
        possible_actions_mask=put(np.ones((N, A), np.float32)),
        possible_next_actions_mask=put(np.ones((N, A), np.float32)),
    )


def offline_net(torch, compute_dtype=None):
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN

    cfg = FULL
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    return FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                             activations=[cfg["act"]] * len(cfg["widths"]), **kw)


def fused_offline_trainer(torch, matmul_dtype, device):
    """bench.py:400-406's trainer."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    return FusedDQNTrainer(
        offline_net(torch), RLParameters(gamma=0.99, target_update_rate=0.1),
        optimizer={"Adam": {"lr": 1e-3}}, minibatch_size=FULL["B"], block_size=SCAN_BLOCK,
        matmul_dtype=matmul_dtype, device=device)


def profile_loop(torch, run, n, wall_step_us, label, ported=None):
    """A profiled window of ``n`` steps of ``run()``: device time per step by
    CUDA kernel, launches per step, the gathers' share, the device's idle
    share against the unprofiled wall time per step, and the host reads of
    device values (``aten::_local_scalar_dense``; 0 expected in the loop).
    ``ported``, a dict, receives the device us per step of K3's and K4's
    CUDA kernels (``fused_mlp``, ``nstep``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    launches = sum(r[1] for r in device_us)
    gather_us = sum(us for us, _, key in device_us if "index" in key.lower())
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    reads = counts.get("aten::_local_scalar_dense", 0)
    log(f"  {label} step: {wall_step_us:.1f} us wall (unprofiled), {dev_step:.1f} us of device "
        f"kernels in {launches:.1f} launches (profiled window of {n} steps), gathers "
        f"{gather_us:.1f} us of them: the device is idle "
        f"{(1 - dev_step / wall_step_us) * 100:.1f}% of a step; host reads of device values "
        f"in the window: {reads} (cudaStreamSynchronize: {counts.get('cudaStreamSynchronize', 0)})")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:5]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    if ported is not None:
        for name in ("fused_mlp", "nstep"):
            ported[name] = sum(us for us, _, key in device_us if name in key)
        log(f"    K3 {ported['fused_mlp']:.2f} us, K4 {ported['nstep']:.2f} us of device time a "
            f"step: {ported['fused_mlp'] / wall_step_us * 100:.2f}% and "
            f"{ported['nstep'] / wall_step_us * 100:.2f}% of its wall time")
    if reads:
        raise AssertionError(f"{label}: {reads} host reads of device values inside the loop")
    return dev_step, launches


def td_trend(td):
    """(mean of the first 20 losses, mean of the last 20)."""
    return td[:20].mean().item(), td[-20:].mean().item()


def device_resident_fused_phase(torch, dataset, matmul_dtype, label):
    """bench.py:383-434 on the port: make_packed_sampled_train_fn over the
    table on the card for SCAN_STEPS steps; K1 once per step, no plain
    version, no host read in the loop.  Returns the trainer, its final state,
    the launches by kernel, the steps/s of each scan length and the first
    scan's td_loss per step."""
    trainer = fused_offline_trainer(torch, matmul_dtype, DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    state, _ = trainer.make_packed_sampled_train_fn(dataset, num_steps=3)(state, gen)  # warm up
    reset_counts()
    rates, tds = {}, []
    for n in SCAN_STEPS:
        run = trainer.make_packed_sampled_train_fn(dataset, num_steps=n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = run(state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[n] = n / wall
        td = metrics["td_loss"].cpu()
        if td.shape != (n,) or not torch.isfinite(td).all():
            raise AssertionError(f"{label}: td_loss {td.shape} finite {torch.isfinite(td).all()}")
        tds.append(td)
        del run
    launches, plain_calls = read_counts()
    steps = sum(SCAN_STEPS)
    k1 = counted()["fused_dqn_offline_update"][0]
    if matmul_dtype == torch.bfloat16:
        kernel, per_update = "fused_dqn_offline_update_bf16", k1.bf16_kernels_per_update
    else:
        kernel, per_update = "fused_dqn_offline_update", k1.kernels_per_update
    trends = "; ".join(
        "{} steps: first 20 {:.4f}, last 20 {:.4f}".format(len(td), *td_trend(td)) for td in tds)
    log(f"  {label}: " + ", ".join(f"{n} steps at {r:.2f} steps/s" for n, r in rates.items())
        + f" (host time included, synchronised at the ends only); td_loss over {trends}; "
        f"launches {launches}, plain-version calls {plain_calls}, CUDA kernels per update "
        f"{per_update}")
    other = "fused_dqn_offline_update" if "bf16" in kernel else "fused_dqn_offline_update_bf16"
    if launches[kernel] != steps or launches[other] != 0 or int(state.step) != steps + 3:
        raise AssertionError(f"{label}: {kernel} launched {launches[kernel]} times "
                             f"({other}: {launches[other]}) for {steps} steps")
    if plain_calls:
        raise AssertionError(f"{label}: plain versions ran {plain_calls} times on the main path")
    n = 50
    window = trainer.make_packed_sampled_train_fn(dataset, num_steps=n)
    holder = [state]

    def run_window():
        holder[0], _ = window(holder[0], gen)

    wall_step_us = 1e6 / rates[SCAN_STEPS[-1]]
    profile_loop(torch, run_window, n, wall_step_us, label)
    return trainer, holder[0], launches, rates, tds[0]


def fused_lockstep_against_cpu(torch, dataset, n=5):
    """``n`` train steps of the bf16 trainer on the card (K1 on the tensor
    cores) and on the CPU (the plain version) from one state, on minibatches
    gathered with the same indices (numpy seed).  td_loss per step rtol 1e-3,
    atol 1e-4; first moments after the first step as
    assert_first_moments_close says; final parameters atol 2 * lr per step, mean abs difference under 1e-5
    (compare_k1_bf16 says why)."""
    from reagent_tpu_torch.training import scan_loop

    trainers = {DEVICE: fused_offline_trainer(torch, torch.bfloat16, DEVICE),
                "cpu": fused_offline_trainer(torch, torch.bfloat16, "cpu")}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(3))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(17)
    reset_counts()
    worst_td = worst_m = 0.0
    for step in range(n):
        idx = torch.tensor(rng.integers(0, TABLE_ROWS, FULL["B"]), device=DEVICE)
        batch = scan_loop.tree_map(lambda x: x[idx], dataset)
        td = {}
        for dev, trainer in trainers.items():
            states[dev], m = trainer.train_step(states[dev], batch.to(dev))
            td[dev] = m["td_loss"].cpu()
        torch.testing.assert_close(td[DEVICE], td["cpu"], rtol=5e-3, atol=1e-3)
        worst_td = max(worst_td, (td[DEVICE] - td["cpu"]).abs().item())
        if step == 0:
            for a, b in zip(states[DEVICE].mW + states[DEVICE].mb,
                            states["cpu"].mW + states["cpu"].mb):
                worst_m = max(worst_m, assert_first_moments_close(
                    torch, a.cpu(), b, "lockstep first moments")[0])
    launches, plain_calls = read_counts()
    if (launches["fused_dqn_offline_update_bf16"], plain_calls) != (n, n):
        raise AssertionError(f"lockstep: launches {launches}, plain calls {plain_calls}")
    far = mean = 0.0
    g, c = states[DEVICE], states["cpu"]
    for a, b in zip(g.W + g.b + g.Wt + g.bt, c.W + c.b + c.Wt + c.bt):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2 * 1e-3 * n)
        far = max(far, (a.cpu() - b).abs().max().item())
        mean = max(mean, (a.cpu() - b).abs().mean().item())
    log(f"  card (K1-bf16) vs CPU (plain version), {n} lockstep train steps: td_loss max abs "
        f"{worst_td:.3e} (last {td[DEVICE].item():.6f}), first moments after step 1 max abs "
        f"{worst_m:.3e}, parameters max abs {far:.3e}, largest mean abs {mean:.3e}")
    if mean > 1e-4:
        raise AssertionError(f"lockstep: parameters part by {mean:.3e} on average")
    return worst_td


def q_values_phase(torch, trainer, state, dataset):
    """trainer.q_values on 64 table rows (one K3 launch at [64, 128] -> 512
    -> 256 -> 8) against the exported q-network's own forward: float32 sums
    in another order, rtol 1e-4, atol 1e-4."""
    obs = dataset.state.float_features[:64].contiguous()
    reset_counts()
    q = trainer.q_values(state, obs)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    with torch.no_grad():
        want = trainer.export_q_network(state)(obs)
    diff = (q - want).abs().max().item()
    torch.testing.assert_close(q, want, rtol=1e-4, atol=1e-4)
    if launches["fused_mlp_forward"] != 1 or plain_calls or not torch.isfinite(q).all():
        raise AssertionError(f"q_values: launches {launches}, plain calls {plain_calls}")
    log(f"  q_values (K3) on 64 rows vs the exported q-network: max abs {diff:.3e}, "
        f"q[0] {q[0].tolist()}")
    return launches["fused_mlp_forward"]


def unfused_scan_phase(torch, dataset, compute_dtype, label):
    """bench.py:324-380 on the port: make_sampled_train_fn over a DQNTrainer
    whose net computes in ``compute_dtype``, UNFUSED_STEPS steps on the
    table on the card.  No hand-written kernel is on this path (the matrix
    products are PyTorch's, as the JAX path leaves them to XLA)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.training import DQNTrainer, make_sampled_train_fn

    trainer = DQNTrainer(
        offline_net(torch, compute_dtype), rl=RLParameters(gamma=0.99, target_update_rate=0.1),
        optimizer={"Adam": {"lr": 1e-3}}, device=DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    state, _ = make_sampled_train_fn(trainer, dataset, FULL["B"], 3)(state, gen)  # warm up
    run = make_sampled_train_fn(trainer, dataset, FULL["B"], UNFUSED_STEPS)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = run(state, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = metrics["td_loss"].float().cpu()
    first, last = td_trend(td)
    rate = UNFUSED_STEPS / wall
    log(f"  {label}: {UNFUSED_STEPS} steps at {rate:.2f} steps/s (host time included, "
        f"synchronised at the ends only); td_loss first 20 {first:.4f}, last 20 {last:.4f}; "
        f"hand-written kernel launches {sum(launches.values())}, plain-version calls {plain_calls}")
    if td.shape != (UNFUSED_STEPS,) or not torch.isfinite(td).all():
        raise AssertionError(f"{label}: td_loss {td.shape}")
    if int(state.step) != UNFUSED_STEPS + 3 or plain_calls:
        raise AssertionError(f"{label}: step {int(state.step)}, plain calls {plain_calls}")
    for p in state.q_params.values():
        if p.dtype != torch.float32 or not torch.isfinite(p).all():
            raise AssertionError(f"{label}: parameters {p.dtype}")
    n = 20
    window = make_sampled_train_fn(trainer, dataset, FULL["B"], n)
    profile_loop(torch, lambda: window(state, gen), n, 1e6 / rate, label)
    return rate, td


def compare_td_paths(torch, tds):
    """The fused and the unfused loops start from the same weights (generator
    seed 0) and draw the same minibatch indices (generator seed 1 on the
    card), so over their first UNFUSED_STEPS steps they are one algorithm in
    four arithmetics.  td_loss per step of each against the fused float32
    loop: the float32 autograd trainer within rtol 1e-2 (float32 sums in
    another order, fed back through 200 Adam steps), the two bfloat16 paths
    within rtol 5e-2 (they round at every product)."""
    base = tds["fused f32"][:UNFUSED_STEPS]
    for label, td in tds.items():
        rel = ((td[:UNFUSED_STEPS] - base).abs() / base.abs()).max().item()
        log(f"  td_loss over the first {UNFUSED_STEPS} steps, {label}: first 20 "
            "{:.4f}, last 20 {:.4f}".format(*td_trend(td[:UNFUSED_STEPS]))
            + f", max rel difference from the fused f32 loop {rel:.3e}")
        limit = 5e-2 if "bf16" in label else 1e-2
        if rel > limit:
            raise AssertionError(f"{label}: td_loss parts from the fused f32 loop by {rel:.3e}")


# --------------------------------------------------------------- CPE slice

# reagent_tpu/workflow/sample_configs/discrete_dqn_cartpole_offline.yaml, the
# parts the run reads, as a dict: the machine with the card has no PyYAML
# (tests/test_torch_cpe_workflow.py holds this equal to the file)
SAMPLE_CONFIG = {
    "table_sample": 90.0,
    "eval_table_sample": 10.0,
    "model": {"DiscreteDQN": {
        "trainer_param": {
            "actions": ["0", "1"],
            "rl": {"gamma": 0.99, "target_update_rate": 0.2, "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": 512,
            "optimizer": {"Adam": {"lr": 0.01}},
        },
        "net_builder": {"FullyConnected": {
            "sizes": [128, 64], "activations": ["leaky_relu", "leaky_relu"]}},
        "eval_parameters": {"calc_cpe_in_training": True},
    }},
    "num_epochs": 20,
}
SAMPLE_CPE_ROWS = 4096  # ~410 evaluation rows after the 90/10 split
FULL_CPE_ROWS, FULL_CPE_EPOCHS = 8192, 4  # 4 train steps, ~850 evaluation rows
# K3 at the evaluation's forwards: a batch of the sample config's net (the
# resident route) and a full evaluation batch of the full-width net (streamed)
K3_EVAL_SHAPES = {"[512, 4->128->64->2]": (512, [4, 128, 64, 2]),
                  "[4096, 128->512->256->8]": (4096, [128, 512, 256, 8])}


def full_cpe_model():
    """The full offline width (FULL) on the unfused DQNTrainer with CPE on;
    the CPE heads take the q-network's widths."""
    cfg = FULL
    net = {"FullyConnected": {
        "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"])}}
    return {"DiscreteDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": cfg["gamma"], "target_update_rate": cfg["tau"],
                   "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": {"Adam": {"lr": cfg["lr"]}},
        },
        "net_builder": net,
        "cpe_net_builder": net,
        "eval_parameters": {"calc_cpe_in_training": True},
    }}


def k3_eval_inputs(torch, rows, sizes, seed):
    """Weights as functional.score passes them (W^T views of [out, in]
    tensors, N(0, 2/fan_in)) and ``rows`` normal observations."""
    rng = np.random.default_rng(seed)
    weights = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = torch.tensor((rng.normal(size=(o, i)) * np.sqrt(2.0 / i)).astype(np.float32),
                         device=DEVICE)
        b = torch.tensor((rng.normal(size=o) * 0.1).astype(np.float32), device=DEVICE)
        weights.append((w.T, b))
    x = torch.tensor(rng.normal(size=(rows, sizes[0])).astype(np.float32), device=DEVICE)
    return x, weights, ["leaky_relu"] * (len(sizes) - 2) + ["linear"]


def k3_eval_phase(torch, name):
    """K3 at the evaluation's two shapes against its plain version (rtol
    1e-5, atol 1e-5, as phase 8), each route checked, then CUDA-event
    times of the kernel, the plain version and one torch.addmm per layer (a
    yardstick only) beside the bound."""
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.ops.fused_dqn import _act

    out = {}
    for label, (rows, sizes) in K3_EVAL_SHAPES.items():
        x, weights, acts = k3_eval_inputs(torch, rows, sizes, rows)
        resident = fused_mlp.takes_resident_route(rows, weights)
        if resident != (sizes[1] == 128):
            raise AssertionError(f"K3 {label}: resident route {resident}")
        y = fused_mlp.fused_mlp_forward(x, weights, acts)
        yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        err = (y - yp).abs().max().item()

        def addmm():
            h = x
            for (w, b), a in zip(weights, acts):
                h = _act(a, torch.addmm(b, h, w))
            return h

        torch.testing.assert_close(addmm(), y, rtol=1e-5, atol=1e-5)
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        flops = 2.0 * rows * macs
        nbytes = 4.0 * (rows * sizes[0] + macs + sum(sizes[1:]) + rows * sizes[-1])
        b_ms, b_by = roofline(flops, nbytes, name)
        plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
        t = dict(
            ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts)),
            plain_ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(
                x, plain_w, acts)),
            products_library_ms=time_ms(torch, addmm), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, route="resident" if resident else "streamed")
        log(f"  K3 {label} ({t['route']} route): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, one torch.addmm per layer (a yardstick only) "
            f"{t['products_library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {flops:.4g} "
            f"FLOP, {nbytes:.4g} B), max abs {err:.3e}, on {card_line()}")
        out[label] = t
    return out


def eval_split(df, split):
    from reagent_tpu_torch.data.data_module import (
        TableSpec,
        get_sample_range,
        split_by_sample_range,
    )

    ranges = get_sample_range(TableSpec(**table_split(split)), True)
    return split_by_sample_range(df, ranges.eval_sample_range)


def evaluation_parts(torch, trainer, tstate, batch_pre, eval_df, bs, names):
    """Where ``eval_seconds`` goes, by the host clock, in a run of the
    workflow's evaluation taken apart: decoding the eval split's batches, the
    page's three forwards (K3) with their copies to the host, assembling the
    page, DM/IPS/DR, the padding, seq-DR, WDR and MAGIC (each ends in host
    values, so each time holds its device work)."""
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.evaluation import EvaluationDataPage, Evaluator
    from reagent_tpu_torch.evaluation.torch_sequential_estimators import pad_edp_trajectories

    t = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[key] = time.perf_counter() - t0
        return out

    batches = timed("host decode", lambda: [batch_pre(b) for b in iterate_minibatches(
        eval_df, min(bs, len(eval_df)), drop_last=False)])
    pages = timed("three forwards (K3)", lambda: [
        EvaluationDataPage.create_from_tensors_dqn(
            trainer, tstate, b.extras.mdp_id, b.extras.sequence_number,
            b.state.float_features, b.action,
            torch.clamp(b.extras.action_probability, min=1e-6), b.reward,
            b.possible_actions_mask) for b in batches])

    def assemble():
        edp = pages[0]
        for p in pages[1:]:
            edp = edp.append(p)
        edp = edp.sort().compute_values(trainer.gamma)
        edp.validate()
        return edp

    edp = timed("page assembly", assemble)
    ev = Evaluator(names, trainer.gamma, device=trainer.device)
    np.random.seed(0)
    timed("DM, IPS, DR", lambda: ev.doubly_robust_estimator.estimate(edp))
    padded = timed("padding", lambda: pad_edp_trajectories(edp, trainer.device))
    timed("seq-DR", lambda: ev.sequential_doubly_robust_estimator.estimate_padded(padded))
    wdr = ev.weighted_sequential_doubly_robust_estimator
    timed("WDR", lambda: wdr.estimate_padded(padded, 1, True))
    timed("MAGIC", lambda: wdr.estimate_padded(padded, ev.NUM_J_STEPS_FOR_MAGIC_ESTIMATOR, True))
    return t, tuple(padded.rewards.shape)


def log_estimates(label, details):
    for name in details.reward_estimates._fields:
        e = getattr(details.reward_estimates, name)
        log(f"    {label} {name}: raw {e.raw:.6g} +/- {e.raw_std_error:.4g}, normalized "
            f"{e.normalized:.6g} +/- {e.normalized_std_error:.4g}")
    log(f"    {label} q-value means {details.q_value_means}, stds {details.q_value_stds}, "
        f"action distribution {details.action_distribution}")


def check_details(label, details, names):
    """Every estimate finite and on the normalised branch (rewards in
    (0, 1)), the q-value statistics finite, the action distribution a
    distribution over ``names``."""
    for name in details.reward_estimates._fields:
        e = getattr(details.reward_estimates, name)
        if e is None or not np.isfinite(list(e)).all() or e.normalized == 0.0:
            raise AssertionError(f"{label}: estimate {name} is {e}")
    for stat in (details.q_value_means, details.q_value_stds):
        if list(stat) != names or not np.isfinite(list(stat.values())).all():
            raise AssertionError(f"{label}: q-value statistics {stat}")
    dist = details.action_distribution
    if list(dist) != names or abs(sum(dist.values()) - 1.0) > 1e-9:
        raise AssertionError(f"{label}: action distribution {dist}")


def cpe_workflow_phase(torch, tmp, label, cfg, model, n_rows, epochs, split):
    """identify_and_train_network with CPE on: the unfused DQNTrainer with
    its three heads, then the eval split's page through K3 (three launches
    a batch, no plain version) and the estimators on the card; the
    artifact against the in-process module; eval_seconds taken apart."""
    reset_counts()
    out, df, serving, (trainer, tstate, _), batch_pre, wall = run_workflow(
        cfg, n_rows, epochs, torch, tmp, label, model=model, split=split, rewards="uniform")
    launches, plain_calls = read_counts()
    steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
    eval_s, td = out.logger_data["eval_seconds"], out.training_report.td_loss
    names = model["DiscreteDQN"]["trainer_param"]["actions"]
    bs = model["DiscreteDQN"]["trainer_param"]["minibatch_size"]
    eval_df = eval_split(df, split)
    n_batches = -(-len(eval_df) // min(bs, len(eval_df)))
    log(f"  {label}: {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host "
        f"time included), td_loss {td}; evaluation of {len(eval_df)} rows in {n_batches} "
        f"batch(es): eval_seconds {eval_s:.3f}; whole workflow {wall:.1f} s; launches "
        f"{launches}, plain-version calls {plain_calls}")
    expected = {k: 0 for k in launches}
    expected["fused_mlp_forward"] = 3 * n_batches
    if launches != expected or plain_calls:
        raise AssertionError(f"{label}: launches {launches} (expected {expected}), plain "
                             f"calls {plain_calls}")
    if td is None or not np.isfinite(td) or steps == 0:
        raise AssertionError(f"{label}: td_loss {td} after {steps} steps")
    details = out.training_report.cpe_details
    check_details(label, details, names)
    log_estimates(label, details)
    diff = check_artifact(out, df, serving, torch)
    parts, padded = evaluation_parts(torch, trainer, tstate, batch_pre, eval_df, bs, names)
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"the evaluation taken apart ({padded[0]} episodes padded to {padded[1]} steps), "
        f"seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f}")
    return dict(launches=launches["fused_mlp_forward"], steps=steps, secs=secs,
                eval_seconds=eval_s, parts=parts, trainer=trainer, tstate=tstate,
                batch_pre=batch_pre, eval_df=eval_df, bs=bs, names=names, details=details)


def cpu_twin(trainer):
    """The same DQNTrainer on the CPU: copies of its networks, its RL
    parameters (no optimizer: the twin only scores)."""
    import copy

    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer

    return DQNTrainer(
        copy.deepcopy(trainer.q_network).cpu(), rl=trainer.rl,
        double_q_learning=trainer.double_q_learning,
        reward_network=copy.deepcopy(trainer.reward_network).cpu(),
        q_network_cpe=copy.deepcopy(trainer.q_network_cpe).cpu(), device="cpu")


# the page and estimates, card against CPU: float32 forwards in another
# order (K3's sums against the CPU's), the estimates' float32 device sums
# against the CPU's; MAGIC twice as loose as WDR (its SLSQP).  The target
# policy's propensities are softmax(Q / T) at the configs' temperature
# (RLParameters' 0.01): a propensity moves by up to 2 |dQ| / T of itself,
# 2e-3 for the 1e-5 by which the two sides' Q-values may part
EDP_TOL = dict(rtol=1e-4, atol=1e-5)
PROPENSITY_TOL = dict(rtol=2e-3, atol=1e-6)
EST_TOL = dict(rtol=1e-4, atol=1e-6)
MAGIC_EST_TOL = dict(rtol=2e-4, atol=2e-6)
STD_EST_TOL = dict(rtol=1e-3, atol=1e-6)


def cpe_edp_against_cpu(torch, run, label):
    """The evaluation page and every estimate from one trained state on the
    card and on the CPU (its twin), ``np.random`` seeded alike; argmax
    flips counted where the top two Q-values are within 1e-4."""
    from reagent_tpu_torch.evaluation import Evaluator
    from reagent_tpu_torch.workflow.training import _build_edp

    trainer, bs = run["trainer"], run["bs"]
    twin, state_c = cpu_twin(trainer), copy_state(run["tstate"], "cpu")
    batch_pre = run["batch_pre"]
    reset_counts()
    edp_g = _build_edp(trainer, run["tstate"], batch_pre, run["eval_df"], bs)
    edp_c = _build_edp(twin, state_c, lambda d: batch_pre(d).to("cpu"), run["eval_df"], bs)
    worst = 0.0
    for name in ("optimal_q_values", "model_values", "model_rewards",
                 "model_rewards_for_logged_action", "logged_values"):
        a, b = getattr(edp_g, name), getattr(edp_c, name)
        np.testing.assert_allclose(a, b, **EDP_TOL, err_msg=f"{label} page {name}")
        worst = max(worst, float(np.abs(a - b).max()))
    a, b = edp_g.model_propensities, edp_c.model_propensities
    np.testing.assert_allclose(a, b, **PROPENSITY_TOL, err_msg=f"{label} page propensities")
    above = b >= PROPENSITY_TOL["atol"]
    worst_p = float((np.abs(a - b)[above] / b[above]).max())
    top2 = np.sort(edp_c.optimal_q_values, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    flips = int((edp_g.eval_action_idxs != edp_c.eval_action_idxs).sum())
    np.testing.assert_array_equal(edp_g.eval_action_idxs[clear], edp_c.eval_action_idxs[clear])
    details = {}
    for dev, edp in ((DEVICE, edp_g), ("cpu", edp_c)):
        np.random.seed(5)
        details[dev] = Evaluator(run["names"], trainer.gamma, device=dev).evaluate_post_training(edp)
    worst_est = 0.0
    for name in details["cpu"].reward_estimates._fields:
        g = getattr(details[DEVICE].reward_estimates, name)
        c = getattr(details["cpu"].reward_estimates, name)
        tol = MAGIC_EST_TOL if name == "magic" else EST_TOL
        np.testing.assert_allclose(g[:2], c[:2], **tol, err_msg=f"{label} {name}")
        np.testing.assert_allclose(g[2:], c[2:], **STD_EST_TOL, err_msg=f"{label} {name} std")
        worst_est = max(worst_est, max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(g, c)))
    launches, plain_calls = read_counts()
    log(f"  {label}: page card vs CPU max abs {worst:.3e} (Q-values, rewards, values), "
        f"propensities above 1e-6 max rel {worst_p:.3e}, greedy-action flips {flips} of "
        f"{len(clear)} ({int((~clear).sum())} rows within 1e-4 of a tie); estimates max rel "
        f"{worst_est:.3e}; K3 launches on the card {launches['fused_mlp_forward']}, "
        f"plain-version calls (the CPU side) {plain_calls}")
    return worst, worst_est


def cpe_lockstep_phase(torch, n=5):
    """``n`` DQNTrainer steps with the CPE heads at the full offline width on
    the card and on the CPU from one initial state and the same batches:
    td_loss, reward_loss and cpe_td_loss per step to rtol 1e-4, atol 1e-5
    (as phase 15), the five parameter trees to rtol 1e-3, atol 1e-4.
    Returns the card's trainer and its trained state."""
    import copy

    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.net_builder.discrete_dqn import FullyConnected
    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer

    cfg = FULL
    build = FullyConnected(sizes=cfg["widths"], activations=[cfg["act"]] * len(cfg["widths"]))
    nets = [build.build_q_network(None, cfg["A"], state_dim=cfg["D"]) for _ in range(3)]
    kw = dict(rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
              optimizer={"Adam": {"lr": cfg["lr"]}})
    trainers = {
        "cpu": DQNTrainer(copy.deepcopy(nets[0]), reward_network=copy.deepcopy(nets[1]),
                          q_network_cpe=copy.deepcopy(nets[2]), device="cpu", **kw),
        DEVICE: DQNTrainer(nets[0], reward_network=nets[1], q_network_cpe=nets[2],
                           device=DEVICE, **kw)}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(13))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(17)
    worst = {k: 0.0 for k in ("td_loss", "reward_loss", "cpe_td_loss")}
    for step in range(n):
        _, b, _ = make_inputs(cfg, 700 + step, torch, "cpu")
        obs, nobs, action, _, not_terminal, mask = b
        reward = torch.tensor(rng.uniform(0, 1, (cfg["B"], 1)).astype(np.float32))
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(obs), next_state=rlt.FeatureData(nobs), action=action,
                next_action=action, reward=reward, time_diff=None, step=None,
                not_terminal=not_terminal, possible_actions_mask=torch.ones_like(mask),
                possible_next_actions_mask=mask).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            metrics[dev] = {k: m[k].cpu() for k in worst}
        for k in worst:
            torch.testing.assert_close(metrics[DEVICE][k], metrics["cpu"][k],
                                       rtol=1e-4, atol=1e-5)
            worst[k] = max(worst[k], (metrics[DEVICE][k] - metrics["cpu"][k]).abs().item())
    worst_p = 0.0
    g, c = states[DEVICE], states["cpu"]
    for tree in ("q_params", "q_target_params", "reward_params", "cpe_params",
                 "cpe_target_params"):
        for k, v in getattr(c, tree).items():
            a = getattr(g, tree)[k].cpu()
            torch.testing.assert_close(a, v, rtol=1e-3, atol=1e-4)
            worst_p = max(worst_p, (a - v).abs().max().item())
    log(f"  card vs CPU, {n} lockstep train steps with the CPE heads: max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (last {', '.join(f'{k} {metrics[DEVICE][k].item():.6f}' for k in worst)}); "
        f"the five parameter trees max abs {worst_p:.3e}")
    return trainers[DEVICE], states[DEVICE]

# ------------------------------------------------- batch-RL slice: the e2e job

# The reference's dqn_cartpole_e2e job (tests/test_offline_e2e.py:75-140): the
# flagship sample config with the CI job's overrides; its four reagent run
# commands, called here as functions (tests/test_torch_cli.py holds their
# arguments to the ones reagent run builds from the YAML)
E2E_JOB = dict(env_name="CartPole-v1", num_train_transitions=12000, max_steps=200,
               num_eval_episodes=20, passing_score_bar=120.0)
HOST_PACKAGES = ("gymnasium", "click", "yaml", "tensorboard")


def e2e_overrides(tmp):
    """The job's --extra-options, its files under ``tmp``."""
    return {
        **E2E_JOB,
        "pkl_path": os.path.join(tmp, "pre_timeline.pkl"),
        "input_table_spec": {
            "table_name": "cartpole_offline", "path": os.path.join(tmp, "table.pkl"),
            "table_sample": SAMPLE_CONFIG["table_sample"],
            "eval_table_sample": SAMPLE_CONFIG["eval_table_sample"]},
        "output_dir": os.path.join(tmp, "model"),
        "model_path": os.path.join(tmp, "model", "serving_model"),
        "device": DEVICE,
    }


def e2e_config(tmp):
    """The sample config as reagent run reads it, updated with the overrides."""
    return {"model": SAMPLE_CONFIG["model"], "num_epochs": SAMPLE_CONFIG["num_epochs"],
            **e2e_overrides(tmp)}


def e2e_funcs():
    from reagent_tpu_torch.workflow import gym_batch_rl, training

    return (gym_batch_rl.offline_gym_random, gym_batch_rl.timeline_operator,
            training.identify_and_train_network, gym_batch_rl.evaluate_gym)


def e2e_kwargs(tmp):
    """Each command's keyword arguments, as reagent run builds them."""
    from reagent_tpu_torch.core.configuration import kwargs_from_config

    config = e2e_config(tmp)
    return [kwargs_from_config(f, config) for f in e2e_funcs()]


class HostEnv:
    """One of the port's functional envs on the host behind the ``Gym``
    adapter's interface: a job's env where gymnasium is not installed.  A
    reset draws the state's uniforms from a numpy generator, reseeded by a
    seeded reset."""

    def __init__(self, env):
        self.env = env
        self.rng = np.random.default_rng(0)

    def reset(self, seed=None):
        import torch

        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state, obs = self.env.reset_from_uniform(
            torch.tensor(self.rng.random(self.env.reset_noise_dim), dtype=torch.float32))
        return obs.numpy()

    def step(self, action):
        import torch

        self.state, obs, reward, done = self.env.step(
            self.state, torch.as_tensor(np.asarray(action)))
        return obs.numpy(), float(reward), bool(done)

    def close(self):
        pass


class HostCartPole(HostEnv):
    class action_space:
        n = 2

    def __init__(self, max_steps):
        from reagent_tpu_torch.gym.envs import CartPole

        super().__init__(CartPole(max_steps=max_steps, device="cpu"))


class HostPendulum(HostEnv):
    """Pendulum-v1's box of torques, as ``random_rollouts`` reads it."""

    class action_space:
        low = np.array([-2.0], np.float32)
        high = np.array([2.0], np.float32)

    def __init__(self, max_steps):
        from reagent_tpu_torch.gym.envs import Pendulum

        super().__init__(Pendulum(max_steps=max_steps, device="cpu"))


class RecordingWriter:
    """A summary writer that keeps what it is given (no tensorboard needed)."""

    def __init__(self):
        self.scalars, self.histograms = {}, {}

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.setdefault(tag, []).append((global_step, float(value)))

    def add_histogram(self, tag, values, global_step=None):
        self.histograms.setdefault(tag, []).append((global_step, np.asarray(values).shape))


def reporter_copies(torch, trainer, tstate, batches, reporter):
    """Device-to-host copies per train step, without and with the reporter's
    log (torch.profiler, the CUDA copies), and the reporter's host ms per
    log of a finished step's metrics (no wait on the queue)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for with_reporter in (False, True):
        state = tstate
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for batch in batches:
                state, metrics = trainer.train_step(state, batch)
                if with_reporter:
                    reporter.log(**metrics)
            torch.cuda.synchronize()
        rows, _ = profiled_rows(prof, len(batches))
        counts[with_reporter] = sum(count for _, count, key in rows if "DtoH" in key)
    host_ms = []
    state = tstate
    for batch in batches:
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reporter.log(**metrics)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return counts[False], counts[True], statistics.median(host_ms)


def e2e_phase(torch, tmp):
    """The dqn_cartpole_e2e job on the card: random CartPole rows, the
    timeline operator, the flagship sample config (unfused DQNTrainer with
    its CPE heads, the DiscreteDQNReporter writing to a recording summary
    writer), the artifact, and 20 greedy episodes against the 120 bar.
    gymnasium's CartPole-v1 where it imports, else the port's functional
    CartPole on the host (the same columns, seeded numpy actions)."""
    import inspect

    import pandas as pd

    from reagent_tpu_torch.core.tracker import summary_writer_context
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.workflow import gym_batch_rl

    have = {m: importlib.util.find_spec(m) is not None for m in HOST_PACKAGES}
    log(f"  host packages importable on this machine: {have}")
    collect, timeline, train, evaluate = e2e_kwargs(tmp)
    t0 = time.perf_counter()
    if have["gymnasium"]:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random(**collect)
    else:
        route = "the port's functional CartPole on the host"
        seed = collect.get("seed", inspect.signature(
            gym_batch_rl.offline_gym_random).parameters["seed"].default)
        gym_batch_rl.random_rollouts(
            HostCartPole(collect["max_steps"]), collect["num_train_transitions"], seed,
        ).to_pickle(collect["pkl_path"])
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gym_batch_rl.timeline_operator(**timeline)
    timeline_s = time.perf_counter() - t0
    spec = timeline["input_table_spec"]
    df = pd.read_pickle(spec.path)
    log(f"  env: {route}; {collect['num_train_transitions']} random transitions in "
        f"{collect_s:.2f} s, {df.mdp_id.nunique()} episodes; timeline: {len(df)} rows in "
        f"{timeline_s:.2f} s")

    writer = RecordingWriter()
    reset_counts()
    with capturing_manager(train["model"]) as captured, summary_writer_context(writer):
        out = e2e_funcs()[2](**train)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    bs = train["model"]["DiscreteDQN"]["trainer_param"]["minibatch_size"]
    eval_df = eval_split(df, (spec.table_sample, spec.eval_table_sample))
    n_batches = -(-len(eval_df) // min(bs, len(eval_df)))
    log(f"  {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host time and "
        f"the reporter included), the reporter's log and flush {data['report_seconds']:.3f} s "
        f"({data['report_seconds'] / steps * 1e3:.3f} ms a step, each log waiting for its "
        f"step), td_loss {out.training_report.td_loss}; evaluation of {len(eval_df)} rows in "
        f"{n_batches} batch(es): eval_seconds {data['eval_seconds']:.3f}; launches "
        f"{launches}, plain-version calls {plain_calls}")
    expected = {k: 0 for k in launches}
    expected["fused_mlp_forward"] = 3 * n_batches
    if launches != expected or plain_calls or n_batches == 0:
        raise AssertionError(f"e2e: launches {launches} (expected {expected}), plain calls "
                             f"{plain_calls}")
    tags = (sorted(writer.scalars), sorted(writer.histograms))
    log(f"  summary writer: {len(tags[0])} scalar tags, {len(tags[1])} histogram tags: "
        f"scalars {tags[0]}; histograms {tags[1]}")
    if not ({"actions/logged/0", "actions/logged/1"} <= set(writer.scalars)
            and "td_loss" in writer.histograms):
        raise AssertionError("e2e: the reporter's action counts or td_loss histogram are "
                             "missing")
    details = out.training_report.cpe_details
    dm = details.reward_estimates.direct_method.raw
    if not np.isfinite(dm):
        raise AssertionError(f"e2e: direct method estimate {dm}")
    log_estimates("e2e", details)
    diff = check_artifact(out, df, captured["build_serving_module"], torch)
    trainer, tstate, _ = captured["build_serving_module_args"]
    batches = [captured["build_batch_preprocessor"](b)
               for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(5))]
    bare, reported, log_ms = reporter_copies(torch, trainer, tstate, batches,
                                             captured["get_reporter"])
    log(f"  artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"device-to-host copies a train step (torch.profiler, 5 steps): {bare:.1f} without "
        f"the reporter, {reported:.1f} with it; the reporter's log of a finished step "
        f"{log_ms:.3f} ms on the host (median of 5), on {card_line()}")
    if reported - bare != 1:
        raise AssertionError(f"e2e: the reporter made {reported - bare} copies a step")

    bar = evaluate["passing_score_bar"]
    t0 = time.perf_counter()
    if have["gymnasium"]:
        mean = gym_batch_rl.evaluate_gym(**evaluate)
    else:
        returns = gym_batch_rl.greedy_returns(
            load_predictor(evaluate["model_path"]), HostCartPole(evaluate["max_steps"]),
            evaluate["num_eval_episodes"])
        mean = float(np.mean(returns))
        if not mean >= bar:
            raise AssertionError(f"{mean} <= {bar}, eval failed")
    log(f"  {evaluate['num_eval_episodes']} greedy episodes of at most "
        f"{evaluate['max_steps']} steps ({route}) through load_predictor: mean reward "
        f"{mean:.2f} against the bar {bar} in {time.perf_counter() - t0:.2f} s")
    return dict(launches=launches["fused_mlp_forward"], steps=steps, secs=secs,
                report_seconds=data["report_seconds"], eval_seconds=data["eval_seconds"],
                copies=(bare, reported), log_ms=log_ms, mean_reward=mean, route=route)


# -------------------------------- batch-RL slice: warm start at full width

# two minibatches of 4,096 an epoch, 4 epochs: 8 K1 updates a run
WARM_ROWS, WARM_EPOCHS = 8192, 4
WARM_METRIC_REWARDS = {"ctr": 1.0, "watch": 0.5}


def warm_start_phase(torch, tmp, cpe_trainer, cpe_state):
    """identify_and_train_network twice at the full offline width through
    K1 (fused, block_size set) with a warm-start checkpoint and
    metric-weighted rewards: the saved step doubles, the checkpoint restores
    each run's final state bit for bit on the card, and K1 launches once a
    step.  Then an unfused DQNTrainerState with its five CPE fields (phase
    24's) saved and restored on the card."""
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.utils.checkpointing import (
        flatten_state,
        restore_checkpoint,
        save_checkpoint,
    )
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    def assert_restores(path, template, state, label):
        got, want = flatten_state(restore_checkpoint(path, template)), flatten_state(state)
        for key, w in want.items():
            if not (got[key].device == w.device and torch.equal(got[key], w)):
                raise AssertionError(f"{label}: {key} restored as {got[key].device} "
                                     f"{got[key].dtype}, not bit for bit")
        return len(want)

    cfg = FULL
    table = os.path.join(tmp, "warm_start.pkl")
    make_table(table, WARM_ROWS, cfg["D"], cfg["A"], seed=7, metrics=True)
    model = fused_model(cfg)
    warm = os.path.join(tmp, "warm_start.ckpt")
    reset_counts()
    saved, total_steps = [], 0
    for run in (1, 2):
        with capturing_manager(model) as captured:
            out = identify_and_train_network(
                TableSpec(table_name="warm_start", path=table), model, num_epochs=WARM_EPOCHS,
                output_dir=os.path.join(tmp, f"warm_start_{run}"), warm_start_path=warm,
                reward_options={"metric_reward_values": WARM_METRIC_REWARDS}, device=DEVICE)
        trainer, tstate, _ = captured["build_serving_module_args"]
        n = assert_restores(warm, trainer.init(torch.Generator().manual_seed(run)), tstate,
                            f"warm start run {run}")
        saved.append(int(tstate.step))
        steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
        total_steps += steps
        log(f"  run {run}: {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, "
            f"host time included), td_loss {out.training_report.td_loss}, saved step "
            f"{saved[-1]}; the checkpoint restores its {n} tensors bit for bit on "
            f"{tstate.step.device}")
    launches, plain_calls = read_counts()
    expected = {k: 0 for k in launches}
    expected["fused_dqn_offline_update"] = total_steps
    log(f"  launches {launches}, plain-version calls {plain_calls}")
    if saved[1] != 2 * saved[0] or saved[0] != total_steps // 2 or total_steps != 16:
        raise AssertionError(f"warm start: saved steps {saved} after {total_steps} updates")
    if launches != expected or plain_calls:
        raise AssertionError(f"warm start: launches {launches} (expected {expected}), plain "
                             f"calls {plain_calls}")
    path = os.path.join(tmp, "cpe_state.ckpt")
    save_checkpoint(path, cpe_state)
    n = assert_restores(path, cpe_trainer.init(torch.Generator().manual_seed(1)), cpe_state,
                        "DQNTrainerState with CPE heads")
    log(f"  DQNTrainerState with its five CPE fields (phase 24's, step "
        f"{int(cpe_state.step)}): {n} tensors restored bit for bit on {cpe_state.step.device}")
    return dict(launches=launches["fused_dqn_offline_update"], saved=saved)


# ------------------------------------------- actor-critic slice: SAC and TD3

SAC_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reagent_tpu_torch",
                        "workflow", "sample_configs", "sac_pendulum_offline.yaml")
# the job's depth cuts on the card (PERF.md §4): the rest of the sample
# config (widths, minibatch, optimizers, gamma, tau, seed, the bar) unchanged
SAC_JOB_CUT = dict(num_epochs=10, num_train_transitions=20000, num_eval_episodes=5,
                   max_steps=1000)
AC_STEP_TOL = dict(rtol=1e-4, atol=1e-5)
AC_PARAM_TOL = dict(rtol=1e-3, atol=1e-4)


def sac_sample_config():
    """The sample config as ``reagent run`` reads it."""
    import yaml

    with open(SAC_YAML) as f:
        return yaml.safe_load(f)


def sac_job_overrides(tmp, cut=True):
    """The job's --extra-options: its files under ``tmp``, the depth cuts
    (none where ``cut`` is False: the sample config unchanged), the card."""
    spec = dict(sac_sample_config()["input_table_spec"])
    spec["path"] = os.path.join(tmp, "table.pkl")
    return {
        **(SAC_JOB_CUT if cut else {}),
        "pkl_path": os.path.join(tmp, "pre_timeline.pkl"),
        "input_table_spec": spec,
        "output_dir": os.path.join(tmp, "model"),
        "model_path": os.path.join(tmp, "model", "serving_model"),
        "device": DEVICE,
    }


def reagent_run(entry, overrides):
    """``reagent run <entry> sac_pendulum_offline.yaml --extra-options ...``
    in this process (the port's CLI, click's own parsing)."""
    from reagent_tpu_torch.workflow.cli import reagent

    reagent.main(["run", entry, SAC_YAML, "--extra-options", json.dumps(overrides)],
                 standalone_mode=False)


@contextlib.contextmanager
def recording(module, name):
    """Keep each return of ``module.name`` called in the block."""
    from unittest import mock

    original, results = getattr(module, name), []

    def wrapper(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    with mock.patch.object(module, name, wrapper):
        yield results


def ac_lockstep_trainers(torch, name):
    """The sample config's manager (SAC) or its TD3 twin built twice, on the
    CPU and on the card, for 3 state features and 1 action; the CPU
    trainer's init (seed 12) copied to the card."""
    import copy

    import reagent_tpu_torch.model_managers  # noqa: F401 — registers the managers
    from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationParameters
    from reagent_tpu_torch.core.registry import MODEL_MANAGERS

    model = copy.deepcopy(sac_sample_config()["model"])
    if name == "TD3":
        sac = model.pop("SAC")
        trainer_param = {k: v for k, v in sac["trainer_param"].items()
                         if k != "entropy_temperature"}
        model["TD3"] = dict(trainer_param=trainer_param,
                            actor_net_builder={"FullyConnected": next(iter(
                                sac["actor_net_builder"].values()))},
                            critic_net_builder=sac["critic_net_builder"])
    manager = MODEL_MANAGERS.build(model)
    ndm = {"state": NormalizationData({i: NormalizationParameters(
               "CONTINUOUS", mean=0.0, stddev=1.0) for i in range(3)}),
           "action": NormalizationData({0: NormalizationParameters("DO_NOT_PREPROCESS")})}
    trainers = {dev: manager.build_trainer(ndm, device=dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(12))
    return model, manager, trainers, {dev: copy_state(first, dev) for dev in trainers}


def compare_states(torch, card_state, cpu_state, tol, label):
    """Every state tensor of the card's run against the CPU's: floats within
    ``tol``, integer leaves exactly; returns (count, max abs)."""
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    card, cpu = flatten_state(card_state), flatten_state(cpu_state)
    if card.keys() != cpu.keys():
        raise AssertionError(f"{label}: the states hold other fields")
    worst = 0.0
    for key, want in cpu.items():
        got = card[key].cpu()
        if not want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{label} {key}")
            continue
        torch.testing.assert_close(got, want, **tol, msg=f"{label} {key}")
        worst = max(worst, (got - want).abs().max().item())
    return len(cpu), worst


def ac_lockstep_phase(torch, name, n):
    """``n`` train steps of the sample config's SAC trainer (twin Q,
    autotuned temperature, 64, 64 leaky_relu, minibatch 1024) or of its TD3
    twin on the card and on the CPU from one state, the same batches (3
    state features, actions in [-2, 2] as the Pendulum table logs them) and
    the same explicit noise.  Each step's metrics to rtol 1e-4, atol 1e-5;
    the final parameters, targets, Adam moments and log-alpha to rtol 1e-3,
    atol 1e-4 (float32 sums in another order, cuBLAS against the CPU, which
    Adam turns into steps of about lr wherever a gradient is near 0)."""
    from reagent_tpu_torch.core import types as rlt

    model, manager, trainers, states = ac_lockstep_trainers(torch, name)
    B = next(iter(model.values()))["trainer_param"]["minibatch_size"]
    rng = np.random.default_rng(40)
    reset_counts()
    worst_m, moved = 0.0, []
    for step in range(n):
        cols = dict(s=rng.normal(size=(B, 3)), ns=rng.normal(size=(B, 3)),
                    a=rng.uniform(-2, 2, (B, 1)), r=-rng.uniform(0, 16, (B, 1)),
                    nt=(rng.random((B, 1)) > 0.005))
        noise = rng.normal(size=(2, B, 1) if name == "SAC" else (B, 1))
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.PolicyNetworkInput(
                state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                action=rlt.FeatureData(t["a"]), next_action=rlt.FeatureData(t["a"]),
                reward=t["r"], time_diff=None, step=None, not_terminal=t["nt"]).to(dev)
            before = states[dev].actor_params["net.layers.0.weight"]
            states[dev], m = trainer.train_step(
                states[dev], batch, torch.tensor(noise, dtype=torch.float32, device=dev))
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
            if dev == DEVICE:
                moved.append(not torch.equal(before, states[dev].actor_params[
                    "net.layers.0.weight"]))
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"{name} lockstep: launches {launches}, plain calls {plain_calls}")
    if name == "TD3" and moved != [step % 2 == 0 for step in range(n)]:
        raise AssertionError(f"TD3 lockstep: the actor moved on steps {moved}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {n} lockstep train steps (minibatch {B}): metrics max abs "
        f"{worst_m:.3e} (last q1_loss {metrics[DEVICE]['q1_loss'].item():.6f}, actor_loss "
        f"{metrics[DEVICE]['actor_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; the actor moved on steps {moved}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def sac_job_phase(torch, tmp, cut=True):
    """The reference's sac_pendulum_e2e job on the card through the port's
    ``reagent run`` and the sample config (``cut`` False: unchanged, else
    with ``SAC_JOB_CUT``'s depths): random Pendulum rows (gymnasium where it
    imports, else the port's functional Pendulum on the host), the timeline,
    SAC with its ``ActorCriticReporter``, the actor artifact, greedy
    episodes.  Then steps/s, the host's decode against a train step, CUDA
    kernels and device-to-host copies a step, the device's idle share."""
    import inspect

    import pandas as pd

    from reagent_tpu_torch.core.configuration import kwargs_from_config
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.utils.checkpointing import flatten_state
    from reagent_tpu_torch.workflow import gym_batch_rl, training

    have_gym = importlib.util.find_spec("gymnasium") is not None
    overrides = sac_job_overrides(tmp, cut)
    config = {**sac_sample_config(), **overrides}
    entry = "reagent_tpu_torch.workflow.{}".format
    cuts = {k: config[k] for k in SAC_JOB_CUT}
    log(f"  depth {'cut' if cut else 'unchanged'}: {cuts}; gymnasium importable: {have_gym}")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium Pendulum-v1"
        reagent_run(entry("gym_batch_rl.offline_gym_random"), overrides)
    else:
        route = "the port's functional Pendulum on the host"
        collect = kwargs_from_config(gym_batch_rl.offline_gym_random, config)
        seed = collect.get("seed", inspect.signature(
            gym_batch_rl.offline_gym_random).parameters["seed"].default)
        gym_batch_rl.random_rollouts(
            HostPendulum(collect["max_steps"]), collect["num_train_transitions"], seed,
        ).to_pickle(collect["pkl_path"])
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reagent_run(entry("gym_batch_rl.timeline_operator"), overrides)
    timeline_s = time.perf_counter() - t0
    df = pd.read_pickle(overrides["input_table_spec"]["path"])
    log(f"  env: {route}; {config['num_train_transitions']} random transitions in "
        f"{collect_s:.2f} s, {df.mdp_id.nunique()} episodes; timeline: {len(df)} rows in "
        f"{timeline_s:.2f} s")

    reset_counts()
    with capturing_manager(config["model"]) as captured, \
            recording(training, "train_workflow") as results:
        reagent_run(entry("training.identify_and_train_network"), overrides)
    launches, plain_calls = read_counts()
    out = results[-1]
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    log(f"  {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host decode and "
        f"the reporter included; the reporter {data['report_seconds']:.3f} s), q1_loss "
        f"{out.training_report.td_loss}; K1-K5 launches {sum(launches.values())}, "
        f"plain-version calls {plain_calls} (the actor-critic path has no TPU kernel)")
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"sac job: launches {launches}, plain calls {plain_calls}")
    if not np.isfinite(out.training_report.td_loss):
        raise AssertionError(f"sac job: q1_loss {out.training_report.td_loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving, batch_pre = captured["build_serving_module"], captured["build_batch_preprocessor"]
    finite = {k: bool(torch.isfinite(v).all()) for k, v in flatten_state(tstate).items()
              if v.is_floating_point()}
    if not all(finite.values()) or not np.isfinite(float(tstate.log_alpha)):
        bad = [k for k, f in finite.items() if not f]
        raise AssertionError(f"sac job: non-finite state {bad}")
    bs = config["model"]["SAC"]["trainer_param"]["minibatch_size"]
    frames = [b for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(8))]
    decode_ms, dense_ms = [], []
    for frame in frames:
        t0 = time.perf_counter()
        for col, pre in (("state_features", batch_pre.state_preprocessor),
                         ("next_state_features", batch_pre.state_preprocessor),
                         ("action", batch_pre.action_preprocessor),
                         ("next_action", batch_pre.action_preprocessor)):
            sparse_to_dense(frame[col].tolist(), pre.sorted_features)
        dense_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch_pre(frame)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    batches = [batch_pre(frame) for frame in frames]

    def run(state=tstate):
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        return state

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / len(batches) * 1e6
    dev_us, launches_per_step = profile_loop(torch, run, len(batches), step_us, "SAC train")
    bare, reported, log_ms = reporter_copies(torch, trainer, tstate, batches[:5],
                                             captured["get_reporter"])
    decode = statistics.median(decode_ms)
    log(f"  a train step {step_us / 1e3:.3f} ms ({len(batches)} pre-decoded batches, "
        f"synchronised at the end) beside the host's decode of its {bs}-row batch "
        f"{decode:.3f} ms (median of {len(batches)}; sparse_to_dense's four Python loops "
        f"alone {statistics.median(dense_ms):.3f} ms): decode is "
        f"{decode / (decode + step_us / 1e3) * 100:.1f}% of a decoded step; "
        f"{launches_per_step:.1f} CUDA kernels a step; device-to-host copies a step: "
        f"{bare:.1f} without the reporter, {reported:.1f} with it (log {log_ms:.3f} ms), on "
        f"{card_line()}")
    if bare != 0 or reported != 1:
        raise AssertionError(f"sac job: {bare} copies a step without the reporter, "
                             f"{reported} with it")

    path = config["model_path"]
    predictor = load_predictor(path)
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                       predictor.sorted_features)
    artifact = np.concatenate([predictor.predict(
        {f: float(v) for f, v in zip(predictor.sorted_features, row)}) for row in values])
    live = serving(torch.tensor(values, device=DEVICE),
                   torch.tensor(presence, device=DEVICE)).cpu().numpy()
    diff = float(np.abs(artifact - live).max())
    log(f"  artifact: model_type {predictor.model_type!r}; 64 rows' actions in "
        f"[{artifact.min():.4f}, {artifact.max():.4f}], against the in-process serving "
        f"module max abs {diff:.3e}")
    if predictor.model_type != "actor" or artifact.shape != (64, 1):
        raise AssertionError(f"sac job: artifact {predictor.model_type} {artifact.shape}")
    if not (np.isfinite(artifact).all() and np.abs(artifact).max() <= 2.0):
        raise AssertionError(f"sac job: artifact actions {artifact.min()}, {artifact.max()}")
    np.testing.assert_allclose(artifact, live, atol=1e-4, rtol=0)

    evaluate = kwargs_from_config(gym_batch_rl.evaluate_gym, config)
    bar = evaluate.pop("passing_score_bar")
    t0 = time.perf_counter()
    if have_gym:
        mean = gym_batch_rl.evaluate_gym(**evaluate)
    else:
        mean = float(np.mean(gym_batch_rl.greedy_returns(
            predictor, HostPendulum(evaluate["max_steps"]), evaluate["num_eval_episodes"])))
    eval_seconds = time.perf_counter() - t0
    log(f"  {evaluate['num_eval_episodes']} greedy episodes of {evaluate['max_steps']} steps "
        f"({route}) through load_predictor: eval_seconds {eval_seconds:.2f}, mean reward "
        f"{mean:.2f} "
        f"(the sample config's bar {bar}: {'met' if mean >= bar else 'missed'}"
        f"{'; not held at the cut depth' if cut else ''})")
    if not np.isfinite(mean):
        raise AssertionError(f"sac job: mean reward {mean}")
    return dict(steps=steps, steps_per_s=steps / secs, step_ms=step_us / 1e3,
                decode_ms=decode, device_us=dev_us, launches_per_step=launches_per_step,
                copies=(bare, reported), eval_seconds=eval_seconds, mean_reward=mean,
                bar=bar, route=route)


# ------------------------------------------- discrete-actor slice (PR 13)

# tests/test_gym_all_algos.py:292-323 (discrete_crr_cartpole_online.yaml):
# actor and q1 128, 64 leaky_relu, gamma 0.99, tau 0.2, Adam 3e-3 both, beta
# 1; prefill 3,000 into a ReplayBuffer of 50,000, minibatch 256, 15,000
# steps, bar 100 over 20 greedy episodes of the actor; cut to ``steps`` here
CRR_ONLINE = dict(D=4, A=2, widths=[128, 64], act="leaky_relu", B=256, gamma=0.99, tau=0.2,
                  lr=3e-3, beta=1.0, prefill=3000, capacity=50_000, steps=100,
                  full_steps=15_000, bar=100.0)
# tests/test_offline_managers.py:16-57: 10,000 random CartPole transitions
# (seed 3, episodes of at most 200 steps), a 95/5 split, this model block, 20
# epochs, 20 greedy episodes of the actor artifact against 100; cut here to
# ``epochs``
CRR_OFFLINE = dict(transitions=10_000, max_steps=200, seed=3, split=(95.0, 5.0), epochs=2,
                   full_epochs=20, episodes=20, bar=100.0)
CRR_OFFLINE_MODEL = {"DiscreteCRR": {
    "trainer_param": {"actions": ["0", "1"], "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                      "optimizer": {"Adam": {"lr": 0.003}}, "beta": 1.0},
    "net_builder": {"FullyConnected": {"sizes": [64, 64], "activations": ["relu", "relu"]}},
    "actor_net_builder": {"FullyConnected": {"sizes": [64, 64],
                                             "activations": ["relu", "relu"]}},
}}
# tests/test_policy_gradient_trainers.py:151-213 (discrete_reinforce/ppo_
# cartpole_online.yaml): CartPole episodes of max_steps 200, the bar 180
# over 20 greedy episodes; cut here to ``episodes``
PG_CONFIGS = {
    "REINFORCE": dict(widths=[64, 64], optimizer={"Adam": {"lr": 5e-3}},
                      kw=dict(gamma=0.99, normalize=True, subtract_mean=True),
                      episodes=4, full_episodes=300, bar=180.0),
    "PPO": dict(widths=[32, 32], optimizer={"Adam": {"lr": 1e-3, "weight_decay": 1e-3}},
                kw=dict(gamma=0.99, ppo_epsilon=0.2, update_epochs=1, normalize=True,
                        subtract_mean=True),
                episodes=4, full_episodes=700, bar=180.0),
}
PG_MAX_STEPS = 200


def crr_online_trainer(torch, device):
    """The online CRR trainer (actor and q1 only, as the reference's test)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.discrete_crr_trainer import DiscreteCRRTrainer

    cfg = CRR_ONLINE

    def net():
        return FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                                 activations=[cfg["act"]] * len(cfg["widths"]))

    return DiscreteCRRTrainer(
        actor_network=net(), q1_network=net(),
        rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        q_network_optimizer={"Adam": {"lr": cfg["lr"]}},
        actor_network_optimizer={"Adam": {"lr": cfg["lr"]}}, beta=cfg["beta"], device=device)


def crr_lockstep_phase(torch, n=5):
    """``n`` CRR train steps at the online config's widths on the card and on
    the CPU from one state, on the same numpy batches (CartPole-like states,
    logged actions, rewards of 1, a few terminals): each step's metrics to
    rtol 1e-4, atol 1e-5, every state tensor to rtol 1e-3, atol 1e-4, the
    integer leaves exactly (``AC_STEP_TOL``, ``AC_PARAM_TOL``, as phase 27).
    The trainer's forwards are autograd modules: no K1-K5 launch."""
    from reagent_tpu_torch.core import types as rlt

    cfg = CRR_ONLINE
    trainers = {dev: crr_online_trainer(torch, dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(21))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(22)
    reset_counts()
    worst_m = 0.0
    for _ in range(n):
        B = cfg["B"]
        cols = dict(s=rng.normal(0, 0.5, (B, cfg["D"])), ns=rng.normal(0, 0.5, (B, cfg["D"])),
                    a=np.eye(cfg["A"])[rng.integers(0, cfg["A"], B)], r=np.ones((B, 1)),
                    nt=(rng.random((B, 1)) > 0.05))
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                reward=t["r"], time_diff=None, step=None, not_terminal=t["nt"],
                action=t["a"], next_action=t["a"],
                possible_actions_mask=torch.ones_like(t["a"]),
                possible_next_actions_mask=torch.ones_like(t["a"])).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"CRR lockstep: launches {launches}, plain calls {plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, "CRR")
    log(f"  CRR, card vs CPU, {n} lockstep train steps (minibatch {cfg['B']}, "
        f"{cfg['widths']} {cfg['act']}): metrics max abs {worst_m:.3e} (last q1_loss "
        f"{metrics[DEVICE]['q1_loss'].item():.6f}, actor_loss "
        f"{metrics[DEVICE]['actor_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def crr_offline_job_phase(torch, tmp, epochs):
    """The flow of tests/test_offline_managers.py::test_crr_offline_e2e on
    the card: random CartPole rows (gymnasium where it imports, else the
    port's functional CartPole on the host), the timeline with a 95/5
    split, ``identify_and_train_network`` with the DiscreteCRR block for
    ``epochs`` epochs, the actor artifact against the in-process actor (its
    serving module, and ``actor_logits``, one K3 launch) on 64 raw rows, the
    greedy episodes through ``load_predictor``.  Train steps/s, the host's
    decode of a minibatch, a train step's CUDA kernels and the device's idle
    share (a profiled window), the mean reward (the bar read at 20 epochs
    only)."""
    import pandas as pd

    from reagent_tpu_torch.data.data_module import TableSpec, iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.workflow import gym_batch_rl
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    cfg = CRR_OFFLINE
    have_gym = importlib.util.find_spec("gymnasium") is not None
    pkl, table = os.path.join(tmp, "crr_pre.pkl"), os.path.join(tmp, "crr_table.pkl")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random("CartPole-v1", pkl, cfg["transitions"],
                                        cfg["max_steps"], cfg["seed"])
    else:
        route = "the port's functional CartPole on the host"
        gym_batch_rl.random_rollouts(HostCartPole(cfg["max_steps"]), cfg["transitions"],
                                     cfg["seed"]).to_pickle(pkl)
    spec = TableSpec(table_name="cp", path=table, table_sample=cfg["split"][0],
                     eval_table_sample=cfg["split"][1])
    gym_batch_rl.timeline_operator(pkl, spec)
    df = pd.read_pickle(table)
    log(f"  env: {route}; {cfg['transitions']} random transitions and the timeline in "
        f"{time.perf_counter() - t0:.2f} s, {len(df)} rows")

    reset_counts()
    with capturing_manager(CRR_OFFLINE_MODEL) as captured:
        out = identify_and_train_network(spec, CRR_OFFLINE_MODEL, num_epochs=epochs,
                                         output_dir=os.path.join(tmp, "crr_out"), device=DEVICE)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    log(f"  {steps} CRR train steps ({epochs} epochs) in {secs:.3f} s ({steps / secs:.2f} "
        f"steps/s, host decode and the reporter included), q1_loss "
        f"{out.training_report.td_loss}; eval_seconds {data['eval_seconds']} (no CPE for a "
        f"CRR trainer, as in JAX); K1-K5 launches {sum(launches.values())}, plain calls "
        f"{plain_calls}")
    if any(launches.values()) or plain_calls or out.training_report.cpe_details is not None:
        raise AssertionError(f"CRR job: launches {launches}, plain calls {plain_calls}")
    if not np.isfinite(out.training_report.td_loss):
        raise AssertionError(f"CRR job: q1_loss {out.training_report.td_loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving, batch_pre = captured["build_serving_module"], captured["build_batch_preprocessor"]
    path = out.output_paths["default_model"]
    predictor = load_predictor(path)
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                       predictor.sorted_features)
    artifact = np.concatenate([predictor.predict(
        {f: float(v) for f, v in zip(predictor.sorted_features, row)})[1] for row in values])
    v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
    _, live = serving(v_t, p_t)
    reset_counts()
    k3_logits = trainer.actor_logits(tstate, serving.model.preprocessor(v_t, p_t))
    k3_launches, plain_calls = read_counts()
    live, k3_logits = live.cpu().numpy(), k3_logits.cpu().numpy()
    diff, diff_k3 = (float(np.abs(artifact - x).max()) for x in (live, k3_logits))
    with open(os.path.join(path, "manifest.json")) as f:
        acts = json.load(f)["activations"]
    log(f"  actor artifact: model_type {predictor.model_type!r}, activations {acts}; 64 raw "
        f"rows' logits against the in-process serving module max abs {diff:.3e}, against "
        f"actor_logits (K3, {k3_launches['fused_mlp_forward']} launch) {diff_k3:.3e}")
    if (predictor.model_type != "discrete_dqn" or artifact.shape != (64, 2)
            or k3_launches["fused_mlp_forward"] != 1 or plain_calls):
        raise AssertionError(f"CRR job: artifact {predictor.model_type} {artifact.shape}, "
                             f"K3 {k3_launches}, plain {plain_calls}")
    np.testing.assert_allclose(artifact, live, atol=1e-4, rtol=0)
    np.testing.assert_allclose(artifact, k3_logits, atol=1e-4, rtol=0)

    bs = CRR_OFFLINE_MODEL["DiscreteCRR"]["trainer_param"].get("minibatch_size", 512)
    frames = [b for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(8))]
    decode_ms = []
    for frame in frames:
        t0 = time.perf_counter()
        batch_pre(frame)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    batches = [batch_pre(frame) for frame in frames]

    def run(state=tstate):
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        return state

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / len(batches) * 1e6
    dev_us, kernels = profile_loop(torch, run, len(batches), step_us, "CRR train")
    decode = statistics.median(decode_ms)
    log(f"  a CRR train step {step_us / 1e3:.3f} ms (pre-decoded), the host's decode of its "
        f"{bs}-row batch {decode:.3f} ms (median of {len(frames)}), {kernels:.1f} CUDA kernels "
        f"a step, on {card_line()}")

    t0 = time.perf_counter()
    if have_gym:
        mean = gym_batch_rl.evaluate_gym("CartPole-v1", path, cfg["episodes"],
                                         max_steps=cfg["max_steps"])
    else:
        mean = float(np.mean(gym_batch_rl.greedy_returns(
            predictor, HostCartPole(cfg["max_steps"]), cfg["episodes"])))
    full = epochs == cfg["full_epochs"]
    log(f"  {cfg['episodes']} greedy episodes of at most {cfg['max_steps']} steps ({route}) "
        f"through load_predictor in {time.perf_counter() - t0:.2f} s: mean reward {mean:.2f} "
        f"(the reference's bar {cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'})")
    if not np.isfinite(mean):
        raise AssertionError(f"CRR job: mean reward {mean}")
    return dict(steps=steps, steps_per_s=steps / secs, step_ms=step_us / 1e3, decode_ms=decode,
                device_us=dev_us, kernels_per_step=kernels,
                idle=1 - dev_us / step_us, mean_reward=mean, bar=cfg["bar"], epochs=epochs,
                k3_launches=k3_launches["fused_mlp_forward"], route=route)


def crr_online_phase(torch, steps):
    """Online CRR through the generic loop (``run_online_training``), as the
    reference's test runs it: a ReplayBuffer of 50,000 prefilled with 3,000
    random transitions, the actor's softmax acting through K3, one sample
    (K4) and one CRR update a step, minibatch 256; then a profiled window of
    10 steps (CUDA kernels a step, the device's idle share, host reads) and
    evaluate_policy over 20 greedy episodes of the actor through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    cfg = CRR_ONLINE
    env = CartPole(max_steps=200, device=DEVICE)
    trainer = crr_online_trainer(torch, DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=cfg["capacity"], update_horizon=1, gamma=cfg["gamma"],
                      device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, cfg["prefill"])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sampler = SoftmaxActionSampler(temperature=1.0)

    def policy_act(ts, obs, g):
        out = sampler.sample_action(trainer.actor_logits(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(trainer.actor_logits(ts, obs), dim=1).to(torch.int32)

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act,
            lambda d: make_discrete_dqn_batch(d, cfg["A"]), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=cfg["B"]))

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  online CRR: prefill {cfg['prefill']} in {prefill_s:.2f} s; {steps} env steps + "
        f"{steps} updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last q1_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"online CRR: {kernel} launched {launches[kernel]} times for "
                                 f"{steps} steps")
    if plain_calls or losses.shape != (steps,) or not torch.isfinite(losses).all():
        raise AssertionError(f"online CRR: plain calls {plain_calls}, losses {losses.shape}")
    n = 10
    ported = {}
    dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                   wall / steps * 1e6, "online CRR", ported)
    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = steps == cfg["full_steps"]
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes of the actor in "
        f"{time.perf_counter() - t0:.2f} s, mean {mean:.2f} (the reference's bar "
        f"{cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"online CRR eval: launches {eval_launches}, plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, steps=steps,
                steps_per_s=steps / wall, device_us=dev_us, kernels_per_step=kernels,
                k3_us=ported["fused_mlp"], k4_us=ported["nstep"],
                idle=1 - dev_us / (wall / steps * 1e6), mean_reward=mean, bar=cfg["bar"])


def pg_trainer(torch, name, device):
    """The reference config's REINFORCE or PPO trainer on ``device``."""
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.ppo_trainer import PPOTrainer
    from reagent_tpu_torch.training.reinforce_trainer import ReinforceTrainer

    cfg = PG_CONFIGS[name]
    net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=cfg["widths"],
                            activations=["leaky_relu"] * len(cfg["widths"]))
    cls = ReinforceTrainer if name == "REINFORCE" else PPOTrainer
    return cls(scorer=net, sampler=SoftmaxActionSampler(temperature=1.0),
               optimizer=cfg["optimizer"], device=device, **cfg["kw"])


def act_log_prob_err(torch, trainer, state, ep):
    """The episode's log-probs, each from one K3 launch at [1, 4], against
    the sampler's log-probs of K3's plain version's scores for the same
    observations, parameters and actions: rtol 1e-5, atol 1e-5 (float32
    sums in another order).  Max abs."""
    from reagent_tpu_torch.ops import fused_mlp

    net, params = trainer.scorer, state.policy_params
    weights = [(params[f"net.layers.{i}.weight"].T, params[f"net.layers.{i}.bias"])
               for i in range(len(net.net.layers))]
    scores = fused_mlp.fused_mlp_forward_reference(ep.state.float_features, weights,
                                                   net.activations)
    want = trainer.sampler.log_prob(scores, ep.action)
    torch.testing.assert_close(ep.log_prob, want, rtol=1e-5, atol=1e-5, msg="act log-probs")
    return (ep.log_prob - want).abs().max().item()


def pg_lockstep_phase(torch, name, episodes=3):
    """``episodes`` episodes of collection and training with the config's
    trainer on the card and on the CPU from one state and one noise tape
    (numpy reset uniforms and gumbel draws): actions, alive masks and
    returns exactly, each step's losses to rtol 1e-4, atol 1e-5, every state
    tensor to rtol 1e-3, atol 1e-4 (``AC_STEP_TOL``, ``AC_PARAM_TOL``).  The
    card's act steps are K3 launches, the CPU's K3's plain version: the
    card's log-probs are held to the plain version's on the card's own
    parameters (``act_log_prob_err``) and, in the first episode, where both
    sides start from one state, to the CPU's, each at rtol 1e-5, atol 1e-5."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.episodic import collect_episode
    from reagent_tpu_torch.gym.policies import discrete_q_scorer

    trainers = {dev: pg_trainer(torch, name, dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(31))
    states = {dev: copy_state(first, dev) for dev in trainers}
    envs = {dev: CartPole(max_steps=PG_MAX_STEPS, device=dev) for dev in trainers}
    rng = np.random.default_rng(32)
    worst_m, worst_lp, returns = 0.0, 0.0, []
    launches = plain_calls = None
    for episode in range(episodes):
        u = rng.random(4).astype(np.float32)
        g = -np.log(-np.log(np.maximum(rng.random((PG_MAX_STEPS, 2)), 1e-30))).astype(np.float32)
        out = {}
        for dev, trainer in trainers.items():
            noise = (torch.tensor(u, device=dev), torch.tensor(g, device=dev))
            if dev == DEVICE:
                reset_counts()
            ep, ret = collect_episode(envs[dev], discrete_q_scorer(trainer.scorer),
                                      trainer.sampler, states[dev].policy_params,
                                      PG_MAX_STEPS, noise=noise)
            if dev == DEVICE:
                launches, plain_calls = read_counts()
                worst_lp = max(worst_lp, act_log_prob_err(torch, trainer, states[dev], ep))
            states[dev], m = trainer.train_step(states[dev], ep)
            out[dev] = (ep.to("cpu"), float(ret), {k: v.cpu() for k, v in m.items()})
        (ep_c, ret_c, m_c), (ep_g, ret_g, m_g) = out["cpu"], out[DEVICE]
        torch.testing.assert_close(ep_g.action, ep_c.action, rtol=0, atol=0, msg="actions")
        torch.testing.assert_close(ep_g.valid_mask, ep_c.valid_mask, rtol=0, atol=0,
                                   msg="alive mask")
        if ret_g != ret_c:
            raise AssertionError(f"{name}: returns {ret_g} on the card, {ret_c} on the CPU")
        if episode == 0:
            torch.testing.assert_close(ep_g.log_prob, ep_c.log_prob, rtol=1e-5, atol=1e-5,
                                       msg="first episode's log-probs, card vs CPU")
            worst_lp = max(worst_lp, (ep_g.log_prob - ep_c.log_prob).abs().max().item())
        for k, want in m_c.items():
            torch.testing.assert_close(m_g[k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (m_g[k] - want).abs().item())
        returns.append(ret_g)
        if launches["fused_mlp_forward"] != PG_MAX_STEPS or plain_calls:
            raise AssertionError(f"{name}: an episode's launches {launches}, plain "
                                 f"{plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {episodes} episodes from one noise tape: returns {returns} "
        f"on both, actions and alive masks equal; act log-probs (K3) max abs {worst_lp:.3e}; "
        f"metrics max abs {worst_m:.3e}; {count} state "
        f"tensors max abs {worst_p:.3e}; K3 {PG_MAX_STEPS} launches an episode")
    return worst_m, worst_p


def pg_run_phase(torch, name, episodes):
    """``episodes`` episodes of the config (each collected with the current
    policy through K3 and trained on), then a profiled episode and update
    (CUDA kernels, the device's idle share, host reads: 0 or the script
    fails) and evaluate_policy over 20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.episodic import make_episodic_trainer_step
    from reagent_tpu_torch.gym.online_loop import evaluate_policy
    from reagent_tpu_torch.gym.policies import discrete_q_scorer

    cfg = PG_CONFIGS[name]
    trainer = pg_trainer(torch, name, DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    env = CartPole(max_steps=PG_MAX_STEPS, device=DEVICE)
    greedy = discrete_q_scorer(trainer.scorer)
    step = make_episodic_trainer_step(env, greedy, trainer.sampler, trainer, PG_MAX_STEPS)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets = []
    for _ in range(episodes):
        state, ret, _ = step(state, gen)
        rets.append(ret)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    rets = torch.stack(rets).cpu()
    per_episode = launches["fused_mlp_forward"] / episodes
    log(f"  {name}: {episodes} episodes of {PG_MAX_STEPS} steps (padded) and updates in "
        f"{wall:.3f} s = {episodes / wall:.2f} episodes/s, {episodes * PG_MAX_STEPS / wall:.1f} "
        f"env steps/s ({int(rets.sum())} of them alive), returns first {rets[:3].tolist()} "
        f"last {rets[-3:].tolist()}; K3 {per_episode:.1f} launches an episode, plain calls "
        f"{plain_calls}")
    if per_episode != PG_MAX_STEPS or plain_calls or any(
            v for k, v in launches.items() if k != "fused_mlp_forward"):
        raise AssertionError(f"{name}: launches {launches}, plain calls {plain_calls}")

    state_p, ported = state, {}
    dev_us, kernels = profile_loop(torch, lambda: step(state_p, gen), 1, wall / episodes * 1e6,
                                   f"{name} episode", ported)
    def greedy_act(ts, obs, g):
        return torch.argmax(greedy(ts.policy_params, obs), dim=1).to(torch.int32)

    reset_counts()
    returns = evaluate_policy(env, greedy_act, state, torch.Generator(device=DEVICE)
                              .manual_seed(2), num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = episodes == cfg["full_episodes"]
    log(f"  {name} evaluate_policy: {EVAL_EPISODES} greedy episodes, mean {mean:.2f} (the "
        f"reference's bar {cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"{name} eval: launches {eval_launches}, plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, episodes=episodes,
                episodes_per_s=episodes / wall, env_steps_per_s=episodes * PG_MAX_STEPS / wall,
                k3_per_episode=per_episode, device_us=dev_us, kernels_per_episode=kernels,
                k3_us=ported["fused_mlp"],
                idle=1 - dev_us / (wall / episodes * 1e6), mean_reward=mean, bar=cfg["bar"])


# ---------------------------------- the rest of the DQN family: C51, parametric

# tests/test_gym_all_algos.py:76-94 (discrete_c51_cartpole_online.yaml): 128,
# 64 leaky_relu, 51 atoms on 0..200, gamma 0.99, tau 0.2, Adam 3e-3; prefill
# 3,000 into a ReplayBuffer of 50,000, minibatch 256, 15,000 steps; and
# :120-147, :261-288 (parametric_dqn / parametric_sarsa_cartpole_online.yaml):
# a critic 128, 64 leaky_relu over (state, one-hot action), gamma 0.99, tau
# 0.1, Adam 1e-3 with amsgrad, prefill 10,000, minibatch 512, 20,000 steps;
# each bar 100 over 20 greedy episodes.  Cut here to ``prefill`` and ``steps``.
DQN_FAMILY_ONLINE = {
    "C51": dict(widths=[128, 64], act="leaky_relu", atoms=51, qmin=0, qmax=200, B=256,
                gamma=0.99, tau=0.2, optimizer={"Adam": {"lr": 0.003}}, maxq=True,
                prefill=1000, full_prefill=3000, steps=150, full_steps=15_000),
    "parametric DQN": dict(widths=[128, 64], act="leaky_relu", B=512, gamma=0.99, tau=0.1,
                           optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, maxq=True,
                           prefill=1000, full_prefill=10_000, steps=150, full_steps=20_000),
    "parametric SARSA": dict(widths=[128, 64], act="leaky_relu", B=512, gamma=0.99, tau=0.1,
                             optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, maxq=False,
                             prefill=1000, full_prefill=10_000, steps=150, full_steps=20_000),
}
DQN_FAMILY_CAPACITY, DQN_FAMILY_BAR = 50_000, 100.0
# the offline managers at the JAX tests' configs: tests/test_model_managers_all.py:
# 75-96 (3,000 random CartPole transitions, seed 11, a 95/5 split, 2 epochs)
# and tests/test_offline_managers.py:59-75 (10,000, seed 3, 95/5, 10 epochs);
# cut here to ``epochs``
DQN_FAMILY_OFFLINE = {
    "C51": dict(transitions=3000, seed=11, epochs=2, full_epochs=2, model={"DiscreteC51DQN": {
        "trainer_param": {"actions": ["0", "1"],
                          "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                          "optimizer": {"Adam": {"lr": 0.002}}, "minibatch_size": 512},
        "net_builder": {"Categorical": {"sizes": [64, 64], "activations": ["relu", "relu"],
                                        "num_atoms": 21, "qmin": 0.0, "qmax": 200.0}}}}),
    "parametric DQN": dict(transitions=10_000, seed=3, epochs=2, full_epochs=10,
                           model={"ParametricDQN": {
                               "trainer_param": {
                                   "actions": ["0", "1"],
                                   "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                                   "optimizer": {"Adam": {"lr": 0.003}}},
                               "net_builder": {"FullyConnected": {
                                   "sizes": [64, 64], "activations": ["relu", "relu"]}}}}),
}
# K3's forwards on these paths: the act step and evaluate_policy of C51
# (4 -> 128 -> 64 -> A * N logits) and of the parametric scorer (each state
# tiled against both one-hot actions: 6 -> 128 -> 64 -> 1); K4 at C51's
# minibatch (the parametric loops sample at K4_SHAPES["loop"])
K3_FAMILY_SHAPES = {
    "C51 act [1, 4->128->64->102]": (1, [4, 128, 64, 102]),
    "C51 eval [20, 4->128->64->102]": (EVAL_EPISODES, [4, 128, 64, 102]),
    "parametric act [2, 6->128->64->1]": (2, [6, 128, 64, 1]),
    "parametric eval [40, 6->128->64->1]": (2 * EVAL_EPISODES, [6, 128, 64, 1]),
}
K4_FAMILY_SHAPE = ("C51 loop", (50_000, 256, 1))  # capacity, B, H


def dqn_family_trainer(torch, name, device):
    """The online job's trainer, and its scorer ``(state, obs [B, 4]) -> Q
    [B, 2]`` (E[Z] of C51's distributions; the parametric scorer's tiled
    rows), each one K3 launch on the card."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
    from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
    from reagent_tpu_torch.models.critic import FullyConnectedCritic
    from reagent_tpu_torch.training.c51_trainer import C51Trainer
    from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainer

    cfg = DQN_FAMILY_ONLINE[name]
    acts = [cfg["act"]] * len(cfg["widths"])
    rl = RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"],
                      maxq_learning=cfg["maxq"])
    if name == "C51":
        net = CategoricalDQN(state_dim=4, action_dim=2, num_atoms=cfg["atoms"], qmin=cfg["qmin"],
                             qmax=cfg["qmax"], sizes=cfg["widths"], activations=acts)
        trainer = C51Trainer(net, rl=rl, optimizer=cfg["optimizer"], device=device)
        return trainer, trainer.q_values
    net = FullyConnectedCritic(state_dim=4, action_dim=2, sizes=cfg["widths"], activations=acts)
    trainer = ParametricDQNTrainer(net, rl=rl, optimizer=cfg["optimizer"], device=device)
    scorer = parametric_dqn_scorer(2, trainer.q_network)
    return trainer, lambda ts, obs: scorer(ts.q_params, obs)


def dqn_family_batch(torch, name, cols, device):
    """One numpy-made batch of CartPole-like rows as the job's batch type."""
    from reagent_tpu_torch.core import types as rlt

    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
    ones = torch.ones_like(t["a"])
    common = dict(state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                  reward=t["r"], time_diff=torch.ones_like(t["r"]), step=None,
                  not_terminal=t["nt"])
    if name == "C51":
        batch = rlt.DiscreteDqnInput(action=t["a"], next_action=t["na"],
                                     possible_actions_mask=ones,
                                     possible_next_actions_mask=ones, **common)
    else:
        tiled = rlt.FeatureData(torch.eye(2).repeat(t["a"].shape[0], 1))
        batch = rlt.ParametricDqnInput(
            action=rlt.FeatureData(t["a"]), next_action=rlt.FeatureData(t["na"]),
            possible_actions=tiled, possible_actions_mask=ones, possible_next_actions=tiled,
            possible_next_actions_mask=ones, **common)
    return batch.to(device)


def dqn_family_lockstep_phase(torch, name, n=5):
    """``n`` train steps of the online job's trainer at its widths and
    minibatch on the card and on the CPU from one state, on the same numpy
    batches (CartPole-like states, logged actions and next actions, rewards
    of 1, a few terminals): each step's metrics to rtol 1e-4, atol 1e-5,
    every state tensor to rtol 1e-3, atol 1e-4, the integer leaves exactly
    (``AC_STEP_TOL``, ``AC_PARAM_TOL``, as phases 27 and 29).  The train
    steps' forwards are autograd modules: no K1-K5 launch."""
    cfg = DQN_FAMILY_ONLINE[name]
    trainers = {dev: dqn_family_trainer(torch, name, dev)[0] for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(31))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(32)
    reset_counts()
    worst_m = 0.0
    for _ in range(n):
        B = cfg["B"]
        cols = dict(s=rng.normal(0, 0.5, (B, 4)), ns=rng.normal(0, 0.5, (B, 4)),
                    a=np.eye(2)[rng.integers(0, 2, B)], na=np.eye(2)[rng.integers(0, 2, B)],
                    r=np.ones((B, 1)), nt=(rng.random((B, 1)) > 0.05))
        metrics = {}
        for dev, trainer in trainers.items():
            states[dev], m = trainer.train_step(
                states[dev], dqn_family_batch(torch, name, cols, dev))
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"{name} lockstep: launches {launches}, plain calls {plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {n} train steps (minibatch {cfg['B']}, {cfg['widths']} "
        f"{cfg['act']}): metrics max abs {worst_m:.3e} (last td_loss "
        f"{metrics[DEVICE]['td_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def k3_k4_family_phase(torch, name, launch_floor_ms):
    """K3 at the new paths' four shapes against its plain version (rtol
    1e-5, atol 1e-5, as phase 8; the resident route each time: the largest
    net is 61 KB) and K4 at C51's minibatch (exact), each timed with CUDA
    events (3 warm-ups, median of 20) beside the launch floor and the bound
    from this run's inputs; ``{"K3": {shape: times}, "K4": {...}}``."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {"K3": {}, "K4": {}}
    for label, (rows, sizes) in K3_FAMILY_SHAPES.items():
        x, weights, acts = k3_eval_inputs(torch, rows, sizes, 50 + rows)
        if not fused_mlp.takes_resident_route(rows, weights):
            raise AssertionError(f"K3 {label}: not on the resident route")
        y = fused_mlp.fused_mlp_forward(x, weights, acts)
        yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        flops = 2.0 * rows * macs
        nbytes = 4.0 * (rows * sizes[0] + macs + sum(sizes[1:]) + rows * sizes[-1])
        b_ms, b_by = roofline(flops, nbytes, name)
        plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
        out["K3"][label] = t = dict(
            ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts)),
            plain_ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(
                x, plain_w, acts)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=(y - yp).abs().max().item(),
            route="resident")
        log(f"  K3 {label} (resident route): kernel {t['ms']:.4f} ms (launch floor "
            f"{launch_floor_ms:.4f}), plain {t['plain_ms']:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), max abs {t['max_abs_err']:.3e}, "
            f"on {card_line()}")
    label, (capacity, B, H) = K4_FAMILY_SHAPE
    rewards, terminals, idx = k4_inputs(torch, capacity, B, 7)
    got = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)
    for a, b in zip(got, nstep_replay.nstep_rewards_reference(rewards, terminals, idx, H, 0.99)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    walked = int(got[1].sum())  # this run's windows, as far as each is read
    flops, nbytes = 2.0 * walked, 8.0 * B + 5.0 * walked + 9.0 * B
    b_ms, b_by = roofline(flops, nbytes, name)
    out["K4"][label] = t = dict(
        ms=time_ms(torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)),
        plain_ms=time_ms(torch, lambda: nstep_replay.nstep_rewards_reference(
            rewards, terminals, idx, H, 0.99)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
    log(f"  K4 {label} (capacity {capacity}, B {B}, H {H}): exact; kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, bound {b_ms:.7f} ms ({b_by}), on {card_line()}")
    return out


def dqn_family_online_phase(torch, name, steps, prefill):
    """One online job through the generic loop (``run_online_training``), as
    the reference's test runs it: a ReplayBuffer of 50,000 prefilled with
    ``prefill`` random transitions, softmax acting on the scorer (K3), one
    sample (K4) and one update a step; then a profiled window of 10 steps
    (CUDA kernels a step, the device's idle share, host reads: 0 or the
    script fails) and evaluate_policy over 20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import (
        make_discrete_dqn_batch,
        make_parametric_dqn_batch,
    )
    from reagent_tpu_torch.replay import ReplayBuffer

    cfg = DQN_FAMILY_ONLINE[name]
    env = CartPole(max_steps=200, device=DEVICE)
    trainer, q_values = dqn_family_trainer(torch, name, DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=DQN_FAMILY_CAPACITY, update_horizon=1,
                      gamma=cfg["gamma"], device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, prefill)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sampler = SoftmaxActionSampler(temperature=1.0)
    make_batch = make_discrete_dqn_batch if name == "C51" else make_parametric_dqn_batch

    def policy_act(ts, obs, g):
        out = sampler.sample_action(q_values(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(q_values(ts, obs), dim=1).to(torch.int32)

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act, lambda d: make_batch(d, 2), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=cfg["B"]))

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  online {name}: prefill {prefill} in {prefill_s:.2f} s; {steps} env steps + "
        f"{steps} updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last td_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"online {name}: {kernel} launched {launches[kernel]} times "
                                 f"for {steps} steps")
    others = {k: v for k, v in launches.items() if k not in ("nstep_rewards", "fused_mlp_forward")}
    if (any(others.values()) or plain_calls or losses.shape != (steps,)
            or not torch.isfinite(losses).all()):
        raise AssertionError(f"online {name}: launches {others}, plain calls {plain_calls}, "
                             f"losses {losses.shape}")
    n = 10
    ported = {}
    dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                   wall / steps * 1e6, f"online {name}", ported)
    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = steps == cfg["full_steps"]
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes in {time.perf_counter() - t0:.2f} "
        f"s, mean {mean:.2f} (the reference's bar {DQN_FAMILY_BAR}: "
        f"{'met' if mean >= DQN_FAMILY_BAR else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"online {name} eval: launches {eval_launches}, "
                             f"plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, steps=steps,
                steps_per_s=steps / wall, device_us=dev_us, kernels_per_step=kernels,
                k3_us=ported["fused_mlp"], k4_us=ported["nstep"],
                idle=1 - dev_us / (wall / steps * 1e6), mean_reward=mean, bar=DQN_FAMILY_BAR)


def dqn_family_offline_phase(torch, tmp, name, epochs):
    """One offline manager at the JAX test's config: random CartPole rows
    (gymnasium where it imports, else the port's functional CartPole on the
    host), the timeline with a 95/5 split, ``identify_and_train_network``
    for ``epochs`` epochs; train steps/s (host decode and the reporter
    included) and the finite ``td_loss``.  C51: the artifact's ``model.pt``
    against the in-process serving module and against ``q_values`` (one K3
    launch) on 64 raw rows, within 1e-4.  ParametricDQN: ``default_model`` is
    ``""`` (no artifact, as in JAX), and the in-process serving module
    against the parametric scorer (one K3 launch) on the same rows."""
    import pandas as pd

    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
    from reagent_tpu_torch.prediction.predictor_wrapper import CategoricalDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.workflow import gym_batch_rl
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    cfg = DQN_FAMILY_OFFLINE[name]
    have_gym = importlib.util.find_spec("gymnasium") is not None
    tag = name.replace(" ", "_")
    pkl, table = os.path.join(tmp, f"{tag}_pre.pkl"), os.path.join(tmp, f"{tag}_table.pkl")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random("CartPole-v1", pkl, cfg["transitions"], 200, cfg["seed"])
    else:
        route = "the port's functional CartPole on the host"
        gym_batch_rl.random_rollouts(HostCartPole(200), cfg["transitions"],
                                     cfg["seed"]).to_pickle(pkl)
    spec = TableSpec(table_name=tag, path=table, table_sample=95.0, eval_table_sample=5.0)
    gym_batch_rl.timeline_operator(pkl, spec)
    df = pd.read_pickle(table)
    log(f"  {name} env: {route}; {cfg['transitions']} random transitions and the timeline in "
        f"{time.perf_counter() - t0:.2f} s, {len(df)} rows")

    reset_counts()
    with capturing_manager(cfg["model"]) as captured:
        out = identify_and_train_network(spec, cfg["model"], num_epochs=epochs,
                                         output_dir=os.path.join(tmp, f"{tag}_out"),
                                         device=DEVICE)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs, loss = data["train_steps"], data["train_seconds"], out.training_report.td_loss
    log(f"  offline {name}: {steps} train steps ({epochs} of the test's {cfg['full_epochs']} "
        f"epochs) in {secs:.3f} s = {steps / secs:.2f} steps/s (host decode and the reporter "
        f"included), td_loss {loss:.6g}; K1-K5 launches {sum(launches.values())}, plain calls "
        f"{plain_calls}, on {card_line()}")
    if (any(launches.values()) or plain_calls or not np.isfinite(loss)
            or out.training_report.cpe_details is not None):
        raise AssertionError(f"offline {name}: launches {launches}, plain {plain_calls}, "
                             f"td_loss {loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving = captured["build_serving_module"]
    path = out.output_paths["default_model"]
    if name == "C51":
        pre = serving.preprocessor
        values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                           pre.sorted_features)
        names, served = CategoricalDqnPredictorWrapper.load(path)(values, presence)
        v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
        live = serving(v_t, p_t)[1]
        reset_counts()
        k3 = trainer.q_values(tstate, pre(v_t, p_t))
    else:
        if path != "":
            raise AssertionError(f"offline {name}: default_model {path!r}, not ''")
        pre = serving.model.state_preprocessor
        values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                           pre.sorted_features)
        v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
        eye = torch.eye(2, device=DEVICE).repeat(64, 1)
        names, live = serving(v_t.repeat_interleave(2, 0), p_t.repeat_interleave(2, 0), eye,
                              torch.ones_like(eye))
        live = live.reshape(64, 2)
        served = live.cpu().numpy()
        reset_counts()
        k3 = parametric_dqn_scorer(2, trainer.q_network)(tstate.q_params, pre(v_t, p_t))
    k3_launches, plain_calls = read_counts()
    live, k3 = live.cpu().numpy(), k3.cpu().numpy()
    diff, diff_k3 = (float(np.abs(served - x).max()) for x in (live, k3))
    log(f"  {name} serving: default_model {path!r}, names {names}; 64 raw rows' Q "
        f"({'the artifact' if path else 'in process'}) against the in-process module max "
        f"abs {diff:.3e}, against the trainer's forward through K3 "
        f"({k3_launches['fused_mlp_forward']} launch) {diff_k3:.3e}")
    if served.shape != (64, 2) or k3_launches["fused_mlp_forward"] != 1 or plain_calls:
        raise AssertionError(f"offline {name}: Q {served.shape}, K3 {k3_launches}, plain "
                             f"{plain_calls}")
    np.testing.assert_allclose(served, live, atol=1e-4, rtol=0)
    np.testing.assert_allclose(served, k3, atol=1e-4, rtol=0)
    return dict(steps=steps, steps_per_s=steps / secs, td_loss=loss, epochs=epochs,
                k3_launches=k3_launches["fused_mlp_forward"], route=route,
                default_model=path, artifact_err=diff, k3_err=diff_k3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from reagent_tpu_torch.ops import _build, fused_dqn, fused_dqn_offline  # noqa: F401

    # Comparisons and timings in full float32: no TF32 in the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("phase 1: device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    phase("phase 2: build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    for lib in ("fused_dqn", "fused_mlp", "nstep_replay", "quantile_huber"):
        _build.load_library(lib)
    log(f"  built {[os.path.basename(p) for p in libs]} in {time.perf_counter() - t0:.2f} s")

    phase("phase 3: K1 against its plain version (full width)")
    err_k1 = compare_kernel("K1", FULL, torch, LAUNCH_SEQUENCE)
    phase("phase 4: K2 against its plain version: one launch at the CartPole sample shapes, "
        "the launch sequence at the full offline width")
    err_k2 = compare_kernel("K2", CARTPOLE, torch, ONE_LAUNCH)
    err_k2_seq = compare_kernel("K2 (launch sequence)", K2_LARGE, torch, LAUNCH_SEQUENCE)

    phase("phase 5: timing (CUDA events, 3 warm-ups, median of 20)")
    timing = {}
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE), ("K2 (launch sequence)", K2_LARGE)):
        timing[kname] = time_kernel(cfg, torch, name)
        ms, plain_ms, b_ms, b_by, flops, nbytes = timing[kname]
        log(f"  {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), "
            f"{b_ms / ms * 100:.1f}% of the bound, on {card}")
    products = {"K1": products_library_ms(FULL, torch)}
    log(f"  K1's products through torch.matmul (cuBLAS, f32, no TF32; a yardstick only): "
        f"{products['K1']:.4f} ms, on {card}")
    gemm_us = {}
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE)):
        log(f"  {kname} device time by CUDA kernel (torch.profiler, mean of 5 updates):")
        gemm_us[kname] = profile_update(cfg, torch)[1]

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 6: workflow at full width through K1")
        k1_launches, k1_steps, _ = workflow_phase(
            FULL, FULL_ROWS, FULL_EPOCHS, "fused_dqn_offline_update", torch, tmp, "full_width")
        phase("phase 7: workflow at the CartPole sample config's shapes through K2")
        k2_launches, _, _ = workflow_phase(
            CARTPOLE, 2048, 2, "fused_dqn_update", torch, tmp, "cartpole_sample")

    phase("phase 8: K2's packed interface, K3 and K4 against their plain versions")
    err_k2p = compare_k2_packed(torch)
    err_k3 = compare_k3(torch)
    err_k4 = compare_k4(torch)

    phase("phase 9: timing of K2-packed, K3 and K4 (CUDA events, 3 warm-ups, median of 20)")
    online_timing = time_online_kernels(torch, name)
    for kname, (ms, plain_ms, b_ms, b_by, flops, nbytes, shapes) in online_timing.items():
        log(f"  {kname} ({shapes}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), on {card}")
    kern_t, _, kw_t = kernel_fns(CARTPOLE, True)
    _, batch_t, params_t = make_inputs(CARTPOLE, 98, torch, DEVICE)
    lr_t, eps_t = step_scalars(torch, 0, CARTPOLE["lr"], DEVICE)
    host_us = {"K2-packed": host_us_per_call(torch, k2_packed_call(torch)[0]),
               "K2": host_us_per_call(torch, lambda: kern_t(lr_t, eps_t, *batch_t, params_t, **kw_t))}
    log(f"  K2 wrapper host time per call (time.perf_counter over 200 calls, no sync): "
        f"packed {host_us['K2-packed']:.1f} us, tensor {host_us['K2']:.1f} us, "
        f"{fused_dqn.fused_dqn_update_packed.kernels_per_update} CUDA kernel per update")
    host_us.update(online_host_us(torch))
    launch_floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0))
    k3_addmm_ms = k3_products_library_ms(torch)
    log(f"  K3 wrapper host time per call: [1, 4] {host_us['K3 [1, 4]']:.1f} us, [20, 4] "
        f"{host_us['K3 [20, 4]']:.1f} us; K4 (loop shape) {host_us['K4 loop']:.1f} us; "
        f"queued launch floor (an empty kernel, CUDA events) {launch_floor_ms:.4f} ms; "
        f"K3 [1, 4] as one torch.addmm per layer (a yardstick only) {k3_addmm_ms:.4f} ms, "
        f"on {card}")
    log("  K2-packed device time by CUDA kernel (torch.profiler, mean of 5 updates):")
    profile_calls(torch, k2_packed_call(torch)[0])

    phase(f"phase 10: fused online loop at the bench's width ({FUSED_STEPS} steps)")
    fused_launches, fused_rate, _ = fused_loop_phase(torch, FUSED_STEPS)

    phase(f"phase 11: generic online loop ({GENERIC_STEPS} steps) and evaluate_policy")
    generic_launches, eval_launches, _ = generic_loop_phase(torch, GENERIC_STEPS)

    phase("phase 12: K5 (quantile-Huber loss: two forward routes and the backward) against "
        "its plain versions")
    err_k5, err_k5_grad, err_k5_scale = compare_k5(torch)

    phase("phase 13: timing of K5 (CUDA events, 3 warm-ups, median of 20)")
    k5_timing = time_k5(torch, name)
    for (kB, kN), t in k5_timing.items():
        parts = []
        for key, label in (("loss", "loss-only forward"), ("sums", "forward with sums"),
                           ("bwd", "backward"), ("pair", "trainer's pair")):
            b_ms, b_by = t["bounds"][key]
            parts.append(f"{label} {t[key]:.4f} ms (plain {t['plain_' + key]:.4f}, bound "
                         f"{b_ms:.6f}, {b_by})")
        log(f"  K5 [{kB}, {kN}] ({t['pairs']:.4g} pairs; {K5_LOSS_INSTR} and {K5_SUMS_INSTR} "
            f"instructions a pair): " + "; ".join(parts) + f", on {card}")
    k5_main = k5_timing[K5_SHAPES[0]]

    phase("phase 14: offline QR-DQN workflow at full width through K5")
    with tempfile.TemporaryDirectory() as tmp:
        qr_launches, _, _ = qr_workflow_phase(torch, tmp, k5_main["pair"])

    phase("phase 15: QR-DQN train steps, card against CPU")
    qr_lockstep_phase(torch)

    phase(f"phase 16: online QR-DQN loop ({QR_ONLINE['steps']} steps) and evaluate_policy")
    qr_online_launches, _ = qr_online_phase(torch)

    bf16, f32 = torch.bfloat16, torch.float32
    phase("phase 17: K1 with its bfloat16 options against its plain version (full width)")
    err_k1_bf16 = compare_k1_bf16(torch, (bf16, bf16), "K1-bf16 (matmul bf16, save bf16)")
    err_k1_save = compare_k1_bf16(torch, (f32, bf16), "K1 (matmul f32, save bf16)")

    phase("phase 18: timing of K1-bf16 (CUDA events, 3 warm-ups, median of 20)")
    timing["K1-bf16"] = time_kernel(FULL, torch, name, (bf16, bf16))
    timing["K1 again"] = time_kernel(FULL, torch, name)
    for kname in ("K1-bf16", "K1 again"):
        ms, plain_ms, b_ms, b_by, flops, nbytes = timing[kname]
        log(f"  {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), {b_ms / ms * 100:.1f}% of the "
            f"bound, on {card}")
    products["K1-bf16"] = products_library_ms(FULL, torch, bf16_products=True)
    log(f"  K1-bf16's products through torch.matmul (cuBLAS, bf16 operands; a yardstick only): "
        f"{products['K1-bf16']:.4f} ms, on {card}")
    log("  K1-bf16 device time by CUDA kernel (torch.profiler, mean of 5 updates):")
    gemm_us["K1-bf16"] = profile_update(FULL, torch, dtypes=(bf16, bf16))[1]

    phase(f"phase 19: device-resident fused loop ({TABLE_ROWS} rows on the card, minibatch "
        f"{FULL['B']}, block {SCAN_BLOCK})")
    dataset = offline_dataset(torch, DEVICE)
    trainer_bf16, state_bf16, scan_bf16, rates_bf16, td_bf16 = device_resident_fused_phase(
        torch, dataset, bf16, "fused loop, matmul bf16")
    _, _, scan_f32, rates_f32, td_f32 = device_resident_fused_phase(
        torch, dataset, f32, "fused loop, f32 twin")
    fused_lockstep_against_cpu(torch, dataset)
    k3_scan_launches = q_values_phase(torch, trainer_bf16, state_bf16, dataset)

    phase(f"phase 20: unfused scan path (DQNTrainer, {UNFUSED_STEPS} steps each)")
    unfused = {label: unfused_scan_phase(torch, dataset, dtype, f"unfused scan, {label}")
               for label, dtype in (("compute f32", None), ("compute bf16", bf16))}
    compare_td_paths(torch, {"fused f32": td_f32, "fused bf16": td_bf16,
                             **{f"unfused {k}": v[1] for k, v in unfused.items()}})
    log("  steps/s on " + card + ": fused bf16 "
        + ", ".join(f"{r:.2f} ({n})" for n, r in rates_bf16.items()) + "; fused f32 "
        + ", ".join(f"{r:.2f} ({n})" for n, r in rates_f32.items()) + "; "
        + "; ".join(f"{k} {v[0]:.2f}" for k, v in unfused.items()))
    del dataset

    phase("phase 21: K3 at the evaluation's shapes against its plain version, timed")
    k3_eval = k3_eval_phase(torch, name)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 22: the flagship sample config unchanged (CPE on) through "
              "identify_and_train_network")
        sample_cfg = dict(CARTPOLE, B=SAMPLE_CONFIG["model"]["DiscreteDQN"]["trainer_param"][
            "minibatch_size"])
        split = (SAMPLE_CONFIG["table_sample"], SAMPLE_CONFIG["eval_table_sample"])
        cpe_sample = cpe_workflow_phase(
            torch, tmp, "cpe_sample_config", sample_cfg, SAMPLE_CONFIG["model"],
            SAMPLE_CPE_ROWS, SAMPLE_CONFIG["num_epochs"], split)
        phase("phase 23: the full offline width with CPE (unfused DQNTrainer, three heads)")
        cpe_full = cpe_workflow_phase(
            torch, tmp, "cpe_full_width", FULL, full_cpe_model(), FULL_CPE_ROWS,
            FULL_CPE_EPOCHS, split)

    phase("phase 24: CPE, card against CPU")
    cpe_trainer, cpe_state = cpe_lockstep_phase(torch)
    for label, run in (("sample config", cpe_sample), ("full width", cpe_full)):
        cpe_edp_against_cpu(torch, run, label)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 25: the dqn_cartpole_e2e job (offline_gym_random, timeline_operator, "
              "identify_and_train_network with the reporter, evaluate_gym)")
        e2e = e2e_phase(torch, tmp)
        phase("phase 26: warm start and reward options at full width through K1")
        warm = warm_start_phase(torch, tmp, cpe_trainer, cpe_state)

    phase("phase 27: SAC and TD3 train steps at the sample config's widths, card against CPU")
    ac_lockstep_phase(torch, "SAC", 5)
    ac_lockstep_phase(torch, "TD3", 4)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 28: the sac_pendulum_e2e job through reagent run (offline_gym_random, "
              "timeline_operator, identify_and_train_network, evaluate_gym)")
        sac_job_phase(torch, tmp)

    phase("phase 29: discrete CRR train steps at the online config's widths, card against CPU")
    crr_lockstep_phase(torch)

    with tempfile.TemporaryDirectory() as tmp:
        phase(f"phase 30: the offline CRR job (offline_gym_random, timeline_operator, "
              f"identify_and_train_network with DiscreteCRR, {CRR_OFFLINE['epochs']} epochs, "
              "evaluate_gym)")
        crr_job = crr_offline_job_phase(torch, tmp, CRR_OFFLINE["epochs"])

    phase(f"phase 31: online discrete CRR through the generic loop ({CRR_ONLINE['steps']} "
          "steps) and evaluate_policy")
    crr_online = crr_online_phase(torch, CRR_ONLINE["steps"])

    phase("phase 32: REINFORCE and PPO on the functional CartPole: card against CPU, then "
          "the configs' runs")
    pg = {}
    for pg_name in PG_CONFIGS:
        pg_lockstep_phase(torch, pg_name)
    for pg_name, pg_cfg in PG_CONFIGS.items():
        pg[pg_name] = pg_run_phase(torch, pg_name, pg_cfg["episodes"])

    phase("phase 33: C51, parametric DQN and parametric SARSA train steps at the online "
          "configs' widths, card against CPU")
    for fam_name in DQN_FAMILY_ONLINE:
        dqn_family_lockstep_phase(torch, fam_name)

    phase("phase 34: K3 and K4 at the C51 and parametric paths' shapes against their plain "
          "versions, timed (CUDA events, 3 warm-ups, median of 20)")
    family_kernels = k3_k4_family_phase(torch, name, launch_floor_ms)

    phase("phase 35: online C51, parametric DQN and parametric SARSA through the generic loop "
          "and evaluate_policy")
    fam_online = {fam_name: dqn_family_online_phase(torch, fam_name, cfg["steps"], cfg["prefill"])
                  for fam_name, cfg in DQN_FAMILY_ONLINE.items()}

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 36: the DiscreteC51DQN and ParametricDQN managers through "
              "identify_and_train_network")
        fam_offline = {fam_name: dqn_family_offline_phase(torch, tmp, fam_name, cfg["epochs"])
                       for fam_name, cfg in DQN_FAMILY_OFFLINE.items()}

    phase("phase 37: kernels")
    by_path = {
        "K1 fused_dqn_offline_update": {
            "offline workflow, full width": k1_launches,
            "device-resident fused loop, f32 twin": scan_f32["fused_dqn_offline_update"],
            "warm start and reward options, full width": warm["launches"]},
        "K1 fused_dqn_offline_update (bf16)": {
            "device-resident fused loop": scan_bf16["fused_dqn_offline_update_bf16"]},
        "K2 fused_dqn_update": {"offline workflow, CartPole sample": k2_launches,
                                "generic online loop": generic_launches["fused_dqn_update"]},
        "K2 fused_dqn_update_packed": {
            "fused online loop": fused_launches["fused_dqn_update_packed"]},
        "K3 fused_mlp_forward": {
            "fused online loop": fused_launches["fused_mlp_forward"],
            "generic online loop": generic_launches["fused_mlp_forward"],
            "evaluate_policy": eval_launches["fused_mlp_forward"],
            "offline QR-DQN workflow (q_values)": qr_launches["fused_mlp_forward"],
            "device-resident fused loop (q_values)": k3_scan_launches,
            "CPE evaluation, sample config": cpe_sample["launches"],
            "CPE evaluation, full width": cpe_full["launches"],
            "dqn_cartpole_e2e job (CPE evaluation)": e2e["launches"],
            "online CRR loop (the actor's act step)": crr_online["launches"]["fused_mlp_forward"],
            "online CRR evaluate_policy": crr_online["eval_launches"]["fused_mlp_forward"],
            "offline CRR job (actor_logits on 64 rows)": crr_job["k3_launches"],
            **{f"{k} episodes (act steps)": v["launches"]["fused_mlp_forward"]
               for k, v in pg.items()},
            **{f"{k} evaluate_policy": v["eval_launches"]["fused_mlp_forward"]
               for k, v in pg.items()},
            **{f"online {k} loop (act steps)": v["launches"]["fused_mlp_forward"]
               for k, v in fam_online.items()},
            **{f"online {k} evaluate_policy": v["eval_launches"]["fused_mlp_forward"]
               for k, v in fam_online.items()},
            **{f"offline {k} workflow (Q on 64 rows)": v["k3_launches"]
               for k, v in fam_offline.items()}},
        "K4 nstep_rewards": {"generic online loop": generic_launches["nstep_rewards"],
                             "online QR-DQN loop": qr_online_launches["nstep_rewards"],
                             "online CRR loop": crr_online["launches"]["nstep_rewards"],
                             **{f"online {k} loop": v["launches"]["nstep_rewards"]
                                for k, v in fam_online.items()}},
        "K5 quantile_huber_loss": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_loss"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_loss"]},
        "K5 quantile_huber_backward": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_backward"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_backward"]},
        "K5 quantile_huber_sums": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_sums"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_sums"]},
    }
    sources = {"K3": "reagent_tpu_torch/ops/csrc/fused_mlp.cu",
               "K4": "reagent_tpu_torch/ops/csrc/nstep_replay.cu",
               "K5": "reagent_tpu_torch/ops/csrc/quantile_huber.cu"}
    k5_shapes = {f"[{b}, {n}]": t for (b, n), t in k5_timing.items()}
    rows = []
    for kname, fn, replaces, err, times in (
        ("K1 fused_dqn_offline_update", fused_dqn_offline.fused_dqn_offline_update,
         "reagent_tpu/ops/fused_dqn_offline.py:240", err_k1, timing["K1"]),
        # the matmul_dtype=bfloat16 / save_dtype options (:71-72): the same
        # entry point, its products on the tensor cores
        ("K1 fused_dqn_offline_update (bf16)", None,
         "reagent_tpu/ops/fused_dqn_offline.py:240", max(err_k1_bf16, err_k1_save),
         timing["K1-bf16"]),
        ("K2 fused_dqn_update", fused_dqn.fused_dqn_update,
         "reagent_tpu/ops/fused_dqn.py:259", err_k2, timing["K2"]),
        # the packed interface reads the batch in place; both interfaces run
        # one C kernel, or the launch sequence where the shapes exceed it
        ("K2 fused_dqn_update_packed", fused_dqn.fused_dqn_update_packed,
         "reagent_tpu/ops/fused_dqn.py:259", err_k2p, online_timing["K2-packed"]),
        ("K3 fused_mlp_forward", None, "reagent_tpu/ops/fused_mlp.py:75", err_k3,
         online_timing["K3 [1, 4]"]),
        ("K4 nstep_rewards", None, "reagent_tpu/ops/nstep_replay.py:92", err_k4,
         online_timing["K4 loop"]),
        # K5's two launches, each at the offline path's [4096, 51]: the
        # forward on the gradient route, the main path's, and the backward
        # scaling its sums; the TPU kernel has no backward (XLA
        # differentiates its plain formulation)
        ("K5 quantile_huber_loss", None, "reagent_tpu/ops/quantile_huber.py:77", err_k5,
         (k5_main["sums"], k5_main["plain_sums"], *k5_main["bounds"]["sums"])),
        ("K5 quantile_huber_backward", None, "reagent_tpu/ops/quantile_huber.py:77",
         max(err_k5_grad, err_k5_scale),
         (k5_main["bwd"], k5_main["plain_bwd"], *k5_main["bounds"]["bwd"])),
    ):
        ms, plain_ms, b_ms, b_by = times[:4]
        row = {
            "name": kname, "route": "cuda",
            "source": sources.get(kname.split()[0], "reagent_tpu_torch/ops/csrc/fused_dqn.cu"),
            "replaces": replaces, "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a DQN update, a fused MLP
            # forward, an n-step window sum or a pairwise quantile-Huber loss
            "library_ms": None,
        }
        if kname.startswith("K5"):
            # each route at each shape; the forward's row also carries the
            # loss-only route and the trainer's pair (forward with sums, then
            # the backward) as one function
            keys = {"K5 quantile_huber_loss": ("sums", "loss", "pair"),
                    "K5 quantile_huber_backward": ("bwd",)}[kname]
            row["by_shape"] = {
                shape: {key: {"ms": t[key], "plain_ms": t["plain_" + key],
                              "bound_ms": t["bounds"][key][0], "bound_by": t["bounds"][key][1]}
                        for key in keys}
                for shape, t in k5_shapes.items()}
        if kname == "K5 quantile_huber_loss":
            row["launches_on_the_gradient_route"] = sum(by_path["K5 quantile_huber_sums"].values())
        if fn is not None:
            row["cuda_kernels_per_launch"] = fn.kernels_per_update
        if kname.startswith("K2"):
            # phase 4 held each route to these counts (double-Q)
            row["cuda_kernels_per_launch_by_route"] = {
                "one launch (CartPole shapes)": ONE_LAUNCH[True],
                "launch sequence (D=128, 512, 256, A=8)": LAUNCH_SEQUENCE[True]}
            row["wrapper_host_us"] = host_us["K2-packed" if kname.endswith("packed") else "K2"]
        if kname == "K2 fused_dqn_update":
            seq = timing["K2 (launch sequence)"]
            row["launch_sequence"] = {"max_abs_err": err_k2_seq, "ms": seq[0], "plain_ms": seq[1],
                                      "bound_ms": seq[2], "bound_by": seq[3]}
        if kname.startswith(("K3", "K4")):
            row["wrapper_host_us"] = host_us["K3 [1, 4]" if kname.startswith("K3") else "K4 loop"]
            row["launch_floor_ms"] = launch_floor_ms
            other = online_timing["K3 [20, 4]" if kname.startswith("K3") else "K4 kernel phase"]
            row["by_shape"] = {other[-1]: {"ms": other[0], "plain_ms": other[1],
                                           "bound_ms": other[2], "bound_by": other[3]}}
        if kname.startswith(("K3", "K4")):
            # the kernel's device time in a step of the discrete-actor paths
            # (profiled windows of phases 31-32), as a share of its wall time
            key = "k3_us" if kname.startswith("K3") else "k4_us"
            paths = {"online CRR loop": (crr_online, "steps_per_s"),
                     **{f"online {k} loop": (v, "steps_per_s") for k, v in fam_online.items()}}
            if kname.startswith("K3"):
                paths.update({f"{k} episodes": (v, "episodes_per_s") for k, v in pg.items()})
            row["share_of_step"] = {
                path: {"device_us": run[key], "share": run[key] * run[rate] / 1e6}
                for path, (run, rate) in paths.items()}
        if kname.startswith("K3"):
            # the same forward as one torch.addmm per layer, at [1, 4]
            row["products_library_ms"] = k3_addmm_ms
            row["wrapper_host_us_by_shape"] = {"x [20, 4]": host_us["K3 [20, 4]"]}
            # the evaluation's forwards (phase 21), each with its addmm yardstick
            row["by_shape"].update({f"evaluation {k}": v for k, v in k3_eval.items()})
        if kname.startswith(("K3", "K4")):
            # the C51 and parametric paths' shapes (phase 34)
            row["by_shape"].update(family_kernels[kname[:2]])
        if kname.startswith("K1"):
            # the same products through cuBLAS, and the kernel's own GEMM share
            key = "K1-bf16" if kname.endswith("(bf16)") else "K1"
            row["products_library_ms"] = products[key]
            row["gemm_device_us"] = gemm_us[key]
        if kname.endswith("(bf16)"):
            row["cuda_kernels_per_launch"] = (
                fused_dqn_offline.fused_dqn_offline_update.bf16_kernels_per_update)
            row["mma"] = "mma.sync m16n8k16 bf16, f32 accumulators, cp.async and ldmatrix"
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
