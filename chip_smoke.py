#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reagent_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from reagent_tpu_torch/ops/csrc (nvcc, sm_90a);
  3. K1 (offline fused DQN update) against its plain PyTorch version at full
     width, double-Q and single-Q, 5 lockstep updates;
  4. K2 (single-block fused DQN update) the same, at the CartPole sample
     config's shapes;
  5. CUDA-event timing of each kernel and its plain version, beside the bound,
     and each update's device time by CUDA kernel (torch.profiler);
  6. the offline workflow (identify_and_train_network) at full width through
     K1, with the exported artifact scored against the in-process module and
     the host's batch preprocessing timed beside the train step;
  7. the workflow at the sample config's shapes through K2;
  8. one JSON line describing each ported kernel.
The last line is {"ok": true, "device": {...}}.  It needs no network, and it
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"

# Published peaks (NVIDIA data sheets): f32 outside the tensor cores, HBM rate.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100": (67e12, 3.35e12),  # SXM
}

FULL = dict(D=128, widths=[512, 256], A=8, B=4096, block=512, act="leaky_relu",
            gamma=0.99, tau=0.1, lr=1e-3)
CARTPOLE = dict(D=4, widths=[128, 64], A=2, B=512, block=None, act="leaky_relu",
                gamma=0.99, tau=0.2, lr=0.01)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def kernel_fns(cfg, double_q):
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    acts = [cfg["act"]] * len(cfg["widths"]) + ["linear"]
    kw = dict(activations=acts, gamma=cfg["gamma"], tau=cfg["tau"],
              double_q_learning=double_q)
    if cfg["block"] is not None:
        kw["block_size"] = cfg["block"]
        return (fused_dqn_offline.fused_dqn_offline_update,
                fused_dqn_offline.fused_dqn_offline_update_reference, kw)
    return fused_dqn.fused_dqn_update, fused_dqn.fused_dqn_update_reference, kw


def compare_kernel(name, cfg, torch):
    """5 lockstep updates of the kernel and its plain version from one state,
    double-Q and single-Q.  Tolerances: float32 sums taken in another order,
    which Adam amplifies where |g| is small (td_loss/metrics rtol 2e-4,
    atol 2e-5; final params rtol 5e-4, atol 5e-5)."""
    worst = 0.0
    for double_q in (True, False):
        kern, plain, kw = kernel_fns(cfg, double_q)
        _, batch, p_kern = make_inputs(cfg, 1234, torch, DEVICE)
        p_plain = [p.clone() for p in p_kern]
        for step in range(5):
            lr_t, eps_t = step_scalars(torch, step, cfg["lr"], DEVICE)
            mk = kern(lr_t, eps_t, *batch, p_kern, **kw)
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


def profile_update(cfg, torch, n=5):
    """Device time of one update by CUDA kernel (torch.profiler over n
    updates, averaged)."""
    from torch.profiler import ProfilerActivity, profile

    kern, _, kw = kernel_fns(cfg, True)
    _, batch, params = make_inputs(cfg, 5, torch, "cuda")
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    kern(lr_t, eps_t, *batch, params, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            kern(lr_t, eps_t, *batch, params, **kw)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / n, ev.count // n, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    for us, count, key in rows:
        log(f"    {us:9.2f} us  x{count:<3d} {key[:90]}")
    log(f"    {total:9.2f} us  device time per update (sum of kernels)")
    return total


def bound(cfg, double_q, name):
    """Least time for one update: the larger of its f32 operations over the
    card's peak and its bytes (inputs read once, params8 read and written
    once) over the memory rate."""
    B, D, A = cfg["B"], cfg["D"], cfg["A"]
    sizes = [D, *cfg["widths"], A]
    macs_layer = [i * o for i, o in zip(sizes[:-1], sizes[1:])]
    F = sum(macs_layer)
    n_fwd = 3 if double_q else 2
    flops = 2.0 * B * (n_fwd * F + F + (F - macs_layer[0]))
    P = F + sum(sizes[1:])
    nbytes = 4.0 * (2 * B * D + 2 * B * A + 2 * B + 2 + 2 * 8 * P + 4)
    peak_flops, peak_bw = peaks_for(name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def time_kernel(cfg, torch, name):
    kern, plain, kw = kernel_fns(cfg, True)
    _, batch, p_kern = make_inputs(cfg, 99, torch, "cuda")
    p_plain = [p.clone() for p in p_kern]
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    ms = time_ms(torch, lambda: kern(lr_t, eps_t, *batch, p_kern, **kw))
    plain_ms = time_ms(torch, lambda: plain(lr_t, eps_t, *batch, p_plain, **kw))
    b_ms, b_by, flops, nbytes = bound(cfg, True, name)
    return ms, plain_ms, b_ms, b_by, flops, nbytes


# ---------------------------------------------------------------- workflow


def make_table(path, n_rows, n_features, n_actions, seed):
    """A logged-transition table (the timeline operator's columns) from a
    numpy seed: episodes of 10 steps, so ~10% terminals, and ~20% of the
    next actions impossible."""
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
        "reward": rng.normal(size=n_rows).astype(np.float32),
        "not_terminal": (~terminal).astype(np.int64),
        "time_diff": np.ones(n_rows, np.int64),
        "action_probability": np.full(n_rows, 1.0 / n_actions),
        "possible_next_actions": possible_next,
    })
    df.to_pickle(path)
    return df


def run_workflow(cfg, n_rows, epochs, torch, tmp, label):
    """identify_and_train_network on a synthetic table; returns the output,
    the table and the in-process serving module."""
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.model_managers.discrete_dqn import DiscreteDQN
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    table = os.path.join(tmp, f"{label}.pkl")
    df = make_table(table, n_rows, cfg["D"], cfg["A"], seed=7)
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
    # keep what the manager builds, to score and time it afterwards
    captured = {}
    originals = {m: getattr(DiscreteDQN, m)
                 for m in ("build_serving_module", "build_batch_preprocessor")}

    def capturing(method):
        def wrapper(self, *args, **kwargs):
            captured[method] = originals[method](self, *args, **kwargs)
            return captured[method]
        return wrapper

    for m in originals:
        setattr(DiscreteDQN, m, capturing(m))
    try:
        t0 = time.perf_counter()
        out = identify_and_train_network(
            TableSpec(table_name=label, path=table), model, num_epochs=epochs,
            output_dir=os.path.join(tmp, label), seed=0, device=DEVICE)
        wall = time.perf_counter() - t0
    finally:
        for m, fn in originals.items():
            setattr(DiscreteDQN, m, fn)
    return (out, df, captured["build_serving_module"],
            captured["build_batch_preprocessor"], wall)


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


def reset_counts(fused_dqn, fused_dqn_offline):
    fused_dqn.fused_dqn_update.launches = 0
    fused_dqn.fused_dqn_update_reference.calls = 0
    fused_dqn_offline.fused_dqn_offline_update.launches = 0
    fused_dqn_offline.fused_dqn_offline_update_reference.calls = 0


def workflow_phase(cfg, n_rows, epochs, kernel, torch, tmp, label):
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    reset_counts(fused_dqn, fused_dqn_offline)
    out, df, serving, batch_pre, wall = run_workflow(cfg, n_rows, epochs, torch, tmp, label)
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

    log("phase 1: device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    log("phase 2: build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    _build.load_library()
    log(f"  built {[os.path.basename(p) for p in libs]} in {time.perf_counter() - t0:.2f} s")

    log("phase 3: K1 against its plain version (full width)")
    err_k1 = compare_kernel("K1", FULL, torch)
    log("phase 4: K2 against its plain version (CartPole sample shapes)")
    err_k2 = compare_kernel("K2", CARTPOLE, torch)

    log("phase 5: timing (CUDA events, 3 warm-ups, median of 20)")
    timing = {}
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE)):
        timing[kname] = time_kernel(cfg, torch, name)
        ms, plain_ms, b_ms, b_by, flops, nbytes = timing[kname]
        log(f"  {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), "
            f"{b_ms / ms * 100:.1f}% of the bound, on {card}")
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE)):
        log(f"  {kname} device time by CUDA kernel (torch.profiler, mean of 5 updates):")
        profile_update(cfg, torch)

    with tempfile.TemporaryDirectory() as tmp:
        log("phase 6: workflow at full width through K1")
        k1_launches, k1_steps, _ = workflow_phase(
            FULL, 16384, 2, "fused_dqn_offline_update", torch, tmp, "full_width")
        log("phase 7: workflow at the CartPole sample config's shapes through K2")
        k2_launches, _, _ = workflow_phase(
            CARTPOLE, 2048, 2, "fused_dqn_update", torch, tmp, "cartpole_sample")

    log("phase 8: kernels")
    rows = []
    for kname, fn, replaces, launches, err in (
        ("K1 fused_dqn_offline_update", fused_dqn_offline.fused_dqn_offline_update,
         "reagent_tpu/ops/fused_dqn_offline.py:240", k1_launches, err_k1),
        ("K2 fused_dqn_update", fused_dqn.fused_dqn_update,
         "reagent_tpu/ops/fused_dqn.py:259", k2_launches, err_k2),
    ):
        ms, plain_ms, b_ms, b_by, _, _ = timing[kname.split()[0]]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "reagent_tpu_torch/ops/csrc/fused_dqn.cu",
            "replaces": replaces, "launches": launches,
            "cuda_kernels_per_launch": fn.kernels_per_update,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a whole DQN update
            "library_ms": None,
        })
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
