#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. build every CUDA kernel of the package from its sources (one nvcc per
     source, started together) into build/kernels/;
  2. hold the sdca_block kernel against its plain-torch version on the
     card for the four losses (squared, hinge, smooth_hinge_1, logistic)
     at K=8, m_b=512, d=256, H=1024, with a shared w, and with per-leaf w
     plus a step mask;
  3. drive the main path through its user entry points: tree-network SDCA
     on a two-level tree of 8 groups x 16 workers x 8192 examples (m =
     1,048,576, d = 512, ridge, lambda = 1e-4), Schedule(rounds=5,
     level_rounds=[2], local_steps=8192), Session.compile(backend="cuda")
     .run(key=PRNGKey(0)) and a warm-started run(rounds=2).  The kernel's
     launch count is zeroed just before and read just after; it must equal
     the run's solve ticks.  The duality gap must fall and w must match
     X^T alpha / (lambda m);
     One more warm root round runs under torch.profiler (wall time,
     device busy share, device time by kernel); its launches come after
     the count was read;
  4. time the kernel (CUDA events, warm) and its plain version on one of
     the main path's own ticks, hold them against each other, and compute
     the kernel's bound from that tick's inputs.

Prints the card's name and power limit, the build seconds, the kernel and
plain times, the run's seconds per root round and peak device memory,
then one JSON line describing each kernel and, last, the device line.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory rate and float32 rate
# outside the tensor cores -- the roofline the kernel's bound is taken on
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# |kernel - plain| <= TOL * max(1, max|plain|) per output: both run in
# float32 but sum <w, x_i> in different orders, and the differences ride
# along H dependent steps; on the logistic loss the 8 Newton steps near
# the edge of (0, 1) amplify them further.
TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    """max |got - want| over the outputs, checked against TOL."""
    err = 0.0
    for g, r in zip(got, want, strict=True):
        e = float((g - r).abs().max())
        scale = max(1.0, float(r.abs().max()))
        if not e <= TOL * scale:
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"max abs err {e} > {TOL} * {scale}")
        err = max(err, e)
    return err


def time_ms(fn, reps: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_round(sess, warm, card: str) -> None:
    """One more warm root round under torch.profiler: the round's wall
    time, the device's busy share, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(rounds=1, warm_start=warm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    names = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top)
    share = f"{100 * busy_ms / wall_ms:.1f}%" if busy_ms else "not measured"
    print(f"profile, one warm root round: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({share}); by kernel: {names}  [{card}]")


def check_losses(dev) -> float:
    """Phase 2: the kernel against the plain version, every loss, shared
    and per-leaf w, with and without a step mask."""
    import torch
    from repro_torch.core import dual
    from repro_torch.kernels.sdca import kernel, ref
    K, m_b, d, H = 8, 512, 256, 1024
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(K, m_b, d, generator=g, device=dev)
    lm = 0.1 * K * m_b
    worst = 0.0
    for name in ("squared", "hinge", "smooth_hinge_1", "logistic"):
        loss = dual.get_loss(name)
        y = torch.randn(K, m_b, generator=g, device=dev)
        if name != "squared":
            y = torch.sign(y)
        alpha = 0.1 * torch.randn(K, m_b, generator=g, device=dev)
        if name != "squared":      # dual feasibility: alpha * y in [0, 1]
            alpha = alpha.abs() * y
        idx = torch.randint(0, m_b, (K, H), generator=g, device=dev,
                            dtype=torch.int32)
        cases = {
            "shared w": (0.1 * torch.randn(d, generator=g, device=dev),
                         None),
            "per-leaf w + mask": (
                0.1 * torch.randn(K, d, generator=g, device=dev),
                (torch.rand(K, H, generator=g, device=dev) < 0.8).float()),
        }
        for label, (w, mask) in cases.items():
            got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=loss,
                                           lm=lm, step_mask=mask)
            want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=loss, lm=lm,
                                      step_mask=mask)
            torch.cuda.synchronize()
            e = max_err(got, want)
            worst = max(worst, e)
            print(f"check sdca_block {name:15s} {label:18s} "
                  f"max_abs_err={e:.3e}")
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import Problem, Schedule, Session, Topology
    from repro_torch.core import dual, prng
    from repro_torch.core.engine import host as host_mod
    from repro_torch.core.engine import plan as plan_mod
    from repro_torch.data.synthetic import gaussian_regression
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdca import kernel, ref

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(built) or 'nothing (cached)'}")

    # ---- 2. kernel vs plain, four losses --------------------------------------
    worst = check_losses(dev)

    # ---- 3. the main path ---------------------------------------------------
    n_groups, per_group, m_leaf, d = 8, 16, 8192, 512
    lam, rounds, more = 1e-4, 5, 2
    X, y = gaussian_regression(m=n_groups * per_group * m_leaf, d=d, seed=0,
                               device=dev)
    problem = Problem.ridge(X, y, lam=lam)
    topo = Topology.two_level(n_groups=n_groups, workers_per_group=per_group,
                              m_per_worker=m_leaf)
    sched = Schedule(rounds=rounds, level_rounds=[2], local_steps=8192)
    torch.cuda.reset_peak_memory_stats()
    sess = Session.compile(problem, topo, sched, backend="cuda", device=dev)
    solve_ticks = int(sess.executor.solves.sum()) * (rounds + more)
    torch.cuda.synchronize()
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sess.run(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = sess.run(rounds=more, warm_start=res)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    gaps = list(res.gaps) + list(res2.gaps)
    print(f"main path: m={problem.m} d={d} leaves={topo.n_leaves} "
          f"H=8192 rounds={rounds}+{more} gaps={[f'{g:.6e}' for g in gaps]}")
    print(f"main path: {(t1 - t0) / rounds:.4f} s per root round "
          f"(cold run), {(t2 - t1) / more:.4f} s per root round (warm "
          f"run); peak device memory {peak / 2**30:.3f} GiB  [{card}]")
    if launches != solve_ticks:
        raise AssertionError(f"sdca_block launched {launches} times, the "
                             f"run had {solve_ticks} solve ticks")
    if not all(math.isfinite(g) for g in gaps):
        raise AssertionError(f"non-finite gap in {gaps}")
    # the dual ascends every round but the primal need not, so the gap is
    # held against its start, not round by round
    if not gaps[-1] < gaps[0]:
        raise AssertionError(f"duality gap did not fall: {gaps}")
    if tuple(res2.alpha.shape) != (problem.m,) or \
            tuple(res2.w.shape) != (d,):
        raise AssertionError("result shapes")
    w_ref = dual.w_of_alpha(res2.alpha, X, lam)
    w_err = float((res2.w - w_ref).abs().max())
    w_scale = float(w_ref.abs().max())
    print(f"main path: max|w - X^T alpha/(lam m)| = {w_err:.3e} "
          f"(max|w| {w_scale:.3e})")
    if not w_err <= 1e-3 * w_scale:
        raise AssertionError("w drifted from X^T alpha / (lam m)")

    profile_round(sess, res2, card)

    # ---- 4. the kernel on one of the main path's ticks -----------------------
    ex, data = sess.executor, sess.data
    K, m_b = sess.plan.n_leaves, sess.plan.m_b
    lm = host_mod.regularizer_scale(lam, problem.m)
    keys = prng.as_key(plan_mod.chunked_key_plan(
        sess.resolved.chunk_tree, sess.plan, prng.PRNGKey(0), 1))[0, 0]
    idx = ex.draw_idx(keys.to(dev))
    mk = torch.ones((K, sess.plan.h_max), device=dev)
    a = torch.zeros(K * m_b, device=dev)
    a[ex.flat_map] = res2.alpha
    a = a.view(K, m_b)
    w = res2.w.expand(K, d).contiguous()
    xsq = data.sqnorm / lm
    args = (data.Xb, data.yb, a, w, xsq, idx)
    kw = dict(loss=problem.loss, lm=lm, step_mask=mk)
    n0 = kernel.LAUNCHES
    got = kernel.sdca_block_launch(*args, **kw)
    want = ref.sdca_steps_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    worst = max(worst, err)
    ms = time_ms(lambda: kernel.sdca_block_launch(*args, **kw), 5)
    plain_ms = time_ms(lambda: ref.sdca_steps_ref(*args, **kw), 1)
    # the other losses at the same shape (labels +-1, alpha = 0 feasible)
    per_loss = {problem.loss.name: ms}
    cls_args = (data.Xb, torch.sign(data.yb), torch.zeros_like(a), w, xsq,
                idx)
    for name in ("hinge", "smooth_hinge_1", "logistic"):
        cls_kw = dict(kw, loss=dual.get_loss(name))
        kernel.sdca_block_launch(*cls_args, **cls_kw)
        per_loss[name] = time_ms(
            lambda k=cls_kw: kernel.sdca_block_launch(*cls_args, **k), 3)
    kernel.LAUNCHES = n0
    # the least work: each distinct sampled row read once, the leaf
    # vectors read and written once; 4 flops per row element per step
    rows = sum(int(torch.unique(r).numel()) for r in idx)
    nbytes = rows * d * 4 + K * (4 * m_b + 2 * d) * 4 + K * idx.shape[1] * 8
    flops = 4 * K * idx.shape[1] * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"sdca_block at the main path's shape (K={K} m_b={m_b} d={d} "
          f"H={idx.shape[1]}): kernel {ms:.4f} ms/launch, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
          f"{flops} flop), {ms * 1e3 / idx.shape[1]:.3f} us per step, "
          f"max_abs_err {err:.3e}  [{card}]")
    print("sdca_block ms/launch by loss at that shape: " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_loss.items()) + f"  [{card}]")
    print(json.dumps({"kernels": [{
        "name": "sdca_block",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdca/csrc/sdca_block.cu",
        "replaces": "src/repro/kernels/sdca/kernel.py:79",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
