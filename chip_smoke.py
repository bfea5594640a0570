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
     .run(key=PRNGKey(0)) and a warm-started run(rounds=2).  The session
     is compiled twice: the first compile builds the executor (one host
     cache miss), the second must take the same executor from the cache
     (one hit, no miss); both compile times and cache deltas are
     printed.  The kernel's launch count is zeroed just before and read
     just after; it must equal
     the run's solve ticks.  The duality gap must fall and w must match
     X^T alpha / (lambda m);
     One more warm root round runs under torch.profiler (wall time,
     device busy share, device time by kernel); its launches come after
     the count was read;
 3b. the compressed, delay-planned main path on phase 3's problem under
     Schedule.auto(t_total=60.0, C="auto", compression="auto",
     h_max=8192), with t_lp=1e-6, group_delay=1e-4, root_delay=5e-2
     (simulated seconds: leaves at 1 us a coordinate step, groups on a
     LAN, the root across a slow WAN).  Session.compile runs the C pilot
     through the kernel.  Phase 3's tree (8 groups x 16) is planned, its
     pilot launches counted nowhere, and its fitted C and level plan
     printed; the run uses the same 128 leaves as 16 groups x 8 (see
     compressed_path).
     The script prints
     the fitted C, the level plan, the bytes per root round and the
     simulated round time against the same tree uncompressed, runs 5
     root rounds and a warm 2 (seconds per root round, peak memory) and
     profiles one more.  The launch count is zeroed before the compile
     and read after its pilot, then zeroed and read around the run: one
     launch per solve tick each.  Checks: the
     planner compressed the root level; the gap fell and stayed finite; w
     matches X^T alpha / (lambda m) within 1e-3 of its max; one warm
     round's error-feedback targets give the same int8 codes, scales,
     roundtrips and top-k indices on the card as on the CPU;
     compression="none" on the same tree shape is the uncompressed plan,
     and its Session.run (which threads the executor's state) equals the
     flat executor restarted every root round (torch.equal); and a
     compressed run at 16 leaves x 1024 examples, d = 512, H = 1024
     agrees between backend="cuda" and backend="torch" within ROUTE_TOL
     plus the last messages' quanta;
 3c. batched sweeps on phase 3's problem under Schedule(rounds=5,
     level_rounds=[2], local_steps=8192, h_cap=8192): Session.sweep(lams=
     [1e-3, 3e-4, 1e-4, 3e-5], seeds=[0, 1]) (B = 8), then a local_hs=
     [2048, 8192] sweep at lambda = 1e-4.  The launch and leaf counts are
     zeroed before and read after each sweep: exactly one sdca_block launch
     per solve tick, each of B x 128 leaves.  Every member must equal its
     standalone Session.run(lam=, key=, local_h=) (torch.equal on alpha and
     w), its gap must fall and its w match X^T alpha / (lambda m) within
     1e-3 of the max.  Prints the seconds per root round of each sweep and
     of the standalone runs, the peak memory, one root round of the
     8-config sweep under torch.profiler, and the batched launch on
     the 8-config sweep's first tick: every config torch.equal to its
     one-config launch, config 0 held against the plain version, its ms
     (CUDA events) and its bound;
 3d. stragglers and acceleration.  Phase 3b's 16 x 8 tree and delays under
     Schedule.auto(t_total=60.0, C=<phase 3b's fitted C>,
     straggler=StragglerModel(slow_prob=0.1, slow_factor=20.0),
     h_max=8192) (the joint (H, skip) planner runs on the host), run 6
     root rounds with Session.straggler_policy(seed=0): some chunk drops a
     leaf, the last keeps all 128, the simulated async time is at most the
     synchronous one, the gap falls and w matches X^T alpha / (lambda m)
     within 1e-3; an always-participate policy (slow_prob=0) equals the
     synchronous run (torch.equal).  Then Schedule(rounds=5,
     level_rounds=[2], local_steps=8192, acceleration=0.5) on phase 3's
     problem: run(acceleration=0.0) equals phase 3's run (torch.equal),
     and the 0.5 run's gaps are printed and checked.  One launch per solve
     tick in each run;
 3e. checkpoints, kill and resume, elastic membership and fleets, on phase
     3's problem and tree.  (a) 5 rounds without a checkpoint, with
     CheckpointPolicy(every=1) and with async_save=True (seconds per root
     round of each, bytes per snapshot): each run torch.equal to phase 3's
     run on alpha, w, next_key and history; the snapshots past round 2 are
     deleted (the crash) and a freshly compiled session's resume equals it
     too.  (b) run_with_faults on phase 3b's compressed 16 x 8 session
     (int8 root, one (128, 512) residual): 6 rounds, every=2,
     FaultModel(crash_prob=0.5) at the first seed with a crash; the result
     equals the uninterrupted run.  (c) ElasticSession, 4 rounds: two
     leaves of the first group leave at round 1, an 8192-row leaf drawn on
     the card joins the last group at round 2; plan_diffs, leaves per
     launch (128, 126, 127) and peak memory printed; w within 1e-3 of
     X^T alpha / (lambda m), and the last round's gap below the first
     after the last boundary (round 2's is the old membership's).  (d)
     phase 3c's 8-config sweep with CheckpointPolicy(every=1) (one stacked
     group_base snapshot a round), the snapshots past round 3 deleted,
     Sweep(resume=) continues: every member torch.equal to 3c's sweep.
     Also verify_plan's time on the 128-leaf plan against
     Session.compile's.  The counts are zeroed and read around each leg;
 3f. the mesh backend, one process per leaf.  The host backend runs
     first, here, on two_level(4, 4, 8192) (phase 3's leaf shape: 16 x
     8192 rows of phase 3's seeded data, d = 512, ridge, lambda = 1e-4)
     under Schedule(rounds=5, level_rounds=[2], local_steps=8192), plain
     and int8.  Then 16 spawned gloo ranks share the card (each
     torch.cuda.set_device(0), each drawing the same data on the card and
     solving its own block): (a) Session.compile(backend="mesh") psum,
     alpha, w and gaps torch.equal to the host backend; (b)
     mesh_sync="reduce_scatter" within rtol 1e-5 / atol 1e-6; (c) the
     int8 schedule under both lowerings against the host's int8 run (psum
     torch.equal; reduce_scatter on w and X^T alpha / (lambda m) within
     1e-5 of max|host| plus the last messages' quanta, as phase 3b holds
     two routes: a reassociated sum can flip an int8 code); (d) a B = 2
     lambda sweep whose members are torch.equal to their standalone mesh
     runs.  Each rank zeroes its launch count before (a) and reads it
     after: one launch per solve tick, of one leaf; the sweep one launch
     per tick of 2 x 1.  (e) one NCCL rank on star(1, 8192): psum and
     reduce_scatter torch.equal to the host backend.  Prints seconds per
     root round, mesh against host (16 processes time-sharing one card,
     not a deployment's speed), the launches and the peak memory of each
     rank.  A failing rank fails the spawn, and every spawn and process
     group has a timeout;
  4. time the kernel (CUDA events, warm) and its plain version on one of
     the main path's own ticks, hold them against each other, and compute
     the kernel's bound from that tick's inputs; time it for every loss at
     that shape (ms per launch and us per dependent step);
  5. hold the flash_attention kernels against their plain version on the
     card: f32 (CUDA-core kernel) and bf16 (tensor-core kernel); causal
     with and without a window, non-causal; GQA H/KV in {10/1, 32/8, 4/4,
     8/2, 4/1}; seq_offset > 0; d in {16, 64, 80, 128, 256}; lengths that
     are not multiples of a tile; phase 11's models' shapes on both
     routes: GQA 40/8, 48/8 and 56/8 at d 128, 32/32 at d 64, and 32/8 at
     d 80 with a window of 4096 at S = 4096; and at B=1, S=4096, H=10,
     KV=1, d=256, window 2048, bf16;
  6. hold the rglru_scan kernel against its plain version on the card,
     bit for bit (torch.equal), on both routes with the launch counted on
     the route route() names: small shapes (S not a multiple of a 32-step
     stage, a tail block of channels), (B=4, S=4096, W=2560) f32, W % 4 !=
     0 and inputs 4 bytes past a 16-byte boundary (the cp.async route);
  7. the serving path: recurrentgemma-2b at full width (26 layers, d_model
     2560, attention_impl="flash"), weights drawn on the card from
     PRNGKey(0) as the reference draws them (the init's seconds by CUDA
     events and its peak memory printed), prompts from the same key,
     through repro_torch.launch.serve.generate: batch 4, 4096-token
     prompts, 32 generated tokens.  The launch counts are zeroed before
     and read after a prefill-only generate (8 flash, all on the
     tensor-core route, and 18 scan, all on the TMA route) and the full
     generate (the same: decode launches neither).  Logits must be finite
     and tokens in range; the same prefill through the plain route
     (attention_impl="xla_chunked" and the plain scan) must give
     last-position logits within LM_TOL; one warm prefill and a few
     decode steps run under torch.profiler;
  8. time the two LM kernels warm (CUDA events) at the serving shape beside
     their plain versions, their bounds (the scan's with its TB/s, its
     share of the bound and, as a yardstick of the card's streaming rate,
     one torch.mul over the same a and b) and, for flash attention, one
     F.scaled_dot_product_attention call with the same band mask (a
     yardstick only: the port never calls it);
  9. TreeSync LM training through Problem.lm + Session.compile(backend=
     "mesh") + LMSession.run: four gloo ranks share the card, one replica
     each, on a (pod, data, model) = (2, 2, 1) DeviceMesh,
     Topology.from_mesh(periods=(2, 2)) with the pod (root) edge
     int8-compressed.  recurrentgemma-2b at full width (d_model 2560,
     vocab 256000, tied, f32 params, bf16 activations, remat,
     xla_chunked attention, logits_chunk 512) cut to one (rec, rec, attn)
     block, Adafactor, batch 4 x 2048 tokens (one sequence a rank), 4
     steps (2 data syncs, 1 compressed pod sync; cut from 8 when phase 13
     came in, to keep the script near 900 s), from PRNGKey(0) (an
     init alone first, timed by CUDA events with its peak memory, and
     freed).  Every loss finite and the last two below the first; after
     each due sync the group's ranks hold torch.equal params; each rank's scan launches, zeroed before the
     run and read after, equal 2 rec layers x (forward + remat recompute +
     reverse) x 4; on rank 0 one step's gradients through the kernel match
     the plain route (autograd through the plain scan) within
     TRAIN_GRAD_TOL per leaf, every recurrent-layer leaf nonzero.  At
     SMOKE width in the same spawn: (a) periods=(1, 1) SGD at f32
     activations equals one process's data-parallel steps within
     STAR_TOL; (b) a checkpointed run stopped after step 4 and resumed by a
     fresh session is torch.equal to the uninterrupted run; (c) a
     straggler run drops a replica as the policy decides, losses finite.
     (d) phase 10b: LMSession.sweep(Sweep(lrs=[1e-3, 3e-3], seeds=[0,
     1], local_hs=[1, 2])) (B = 8) at SMOKE width with the int8 root,
     AdamW: one executor build, one data draw a step, B x the code's scan
     launches, every member torch.equal (params, optimizer state,
     residual, losses) to its standalone LMSession.run.
     Prints seconds per warm step and per outer round, sync seconds by
     level, tokens/s per rank and in total, peak memory per rank and the
     launches;
 10. the LM sweep at full width: phase 9's model (912,304,640 parameters,
     3.40 GiB f32), Adafactor, two gloo ranks sharing the card as (pod,
     data) = (1, 2), periods (2,), uncompressed, batch 2 x 2048 (one
     sequence a rank), 2 grid steps of LMSession.sweep(Sweep(lrs=[1e-3,
     3e-3], seeds=[0, 1])) (B = 4 members on each rank; the first
     without a sync, the second with one).  Cut against phase 9: no int8
     root (a residual per member would add 13.6 GiB a rank) and two
     ranks, not four; cut from 4 grid steps to 2 to keep the script near
     half its time limit.  Checks on each rank: one executor
     build for the grid (cache_stats), every loss finite, one data draw a
     grid step (not B), scan launches = B x the code's count; members 0
     and 3 (other lr and seed) torch.equal in params, optimizer state and
     losses to their standalone LMSession.run on the same ranks.  Prints
     the seconds of each grid step, the data draw and a member's local
     step (CUDA events the script records around them), a sync, and the
     peak per rank; then the reverse-time launch's ms
     at (1, 2048, 2560) beside the forward's, with its bytes bound;
 11. the other architectures' serving paths, through repro_torch.launch.
     serve.generate at batch 4, 4096-token prompts and 32 generated
     tokens, weights drawn on the card from PRNGKey(0) (the init's
     seconds by CUDA events and its peak printed), prompts from the same
     key.  The launch counts are zeroed before and read after a
     prefill-only generate and the whole request; each leg prints its
     prefill seconds, decode tokens/s and peak memory.  (a) h2o-danube-
     1.8b whole (24 layers, d_model 2560, 32/8 heads of 80, window 4096,
     attention_impl="flash"; the decode ring wraps): 24 flash launches in
     prefill, all on the tensor-core route, none in decode; the same
     prefill through xla_chunked within LM_TOL.  (b) dbrx-132b at full
     width (d_model 6144, 48/8 heads of 128, 16 experts of d_ff 10752,
     top 4, bf16) cut to DBRX_LAYERS = 2 layers (the whole model is
     ~246 GiB): 2 flash launches in prefill, none in decode; C in
     prefill and in a decode step, the share of tokens whose kept
     experts agree between the kernel and plain routes; rows whose last
     position kept the same experts within LM_TOL, and the plain route
     with the kernel route's experts pinned within LM_TOL on every row.
     (c) rwkv6-1.6b whole (24 layers, d_model 2048, f32): no flash or
     scan launch; a 4080-token prefill plus 16 teacher-forced decode
     steps within RWKV_TOL of a 4096-token prefill, at the config's bf16
     activations and at float32.  One warm prefill of each leg runs under
     torch.profiler (a 1024-token one for rwkv6).  The flash kernel is
     timed at (a)'s and (b)'s prefill shapes beside its plain version,
     its bound and one SDPA call.  Prints the phase's seconds.
 12. tensor parallelism inside a replica through launch/steps.py::
     build_cell, gloo ranks sharing the card (one card holds one NCCL
     rank): (a) recurrentgemma-2b FULL (26 layers, attention_impl=
     "flash") on (data, model) = (1, 2), two ranks: phase 7's PRNGKey(0)
     weights drawn whole on each rank and cut to its shards, build_cell's
     prefill at batch 4 x 4096 (phase 7's prompts) then 16 greedy decode
     steps.  The counts are zeroed before the prefill: each rank must
     launch flash 8 times at its local (B 4, S 4096, H 5, KV 1, d 256) and
     the scan 18 times at (4, 4096, 1280), and nothing in decode; the
     gathered last-position logits within LM_TOL of phase 7's (passed
     through build/tp_smoke/) and equal on both ranks; the share of greedy
     tokens agreeing with phase 7's is printed, with prefill seconds,
     decode tokens/s, collective seconds by axis and peak memory per
     rank.  (b) phase 9's model (full width, one (rec, rec, attn) block),
     AdamW (get_optimizer), on (data, model) = (2, 2), four ranks, global
     batch 4 x 2048 from PRNGKey(1), two steps: the loss of step 1 within
     TP_LOSS_RTOL and every rank's parameter shards after it within
     TP_PARAM_TOL of the port's single-rank make_train_step (run first in
     this process), scan launches the code's count at (2, 2048, 1280);
     step seconds, collective seconds by axis and peak per rank.  (c)
     flash at (4, 4096, 5, 1, 256, window 2048) and the scan at (4, 4096,
     1280), the TP local shapes, timed as in phase 8.
 13. expert- and head-parallel serving through build_cell and TreeSync
     over tensor-parallel replicas, gloo ranks sharing the card.  (a)
     dbrx-132b at full width cut to DBRX_LAYERS = 2 layers on (data,
     model) = (1, 2), two ranks: PRNGKey(0) weights drawn whole and cut to
     each rank's 8 of 16 experts and 24 of 48 q heads (4 of 8 kv), phase
     11(b)'s prompts (batch 4 x 4096), prefill then 16 greedy decode
     steps.  Each rank must launch flash twice in prefill at (4, 4096, 24,
     4, 128), all on the tensor-core route, and nothing in decode; the
     gathered last-position logits equal on both ranks and within LM_TOL
     of phase 11(b)'s (passed through build/ep_smoke/) on the rows whose
     kept experts agree with phase 11's in both layers (the share of
     tokens whose kept experts agree printed per layer, as phase 11
     does).  (b) rwkv6-1.6b whole (24 layers, f32 params) head parallel on
     (1, 2): a 1024-token prefill at batch 4 and 16 teacher-forced decode
     steps at float32 activations, the prefill's and the last step's
     logits within RWKV_TOL["float32"] of the single-rank run made first
     in this process; then the same at the config's bf16 activations,
     whose difference is printed (two orders of the same bf16 sums
     diverge by 7-10% through 24 layers); no flash or scan launch.  Each leg prints prefill seconds, decode tokens/s, collective
     seconds by axis and peak memory per rank.  (c) phase 9's model,
     Adafactor, through Problem.lm + LMSession on (data, model) = (2, 2),
     four ranks (two replicas of two model ranks), Topology.from_mesh(
     periods=(2,)) with an int8 root, batch 4 x 2048, 2 steps (1 sync):
     every loss finite; after each sync the two ranks of a model
     coordinate hold torch.equal shards; step 1's loss within TP_LOSS_RTOL
     of the mean of the port's single-rank steps on each replica's rows
     (run first in this process), each rank's shards after step 1 within
     TP_PARAM_TOL (an unfactored entry whose rounding-small gradient took
     the other sign, and so Adafactor's same step the other way, counted
     apart), their second moments within TP_MOMENT_NORM_REL and
     their updates within TP_UPDATE_NORM_REL of its replica's; scan
     launches the code's count at (2, 2048, 1280); the consensus whole.
     Prints seconds per warm step and per sync and peak per rank.  (d)
     flash at (a)'s local shape (4, 4096, 24, 4, 128), timed as in phase 8.
 14. the cost count (src/repro_torch/launch/steps.py::CellProgram.lower,
     on meta tensors on the host, no kernel launched and no launch count
     moved): phase 7's cell
     (recurrentgemma-2b FULL, flash, prefill 4 x 4096 into a 4128-slot
     cache, one rank) must count phase 7's launches by shape (flash 8 at
     (4, 4096, 4096, 10, 1, 256), the scan 18 at (4, 4096, 2560)); its
     roofline terms and lower bound (launch/roofline.py on launch/hw.py's
     H100 peaks, flops priced by dtype) and the model-flops share (MFU)
     are printed beside phase 7's warm prefill seconds, the bound at most
     ROOFLINE_SLACK of them; its estimated peak within
     PEAK_RATIO of phase 7's max_memory_allocated; and phase 12(a)'s TP
     prefill on (1, 2), counted for rank 0, must count the collective
     calls by axis each of its ranks made.

Prints the card's name and power limit, the build seconds, the kernel and
plain times, the run's seconds per root round and peak device memory, the
serving path's prefill seconds, decode tokens/s and peak memory, the
script's own seconds, then one JSON line describing each kernel (the
sdca_block row's launches are phase 3's run; its launches_by_path gives
every path's launches and leaves per launch -- phase 3b's pilot and run,
3c's two sweeps, 3d's straggler and accelerated runs, 3e's checkpoint,
kill-and-resume, elastic and fleet legs, 3f's mesh run per rank -- and
"batched" the batched launch's ms, bound and error; the flash row's
launches_by_path gives the serving path's and phase 11's requests, and
its by_shape phase 11's prefill shapes; the rglru_scan row's
launches_by_path gives the serving path's and, per rank, phase 9's, 10b's
and 10's; both add phase 12's and phase 13's per rank, "tp_by_shape" phase 12(a)'s
local shapes, "tp_local_shape" phase 12(c)'s timing and, in the flash row,
"ep_local_shape" phase 13(d)'s) and, last, the device line.  Needs
one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' bounds are taken on src/repro_torch/launch/hw.py's H100 SXM
# peaks (HBM_BW, PEAK_FLOPS_F32, PEAK_FLOPS_BF16) and each kernel's cost()

# |kernel - plain| <= TOL * max(1, max|plain|) per output: both run in
# float32 but sum <w, x_i> in different orders, and the differences ride
# along H dependent steps; on the logistic loss the 8 Newton steps near
# the edge of (0, 1) amplify them further.
TOL = 1e-3
# the compressed run, kernel route against plain route, on w and on X^T
# alpha / (lambda m): ROUTE_TOL x max|plain| (the sums' order, as TOL
# above), plus, for each compressed depth, the largest block scale of its
# last message in either route: int8 codes flip between the routes, but
# error feedback re-sends each flip's difference at the next sync, so what
# stays is the last residual, within half a quantum per route
ROUTE_TOL = TOL
# flash attention, |kernel - plain| per element: float32 softmax in both,
# summed in other orders; bf16 outputs are rounded to 8 mantissa bits
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the serving path's last-position logits, kernel route against the plain
# route, as a share of max|plain logits|: bf16 activations through 26
# layers, where the routes round P (bf16 in the plain einsum, f32 in the
# kernel) and sum in other orders
LM_TOL = 5e-2


# the kernels of this package, by the names the profiler shows
PORT_KERNELS = ("sdca_block_kernel", "flash_fwd", "rglru_scan_kernel")


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


def time_plain_ms(fn, reps: int) -> float:
    """Like time_ms after one warm call (the plain versions are long)."""
    fn()
    return time_ms(fn, reps)


def capture_targets(ex, targets: list):
    """Record every error-feedback target ``ex.roundtrip`` is handed (as
    (depth, tensor)); ``del ex.roundtrip`` restores the method."""
    orig = ex.roundtrip

    def roundtrip(dd, target):
        targets.append((dd, target.clone()))
        return orig(dd, target)
    ex.roundtrip = roundtrip


def ef_allowance(ex, got: list, want: list):
    """Compare two routes' error-feedback targets (the same sequence of
    roundtrips) on the rows of the executor's int8 groups.  Returns (int8
    codes that differ, codes compared, the sum over the compressed depths
    of the largest block scale of that depth's last message in either
    route)."""
    import torch
    from repro_torch.core import compression as comp
    flips, codes, last = 0, 0, {}
    for (dd, g), (dd2, w) in zip(got, want, strict=True):
        assert dd == dd2
        for kind, _, rows in ex.comp_groups[dd]:
            if kind != comp.KIND_INT8:
                continue
            gc, gs = comp.quantize_int8(g[rows], keep_leading=1)
            wc, ws = comp.quantize_int8(w[rows], keep_leading=1)
            flips += int((gc != wc).sum())
            codes += gc.numel()
            last[dd] = float(torch.maximum(gs, ws).max())
    return flips, codes, sum(last.values())


def compressed_path(problem, dev, card: str) -> dict:
    """Phase 3b: the compressed, delay-planned session on phase 3's
    problem (see the module docstring).  Returns the kernel's launches in
    the pilot and in the run, and the route comparison's largest error."""
    import torch
    from repro_torch.api import Problem, Schedule, Session, Topology
    from repro_torch.core import compression as comp
    from repro_torch.core import dual, prng
    from repro_torch.core.engine import host as host_mod
    from repro_torch.core.engine import plan as plan_mod
    from repro_torch.kernels.sdca import kernel
    lam = problem.lam
    t_lp, group_delay, root_delay = 1e-6, 1e-4, 5e-2
    sched = Schedule.auto(t_total=60.0, C="auto", compression="auto",
                          h_max=8192)

    def two_level(n_groups, per_group):
        return Topology.two_level(n_groups, per_group, 8192, t_lp=t_lp,
                                  group_delay=group_delay,
                                  root_delay=root_delay)

    # phase 3's 8 x 16 tree: fit_C caps C at the smallest group size (8,
    # the root's fan-out), and at that cap eq. (12) keeps the root
    # uncompressed.  Its pilot runs on the card and its plan is printed, to
    # show whether the fit reaches the cap; those launches count nowhere.
    # The run uses the same 128 leaves as 16 groups of 8, whose root
    # fan-out (16) sits above the cap.
    n0 = kernel.LAUNCHES
    s8 = Session.compile(problem, two_level(8, 16), sched, backend="cuda",
                         device=dev)
    kernel.LAUNCHES = n0
    print(f"compressed path: two_level(8, 16): fitted C = {s8.fitted_C!r} "
          f"(cap 8), specs top-down {s8.resolved.compression}, H per level "
          f"{[row['H'] for row in s8.level_plan]}")
    del s8

    topo = two_level(16, 8)
    print(f"compressed path: Topology.two_level(16, 8, 8192, t_lp={t_lp}, "
          f"group_delay={group_delay}, root_delay={root_delay}), "
          f"Schedule.auto(t_total=60.0, C='auto', compression='auto', "
          f"h_max=8192), m={problem.m} d={problem.d} lam={lam}")
    pilot = plan_mod.compile_tree(Schedule().resolve(topo).chunk_tree)
    pilot_ticks = int((pilot.solve_mask.max(axis=1) > 0).sum()) * \
        sched.delay.pilot_rounds
    torch.cuda.synchronize()
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    sess = Session.compile(problem, topo, sched, backend="cuda", device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    pilot_launches = kernel.LAUNCHES
    if pilot_launches != pilot_ticks:
        raise AssertionError(f"the C pilot launched sdca_block "
                             f"{pilot_launches} times for {pilot_ticks} "
                             f"solve ticks")
    r = sess.resolved
    print(f"compressed path: compile {compile_s:.3f} s with the C pilot "
          f"({pilot_launches} launches on the card), fitted C = "
          f"{sess.fitted_C!r}")
    for row in sess.level_plan:
        print(f"compressed path: level {row['name']}: H={row['H']} "
              f"spec={row.get('compress')} round_time="
              f"{row['round_time']!r} s delay={row['delay']!r} s")
    print(f"compressed path: specs top-down {r.compression}, planned "
          f"{r.rounds} root rounds in 60 s")
    plain_plan = plan_mod.compile_tree(r.chunk_tree, weighting=r.weighting)
    plain_bytes = plan_mod.plan_bytes_per_round(plain_plan, problem.d)
    plain_time = r.chunk_tree.solve_time()
    print(f"compressed path: bytes per root round "
          f"{sess.bytes_per_round!r} against {plain_bytes!r} uncompressed "
          f"({sess.bytes_per_round / plain_bytes:.5f}); simulated "
          f"per_round_time {r.per_round_time!r} s against {plain_time!r} s "
          f"uncompressed")
    if r.compression[0] in (None, "", "none"):
        raise AssertionError(f"the planner left the root level "
                             f"uncompressed: {r.compression}")

    solves = int(sess.executor.solves.sum())
    rounds, more = 5, 2
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sess.run(rounds=rounds, key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = sess.run(rounds=more, warm_start=res)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    gaps = list(res.gaps) + list(res2.gaps)
    print(f"compressed path: {solves} solve ticks per root round, "
          f"{launches} sdca_block launches in the run, "
          f"gaps={[f'{g:.6e}' for g in gaps]}")
    print(f"compressed path: {(t1 - t0) / rounds:.4f} s per root round "
          f"(cold run), {(t2 - t1) / more:.4f} s per root round (warm "
          f"run); peak device memory {peak / 2**30:.3f} GiB  [{card}]")
    if launches != solves * (rounds + more):
        raise AssertionError(f"sdca_block launched {launches} times, the "
                             f"run had {solves * (rounds + more)} solve "
                             f"ticks")
    if not all(math.isfinite(g) for g in gaps):
        raise AssertionError(f"non-finite gap in {gaps}")
    if not gaps[-1] < gaps[0]:
        raise AssertionError(f"duality gap did not fall: {gaps}")
    w_ref = dual.w_of_alpha(res2.alpha, problem.X, lam)
    w_err = float((res2.w - w_ref).abs().max())
    w_scale = float(w_ref.abs().max())
    print(f"compressed path: max|w - X^T alpha/(lam m)| = {w_err:.3e} "
          f"(max|X^T alpha/(lam m)| {w_scale:.3e})")
    if not w_err <= 1e-3 * w_scale:
        raise AssertionError("w drifted from X^T alpha / (lam m)")
    profile_round(sess, res2, card)
    n0 = kernel.LAUNCHES

    # ---- integer exactness: card against CPU on the run's own targets ---
    ex = sess.executor
    targets: list = []
    capture_targets(ex, targets)
    sess.run(rounds=1, warm_start=res2, record_history=False)
    del ex.roundtrip
    k_default = comp.topk_count(problem.d, comp.DEFAULT_TOPK_FRAC)
    for dd, tgt in targets:
        host = tgt.cpu()
        codes, scale = comp.quantize_int8(tgt, keep_leading=1)
        hcodes, hscale = comp.quantize_int8(host, keep_leading=1)
        same = (torch.equal(codes.cpu(), hcodes)
                and torch.equal(scale.cpu(), hscale)
                and torch.equal(comp.int8_roundtrip(tgt, 1).cpu(),
                                comp.int8_roundtrip(host, 1)))
        for k in (k_default, problem.d // 4):
            same = same and torch.equal(comp.topk_indices(tgt, k).cpu(),
                                        comp.topk_indices(host, k))
        if not same:
            raise AssertionError(f"depth {dd}: int8 codes, scales or top-k "
                                 f"indices differ between card and CPU")
    print(f"compressed path: int8 codes, scales, roundtrips and top-k "
          f"indices (k={k_default}, {problem.d // 4}) of {len(targets)} "
          f"error-feedback targets ({tuple(targets[0][1].shape)}) from one "
          f"warm round equal on card and CPU")

    # ---- compression="none": the uncompressed plan and flat executor ----
    h_leaf, h_group = sess.level_plan[0]["H"], sess.level_plan[1]["H"]
    s_none = Session.compile(problem, topo, Schedule(
        rounds=2, level_rounds=[h_group], local_steps=h_leaf,
        compression="none"), backend="cuda", device=dev)
    if s_none.plan.has_compression or \
            s_none.plan.fingerprint != plain_plan.fingerprint:
        raise AssertionError("compression='none' is not the uncompressed "
                             "plan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_n = s_none.run(key=prng.PRNGKey(1), record_history=False)
    torch.cuda.synchronize()
    none_s = (time.perf_counter() - t0) / 2
    # the flat executor restarts from (alpha, w) every root round
    ex_n = s_none.executor
    lm = host_mod.regularizer_scale(lam, problem.m)
    keys = prng.as_key(plan_mod.chunked_key_plan(
        s_none.resolved.chunk_tree, s_none.plan, prng.PRNGKey(1), 2)).to(dev)
    part = torch.as_tensor(plan_mod.full_participation(s_none.plan),
                           device=dev)
    steps = torch.as_tensor(plan_mod.full_steps(s_none.plan), device=dev)
    alpha_f = torch.zeros_like(problem.y)
    w_f = torch.zeros(problem.d, device=dev)
    for t in range(2):
        alpha_f, w_f = ex_n(s_none.data, keys[t], alpha_f, w_f, part, steps,
                            lm)
    if not (torch.equal(alpha_f, run_n.alpha) and torch.equal(w_f, run_n.w)):
        raise AssertionError("compression='none': Session.run differs from "
                             "the flat executor")
    print(f"compressed path: compression='none' (H={h_leaf}, "
          f"{h_group} group rounds, 2 root rounds) is the uncompressed "
          f"plan, and its run equals the flat executor's (torch.equal); "
          f"{none_s:.4f} s per root round (cold run)  [{card}]")

    # ---- kernel route against plain route at a reduced shape ------------
    m_s = 16 * 1024
    prob_s = Problem.ridge(problem.X[:m_s], problem.y[:m_s], lam=lam)
    topo_s = Topology.two_level(2, 8, 1024)
    sched_s = Schedule(rounds=3, level_rounds=[2], local_steps=1024,
                       compression="int8")
    out, secs, targets_of = {}, {}, {}
    for backend in ("cuda", "torch"):
        s_r = Session.compile(prob_s, topo_s, sched_s, backend=backend,
                              device=dev)
        targets_of[backend] = []
        capture_targets(s_r.executor, targets_of[backend])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = s_r.run(key=prng.PRNGKey(2), record_history=False)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
    kernel.LAUNCHES = n0
    # a last-ulp difference between the routes' targets can flip an int8
    # code, and the differences the chain builds up flip many more; error
    # feedback keeps what the flips leave in the end state to the last
    # residual of each compressed depth, within half a quantum of that
    # message's block per route (every leaf attends every sync of this
    # symmetric tree, so each captured row is a message)
    flips, codes, quanta = ef_allowance(s_r.executor, targets_of["cuda"],
                                        targets_of["torch"])
    worst = 0.0
    for label, got, want in (
            ("w", out["cuda"].w, out["torch"].w),
            ("X^T alpha/(lam m)", dual.w_of_alpha(out["cuda"].alpha,
                                                  prob_s.X, lam),
             dual.w_of_alpha(out["torch"].alpha, prob_s.X, lam))):
        err = float((got - want).abs().max())
        allow = ROUTE_TOL * float(want.abs().max()) + quanta
        print(f"compressed path, kernel vs plain route (16 x 1024, d=512, "
              f"H=1024, int8, 3 root rounds): max|d {label}| = {err:.3e}, "
              f"allowed {allow:.3e} ({ROUTE_TOL} x max|plain| + the last "
              f"messages' quanta {quanta:.3e}); {flips} of {codes} int8 "
              f"codes differ between the routes; cuda {secs['cuda']:.3f} s, "
              f"torch {secs['torch']:.3f} s  [{card}]")
        if not err <= allow:
            raise AssertionError(f"kernel and plain routes disagree on "
                                 f"{label}: {err} > {allow}")
        worst = max(worst, err)
    return {"pilot_launches": pilot_launches, "launches": launches,
            "route_err": worst, "fitted_C": sess.fitted_C, "session": sess}


def sweep_path(problem, topo, dev, card, h: int = 8192) -> dict:
    """Phase 3c: batched sweeps through Session.sweep on phase 3's problem
    (see the module docstring; ``h`` is the leaves' H).  Returns each
    sweep's launches and leaves per launch, and the batched launch's
    timing, error and bound."""
    import torch
    from repro_torch.api import Schedule, Session
    from repro_torch.core import dual
    from repro_torch.core.engine import host as host_mod
    from repro_torch.kernels.sdca import kernel, ref
    from repro_torch.launch import hw
    rounds = 5
    sched = Schedule(rounds=rounds, level_rounds=[2], local_steps=h,
                     h_cap=h)
    sess = Session.compile(problem, topo, sched, backend="cuda", device=dev)
    n, solves = topo.n_leaves, int(sess.executor.solves.sum())
    grids = {"sweep": dict(lams=[1e-3, 3e-4, 1e-4, 3e-5], seeds=[0, 1]),
             "sweep_local_hs": dict(lams=[1e-4], local_hs=[h // 4, h])}
    out, sets = {}, {}
    for name, grid in grids.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.LAUNCHES = kernel.LEAVES = 0
        t0 = time.perf_counter()
        rs = sess.sweep(**grid)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, leaves = kernel.LAUNCHES, kernel.LEAVES
        peak = torch.cuda.max_memory_allocated()
        B = len(rs)
        print(f"sweep path: Session.sweep({', '.join(f'{k}={v}' for k, v in grid.items())}) "
              f"on {topo.n_leaves} leaves, m={problem.m} d={problem.d}: "
              f"B={B}, {launches} sdca_block launches for {solves * rounds} "
              f"solve ticks, {leaves} leaves ({leaves // max(launches, 1)} "
              f"a launch); {secs / rounds:.4f} s per root round for all "
              f"{B} configs; peak device memory {peak / 2**30:.3f} GiB  "
              f"[{card}]")
        if launches != solves * rounds or leaves != launches * B * n:
            raise AssertionError(f"{name}: {launches} launches of {leaves} "
                                 f"leaves, expected {solves * rounds} of "
                                 f"{B * n} leaves each")
        single_s = []
        for pt in rs.points:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = sess.run(key=pt.key(), lam=pt.lam, local_h=pt.local_h)
            torch.cuda.synchronize()
            single_s.append((time.perf_counter() - t0) / rounds)
            mem = rs[pt.index]
            if not (torch.equal(mem.alpha, single.alpha)
                    and torch.equal(mem.w, single.w)):
                raise AssertionError(f"{name} member {pt.to_dict()} differs "
                                     f"from its standalone Session.run")
            gaps = mem.gaps
            if not (all(math.isfinite(g) for g in gaps)
                    and gaps[-1] < gaps[0]):
                raise AssertionError(f"{name} member {pt.to_dict()}: the "
                                     f"gap did not fall: {list(gaps)}")
            w_ref = dual.w_of_alpha(mem.alpha, problem.X, pt.lam)
            w_err = float((mem.w - w_ref).abs().max())
            w_scale = float(w_ref.abs().max())
            print(f"sweep path: {name} {pt.to_dict()}: gaps "
                  f"{gaps[0]:.6e} -> {gaps[-1]:.6e}, max|w - X^T "
                  f"alpha/(lam m)| {w_err:.3e} of {w_scale:.3e}, torch.equal "
                  f"to its standalone run")
            if not w_err <= 1e-3 * w_scale:
                raise AssertionError(f"{name}: w drifted from X^T alpha / "
                                     f"(lam m)")
        print(f"sweep path: {name}: standalone runs {single_s[0]:.4f} s per "
              f"root round (first), {min(single_s):.4f} (fastest) against "
              f"{secs / rounds:.4f} for the batch of {B}  [{card}]")
        out[name] = {"launches": launches, "leaves_per_launch": leaves //
                     launches, "s_per_round": secs / rounds,
                     "single_s_per_round": min(single_s), "peak": peak}
        sets[name] = rs

    # one more root round of the 8-config sweep under the profiler (its
    # launches come after the counts were read)
    n0 = (kernel.LAUNCHES, kernel.LEAVES)
    profile_window(lambda: sess.sweep(rounds=1, record_history=False,
                                      **grids["sweep"]),
                   "one root round of the 8-config sweep", card)
    kernel.LAUNCHES, kernel.LEAVES = n0

    # ---- the batched launch on the 8-config sweep's first tick ----------
    rs = sets["sweep"]
    ex, data = sess.executor, sess.data
    B, K, m_b, d = len(rs), n, sess.plan.m_b, problem.d
    keys = prng_first_tick(sess, rs)
    idx = ex.draw_idx(keys.to(dev))
    mk = torch.ones((B, K, sess.plan.h_max), device=dev)
    a = torch.zeros((B, K * m_b), device=dev)
    a[:, ex.flat_map] = rs.alphas
    a = a.view(B, K, m_b)
    w = rs.ws[:, None, :].expand(B, K, d).contiguous()
    lms = [host_mod.regularizer_scale(pt.lam, problem.m) for pt in rs.points]
    xsq = torch.stack([data.sqnorm / v for v in lms])
    args = (data.Xb, data.yb, a, w, xsq, idx)
    n0 = (kernel.LAUNCHES, kernel.LEAVES)
    got = kernel.sdca_block_launch_batched(*args, loss=problem.loss, lms=lms,
                                           step_mask=mk)
    for b in range(B):
        one = kernel.sdca_block_launch(
            data.Xb, data.yb, a[b], w[b], xsq[b], idx[b], loss=problem.loss,
            lm=lms[b], step_mask=mk[b])
        if not (torch.equal(got[0][b], one[0])
                and torch.equal(got[1][b], one[1])):
            raise AssertionError(f"config {b} of the batched launch differs "
                                 f"from its one-config launch")
    t0 = time.perf_counter()
    want = ref.sdca_steps_ref_batched(
        data.Xb, data.yb, a[:1], w[:1], xsq[:1], idx[:1], loss=problem.loss,
        lms=lms[:1], step_mask=mk[:1])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err((got[0][:1], got[1][:1]), want)
    ms = time_ms(lambda: kernel.sdca_block_launch_batched(
        *args, loss=problem.loss, lms=lms, step_mask=mk), 3)
    kernel.LAUNCHES, kernel.LEAVES = n0
    H = idx.shape[2]
    # the least work (kernels/sdca/kernel.py::cost): each distinct sampled
    # row of a leaf (over all configs) read once
    rows = sum(int(torch.unique(idx[:, k]).numel()) for k in range(K))
    flops, nbytes = kernel.cost(rows, B, K, m_b, d, H)
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.PEAK_FLOPS_F32 * 1e3
    print(f"sdca_block batched launch, the 8-config sweep's first tick (B={B} "
          f"K={K} m_b={m_b} d={d} H={H}, {B * K} blocks): kernel {ms:.4f} "
          f"ms/launch ({ms / B:.4f} ms a config), every config torch.equal "
          f"to its one-config launch, config 0 against the plain version "
          f"max_abs_err {err:.3e} (plain {plain_ms:.1f} ms for that one "
          f"config), bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
          f"{flops} flop)  [{card}]")
    out["batched"] = {"B": B, "ms": ms, "max_abs_err": err,
                      "bound_ms": max(t_bytes, t_ops)}
    out["session"], out["sweep_set"] = sess, sets["sweep"]
    return out


def prng_first_tick(sess, rs):
    """The (B, n, 2) keys of the first solve tick of each sweep member."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.engine import plan as plan_mod
    return torch.stack([prng.as_key(plan_mod.chunked_key_plan(
        sess.resolved.chunk_tree, sess.plan, pt.key(), 1))[0, 0]
        for pt in rs.points])


def straggler_accel_path(problem, topo, plain_run, fitted_C, dev, card,
                         h: int = 8192) -> dict:
    """Phase 3d: a straggler-planned session on phase 3b's 16 x 8 tree and
    an accelerated session on phase 3's tree (see the module docstring;
    ``h`` is the leaves' H and their examples).  Returns the launches of
    each run."""
    import torch
    from repro_torch.api import Schedule, Session, Topology
    from repro_torch.core import dual, prng
    from repro_torch.core.delay import StragglerModel
    from repro_torch.kernels.sdca import kernel
    from repro_torch.runtime.straggler import StragglerPolicy
    out = {}
    model = StragglerModel(slow_prob=0.1, slow_factor=20.0)
    topo_s = Topology.two_level(16, 8, h, t_lp=1e-6, group_delay=1e-4,
                                root_delay=5e-2)
    sched = Schedule.auto(t_total=60.0, C=fitted_C, straggler=model,
                          h_max=h)
    t0 = time.perf_counter()
    sess = Session.compile(problem, topo_s, sched, backend="cuda",
                           device=dev)
    plan_s = time.perf_counter() - t0
    r = sess.resolved
    print(f"straggler path: Topology.two_level(16, 8, {h}, t_lp=1e-6, "
          f"group_delay=1e-4, root_delay=5e-2), Schedule.auto(t_total=60.0, "
          f"C={fitted_C!r}, straggler={model}, h_max={h}): planned in "
          f"{plan_s:.2f} s (host), skip={r.skip}, level plan "
          f"{r.level_plan}, {r.rounds} root rounds in 60 s")
    n, solves, rounds = topo_s.n_leaves, int(sess.executor.solves.sum()), 6
    pol = sess.straggler_policy(seed=0)
    torch.cuda.synchronize()
    kernel.LAUNCHES = kernel.LEAVES = 0
    t0 = time.perf_counter()
    res = sess.run(rounds=rounds, key=prng.PRNGKey(0), straggler=pol)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    parts = [h["participants"] for h in res.history[1:]]
    last = res.history[-1]
    w_ref = dual.w_of_alpha(res.alpha, problem.X, problem.lam)
    w_err = float((res.w - w_ref).abs().max())
    w_scale = float(w_ref.abs().max())
    print(f"straggler path: {rounds} root rounds, participants per chunk "
          f"{parts}, simulated time {last['time']!r} s against "
          f"{last['time_sync']!r} s synchronous, gaps "
          f"{[f'{g:.6e}' for g in res.gaps]}, max|w - X^T alpha/(lam m)| "
          f"{w_err:.3e} of {w_scale:.3e}; {launches} launches of "
          f"{leaves // max(launches, 1)} leaves for {solves * rounds} solve "
          f"ticks; {secs / rounds:.4f} s per root round  [{card}]")
    if launches != solves * rounds or leaves != launches * n:
        raise AssertionError(f"straggler run: {launches} launches of "
                             f"{leaves} leaves for {solves * rounds} ticks")
    if not (min(parts) < n and parts[-1] == n):
        raise AssertionError(f"straggler run dropped no leaf or ended "
                             f"without a full barrier: {parts}")
    if not last["time"] <= last["time_sync"]:
        raise AssertionError("simulated async time exceeds the sync time")
    gaps = res.gaps
    if not (all(math.isfinite(g) for g in gaps) and gaps[-1] < gaps[0]):
        raise AssertionError(f"straggler run: the gap did not fall: {gaps}")
    if not w_err <= 1e-3 * w_scale:
        raise AssertionError("straggler run: w drifted from X^T alpha / "
                             "(lam m)")
    out["straggler"] = {"launches": launches, "leaves_per_launch":
                        leaves // launches}
    n0 = (kernel.LAUNCHES, kernel.LEAVES)
    calm = StragglerPolicy(model=StragglerModel(slow_prob=0.0,
                                                slow_factor=20.0),
                           max_consecutive=int(r.skip), seed=0)
    res_calm = sess.run(rounds=rounds, key=prng.PRNGKey(0), straggler=calm)
    sync = sess.run(rounds=rounds, key=prng.PRNGKey(0))
    kernel.LAUNCHES, kernel.LEAVES = n0
    calm_parts = [h["participants"] for h in res_calm.history[1:]]
    if not (calm_parts == [n] * rounds
            and torch.equal(res_calm.alpha, sync.alpha)
            and torch.equal(res_calm.w, sync.w)):
        raise AssertionError(f"the always-participate policy differs from "
                             f"the synchronous run (participants "
                             f"{calm_parts})")
    print(f"straggler path: an always-participate policy (slow_prob=0) kept "
          f"all {n} leaves in every chunk and equals the synchronous run "
          f"(torch.equal); sync gaps {[f'{g:.6e}' for g in sync.gaps]}")

    # ---- acceleration on phase 3's tree ---------------------------------
    acc_sched = Schedule(rounds=5, level_rounds=[2], local_steps=h,
                         acceleration=0.5)
    acc = Session.compile(problem, topo, acc_sched, backend="cuda",
                          device=dev)
    solves = int(acc.executor.solves.sum())
    torch.cuda.synchronize()
    kernel.LAUNCHES = kernel.LEAVES = 0
    r0 = acc.run(key=prng.PRNGKey(0), acceleration=0.0)
    t0 = time.perf_counter()
    r5 = acc.run(key=prng.PRNGKey(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    if not (torch.equal(r0.alpha, plain_run.alpha)
            and torch.equal(r0.w, plain_run.w)):
        raise AssertionError("run(acceleration=0.0) differs from the plain "
                             "session's run")
    if launches != 2 * 5 * solves or leaves != launches * topo.n_leaves:
        raise AssertionError(f"accelerated runs: {launches} launches of "
                             f"{leaves} leaves for {2 * 5 * solves} ticks")
    w_ref = dual.w_of_alpha(r5.alpha, problem.X, problem.lam)
    w_err = float((r5.w - w_ref).abs().max())
    w_scale = float(w_ref.abs().max())
    gaps = r5.gaps
    print(f"accelerated path: Schedule(rounds=5, level_rounds=[2], "
          f"local_steps={h}, acceleration=0.5) on phase 3's problem: "
          f"run(acceleration=0.0) equals the plain run (torch.equal), gap "
          f"after 5 rounds {r0.gaps[-1]:.6e}; acceleration 0.5: gaps "
          f"{[f'{g:.6e}' for g in gaps]}, max|w - X^T alpha/(lam m)| "
          f"{w_err:.3e} of {w_scale:.3e}; {launches} launches of "
          f"{leaves // launches} leaves; {secs / 5:.4f} s per root round  "
          f"[{card}]")
    if not (all(math.isfinite(g) for g in gaps) and gaps[-1] < gaps[0]):
        raise AssertionError(f"accelerated run: the gap did not fall: {gaps}")
    if not w_err <= 1e-3 * w_scale:
        raise AssertionError("accelerated run: w drifted from X^T alpha / "
                             "(lam m)")
    out["accelerated"] = {"launches": launches, "leaves_per_launch":
                          leaves // launches}
    return out


def _crash_after(root, step: int) -> None:
    """Delete every snapshot after ``step`` under ``root``: the crash."""
    for f in Path(root).rglob("step_*.*"):
        if int(f.name.split(".")[0].split("_")[1]) > step:
            f.unlink()


def _same_run(a, b) -> bool:
    import torch
    return (torch.equal(a.alpha, b.alpha) and torch.equal(a.w, b.w)
            and torch.equal(a.next_key, b.next_key)
            and a.history == b.history)


def elastic_path(problem, topo, sched, sess, plain_run, compressed, swept,
                 dev, card) -> dict:
    """Phase 3e: checkpoints and resume, kill and resume, an elastic
    session and a resumed fleet on phase 3's problem (see the module
    docstring).  ``sched`` / ``sess`` / ``plain_run`` are phase 3's
    schedule, session and 5-round run, ``compressed`` / ``swept`` what
    phases 3b / 3c returned.  Returns each leg's launches and leaves per
    launch."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.analysis import verify_plan
    from repro_torch.api import (CheckpointPolicy, ElasticSession,
                                 FaultModel, MembershipLog, Schedule,
                                 Session, Sweep, run_with_faults)
    from repro_torch.core import dual, prng
    from repro_torch.data.synthetic import gaussian_regression
    from repro_torch.kernels.sdca import kernel
    out = {}
    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "checkpoints"
    scratch.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=scratch))
    n, rounds = topo.n_leaves, 5
    solves = int(sess.executor.solves.sum())

    # ---- verify_plan on every compile: its share of Session.compile -----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = Session.compile(problem, topo, sched, backend="cuda",
                            device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_plan(fresh.plan)
    verify_s = time.perf_counter() - t0
    print(f"elastic path: verify_plan on the {n}-leaf plan "
          f"{verify_s * 1e3:.3f} ms against Session.compile's "
          f"{compile_s * 1e3:.3f} ms (which runs it)")

    # ---- (a) checkpoint and resume ---------------------------------------
    torch.cuda.synchronize()
    kernel.LAUNCHES = kernel.LEAVES = 0
    secs = {}
    runs = {}
    for label, policy in (
            ("none", None),
            ("every=1", CheckpointPolicy(work / "sync", every=1, keep=5)),
            ("every=1 async", CheckpointPolicy(work / "async", every=1,
                                               keep=5, async_save=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = sess.run(key=prng.PRNGKey(0), checkpoint=policy)
        torch.cuda.synchronize()
        secs[label] = (time.perf_counter() - t0) / rounds
    for label, r in runs.items():
        if not _same_run(r, plain_run):
            raise AssertionError(f"the {label} run differs from phase 3's "
                                 f"uncheckpointed run")
    snap = work / "sync" / "step_0000000001.npz"
    snap_bytes = snap.stat().st_size + snap.with_suffix(".json").stat(
        ).st_size
    _crash_after(work / "sync", 2)
    again = Session.compile(problem, topo, sched, backend="cuda",
                            device=dev)
    resumed = again.resume(work / "sync")
    torch.cuda.synchronize()
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    if not _same_run(resumed, plain_run):
        raise AssertionError("the run resumed after round 2 differs from "
                             "the uncheckpointed run")
    want = solves * (3 * rounds + (rounds - 2))
    if launches != want or leaves != launches * n:
        raise AssertionError(f"checkpoint leg: {launches} launches of "
                             f"{leaves} leaves, expected {want} of {n}")
    print(f"elastic path: 5 root rounds on {n} leaves, seconds per root "
          f"round: {secs['none']:.4f} without a checkpoint, "
          f"{secs['every=1']:.4f} with CheckpointPolicy(every=1), "
          f"{secs['every=1 async']:.4f} with async_save=True; "
          f"{snap_bytes} bytes per snapshot; both runs and a fresh "
          f"session's resume after the snapshots past round 2 were "
          f"deleted torch.equal to the uncheckpointed run (alpha, w, "
          f"next_key, history); {launches} launches of {n} leaves  [{card}]")
    out["checkpoint"] = {"launches": launches, "leaves_per_launch": n}
    # two checkpointed root rounds under the profiler (after the count)
    profile_window(lambda: sess.run(rounds=2, key=prng.PRNGKey(0),
                                    checkpoint=CheckpointPolicy(
                                        work / "profiled", every=1)),
                   "two root rounds with CheckpointPolicy(every=1)", card)
    kernel.LAUNCHES, kernel.LEAVES = launches, leaves

    # ---- (b) kill and resume on phase 3b's compressed session -----------
    sess_c = compressed["session"]
    fm = FaultModel(crash_prob=0.5)
    seed = next(s for s in range(100) if fm.sample_crashes(6, s))
    ref_c = sess_c.run(6, key=prng.PRNGKey(0))
    solves_c = int(sess_c.executor.solves.sum())
    torch.cuda.synchronize()
    kernel.LAUNCHES = kernel.LEAVES = 0
    t0 = time.perf_counter()
    res_c, report = run_with_faults(
        sess_c, 6, checkpoint=CheckpointPolicy(work / "faults", every=2),
        fault=fm, key=prng.PRNGKey(0), seed=seed)
    torch.cuda.synchronize()
    fault_s = time.perf_counter() - t0
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    legs = report["crashes"][0] + sum(
        r["ran_to"] - r["resumed_from"] for r in report["restarts"])
    print(f"elastic path: run_with_faults on the compressed 16 x 8 session "
          f"(specs {sess_c.resolved.compression}, {len(sess_c.executor.res_slot)} "
          f"residual of ({sess_c.plan.n_leaves}, {problem.d})): 6 rounds, "
          f"every=2, FaultModel(crash_prob=0.5), seed {seed}, crashes "
          f"{report['crashes']}, restarts {report['restarts']}; "
          f"{legs} root rounds run in {fault_s:.3f} s; {launches} launches "
          f"of {leaves // max(launches, 1)} leaves  [{card}]")
    if not report["crashes"]:
        raise AssertionError("the fault model sampled no crash")
    if not _same_run(res_c, ref_c):
        raise AssertionError("the killed-and-resumed compressed run differs "
                             "from the uninterrupted run")
    if launches != solves_c * legs or leaves != launches * n:
        raise AssertionError(f"kill-and-resume leg: {launches} launches of "
                             f"{leaves} leaves for {solves_c * legs} ticks")
    out["kill_resume"] = {"launches": launches, "leaves_per_launch": n}

    # ---- (c) elastic: two leaves leave, one joins ------------------------
    first, last = topo.tree.children[0], topo.tree.children[-1]
    m_leaf = first.children[0].data_size
    Xj, yj = gaussian_regression(m=m_leaf, d=problem.d, seed=1, device=dev)
    gone = [first.children[0].name, first.children[1].name]
    log = (MembershipLog().leave(gone[0], at_round=1)
           .leave(gone[1], at_round=1)
           .join("J0", Xj, yj, at_round=2, parent=last.name))
    es = ElasticSession(problem, topo, Schedule(level_rounds=[2],
                                                local_steps=8192,
                                                weighting="size"),
                        backend="cuda", device=dev)
    per_launch = []
    launch = kernel.sdca_block_launch_batched

    def logged(*a, **k):
        n0 = kernel.LEAVES
        got = launch(*a, **k)
        per_launch.append(kernel.LEAVES - n0)
        return got
    kernel.sdca_block_launch_batched = logged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = kernel.LEAVES = 0
    t0 = time.perf_counter()
    try:
        res_e = es.run(4, membership=log, key=prng.PRNGKey(0))
        torch.cuda.synchronize()
    finally:
        kernel.sdca_block_launch_batched = launch
    elastic_s = time.perf_counter() - t0
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    peak = torch.cuda.max_memory_allocated()
    cur = es.current_problem
    w_ref = dual.w_of_alpha(res_e.alpha, cur.X, cur.lam)
    w_err = float((res_e.w - w_ref).abs().max())
    w_scale = float(w_ref.abs().max())
    gaps = {h["round"]: h["gap"] for h in res_e.history}
    diffs = [{k: v for k, v in d.items() if k != "weights_changed"}
             | {"weights_changed": len(d["weights_changed"])}
             for d in es.plan_diffs]
    print(f"elastic path: ElasticSession on {n} leaves, 4 rounds, "
          f"{gone} leave at round 1, J0 ({m_leaf} rows) joins {last.name} at "
          f"round 2: m {problem.m} -> {cur.m}, plan_diffs {diffs}; "
          f"leaves per launch {per_launch}; gaps "
          f"{[f'{g:.6e}' for g in res_e.gaps]}; max|w - X^T alpha/(lam m)| "
          f"{w_err:.3e} of {w_scale:.3e}; {elastic_s:.3f} s; peak device "
          f"memory {peak / 2**30:.3f} GiB  [{card}]")
    want = [n] * solves + [n - 2] * solves + [n - 1] * 2 * solves
    if per_launch != want or launches != len(want):
        raise AssertionError(f"elastic run: leaves per launch {per_launch}, "
                             f"expected {want}")
    if cur.m != problem.m - m_leaf or \
            tuple(res_e.alpha.shape) != (cur.m,):
        raise AssertionError("elastic run: the spliced problem's size")
    if not w_err <= 1e-3 * w_scale:
        raise AssertionError("elastic run: w drifted from X^T alpha / "
                             "(lam m)")
    # the history's round-2 gap is the old membership's; the new one's
    # first is round 3's, and the solve must go on closing it
    if not (all(math.isfinite(g) for g in res_e.gaps)
            and gaps[4] < gaps[3]):
        raise AssertionError(f"elastic run: the gap did not fall after the "
                             f"last boundary: {gaps}")
    out["elastic"] = {"launches": launches,
                      "leaves_per_launch": list(dict.fromkeys(per_launch))}
    del es, res_e, cur, Xj, yj

    # ---- (d) a checkpointed fleet, crashed and resumed -------------------
    sess_s, ref_s = swept["session"], swept["sweep_set"]
    grid = dict(lams=[1e-3, 3e-4, 1e-4, 3e-5], seeds=[0, 1])
    B = len(ref_s)
    torch.cuda.synchronize()
    kernel.LAUNCHES = kernel.LEAVES = 0
    t0 = time.perf_counter()
    sess_s.sweep(Sweep(**grid), checkpoint=CheckpointPolicy(work / "fleet",
                                                             every=1))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    files = sorted(p.name for p in (work / "fleet" / "group_base").iterdir())
    _crash_after(work / "fleet", 3)
    rs = sess_s.sweep(Sweep(**grid, resume=work / "fleet"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, leaves = kernel.LAUNCHES, kernel.LEAVES
    solves_s = int(sess_s.executor.solves.sum())
    for b in range(B):
        if not (torch.equal(rs.alphas[b], ref_s.alphas[b])
                and torch.equal(rs.ws[b], ref_s.ws[b])):
            raise AssertionError(f"resumed fleet member {b} differs from "
                                 f"the uncheckpointed sweep")
    if not np.array_equal(rs.gaps, ref_s.gaps):
        raise AssertionError("resumed fleet histories differ")
    want = solves_s * (rounds + rounds - 3)
    if launches != want or leaves != launches * B * n:
        raise AssertionError(f"fleet leg: {launches} launches of {leaves} "
                             f"leaves, expected {want} of {B * n}")
    print(f"elastic path: Session.sweep({grid}) with CheckpointPolicy("
          f"every=1): {files} in group_base; {(t1 - t0) / rounds:.4f} s per "
          f"root round for all {B} configs; after the snapshots past round "
          f"3 were deleted, Sweep(resume=) ran 2 rounds in {t2 - t1:.3f} s "
          f"and every member is torch.equal to the uncheckpointed sweep; "
          f"{launches} launches of {leaves // launches} leaves  [{card}]")
    out["fleet"] = {"launches": launches, "leaves_per_launch": B * n}
    shutil.rmtree(work)
    print(f"elastic path: phase 3e took {time.perf_counter() - t_phase:.1f} "
          f"s  [{card}]")
    return out


# ---- phase 3f: the mesh backend, one process per leaf -----------------------
MESH_WORLD = 16          # gloo ranks sharing the card, one per leaf
MESH_LEAF = 8192         # phase 3's leaf shape: m_b = 8192, d = 512
MESH_ROUNDS = 5
MESH_LAMS = (1e-4, 1e-3)
# reduce_scatter against psum / the host: the group sum is reassociated.
# Under int8 a reassociated sum can also flip a code; as for phase 3b's
# two routes, error feedback leaves what the flips change in the end
# state to the last residual of each compressed depth, so the compressed
# reduce_scatter run is held on w and X^T alpha / (lambda m) to its rtol
# times max|host| plus the last messages' quanta (int8_quanta)
MESH_RS_TOL = dict(rtol=1e-5, atol=1e-6)
# the whole spawn (16 processes reaching the card, the runs, the joins)
MESH_SPAWN_TIMEOUT = 300.0


def _mesh_setup(dev, n_leaves: int):
    """Phase 3f's problem (phase 3's seeded data drawn on the card at
    n_leaves x 8192 rows, d = 512, ridge, lambda = 1e-4), tree and
    schedule: two_level(4, 4) for 16 leaves, a star for one."""
    from repro_torch.api import Problem, Schedule, Topology
    from repro_torch.data.synthetic import gaussian_regression
    X, y = gaussian_regression(m=n_leaves * MESH_LEAF, d=512, seed=0,
                               device=dev)
    topo = Topology.star(1, MESH_LEAF) if n_leaves == 1 else \
        Topology.two_level(4, 4, MESH_LEAF)
    return (Problem.ridge(X, y, lam=MESH_LAMS[0]), topo,
            Schedule(rounds=MESH_ROUNDS, level_rounds=[2] if n_leaves > 1
                     else None, local_steps=MESH_LEAF))


def _cpu_result(res) -> dict:
    return {"alpha": res.alpha.cpu(), "w": res.w.cpu(),
            "gaps": list(res.gaps)}


def _last_scales(ex, last: dict) -> None:
    """Record in ``last[depth]`` the largest int8 block scale of the last
    error-feedback target ``ex.roundtrip`` was handed at each depth."""
    from repro_torch.core import compression as comp
    orig = ex.roundtrip

    def roundtrip(dd, target):
        last[dd] = float(comp.quantize_int8(target, keep_leading=1)[1].max())
        return orig(dd, target)
    ex.roundtrip = roundtrip


def _timed_round(sess, warm) -> dict:
    """One more root round of a mesh session with its leaf solves and its
    collectives timed on the host clock, the card synchronized before and
    after each (so a collective's time is its own, not the queued work's):
    {"round_s", "solve_s", "collective_s", "collectives"}."""
    import torch
    ex = sess.executor
    acc = {"solve_s": 0.0, "collective_s": 0.0, "collectives": 0}

    def timed(fn, field, count=False):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[field] += time.perf_counter() - t0
            acc["collectives"] += int(count)
            return out
        return call
    ex.leaf_solve = timed(ex.leaf_solve, "solve_s")
    for comm in ex.comms:
        comm._gather = timed(comm._gather, "collective_s", True)
        comm.reduce_scatter = timed(comm.reduce_scatter, "collective_s",
                                    True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(rounds=1, warm_start=warm)
    torch.cuda.synchronize()
    acc["round_s"] = time.perf_counter() - t0
    del ex.leaf_solve
    for comm in ex.comms:
        del comm._gather, comm.reduce_scatter
    return acc


def _mesh_rank(rank: int, world: int, root: str, backend: str) -> None:
    """One rank of phase 3f, in a spawned process on card 0: the gloo
    world's runs (a)-(d), or the one-rank NCCL world's run (e).  Rank 0
    saves the results, every rank its launches, seconds and peak memory."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core import prng
    from repro_torch.kernels.sdca import kernel
    from repro_torch.runtime import ranks
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ranks.init(rank, world, f"file://{root}/pg_{backend}", backend=backend)
    t_init = time.perf_counter()
    problem, topo, sched = _mesh_setup(dev, world)
    key = prng.PRNGKey(0)
    out, stats = {}, {"init_s": t_init - t_start, "marks": []}

    def mark(label):
        torch.cuda.synchronize()
        stats["marks"].append((label, time.perf_counter() - t_start))

    def mesh(schedule=sched, **kw):
        return Session.compile(problem, topo, schedule, backend="mesh",
                               device=dev, **kw)

    if backend == "nccl":
        for sync in ("psum", "reduce_scatter"):
            out[sync] = _cpu_result(mesh(mesh_sync=sync).run(key=key))
    else:
        t0 = time.perf_counter()
        sess = mesh()
        stats["compile_s"] = time.perf_counter() - t0
        ticks = int(sess.executor.solves.sum()) * MESH_ROUNDS
        torch.cuda.synchronize()
        kernel.LAUNCHES = kernel.LEAVES = 0
        t0 = time.perf_counter()
        res = sess.run(key=key)                                     # (a)
        torch.cuda.synchronize()
        stats.update(psum_s=time.perf_counter() - t0, ticks=ticks,
                     launches=kernel.LAUNCHES, leaves=kernel.LEAVES)
        out["psum"] = _cpu_result(res)
        mark("(a) psum")
        rs = mesh(mesh_sync="reduce_scatter")
        mark("reduce_scatter compile")
        t0 = time.perf_counter()
        out["reduce_scatter"] = _cpu_result(rs.run(key=key))        # (b)
        torch.cuda.synchronize()
        stats["rs_s"] = time.perf_counter() - t0
        mark("(b) reduce_scatter")
        int8 = dataclasses.replace(sched, compression="int8")
        stats["int8_scales"] = {}
        for sync in ("psum", "reduce_scatter"):                     # (c)
            s8 = mesh(int8, mesh_sync=sync)
            if sync == "reduce_scatter":
                _last_scales(s8.executor, stats["int8_scales"])
            out[f"int8_{sync}"] = _cpu_result(s8.run(key=key))
        mark("(c) int8")
        kernel.LAUNCHES = kernel.LEAVES = 0
        swept = sess.sweep(lams=list(MESH_LAMS))                    # (d)
        torch.cuda.synchronize()
        stats.update(sweep_launches=kernel.LAUNCHES,
                     sweep_leaves=kernel.LEAVES)
        out["sweep"] = [_cpu_result(r) for r in swept]
        out["standalone"] = [out["psum"]] + [
            _cpu_result(sess.run(key=key, lam=lam)) for lam in MESH_LAMS[1:]]
        mark("(d) sweep and standalone")
        # after the counts and the checked runs: one warm psum round, timed
        stats["timed"] = _timed_round(sess, res)
    torch.cuda.synchronize()
    stats["total_s"] = time.perf_counter() - t_start
    stats["peak"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        torch.save(out, f"{root}/{backend}_results.pt")
    torch.save(stats, f"{root}/{backend}_stats{rank}.pt")
    dist.destroy_process_group()


def _same(a: dict, b: dict) -> bool:
    """alpha and w torch.equal, the gaps equal (host copies)."""
    import torch
    return (torch.equal(a["alpha"], b["alpha"])
            and torch.equal(a["w"], b["w"]) and a["gaps"] == b["gaps"])


def _rs_close(got: dict, want: dict) -> dict:
    """max |got - want| of alpha and of w, raising past MESH_RS_TOL."""
    import numpy as np
    err = {}
    for f in ("alpha", "w"):
        g, w = got[f].numpy(), want[f].numpy()
        np.testing.assert_allclose(g, w, **MESH_RS_TOL, err_msg=f)
        err[f] = float(np.abs(g - w).max())
    return err


def mesh_path(dev, card: str) -> dict:
    """Phase 3f: the mesh backend (see the module docstring).  The host
    runs go first, here; then 16 gloo ranks share the card, then one NCCL
    rank.  Returns the per-rank launches of run (a)."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.api import Session
    from repro_torch.core import dual, prng
    from repro_torch.runtime import ranks
    t_phase = time.perf_counter()
    root = ROOT / "build" / "mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    key = prng.PRNGKey(0)
    problem, topo, sched = _mesh_setup(dev, MESH_WORLD)
    host = Session.compile(problem, topo, sched, backend="cuda", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _cpu_result(host.run(key=key))
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / MESH_ROUNDS
    host8 = Session.compile(problem, topo,
                            dataclasses.replace(sched, compression="int8"),
                            backend="cuda", device=dev)
    host8_scales: dict = {}
    _last_scales(host8.executor, host8_scales)
    want_int8 = _cpu_result(host8.run(key=key))
    X = problem.X
    del problem, host, host8
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks.spawn(_mesh_rank, MESH_WORLD,
                args=(MESH_WORLD, str(root), "gloo"),
                timeout=MESH_SPAWN_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    got = torch.load(root / "gloo_results.pt", weights_only=False)
    stats = [torch.load(root / f"gloo_stats{r}.pt", weights_only=False)
             for r in range(MESH_WORLD)]
    mesh_s = max(st["psum_s"] for st in stats) / MESH_ROUNDS
    rs_s = max(st["rs_s"] for st in stats) / MESH_ROUNDS
    peaks = [st["peak"] / 2**30 for st in stats]
    gaps = got["psum"]["gaps"]
    print(f"mesh path: {MESH_WORLD} gloo ranks time-sharing one card (not a "
          f"deployment's speed), two_level(4, 4, {MESH_LEAF}), d=512, H="
          f"{MESH_LEAF}, {MESH_ROUNDS} rounds: psum {mesh_s:.4f} s per root "
          f"round, reduce_scatter {rs_s:.4f}, host backend {host_s:.4f}; "
          f"spawn and all runs {spawn_s:.1f} s  [{card}]")
    print("mesh path: rank 0's clock (s from its start): " + ", ".join(
        f"{label} {t:.2f}" for label, t in
        [("joined", stats[0]["init_s"]),
         ("first compile", stats[0]["init_s"] + stats[0]["compile_s"])]
        + stats[0]["marks"]) + f"; the slowest rank "
        f"{max(st['total_s'] for st in stats):.2f} in all")
    tm = stats[0]["timed"]
    print(f"mesh path: rank 0, one more warm psum root round with the card "
          f"synchronized around each leaf solve and collective: "
          f"{tm['round_s']:.4f} s, of which {tm['solve_s']:.4f} s in the "
          f"2 leaf solves (the kernel waiting its turn on the shared card) "
          f"and {tm['collective_s']:.4f} s in {tm['collectives']} gloo "
          f"all_reduces (the round's 3 syncs and its gathers of alpha and "
          f"w)  [{card}]")
    print(f"mesh path: sdca_block launches per rank "
          f"{[st['launches'] for st in stats]} for {stats[0]['ticks']} solve "
          f"ticks (1 leaf each); sweep {stats[0]['sweep_launches']} launches "
          f"of {len(MESH_LAMS)} x 1; peak device memory per rank (GiB) "
          f"{[f'{p:.3f}' for p in peaks]}  [{card}]")
    for r, st in enumerate(stats):
        if st["launches"] != st["ticks"] or st["leaves"] != st["ticks"]:
            raise AssertionError(f"rank {r}: {st['launches']} sdca_block "
                                 f"launches of {st['leaves']} leaves for "
                                 f"{st['ticks']} solve ticks")
        if st["sweep_launches"] != st["ticks"] or \
                st["sweep_leaves"] != len(MESH_LAMS) * st["ticks"]:
            raise AssertionError(f"rank {r}: the sweep made "
                                 f"{st['sweep_launches']} launches of "
                                 f"{st['sweep_leaves']} leaves")
    if not _same(got["psum"], want):                                # (a)
        raise AssertionError("mesh psum differs from the host backend")
    if not (all(math.isfinite(g) for g in gaps) and gaps[-1] < gaps[0]):
        raise AssertionError(f"mesh run: the gap did not fall: {gaps}")
    rs_err = _rs_close(got["reduce_scatter"], want)                 # (b)
    if not _same(got["int8_psum"], want_int8):                      # (c)
        raise AssertionError("compressed mesh psum differs from the host's "
                             "compressed run")
    # the last messages' quanta: per compressed depth, the larger of the
    # two runs' largest block scales (any rank's, for the mesh)
    quanta = sum(max([host8_scales[dd]] + [st["int8_scales"][dd]
                                           for st in stats])
                 for dd in host8_scales)
    rs8 = got["int8_reduce_scatter"]
    rs8_err = {}
    for label, g, w in (
            ("w", rs8["w"], want_int8["w"]),
            ("X^T alpha/(lam m)",
             dual.w_of_alpha(rs8["alpha"].to(dev), X, MESH_LAMS[0]).cpu(),
             dual.w_of_alpha(want_int8["alpha"].to(dev), X,
                             MESH_LAMS[0]).cpu())):
        rs8_err[label] = float((g - w).abs().max())
        allow = MESH_RS_TOL["rtol"] * float(w.abs().max()) + quanta
        if not rs8_err[label] <= allow:
            raise AssertionError(f"int8 reduce_scatter against the host's "
                                 f"int8 run: max|d {label}| "
                                 f"{rs8_err[label]} > {allow}")
    del X
    for lam, member, alone in zip(MESH_LAMS, got["sweep"],          # (d)
                                  got["standalone"], strict=True):
        if not _same(member, alone):
            raise AssertionError(f"mesh sweep member lam={lam} differs from "
                                 f"its standalone mesh run")
    print(f"mesh path: (a) psum torch.equal to the host backend (alpha, w, "
          f"gaps {gaps[0]:.6e} -> {gaps[-1]:.6e}); (b) reduce_scatter max "
          f"abs err alpha {rs_err['alpha']:.3e}, w {rs_err['w']:.3e} (rtol "
          f"1e-5, atol 1e-6); (c) int8 psum torch.equal, int8 "
          f"reduce_scatter max abs err w {rs8_err['w']:.3e}, X^T alpha/(lam "
          f"m) {rs8_err['X^T alpha/(lam m)']:.3e}, allowed 1e-5 x max|host| "
          f"+ the last messages' quanta {quanta:.3e}, alpha "
          f"{float((rs8['alpha'] - want_int8['alpha']).abs().max()):.3e}; "
          f"(d) lambda sweep B={len(MESH_LAMS)} members torch.equal to "
          f"their standalone mesh runs")

    # ---- (e) one NCCL rank on a one-leaf star -----------------------------
    problem1, topo1, sched1 = _mesh_setup(dev, 1)
    want1 = _cpu_result(Session.compile(problem1, topo1, sched1,
                                        backend="cuda", device=dev).run(
        key=key))
    del problem1
    ranks.spawn(_mesh_rank, 1, args=(1, str(root), "nccl"),
                timeout=MESH_SPAWN_TIMEOUT)
    got1 = torch.load(root / "nccl_results.pt", weights_only=False)
    for sync in ("psum", "reduce_scatter"):
        if not _same(got1[sync], want1):
            raise AssertionError(f"one-rank NCCL mesh ({sync}) differs from "
                                 f"the host backend")
    print(f"mesh path: (e) one NCCL rank, star(1, {MESH_LEAF}): psum and "
          f"reduce_scatter (all_gather_into_tensor, reduce_scatter_tensor, "
          f"all_reduce) torch.equal to the host backend; phase 3f took "
          f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return {"3f mesh": {"launches": stats[0]["launches"],
                        "leaves_per_launch": 1, "ranks": MESH_WORLD,
                        "launches_per_rank": [st["launches"]
                                              for st in stats]}}


def check_flash(dev) -> float:
    """Phase 5: the flash kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=dev).manual_seed(5)
    # (B, Sq, Sk, H, KV, D, causal, window, seq_offset)
    cases = [(2, 256, 256, 10, 1, 256, True, 96, 0),
             (1, 192, 192, 32, 8, 64, True, None, 0),
             (1, 128, 128, 4, 4, 80, False, None, 0),
             (2, 100, 100, 10, 1, 64, True, 30, 0),
             (1, 64, 320, 4, 4, 256, True, 100, 256),
             (1, 96, 200, 32, 8, 80, False, 50, 60),
             (1, 130, 300, 8, 2, 128, True, None, 5),
             (1, 70, 130, 4, 1, 16, True, 40, 10),
             # phase 11's models: GQA groups 5, 6 and 7 at d 128 (qwen2.5,
             # dbrx, yi / llava), MHA at d 64 (musicgen), and h2o-danube's
             # d 80 (the 128-wide panel with zero fill) with its window
             (1, 200, 200, 40, 8, 128, True, None, 0),
             (1, 160, 300, 48, 8, 128, True, 100, 140),
             (2, 130, 130, 56, 8, 128, True, None, 0),
             (1, 150, 150, 32, 32, 64, True, None, 0),
             (1, 4096, 4096, 32, 8, 80, True, 4096, 0)]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, Sq, Sk, H, KV, D, causal, window, off in cases + [
                (1, 4096, 4096, 10, 1, 256, True, 2048, 0)]:
            if D == 256 and Sq == 4096 and dtype != torch.bfloat16:
                continue
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, KV, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Sk, KV, D, generator=g, device=dev).to(dtype)
            before = fa.LAUNCHES_BY_ROUTE[fa.route(dtype, D)]
            got = fa.flash_attention_kernel(q, k, v, causal=causal,
                                            window=window, seq_offset=off)
            if fa.LAUNCHES_BY_ROUTE[fa.route(dtype, D)] != before + 1:
                raise AssertionError(f"{name} d={D} did not take the "
                                     f"{fa.route(dtype, D)} route")
            want = attention_ref(q, k, v, causal=causal, window=window,
                                 seq_offset=off)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            if not e <= FLASH_TOL[name]:
                raise AssertionError(
                    f"flash_attention disagrees with its plain version: "
                    f"{e} > {FLASH_TOL[name]} at {name} B={B} Sq={Sq} "
                    f"Sk={Sk} H={H} KV={KV} d={D} causal={causal} "
                    f"window={window} seq_offset={off}")
            worst = max(worst, e)
            print(f"check flash_attention {name:8s} "
                  f"({fa.route(dtype, D)}) B={B} Sq={Sq} Sk={Sk} "
                  f"H={H} KV={KV} d={D} causal={causal} window={window} "
                  f"seq_offset={off} max_abs_err={e:.3e}")
    return worst


def check_rglru(dev) -> float:
    """Phase 6: the scan kernel against its plain version on the card, bit
    for bit, on both routes."""
    import torch
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    # (B, S, W, offset): offset floats into the buffers a and b view
    for B, S, W, off in [(1, 1, 8, 0), (2, 300, 64, 0), (3, 37, 40, 0),
                         (2, 256, 2560, 0), (4, 4096, 2560, 0),
                         (2, 300, 6, 0), (3, 1000, 2562, 0),
                         (2, 300, 64, 1), (4, 4096, 2560, 1)]:
        n = B * S * W
        a = (0.9 + 0.1 * torch.rand(n + off, generator=g, device=dev)
             )[off:].view(B, S, W)
        b = torch.randn(n + off, generator=g, device=dev)[off:].view(B, S, W)
        h0 = torch.randn(B, W, generator=g, device=dev)
        name = rg.route(a, b)
        if name != ("tma" if W % 4 == 0 and off == 0 else "cp_async"):
            raise AssertionError(f"rglru_scan route {name} for W={W} "
                                 f"offset={off}")
        before = rg.LAUNCHES_BY_ROUTE[name]
        got = rg.rglru_scan_kernel(a, b, h0)
        if rg.LAUNCHES_BY_ROUTE[name] != before + 1:
            raise AssertionError(f"B={B} S={S} W={W} offset={off} did not "
                                 f"take the {name} route")
        want = rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        e = max_err(got, want)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"rglru_scan ({name}) is not bit-equal to "
                                 f"its plain version at B={B} S={S} W={W} "
                                 f"offset={off}: max abs err {e}")
        worst = max(worst, e)
        print(f"check rglru_scan ({name}) B={B} S={S} W={W} offset={off} "
              f"bit-equal, max_abs_err={e:.3e}")
    return worst


def profile_window(fn, label: str, card: str) -> None:
    """fn under torch.profiler: wall time, device busy share, device time
    by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    names = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top)
    ours = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                     f"ms x{e.count}" for e in kernels
                     if any(n in e.key for n in PORT_KERNELS)) or "none"
    share = f"{100 * busy_ms / wall_ms:.1f}%" if busy_ms else "not measured"
    print(f"profile, {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({share}); by kernel: {names}; the port's "
          f"kernels: {ours}  [{card}]")


def init_on_card(fn):
    """``fn()`` (a model or state init on the card) timed by CUDA events,
    the card's clock as for the kernels, with the peak device memory
    allocated while it ran: ``(result, {"s", "peak"})``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, {"s": start.elapsed_time(end) / 1e3,
                 "peak": torch.cuda.max_memory_allocated()}


def serve_path(dev, card: str, phase7_file: Path):
    """Phase 7: recurrentgemma-2b at full width through generate; its
    kernel route's last-position logits and the request's tokens go to
    ``phase7_file`` for phase 12(a).  Returns the request's launches and,
    for phase 14, the prefill's launches by shape, the warm request's
    prefill seconds and its peak device memory."""
    import dataclasses
    import torch
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    cfg = dataclasses.replace(recurrentgemma_2b.FULL, attention_impl="flash")
    B, S, gen = 4, 4096, 32
    kinds = cfg.layer_kinds()
    n_attn = sum(k == "attn" for k in kinds)
    n_rec = sum(k == "rec" for k in kinds)
    key = prng.PRNGKey(0)      # the reference CLI's key, for both draws
    params, init = init_on_card(lambda: transformer.init_params(
        cfg, key, device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} {n_params} parameters drawn on the card from "
          f"PRNGKey(0) in {init['s']:.3f} s, peak device memory "
          f"{init['peak'] / 2**30:.3f} GiB during the init  [{card}]")
    prompts = {"tokens": prng.randint(key, (B, S), 0,
                                      cfg.vocab_size).to(dev)}

    # prefill only (gen_tokens=1: no decode step), also the warm-up
    _zero_lm_counts()
    _, cold = generate(cfg, params, prompts, 1, device=dev)
    pre_shapes = {"flash_attention": dict(fa.LAUNCHES_BY_SHAPE),
                  "rglru_scan": dict(rg.LAUNCHES_BY_SHAPE)}
    pre = (fa.LAUNCHES, rg.LAUNCHES)
    pre_routes = dict(fa.LAUNCHES_BY_ROUTE)
    pre_scan_routes = dict(rg.LAUNCHES_BY_ROUTE)
    # the whole request: prefill then 31 decode steps
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    toks, stats = generate(cfg, params, prompts, gen, device=dev)
    launches = {"flash_attention": fa.LAUNCHES, "rglru_scan": rg.LAUNCHES}
    routes = dict(fa.LAUNCHES_BY_ROUTE)
    scan_routes = dict(rg.LAUNCHES_BY_ROUTE)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: batch {B}, prompt {S}, {gen} generated: prefill "
          f"{stats['prefill_s']:.4f} s (cold {cold['prefill_s']:.4f} s), "
          f"decode {stats['decode_s']:.4f} s = {stats['tok_per_s']:.2f} "
          f"tokens/s; peak device memory {peak / 2**30:.3f} GiB  [{card}]")
    print(f"serve: launches in prefill flash={pre[0]} {pre_routes} "
          f"scan={pre[1]} {pre_scan_routes}; in the whole request "
          f"flash={launches['flash_attention']} {routes} "
          f"scan={launches['rglru_scan']} {scan_routes}")
    if pre != (n_attn, n_rec):
        raise AssertionError(f"prefill launched (flash, scan) = {pre}, the "
                             f"model has ({n_attn}, {n_rec}) layers")
    for label, r in (("prefill", pre_routes), ("request", routes)):
        if r != {"wgmma": n_attn, "f32": 0}:
            raise AssertionError(f"{label}'s flash launches by route {r}: "
                                 f"the bf16 model's {n_attn} attention "
                                 f"layers must take the tensor-core kernel")
    for label, r in (("prefill", pre_scan_routes), ("request", scan_routes)):
        if r != {"tma": n_rec, "cp_async": 0}:
            raise AssertionError(f"{label}'s scan launches by route {r}: "
                                 f"the model's {n_rec} recurrences at W="
                                 f"{cfg.lru_width} must take the TMA route")
    if (launches["flash_attention"], launches["rglru_scan"]) != pre:
        raise AssertionError(f"decode launched kernels: {launches} over a "
                             f"prefill's {pre}")
    if tuple(toks.shape) != (B, gen) or toks.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(toks.shape)} {toks.dtype}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens out of the vocabulary")

    # the same prefill by the kernel route and by the plain route; logits
    # checked below are not part of the counted run
    with torch.no_grad():
        logits, cache = transformer.prefill(cfg, params, prompts,
                                            max_len=S + gen)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        dlogits, _ = transformer.decode_step(cfg, params, cache, nxt)
        del cache
        plain_cfg = dataclasses.replace(cfg, attention_impl="xla_chunked")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, _ = transformer.prefill(plain_cfg, params, prompts,
                                       max_len=S + gen,
                                       plain_recurrence=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    for name, t in (("prefill", logits), ("decode", dlogits)):
        if tuple(t.shape) != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} logits {tuple(t.shape)} not "
                                 f"finite or of the wrong shape")
    phase7_file.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"logits": logits.cpu(), "tokens": toks.cpu()}, phase7_file)
    err = float((logits - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"serve: last-position logits, kernel route vs plain route: max "
          f"abs diff {err:.4e}, max|plain| {scale:.4e} (tolerance "
          f"{LM_TOL} x max|plain|), argmax agreement {agree:.2f}; plain "
          f"route prefill {plain_s:.3f} s  [{card}]")
    if not err <= LM_TOL * scale:
        raise AssertionError("the kernel route's logits disagree with the "
                             "plain route's")

    def one_prefill():
        with torch.no_grad():
            transformer.prefill(cfg, params, prompts, max_len=S + gen)

    def decode_steps():
        generate(cfg, params, {"tokens": prompts["tokens"][:, :64]}, 5,
                 device=dev)

    n0 = (fa.LAUNCHES, rg.LAUNCHES)
    profile_window(one_prefill, f"one warm prefill (B={B}, S={S})", card)
    profile_window(decode_steps, "generate of 5 tokens after a 64-token "
                   "prompt (prefill + 4 decode steps)", card)
    fa.LAUNCHES, rg.LAUNCHES = n0
    return launches, {"by_shape": pre_shapes, "prefill_s": stats["prefill_s"],
                      "peak": peak}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_flash(dev, card: str, B: int, S: int, H: int, KV: int, D: int,
               win, label: str, seed: int = 8) -> dict:
    """The bf16 flash kernel warm (CUDA events) at one causal shape, beside
    its plain version, its bound and one F.scaled_dot_product_attention
    call with the same band mask (a yardstick only: the port never calls
    it).  Where the plain version's (B, H, S, S) float32 scores would not
    fit beside the other temporaries, it runs one batch row a call (the
    same work, B calls)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import hw

    n0 = (fa.LAUNCHES, dict(fa.LAUNCHES_BY_ROUTE))
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, KV, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, KV, D, generator=g, device=dev).bfloat16()
    run = lambda: fa.flash_attention_kernel(q, k, v, causal=True,  # noqa: E731
                                            window=win)
    by_row = B * H * S * S * 4 > 4 * 2 ** 30

    def plain():
        if not by_row:
            return attention_ref(q, k, v, causal=True, window=win,
                                 seq_offset=0)
        return torch.cat([attention_ref(q[b: b + 1], k[b: b + 1],
                                        v[b: b + 1], causal=True,
                                        window=win, seq_offset=0)
                          for b in range(B)])

    got, want = run(), plain()
    err = float((got.float() - want.float()).abs().max())
    if not err <= FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {label}: {err}")
    ms = time_ms(run, 10)
    plain_ms = time_plain_ms(plain, 2)
    pos = torch.arange(S, device=dev)
    band = pos[:, None] >= pos[None, :]
    if win is not None:
        band &= pos[:, None] - pos[None, :] < win
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib = sdpa().transpose(1, 2)
    lib_err = float((lib.float() - want.float()).abs().max())
    library_ms = time_ms(sdpa, 5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    sdpa_kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total)
    backend = sdpa_kernels[0].key if sdpa_kernels else "not measured"
    # the least work (kernel.py::cost): QK^T and PV over the visible
    # (query, key) pairs of this causal band; q, k, v read once, out
    # written once
    pairs = fa.visible_pairs(S, S, window=win)
    flops, nbytes = fa.cost(B, S, S, H, KV, D, window=win)
    t_ops = flops / hw.PEAK_FLOPS_BF16 * 1e3
    t_bytes = nbytes / hw.HBM_BW * 1e3
    print(f"flash_attention at {label} (B={B} S={S} H={H} KV={KV} d={D} "
          f"window={win} bf16, tensor-core kernel): kernel "
          f"{ms:.4f} ms/launch ({100 * max(t_ops, t_bytes) / ms:.1f}% of "
          f"its bound, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms{' (one batch row a call)' if by_row else ''}, "
          f"SDPA {library_ms:.4f} ms (band mask, enable_gqa; its top "
          f"kernel: {backend[:90]}; max abs diff from plain {lib_err:.3e}), "
          f"bound {max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f} ms: "
          f"{flops} flop over {pairs} visible pairs per (b, h) at the bf16 "
          f"tensor-core peak; bytes {t_bytes:.4f} ms: {nbytes} B), "
          f"max_abs_err {err:.3e}  [{card}]")
    fa.LAUNCHES = n0[0]
    fa.LAUNCHES_BY_ROUTE.update(n0[1])
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=library_ms, max_abs_err=err)


def time_lm_kernels(dev, card: str) -> dict:
    """Phase 8: the two LM kernels at the serving shape, warm, beside their
    plain versions, their bounds and (flash) one SDPA call."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg

    n0 = (fa.LAUNCHES, rg.LAUNCHES)
    B, S = 4, 4096
    out = {"flash_attention": time_flash(dev, card, B, S, 10, 1, 256, 2048,
                                         "the serving shape")}
    out["rglru_scan"] = time_scan(dev, card, B, S, 2560, "the serving shape")
    fa.LAUNCHES, rg.LAUNCHES = n0
    return out


def time_scan(dev, card: str, B: int, S: int, W: int, label: str) -> dict:
    """The scan kernel warm (CUDA events) at (B, S, W) f32, bit-equal to
    its plain version, beside the plain version's time and its bound."""
    import torch
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.launch import hw

    n0 = rg.LAUNCHES
    g = torch.Generator(device=dev).manual_seed(8)
    a = 0.9 + 0.1 * torch.rand(B, S, W, generator=g, device=dev)
    b = torch.randn(B, S, W, generator=g, device=dev)
    h0 = torch.zeros(B, W, device=dev)
    name = rg.route(a, b)
    got = rg.rglru_scan_kernel(a, b, h0)
    want = rglru_scan_ref(a, b, h0)
    err = max_err(got, want)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"rglru_scan is not bit-equal to its plain "
                             f"version at {label}")
    ms = time_ms(lambda: rg.rglru_scan_kernel(a, b, h0), 20)
    plain_ms = time_plain_ms(lambda: rglru_scan_ref(a, b, h0), 1)
    # the card's practical rate for the scan's traffic: an elementwise
    # product reads a and b and writes one (B, S, W) tensor, the scan's
    # bytes but h0 and h_last, with no recurrence (a yardstick, not the same
    # function)
    prod = torch.empty_like(a)
    stream_ms = time_ms(lambda: torch.mul(a, b, out=prod), 20)
    del prod
    flops, nbytes = rg.cost(B, S, W)
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.PEAK_FLOPS_F32 * 1e3
    print(f"rglru_scan at {label} (B={B} S={S} W={W} f32, {name} "
          f"route): kernel {ms:.4f} ms/launch "
          f"({nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{100 * max(t_ops, t_bytes) / ms:.1f}% of its bound), plain "
          f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms (bytes "
          f"{t_bytes:.4f} ms: {nbytes} B; operations {t_ops:.4f} ms: {flops} "
          f"flop), bit-equal to the plain version, max_abs_err {err:.3e}; "
          f"a and b read and one (B, S, W) tensor written by torch.mul(a, "
          f"b, out=) {stream_ms:.4f} ms "
          f"({3 * a.numel() * 4 / (stream_ms * 1e-3) / 1e12:.3f} TB/s)  "
          f"[{card}]")
    rg.LAUNCHES = n0
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, max_abs_err=err)


# ---- phase 9: TreeSync LM training, one rank per replica -------------------
TRAIN_WORLD = 4          # gloo ranks sharing the card, one per replica
TRAIN_MESH = (2, 2, 1)   # (pod, data, model)
TRAIN_PERIODS = (2, 2)   # data syncs every 2 steps, pod syncs every 4
TRAIN_STEPS = 4          # cut from 8 to keep the script near 900 s
TRAIN_BATCH, TRAIN_SEQ = 4, 2048       # one 2048-token sequence a rank
TRAIN_SPAWN_TIMEOUT = 900.0
# gradients through the kernel route against the plain route on one rank,
# per leaf, as a share of max|plain|: the scans agree to an ulp (forward
# bit-equal, backward the same recurrence), and bf16 activations round
# what follows them at the same points in both routes
TRAIN_GRAD_TOL = 1e-2
# the star special case at f32 activations, against one process's
# data-parallel steps on the global batch: the mean of four replicas'
# gradients against one batch's gradient, the sums reassociated
STAR_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_STRAGGLER = dict(slow_prob=0.3, slow_factor=50.0)
TRAIN_STRAGGLER_SEED = 1


def _train_cfg():
    """recurrentgemma-2b at full width, cut to one (rec, rec, attn) block."""
    import dataclasses
    from repro_torch.configs import recurrentgemma_2b
    return dataclasses.replace(recurrentgemma_2b.FULL, num_layers=3,
                               remat=True, attention_impl="xla_chunked",
                               logits_chunk=512)


def expected_scan_launches(cfg, steps: int) -> int:
    """Scan launches a replica makes in ``steps`` train steps, from the
    code: each recurrent layer launches the forward and the reverse-time
    launch of RGLRUScan.backward, and a layer inside a pattern block,
    under remat, the recomputed forward as well (the tail's layers run
    outside the checkpointed blocks, as in the reference)."""
    from repro_torch.models.transformer import block_layout
    pattern, n_full, tail = block_layout(cfg)
    in_blocks = n_full * sum(k == "rec" for k in pattern)
    in_tail = sum(k == "rec" for k in tail)
    return (in_blocks * (2 + int(cfg.remat)) + in_tail * 2) * steps


def _group_equal(group, tree) -> bool:
    """Whether every member of ``group`` (an LMComm group) holds the same
    bits in every tensor of ``tree``: the group's rows of each piece
    gathered and compared with this rank's."""
    import torch
    from repro_torch.core.engine.lm import SYNC_CHUNK
    from repro_torch.optim.api import tree_leaves
    comm, _ = group
    same = True
    for t in tree_leaves(tree):
        bits = t.detach().reshape(-1).view(torch.int32)
        for s in range(0, bits.numel(), SYNC_CHUNK):
            piece = bits[s:s + SYNC_CHUNK]
            rows = comm.gather_rows(piece[None])
            same &= bool((rows == piece[None]).all())
    return same


def _smoke_session(mesh, dev, cfg, opt, periods, schedule=None, **topo_kw):
    from repro_torch.api import Problem, Session, Topology
    prob = Problem.lm(cfg, opt, batch=8, seq=64, seed=0)
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=periods, **topo_kw)
    return Session.compile(prob, topo, schedule, backend="mesh", mesh=mesh,
                           device=dev)


def _train_rank(rank: int, world: int, root: str) -> None:
    """One replica of phase 9, in a spawned process on card 0: the
    full-width run with its checks, the gradient check (rank 0), then the
    SMOKE-width star, kill-and-resume and straggler runs.  Each rank saves
    its numbers; a failed check raises, which fails the spawn."""
    import dataclasses
    import os
    from datetime import timedelta

    # four processes share the card: let each return what it frees to its
    # own pool in whole segments, so peaks do not strand memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.api import (CheckpointPolicy, Problem, Schedule, Session,
                                 Sweep, Topology)
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.core import prng
    from repro_torch.core.delay import StragglerModel
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.optim import make_adafactor, make_adamw, make_sgd
    from repro_torch.optim.api import tree_leaves
    from repro_torch.runtime import ranks
    from repro_torch.runtime.straggler import StragglerPolicy
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ranks.init(rank, world, f"file://{root}/pg", backend="gloo",
               timeout=timedelta(seconds=TRAIN_SPAWN_TIMEOUT))
    mesh = init_device_mesh("cuda", TRAIN_MESH,
                            mesh_dim_names=("pod", "data", "model"))
    stats = {"init_s": time.perf_counter() - t_start}

    # ---- the full-width run ---------------------------------------------
    cfg = _train_cfg()
    prob = Problem.lm(cfg, make_adafactor(), batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, seed=0)
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=TRAIN_PERIODS)
    sess = Session.compile(prob, topo, Schedule(compression=("int8",
                                                             "none")),
                           backend="mesh", mesh=mesh, device=dev)
    cum = np.cumprod(TRAIN_PERIODS)
    synced = []

    def on_state(step, state):
        # the highest level due at this step: its group holds one model
        for level in (1, 0):
            if step % int(cum[level]) == 0:
                group = sess.comm.prefix[level]
                if not _group_equal(group, state.params):
                    raise AssertionError(
                        f"after step {step}'s level-{level} sync the group "
                        f"of replica {sess.replica} holds different params")
                synced.append((step, level))
                break

    # the init alone (PRNGKey(0), as the run draws it), timed and freed
    st, init = init_on_card(lambda: sess.init_state(prng.PRNGKey(0)))
    stats["init_card_s"], stats["init_peak"] = init["s"], init["peak"]
    del st
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rg.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sess.run(steps=TRAIN_STEPS, key=prng.PRNGKey(0), on_state=on_state)
    torch.cuda.synchronize()
    stats["run_s"] = time.perf_counter() - t0
    stats["launches"] = rg.LAUNCHES
    stats["peak"] = torch.cuda.max_memory_allocated()
    stats["history"] = res.history
    stats["sync_s"] = sess.sync_seconds()
    stats["sync_n"] = sess.sync_counts()
    stats["synced"] = synced
    losses = [h["loss"] for h in res.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    want = expected_scan_launches(cfg, TRAIN_STEPS)
    if stats["launches"] != want:
        raise AssertionError(f"rank {rank}: {stats['launches']} scan "
                             f"launches, the code makes {want}")

    # ---- the kernel route's gradients against the plain route (rank 0) --
    if rank != 0:
        del res
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        params = res.state.params
        res.state.residual = res.state.opt_state = None
        # alone on the card (the other ranks wait): one step's data draw
        # and its forward + backward, each timed warm after one untimed
        batch = sess._batch_at(TRAIN_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = sess._batch_at(TRAIN_STEPS)
        torch.cuda.synchronize()
        stats["draw_alone_s"] = time.perf_counter() - t0
        grads_of(cfg, params, batch)
        torch.cuda.synchronize()
        n0 = rg.LAUNCHES
        t0 = time.perf_counter()
        gk, mk = grads_of(cfg, params, batch)
        torch.cuda.synchronize()
        stats["grads_alone_s"] = time.perf_counter() - t0
        stats["grad_launches"] = rg.LAUNCHES - n0
        gp, mp = grads_of(cfg, params, batch, plain_recurrence=True)
        worst, rec_min = 0.0, float("inf")
        for blk in ("sub0", "sub1"):
            for g in gk["blocks"][blk]["mix"].values():
                rec_min = min(rec_min, float(g.abs().sum()))
        for x, y in zip(tree_leaves(gk), tree_leaves(gp), strict=True):
            scale = max(float(y.abs().max()), 1e-30)
            e = float((x - y).abs().max()) / scale
            if not e <= TRAIN_GRAD_TOL:
                raise AssertionError(f"kernel-route gradient differs from "
                                     f"the plain route by {e} of max|plain|")
            worst = max(worst, e)
        if not rec_min > 0:
            raise AssertionError("a recurrent-layer parameter got no "
                                 "gradient through the kernel")
        stats.update(grad_rel_err=worst, grad_loss=(float(mk["loss"]),
                                                    float(mp["loss"])))
        del gk, gp, params, res
        torch.cuda.empty_cache()
    dist.barrier()
    del sess

    # ---- (a) the star special case at SMOKE width ------------------------
    small32 = dataclasses.replace(recurrentgemma_2b.SMOKE,
                                  activation_dtype="float32")
    sgd = make_sgd(lr=0.05, momentum=0.0)
    star = _smoke_session(mesh, dev, small32, sgd, (1, 1))
    consensus = star.run(steps=3, key=0).consensus()
    if rank == 0:
        st = star.init_state(0)
        params, opt_state = st.params, st.opt_state
        dp = make_train_step(small32, sgd)
        for i in range(3):
            params, opt_state, _ = dp(params, opt_state, lm_batch(
                small32, 8, 64, i, seed=0, device=dev))
        err = 0.0
        for x, y in zip(tree_leaves(consensus), tree_leaves(params),
                        strict=True):
            torch.testing.assert_close(x, y, **STAR_TOL)
            err = max(err, float((x - y).abs().max()))
        stats["star_err"] = err

    # ---- (b) kill after step 4 and resume: the uninterrupted run ----------
    small = recurrentgemma_2b.SMOKE
    int8 = Schedule(compression=("int8", "none"))
    run_b = _smoke_session(mesh, dev, small, make_adamw(lr=1e-3),
                           TRAIN_PERIODS, int8)
    full = run_b.run(steps=6, key=0)
    pol = CheckpointPolicy(f"{root}/ckpt", every=1)
    run_b.run(steps=4, key=0, checkpoint=pol)
    fresh = _smoke_session(mesh, dev, small, run_b.problem.optimizer,
                           TRAIN_PERIODS, int8)
    resumed = fresh.resume(pol, steps=2)
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(full.state.params) + tree_leaves(full.state.opt_state)
        + tree_leaves(full.state.residual),
        tree_leaves(resumed.state.params) + tree_leaves(
            resumed.state.opt_state) + tree_leaves(resumed.state.residual),
        strict=True))
    if not same or [h["loss"] for h in full.history] != [
            h["loss"] for h in resumed.history]:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    stats["resume_equal"] = True

    # ---- (c) stragglers ------------------------------------------------
    topo_kw = dict(level_delays=[1e-3, 5e-2], t_lp=1e-3)
    strag = _smoke_session(mesh, dev, small, make_sgd(lr=0.05),
                           TRAIN_PERIODS, **topo_kw)

    def policy():
        return StragglerPolicy(model=StragglerModel(**TRAIN_STRAGGLER),
                               seed=TRAIN_STRAGGLER_SEED)
    out = strag.run(rounds=4, key=0, straggler=policy())
    losses = [h["loss"] for h in out.history]
    decide = policy()
    spr = strag.steps_per_round
    decide.bind(strag.topology.leaf_sync_delays(),
                t_compute=spr * strag.topology.leaf_t_lp(),
                t_lp=strag.topology.leaf_t_lp())
    want_parts = []
    for r in range(4):
        st = decide.step(final=r == 3)
        want_parts += [int(st.mask.sum())] * spr
    got_parts = [h["participants"] for h in out.history]
    if not all(np.isfinite(losses)) or got_parts != want_parts:
        raise AssertionError(f"straggler run: losses {losses}, participants "
                             f"{got_parts} against the policy's "
                             f"{want_parts}")
    if min(got_parts) == TRAIN_WORLD:
        raise AssertionError("the straggler policy dropped no replica")
    stats["straggler_participants"] = got_parts

    # ---- (d) phase 10b: an LM sweep at SMOKE width, int8 root -----------
    stats["smoke_sweep"] = smoke_sweep(mesh, dev, int8)
    torch.cuda.synchronize()
    stats["total_s"] = time.perf_counter() - t_start
    torch.save(stats, f"{root}/train_stats{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# ---- phase 10: the LM sweep ---------------------------------------------
SWEEP_WORLD = 2          # gloo ranks sharing the card, one per replica
SWEEP_MESH = (1, 2, 1)   # (pod, data, model): one sync level
SWEEP_PERIODS = (2,)
SWEEP_STEPS = 2          # one grid step without a sync, one with
SWEEP_BATCH = 2          # one 2048-token sequence a rank
SWEEP_LRS, SWEEP_SEEDS = [1e-3, 3e-3], [0, 1]
SWEEP_CHECKED = (0, 3)   # members held to their standalone runs
SMOKE_SWEEP = dict(lrs=[1e-3, 3e-3], seeds=[0, 1], local_hs=[1, 2])
SMOKE_SWEEP_STEPS = 4    # 10b: one outer round of periods (2, 2), int8 root


def _states_equal(a, b) -> bool:
    import torch
    from repro_torch.optim.api import tree_leaves

    def leaves(st):
        return (tree_leaves(st.params) + tree_leaves(st.opt_state)
                + (tree_leaves(st.residual) if st.residual is not None
                   else []))
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b),
                                                   strict=True))


def _sweep_checks(sess, rs, cfg, steps, c0, d0, launches) -> None:
    """Phase 10's checks on one rank: one executor build for the grid,
    finite losses, one data draw a step, the scan launches the code
    makes for B members."""
    import numpy as np
    c1 = sess.cache_stats()
    if c1["misses"] - c0["misses"] != 1:
        raise AssertionError(f"the grid built {c1['misses'] - c0['misses']}"
                             " executors, not one")
    if not np.isfinite(rs.losses).all() or rs.losses.shape != (len(rs),
                                                              steps):
        raise AssertionError(f"sweep losses {rs.losses}")
    if sess.draw_count - d0 != steps:
        raise AssertionError(f"{sess.draw_count - d0} data draws in "
                             f"{steps} grid steps: one a step, not B")
    want = len(rs) * expected_scan_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{launches} scan launches in the sweep, the "
                             f"code makes {want} for {len(rs)} members")


def smoke_sweep(mesh, dev, schedule) -> dict:
    """Phase 10b, on each of phase 9's ranks: Sweep(lrs, seeds, local_hs)
    at SMOKE width with phase 9's periods and int8 root; every member
    torch.equal to its standalone run (params, optimizer state, residual
    and losses)."""
    import torch
    from repro_torch.api import Sweep
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.optim import make_adamw
    cfg = recurrentgemma_2b.SMOKE
    sess = _smoke_session(mesh, dev, cfg, make_adamw(lr=1e-3), TRAIN_PERIODS,
                          schedule)
    c0, d0 = sess.cache_stats(), sess.draw_count
    torch.cuda.synchronize()
    rg.LAUNCHES = 0
    rs = sess.sweep(Sweep(**SMOKE_SWEEP), steps=SMOKE_SWEEP_STEPS)
    torch.cuda.synchronize()
    launches = rg.LAUNCHES
    _sweep_checks(sess, rs, cfg, SMOKE_SWEEP_STEPS, c0, d0, launches)
    for i, pt in enumerate(rs.points):
        one = sess.run(steps=SMOKE_SWEEP_STEPS, key=pt.seed, lr=pt.lr,
                       local_h=pt.local_h)
        if not _states_equal(one.state, rs.member_state(i)) or [
                h["loss"] for h in one.history] != rs.losses[i].tolist():
            raise AssertionError(f"SMOKE sweep member {i} ({pt}) differs "
                                 f"from its standalone run")
    return {"members": len(rs), "launches": launches,
            "losses": rs.losses.tolist()}


def _sweep_rank(rank: int, world: int, root: str) -> None:
    """One replica of phase 10, in a spawned process on card 0: the
    full-width sweep, its checks and the standalone runs of members 0 and
    3.  Each rank saves its numbers; a failed check fails the spawn.  The
    data draws and the local steps are timed on the card's clock by CUDA
    events recorded around each call, read after the sweep: the engine
    itself takes no host synchronize for them."""
    import os
    from datetime import timedelta

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.api import Problem, Session, Sweep, Topology
    from repro_torch.core.engine import lm as lm_mod
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.optim import make_adafactor
    from repro_torch.runtime import ranks
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ranks.init(rank, world, f"file://{root}/pg", backend="gloo",
               timeout=timedelta(seconds=TRAIN_SPAWN_TIMEOUT))
    mesh = init_device_mesh("cuda", SWEEP_MESH,
                            mesh_dim_names=("pod", "data", "model"))
    cfg = _train_cfg()
    prob = Problem.lm(cfg, make_adafactor(), batch=SWEEP_BATCH,
                      seq=TRAIN_SEQ, seed=0)
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"),
                              periods=SWEEP_PERIODS)
    sess = Session.compile(prob, topo, backend="mesh", mesh=mesh,
                           device=dev)
    stats = {}
    spans = {"draw": [], "local": []}

    def on_card_clock(fn, name):
        def timed(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return timed

    c0, d0 = sess.cache_stats(), sess.draw_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rg.LAUNCHES = 0
    local_step = lm_mod.LMStep.local_step
    sess._batch_at = on_card_clock(sess._batch_at, "draw")
    lm_mod.LMStep.local_step = on_card_clock(local_step, "local")
    t0 = time.perf_counter()
    try:
        rs = sess.sweep(Sweep(lrs=SWEEP_LRS, seeds=SWEEP_SEEDS),
                        steps=SWEEP_STEPS)
        torch.cuda.synchronize()
    finally:
        lm_mod.LMStep.local_step = local_step
        del sess._batch_at
    stats["sweep_s"] = time.perf_counter() - t0
    stats["launches"] = rg.LAUNCHES
    stats["peak"] = torch.cuda.max_memory_allocated()
    _sweep_checks(sess, rs, cfg, SWEEP_STEPS, c0, d0, stats["launches"])
    stats["step_s"] = list(rs.step_seconds)
    stats["draw_s"] = [e0.elapsed_time(e1) / 1e3 for e0, e1 in spans["draw"]]
    stats["local_s"] = [e0.elapsed_time(e1) / 1e3
                        for e0, e1 in spans["local"]]
    stats["sync_s"], stats["sync_n"] = sess.sync_seconds(), sess.sync_counts()
    stats["losses"] = rs.losses.tolist()
    stats["points"] = [(p.lr, p.seed) for p in rs.points]
    stats["best"] = rs.best()
    # members 0 and 3 (other lr and seed) against their standalone runs;
    # the other members are dropped first
    for i in range(len(rs)):
        if i not in SWEEP_CHECKED:
            rs.states[i] = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats["standalone_equal"] = []
    for i in SWEEP_CHECKED:
        pt = rs.points[i]
        n0 = rg.LAUNCHES
        one = sess.run(steps=SWEEP_STEPS, key=pt.seed, lr=pt.lr)
        same = _states_equal(one.state, rs.member_state(i)) and [
            h["loss"] for h in one.history] == rs.losses[i].tolist()
        if not same:
            raise AssertionError(f"sweep member {i} ({pt}) differs from its "
                                 f"standalone run")
        stats["standalone_equal"].append(i)
        stats.setdefault("standalone_launches", []).append(rg.LAUNCHES - n0)
        stats.setdefault("standalone_step_s", []).append(
            [h["sec"] for h in one.history])
        del one
        rs.states[i] = None
        torch.cuda.empty_cache()
    stats["standalone_peak"] = torch.cuda.max_memory_allocated()
    stats["total_s"] = time.perf_counter() - t_start
    torch.save(stats, f"{root}/sweep_stats{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def lm_sweep_path(dev, card: str) -> dict:
    """Phase 10 (see the module docstring): two gloo ranks share the card;
    returns each rank's scan launches and the timings."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.runtime import ranks
    t_phase = time.perf_counter()
    root = ROOT / "build" / "sweep_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = _train_cfg()
    ranks.spawn(_sweep_rank, SWEEP_WORLD, args=(SWEEP_WORLD, str(root)),
                timeout=TRAIN_SPAWN_TIMEOUT)
    stats = [torch.load(root / f"sweep_stats{r}.pt", weights_only=False)
             for r in range(SWEEP_WORLD)]
    shutil.rmtree(root, ignore_errors=True)
    B = len(SWEEP_LRS) * len(SWEEP_SEEDS)
    n_params = cfg.param_count()
    print(f"sweep path: recurrentgemma-2b at full width cut to "
          f"{cfg.num_layers} layers ({n_params} parameters, "
          f"{n_params * 4 / 2**30:.2f} GiB f32 a member), Adafactor, "
          f"Sweep(lrs={SWEEP_LRS}, seeds={SWEEP_SEEDS}) = {B} members on "
          f"each of {SWEEP_WORLD} gloo ranks time-sharing one card, "
          f"(pod, data) = {SWEEP_MESH[:2]}, periods {SWEEP_PERIODS}, "
          f"uncompressed, batch {SWEEP_BATCH} x {TRAIN_SEQ}, {SWEEP_STEPS} "
          f"grid steps; one executor build, one data draw a step")
    print(f"sweep path: losses by member {stats[0]['points']}: "
          f"{[[f'{x:.4f}' for x in row] for row in stats[0]['losses']]}, "
          f"best member {stats[0]['best']}")
    for r, s in enumerate(stats):
        warm = s["step_s"][1:]
        sync_n = max(sum(s["sync_n"]), 1)
        alone = [[f"{x:.3f}" for x in row] for row in s["standalone_step_s"]]
        print(f"sweep path rank {r}: {s['launches']} scan launches ({B} x "
              f"{expected_scan_launches(cfg, SWEEP_STEPS)} from the code), "
              f"grid steps {[f'{x:.3f}' for x in s['step_s']]} s "
              f"({np.mean(warm):.3f} s warm = {np.mean(warm) / B:.3f} s a "
              f"member), data draws {[f'{x:.3f}' for x in s['draw_s']]} s "
              f"on the card's clock ({np.mean(s['draw_s'][1:]):.3f} s warm), "
              f"local steps (forward + backward + Adafactor) "
              f"{np.mean(s['local_s'][B:]):.3f} s a member warm on the "
              f"card's clock (first step {np.mean(s['local_s'][:B]):.3f} s)"
              f", syncs "
              f"{sum(s['sync_s']):.3f} s over {sync_n} "
              f"({sum(s['sync_s']) / sync_n:.3f} s each), whole sweep "
              f"{s['sweep_s']:.1f} s with the inits; peak "
              f"{s['peak'] / 2**30:.2f} GiB (standalone runs "
              f"{s['standalone_peak'] / 2**30:.2f} GiB); members "
              f"{s['standalone_equal']} torch.equal to their standalone runs"
              f" (steps {alone} s); total {s['total_s']:.1f} s  [{card}]")
    print(f"sweep path: phase 10 took {time.perf_counter() - t_phase:.1f} s"
          f"  [{card}]")
    return {"launches": [s["launches"] for s in stats],
            "standalone_launches": [s["standalone_launches"] for s in stats],
            "expected_per_rank": B * expected_scan_launches(cfg,
                                                            SWEEP_STEPS)}


def time_reverse_scan(dev, card: str) -> dict:
    """The scan's reverse-time launch at the training shape (1, 2048, 2560)
    beside its forward launch, both with their bytes bound."""
    import torch
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.launch import hw
    n0 = rg.LAUNCHES
    B, S, W = 1, TRAIN_SEQ, 2560
    g = torch.Generator(device=dev).manual_seed(9)
    a = 0.9 + 0.1 * torch.rand(B, S, W, generator=g, device=dev)
    b = torch.randn(B, S, W, generator=g, device=dev)
    dh = torch.randn(B, S, W, generator=g, device=dev)
    h0 = torch.zeros(B, W, device=dev)
    a_next = torch.zeros_like(a)
    a_next[:, :-1] = a[:, 1:]
    ra = torch.flip(a_next, (1,)).contiguous()
    rb = torch.flip(dh, (1,)).contiguous()
    got = ops.reverse_scan(a, dh)
    want = torch.flip(rglru_scan_ref(ra, rb, h0)[0], (1,))
    if not torch.equal(got, want):
        raise AssertionError("the reverse-time launch is not bit-equal to "
                             "the plain backward recurrence")
    fwd_ms = time_ms(lambda: rg.rglru_scan_kernel(a, b, h0), 20)
    rev_ms = time_ms(lambda: rg.rglru_scan_kernel(ra, rb, h0), 20)
    op_ms = time_ms(lambda: ops.reverse_scan(a, dh), 20)
    plain_ms = time_plain_ms(lambda: rglru_scan_ref(ra, rb, h0), 1)
    flops, nbytes = rg.cost(B, S, W)
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.PEAK_FLOPS_F32 * 1e3
    bound = max(t_bytes, t_ops)
    print(f"rglru_scan at the training shape (B={B} S={S} W={W} f32): "
          f"forward launch {fwd_ms:.4f} ms, reverse-time launch {rev_ms:.4f} "
          f"ms ({100 * bound / rev_ms:.1f}% of its bound), the whole "
          f"reverse op (shift, two flips, launch, flip back) {op_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes "
          f"{t_bytes:.4f} ms: {nbytes} B), bit-equal to the plain backward "
          f"recurrence  [{card}]")
    rg.LAUNCHES = n0
    return {"forward_ms": fwd_ms, "ms": rev_ms, "op_ms": op_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def train_path(dev, card: str) -> dict:
    """Phase 9 (see the module docstring): four gloo ranks share the card,
    one replica each; returns the scan launches of each rank's full-width
    run and the timings."""
    import shutil

    import torch
    from repro_torch.runtime import ranks
    t_phase = time.perf_counter()
    root = ROOT / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = _train_cfg()
    want = expected_scan_launches(cfg, TRAIN_STEPS)
    ranks.spawn(_train_rank, TRAIN_WORLD, args=(TRAIN_WORLD, str(root)),
                timeout=TRAIN_SPAWN_TIMEOUT)
    stats = [torch.load(root / f"train_stats{r}.pt", weights_only=False)
             for r in range(TRAIN_WORLD)]
    shutil.rmtree(root, ignore_errors=True)
    n_params = cfg.param_count()
    steps = [[h["sec"] for h in s["history"]] for s in stats]
    warm = [sum(x[1:]) / (len(x) - 1) for x in steps]
    spr = TRAIN_PERIODS[0] * TRAIN_PERIODS[1]
    per_round = [sum(x) / (len(x) / spr) for x in steps]
    tok = TRAIN_SEQ * TRAIN_BATCH // TRAIN_WORLD
    losses = [h["loss"] for h in stats[0]["history"]]
    print(f"train path: recurrentgemma-2b at full width cut to "
          f"{cfg.num_layers} layers ({n_params} parameters, "
          f"{n_params * 4 / 2**30:.2f} GiB f32), Adafactor, bf16 "
          f"activations, remat, (pod, data) = (2, 2), periods "
          f"{TRAIN_PERIODS}, int8 root; {TRAIN_WORLD} processes "
          f"time-sharing one card, {tok} tokens a rank a step")
    print(f"train path: losses {[f'{x:.4f}' for x in losses]}; groups "
          f"torch.equal after each sync {stats[0]['synced']}")
    for r, s in enumerate(stats):
        print(f"train path rank {r}: {s['launches']} scan launches (the "
              f"code: {want}), {warm[r]:.3f} s per warm step, "
              f"{per_round[r]:.3f} s per outer round, syncs "
              f"{[f'{x:.3f}' for x in s['sync_s']]} s over "
              f"{s['sync_n']} (data, pod), {tok / warm[r]:.1f} tokens/s, "
              f"peak memory {s['peak'] / 2**30:.2f} GiB, process start "
              f"{s['init_s']:.1f} s, model init from PRNGKey(0) "
              f"{s['init_card_s']:.3f} s (peak {s['init_peak'] / 2**30:.3f}"
              f" GiB), run {s['run_s']:.1f} s, total "
              f"{s['total_s']:.1f} s  [{card}]")
    total_tok = TRAIN_WORLD * tok / max(warm)
    print(f"train path: {total_tok:.1f} tokens/s in total (4 processes "
          f"time-sharing one card, not a deployment's speed); gradient "
          f"check on rank 0: kernel route vs plain route within "
          f"{stats[0]['grad_rel_err']:.3e} of max|plain| per leaf "
          f"(alone on the card: the data draw {stats[0]['draw_alone_s']:.3f}"
          f" s, forward + backward {stats[0]['grads_alone_s']:.3f} s) "
          f"({stats[0]['grad_launches']} scan launches), losses "
          f"{stats[0]['grad_loss']}; star case within "
          f"{stats[0]['star_err']:.3e}; resume torch.equal; straggler "
          f"participants {stats[0]['straggler_participants']}; phase 9 "
          f"took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    sm = stats[0]["smoke_sweep"]
    print(f"smoke sweep (phase 10b, on phase 9's ranks): Sweep("
          f"{SMOKE_SWEEP}) at SMOKE width, periods {TRAIN_PERIODS}, int8 "
          f"root: {sm['members']} members, one executor build, one data "
          f"draw a step, scan launches per rank "
          f"{[s['smoke_sweep']['launches'] for s in stats]}, every member "
          f"torch.equal to its standalone run")
    return {"launches": [s["launches"] for s in stats],
            "smoke_sweep_launches": [s["smoke_sweep"]["launches"]
                                     for s in stats],
            "expected_per_rank": want,
            "sec_per_step_warm": warm, "sec_per_round": per_round,
            "sync_s": [s["sync_s"] for s in stats],
            "tokens_per_s_total": total_tok,
            "draw_alone_s": stats[0]["draw_alone_s"],
            "grads_alone_s": stats[0]["grads_alone_s"],
            "peak_bytes": [s["peak"] for s in stats]}


# ---- phase 11: the other architectures' serving paths ------------------------
ARCH_B, ARCH_S, ARCH_GEN = 4, 4096, 32
DBRX_LAYERS = 2          # dbrx-132b at full width, cut in depth to fit
# rwkv6-1.6b's last logits, a 4080-token prefill plus 16 teacher-forced
# decode steps against a 4096-token prefill, as a share of max|prefill
# logits|.  At its bf16 activations through 24 layers the chunked WKV
# (float32 within-chunk products) and the sequential state update round
# y to bf16 from float32 values summed in other orders, and each flipped
# rounding rides through the later layers: measured 2.9e-2 and 3.2e-2 on
# the CPU at 24 layers of d_model 128 and 256 (argmax agreement 0.75).
# At float32 activations the same comparison sees only the sums' order
# through 24 layers
RWKV_TOL = {"bfloat16": 1e-1, "float32": 1e-3}


def _zero_lm_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    fa.LAUNCHES = rg.LAUNCHES = 0
    fa.LAUNCHES_BY_ROUTE.update(wgmma=0, f32=0)
    rg.LAUNCHES_BY_ROUTE.update(tma=0, cp_async=0)
    fa.LAUNCHES_BY_SHAPE.clear()
    rg.LAUNCHES_BY_SHAPE.clear()


def _lm_counts() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    return {"flash": fa.LAUNCHES, "flash_routes": dict(fa.LAUNCHES_BY_ROUTE),
            "scan": rg.LAUNCHES}


def _serve_leg(cfg, dev, card: str) -> dict:
    """One phase-11 leg through repro_torch.launch.serve.generate: weights
    drawn on the card from PRNGKey(0) (CUDA events, peak), prompts from
    the same key, a prefill-only generate (the warm-up) and the whole
    request (prefill, then ARCH_GEN - 1 decode steps), each between a
    zeroing and a reading of the launch counts.  Checks: the prefill
    launches one flash kernel per attention layer, all on the tensor-core
    route, and no scan; decode launches nothing; tokens in range."""
    import torch
    from repro_torch.core import prng
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    key = prng.PRNGKey(0)
    params, init = init_on_card(lambda: transformer.init_params(
        cfg, key, device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"arch {cfg.name}: {cfg.num_layers} layers, {n_params} "
          f"parameters ({nbytes / 2**30:.3f} GiB, {cfg.param_dtype}) drawn "
          f"on the card from PRNGKey(0) in {init['s']:.3f} s, peak "
          f"{init['peak'] / 2**30:.3f} GiB during the init  [{card}]")
    prompts = {"tokens": prng.randint(key, (ARCH_B, ARCH_S), 0,
                                      cfg.vocab_size).to(dev)}
    n_attn = sum(k == "attn" for k in cfg.layer_kinds()) \
        if cfg.attention_impl == "flash" else 0
    _zero_lm_counts()
    _, cold = generate(cfg, params, prompts, 1, device=dev)
    pre = _lm_counts()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    toks, stats = generate(cfg, params, prompts, ARCH_GEN, device=dev)
    whole = _lm_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"arch {cfg.name}: batch {ARCH_B}, prompt {ARCH_S}, {ARCH_GEN} "
          f"generated: prefill {stats['prefill_s']:.4f} s (cold "
          f"{cold['prefill_s']:.4f} s), decode {stats['decode_s']:.4f} s = "
          f"{stats['tok_per_s']:.2f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches in prefill {pre}, in the whole "
          f"request {whole}  [{card}]")
    want = {"flash": n_attn, "flash_routes": {"wgmma": n_attn, "f32": 0},
            "scan": 0}
    if pre != want or whole != want:
        raise AssertionError(f"{cfg.name}: launches in prefill {pre} and "
                             f"in the request {whole}, expected {want} in "
                             f"each (decode launches nothing)")
    if tuple(toks.shape) != (ARCH_B, ARCH_GEN) or toks.dtype != torch.int32 \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: tokens {tuple(toks.shape)} "
                             f"{toks.dtype} or out of the vocabulary")
    return dict(params=params, prompts=prompts, launches=whole["flash"],
                prefill_s=stats["prefill_s"], tok_per_s=stats["tok_per_s"],
                peak=peak, init_s=init["s"])


def _check_logits(name: str, logits, B: int, V: int) -> None:
    import torch
    if tuple(logits.shape) != (B, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} logits {tuple(logits.shape)} not "
                             f"finite or of the wrong shape")


def _routes_recorded(fn):
    """Run ``fn()`` with models.mlp.route recording each MoE layer's
    gate_idx; returns (fn's result, [gate_idx per MoE call])."""
    from repro_torch.models import mlp
    seen, route = [], mlp.route

    def recording(p, cfg, xf):
        probs, gate_w, gate_idx = route(p, cfg, xf)
        seen.append(gate_idx)
        return probs, gate_w, gate_idx

    mlp.route = recording
    try:
        return fn(), seen
    finally:
        mlp.route = route


def _routes_pinned(fn, pinned):
    """Run ``fn()`` with each MoE layer's experts pinned to ``pinned``'s
    (the gate weights still this run's probabilities at them), so that
    two routes of the model dispatch every token alike."""
    import torch
    from repro_torch.models import mlp
    it, route = iter(pinned), mlp.route

    def replaying(p, cfg, xf):
        probs, _, _ = route(p, cfg, xf)
        gate_idx = next(it)
        return probs, torch.gather(probs, -1, gate_idx), gate_idx

    mlp.route = replaying
    try:
        return fn()
    finally:
        mlp.route = route


def _prefill_only(cfg, params, prompts) -> None:
    import torch
    from repro_torch.models import transformer
    with torch.no_grad():
        transformer.prefill(cfg, params, prompts)


def kept_experts(cfg, gate_idx, cap: int):
    """(T, K) expert ids of one MoE layer's assignments, sorted, with -1
    where the capacity ``cap`` dropped one."""
    import torch
    from repro_torch.models import mlp
    keep = mlp.slots(gate_idx, cfg.num_experts, cap)[2]
    return torch.where(keep.view(-1, cfg.experts_per_token), gate_idx,
                       -1).sort(-1).values


def arch_path(dev, card: str, ep_file: Path) -> dict:
    """Phase 11: h2o-danube-1.8b whole, dbrx-132b at full width cut to
    DBRX_LAYERS layers, rwkv6-1.6b whole, each served through generate
    (see the module docstring).  Returns the flash launches per leg and
    the kernel's times at the h2o and dbrx prefill shapes; dbrx's logits
    and kept experts go to ``ep_file`` for phase 13(a)."""
    import dataclasses
    import torch
    from repro_torch.configs import dbrx_132b, h2o_danube_1_8b, rwkv6_1_6b
    from repro_torch.models import mlp, transformer

    t_phase = time.perf_counter()
    out = {"launches": {}, "flash_shapes": {}}
    B, S = ARCH_B, ARCH_S

    # ---- (a) h2o-danube-1.8b, whole: d 80 on the 128-wide panel ----------
    cfg = dataclasses.replace(h2o_danube_1_8b.FULL, attention_impl="flash")
    leg = _serve_leg(cfg, dev, card)
    params, prompts = leg["params"], leg["prompts"]
    with torch.no_grad():
        logits, cache = transformer.prefill(cfg, params, prompts,
                                            max_len=S + ARCH_GEN)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        dlogits, _ = transformer.decode_step(cfg, params, cache, nxt)
        del cache
        plain, _ = transformer.prefill(
            dataclasses.replace(cfg, attention_impl="xla_chunked"), params,
            prompts, max_len=S + ARCH_GEN)
    for name, t in (("prefill", logits), ("decode", dlogits), ("plain", plain)):
        _check_logits(f"{cfg.name} {name}", t, B, cfg.vocab_size)
    err, scale = float((logits - plain).abs().max()), float(plain.abs().max())
    print(f"arch {cfg.name}: last-position logits, kernel route vs plain "
          f"route: max abs diff {err:.4e}, max|plain| {scale:.4e} "
          f"(tolerance {LM_TOL} x max|plain|), argmax agreement "
          f"{float((logits.argmax(-1) == plain.argmax(-1)).float().mean()):.2f}"
          f"  [{card}]")
    if not err <= LM_TOL * scale:
        raise AssertionError(f"{cfg.name}: the kernel route's logits "
                             f"disagree with the plain route's")
    profile_window(lambda: _prefill_only(cfg, params, prompts),
                   f"{cfg.name}, one warm prefill (B={B}, S={S})", card)
    out["launches"][cfg.name] = leg["launches"]
    del params, prompts, leg, logits, dlogits, plain
    torch.cuda.empty_cache()
    out["flash_shapes"]["h2o-danube-1.8b prefill"] = time_flash(
        dev, card, B, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.window, "h2o-danube-1.8b's prefill shape")
    torch.cuda.empty_cache()

    # ---- (b) dbrx-132b at full width, DBRX_LAYERS layers: MoE ------------
    cfg = dataclasses.replace(dbrx_132b.FULL, num_layers=DBRX_LAYERS,
                              attention_impl="flash")
    leg = _serve_leg(cfg, dev, card)
    params, prompts = leg["params"], leg["prompts"]
    c_pre, c_dec = mlp.capacity(cfg, B * S), mlp.capacity(cfg, B)
    with torch.no_grad():
        logits, routes = _routes_recorded(lambda: transformer.prefill(
            cfg, params, prompts, max_len=S + ARCH_GEN)[0])
        plain_cfg = dataclasses.replace(cfg, attention_impl="xla_chunked")
        plain, plain_routes = _routes_recorded(lambda: transformer.prefill(
            plain_cfg, params, prompts, max_len=S + ARCH_GEN)[0])
        pinned = _routes_pinned(lambda: transformer.prefill(
            plain_cfg, params, prompts, max_len=S + ARCH_GEN)[0], routes)
    for name, t in (("prefill", logits), ("plain", plain),
                    ("pinned", pinned)):
        _check_logits(f"{cfg.name} {name}", t, B, cfg.vocab_size)
    # a token whose k-th and (k+1)-th experts are nearly tied can take
    # another expert on the plain route: its FFN output then moves by its
    # smaller gate weight times the difference of two experts' outputs, a
    # share of the row's hidden state, not a rounding; and a flip moves
    # the later tokens of its experts one slot, which can carry one across
    # the capacity.  So rows whose last position kept the same experts in
    # every layer on both routes are held to LM_TOL (earlier flips reach
    # the last position only through the second layer's attention, whose
    # output is a small share of a residual stream the experts' outputs
    # dominate), and the plain route with every layer's experts pinned to
    # the kernel route's is held to LM_TOL on every row
    K = cfg.experts_per_token
    pairs = [(kept_experts(cfg, a, c_pre), kept_experts(cfg, b, c_pre))
             for a, b in zip(routes, plain_routes, strict=True)]
    # the kernel route's logits and kept experts, for phase 13(a)
    ep_file.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"logits": logits.cpu(), "C": c_pre,
                "kept": [a.cpu() for a, _ in pairs]}, ep_file)
    share = [float((a == b).all(-1).float().mean()) for a, b in pairs]
    last = [b * S + S - 1 for b in range(B)]
    rows_same = [all(torch.equal(a[t], b_[t]) for a, b_ in pairs)
                 for t in last]
    kept = [int((a >= 0).sum()) for a, _ in pairs]
    scale = float(plain.abs().max())
    row_err = (logits - plain).abs().amax(-1)
    pin_err = float((logits - pinned).abs().max())
    print(f"arch {cfg.name}: capacity C = {c_pre} slots an expert in "
          f"prefill (T = {B * S}), C = {c_dec} in a decode step (T = {B}); "
          f"assignments kept per layer {kept} of {B * S * K}; share of "
          f"tokens whose kept experts agree between the kernel and plain "
          f"routes per layer {share}; "
          f"last-position rows routed alike {rows_same}; max abs logits "
          f"diff per row {[f'{float(e):.4e}' for e in row_err]}, with "
          f"experts pinned {pin_err:.4e}; max|plain| {scale:.4e} "
          f"(tolerance {LM_TOL} x max|plain|)  [{card}]")
    if not pin_err <= LM_TOL * scale or not all(
            float(e) <= LM_TOL * scale
            for e, alike in zip(row_err, rows_same, strict=True) if alike):
        raise AssertionError(f"{cfg.name}: the kernel route's logits "
                             f"disagree with the plain route's")
    profile_window(lambda: _prefill_only(cfg, params, prompts),
                   f"{cfg.name}, one warm prefill (B={B}, S={S})", card)
    out["launches"][cfg.name] = leg["launches"]
    out["dbrx"] = dict(C_prefill=c_pre, C_decode=c_dec, agree=share,
                       rows_alike=rows_same)
    del params, prompts, leg, logits, plain, pinned, routes, plain_routes, \
        pairs
    torch.cuda.empty_cache()
    out["flash_shapes"]["dbrx-132b prefill"] = time_flash(
        dev, card, B, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.window, "dbrx-132b's prefill shape")
    torch.cuda.empty_cache()

    # ---- (c) rwkv6-1.6b, whole: no attention, no kernel -------------------
    cfg = rwkv6_1_6b.FULL
    leg = _serve_leg(cfg, dev, card)
    params, prompts = leg["params"], leg["prompts"]
    cut = S - 16
    for act in ("bfloat16", "float32"):
        acfg = dataclasses.replace(cfg, activation_dtype=act)
        with torch.no_grad():
            want, _ = transformer.prefill(acfg, params, prompts)
            _, cache = transformer.prefill(
                acfg, params, {"tokens": prompts["tokens"][:, :cut]},
                max_len=S)
            for t in range(cut, S):
                got, cache = transformer.decode_step(
                    acfg, params, cache, prompts["tokens"][:, t: t + 1])
        for name, t in (("prefill", want), ("decode", got)):
            _check_logits(f"{cfg.name} {act} {name}", t, B, cfg.vocab_size)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"arch {cfg.name}: at {act} activations, a {cut}-token "
              f"prefill and {S - cut} teacher-forced decode steps against a "
              f"{S}-token prefill: last logits max abs diff {err:.4e}, "
              f"max|prefill| {scale:.4e} (tolerance {RWKV_TOL[act]} x "
              f"max|prefill|), argmax agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.2f}"
              f"  [{card}]")
        if not err <= RWKV_TOL[act] * scale:
            raise AssertionError(f"{cfg.name}: prefill then decode "
                                 f"disagrees with the longer prefill at "
                                 f"{act} activations")
        del cache

    def short_prefill():
        with torch.no_grad():
            transformer.prefill(cfg, params,
                                {"tokens": prompts["tokens"][:, :1024]})

    profile_window(short_prefill, f"{cfg.name}, one warm 1024-token prefill "
                   f"(B={B}; 64 chunks x {cfg.num_layers} layers of the WKV "
                   f"loop)", card)
    out["launches"][cfg.name] = leg["launches"]
    del params, prompts, leg
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"arch path: phase 11 took {out['seconds']:.1f} s  [{card}]")
    return out


# ---- phase 12: tensor parallelism inside a replica ----------------------------
TP_SERVE_MESH = (1, 2)         # (data, model)
TP_TRAIN_MESH = (2, 2)
TP_PROMPT, TP_DECODE = 4096, 16
TP_MAX_LEN = 4096 + 32         # phase 7's cache length (prompt + 32)
TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 4, 2048, 2
TP_SPAWN_TIMEOUT = 600.0
# the sharded train step against the single-rank step: the reference's own
# tolerances for its sharded step (tests/test_sharding.py)
TP_LOSS_RTOL = 1e-3
TP_PARAM_TOL = dict(rtol=5e-3, atol=1e-3)
# and what scales with the gradient, which the parameters cannot show
# (AdamW's first step moves every entry by about lr, inside that atol):
# each leaf's moments mu = (1 - b1) g and nu = (1 - b2) g^2 and its update
# p1 - p0, norm-relative (tests/test_torch_tp.py's BF16_NORM_REL and
# UPDATE_NORM_REL; a halved gradient is 0.5 / 0.75 off in the moments, an
# update left out 1, a reversed one 2)
TP_MOMENT_NORM_REL = 0.1
TP_UPDATE_NORM_REL = 0.5


def _tp_mesh(shape):
    import torch
    from repro_torch.launch.mesh import RankMesh
    n = shape[0] * shape[1]
    return RankMesh(torch.arange(n).reshape(shape), ("data", "model"),
                    device_type="cuda")


def _tp_start(rank: int, world: int, root: str):
    """Join the gloo group of a phase-12 rank on card 0."""
    import os
    from datetime import timedelta
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from repro_torch.runtime import ranks
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks.init(rank, world, f"file://{root}/pg", backend="gloo",
               timeout=timedelta(seconds=TP_SPAWN_TIMEOUT))
    return torch.device("cuda", 0)


def _kernel_counts() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    return {name: {"launches": mod.LAUNCHES,
                   "by_route": dict(mod.LAUNCHES_BY_ROUTE),
                   "by_shape": {"x".join(map(str, k)): v for k, v in
                                mod.LAUNCHES_BY_SHAPE.items()}}
            for name, mod in (("flash_attention", fa), ("rglru_scan", rg))}


def _tp_serve_rank(rank: int, world: int, root: str) -> None:
    """One rank of phase 12(a), in a spawned process on card 0:
    recurrentgemma-2b FULL on (data, model) = (1, 2) through build_cell's
    prefill and decode programs."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import prng
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer
    dev = _tp_start(rank, world, root)
    cfg = dataclasses.replace(recurrentgemma_2b.FULL, attention_impl="flash")
    mesh = _tp_mesh(TP_SERVE_MESH)
    B = 4
    pre = build_cell(cfg, ShapeSpec("tp_prefill", TP_MAX_LEN, B, "prefill"),
                     mesh)
    dec = build_cell(cfg, ShapeSpec("tp_decode", TP_MAX_LEN, B, "decode"),
                     mesh)
    ctx = pre.ctx
    key = prng.PRNGKey(0)          # phase 7's weights and prompts
    local, init = init_on_card(lambda: pre.local(
        0, transformer.init_params(cfg, key, device=dev)))
    torch.cuda.empty_cache()
    prompts = {"tokens": prng.randint(key, (B, TP_PROMPT), 0,
                                      cfg.vocab_size).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    ctx.reset_timing()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = pre(local, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_counts = _kernel_counts()
        pre_coll = dict(ctx.seconds)
        pre_calls = dict(ctx.calls)
        ctx.reset_timing()
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        t0 = time.perf_counter()
        for _ in range(TP_DECODE):
            nxt, cache = dec(local, cache, toks[-1])
            toks.append(nxt)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    stats = {"init": init, "prefill_s": prefill_s, "decode_s": decode_s,
             "prefill_counts": pre_counts, "counts": _kernel_counts(),
             "prefill_coll": pre_coll, "prefill_calls": pre_calls,
             "decode_coll": dict(ctx.seconds),
             "decode_calls": dict(ctx.calls),
             "peak": torch.cuda.max_memory_allocated(),
             "logits": logits.cpu(), "tokens": torch.cat(toks, 1).cpu(),
             "finite": bool(torch.isfinite(logits).all())}
    torch.save(stats, f"{root}/serve{rank}.pt")
    dist.destroy_process_group()


def _tp_train_batch(cfg, dev):
    """Phase 12(b)'s global batch: next-token pairs drawn from PRNGKey(1)."""
    from repro_torch.core import prng
    seq = prng.randint(prng.PRNGKey(1), (TP_TRAIN_BATCH, TP_TRAIN_SEQ + 1),
                       0, cfg.vocab_size).to(dev)
    return {"tokens": seq[:, :-1].contiguous(),
            "labels": seq[:, 1:].contiguous()}


def _tp_train_rank(rank: int, world: int, root: str) -> None:
    """One rank of phase 12(b), in a spawned process on card 0: phase 9's
    model on (data, model) = (2, 2) through build_cell's train program,
    two steps on the same global batch; saves its parameter and optimizer
    state shards after step 1 for the parent to hold against the
    single-rank step."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import prng
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer
    from repro_torch.optim import get_optimizer
    from repro_torch.optim.api import tree_leaves
    dev = _tp_start(rank, world, root)
    cfg = _train_cfg()
    opt = get_optimizer(cfg)
    mesh = _tp_mesh(TP_TRAIN_MESH)
    cell = build_cell(cfg, ShapeSpec("tp_train", TP_TRAIN_SEQ,
                                     TP_TRAIN_BATCH, "train"), mesh,
                      optimizer=opt)
    ctx = cell.ctx
    params, init = init_on_card(lambda: cell.local(
        0, transformer.stack_blocks(transformer.init_params(
            cfg, prng.PRNGKey(0), device=dev))))
    torch.cuda.empty_cache()
    # AdamW's state is zeros shaped like each shard: its init on the shards
    # is the cut of its init on the whole
    state = opt.init(params)
    want = cell.local(1, cell.arg_shapes[1])
    for a, b in zip(tree_leaves(state), tree_leaves(want), strict=True):
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"optimizer state shard {tuple(a.shape)}, "
                                 f"the spec cuts {tuple(b.shape)}")
    batch = cell.local(2, _tp_train_batch(cfg, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    hist = []
    for step in range(TP_TRAIN_STEPS):
        ctx.reset_timing()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = cell(params, state, batch)
        torch.cuda.synchronize()
        hist.append({"sec": time.perf_counter() - t0,
                     "loss": float(m["loss"]), "coll": dict(ctx.seconds),
                     "calls": dict(ctx.calls)})
        if step == 0:
            torch.save({"params": params, "opt": state,
                        "coords": ctx.coords}, f"{root}/params{rank}.pt")
    stats = {"init": init, "history": hist, "counts": _kernel_counts(),
             "peak": torch.cuda.max_memory_allocated(),
             "specs": cell.in_shardings[0],
             "ospecs": cell.in_shardings[1]}
    torch.save(stats, f"{root}/train{rank}.pt")
    dist.destroy_process_group()


def tp_path(dev, card: str, phase7_file: Path) -> dict:
    """Phase 12: (a) the serving cell and (b) the train cell, gloo ranks
    sharing the card; (c) the kernels timed at the TP local shapes."""
    import shutil
    import torch
    from repro_torch.core import prng
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import get_optimizer
    from repro_torch.optim.api import tree_leaves
    from repro_torch.runtime import ranks
    t_phase = time.perf_counter()
    root = phase7_file.parent
    out = {"launches": {}}

    # ---- (a) serving: recurrentgemma-2b FULL on (1, 2) -----------------
    for f in root.glob("*.pt"):
        if f != phase7_file:
            f.unlink()
    n_ranks = TP_SERVE_MESH[0] * TP_SERVE_MESH[1]
    ranks.spawn(_tp_serve_rank, n_ranks, args=(n_ranks, str(root)),
                timeout=TP_SPAWN_TIMEOUT)
    ref = torch.load(phase7_file, weights_only=False)
    st = [torch.load(root / f"serve{r}.pt", weights_only=False)
          for r in range(n_ranks)]
    from repro_torch.configs import recurrentgemma_2b
    cfg = recurrentgemma_2b.FULL
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    B = 4
    want_shapes = {
        "flash_attention": {f"{B}x{TP_PROMPT}x{TP_PROMPT}x"
                            f"{cfg.num_heads // 2}x{cfg.num_kv_heads}x"
                            f"{cfg.head_dim}": n_attn},
        "rglru_scan": {f"{B}x{TP_PROMPT}x{cfg.lru_width // 2}": n_rec}}
    for r, s in enumerate(st):
        for name, n in (("flash_attention", n_attn), ("rglru_scan", n_rec)):
            c = s["prefill_counts"][name]
            if c["launches"] != n or c["by_shape"] != want_shapes[name]:
                raise AssertionError(f"rank {r}'s prefill launched {name} "
                                     f"{c}, the model's local shapes are "
                                     f"{want_shapes[name]}")
            if s["counts"][name]["launches"] != n:
                raise AssertionError(f"rank {r}'s decode launched {name}")
        if not s["finite"] or tuple(s["logits"].shape) != (B, cfg.vocab_size):
            raise AssertionError(f"rank {r}'s logits "
                                 f"{tuple(s['logits'].shape)} not finite")
        out["launches"][f"tp_serve_rank{r}"] = {
            k: s["counts"][k]["launches"] for k in s["counts"]}
    if not torch.equal(st[0]["logits"], st[1]["logits"]):
        raise AssertionError("the two ranks' gathered logits differ")
    err = float((st[0]["logits"] - ref["logits"]).abs().max())
    scale = float(ref["logits"].abs().max())
    n_tok = TP_DECODE + 1
    agree = float((st[0]["tokens"] == ref["tokens"][:, :n_tok]).float()
                  .mean())
    print(f"tp serve (phase 12a): {cfg.name} FULL on (data, model) = "
          f"{TP_SERVE_MESH}, batch {B} x {TP_PROMPT}, {TP_DECODE} decode "
          f"steps, two gloo ranks sharing the card; last-position logits "
          f"vs phase 7's single-rank kernel route: max abs diff "
          f"{err:.4e}, {100 * err / scale:.2f}% of max|phase 7| {scale:.4e}"
          f" (tolerance {LM_TOL} x max); greedy tokens agreeing with phase "
          f"7's {100 * agree:.1f}% of {B} x {n_tok}  [{card}]")
    if not err <= LM_TOL * scale:
        raise AssertionError("the sharded prefill's logits disagree with "
                             "phase 7's")
    for r, s in enumerate(st):
        c = s["prefill_counts"]
        print(f"tp serve rank {r}: prefill {s['prefill_s']:.4f} s "
              f"(collectives {s['prefill_coll']} s), decode "
              f"{s['decode_s']:.4f} s = "
              f"{B * TP_DECODE / s['decode_s']:.2f} tokens/s (collectives "
              f"{s['decode_coll']} s in {s['decode_calls']} calls); launches "
              f"in prefill: flash {c['flash_attention']['launches']} "
              f"{c['flash_attention']['by_route']} at "
              f"{c['flash_attention']['by_shape']}, scan "
              f"{c['rglru_scan']['launches']} {c['rglru_scan']['by_route']} "
              f"at {c['rglru_scan']['by_shape']}, none in decode; init "
              f"{s['init']['s']:.3f} s (peak {s['init']['peak'] / 2**30:.3f}"
              f" GiB), peak after it {s['peak'] / 2**30:.3f} GiB  [{card}]")
    out["serve"] = {"err_share": err / scale, "agree": agree,
                    "by_shape": {k: st[0]["prefill_counts"][k]["by_shape"]
                                 for k in want_shapes},
                    "prefill_calls": [s["prefill_calls"] for s in st]}

    # ---- (b) training: phase 9's model on (2, 2) -----------------------
    tcfg = _train_cfg()
    opt = get_optimizer(tcfg)
    params = transformer.stack_blocks(transformer.init_params(
        tcfg, prng.PRNGKey(0), device=dev))
    batch = _tp_train_batch(tcfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_ref, o_ref, m_ref = make_train_step(tcfg, opt)(
        params, opt.init(params), batch)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_loss = float(m_ref["loss"])
    del batch, m_ref
    torch.cuda.empty_cache()
    n_ranks = TP_TRAIN_MESH[0] * TP_TRAIN_MESH[1]
    ranks.spawn(_tp_train_rank, n_ranks, args=(n_ranks, str(root)),
                timeout=TP_SPAWN_TIMEOUT)

    def norm_rel(a, b) -> float:
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))

    worst = 0.0
    worst_moment, worst_update = (0.0, ""), (0.0, "")
    want = expected_scan_launches(tcfg, TP_TRAIN_STEPS)
    # one reverse-time launch per recurrent layer a step
    rev = TP_TRAIN_STEPS * sum(k == "rec" for k in tcfg.layer_kinds())
    for r in range(n_ranks):
        s = torch.load(root / f"train{r}.pt", weights_only=False)
        got = torch.load(root / f"params{r}.pt", weights_only=False,
                         map_location=dev)
        cut = functools.partial(sh.shard_tree, mesh=_tp_mesh(TP_TRAIN_MESH),
                                coords=got["coords"])
        mine, before = cut(p_ref, s["specs"]), cut(params, s["specs"])
        for (path, a), b, z in zip(sh.flat_with_path(got["params"]),
                                   tree_leaves(mine), tree_leaves(before),
                                   strict=True):
            excess = float(((a.float() - b.float()).abs()
                            - TP_PARAM_TOL["rtol"] * b.float().abs()).max())
            worst = max(worst, excess)
            if excess > TP_PARAM_TOL["atol"]:
                raise AssertionError(f"rank {r}'s {sh.path_str(path)} after "
                                     f"step 1 is off the single-rank step")
            upd = norm_rel(a.float() - z.float(), b.float() - z.float())
            worst_update = max(worst_update, (upd, sh.path_str(path)))
            if not upd < TP_UPDATE_NORM_REL:
                raise AssertionError(f"rank {r}'s update of "
                                     f"{sh.path_str(path)} is {upd:.4f} "
                                     f"off the single-rank step's")
        n_moments = 0
        for (path, a), b in zip(sh.flat_with_path(got["opt"]),
                                tree_leaves(cut(o_ref, s["ospecs"])),
                                strict=True):
            if path[0] not in ("mu", "nu"):
                continue
            n_moments += 1
            off = norm_rel(a, b)
            worst_moment = max(worst_moment, (off, sh.path_str(path)))
            if not off < TP_MOMENT_NORM_REL:
                raise AssertionError(f"rank {r}'s {sh.path_str(path)} after "
                                     f"step 1 is {off:.4f} off the "
                                     f"single-rank step's")
        if n_moments != 2 * len(tree_leaves(mine)):
            raise AssertionError(f"rank {r}'s optimizer state holds "
                                 f"{n_moments} moments")
        del got, mine, before
        h = s["history"]
        if abs(h[0]["loss"] - ref_loss) > TP_LOSS_RTOL * abs(ref_loss) or \
                not all(math.isfinite(x["loss"]) for x in h):
            raise AssertionError(f"rank {r}'s losses {[x['loss'] for x in h]}"
                                 f" against the single-rank {ref_loss}")
        c = s["counts"]["rglru_scan"]
        if c["launches"] != want or c["by_shape"] != {
                f"{TP_TRAIN_BATCH // TP_TRAIN_MESH[0]}x{TP_TRAIN_SEQ}x"
                f"{tcfg.lru_width // TP_TRAIN_MESH[1]}": want}:
            raise AssertionError(f"rank {r}'s scan launches {c}, the code "
                                 f"makes {want}")
        out["launches"][f"tp_train_rank{r}"] = {"rglru_scan": c["launches"]}
        print(f"tp train rank {r} (phase 12b): losses "
              f"{[round(x['loss'], 6) for x in h]} (single-rank step "
              f"{ref_loss:.6f}), steps {[round(x['sec'], 3) for x in h]} s, "
              f"collectives of the warm step {h[-1]['coll']} s in "
              f"{h[-1]['calls']} calls, scan launches {c['launches']} "
              f"{c['by_route']} at {c['by_shape']}: {c['launches'] - rev} "
              f"forward (with the remat recompute) and {rev} reverse-time "
              f"(the code's {want}), init "
              f"{s['init']['s']:.3f} s (peak "
              f"{s['init']['peak'] / 2**30:.3f} GiB), peak after it "
              f"{s['peak'] / 2**30:.3f} GiB  [{card}]")
    print(f"tp train (phase 12b): {tcfg.num_layers} layers at full width, "
          f"AdamW, (data, model) = {TP_TRAIN_MESH}, global batch "
          f"{TP_TRAIN_BATCH} x {TP_TRAIN_SEQ}; every rank's parameter "
          f"shards after step 1 within rtol {TP_PARAM_TOL['rtol']} / atol "
          f"{TP_PARAM_TOL['atol']} of the single-rank step's (largest "
          f"excess over rtol {worst:.3e}); the gradients through the "
          f"moments: largest leaf {worst_moment[0]:.4e} norm-relative "
          f"({worst_moment[1]}; bound {TP_MOMENT_NORM_REL}); the updates "
          f"p1 - p0: largest leaf {worst_update[0]:.4e} ({worst_update[1]};"
          f" bound {TP_UPDATE_NORM_REL}); the single-rank step alone "
          f"{ref_s:.3f} s  [{card}]")
    out["train"] = {"moment_norm_rel": worst_moment[0],
                    "update_norm_rel": worst_update[0], "excess": worst}
    del p_ref, o_ref, params
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)

    # ---- (c) the kernels at the TP local shapes ------------------------
    out["flash_attention"] = time_flash(dev, card, 4, 4096, 5, 1, 256, 2048,
                                        "the TP local shape")
    out["rglru_scan"] = time_scan(dev, card, 4, 4096, 1280,
                                  "the TP local shape")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tp path: phase 12 took {out['seconds']:.1f} s  [{card}]")
    return out


# ---- phase 13: expert- and head-parallel serving, TreeSync over TP ----------
EP_MESH = (1, 2)               # (data, model)
EP_DECODE = 16
RWKV_TP_PROMPT = 1024
TSTP_MESH = (2, 2)             # (data, model): two replicas of two ranks
TSTP_PERIODS = (2,)            # the int8 root syncs every 2 steps
TSTP_STEPS = 2                 # cut from 4 to keep the script near 1000 s
TSTP_BATCH, TSTP_SEQ = 4, 2048
EP_SPAWN_TIMEOUT = 600.0


def _ep_record(seen: list):
    """models.mlp.route recording each MoE call's gate_idx into ``seen``;
    returns a function that puts the original back."""
    from repro_torch.models import mlp
    route = mlp.route

    def recording(p, cfg, xf):
        out = route(p, cfg, xf)
        seen.append(out[2])
        return out

    mlp.route = recording

    def restore():
        mlp.route = route
    return restore


def _ep_leg(cfgs, mesh, dev, prompt_len: int, teacher: bool) -> list:
    """One phase-13 serving leg on this rank: build_cell's prefill and
    decode programs, weights drawn whole from PRNGKey(0) and cut to this
    rank's shards, prompts from the same key (phase 11's), then for each
    config of ``cfgs`` (the same weights at other activation dtypes) a
    prefill of ``prompt_len`` tokens and EP_DECODE decode steps (greedy,
    or with ``teacher`` the prompt's next tokens fed, the last step's
    logits kept).  The counts are zeroed before each prefill."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import shardctx, transformer
    B = ARCH_B
    n = prompt_len + (EP_DECODE if teacher else ARCH_GEN)
    cells = [(steps.build_cell(c, ShapeSpec("ep_prefill", n, B, "prefill"),
                               mesh),
              steps.build_cell(c, ShapeSpec("ep_decode", n, B, "decode"),
                               mesh)) for c in cfgs]
    key = prng.PRNGKey(0)
    local, init = init_on_card(lambda: cells[0][0].local(
        0, transformer.init_params(cfgs[0], key, device=dev)))
    torch.cuda.empty_cache()
    seq = prng.randint(key, (B, ARCH_S), 0, cfgs[0].vocab_size).to(dev)
    prompts = {"tokens": seq[:, :prompt_len].contiguous()}
    outs = []
    for cfg, (pre, dec) in zip(cfgs, cells, strict=True):
        ctx = pre.ctx
        seen = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_lm_counts()
        ctx.reset_timing()
        restore = _ep_record(seen)
        try:
            with torch.no_grad():
                t0 = time.perf_counter()
                logits, cache = pre(local, prompts)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
        finally:
            restore()
        pre_counts = _kernel_counts()
        pre_coll = dict(ctx.seconds)
        ctx.reset_timing()
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        last = None
        with torch.no_grad():
            t0 = time.perf_counter()
            for t in range(EP_DECODE):
                feed = seq[:, prompt_len + t:prompt_len + t + 1] if teacher \
                    else toks[-1]
                if teacher and t == EP_DECODE - 1:
                    # the last step's logits, through the model itself
                    with steps._shard_scope(ctx):
                        used = shardctx.gather_params(
                            cfg, steps._serving_layout(local))
                        last, cache = transformer.decode_step(
                            cfg, used, cache, feed, max_len=n)
                    continue
                nxt, cache = dec(local, cache, feed)
                toks.append(nxt)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        out = {"act": cfg.activation_dtype, "init": init,
               "prefill_s": prefill_s, "decode_s": decode_s,
               "prefill_counts": pre_counts, "counts": _kernel_counts(),
               "prefill_coll": pre_coll, "decode_coll": dict(ctx.seconds),
               "decode_calls": dict(ctx.calls),
               "peak": torch.cuda.max_memory_allocated(),
               "logits": logits.cpu(), "tokens": torch.cat(toks, 1).cpu(),
               "last": None if last is None else last.cpu(),
               "finite": bool(torch.isfinite(logits).all()) and (
                   last is None or bool(torch.isfinite(last).all()))}
        if cfg.is_moe:
            from repro_torch.models import mlp
            cap = mlp.capacity(cfg, B * prompt_len)
            out["kept"] = [kept_experts(cfg, g, cap).cpu() for g in seen]
        outs.append(out)
        del cache, logits
    return outs


def _ep_cfgs(which: str):
    """Phase 13's serving configs: (a) dbrx-132b at full width cut to
    DBRX_LAYERS layers, flash attention; (b) rwkv6-1.6b whole at float32
    activations, then at its bf16 ones."""
    import dataclasses
    from repro_torch.configs import dbrx_132b, rwkv6_1_6b
    if which == "dbrx":
        return [dataclasses.replace(dbrx_132b.FULL, num_layers=DBRX_LAYERS,
                                    attention_impl="flash")]
    return [dataclasses.replace(rwkv6_1_6b.FULL, activation_dtype=act)
            for act in ("float32", "bfloat16")]


def _ep_serve_rank(rank: int, world: int, root: str, which: str) -> None:
    """One rank of phase 13(a) (``which`` "dbrx": expert parallel) or (b)
    ("rwkv": head parallel), in a spawned process on card 0, on (data,
    model) = EP_MESH."""
    import torch
    import torch.distributed as dist
    dev = _tp_start(rank, world, root)
    teacher = which == "rwkv"
    torch.save(_ep_leg(_ep_cfgs(which), _tp_mesh(EP_MESH), dev,
                       RWKV_TP_PROMPT if teacher else ARCH_S, teacher),
               f"{root}/{which}{rank}.pt")
    dist.destroy_process_group()


def _tstp_rank(rank: int, world: int, root: str) -> None:
    """One rank of phase 13(c), in a spawned process on card 0: phase 9's
    model through LMSession on (data, model) = (2, 2), Adafactor, the
    int8 root every TSTP_PERIODS[0] steps.  Saves its shards after step 1
    for the parent to hold against the single-rank step; a failed sync
    check raises, which fails the spawn."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.api import Problem, Schedule, Session, Topology
    from repro_torch.core import prng
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.optim import make_adafactor
    dev = _tp_start(rank, world, root)
    mesh = init_device_mesh("cuda", TSTP_MESH,
                            mesh_dim_names=("data", "model"))
    cfg = _train_cfg()
    sess = Session.compile(
        Problem.lm(cfg, make_adafactor(), batch=TSTP_BATCH, seq=TSTP_SEQ,
                   seed=0),
        Topology.from_mesh(mesh, sync_axes=("data",), periods=TSTP_PERIODS),
        Schedule(compression=("int8",)), backend="mesh", mesh=mesh,
        device=dev)
    synced = []

    def on_state(step, state):
        if step == 1:
            torch.save({"params": state.params, "opt": state.opt_state,
                        "coords": sess.tp.ctx.coords,
                        "replica": sess.replica},
                       f"{root}/tstp_params{rank}.pt")
        if step % TSTP_PERIODS[0] == 0:
            # the replicas that share this rank's model coordinate
            if not _group_equal(sess.comm.world, state.params):
                raise AssertionError(f"after step {step}'s sync rank {rank}'s"
                                     f" shards differ from its peer's")
            synced.append(step)

    st, init = init_on_card(lambda: sess.init_state(prng.PRNGKey(0)))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rg.LAUNCHES = 0
    rg.LAUNCHES_BY_SHAPE.clear()
    sess.tp.ctx.reset_timing()
    t0 = time.perf_counter()
    res = sess.run(steps=TSTP_STEPS, warm_start=st, on_state=on_state)
    torch.cuda.synchronize()
    losses = [h["loss"] for h in res.history]
    stats = {"init": init, "run_s": time.perf_counter() - t0,
             "history": res.history, "sync_s": sess.sync_seconds(),
             "sync_n": sess.sync_counts(), "synced": synced,
             "tp_coll": dict(sess.tp.ctx.seconds),
             "tp_calls": dict(sess.tp.ctx.calls),
             "launches": rg.LAUNCHES,
             "by_shape": {"x".join(map(str, k)): v
                          for k, v in rg.LAUNCHES_BY_SHAPE.items()},
             "peak": torch.cuda.max_memory_allocated(),
             "specs": sess.tp.pspecs, "ospecs": sess.tp.ospecs,
             "consensus": [tuple(t.shape) for t in
                           _leaves(res.consensus())]}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"rank {rank}: non-finite loss in {losses}")
    torch.save(stats, f"{root}/tstp{rank}.pt")
    dist.destroy_process_group()


def _rwkv_single(dev) -> list:
    """Phase 13(b)'s single-rank runs in this process: rwkv6-1.6b whole,
    the same prompts, RWKV_TP_PROMPT tokens of prefill and EP_DECODE
    teacher-forced decode steps, at each of _ep_cfgs("rwkv")'s
    activation dtypes."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import transformer
    cfgs = _ep_cfgs("rwkv")
    key = prng.PRNGKey(0)
    params = transformer.init_params(cfgs[0], key, device=dev)
    seq = prng.randint(key, (ARCH_B, ARCH_S), 0, cfgs[0].vocab_size).to(dev)
    outs = []
    for cfg in cfgs:
        with torch.no_grad():
            logits, cache = transformer.prefill(
                cfg, params, {"tokens": seq[:, :RWKV_TP_PROMPT]},
                max_len=RWKV_TP_PROMPT + EP_DECODE)
            for t in range(EP_DECODE):
                last, cache = transformer.decode_step(
                    cfg, params, cache,
                    seq[:, RWKV_TP_PROMPT + t:RWKV_TP_PROMPT + t + 1])
        outs.append({"logits": logits.cpu(), "last": last.cpu()})
        del cache
    del params
    torch.cuda.empty_cache()
    return outs


def _tstp_reference(dev) -> dict:
    """Phase 13(c)'s single-rank local steps in this process: for each
    replica, make_train_step (Adafactor) from the whole PRNGKey(0) state
    on the replica's rows of step 0's draw; the results kept on the host,
    which leaves the card to the four ranks."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.engine import lm as lm_mod
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import make_adafactor
    from repro_torch.optim.api import tree_leaves, tree_unflatten
    cfg = _train_cfg()
    opt = make_adafactor()

    def host(tree):
        return tree_unflatten(tree, [t.cpu() for t in tree_leaves(tree)])

    out = {"p0": None, "params": [], "opt": [], "loss": []}
    for r in range(TSTP_MESH[0]):
        st = lm_mod.init_lm_state(cfg, opt, prng.PRNGKey(0), device=dev)
        if out["p0"] is None:
            out["p0"] = host(st.params)
        rows = lm_mod.replica_rows(TSTP_BATCH, TSTP_MESH[0], r)
        p, o, m = make_train_step(cfg, opt)(
            st.params, st.opt_state, lm_batch(cfg, TSTP_BATCH, TSTP_SEQ, 0,
                                              seed=0, rows=rows, device=dev))
        out["params"].append(host(p))
        out["opt"].append(host(o))
        out["loss"].append(float(m["loss"]))
        del st, p, o
        torch.cuda.empty_cache()
    return out


def _ep_dbrx(dev, card: str, root: Path, ep_file: Path) -> dict:
    """Phase 13(a): dbrx-132b expert parallel on EP_MESH, against phase
    11(b)'s single-rank run (``ep_file``)."""
    import torch
    from repro_torch.runtime import ranks
    B = ARCH_B
    n_ranks = EP_MESH[0] * EP_MESH[1]
    ranks.spawn(_ep_serve_rank, n_ranks, args=(n_ranks, str(root), "dbrx"),
                timeout=EP_SPAWN_TIMEOUT)
    ref = torch.load(ep_file, weights_only=False)
    cfg = _ep_cfgs("dbrx")[0]
    st = [torch.load(root / f"dbrx{r}.pt", weights_only=False)[0]
          for r in range(n_ranks)]
    H, KV = cfg.num_heads // EP_MESH[1], cfg.num_kv_heads // EP_MESH[1]
    shape = f"{B}x{ARCH_S}x{ARCH_S}x{H}x{KV}x{cfg.head_dim}"
    launches = {}
    for r, s in enumerate(st):
        c = s["prefill_counts"]
        if c["flash_attention"]["launches"] != DBRX_LAYERS or \
                c["flash_attention"]["by_shape"] != {shape: DBRX_LAYERS} or \
                c["flash_attention"]["by_route"]["wgmma"] != DBRX_LAYERS or \
                c["rglru_scan"]["launches"] != 0:
            raise AssertionError(f"rank {r}'s dbrx prefill launched {c}, the "
                                 f"model's local shape is {shape} x "
                                 f"{DBRX_LAYERS}")
        if s["counts"]["flash_attention"]["launches"] != DBRX_LAYERS:
            raise AssertionError(f"rank {r}'s dbrx decode launched flash")
        if not s["finite"] or tuple(s["logits"].shape) != (B, cfg.vocab_size):
            raise AssertionError(f"rank {r}'s dbrx logits not finite")
        launches[f"ep_dbrx_rank{r}"] = {
            "flash_attention": s["counts"]["flash_attention"]["launches"]}
    if not torch.equal(st[0]["logits"], st[1]["logits"]):
        raise AssertionError("the two ranks' gathered dbrx logits differ")
    # a token whose experts flip between the runs moves by a share of its
    # hidden state (phase 11's note): rows whose last position kept the
    # same experts in both layers are held to LM_TOL
    share = [float((a == b).all(-1).float().mean())
             for a, b in zip(st[0]["kept"], ref["kept"], strict=True)]
    last = [b * ARCH_S + ARCH_S - 1 for b in range(B)]
    alike = [all(torch.equal(a[t], b[t]) for a, b in
                 zip(st[0]["kept"], ref["kept"], strict=True)) for t in last]
    row_err = (st[0]["logits"] - ref["logits"]).abs().amax(-1)
    scale = float(ref["logits"].abs().max())
    print(f"ep serve (phase 13a): {cfg.name} at full width, {DBRX_LAYERS} "
          f"layers, expert parallel on (data, model) = {EP_MESH} "
          f"({cfg.num_experts // EP_MESH[1]} of {cfg.num_experts} experts "
          f"and {H} of {cfg.num_heads} q heads a rank), batch {B} x "
          f"{ARCH_S}, {EP_DECODE} greedy decode steps; C = {ref['C']}; share "
          f"of tokens whose kept experts agree with phase 11's single-rank "
          f"run per layer {share}; last-position rows routed alike {alike};"
          f" max abs logits diff per row "
          f"{[f'{float(e):.4e}' for e in row_err]}, max|phase 11| "
          f"{scale:.4e} (tolerance {LM_TOL} x max on the rows routed "
          f"alike)  [{card}]")
    if not any(alike) or not all(
            float(e) <= LM_TOL * scale
            for e, a in zip(row_err, alike, strict=True) if a):
        raise AssertionError("the expert-parallel prefill's logits disagree "
                             "with phase 11's")
    for r, s in enumerate(st):
        _ep_print(f"ep serve rank {r} ({cfg.name})", s, B, card)
    return {"launches": launches, "agree": share, "rows_alike": alike,
            "prefill_s": [s["prefill_s"] for s in st],
            "tok_per_s": [B * EP_DECODE / s["decode_s"] for s in st]}


def _hp_rwkv(dev, card: str, root: Path) -> dict:
    """Phase 13(b): rwkv6-1.6b head parallel on EP_MESH at float32 and at
    bf16 activations, against the single-rank runs made first here."""
    import torch
    from repro_torch.runtime import ranks
    B = ARCH_B
    refs = _rwkv_single(dev)
    n_ranks = EP_MESH[0] * EP_MESH[1]
    ranks.spawn(_ep_serve_rank, n_ranks, args=(n_ranks, str(root), "rwkv"),
                timeout=EP_SPAWN_TIMEOUT)
    cfgs = _ep_cfgs("rwkv")
    legs = [torch.load(root / f"rwkv{r}.pt", weights_only=False)
            for r in range(n_ranks)]
    out = {"launches": {f"hp_rwkv_rank{r}": {} for r in range(n_ranks)}}
    bad = []
    for k, cfg in enumerate(cfgs):
        act, tol = cfg.activation_dtype, RWKV_TOL[cfg.activation_dtype]
        errs = []
        for r, leg in enumerate(legs):
            s = leg[k]
            for name, c in s["prefill_counts"].items():
                if c["launches"] or s["counts"][name]["launches"]:
                    raise AssertionError(f"rank {r}'s rwkv6 run launched "
                                         f"{name}")
            if not s["finite"]:
                raise AssertionError(f"rank {r}'s rwkv6 logits not finite")
            for name in ("logits", "last"):
                want = refs[k][name]
                err = float((s[name] - want).abs().max())
                errs.append((r, name, err, float(want.abs().max())))
        agree = float((legs[0][k]["last"].argmax(-1)
                       == refs[k]["last"].argmax(-1)).float().mean())
        print(f"hp serve (phase 13b): {cfg.name} whole ({cfg.num_layers} "
              f"layers, {act} activations), head parallel on (data, model) "
              f"= {EP_MESH} ({cfg.d_model // cfg.rwkv_head_dim // EP_MESH[1]}"
              f" of {cfg.d_model // cfg.rwkv_head_dim} heads a rank), a "
              f"{RWKV_TP_PROMPT}-token prefill at batch {B} and {EP_DECODE} "
              f"teacher-forced decode steps against the single-rank run: "
              f"(rank, logits, max abs diff, max|single|) "
              f"{[(r, n, f'{e:.4e}', f'{m:.4e}') for r, n, e, m in errs]} "
              f"({f'tolerance {tol} x max' if act == 'float32' else 'reported'}"
              f"), last-step argmax agreement "
              f"{agree:.2f}; no flash or scan launch  [{card}]")
        # the check is the float32 leg's: at bf16 through 24 layers two
        # orders of the same sums diverge by 7-10% of max (phase 11's
        # prefill-then-decode against a longer prefill: 6.6% on the
        # card), so the bf16 leg's difference is reported, not held
        if act == "float32":
            bad += [(act, r, n) for r, n, e, m in errs if not e <= tol * m]
        for r, leg in enumerate(legs):
            _ep_print(f"hp serve rank {r} ({cfg.name}, {act})", leg[k], B,
                      card)
        out[act] = {"prefill_s": [leg[k]["prefill_s"] for leg in legs],
                    "tok_per_s": [B * EP_DECODE / leg[k]["decode_s"]
                                  for leg in legs],
                    "err_share": max(e / m for _, _, e, m in errs)}
    if bad:
        raise AssertionError(f"the head-parallel rwkv6 runs disagree with "
                             f"the single-rank runs: {bad}")
    return out


def _tstp(dev, card: str, root: Path) -> dict:
    """Phase 13(c): TreeSync over tensor-parallel replicas, four ranks,
    against the single-rank steps made first here."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim.api import tree_leaves
    from repro_torch.runtime import ranks
    tcfg = _train_cfg()
    t0 = time.perf_counter()
    want = _tstp_reference(dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    n_ranks = TSTP_MESH[0] * TSTP_MESH[1]
    ranks.spawn(_tstp_rank, n_ranks, args=(n_ranks, str(root)),
                timeout=EP_SPAWN_TIMEOUT)

    def norm_rel(a, b) -> float:
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))

    ref_loss = sum(want["loss"]) / len(want["loss"])
    n_scan = expected_scan_launches(tcfg, TSTP_STEPS)
    scan_shape = (f"{TSTP_BATCH // TSTP_MESH[0]}x{TSTP_SEQ}x"
                  f"{tcfg.lru_width // TSTP_MESH[1]}")
    whole = [tuple(t.shape) for t in _leaves(want["p0"])]
    worst, worst_moment, worst_update = 0.0, (0.0, ""), (0.0, "")
    stats, launches, flips = [], {}, 0
    for r in range(n_ranks):
        s = torch.load(root / f"tstp{r}.pt", weights_only=False)
        got = torch.load(root / f"tstp_params{r}.pt", weights_only=False,
                         map_location="cpu")
        cut = functools.partial(sh.shard_tree, mesh=_tp_mesh(TSTP_MESH),
                                coords=got["coords"])
        rep = got["replica"]
        mine, before = cut(want["params"][rep], s["specs"]), cut(
            want["p0"], s["specs"])
        for (path, a), b, z in zip(sh.flat_with_path(got["params"]),
                                   tree_leaves(mine), tree_leaves(before),
                                   strict=True):
            a, b, z = (x.to(dev).float() for x in (a, b, z))
            # Adafactor's first step moves an unfactored entry by lr
            # rms(p) sign(g): where g is rounding-small its sign can differ
            # between the runs, and the entry then took the same step the
            # other way (2 z - b); such flips are counted, and the update
            # check below bounds their share (a leaf with a share f of
            # them is 2 sqrt(f) off)
            tol = TP_PARAM_TOL["atol"] + TP_PARAM_TOL["rtol"] * b.abs()
            flip = ((a - (2 * z - b)).abs() <= tol) & ((a - b).abs() > tol)
            flips += int(flip.sum())
            excess = float(torch.where(flip, float("-inf"),
                                       (a - b).abs() - tol).max())
            worst = max(worst, excess + TP_PARAM_TOL["atol"])
            if excess > 0:
                raise AssertionError(f"rank {r}'s {sh.path_str(path)} after "
                                     f"step 1 is off the single-rank step")
            upd = norm_rel(a - z, b - z)
            worst_update = max(worst_update, (upd, sh.path_str(path)))
            if not upd < TP_UPDATE_NORM_REL:
                raise AssertionError(f"rank {r}'s update of "
                                     f"{sh.path_str(path)} is {upd:.4f} off")
        n_moments = 0
        for (path, a), b in zip(sh.flat_with_path(got["opt"]),
                                tree_leaves(cut(want["opt"][rep],
                                                s["ospecs"])),
                                strict=True):
            if path[0] != "v":          # Adafactor's second moments
                continue
            n_moments += 1
            off = norm_rel(a.to(dev), b.to(dev))
            worst_moment = max(worst_moment, (off, sh.path_str(path)))
            if not off < TP_MOMENT_NORM_REL:
                raise AssertionError(f"rank {r}'s {sh.path_str(path)} after "
                                     f"step 1 is {off:.4f} off")
        if n_moments < len(tree_leaves(mine)):
            raise AssertionError(f"rank {r}'s optimizer state holds "
                                 f"{n_moments} second moments")
        del got, mine, before
        h = s["history"]
        if abs(h[0]["loss"] - ref_loss) > TP_LOSS_RTOL * abs(ref_loss):
            raise AssertionError(f"rank {r}'s step-1 loss {h[0]['loss']} "
                                 f"against the single-rank {ref_loss}")
        if s["launches"] != n_scan or s["by_shape"] != {scan_shape: n_scan}:
            raise AssertionError(f"rank {r}'s scan launches {s['launches']} "
                                 f"at {s['by_shape']}, the code makes "
                                 f"{n_scan} at {scan_shape}")
        if s["synced"] != list(range(TSTP_PERIODS[0], TSTP_STEPS + 1,
                                     TSTP_PERIODS[0])) or \
                s["consensus"] != whole:
            raise AssertionError(f"rank {r}: syncs checked at {s['synced']}, "
                                 f"consensus shapes {s['consensus'][:3]}...")
        launches[f"tstp_rank{r}"] = {"rglru_scan": s["launches"]}
        print(f"tstp rank {r} (phase 13c): losses "
              f"{[round(x['loss'], 6) for x in h]}, steps "
              f"{[round(x['sec'], 3) for x in h]} s, syncs {s['sync_n']} "
              f"taking {[round(x, 3) for x in s['sync_s']]} s, collectives "
              f"over model {s['tp_coll']} s in {s['tp_calls']} calls, scan "
              f"launches {s['launches']} at {s['by_shape']} (the code's "
              f"{n_scan}), init {s['init']['s']:.3f} s (peak "
              f"{s['init']['peak'] / 2**30:.3f} GiB), peak in the run "
              f"{s['peak'] / 2**30:.3f} GiB  [{card}]")
        stats.append(s)
    h = stats[0]["history"]
    warm = [x["sec"] for x in h[1:]]
    sync_per = stats[0]["sync_s"][0] / max(stats[0]["sync_n"][0], 1)
    print(f"tstp (phase 13c): {tcfg.num_layers} layers at full width, "
          f"Adafactor, LMSession on (data, model) = {TSTP_MESH} (two "
          f"replicas of two model ranks), periods {TSTP_PERIODS}, int8 "
          f"root, batch {TSTP_BATCH} x {TSTP_SEQ}, {TSTP_STEPS} steps: step-1 "
          f"loss {h[0]['loss']:.6f} against the single-rank steps' mean "
          f"{ref_loss:.6f}; shards after step 1 within rtol "
          f"{TP_PARAM_TOL['rtol']} / atol {TP_PARAM_TOL['atol']} of the "
          f"single-rank step's (largest excess over rtol {worst:.3e}, "
          f"{flips} entries of the four ranks' shards took the same step "
          f"the other way); second moments: largest leaf "
          f"{worst_moment[0]:.4e} "
          f"norm-relative ({worst_moment[1]}); updates: largest leaf "
          f"{worst_update[0]:.4e} ({worst_update[1]}); replicas equal after "
          f"every sync; warm steps {[round(x, 3) for x in warm]} s, "
          f"{sync_per:.3f} s per sync (rank 0); the single-rank steps "
          f"{ref_s:.3f} s  [{card}]")
    return {"launches": launches, "warm_s": warm, "sync_s": sync_per,
            "flips": flips, "moment_norm_rel": worst_moment[0],
            "update_norm_rel": worst_update[0], "excess": worst}


def ep_path(dev, card: str, ep_file: Path) -> dict:
    """Phase 13: (a) dbrx-132b expert parallel and (b) rwkv6-1.6b head
    parallel through build_cell's serving cells, (c) TreeSync over
    tensor-parallel replicas through LMSession, gloo ranks sharing the
    card; (d) flash at (a)'s local shape."""
    import shutil
    import torch
    from repro_torch.configs import dbrx_132b
    t_phase = time.perf_counter()
    root = ep_file.parent
    out = {"dbrx": _ep_dbrx(dev, card, root, ep_file)}
    torch.cuda.empty_cache()
    out["rwkv"] = _hp_rwkv(dev, card, root)
    torch.cuda.empty_cache()
    out["tstp"] = _tstp(dev, card, root)
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: v for leg in ("dbrx", "rwkv", "tstp")
                       for k, v in out[leg].pop("launches").items()}
    cfg = dbrx_132b.FULL
    out["flash_attention"] = time_flash(
        dev, card, ARCH_B, ARCH_S, cfg.num_heads // EP_MESH[1],
        cfg.num_kv_heads // EP_MESH[1], cfg.head_dim, cfg.window,
        "dbrx-132b's expert-parallel local shape")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ep path: phase 13 took {out['seconds']:.1f} s  [{card}]")
    return out


def _ep_print(label: str, s: dict, B: int, card: str) -> None:
    c = s["prefill_counts"]["flash_attention"]
    print(f"{label}: prefill {s['prefill_s']:.4f} s (collectives "
          f"{s['prefill_coll']} s), decode {s['decode_s']:.4f} s = "
          f"{B * EP_DECODE / s['decode_s']:.2f} tokens/s (collectives "
          f"{s['decode_coll']} s in {s['decode_calls']} calls); flash in "
          f"prefill {c['launches']} {c['by_route']} at {c['by_shape']}, none "
          f"in decode; init {s['init']['s']:.3f} s (peak "
          f"{s['init']['peak'] / 2**30:.3f} GiB), peak after it "
          f"{s['peak'] / 2**30:.3f} GiB  [{card}]")


# ---- phase 14: the cost count of a cell against its measured run ----------
# a counted step's lower bound may exceed the measured time by this share
# at most (a bound above the measurement is a count that is too high)
ROOFLINE_SLACK = 1.05
PEAK_RATIO = 2.0        # estimated peak within this factor of the measured


def cost_path(card: str, served: dict, tp_calls: list) -> dict:
    """Phase 14: ``CellProgram.lower()`` of phase 7's cell
    (recurrentgemma-2b FULL, flash, prefill of 4 x 4096 tokens into a
    4128-slot cache, one rank) and of phase 12(a)'s TP prefill on (data,
    model) = (1, 2), counted on meta tensors on the host.  The counted
    kernel launches by shape must equal phase 7's, the step's roofline
    lower bound must not exceed phase 7's measured warm prefill by more
    than ROOFLINE_SLACK, the estimated peak must be within PEAK_RATIO of
    phase 7's ``max_memory_allocated``, and rank 0's counted collectives
    by axis must equal the calls each rank of phase 12(a) made."""
    import collections
    import dataclasses
    import torch
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rg
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.steps import build_cell

    t0 = time.perf_counter()
    cfg = dataclasses.replace(recurrentgemma_2b.FULL, attention_impl="flash")
    B, S, max_len = 4, 4096, 4096 + 32
    before = (fa.LAUNCHES, rg.LAUNCHES, dict(fa.LAUNCHES_BY_SHAPE),
              dict(rg.LAUNCHES_BY_SHAPE))

    def lowered(mesh_shape):
        cell = build_cell(cfg, ShapeSpec("prefill_4k", max_len, B,
                                         "prefill"),
                          make_abstract_mesh(mesh_shape, ("data", "model")))
        tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
        return dataclasses.replace(
            cell, arg_shapes=(cell.arg_shapes[0], {"tokens": tokens})).lower()

    one = lowered((1, 1))
    tp = lowered(TP_SERVE_MESH)
    if (fa.LAUNCHES, rg.LAUNCHES, fa.LAUNCHES_BY_SHAPE,
            rg.LAUNCHES_BY_SHAPE) != before:
        raise AssertionError("the counted step moved a launch count")
    count_s = time.perf_counter() - t0
    got = {k: one.launches.get(k, {}) for k in served["by_shape"]}
    print(f"cost count (phase 14): {cfg.name} FULL prefill {B} x {S} into "
          f"{max_len} slots, one rank, counted on meta in {one.seconds:.2f} "
          f"s: launches by shape {got}; phase 7's prefill "
          f"{served['by_shape']}")
    if got != served["by_shape"]:
        raise AssertionError("the counted launches by shape differ from "
                             "phase 7's")
    mflops = rf.model_flops(cfg, ShapeSpec("prefill_4k", S, B, "prefill"))
    roof = rf.roofline(one.cost_analysis(), one.collective_summary(), 1,
                       mflops)
    measured = served["prefill_s"]
    frac = roof["step_time_lower_bound_s"] / measured
    mem = one.memory_analysis()
    ratio = mem.peak_bytes / served["peak"]
    share = rf.mfu(mflops, measured)
    print(f"cost count (phase 14): {one.flops} flop ({one.kernel_flops} in "
          f"the kernels; by dtype {one.flops_by_dtype}), {one.bytes} B per "
          f"aten op unfused "
          f"({one.kernel_bytes} in the kernels); roofline compute "
          f"{roof['compute_s']:.6f} s, memory {roof['memory_s']:.6f} s, "
          f"collective {roof['collective_s']:.6f} s, lower bound "
          f"{roof['step_time_lower_bound_s']:.6f} s ({roof['dominant']}), "
          f"model flops {mflops:.4e} (useful {roof['useful_ratio']:.3f}); "
          f"phase 7's warm prefill {measured:.4f} s, measured roofline "
          f"fraction {frac:.4f} (limit {ROOFLINE_SLACK}), model-flops share "
          f"(MFU) {share:.4f}; estimated peak "
          f"{mem.peak_bytes / 2**30:.3f} GiB (arguments "
          f"{mem.argument_size_in_bytes / 2**30:.3f}, outputs "
          f"{mem.output_size_in_bytes / 2**30:.3f}, temporaries "
          f"{mem.temp_size_in_bytes / 2**30:.3f}) against phase 7's "
          f"{served['peak'] / 2**30:.3f} GiB, ratio {ratio:.3f}  [{card}]")
    if not frac <= ROOFLINE_SLACK:
        raise AssertionError(f"the counted lower bound exceeds the measured "
                             f"prefill: fraction {frac}")
    if not 1 / PEAK_RATIO <= ratio <= PEAK_RATIO:
        raise AssertionError(f"the estimated peak is {ratio:.3f}x the "
                             f"measured one")
    by_axis = dict(collections.Counter("+".join(c.axes) for c in tp.calls))
    tp_roof = rf.roofline(tp.cost_analysis(), tp.collective_summary(), 2,
                          mflops)
    print(f"cost count (phase 14): the TP prefill on (data, model) = "
          f"{TP_SERVE_MESH}, rank 0 counted: collectives by axis {by_axis} "
          f"({tp.collective_summary()['wire_bytes_per_chip']:.0f} wire B per "
          f"GPU, all NVLink), launches {tp.launches}; phase 12(a)'s ranks "
          f"recorded {tp_calls}; roofline lower bound "
          f"{tp_roof['step_time_lower_bound_s']:.6f} s "
          f"({tp_roof['dominant']}); phase 14 {count_s:.2f} s  [{card}]")
    for r, calls in enumerate(tp_calls):
        if calls != by_axis:
            raise AssertionError(f"phase 12(a) rank {r} made {calls} "
                                 f"collective calls, the count {by_axis}")
    return {"roofline": roof, "fraction": frac, "mfu": share,
            "peak_ratio": ratio,
            "tp_calls": by_axis, "seconds": count_s}


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
    from repro_torch.launch import hw

    t_start = time.perf_counter()
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
    # a second compile of the same problem takes the executor from the
    # host cache (the first builds it)
    host_mod.clear_executor_cache()
    compiled = []
    for _ in range(2):
        c0 = Session.cache_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = Session.compile(problem, topo, sched, backend="cuda",
                              device=dev)
        torch.cuda.synchronize()
        c1 = Session.cache_stats()
        compiled.append((one, time.perf_counter() - t0,
                         {k: c1[k] - c0[k] for k in ("hits", "misses",
                                                     "size")}))
    sess = compiled[0][0]
    cache = {"compile_s": [c[1] for c in compiled],
             "deltas": [c[2] for c in compiled]}
    print(f"main path: Session.compile {compiled[0][1]:.4f} s building the "
          f"executor (cache delta {compiled[0][2]}), {compiled[1][1]:.4f} s "
          f"taking it from the host cache (delta {compiled[1][2]})  [{card}]")
    if compiled[0][2]["misses"] != 1 or compiled[1][2] != {
            "hits": 1, "misses": 0, "size": 0} or \
            compiled[1][0].executor is not sess.executor:
        raise AssertionError(f"the second compile did not hit the host "
                             f"executor cache: {cache['deltas']}")
    del compiled, one
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

    # ---- 3b. the compressed, delay-planned main path --------------------
    compressed = compressed_path(problem, dev, card)

    # ---- 3c. batched sweeps; 3d. stragglers and acceleration ------------
    swept = sweep_path(problem, topo, dev, card)
    strag = straggler_accel_path(problem, topo, res, compressed["fitted_C"],
                                 dev, card)

    # ---- 3e. checkpoints, kill and resume, elastic membership, fleets ----
    elastic = elastic_path(problem, topo, sched, sess, res, compressed,
                           swept, dev, card)
    del compressed["session"], swept["session"], swept["sweep_set"]

    # ---- 3f. the mesh backend: one process per leaf ---------------------
    meshed = mesh_path(dev, card)

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
    # the least work (kernels/sdca/kernel.py::cost): each distinct sampled
    # row read once
    rows = sum(int(torch.unique(r).numel()) for r in idx)
    flops, nbytes = kernel.cost(rows, 1, K, m_b, d, idx.shape[1])
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / hw.PEAK_FLOPS_F32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"sdca_block at the main path's shape (K={K} m_b={m_b} d={d} "
          f"H={idx.shape[1]}): kernel {ms:.4f} ms/launch, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
          f"{flops} flop), {ms * 1e3 / idx.shape[1]:.3f} us per step, "
          f"max_abs_err {err:.3e}  [{card}]")
    print("sdca_block by loss at that shape: " + ", ".join(
        f"{k} {v:.4f} ms/launch = {v * 1e3 / idx.shape[1]:.4f} us/step"
        for k, v in per_loss.items()) + f"  [{card}]")
    # ---- 5-6. the LM kernels against their plain versions ------------------
    flash_err = check_flash(dev)
    rglru_err = check_rglru(dev)
    del X, y, problem, sess, res, res2, data, ex, args, got, want, cls_args
    torch.cuda.empty_cache()

    # ---- 7. the serving path ---------------------------------------------------
    import shutil
    tp_root = ROOT / "build" / "tp_smoke"
    shutil.rmtree(tp_root, ignore_errors=True)
    phase7_file = tp_root / "phase7.pt"
    lm_launches, served = serve_path(dev, card, phase7_file)
    torch.cuda.empty_cache()

    # ---- 8. the LM kernels timed at the serving shape ------------------------
    lm = time_lm_kernels(dev, card)
    lm["flash_attention"]["max_abs_err"] = max(
        lm["flash_attention"]["max_abs_err"], flash_err)
    lm["rglru_scan"]["max_abs_err"] = max(lm["rglru_scan"]["max_abs_err"],
                                          rglru_err)

    # ---- 9. TreeSync LM training, one rank per replica ----------------------
    torch.cuda.empty_cache()
    trained = train_path(dev, card)

    # ---- 10. the LM sweep, one executor per grid ---------------------------
    torch.cuda.empty_cache()
    swept_lm = lm_sweep_path(dev, card)
    reverse = time_reverse_scan(dev, card)

    # ---- 11. the other architectures: dense, MoE, RWKV6 -------------------
    torch.cuda.empty_cache()
    ep_root = ROOT / "build" / "ep_smoke"
    shutil.rmtree(ep_root, ignore_errors=True)
    ep_file = ep_root / "phase11_dbrx.pt"
    arched = arch_path(dev, card, ep_file)
    lm["flash_attention"]["max_abs_err"] = max(
        [lm["flash_attention"]["max_abs_err"]]
        + [r["max_abs_err"] for r in arched["flash_shapes"].values()])

    # ---- 12. tensor parallelism inside a replica --------------------------
    torch.cuda.empty_cache()
    tp = tp_path(dev, card, phase7_file)
    for name in ("flash_attention", "rglru_scan"):
        lm[name]["max_abs_err"] = max(lm[name]["max_abs_err"],
                                      tp[name]["max_abs_err"])
    # ---- 13. expert- and head-parallel serving, TreeSync over TP -------
    torch.cuda.empty_cache()
    ep = ep_path(dev, card, ep_file)
    lm["flash_attention"]["max_abs_err"] = max(
        lm["flash_attention"]["max_abs_err"],
        ep["flash_attention"]["max_abs_err"])
    # ---- 14. the cost count against phases 7 and 12(a) ------------------
    cost_path(card, served, tp["serve"]["prefill_calls"])
    tp_paths = {name: {k: v[name] for k, v in {**tp["launches"],
                                               **ep["launches"]}.items()
                       if name in v}
                for name in ("flash_attention", "rglru_scan")}
    # the flash row is the serving path's (bf16) kernel; its
    # launches_by_path adds phase 11's requests, by_shape its prefill shapes
    lm_rows = [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/{pkg}/csrc/{src}.cu",
        replaces=replaces, launches=lm_launches[name], **lm[name],
        **({"launches_by_path": {"serve": lm_launches[name],
                                 **arched["launches"],
                                 **tp_paths[name]},
            "by_shape": arched["flash_shapes"],
            "tp_local_shape": tp[name],
            "ep_local_shape": ep[name],
            "tp_by_shape": tp["serve"]["by_shape"][name]}
           if name == "flash_attention" else {}),
        **({"launches_by_path": {
            "serve": lm_launches[name],
            **{f"train_rank{r}": n
               for r, n in enumerate(trained["launches"])},
            **{f"smoke_sweep_rank{r}": n
               for r, n in enumerate(trained["smoke_sweep_launches"])},
            **{f"sweep_rank{r}": n
               for r, n in enumerate(swept_lm["launches"])},
            **tp_paths[name]},
            "tp_local_shape": tp[name],
            "tp_by_shape": tp["serve"]["by_shape"][name],
            "sweep_expected_per_rank": swept_lm["expected_per_rank"],
            "train_expected_per_rank": trained["expected_per_rank"],
            "reverse_time": reverse} if name == "rglru_scan" else {}))
        for name, pkg, src, replaces in (
            ("flash_attention", "flash_attention", "flash_attention_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:86"),
            ("rglru_scan", "rglru", "rglru_scan",
             "src/repro/kernels/rglru/kernel.py:71"))]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the first "
          f"phase to the result")
    print(json.dumps({"kernels": [{
        "name": "sdca_block",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdca/csrc/sdca_block.cu",
        "replaces": "src/repro/kernels/sdca/kernel.py:77",
        "launches": launches,
        "launches_by_path": {
            "main": {"launches": launches, "leaves_per_launch": K},
            "compressed_pilot": {"launches": compressed["pilot_launches"],
                                 "leaves_per_launch": K},
            "compressed_run": {"launches": compressed["launches"],
                               "leaves_per_launch": K},
            **{name: {k: swept[name][k]
                      for k in ("launches", "leaves_per_launch")}
               for name in ("sweep", "sweep_local_hs")},
            **strag, **elastic, **meshed},
        "batched": swept["batched"],
        "max_abs_err": max(worst, swept["batched"]["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }] + lm_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
