"""Perf-iteration tool (the JAX package's ``launch/perf.py``).

Named sharding/step variants applied to one cell; each run prints the
three roofline terms of rank 0's counted step (``launch/dryrun.py``), so
hypothesis -> change -> count cycles are one command:

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --arch qwen3-32b --shape train_4k --mesh single \\
        --variant baseline zero1 mb2 replicate_embed_in

``--treesync`` counts the bytes a pod-level TreeSync sync moves against
the synchronous data-parallel step, and the eq.-(12) optimal period for
each cross-pod link; ``--flash-adjust`` fits the attention's quadratic
bytes of the ``xla_chunked`` route and counts the flash kernel's route
beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

from repro_torch.launch import sharding as sh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "perf_torch"


def _rules(**kw) -> sh.AxisRules:
    base = dataclasses.replace(sh.DEFAULT_RULES, act_seq=("model",))
    return dataclasses.replace(base, **kw)


_FSDP_PURE = dict(embed=("data", "model"), heads=None, kv_heads=None,
                  ffn=None, act_batch=("pod", "data", "model"),
                  act_seq=None, act_heads=None,
                  cache_batch=("pod", "data", "model"))

# name -> dict(rules=..., microbatches=..., cfg_overrides=...), the
# reference's variants
VARIANTS: Dict[str, Dict[str, Any]] = {
    # the dry-run baseline (train: seq-parallel boundaries + 4 microbatches)
    "baseline": dict(),
    # fewer grad-accumulation passes
    "mb2": dict(microbatches=2),
    "mb1": dict(microbatches=1),
    # replicate the embedding table across "model"
    "replicate_embed_in": dict(rules=_rules(vocab_in=None)),
    # ZeRO-1: params replicated over "data", optimizer state sharded
    "zero1": dict(rules=_rules(embed=None, zero1=("data",))),
    "zero1_mb1": dict(rules=_rules(embed=None, zero1=("data",)),
                      microbatches=1),
    "zero1_mb2": dict(rules=_rules(embed=None, zero1=("data",)),
                      microbatches=2),
    "zero1_re": dict(rules=_rules(embed=None, zero1=("data",),
                                  vocab_in=None)),
    "zero1_re_mb2": dict(rules=_rules(embed=None, zero1=("data",),
                                      vocab_in=None), microbatches=2),
    "zero1_re_mb1": dict(rules=_rules(embed=None, zero1=("data",),
                                      vocab_in=None), microbatches=1),
    # no sequence parallelism
    "no_seqpar": dict(rules=dataclasses.replace(sh.DEFAULT_RULES)),
    # pure FSDP/ZeRO-3: batch over both mesh axes, no tensor parallelism
    "fsdp_pure": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, vocab_in=("data", "model"), **_FSDP_PURE),
        microbatches=1),
    "fsdp_pure_mb2": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, vocab_in=("data", "model"), **_FSDP_PURE),
        microbatches=2),
    # fsdp_pure + embedding table sharded on d_model only
    "fsdp_pure_re": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, vocab_in=None, **_FSDP_PURE), microbatches=1),
    # + smaller q-chunks
    "fsdp_pure_re_qc512": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, vocab_in=None, **_FSDP_PURE), microbatches=1,
        cfg_overrides={"q_chunk_size": 512}),
    # inference variants
    "serve_seqpar": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, act_seq=("model",))),
    "serve_headdata": dict(rules=dataclasses.replace(
        sh.DEFAULT_RULES, act_heads=("model", "data"),
        cache_batch=("pod",))),
}


def _save(name: str, rec: Dict[str, Any]) -> None:
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / name).write_text(json.dumps(rec, indent=1))


def run_variant(arch: str, shape_name: str, mesh_name: str, variant: str,
                save: bool = True, **cell) -> Dict[str, Any]:
    """One variant of one cell (``cell``: ``run_cell``'s ``cfg`` /
    ``shape`` / ``mesh`` stand-ins)."""
    from repro_torch.launch.dryrun import run_cell
    v = VARIANTS[variant]
    rec = run_cell(arch, shape_name, mesh_name, rules=v.get("rules"),
                   microbatches=v.get("microbatches"),
                   cfg_overrides=v.get("cfg_overrides"), verbose=False,
                   **cell)
    rec["variant"] = variant
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"  {variant:<18} comp={r['compute_s']*1e3:7.2f}ms "
              f"mem={r['memory_s']*1e3:7.2f}ms "
              f"coll={r['collective_s']*1e3:7.2f}ms "
              f"dom={r['dominant'][:-2]:<10} frac={r['roofline_fraction']:.3f} "
              f"useful={r['useful_ratio']:.2f} "
              f"{rec['memory']['peak_gib_per_device']:.1f}GiB",
              flush=True)
    else:
        print(f"  {variant:<18} {rec['status']}: "
              f"{str(rec.get('error'))[:200]}", flush=True)
    if save:
        safe = arch.replace(".", "_")
        _save(f"{safe}__{shape_name}__{mesh_name}__{variant}.json", rec)
    return rec


def run_flash_adjustment(arch: str, shape_name: str, mesh_name: str,
                         variant: str = "baseline", save: bool = True,
                         cfg=None, mesh=None) -> Dict[str, Any]:
    """The attention's quadratic bytes, as the reference fits them: per
    block, b(S) = a S + c S^2 for the ``xla_chunked`` route (its score
    chain grows with S^2, what the flash kernel keeps on chip); the
    1- and 2-block models are counted at S and S/2 (same batch) and c
    solved for.  Beside it, the flash route of the same cell counted
    directly (the kernel's own bytes; forward only, so a train cell has
    none and says why)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.launch.dryrun import _pattern_len, run_cell

    v = VARIANTS[variant]
    shape = SHAPES[shape_name]
    cfg0 = cfg if cfg is not None else get_config(arch)
    if v.get("cfg_overrides"):
        cfg0 = dataclasses.replace(cfg0, **v["cfg_overrides"])
    p = _pattern_len(cfg0)
    tail = cfg0.num_layers % p
    n_target = cfg0.num_layers // p

    def count(cfg, S):
        rec = run_cell(arch, shape_name, mesh_name, rules=v.get("rules"),
                       microbatches=v.get("microbatches"), verbose=False,
                       cfg=cfg, mesh=mesh, shape=ShapeSpec(
                           shape.name, S, shape.global_batch, shape.kind))
        if rec["status"] != "ok":
            raise RuntimeError(f"{arch} x {shape_name} at S={S}: "
                               f"{rec.get('error')}")
        return {"flops": rec["cost"]["flops_per_chip"],
                "bytes": rec["cost"]["bytes_per_chip"],
                "wire": rec["collectives"]["wire_bytes_per_chip"]}

    def per_block(S, **over):
        out = {}
        for nb in (1, 2):
            c = dataclasses.replace(cfg0, num_layers=nb * p + tail,
                                    q_chunk_size=min(cfg0.q_chunk_size, S),
                                    **over)
            out[nb] = count(c, S)
        return {m: out[2][m] - out[1][m] for m in ("flops", "bytes", "wire")}

    S = shape.seq_len
    b_full = per_block(S, attention_impl="xla_chunked")
    b_half = per_block(S // 2, attention_impl="xla_chunked")
    report: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "variant": variant}
    for metric in ("bytes", "wire", "flops"):
        c = 2.0 * (b_full[metric] - 2.0 * b_half[metric]) / (S * S)
        report[metric] = {"per_block_S": b_full[metric], "quad_coeff": c,
                          "quad_total": c * S * S * n_target}
    if shape.kind == "train" or not cfg0.attends:
        report["flash"] = {"status": "none", "reason": (
            "the flash kernel is forward only" if shape.kind == "train"
            else "the architecture has no attention")}
    else:
        flash = per_block(S, attention_impl="flash")
        report["flash"] = {"status": "ok", "per_block_S": flash,
                           "bytes_saved_per_block": b_full["bytes"]
                           - flash["bytes"]}
    from repro_torch.launch import hw
    quad_bytes = max(report["bytes"]["quad_total"], 0.0)
    report["memory_term_quad_s"] = quad_bytes / hw.HBM_BW
    print(f"  flash-adjust {arch} x {shape_name} ({variant}): "
          f"quadratic HBM bytes = {quad_bytes / 2**40:.3f} TiB/chip "
          f"(= {quad_bytes / hw.HBM_BW:.3f}s of the memory term); "
          f"quad wire = {report['wire']['quad_total'] / 2**30:.2f} GiB "
          f"(should be ~0); flash route: {report['flash']['status']}",
          flush=True)
    if save:
        safe = arch.replace(".", "_")
        _save(f"{safe}__{shape_name}__{mesh_name}__flashadj_{variant}.json",
              report)
    return report


def _sync_wire(cfg, mesh, compressed: bool) -> float:
    """Wire bytes per GPU of one pod-level TreeSync sync: each rank's
    parameter shards all-reduced over ``pod`` (a mean), or their int8
    codes and block scales all-gathered (``core/compression.py``'s
    blocks of 32 along the last dim; the residual stays local)."""
    import torch

    from repro_torch.core.compression import BLOCK
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.steps import params_shape
    from repro_torch.models.shardctx import ShardContext
    ctx = ShardContext(mesh, sh.DEFAULT_RULES)
    specs = sh.param_specs(cfg, params_shape(cfg), mesh)
    local = sh.shard_tree(params_shape(cfg), specs, mesh, ctx.coords)
    for t in sh.flat_with_path(local, is_leaf=lambda x: False):
        t = t[1]
        if compressed and t.shape[-1] % BLOCK == 0:
            codes = torch.empty(t.shape, dtype=torch.int8, device="meta")
            scales = torch.empty(t.shape[:-1] + (t.shape[-1] // BLOCK,),
                                 dtype=torch.float32, device="meta")
            ctx.gather(codes[None], 0, ("pod",))
            ctx.gather(scales[None], 0, ("pod",))
        else:
            ctx.all_reduce(t.float(), ("pod",))
    return rf.collective_summary(
        *rf.aggregate(ctx.collectives))["wire_bytes_per_chip"]


def run_treesync(arch: str, mesh_name: str = "multi", period: int = 16,
                 compression: str = "none", save: bool = True,
                 cfg=None) -> Dict[str, Any]:
    """The paper's schedule at the pod level: replica = one pod (FSDP x TP
    inside); TreeSync averages parameters over ``pod`` every ``period``
    steps, optionally int8-compressed with error feedback.  Counts the
    synchronous data-parallel step (rank 0's counted collectives; its
    cross-pod gradient reduction moves the same bytes as a parameter
    mean) and the sync's wire bytes plain and int8, and reports cross-pod
    bytes per step and step-time models for three cross-pod rates, with
    the eq.-(12) optimal period for each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.delay import optimal_h
    from repro_torch.launch import hw
    from repro_torch.launch.dryrun import make_mesh, run_cell

    if mesh_name != "multi":
        raise ValueError("the pod-level sync needs the multi-pod mesh")
    mesh = make_mesh(mesh_name)
    cfg = cfg if cfg is not None else get_config(arch)
    base = run_cell(arch, "train_4k", mesh_name, microbatches=1,
                    verbose=False, cfg=cfg)
    if base["status"] != "ok":
        raise RuntimeError(f"{arch} train_4k: {base.get('error')}")
    total_wire = base["collectives"]["wire_bytes_per_chip"]
    sync_wire = _sync_wire(cfg, mesh, False)
    sync8_wire = _sync_wire(cfg, mesh, True)

    r = base["roofline"]
    local_s = max(r["compute_s"], r["memory_s"])
    intra_coll_s = max(r["collective_s"] - sync_wire / hw.NETWORK_BW, 0.0)
    report = {
        "arch": arch, "mesh": mesh_name, "period": period,
        "compression": compression,
        "baseline_total_wire_per_chip": total_wire,
        "grad_sync_wire_per_chip": sync_wire,
        "treesync_sync_wire_per_chip": sync_wire,
        "treesync_int8_wire_per_chip": sync8_wire,
        "scenarios": {},
    }
    for name, bw in (("nvlink_450GBps", hw.NVLINK_BW),
                     ("network_50GBps", hw.NETWORK_BW),
                     ("dci_0.5GBps", 0.5e9)):
        base_step = local_s + intra_coll_s + sync_wire / bw
        ts_step = local_s + intra_coll_s + sync_wire / (bw * period)
        ts8_step = local_s + intra_coll_s + sync8_wire / (bw * period)
        h_star, _ = optimal_h(
            C=0.5, K=2, delta=1e-3, t_total=3600.0,
            t_lp=local_s + intra_coll_s, t_delay=sync_wire / bw,
            t_cp=0.0, h_max=10**4)
        report["scenarios"][name] = {
            "sync_dp_step_s": base_step,
            "treesync_step_s": ts_step,
            "treesync_int8_step_s": ts8_step,
            "speedup": base_step / ts_step,
            "speedup_int8": base_step / ts8_step,
            "eq12_optimal_period": h_star,
        }
        print(f"  [{name}] sync-DP {base_step:.2f}s/step; "
              f"TreeSync(H={period}) {ts_step:.2f}s "
              f"({base_step / ts_step:.2f}x); +int8 {ts8_step:.2f}s "
              f"({base_step / ts8_step:.2f}x); eq12 H*={h_star}",
              flush=True)
    print(f"  cross-pod bytes/step: sync-DP {sync_wire / 2**30:.2f} GiB -> "
          f"TreeSync {sync_wire / period / 2**30:.3f} GiB -> "
          f"+int8 {sync8_wire / period / 2**30:.3f} GiB", flush=True)
    if save:
        safe = arch.replace(".", "_")
        _save(f"{safe}__treesync_pod_H{period}.json", report)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", nargs="+", default=["baseline"])
    ap.add_argument("--treesync", action="store_true")
    ap.add_argument("--periods", type=int, nargs=2, default=[4, 16])
    ap.add_argument("--compression", default="none")
    ap.add_argument("--flash-adjust", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    global RESULTS
    if args.out:
        RESULTS = Path(args.out)
    print(f"{args.arch} x {args.shape} x {args.mesh}:")
    if args.treesync:
        run_treesync(args.arch, args.mesh, args.periods[0],
                     args.compression)
        return
    if args.flash_adjust:
        for v in args.variant:
            run_flash_adjustment(args.arch, args.shape, args.mesh, v)
        return
    for v in args.variant:
        run_variant(args.arch, args.shape, args.mesh, v)


if __name__ == "__main__":
    main()
