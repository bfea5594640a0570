"""The training command line: a thin layer over the Session-driven LM
program (the JAX package's ``launch/train.py``, with the same flags).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --smoke --steps 50 --batch 8 --seq 128

runs one replica on the card.  Under ``torchrun`` every process is one
replica of a data-parallel tree (``--nproc-per-node 4`` on one card gives
four replicas time-sharing it; the sync groups run on gloo)::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --smoke --steps 16 --batch 8 --seq 128 \\
        --periods 2 2 --mesh 2 2

``Problem.lm`` + ``Session.compile`` build the program
(``repro_torch.api.lm.LMSession``); ``CheckpointPolicy`` / ``resume``
handle restart; ``--sync`` is ``periods=(1, ...)`` on the same program
(with SGD, plain data parallelism); ``--adapt-h`` attaches a straggler
policy whose eq.-(12) replanning feeds the runtime periods operand.
"""
from __future__ import annotations

import argparse
import os
import warnings
from typing import Any, Dict, Optional, Sequence

from repro_torch.api import CheckpointPolicy, Problem, Session, Topology
from repro_torch.configs.registry import ARCHS
from repro_torch.core.engine.lm import present_axes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import get_optimizer


def train(cfg, *, steps: int, batch: int, seq: int, mesh=None,
          mode: Optional[str] = None, sync: bool = False,
          periods: Sequence[int] = (4,),
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          lr: float = 3e-4, adapt_h: bool = False,
          log_every: int = 10, seed: int = 0,
          device="cuda") -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` optimizer steps on ``device``; returns
    ``{"history", "final_loss", "wall_s"}`` (history entries ``{"step",
    "loss", "sec"}``).

    ``mode=`` is a deprecated shim: ``mode="sync"`` means ``sync=True``
    (all periods 1), ``mode="treesync"`` the default schedule.
    ``ckpt_every`` is in optimizer steps; snapshots land on outer-round
    boundaries."""
    if mode is not None:
        warnings.warn(
            "train(mode=...) is deprecated: both modes are ONE program "
            "now -- use sync=True (periods all 1) or periods=",
            DeprecationWarning, stacklevel=2)
        if mode not in ("treesync", "sync"):
            raise ValueError(f"unknown mode {mode!r}")
        sync = mode == "sync"

    import torch
    mesh = mesh or make_host_mesh(device_type=torch.device(device).type)
    opt = get_optimizer(cfg, lr=lr)
    prob = Problem.lm(cfg, opt, batch=batch, seq=seq, seed=seed)

    # fit the period list to the mesh's present sync axes (pad with the
    # last value / truncate), then lower the tree once
    axes = present_axes(mesh, ("data", "pod"))
    L = max(len(axes), 1)
    ps = [1] * L if sync else (
        list(periods) + [periods[-1]] * (L - len(periods)))[:L]
    topo = Topology.from_mesh(mesh, sync_axes=("data", "pod"), periods=ps)
    sess = Session.compile(prob, topo, backend="mesh", mesh=mesh,
                           device=device)
    spr = sess.steps_per_round
    quiet = not sess.writer

    def on_step(entry):
        if entry["step"] % log_every == 0 and not quiet:
            print(f"[train] step {entry['step']}: loss={entry['loss']:.4f} "
                  f"{entry['sec']*1e3:.0f}ms", flush=True)

    straggler = None
    if adapt_h:
        if ckpt_dir:
            raise ValueError("--adapt-h does not compose with --ckpt-dir "
                             "(straggler-adaptive runs are not "
                             "checkpointable); pick one")
        from repro_torch.runtime.straggler import (AdaptiveSchedule,
                                                   StragglerPolicy)
        straggler = StragglerPolicy(seed=seed, adaptive=AdaptiveSchedule())

    if ckpt_dir:
        policy = CheckpointPolicy(directory=ckpt_dir, keep=3,
                                  every=max(1, int(ckpt_every) // spr))
        sess.barrier()
        last = policy.manager().latest_step()
        if last is not None:
            # continue toward THIS call's step target; report only the
            # newly run steps (the prefix is the previous run's history)
            res = sess.resume(policy, steps=max(steps - last, 0),
                              on_step=on_step)
            if not quiet:
                print(f"[train] resumed from step {last}; "
                      f"ran to step {int(res.state.step)}")
            history = [e for e in res.history if e["step"] > last]
        else:
            res = sess.run(steps=steps, checkpoint=policy, on_step=on_step)
            history = res.history
    else:
        res = sess.run(steps=steps, straggler=straggler, on_step=on_step)
        history = res.history

    return {"history": history, "final_loss": res.final_loss,
            "wall_s": res.wall_s}


def _init_from_env(device: str):
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), on gloo, and pick
    this process's card; a plain ``python -m`` run has none of these and
    trains one replica."""
    import torch
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from datetime import timedelta
    dist.init_process_group("gloo", timeout=timedelta(seconds=600))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync", action="store_true",
                    help="all periods 1: every step a full barrier "
                         "(the star special case; DP-equivalent)")
    ap.add_argument("--mode", default=None, choices=["treesync", "sync"],
                    help="deprecated: use --sync / --periods")
    ap.add_argument("--periods", type=int, nargs="+", default=[4])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--adapt-h", action="store_true")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("POD", "DATA"),
                    help="a (pod, data) mesh over the world (default: "
                         "(data,) = the world)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    _init_from_env(args.device)
    mesh = None
    if args.mesh is not None:
        from torch.distributed.device_mesh import init_device_mesh
        import torch
        mesh = init_device_mesh(torch.device(args.device).type,
                                (args.mesh[0], args.mesh[1], 1),
                                mesh_dim_names=("pod", "data", "model"))
    mod = ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.FULL
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                mesh=mesh, mode=args.mode, sync=args.sync,
                periods=args.periods, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, adapt_h=args.adapt_h,
                device=args.device)
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] done: final loss {out['final_loss']:.4f} "
              f"in {out['wall_s']:.1f}s")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
