"""End-to-end LM training on the PyTorch/CUDA port
(``examples/train_lm.py``'s program): a ~100M-param decoder-only LM for a
few hundred steps with the paper's TreeSync schedule + checkpointing.
``--sync`` is the same program with every period 1; ``--smoke`` swaps in
a tiny config (seconds, any machine).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --smoke --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import train

CFG_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    num_layers=10,
    d_model=640,
    num_heads=10,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=32_768,
    qk_norm=True,
    q_chunk_size=128,
    logits_chunk=128,
    remat=False,
    param_dtype="float32",
)  # ~104M params (printed at startup)

CFG_SMOKE = ModelConfig(
    name="repro-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    q_chunk_size=32,
    logits_chunk=32,
    remat=False,
    param_dtype="float32",
)  # CI-sized: a few seconds on one CPU


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config + short sequences (CI smoke)")
    ap.add_argument("--sync", action="store_true",
                    help="all periods 1 (the fully synchronous star)")
    ap.add_argument("--periods", type=int, nargs="+", default=[4])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = CFG_SMOKE if args.smoke else CFG_100M
    batch, seq = (4, 32) if args.smoke else (args.batch, args.seq)
    ckpt = args.ckpt_dir
    if ckpt is None and not args.smoke:
        ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")

    print(f"training {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
          f"sync={args.sync}, steps={args.steps}")
    out = train(
        cfg, steps=args.steps, batch=batch, seq=seq,
        sync=args.sync, periods=args.periods, lr=1e-3,
        ckpt_dir=ckpt, ckpt_every=100, log_every=20, device=args.device,
    )
    h = out["history"]
    print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"({out['wall_s']:.0f}s wall)")
    assert h[-1]["loss"] < h[0]["loss"], "training failed to reduce loss"


if __name__ == "__main__":
    main()
