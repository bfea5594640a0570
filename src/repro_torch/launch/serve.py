"""Serving entry point: batched prefill + greedy decode (the JAX package's
``launch/serve.py``), on the card unless the caller asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --smoke --batch 4 --prompt-len 32 --gen 16

Weights and prompts are drawn from ``PRNGKey(0)`` at the config's shapes,
as the reference's CLI draws them; the published checkpoints are not in
the repository.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.core import prng
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: Dict[str, torch.Tensor], gen_tokens: int,
             max_len: Optional[int] = None, device="cuda"):
    """Prefill the prompt batch then greedily decode ``gen_tokens`` tokens.
    ``params`` must already be on ``device``; the prompts are moved there.
    Returns (tokens (B, gen_tokens) int32, {"prefill_s", "decode_s",
    "tok_per_s"}), times on the host clock around work that ends in a
    device synchronize."""
    device = torch.device(device)
    prompts = {k: torch.as_tensor(v).to(device) for k, v in prompts.items()}
    first_input = prompts.get("tokens", prompts.get("embeds"))
    B, S = first_input.shape[0], first_input.shape[1]
    max_len = max_len or (S + gen_tokens)
    prefill = make_prefill_step(cfg, max_len=max_len)
    serve = make_serve_step(cfg)

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompts)
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0

        toks = [first]
        t0 = time.perf_counter()
        tok = first
        for _ in range(gen_tokens - 1):
            tok, cache = serve(params, cache, tok)
            toks.append(tok)
        out = torch.cat(toks, dim=1)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return out, {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tok_per_s": B * (gen_tokens - 1) / max(t_decode, 1e-9)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.FULL
    key = prng.PRNGKey(0)            # the reference's PRNGKey(0), reused
    params = transformer.init_params(cfg, key, device=args.device)
    if cfg.input_mode == "embeddings":
        prompts = {"embeds": (0.02 * prng.normal_bf16(
            key, (args.batch, args.prompt_len, cfg.d_model))).to(args.device)}
    else:
        prompts = {"tokens": prng.randint(
            key, (args.batch, args.prompt_len), 0,
            cfg.vocab_size).to(args.device)}
    out, stats = generate(cfg, params, prompts, args.gen, device=args.device)
    print("generated:", tuple(out.shape), out[0, :8].tolist())
    print({k: round(v, 4) for k, v in stats.items()})


if __name__ == "__main__":
    main()
