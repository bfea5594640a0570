"""Deterministic synthetic LM data pipeline (the JAX package's
``data/lm.py``), bit for bit: the same tokens and labels for the same
``(seed, step)``.

Host-invariant: batch t is a pure function of (seed, t), so every process
generates the same global batch and a restart resumes the stream exactly.
A rank of a data-parallel run draws only its own rows (``rows=``): the
Gumbel noise of ``jax.random.categorical`` is drawn from the counters of
the whole (B, S + 1, V) draw offset to the rank's block, a chunk at a
time, so a 256k-vocab batch never exists whole.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs so a small model has learnable structure.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

from repro_torch.core import prng

Tensor = torch.Tensor


def lm_batch(cfg, batch: int, seq: int, step: int, seed: int = 0, *,
             rows: Optional[slice] = None, device="cuda"
             ) -> Dict[str, Tensor]:
    """Batch ``step`` of the deterministic stream on ``device``; ``rows``
    (a slice of the batch) keeps only those sequences, drawn as their
    slice of the whole batch."""
    rows = rows if rows is not None else slice(0, batch)
    key = prng.fold_in(prng.PRNGKey(seed), step)
    kz, km, kpos, kmask = prng.split(key, 4)
    V = cfg.vocab_size

    # Zipf-ish unigram: p(v) ~ 1/(v+10)
    ranks = torch.arange(V, dtype=torch.float32, device=device)
    logits = -torch.log(ranks + 10.0)
    toks = prng.categorical(kz, logits, (batch, seq + 1), rows=rows)

    # overlay repeated motifs (period-8 structure the model can learn)
    motif = prng.randint(km, (batch, 8), 0, V)[rows].to(device)
    tiled = motif.repeat(1, (seq + 1) // 8 + 1)[:, : seq + 1]
    use_motif = prng.bernoulli(kmask, 0.5, (batch, 1))[rows].to(device)
    toks = torch.where(use_motif, tiled, toks)

    out: Dict[str, Tensor] = {
        "tokens": toks[:, :-1].to(torch.int32).contiguous(),
        "labels": toks[:, 1:].to(torch.int32).contiguous(),
    }
    if cfg.input_mode == "embeddings":
        # modality-frontend stub: pretend tokens were already embedded
        emb_key = prng.fold_in(kpos, 1)
        table = prng.normal_bf16(emb_key, (256, cfg.d_model)).to(device)
        table = (table.float() * torch.tensor(0.02, dtype=torch.bfloat16)
                 .float()).to(torch.bfloat16)
        out["embeds"] = table[(out["tokens"] % 256).long()]
    return out


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0,
                         start: int = 0, *, rows: Optional[slice] = None,
                         device="cuda") -> Iterator[Dict[str, Tensor]]:
    step = start
    while True:
        yield lm_batch(cfg, batch, seq, step, seed, rows=rows, device=device)
        step += 1
