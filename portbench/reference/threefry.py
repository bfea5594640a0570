"""Threefry-2x32 key splits and integer draws, bit for bit as ``jax.random``
draws them with ``jax_threefry_partitionable`` on (a frozen copy of the
arithmetic of the port's ``core/prng.py``, which follows jax >= 0.5):

  * ``split(key, n)``: threefry2x32(key, (hi, lo) of iota(n)) -> (n, 2);
  * 32 random bits of shape ``s``: threefry2x32(key, (hi, lo) of
    iota(prod(s)).reshape(s)), the two output words XOR-ed;
  * ``randint``: ``k1, k2 = split(key)``, two 32-bit draws ``hi``, ``lo``
    and ``(hi % span * (2**32 % span) + lo % span) % span``.

uint32 arithmetic runs on int64 tensors masked with ``0xFFFFFFFF``, so the
same code runs on the CPU and on the card.  A key is an int64 tensor of
shape ``(..., 2)`` holding two uint32 words.
"""
from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: Tensor, r: int) -> Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _iota_hi_lo(shape: Sequence[int], device):
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return ((flat >> 32) & M32).reshape(shape), (flat & M32).reshape(shape)


def _bits(keys: Tensor, shape: Sequence[int]) -> Tensor:
    """32 random bits of ``shape`` per key: ``keys.shape[:-1] + shape``."""
    hi, lo = _iota_hi_lo(shape, keys.device)
    pad = (1,) * len(shape)
    k0 = keys[..., 0].reshape(keys.shape[:-1] + pad)
    k1 = keys[..., 1].reshape(keys.shape[:-1] + pad)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return b0 ^ b1


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)`` for every key of a batch: (..., 2)
    keys -> (..., num, 2)."""
    hi, lo = _iota_hi_lo((num,), key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def randint(keys: Tensor, shape: Sequence[int], maxval: int) -> Tensor:
    """``jax.random.randint(key, shape, 0, maxval)`` for every key of a
    batch: (..., 2) keys -> ``keys.shape[:-1] + shape`` int64 draws."""
    shape = tuple(int(s) for s in shape)
    pair = split(keys, 2)
    higher = _bits(pair[..., 0, :], shape)
    lower = _bits(pair[..., 1, :], shape)
    span = int(maxval) & M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span      # uint32: 2**32 wraps to 0
    off = ((higher % span) * mult) & M32
    return ((off + lower % span) & M32) % span
