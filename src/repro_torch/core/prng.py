"""Threefry-2x32 keys and integer draws, bit-exact with ``jax.random``.

Every executor of the reference replays the legacy key chain (``split`` per
internal round, ``randint(leaf_key, (H,), 0, m_b)`` per leaf solve), so an
exact port of that chain is what makes a Session-level result of this
package comparable with the JAX package's at all.  The arithmetic here is
the partitionable threefry of jax >= 0.5 (``jax_threefry_partitionable``
on, the default there):

  * ``split(key, n)``: threefry2x32(key, (hi, lo) of iota(n)) -> (n, 2);
  * random bits of shape ``s``: threefry2x32(key, (hi, lo) of
    iota(prod(s)).reshape(s)), the two output words XOR-ed;
  * ``randint``: ``k1, k2 = split(key)``, two 32-bit draws ``hi``, ``lo``
    and ``(hi % span * (2**32 % span) + lo % span) % span`` in uint32
    arithmetic (jax's ``_randint``);
  * ``uniform``: the top 23 bits of one draw as the mantissa of a float32
    in [1, 2), minus 1, scaled to [minval, maxval) by one fused
    multiply-add and floored at minval (jax's ``_uniform`` as XLA
    compiles it) -- bit-exact;
  * ``normal``: ``sqrt(2) * erfinv(u)`` over u uniform in the open
    interval (-1, 1) (jax's ``_normal_real``), erfinv by XLA's float32
    polynomial (:func:`erfinv`); ``log1p`` is torch's, so the normals
    agree to a float32 ulp or two, not bit for bit.  ``normal_blocked``
    draws a large shape in row blocks from the whole draw's counters (the
    model initializers' path).

uint32 arithmetic is done on int64 tensors masked with ``0xFFFFFFFF``, so
the same code runs on the CPU and on the card.  A key is an int64 tensor
of shape ``(..., 2)`` holding two uint32 words; keys live on the CPU unless
a caller moves them.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: Tensor, r: int) -> Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Tensor:
    """The legacy ``jax.random.PRNGKey(seed)``: words ``(seed >> 32,
    seed & 0xFFFFFFFF)`` for ``0 <= seed < 2**32``."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64)


def as_key(key) -> Tensor:
    """A key from a tensor, a numpy array or a sequence of uint32 words
    (e.g. ``np.asarray(jax_key)``), as an int64 tensor; an int is a seed,
    ``PRNGKey(seed)``."""
    if isinstance(key, (int, np.integer)):
        return PRNGKey(int(key))
    if isinstance(key, Tensor):
        return key.to(torch.int64)
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _iota_hi_lo(shape: Sequence[int], device):
    """jax's ``iota_2x32_shape``: the (hi, lo) words of a row-major iota."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return ((flat >> 32) & _M32).reshape(shape), (flat & _M32).reshape(shape)


def _bits(keys: Tensor, shape: Sequence[int]) -> Tensor:
    """32 random bits of ``shape`` per key: output ``keys.shape[:-1] +
    shape``."""
    hi, lo = _iota_hi_lo(shape, keys.device)
    pad = (1,) * len(shape)
    k0 = keys[..., 0].reshape(keys.shape[:-1] + pad)
    k1 = keys[..., 1].reshape(keys.shape[:-1] + pad)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return b0 ^ b1


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)``: (..., 2) keys -> (..., num, 2)."""
    hi, lo = _iota_hi_lo((num,), key.device)
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def randint(keys: Tensor, shape: Sequence[int], minval: int,
            maxval: Union[int, Tensor]) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 output) for
    every key of a batch: ``keys`` is (..., 2), the result ``keys.shape[:-1]
    + shape``.  ``maxval`` is a scalar or one value per key (the executors
    draw each leaf's coordinates below its own block size)."""
    shape = tuple(int(s) for s in shape)
    batch = keys.shape[:-1]
    pair = split(keys, 2)
    higher = _bits(pair[..., 0, :], shape)
    lower = _bits(pair[..., 1, :], shape)
    mx = torch.as_tensor(maxval, dtype=torch.int64, device=keys.device)
    mx = mx.reshape(mx.shape + (1,) * (len(batch) + len(shape) - mx.dim()))
    span = (mx - int(minval)) & _M32
    span = torch.where(mx <= int(minval), torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((higher % span) * mult) & _M32
    off = ((off + lower % span) & _M32) % span
    return (int(minval) + off).to(torch.int32)


def uniform(key: Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for one
    key (``(2,)``) or a batch (``(..., 2)``; output ``keys.shape[:-1] +
    shape``), bit for bit."""
    shape = tuple(int(s) for s in shape)
    bits = _bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add;
    # the float64 product of two float32 values is exact, so the float64
    # sum rounded to float32 reproduces it (tests/test_torch_prng.py holds
    # it bit for bit)
    span = (hi - lo).double()
    scaled = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, scaled)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = np.float32(np.sqrt(2))
# XLA's float32 erfinv (Giles' polynomials in w = -log1p(-x^2), one for w
# < 5 in w - 2.5, one in sqrt(w) - 3), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: Tensor) -> Tensor:
    """float32 erfinv as XLA computes it for ``jax.lax.erf_inv``: the same
    polynomials, each Horner step a fused multiply-add as XLA compiles it
    (the float64 product of two float32 values is exact, so the float64
    sum rounded once reproduces it).  Only ``log1p`` is torch's, so the
    result agrees with jax's to an ulp or two where ``torch.erfinv``
    (another polynomial) is off by tens of ulps in the tails."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, np.float32(a).item(), np.float32(b).item())
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: Tensor, shape: Sequence[int] = ()) -> Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) *
    erfinv(u)`` with u uniform over (nextafter(-1, 0), 1), as jax draws
    it.  The uniforms are exact; the result differs from jax's by the two
    ``log1p`` implementations inside :func:`erfinv`, an ulp or two."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * torch.tensor(_SQRT2, device=key.device)


# ---------------------------------------------------------------------------
# the draws of the LM data stream (``data/lm.py``)
# ---------------------------------------------------------------------------
def fold_in(key: Tensor, data: int) -> Tensor:
    """``jax.random.fold_in(key, data)``: threefry2x32 of the key over the
    counter words ``(0, data)`` (jax's ``threefry_seed`` of a uint32)."""
    k0, k1 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k0)
    d = torch.full_like(k0, int(data) & _M32)
    b0, b1 = threefry2x32(k0, k1, zero, d)
    return torch.stack([b0, b1], dim=-1)


def _bits_range(key: Tensor, start: int, count: int, device=None) -> Tensor:
    """The 32 random bits of flat positions ``start .. start + count`` of a
    row-major draw of any shape holding them (one key, ``(2,)``): the same
    counters the whole draw would use."""
    flat = torch.arange(start, start + count, dtype=torch.int64,
                        device=device if device is not None else key.device)
    k = key.to(flat.device)
    b0, b1 = threefry2x32(k[0], k[1], (flat >> 32) & _M32, flat & _M32)
    return b0 ^ b1


def _unit_floats(bits: Tensor) -> Tensor:
    """float32 in [0, 1) from the top 23 bits of each word."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _scale_to(floats: Tensor, minval: float, maxval: float) -> Tensor:
    """``max(minval, floats * (maxval - minval) + minval)`` with the
    multiply-add fused, as :func:`uniform` computes it."""
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    span = (hi - lo).double()
    return torch.maximum(lo, (floats.double() * span + lo.double()).float())


def bernoulli(key: Tensor, p: float = 0.5, shape: Sequence[int] = ()
              ) -> Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a uniform draw
    below ``p``, bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel_rows(key: Tensor, shape: Sequence[int], start: int, count: int,
                device=None) -> Tensor:
    """Rows ``start .. start + count`` of ``jax.random.gumbel(key, shape)``
    (mode "low", float32) with ``shape``'s last axis a row: ``-log(-log(
    u))``, u uniform over [tiny, 1), from the counters the whole draw would
    use.  Returns ``(count, shape[-1])``."""
    V = int(shape[-1])
    u = _scale_to(_unit_floats(_bits_range(key, start * V, count * V,
                                           device)), _TINY, 1.0)
    return (-torch.log(-torch.log(u))).reshape(count, V)


def categorical(key: Tensor, logits: Tensor, shape: Sequence[int],
                rows: Union[slice, None] = None,
                chunk_elems: int = 1 << 24) -> Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for 1-D
    ``logits`` (V,): the Gumbel-max argmax over gumbel noise of shape
    ``shape + (V,)`` plus ``logits``, int32 of ``shape``.

    ``rows`` (a slice of ``shape[0]``) draws only those leading rows, from
    the counters of the whole draw offset to the block, so a rank draws its
    own rows of a global batch and gets exactly their slice.  The noise is
    made ``chunk_elems`` at a time, so a (B, S, V) draw at a 256k vocab
    never exists at once.  Ties go to the lower index, as ``jnp.argmax``
    breaks them."""
    shape = tuple(int(s) for s in shape)
    V = int(logits.shape[-1])
    rows = rows if rows is not None else slice(0, shape[0])
    r0, r1, _ = rows.indices(shape[0])
    per_row = int(np.prod(shape[1:], dtype=np.int64))   # V-vectors a row
    n = (r1 - r0) * per_row
    step = max(1, chunk_elems // max(V, 1))
    logits = logits.float()
    out = []
    for s in range(0, n, step):
        c = min(step, n - s)
        g = gumbel_rows(key, shape + (V,), r0 * per_row + s, c,
                        device=logits.device)
        out.append(torch.argmax(g + logits, dim=-1))
        del g
    if not out:
        return torch.zeros((r1 - r0,) + shape[1:], dtype=torch.int32,
                           device=logits.device)
    return torch.cat(out).to(torch.int32).reshape((r1 - r0,) + shape[1:])


# elements of one block of a blocked normal draw (a full-width embedding is
# 655M counters; a block's int64 temporaries stay near 1 GiB)
NORMAL_BLOCK = 1 << 24


def normal_range(key: Tensor, start: int, count: int, device=None
                 ) -> Tensor:
    """Flat positions ``start .. start + count`` of ``jax.random.normal(
    key, shape)`` for any shape holding them (one key, ``(2,)``): the
    counters of the whole draw, the same arithmetic as :func:`normal`."""
    u = _scale_to(_unit_floats(_bits_range(key, start, count, device)),
                  _NORMAL_LO, 1.0)
    return erfinv(u) * torch.tensor(_SQRT2, device=u.device)


def normal_blocked(key: Tensor, shape: Sequence[int], device=None,
                   dtype=torch.float32, scale=None,
                   block_elems: int = NORMAL_BLOCK) -> Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)`` on
    ``device`` (the key's by default), drawn in blocks of whole rows of
    ``shape[0]`` of at most ``block_elems`` elements (one row when a row
    is longer), each from the counters the whole draw would use: the
    result equals :func:`normal` of the whole shape (scaled and cast),
    and no temporary is larger than a block."""
    shape = tuple(int(s) for s in shape)
    dev = torch.device(device) if device is not None else key.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    if out.numel() == 0 or dev.type == "meta":   # meta: shape and dtype only
        return out
    flat = out.view(shape[0], -1) if shape else out.view(1, 1)
    row = flat.shape[1]
    rows = max(1, int(block_elems) // row)
    for r0 in range(0, flat.shape[0], rows):
        r1 = min(r0 + rows, flat.shape[0])
        z = normal_range(key, r0 * row, (r1 - r0) * row, dev)
        if scale is not None:
            z = z * scale
        flat[r0:r1].copy_(z.view(r1 - r0, row))
        del z
    return out


def _round_bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).float()


def normal_bf16(key: Tensor, shape: Sequence[int] = ()) -> Tensor:
    """``jax.random.normal(key, shape, bfloat16)``: 8-bit draws (the low
    byte of each word: bfloat16 has 7 mantissa bits), a bfloat16 uniform over (nextafter(-1, 0), 1) and
    ``sqrt(2) * erfinv(u)``, each operation rounded to bfloat16.  The
    erfinv differs from jax's by its implementation, so the result agrees
    to a bfloat16 ulp or so, not bit for bit."""
    shape = tuple(int(s) for s in shape)
    bits = (_bits(key, shape) & 0xFF) >> 1
    floats = ((bits | 0x3F80) << 16).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(-1.0 + 2.0 ** -8, device=key.device)   # bf16 nextafter
    span = _round_bf16(1.0 - lo)
    u = torch.maximum(lo, _round_bf16(_round_bf16(floats * span) + lo))
    z = _round_bf16(torch.erfinv(u))
    return (z * _round_bf16(torch.tensor(float(np.sqrt(2)),
                                         device=key.device))
            ).to(torch.bfloat16)
