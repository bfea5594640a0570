"""The LM paths' kernels on the card: the hand-written flash-attention and
RG-LRU scan kernels against their plain versions over the shape and dtype
grid chip_smoke.py runs, the wrappers' checks, ``launch/serve.generate``
on the card against its CPU run with the launch counts of prefill and
decode (recurrentgemma, MoE, RWKV6, and a head dim of 80 on the
tensor-core kernel), and the training path: the scan's reverse-time
launch against the plain backward recurrence, gradients through the
kernel (forward and reverse launches) against autograd through the
plain scan, and one training step of one replica.  Every test here
needs an NVIDIA GPU and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import recurrentgemma_2b  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rglru import kernel as rg  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

pytestmark = pytest.mark.cuda

# |kernel - plain| per element, as chip_smoke.py states it: float32
# softmax in both, summed in other orders (and q scaled before the product
# in the kernel, after it in the plain version); in bf16 both outputs are
# rounded to 8 mantissa bits
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(B, Sq, Sk, H, KV, D, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]


# (B, Sq, Sk, H, KV, causal, window, seq_offset)
FLASH_CASES = [
    (2, 128, 128, 10, 1, True, None, 0),
    (1, 192, 192, 10, 1, True, 64, 0),       # window prunes k tiles
    (1, 64, 64, 32, 8, False, None, 0),      # GQA 4:1, non-causal
    (2, 100, 100, 4, 4, True, 30, 0),        # S not a multiple of a tile
    (1, 64, 256, 4, 4, True, 80, 192),       # queries late in the keys
    (1, 48, 160, 32, 8, False, 40, 70),      # window without causality
]


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_version(D, dtype, case, cuda_device):
    B, Sq, Sk, H, KV, causal, window, off = case
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, dtype, cuda_device)
    before = fa.LAUNCHES
    name = fa.route(dtype, D)
    before_route = fa.LAUNCHES_BY_ROUTE[name]
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                    seq_offset=off)
    want = attention_ref(q, k, v, causal=causal, window=window,
                         seq_offset=off)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert fa.LAUNCHES_BY_ROUTE[name] == before_route + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


# the tensor-core kernel's edges: BQ = 128 query rows, BK = 64-key tiles;
# (B, Sq, Sk, H, KV, causal, window, seq_offset)
WGMMA_CASES = {
    # neither length a multiple of 64; the window edge and the diagonal
    # inside one tile; queries late in the keys; one kv head
    "ragged, edges in a tile, offset, KV=1": (1, 130, 200, 8, 1, True, 40,
                                              70),
    "KV = H": (2, 100, 100, 4, 4, True, 30, 0),
    "GQA 4:1, window without causality": (1, 96, 150, 8, 2, False, 50, 20),
    # rows 59.. sit past the keys' window: they see no key
    "rows that see no key": (1, 100, 50, 4, 1, True, 40, 30),
}


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("case", list(WGMMA_CASES), ids=list(WGMMA_CASES))
def test_flash_tensor_core_kernel_at_its_edges(D, case, cuda_device):
    B, Sq, Sk, H, KV, causal, window, off = WGMMA_CASES[case]
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, torch.bfloat16, cuda_device, seed=2)
    before = dict(fa.LAUNCHES_BY_ROUTE)
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                    seq_offset=off)
    want = attention_ref(q, k, v, causal=causal, window=window,
                         seq_offset=off)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_ROUTE == dict(before, wgmma=before["wgmma"] + 1)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[torch.bfloat16],
                               atol=FLASH_TOL[torch.bfloat16])
    blind = (want == 0).flatten(2).all(-1)       # (B, Sq): rows seeing no key
    assert bool((got[blind] == 0).all())
    if case == "rows that see no key":
        assert int(blind.sum()) == B * (Sq - 59)


def test_flash_kernel_at_the_serving_shape(cuda_device):
    """B=1, S=4096, 10 query heads on 1 kv head, d=256, window 2048,
    bf16: one prefill attention layer of recurrentgemma-2b."""
    q, k, v = _qkv(1, 4096, 4096, 10, 1, 256, torch.bfloat16, cuda_device)
    got = fa.flash_attention_kernel(q, k, v, causal=True, window=2048)
    want = attention_ref(q, k, v, causal=True, window=2048, seq_offset=0)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# the scan's edges, (B, S, W, offset): W = 6 (W % 4 != 0: the cp.async
# route), 40 (a block's second consumer lies past W), 32 and 2560; S = 1,
# 20 (under one 32-row stage), 1000 (not a multiple of a stage) and 4096;
# offset 1 (a and b viewed 4 bytes past a 16-byte boundary, still
# contiguous: the cp.async route)
RGLRU_CASES = ([(1, 1, 8, 0), (2, 384, 64, 0), (3, 37, 40, 0)]
               + [(B, S, W, 0) for B in (1, 4) for S in (1, 20, 1000, 4096)
                  for W in (6, 32, 40, 2560)]
               + [(1, 1000, 32, 1), (2, 20, 6, 1), (4, 4096, 2560, 1)])


@pytest.mark.parametrize("B,S,W,offset", RGLRU_CASES)
def test_rglru_kernel_equals_plain_version(B, S, W, offset, cuda_device):
    """The kernel rounds the product and the sum of each step as the plain
    version's two elementwise kernels do, so the two agree bit for bit on
    both routes; TMA takes W % 4 == 0 with 16-byte aligned a and b."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n = B * S * W
    a = (0.9 + 0.1 * torch.rand(n + offset, generator=g, device=cuda_device)
         )[offset:].view(B, S, W)
    b = torch.randn(n + offset, generator=g, device=cuda_device
                    )[offset:].view(B, S, W)
    h0 = torch.randn(B, W, generator=g, device=cuda_device)
    assert a.is_contiguous() and (a.data_ptr() % 16 != 0) == (offset != 0)
    want_route = "tma" if W % 4 == 0 and offset == 0 else "cp_async"
    assert rg.route(a, b) == want_route
    before, routes = rg.LAUNCHES, dict(rg.LAUNCHES_BY_ROUTE)
    h, h_last = rg.rglru_scan_kernel(a, b, h0)
    want_h, want_last = rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
    assert rg.LAUNCHES_BY_ROUTE == dict(
        routes, **{want_route: routes[want_route] + 1})
    assert torch.equal(h, want_h) and torch.equal(h_last, want_last)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device,
                                                            monkeypatch):
    q, k, v = _qkv(1, 32, 32, 4, 2, 64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention_kernel(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention_kernel(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_kernel(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="compiled"):
        fa.flash_attention_kernel(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention_kernel(q, k.cpu(), v)
    monkeypatch.setattr(fa, "smem_limit", lambda device: 1024)
    with pytest.raises(ValueError, match="shared"):
        fa.flash_attention_kernel(q, k, v)


def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(cuda_device,
                                                            monkeypatch):
    a = torch.rand(2, 16, 8, device=cuda_device)
    h0 = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(TypeError):
        rg.rglru_scan_kernel(a.double(), a.double(), h0.double())
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan_kernel(a.transpose(0, 1).contiguous().transpose(0, 1),
                             a, h0)
    with pytest.raises(ValueError):
        rg.rglru_scan_kernel(a, a[:, :8].contiguous(), h0)
    with pytest.raises(ValueError):
        rg.rglru_scan_kernel(a, a, h0.cpu())
    # the source's shared memory is the wrapper's reckoning; a limit below
    # it is refused before the launch
    assert rg._library().rglru_scan_smem_bytes() == rg.smem_bytes()
    assert rg.check_smem(rg.smem_limit(cuda_device)) == rg.smem_bytes()
    before = (rg.LAUNCHES, dict(rg.LAUNCHES_BY_ROUTE))
    monkeypatch.setattr(rg, "smem_limit", lambda device: 1024)
    with pytest.raises(ValueError, match="shared"):
        rg.rglru_scan_kernel(a, a, h0)
    assert (rg.LAUNCHES, rg.LAUNCHES_BY_ROUTE) == before


@pytest.mark.parametrize("impl", ["flash", "xla_chunked"])
def test_generate_on_the_card_matches_the_cpu(impl, cuda_device):
    """recurrentgemma-2b SMOKE at float32 activations: prefill logits and
    greedy tokens on the card against the CPU run; the prefill launches
    the flash kernel once per attention layer (with attention_impl
    "flash") and the scan kernel once per recurrent layer, decode neither."""
    cfg = dataclasses.replace(recurrentgemma_2b.SMOKE,
                              activation_dtype="float32",
                              attention_impl=impl)
    params = transformer.init_params(cfg, prng.PRNGKey(0), device="cpu")
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    kinds = cfg.layer_kinds()
    n_attn = sum(k == "attn" for k in kinds) if impl == "flash" else 0
    n_rec = sum(k == "rec" for k in kinds)

    fa.LAUNCHES = rg.LAUNCHES = 0
    serve.generate(cfg, on_card, {"tokens": toks}, 1, device=cuda_device)
    assert (fa.LAUNCHES, rg.LAUNCHES) == (n_attn, n_rec)
    fa.LAUNCHES = rg.LAUNCHES = 0
    got, _ = serve.generate(cfg, on_card, {"tokens": toks}, 12,
                            device=cuda_device)
    assert (fa.LAUNCHES, rg.LAUNCHES) == (n_attn, n_rec)
    want, _ = serve.generate(cfg, params, {"tokens": toks}, 12, device="cpu")
    assert torch.equal(got.cpu(), want)

    dl, _ = transformer.prefill(cfg, on_card, {"tokens": toks.to(
        cuda_device)})
    cl, _ = transformer.prefill(cfg, params, {"tokens": toks})
    torch.testing.assert_close(dl.cpu(), cl, rtol=1e-4, atol=1e-5)


def test_bf16_prefill_takes_the_tensor_core_route(cuda_device):
    """recurrentgemma-2b SMOKE at its bf16 activations: every prefill
    attention layer goes through the tensor-core kernel, every recurrence
    through the scan's TMA route, and the greedy tokens are in range."""
    cfg = dataclasses.replace(recurrentgemma_2b.SMOKE, attention_impl="flash")
    params = transformer.init_params(cfg, prng.PRNGKey(0),
                                     device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    fa.LAUNCHES = 0
    fa.LAUNCHES_BY_ROUTE.update(wgmma=0, f32=0)
    rg.LAUNCHES_BY_ROUTE.update(tma=0, cp_async=0)
    got, _ = serve.generate(cfg, params, {"tokens": toks}, 6,
                            device=cuda_device)
    assert fa.LAUNCHES_BY_ROUTE == {"wgmma": n_attn, "f32": 0}
    assert rg.LAUNCHES_BY_ROUTE == {"tma": n_rec, "cp_async": 0}
    assert fa.LAUNCHES == n_attn
    assert bool(((got >= 0) & (got < cfg.vocab_size)).all())


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b", "rwkv6-1.6b"])
def test_moe_and_rwkv_generate_on_the_card_match_the_cpu(arch, cuda_device):
    """MoE (dbrx, arctic) and RWKV6 SMOKE at float32 activations with
    attention_impl "flash": prefill logits on the card against the CPU
    run, greedy tokens equal; the prefill launches the flash kernel once
    per attention layer (none for RWKV6), decode launches nothing."""
    cfg = dataclasses.replace(ARCHS[arch].SMOKE, activation_dtype="float32",
                              attention_impl="flash")
    params = transformer.init_params(cfg, prng.PRNGKey(0), device="cpu")
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    fa.LAUNCHES = rg.LAUNCHES = 0
    got, _ = serve.generate(cfg, on_card, {"tokens": toks}, 8,
                            device=cuda_device)
    assert (fa.LAUNCHES, rg.LAUNCHES) == (n_attn, 0)
    want, _ = serve.generate(cfg, params, {"tokens": toks}, 8, device="cpu")
    assert torch.equal(got.cpu(), want)
    dl, _ = transformer.prefill(cfg, on_card, {"tokens": toks.to(
        cuda_device)})
    cl, _ = transformer.prefill(cfg, params, {"tokens": toks})
    torch.testing.assert_close(dl.cpu(), cl, rtol=1e-4, atol=1e-4)


def test_head_dim_80_prefill_takes_the_tensor_core_route(cuda_device):
    """h2o-danube SMOKE widened to two heads of 80 (GQA 2/1, window 16) at
    its bf16 activations: every prefill attention layer goes through the
    tensor-core kernel's 128-wide panel, and the last-position logits
    match the plain chunked route within 5% of their largest magnitude
    (chip_smoke.py's LM_TOL)."""
    cfg = dataclasses.replace(ARCHS["h2o-danube-1.8b"].SMOKE, d_model=160,
                              num_heads=2, num_kv_heads=1, head_dim=80,
                              attention_impl="flash")
    params = transformer.init_params(cfg, prng.PRNGKey(0),
                                     device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32)).to(cuda_device)
    fa.LAUNCHES_BY_ROUTE.update(wgmma=0, f32=0)
    with torch.no_grad():
        got, _ = transformer.prefill(cfg, params, {"tokens": toks})
        want, _ = transformer.prefill(
            dataclasses.replace(cfg, attention_impl="xla_chunked"), params,
            {"tokens": toks})
    assert fa.LAUNCHES_BY_ROUTE == {"wgmma": cfg.num_layers, "f32": 0}
    err = float((got - want).abs().max())
    assert err <= 5e-2 * float(want.abs().max()), err


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# the training path: the scan's autograd Function and one train step
# ---------------------------------------------------------------------------
# gradients through the kernel against autograd through the plain scan,
# as a share of max|plain| per tensor: the forward is bit-equal, the
# backward recurrence runs the same products in the same order but the
# plain version's autograd adds the carried gradient in its own kernels
SCAN_GRAD_TOL = 1e-5


def _scan_case(B, S, W, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    a = 0.5 + 0.5 * torch.rand(B, S, W, generator=g, device=device)
    b = torch.randn(B, S, W, generator=g, device=device)
    h0 = torch.randn(B, W, generator=g, device=device)
    dh = torch.randn(B, S, W, generator=g, device=device)
    return a, b, h0, dh


@pytest.mark.parametrize("B,S,W", [(1, 1, 8), (2, 37, 40), (2, 300, 6),
                                   (1, 2048, 2560)])
def test_reverse_launch_is_the_backward_recurrence(B, S, W, cuda_device):
    from repro_torch.kernels.rglru import ops
    a, _, _, dh = _scan_case(B, S, W, cuda_device)
    before = rg.LAUNCHES
    g = ops.reverse_scan(a, dh)
    assert rg.LAUNCHES == before + 1
    a_next = torch.zeros_like(a)
    a_next[:, :-1] = a[:, 1:]
    want, _ = rglru_scan_ref(torch.flip(a_next, (1,)), torch.flip(dh, (1,)),
                             torch.zeros(B, W, device=cuda_device))
    assert torch.equal(g, torch.flip(want, (1,)))


@pytest.mark.parametrize("B,S,W", [(2, 37, 40), (2, 300, 6), (1, 2048, 2560)])
def test_scan_gradients_through_the_kernel(B, S, W, cuda_device):
    from repro_torch.kernels.rglru import ops
    a, b, h0, dh = _scan_case(B, S, W, cuda_device)
    ins = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    refs = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    before = rg.LAUNCHES
    h, last = ops.rglru_scan(*ins)
    got = torch.autograd.grad((h * dh).sum() + last.sum(), ins)
    assert rg.LAUNCHES == before + 2          # forward, reverse
    hr, lastr = rglru_scan_ref(*refs)
    want = torch.autograd.grad((hr * dh).sum() + lastr.sum(), refs)
    assert torch.equal(h, hr)
    for x, y in zip(got, want, strict=True):
        err = float((x - y).abs().max())
        assert err <= SCAN_GRAD_TOL * max(1.0, float(y.abs().max())), err


def test_one_train_step_on_one_replica(cuda_device):
    """recurrentgemma SMOKE at its bf16 activations with remat: one
    LMSession step on the card (one replica, no process group) launches
    the scan three times per recurrent layer of a block (forward, remat
    recompute, reverse) and twice for the tail's (outside the checkpointed
    blocks), every recurrent-layer parameter gets a nonzero gradient
    through the kernel, and the kernel route's gradients match the plain
    route's."""
    from repro_torch.api import Problem, Session
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import grads_of
    from repro_torch.optim import make_adafactor
    from repro_torch.optim.api import tree_leaves
    cfg = dataclasses.replace(recurrentgemma_2b.SMOKE, remat=True)
    sess = Session.compile(Problem.lm(cfg, make_adafactor(), batch=2,
                                      seq=64), None, backend="mesh",
                           mesh=make_host_mesh(), device=cuda_device)
    pattern, n_full, tail = transformer.block_layout(cfg)
    want = 3 * n_full * pattern.count("rec") + 2 * tail.count("rec")
    rg.LAUNCHES = 0
    res = sess.run(steps=1)
    assert rg.LAUNCHES == want == 8
    assert np.isfinite(res.final_loss)
    params = res.state.params
    batch = sess._batch_at(1)
    gk, _ = grads_of(cfg, params, batch)
    gp, _ = grads_of(cfg, params, batch, plain_recurrence=True)
    mixes = [gk["blocks"]["sub0"]["mix"], gk["blocks"]["sub1"]["mix"],
             gk["tail"][0]["mix"]]
    for mix in mixes:
        for name, g in mix.items():
            assert bool(torch.isfinite(g).all()) and float(
                g.abs().sum()) > 0, name
    for x, y in zip(tree_leaves(gk), tree_leaves(gp), strict=True):
        err = float((x - y).abs().max())
        assert err <= 1e-2 * max(float(y.abs().max()), 1e-12), err


def test_key_init_on_the_card_matches_the_cpu(cuda_device):
    """init_params from a threefry key on the card: the CPU's draw within
    4 float32 ulp, the tolerance the CPU holds against jax (the integer
    draws and uniforms are exact; each device's log1p inside erfinv is
    within an ulp of the true value, and the tails amplify it), the
    layout equal; a seeded TreeSync state lands on the card by
    default."""
    from repro_torch.core import treesync as tsy
    from repro_torch.optim import make_adafactor
    cfg = recurrentgemma_2b.SMOKE
    got = transformer.init_params(cfg, prng.PRNGKey(3), device=cuda_device)
    want = transformer.init_params(cfg, prng.PRNGKey(3), device="cpu")
    gl, wl = list(_leaf_list(got)), list(_leaf_list(want))
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.device.type == "cuda" and a.shape == b.shape
        assert a.dtype == b.dtype
        x, y = a.cpu().double().numpy(), b.double().numpy()
        ulp = np.spacing(np.maximum(np.abs(x), np.abs(y)).astype(np.float32))
        ulps = np.abs(x - y) / np.maximum(ulp.astype(np.float64), 1e-45)
        assert ulps.max(initial=0.0) <= 4, (tuple(a.shape), ulps.max())
    mesh = type("M", (), {"mesh_dim_names": ("data",), "shape": (1,)})()
    ts = tsy.TreeSyncConfig(sync_axes=("data",), periods=(2,))
    st = tsy.init_state(cfg, make_adafactor(), 7, mesh, ts)
    assert all(t.device.type == "cuda" for t in _leaf_list(st.params))


def _leaf_list(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_list(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_list(v)
    else:
        yield tree
