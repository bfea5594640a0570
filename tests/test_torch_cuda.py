"""The port on the card: the hand-written sdca_block kernel against its
plain version, the wrapper's checks, on-device draws and the Session's
CUDA backend against its CPU run.  Every test here needs an NVIDIA GPU
and skips without one; the file imports no JAX, so it runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem, Session, Topology  # noqa: E402
from repro_torch.core import dual, prng  # noqa: E402
from repro_torch.kernels.sdca import kernel, ref  # noqa: E402

pytestmark = pytest.mark.cuda

LOSSES = ["squared", "hinge", "smooth_hinge_1", "logistic"]
# |kernel - plain| <= 1e-3 * max(1, max|plain|), as chip_smoke.py states
# it: float32 in both, <w, x_i> summed in different orders
REL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _block(loss_name, K, m_b, d, H, seed, per_leaf, masked, device):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, m_b, d)).astype(np.float32)
    y = rng.standard_normal((K, m_b)).astype(np.float32)
    alpha = (0.1 * rng.standard_normal((K, m_b))).astype(np.float32)
    if loss_name != "squared":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
        alpha = np.abs(alpha) * y
    w = (0.1 * rng.standard_normal((K, d) if per_leaf else (d,))).astype(
        np.float32)
    idx = rng.integers(0, m_b, (K, H)).astype(np.int32)
    mask = (rng.uniform(size=(K, H)) < 0.7).astype(np.float32) \
        if masked else None
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in (X, y, alpha, w, idx, mask)]


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_kernel_matches_plain_version(loss_name, per_leaf, cuda_device):
    X, y, alpha, w, idx, mask = _block(loss_name, 8, 256, 128, 512, 6,
                                       per_leaf, per_leaf, cuda_device)
    loss = dual.get_loss(loss_name)
    before = kernel.LAUNCHES
    got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=loss, lm=204.8,
                                   step_mask=mask)
    want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=loss, lm=204.8,
                              step_mask=mask)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


# (K, m_b, d, H, idx range): the ring, the two row-copy routes and the two
# places w lives, at the edges of the step count
EDGE_SHAPES = {
    "idx repeating within the ring": (3, 64, 512, 300, (0, 4)),
    "H < ring depth": (2, 40, 512, 5, None),
    "H = 1": (2, 40, 512, 1, None),
    "H = 0": (2, 40, 512, 0, None),
    "d % 4 != 0 (4-byte copies, w in shared memory)": (2, 64, 13, 200, None),
    "d = 2,048 (bulk copies, w in 16 register chunks)": (2, 32, 2048, 60,
                                                         None),
    "d > 2,048 (bulk copies, w in shared memory)": (2, 32, 2052, 60, None),
    "d = 2,000, idx repeating within the ring": (3, 64, 2000, 300, (0, 4)),
    "out-of-range idx (clamped)": (2, 50, 100, 100, (-5, 55)),
    "ring of 12, a partial last group, w in 8 chunks": (2, 40, 600, 77,
                                                       None),
}


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("shape", list(EDGE_SHAPES), ids=list(EDGE_SHAPES))
def test_kernel_matches_plain_version_at_the_edges(shape, loss_name,
                                                   per_leaf, cuda_device):
    K, m_b, d, H, span = EDGE_SHAPES[shape]
    X, y, alpha, w, idx, mask = _block(loss_name, K, m_b, d, H, 8, per_leaf,
                                       per_leaf, cuda_device)
    if span is not None:
        idx = torch.from_numpy(np.random.default_rng(3).integers(
            *span, (K, H)).astype(np.int32)).to(cuda_device)
    loss = dual.get_loss(loss_name)
    lm = 0.1 * K * m_b
    got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=loss, lm=lm,
                                   step_mask=mask)
    # the kernel clamps out-of-range coordinates, as the TPU kernel's
    # dynamic slices do; the plain version indexes, so it gets them clamped
    want = ref.sdca_block_ref(X, y, alpha, w, idx.clamp(0, m_b - 1),
                              loss=loss, lm=lm, step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


def test_kernel_takes_rows_of_an_unaligned_block(cuda_device):
    """X 4 bytes off a 16-byte boundary: the rows come in by 4-byte copies,
    w stays in registers."""
    X, y, alpha, w, idx, mask = _block("hinge", 2, 48, 64, 90, 4, True, True,
                                       cuda_device)
    X = torch.cat([torch.zeros(1, device=cuda_device),
                   X.flatten()])[1:].view(X.shape)
    assert X.data_ptr() % 16 == 4
    got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.hinge,
                                   lm=9.6, step_mask=mask)
    want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=dual.hinge, lm=9.6,
                              step_mask=mask)
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


@pytest.mark.parametrize("m_b,route,offset,nc", [
    (64, "sdca_block_kernel", 0, 16),
    (64, "sdca_block_kernel", 4, 0),
    (16_037, "sdca_block_kernel_gmem_leaf", 0, 16),
    (16_037, "sdca_block_kernel_gmem_leaf", 4, 0),
])
def test_w_in_registers_at_d_2000_needs_aligned_w(m_b, route, offset, nc,
                                                  cuda_device):
    """At d = 2,000 the stepping warp keeps w in 16 float4 chunks a lane
    when w and dw are 16-byte aligned; w 4 bytes off a 16-byte boundary
    takes the shared-memory loop (NC = 0, the device name says which).
    Both match the plain version, on either route."""
    from torch.profiler import ProfilerActivity, profile
    X, y, alpha, w, idx, mask = _block("hinge", 2, m_b, 2000, 200, 12, True,
                                       True, cuda_device)
    w = torch.cat([torch.zeros(offset // 4, device=cuda_device),
                   w.flatten()])[offset // 4:].view(w.shape)
    assert w.data_ptr() % 16 == offset
    lm = 0.1 * 2 * m_b
    kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.hinge, lm=lm,
                             step_mask=mask)           # builds the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.hinge,
                                       lm=lm, step_mask=mask)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "sdca_block_kernel" in e.key]
    assert len(names) == 1 and f"{route}<1, {nc}>(" in names[0], names
    want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=dual.hinge, lm=lm,
                              step_mask=mask)
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


@pytest.mark.parametrize("m_b,d", [(8192, 512), (512, 256), (64, 13),
                                   (32, 2048), (60_000, 4)])
def test_kernel_shared_memory_is_what_the_wrapper_reckons(m_b, d,
                                                          cuda_device):
    assert kernel._library().sdca_block_smem_bytes(m_b, d) == \
        kernel.smem_bytes(m_b, d)


def test_kernel_all_ones_mask_is_bit_identical_to_no_mask(cuda_device):
    X, y, alpha, w, idx, _ = _block("logistic", 4, 128, 64, 256, 1, True,
                                    False, cuda_device)
    ones = torch.ones(idx.shape, device=cuda_device)
    a = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.logistic,
                                 lm=51.2)
    b = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.logistic,
                                 lm=51.2, step_mask=ones)
    assert all(torch.equal(u, v) for u, v in zip(a, b, strict=True))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    X, y, alpha, w, idx, _ = _block("squared", 2, 32, 8, 16, 0, False,
                                    False, cuda_device)
    sq = dual.squared
    with pytest.raises(TypeError):
        kernel.sdca_block_kernel(X.double(), y, alpha, w, idx, loss=sq,
                                 lm=6.4)
    with pytest.raises(TypeError):
        kernel.sdca_block_kernel(X, y, alpha, w, idx.long(), loss=sq, lm=6.4)
    with pytest.raises(ValueError):
        kernel.sdca_block_kernel(X, y, alpha, w[:4], idx, loss=sq, lm=6.4)
    with pytest.raises(ValueError):
        kernel.sdca_block_kernel(X, y, alpha.cpu(), w, idx, loss=sq, lm=6.4)
    # a leaf whose w and row ring alone overflow shared memory (d = 40,000:
    # no route fits; a leaf of 60,000 rows at d = 4 takes the global-leaf
    # route, tests/test_torch_cuda_gmem_leaf.py)
    big = torch.zeros(1, 8, 40_000, device=cuda_device)
    vec = torch.zeros(1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="shared"):
        kernel.sdca_block_kernel(
            big, vec, vec, torch.zeros(40_000, device=cuda_device),
            torch.zeros(1, 8, dtype=torch.int32, device=cuda_device),
            loss=sq, lm=1.0)


def test_draws_on_the_card_match_the_cpu(cuda_device):
    keys = prng.split(prng.PRNGKey(3), 128)
    cpu = prng.randint(keys, (4096,), 0, 8191)
    dev = prng.randint(keys.to(cuda_device), (4096,), 0, 8191)
    assert torch.equal(dev.cpu(), cpu)


def test_session_cuda_backend_matches_the_cpu_run(cuda_device):
    """The kernel path on the card against the plain path on the CPU on an
    imbalanced tree (padded blocks, idle ticks, mixed depth); the launch
    count equals the run's solve ticks."""
    topo = Topology.groups([[24, 16], [12, 20, 8], 20], root_rounds=5,
                           group_rounds=2, local_steps=30)
    rng = np.random.default_rng(9)
    X = rng.standard_normal((topo.m_total, 12)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    sess = Session.compile(Problem(X, y, lam=0.1), topo, backend="cuda",
                           device=cuda_device)
    before = kernel.LAUNCHES
    res = sess.run(key=prng.PRNGKey(5))
    torch.cuda.synchronize()
    ticks = int(sess.executor.solves.sum()) * sess.default_rounds
    assert kernel.LAUNCHES - before == ticks
    cpu = Session.compile(Problem(X, y, lam=0.1), topo, backend="torch",
                          device="cpu").run(key=prng.PRNGKey(5))
    np.testing.assert_allclose(res.alpha.cpu().numpy(), cpu.alpha.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.w.cpu().numpy(), cpu.w.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.gaps, cpu.gaps, rtol=1e-4, atol=1e-5)
    assert torch.equal(res.next_key, cpu.next_key)


@pytest.mark.parametrize("w_scale", [0.1, 3.0])
def test_logistic_kernel_matches_its_plain_version_at_every_newton_depth(
        w_scale, cuda_device):
    """The logistic launch against its plain version where the damped
    Newton steps end soonest (small w) and where they run longer (large w,
    margins far from 0): both end a coordinate at its first step of at
    most 1e-6, after at most 16."""
    X, y, alpha, w, idx, mask = _block("logistic", 8, 256, 128, 512, 6,
                                       True, True, cuda_device)
    w = w * (w_scale / 0.1)
    got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=dual.logistic,
                                   lm=204.8, step_mask=mask)
    want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=dual.logistic,
                              lm=204.8, step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


def test_custom_loss_on_the_card_launches_its_own_step(cuda_device):
    """A registered loss the kernel has no closed form for (the squared
    loss's formulas under a new name, its step given in CUDA C++) is
    launched from a library built with that step: the launch equals the
    plain version (the loss's ``coord_delta``), and a session on the card
    launches once a solve tick and agrees with the built-in squared
    loss's run."""
    custom = dual.register_loss(dual.Loss(
        "squared_by_formula", dual.squared.value, dual.squared.conj_neg,
        dual.squared.coord_delta, gamma=1.0,
        cuda="return (y - wx - a) / (1.0f + xsq);"))
    X, y, alpha, w, idx, mask = _block("squared", 8, 256, 128, 512, 6,
                                       True, True, cuda_device)
    got = kernel.sdca_block_kernel(X, y, alpha, w, idx, loss=custom,
                                   lm=204.8, step_mask=mask)
    want = ref.sdca_block_ref(X, y, alpha, w, idx, loss=custom, lm=204.8,
                              step_mask=mask)
    torch.cuda.synchronize()
    for g, r in zip(got, want, strict=True):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))
    topo = Topology.two_level(2, 4, 256, root_rounds=3, group_rounds=2,
                              local_steps=256)
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((topo.m_total, 64)).astype(
        np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.standard_normal(topo.m_total).astype(
        np.float32)).to(cuda_device)
    runs = {}
    for loss in (custom, dual.squared):
        sess = Session.compile(Problem(X, y, loss=loss, lam=0.1), topo,
                               backend="cuda", device=cuda_device)
        n0 = kernel.LAUNCHES
        runs[loss.name] = sess.run(key=prng.PRNGKey(2))
        torch.cuda.synchronize()
        ticks = int(sess.executor.solves.sum()) * sess.default_rounds
        assert kernel.LAUNCHES - n0 == ticks
    a, b = runs["squared_by_formula"], runs["squared"]
    for g, r in ((a.alpha, b.alpha), (a.w, b.w)):
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


def test_compression_on_the_card_matches_the_cpu(cuda_device):
    """int8 codes, scales and roundtrips and top-k selections (ties
    included) on the card equal the CPU's for the same tensors."""
    from repro_torch.core import compression as comp
    rng = np.random.default_rng(4)
    tied = (rng.integers(0, 4, (8, 96)) * 0.5
            * rng.choice([-1.0, 1.0], (8, 96))).astype(np.float32)
    for x in (rng.standard_normal((128, 512)).astype(np.float32) * 1e-3,
              rng.standard_normal((6, 45)).astype(np.float32), tied):
        host = torch.from_numpy(x)
        dev = host.to(cuda_device)
        for a, b in zip(comp.quantize_int8(dev, keep_leading=1),
                        comp.quantize_int8(host, keep_leading=1),
                        strict=True):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(comp.int8_roundtrip(dev, 1).cpu(),
                           comp.int8_roundtrip(host, 1))
        for k in (1, 5, x.shape[1] // 4):
            assert torch.equal(comp.topk_indices(dev, k).cpu(),
                               comp.topk_indices(host, k))
            assert torch.equal(comp.topk_roundtrip(dev, k).cpu(),
                               comp.topk_roundtrip(host, k))


def test_compressed_and_auto_planned_sessions_match_the_cpu(cuda_device):
    """A top-k compressed session through the kernel on the card against
    the plain path on the CPU (state threaded across root rounds), and
    the C pilot of an auto-planned schedule run on the card."""
    from repro_torch.api import Schedule
    topo = Topology.two_level(2, 2, 32, root_rounds=4, group_rounds=3,
                              local_steps=16, t_lp=1e-6, root_delay=5e-2,
                              group_delay=1e-4)
    rng = np.random.default_rng(10)
    X = rng.standard_normal((topo.m_total, 24)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    sched = Schedule(rounds=4, compression=["topk_0.25", "topk_0.5"])
    before = kernel.LAUNCHES
    sess = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                           backend="cuda", device=cuda_device)
    res = sess.run(key=prng.PRNGKey(5))
    torch.cuda.synchronize()
    assert kernel.LAUNCHES - before == int(sess.executor.solves.sum()) * 4
    cpu = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                          backend="torch", device="cpu").run(
        key=prng.PRNGKey(5))
    np.testing.assert_allclose(res.alpha.cpu().numpy(), cpu.alpha.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.w.cpu().numpy(), cpu.w.numpy(),
                               rtol=1e-4, atol=1e-5)
    auto = Schedule.auto(t_total=0.5, C="auto", compression="auto",
                         pilot_rounds=4)
    on_card = Session.compile(Problem(X, y, lam=0.1), topo, auto,
                              backend="cuda", device=cuda_device)
    on_cpu = Session.compile(Problem(X, y, lam=0.1), topo, auto,
                             backend="torch", device="cpu")
    assert on_card.fitted_C == pytest.approx(on_cpu.fitted_C, rel=1e-3)
    assert [r["H"] for r in on_card.level_plan] == \
        [r["H"] for r in on_cpu.level_plan]
    assert on_card.resolved.compression == on_cpu.resolved.compression


# ---------------------------------------------------------------------------
# the batched launch: B configs x K leaves in one launch
# ---------------------------------------------------------------------------
def _batched(loss_name, B, K, m_b, d, H, seed, per_leaf, masked, device):
    """Shared X, y; per-config alpha, w, idx, mask and lm."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, m_b, d)).astype(np.float32)
    y = rng.standard_normal((K, m_b)).astype(np.float32)
    if loss_name != "squared":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    alpha = (0.1 * rng.standard_normal((B, K, m_b))).astype(np.float32)
    if loss_name != "squared":
        alpha = np.abs(alpha) * y[None]
    w = (0.1 * rng.standard_normal((B, K, d) if per_leaf else (B, d))
         ).astype(np.float32)
    idx = rng.integers(0, m_b, (B, K, H)).astype(np.int32)
    mask = (rng.uniform(size=(B, K, H)) < 0.7).astype(np.float32) \
        if masked else None
    lms = [float(np.float32(v)) for v in 0.1 * K * m_b * (1.0 + np.arange(B))]
    t = [None if a is None else torch.from_numpy(a).to(device)
         for a in (X, y, alpha, w, idx, mask)]
    X_t = t[0]
    sq = torch.sum(X_t * X_t, dim=2)
    xsq = torch.stack([sq / v for v in lms])
    return t + [xsq, lms]


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("B", [1, 3])
def test_batched_launch_matches_plain_version(B, loss_name, per_leaf,
                                              cuda_device):
    X, y, alpha, w, idx, mask, xsq, lms = _batched(
        loss_name, B, 6, 256, 128, 400, 11, per_leaf, per_leaf, cuda_device)
    loss = dual.get_loss(loss_name)
    n0, l0 = kernel.LAUNCHES, kernel.LEAVES
    got = kernel.sdca_block_launch_batched(X, y, alpha, w, xsq, idx,
                                           loss=loss, lms=lms,
                                           step_mask=mask)
    want = ref.sdca_steps_ref_batched(X, y, alpha, w, xsq, idx, loss=loss,
                                      lms=lms, step_mask=mask)
    torch.cuda.synchronize()
    assert (kernel.LAUNCHES - n0, kernel.LEAVES - l0) == (1, B * 6)
    for g, r in zip(got, want, strict=True):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_batched_config_equals_its_single_launch(loss_name, per_leaf,
                                                 cuda_device):
    """Each config's slice of a B = 3 launch is bit for bit the B = 1
    launch on that config's inputs (shared w; per-leaf w with a mask)."""
    X, y, alpha, w, idx, mask, xsq, lms = _batched(
        loss_name, 3, 5, 200, 96, 300, 12, per_leaf, per_leaf, cuda_device)
    loss = dual.get_loss(loss_name)
    da, dw = kernel.sdca_block_launch_batched(X, y, alpha, w, xsq, idx,
                                              loss=loss, lms=lms,
                                              step_mask=mask)
    for b in range(3):
        one = kernel.sdca_block_launch(
            X, y, alpha[b], w[b], xsq[b], idx[b], loss=loss, lm=lms[b],
            step_mask=None if mask is None else mask[b])
        torch.cuda.synchronize()
        assert torch.equal(da[b], one[0]) and torch.equal(dw[b], one[1])


def test_batched_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    X, y, alpha, w, idx, _, xsq, lms = _batched(
        "squared", 2, 3, 32, 8, 16, 0, False, False, cuda_device)
    sq = dual.squared
    with pytest.raises(ValueError, match="lm"):
        kernel.sdca_block_launch_batched(X, y, alpha, w, xsq, idx, loss=sq,
                                         lms=lms[:1])
    with pytest.raises(ValueError, match="w"):
        kernel.sdca_block_launch_batched(X, y, alpha, w[:1], xsq, idx,
                                         loss=sq, lms=lms)
    with pytest.raises(TypeError, match="idx"):
        kernel.sdca_block_launch_batched(X, y, alpha, w, xsq, idx.long(),
                                         loss=sq, lms=lms)


def test_sweep_on_the_card_is_one_launch_a_tick_and_bit_equal(cuda_device):
    """A lambda x seed sweep: one launch per solve tick covering B x n
    leaves, every member torch.equal to its standalone run on the card,
    and close to the CPU's plain run."""
    topo = Topology.two_level(2, 3, 40, root_rounds=3, group_rounds=2,
                              local_steps=24)
    rng = np.random.default_rng(13)
    X = rng.standard_normal((topo.m_total, 16)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    sess = Session.compile(Problem(X, y, lam=0.1), topo, backend="cuda",
                           device=cuda_device)
    n0, l0 = kernel.LAUNCHES, kernel.LEAVES
    rs = sess.sweep(lams=[0.05, 0.2], seeds=[0, 3])
    torch.cuda.synchronize()
    ticks = int(sess.executor.solves.sum()) * sess.default_rounds
    assert kernel.LAUNCHES - n0 == ticks
    assert kernel.LEAVES - l0 == ticks * 4 * topo.n_leaves
    cpu = Session.compile(Problem(X, y, lam=0.1), topo, backend="torch",
                          device="cpu")
    for pt in rs.points:
        single = sess.run(key=prng.PRNGKey(pt.seed), lam=pt.lam)
        mem = rs[pt.index]
        assert torch.equal(mem.alpha, single.alpha)
        assert torch.equal(mem.w, single.w)
        assert mem.gaps.tolist() == single.gaps.tolist()
        plain = cpu.run(key=prng.PRNGKey(pt.seed), lam=pt.lam)
        np.testing.assert_allclose(mem.alpha.cpu().numpy(),
                                   plain.alpha.numpy(), rtol=1e-4, atol=1e-5)


def test_straggler_and_acceleration_on_the_card(cuda_device):
    """Acceleration 0 is the plain run bit for bit on the card; a
    straggler run drops leaves, ends on a full barrier and stays close to
    the CPU's run of the same policy seed."""
    from repro_torch.api import Schedule
    from repro_torch.core.delay import StragglerModel
    from repro_torch.runtime.straggler import StragglerPolicy
    topo = Topology.two_level(2, 2, 32, root_rounds=8, group_rounds=2,
                              local_steps=32, t_lp=1e-5, root_delay=0.02,
                              group_delay=1e-3)
    rng = np.random.default_rng(14)
    X = rng.standard_normal((topo.m_total, 10)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    prob = Problem(X, y, lam=0.1)
    plain = Session.compile(prob, topo, backend="cuda",
                            device=cuda_device).run(key=prng.PRNGKey(0))
    acc = Session.compile(prob, topo, Schedule(acceleration=0.5),
                          backend="cuda", device=cuda_device)
    acc0 = acc.run(key=prng.PRNGKey(0), acceleration=0.0)
    assert torch.equal(acc0.alpha, plain.alpha)
    assert torch.equal(acc0.w, plain.w)

    def policy():
        return StragglerPolicy(model=StragglerModel(slow_prob=0.3,
                                                    slow_factor=30.0),
                               max_consecutive=2, seed=1)
    on_card = Session.compile(prob, topo, backend="cuda",
                              device=cuda_device).run(
        key=prng.PRNGKey(0), straggler=policy())
    on_cpu = Session.compile(prob, topo, backend="torch", device="cpu").run(
        key=prng.PRNGKey(0), straggler=policy())
    parts = [h["participants"] for h in on_card.history[1:]]
    assert min(parts) < topo.n_leaves and parts[-1] == topo.n_leaves
    assert parts == [h["participants"] for h in on_cpu.history[1:]]
    np.testing.assert_allclose(on_card.alpha.cpu().numpy(),
                               on_cpu.alpha.numpy(), rtol=1e-4, atol=1e-5)


def _resume_setup(tmp_path, device):
    from repro_torch.api import CheckpointPolicy, Schedule
    topo = Topology.two_level(2, 3, 40, root_rounds=6, group_rounds=2,
                              local_steps=24)
    rng = np.random.default_rng(15)
    X = rng.standard_normal((topo.m_total, 12)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    sched = Schedule(compression=["int8", "none"])
    return (topo, X, y, sched,
            CheckpointPolicy(tmp_path / "ckpt", every=2))


def test_resume_on_the_card_is_bit_identical(cuda_device, tmp_path):
    """A compressed session on the card, killed after round 3 of 6 and
    resumed: alpha, w, next_key and history equal the uninterrupted run's,
    and every round launched the kernel."""
    topo, X, y, sched, policy = _resume_setup(tmp_path, cuda_device)
    sess = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                           backend="cuda", device=cuda_device)
    ref = sess.run(6, key=prng.PRNGKey(3))
    before = kernel.LAUNCHES
    sess.run(3, key=prng.PRNGKey(3), checkpoint=policy)
    res = sess.resume(policy, rounds=3)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES - before == int(sess.executor.solves.sum()) * 6
    assert torch.equal(res.alpha, ref.alpha)
    assert torch.equal(res.w, ref.w)
    assert torch.equal(res.next_key, ref.next_key)
    assert res.history == ref.history


def test_a_card_checkpoint_resumes_on_the_cpu(cuda_device, tmp_path):
    """The snapshot is host arrays: written by the kernel route on the
    card, it resumes on the CPU's plain route, within the kernel-vs-plain
    tolerance of the card's own uninterrupted run."""
    topo, X, y, sched, policy = _resume_setup(tmp_path, cuda_device)
    card = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                           backend="cuda", device=cuda_device)
    ref = card.run(6, key=prng.PRNGKey(3))
    card.run(3, key=prng.PRNGKey(3), checkpoint=policy)
    cpu = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                          backend="torch", device="cpu")
    res = cpu.resume(policy, rounds=3)
    assert res.alpha.device.type == "cpu"
    assert torch.equal(res.next_key, ref.next_key)
    assert [h["round"] for h in res.history] == \
        [h["round"] for h in ref.history]
    for got, want in ((res.alpha, ref.alpha), (res.w, ref.w)):
        want = want.cpu()
        assert float((got - want).abs().max()) <= \
            REL * max(1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# the mesh backend on the card (spawned ranks sharing card 0)
# ---------------------------------------------------------------------------
MESH_RS_TOL = dict(rtol=1e-5, atol=1e-6)


def _mesh_case(n, dev):
    rng = np.random.default_rng(21)
    topo = Topology.star(n, 512, rounds=4, local_steps=256)
    X = torch.from_numpy(rng.standard_normal((n * 512, 64)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(n * 512).astype(
        np.float32)).to(dev)
    return Problem(X, y, lam=1e-3), topo


def _mesh_rank(rank, world, backend, root):
    """One rank (spawned): psum and reduce_scatter runs on card 0, with
    its sdca_block launches counted around the psum run."""
    import torch.distributed as dist

    from repro_torch.runtime import ranks
    torch.cuda.set_device(0)
    ranks.init(rank, world, f"file://{root}/pg", backend=backend)
    dev = torch.device("cuda", 0)
    prob, topo = _mesh_case(world, dev)
    out = {}
    for sync in ("psum", "reduce_scatter"):
        sess = Session.compile(prob, topo, backend="mesh", device=dev,
                               mesh_sync=sync)
        before = kernel.LAUNCHES
        res = sess.run(key=prng.PRNGKey(5))
        torch.cuda.synchronize()
        out[sync] = {"alpha": res.alpha.cpu(), "w": res.w.cpu(),
                     "gaps": list(res.gaps),
                     "launches": kernel.LAUNCHES - before,
                     "ticks": int(sess.executor.solves.sum()) * 4}
    torch.save(out, f"{root}/rank{rank}.pt")
    dist.destroy_process_group()


def _mesh_against_host(world, backend, root, cuda_device):
    from repro_torch.kernels import _build
    from repro_torch.runtime import ranks
    _build.build_all()               # the ranks load the built library
    prob, topo = _mesh_case(world, cuda_device)
    host = Session.compile(prob, topo, backend="cuda",
                           device=cuda_device).run(key=prng.PRNGKey(5))
    ranks.spawn(_mesh_rank, world, args=(world, backend, str(root)),
                timeout=300)
    for r in range(world):
        got = torch.load(root / f"rank{r}.pt", weights_only=False)
        psum, rs = got["psum"], got["reduce_scatter"]
        assert torch.equal(psum["alpha"], host.alpha.cpu())
        assert torch.equal(psum["w"], host.w.cpu())
        assert psum["gaps"] == list(host.gaps)
        assert psum["launches"] == psum["ticks"] > 0
        np.testing.assert_allclose(rs["alpha"].numpy(),
                                   host.alpha.cpu().numpy(), **MESH_RS_TOL)
        np.testing.assert_allclose(rs["w"].numpy(), host.w.cpu().numpy(),
                                   **MESH_RS_TOL)
    return got


def test_gloo_mesh_on_the_card_equals_the_host_backend(cuda_device,
                                                       tmp_path):
    """Two gloo ranks sharing the card (gloo reduces CUDA tensors through
    all_reduce only, the form the mesh picks for gloo): psum torch.equal
    to the host backend, reduce_scatter within rtol 1e-5 / atol 1e-6, one
    kernel launch per solve tick on each rank."""
    _mesh_against_host(2, "gloo", tmp_path, cuda_device)


def test_one_rank_nccl_mesh_equals_the_host_backend(cuda_device, tmp_path):
    """One NCCL rank (the native all_gather_into_tensor /
    reduce_scatter_tensor / all_reduce forms): both lowerings torch.equal
    to the host backend."""
    got = _mesh_against_host(1, "nccl", tmp_path, cuda_device)
    assert torch.equal(got["reduce_scatter"]["alpha"], got["psum"]["alpha"])
    assert torch.equal(got["reduce_scatter"]["w"], got["psum"]["w"])


def test_strict_session_steps_without_a_host_sync(cuda_device):
    """Session.compile(strict=True) guards each executor step after the
    first with torch.cuda.set_sync_debug_mode("error"): the card path's
    steps make no host synchronization, and the run equals the plain
    one bit for bit."""
    from repro_torch.analysis import TraceGuard
    topo = Topology.two_level(2, 2, 64)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.randn(topo.m_total, 16, generator=g, device=cuda_device)
    y = torch.randn(topo.m_total, generator=g, device=cuda_device)
    plain = Session.compile(Problem(X, y), topo, device=cuda_device).run(
        rounds=3, key=prng.PRNGKey(0))
    strict = Session.compile(Problem(X, y), topo, device=cuda_device,
                             strict=TraceGuard(sanitize=True))
    got = strict.run(rounds=3, key=prng.PRNGKey(0))
    assert torch.equal(got.alpha, plain.alpha)
    assert torch.equal(got.w, plain.w)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_the_sync_guard_raises_on_a_host_sync(cuda_device):
    from repro_torch.analysis import HostSyncError, no_host_sync
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(HostSyncError, match="host synchronization"):
        with no_host_sync():
            float(x.sum())
    assert torch.cuda.get_sync_debug_mode() == 0
