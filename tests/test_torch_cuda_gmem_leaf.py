"""The sdca_block kernel's global-leaf route on the card: leaves whose
alpha, y and xsq do not fit in a block's shared memory beside w and the
row ring (``kernels/sdca/kernel.py::route``) keep them in global memory and
bring each step's scalars a block of 32 steps ahead.  Held against the
plain version (``kernels/sdca/ref.py``) for every loss code, one and eight
configs, w shared and per leaf, with and without a step mask, at the
route's edges; against draws that repeat a coordinate at every distance
up to and past the steps a scalar is loaded ahead; float for float
against the shared-memory route across the boundary between them; and a
depth-1 session of 8 such leaves against its CPU run.  Every test needs
an NVIDIA GPU and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_gmem_leaf.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem, Schedule, Session, Topology  # noqa: E402
from repro_torch.core import dual, prng  # noqa: E402
from repro_torch.kernels.sdca import kernel, ref  # noqa: E402

pytestmark = pytest.mark.cuda

# |kernel - plain| <= 1e-3 * max(1, max|plain|), as tests/test_torch_cuda.py
# states it: float32 in both, <w, x_i> summed in different orders
REL = 1e-3
# the squared loss's step given as a loss's own CUDA C++ (code 4, kCustom)
CUSTOM = dual.register_loss(dual.Loss(
    "squared_by_formula_gmem_leaf", dual.squared.value, dual.squared.conj_neg,
    dual.squared.coord_delta, gamma=1.0,
    cuda="return (y - wx - a) / (1.0f + xsq);"))
LOSSES = ["squared", "hinge", "smooth_hinge_1", "logistic", CUSTOM.name]
# a step's scalars are loaded 32 to 63 steps before it runs: a coordinate
# drawn again up to 63 steps later takes its alpha from the warp's history
AHEAD = 63


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _limit(device):
    return kernel._library().sdca_block_smem_limit(device.index)


def _operands(loss_name, B, K, m_b, d, H, seed, per_leaf, masked, device):
    """Shared X, y; per-config alpha, w, idx, mask, lm and xsq."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, m_b, d)).astype(np.float32)
    y = rng.standard_normal((K, m_b)).astype(np.float32)
    alpha = (0.1 * rng.standard_normal((B, K, m_b))).astype(np.float32)
    if loss_name not in ("squared", CUSTOM.name):
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
        alpha = np.abs(alpha) * y[None]
    w = (0.1 * rng.standard_normal((B, K, d) if per_leaf else (B, d))
         ).astype(np.float32)
    idx = rng.integers(0, m_b, (B, K, H)).astype(np.int32)
    mask = (rng.uniform(size=(B, K, H)) < 0.7).astype(np.float32) \
        if masked else None
    lms = [float(np.float32(v)) for v in 0.1 * K * m_b * (1.0 + np.arange(B))]
    t = [None if a is None else torch.from_numpy(a).to(device)
         for a in (X, y, alpha, w, idx, mask)]
    sq = torch.sum(t[0] * t[0], dim=2)
    return t + [torch.stack([sq / v for v in lms]), lms]


def _launch_against_plain(loss_name, X, y, alpha, w, idx, mask, xsq, lms):
    loss = dual.get_loss(loss_name)
    before = dict(kernel.LAUNCHES_BY_ROUTE)
    got = kernel.sdca_block_launch_batched(X, y, alpha, w, xsq, idx,
                                           loss=loss, lms=lms,
                                           step_mask=mask)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES_BY_ROUTE["gmem_leaf"] == before["gmem_leaf"] + 1
    assert kernel.LAUNCHES_BY_ROUTE["smem_leaf"] == before["smem_leaf"]
    # the kernel clamps out-of-range coordinates; the plain version indexes
    want = ref.sdca_steps_ref_batched(X, y, alpha, w, xsq,
                                      idx.clamp(0, X.shape[1] - 1),
                                      loss=loss, lms=lms, step_mask=mask)
    for g, r in zip(got, want, strict=True):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= REL * max(
            1.0, float(r.abs().max()))
    return got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_gmem_leaf_matches_plain_version(loss_name, B, per_leaf, masked,
                                         cuda_device):
    """2 leaves of 20,000 rows at d = 64 (w in registers, bulk copies):
    their alpha, y and xsq alone take 240,000 B, above a block's shared
    memory."""
    ops = _operands(loss_name, B, 2, 20_000, 64, 400, 21, per_leaf, masked,
                    cuda_device)
    assert kernel.route(20_000, 64, _limit(cuda_device)) == "gmem_leaf"
    alpha = ops[2].clone()
    _launch_against_plain(loss_name, *ops)
    assert torch.equal(ops[2], alpha)            # the caller's alpha is read


# (K, m_b, d, H, idx range): the route's row copies, where w lives, the
# step count against the blocks of 32 steps the scalars come in
EDGE_SHAPES = {
    "first leaf of the route at d = 2,000 (w in 16 register chunks)":
        (2, 16_037, 2000, 200, None),
    "d > 2,048 (w in shared memory)": (2, 20_000, 2052, 200, None),
    "first leaf of the route at d = 54 (4-byte copies)":
        (2, 19_060, 54, 300, None),
    "d % 4 != 0": (2, 20_000, 13, 300, None),
    "w in 8 chunks": (2, 20_000, 1000, 150, None),
    "H < 32": (2, 20_000, 64, 5, None),
    "H = 0": (2, 20_000, 64, 0, None),
    "H = 1": (2, 20_000, 64, 1, None),
    "H = 33": (2, 20_000, 64, 33, None),
    "H = 65": (2, 20_000, 64, 65, None),
    "out-of-range idx (clamped)": (2, 20_000, 64, 200, (-5, 20_005)),
}


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("shape", list(EDGE_SHAPES), ids=list(EDGE_SHAPES))
def test_gmem_leaf_matches_plain_version_at_the_edges(shape, loss_name,
                                                      per_leaf, cuda_device):
    K, m_b, d, H, span = EDGE_SHAPES[shape]
    assert kernel.route(m_b, d, _limit(cuda_device)) == "gmem_leaf"
    X, y, alpha, w, idx, mask, xsq, lms = _operands(
        loss_name, 1, K, m_b, d, H, 8, per_leaf, per_leaf, cuda_device)
    if span is not None:
        idx = torch.from_numpy(np.random.default_rng(3).integers(
            *span, (1, K, H)).astype(np.int32)).to(cuda_device)
    _launch_against_plain(loss_name, X, y, alpha, w, idx, mask, xsq, lms)


def _repeats(m_b, lead):
    """One leaf's draws: ``lead`` distinct coordinates (shifting where the
    rest falls in a block of 32 steps), then a coordinate drawn again at
    every distance from 1 to AHEAD + 8 with distinct ones in between, one
    drawn three times within a block, one drawn 40 times in a row and one
    every 32nd step (at distances 32 and 64)."""
    fresh = iter(range(m_b))
    seq = [next(fresh) for _ in range(lead)]
    for dist in range(1, AHEAD + 9):
        c = next(fresh)
        seq += [c] + [next(fresh) for _ in range(dist - 1)] + [c]
    c, e = next(fresh), next(fresh)
    seq += [c, next(fresh), c, next(fresh), next(fresh), c] + [e] * 40
    c = next(fresh)
    for _ in range(4):
        seq += [c] + [next(fresh) for _ in range(31)]
    return seq


def _repeats_against_plain(loss_name, per_leaf, d, device):
    """2 configs x 4 leaves of 20,000 rows in ``d`` dimensions, each leaf
    and config drawing :func:`_repeats` at another offset within the
    blocks of 32 steps, against the plain version."""
    K, B, m_b = 4, 2, 20_000
    rows = [_repeats(m_b, lead) for lead in (0, 7, 19, 31, 1, 13, 26, 30)]
    H = min(len(r) for r in rows)
    X, y, alpha, w, _, mask, xsq, lms = _operands(
        loss_name, B, K, m_b, d, H, 17, per_leaf, per_leaf, device)
    idx = torch.tensor([r[:H] for r in rows], dtype=torch.int32,
                       device=device).view(B, K, H)
    _launch_against_plain(loss_name, X, y, alpha, w, idx, mask, xsq, lms)


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_gmem_leaf_is_exact_where_a_coordinate_is_drawn_again(
        loss_name, per_leaf, cuda_device):
    """Repeated coordinates at every distance up to and past the window a
    step's alpha is loaded ahead, each leaf and config at another offset
    within the blocks of 32 steps: a stale alpha would break the chain."""
    _repeats_against_plain(loss_name, per_leaf, 64, cuda_device)


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_gmem_leaf_at_d_2000_is_exact_where_a_coordinate_is_drawn_again(
        loss_name, per_leaf, cuda_device):
    """The same draws at d = 2,000, where the stepping warp holds w in 16
    float4 chunks a lane and the ring one group of 4 rows."""
    _repeats_against_plain(loss_name, per_leaf, 2000, cuda_device)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_first_gmem_leaf_equals_the_last_smem_leaf(loss_name, masked,
                                                   cuda_device):
    """At d = 2,000 a leaf of 16,036 rows takes the shared-memory route
    and one of 16,037 the global-leaf route.  The same draws (none of the
    extra row; each leaf's repeats at every distance, as above) give the
    same floats on both, bit for bit, and both match the plain version."""
    m = 16_036
    limit = _limit(cuda_device)
    assert kernel.route(m, 2000, limit) == "smem_leaf"
    assert kernel.route(m + 1, 2000, limit) == "gmem_leaf"
    rows = [_repeats(m, lead) for lead in (3, 22)]
    H = min(len(r) for r in rows)
    X, y, alpha, w, _, mask, xsq, lms = _operands(
        loss_name, 1, 2, m + 1, 2000, H, 5, True, masked, cuda_device)
    idx = torch.tensor([r[:H] for r in rows], dtype=torch.int32,
                       device=cuda_device).view(1, 2, H)
    loss = dual.get_loss(loss_name)
    before = dict(kernel.LAUNCHES_BY_ROUTE)
    small = kernel.sdca_block_launch_batched(
        X[:, :m].contiguous(), y[:, :m].contiguous(),
        alpha[:, :, :m].contiguous(), w, xsq[:, :, :m].contiguous(), idx,
        loss=loss, lms=lms, step_mask=mask)
    big = _launch_against_plain(loss_name, X, y, alpha, w, idx, mask, xsq,
                                lms)
    assert kernel.LAUNCHES_BY_ROUTE == {
        "smem_leaf": before["smem_leaf"] + 1,
        "gmem_leaf": before["gmem_leaf"] + 1}
    assert torch.equal(big[0][..., :m], small[0])
    assert torch.equal(big[1], small[1])
    assert not big[0][..., m].any()


def test_gmem_leaf_shared_memory_is_what_the_wrapper_reckons(cuda_device):
    lib = kernel._library()
    for d in (4, 13, 54, 64, 512, 1000, 2000, 11_621):
        assert lib.sdca_block_gmem_leaf_smem_bytes(d) == \
            kernel.gmem_leaf_smem_bytes(d)
    assert _limit(cuda_device) == 232_448     # an H100's opt-in per block


def test_depth1_session_of_large_leaves_matches_the_cpu_run(cuda_device):
    """The paper's star (CoCoA: root -> 8 workers) with leaves of 20,000
    rows, above what shared memory holds: every solve tick is one
    global-leaf launch, and the run matches the CPU's plain path."""
    topo = Topology.balanced([8], m_leaf=20_000)
    sched = Schedule(rounds=3, level_rounds=[], local_steps=500)
    rng = np.random.default_rng(31)
    X = rng.standard_normal((topo.m_total, 8)).astype(np.float32)
    y = rng.standard_normal(topo.m_total).astype(np.float32)
    sess = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                           backend="cuda", device=cuda_device)
    before = dict(kernel.LAUNCHES_BY_ROUTE)
    res = sess.run(key=prng.PRNGKey(5))
    torch.cuda.synchronize()
    assert kernel.LAUNCHES_BY_ROUTE["gmem_leaf"] - before["gmem_leaf"] == 3
    assert kernel.LAUNCHES_BY_ROUTE["smem_leaf"] == before["smem_leaf"]
    cpu = Session.compile(Problem(X, y, lam=0.1), topo, sched,
                          backend="torch", device="cpu").run(
                              key=prng.PRNGKey(5))
    np.testing.assert_allclose(res.alpha.cpu().numpy(), cpu.alpha.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.w.cpu().numpy(), cpu.w.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.gaps, cpu.gaps, rtol=1e-4, atol=1e-5)
