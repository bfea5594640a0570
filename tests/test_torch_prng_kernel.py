"""The solve tick's coordinate draws: the ``threefry_randint`` kernel
(``kernels/prng``) against ``core/prng.py::randint``, and
``HostExecutor.draw_idx`` through its wrapper.

On the CPU: the wrapper's plain version is what ``draw_idx`` drew before
the kernel existed (``randint`` once per distinct H, zeros beyond each
leaf's H), for one and for several H and for a mesh rank's ``rows``, over
a grouping by H that the executor builds once; it launches nothing,
counts nothing and refuses what the kernel would not take; ``cost`` gives
the kernels table's bounds.  On the card (``cuda``-marked, skipped without
one; the file imports no JAX): the kernel equals ``randint`` bit for bit
at the benchmark cells' shapes, for mixed H, for m_b = 1 and for m_b above
2^16, where the reduction's multiplier is not trivial, and each launch,
and nothing else, counts ``draw.kernel_ticks`` under a profiler:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_prng_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import dual, instrument, prng  # noqa: E402
from repro_torch.core.engine.host import HostExecutor  # noqa: E402
from repro_torch.core.engine.plan import compile_tree  # noqa: E402
from repro_torch.core.tree import TreeNode  # noqa: E402
from repro_torch.kernels.prng import kernel, ref  # noqa: E402
from repro_torch.launch import hw  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _keys(shape, seed, device="cpu"):
    """int64 tensors of uint32 key words, (*shape, 2)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, tuple(shape) + (2,), dtype=np.int64)
    return torch.from_numpy(words).to(device)


def _tree(hs, sizes):
    """Two groups of two leaves under a root; leaf i takes H hs[i] and
    sizes[i] rows."""
    leaves = [TreeNode(name=f"l{i}", rounds=h, data_size=m)
              for i, (h, m) in enumerate(zip(hs, sizes))]
    return TreeNode(name="root", rounds=2, children=(
        TreeNode(name="g0", rounds=2, children=tuple(leaves[:2])),
        TreeNode(name="g1", rounds=2, children=tuple(leaves[2:]))))


def _executor(hs, sizes, device="cpu", rows=slice(None)):
    return HostExecutor(compile_tree(_tree(hs, sizes)),
                        loss=dual.get_loss("squared"), backend="torch",
                        device=device, rows=rows)


def _draws_by_group(keys, hs, sizes, h_max):
    """The draws as ``draw_idx`` made them before the kernel: the leaves
    grouped by H, each group one ``randint`` of its exact shape, one H
    returned as drawn, several placed in (..., n, h_max) zeros."""
    hs, sizes = np.asarray(hs), np.asarray(sizes)
    lead = tuple(keys.shape[:-2])
    groups = sorted({int(h) for h in hs})
    if len(groups) == 1:
        mb = torch.as_tensor(sizes, dtype=torch.int64)
        return prng.randint(keys, (groups[0],), 0,
                            mb.expand(lead + tuple(mb.shape)))
    idx = torch.zeros(lead + (len(hs), h_max), dtype=torch.int32)
    for h in groups:
        rows = torch.as_tensor(np.nonzero(hs == h)[0])
        mb = torch.as_tensor(sizes[rows.numpy()], dtype=torch.int64)
        idx[..., rows, :h] = prng.randint(keys[..., rows, :], (h,), 0,
                                          mb.expand(lead + tuple(mb.shape)))
    return idx


PLANS = {
    "one H": ([24, 24, 24, 24], [16, 16, 11, 16]),
    "several H": ([24, 8, 24, 5], [16, 9, 16, 3]),
}


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_draw_idx_on_cpu_keys_is_the_grouped_randint(plan, lead):
    hs, sizes = PLANS[plan]
    ex = _executor(hs, sizes)
    keys = _keys(lead + (4,), 11)
    before = kernel.LAUNCHES
    got = ex.draw_idx(keys)
    assert kernel.LAUNCHES == before           # no kernel on the CPU
    want = _draws_by_group(keys, hs, sizes, max(hs))
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    for li, h in enumerate(hs):
        assert (got[..., li, h:] == 0).all()
        assert (got[..., li, :h] < sizes[li]).all()


def test_draw_idx_of_a_mesh_rank_draws_its_own_leaf():
    hs, sizes = PLANS["several H"]
    keys = _keys((4,), 12)
    whole = _executor(hs, sizes).draw_idx(keys)
    for leaf in range(4):
        ex = _executor(hs, sizes, rows=slice(leaf, leaf + 1))
        got = ex.draw_idx(keys[leaf:leaf + 1])
        h = hs[leaf]
        assert got.shape == (1, h)              # one H: as randint gives it
        assert torch.equal(got[0], whole[leaf, :h])


def test_draw_idx_groups_the_leaves_by_h_once(monkeypatch):
    hs, sizes = PLANS["several H"]
    ex = _executor(hs, sizes)
    assert [g[0] for g in ex.draw_groups] == sorted(set(hs))

    def regroup(*a):
        raise AssertionError("the draws regrouped the leaves by H")

    monkeypatch.setattr(ref, "h_groups", regroup)
    for seed in (15, 16):                       # two ticks
        keys = _keys((4,), seed)
        assert torch.equal(ex.draw_idx(keys),
                           _draws_by_group(keys, hs, sizes, max(hs)))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plain_version_over_given_groups_draws_as_over_its_own(plan):
    hs, sizes = PLANS[plan]
    keys = _keys((2, 4), 17)
    hcap = torch.tensor(hs, dtype=torch.int32)
    mb = torch.tensor(sizes, dtype=torch.int32)
    for width in sorted({max(hs), max(hs) + 3}):
        own = ref.randint_rows_ref(keys, hcap, mb, width)
        given = ref.randint_rows_ref(keys, hcap, mb, width,
                                     ref.h_groups(hcap, mb))
        assert torch.equal(given, own)


def test_plain_version_counts_no_kernel_tick_under_a_profiler():
    keys = _keys((4,), 18)
    hcap = torch.full((4,), 8, dtype=torch.int32)
    mb = torch.full((4,), 16, dtype=torch.int32)
    instrument.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert instrument.tracing()
            kernel.randint_rows(keys, hcap, mb, 8)
        assert "draw.kernel_ticks" not in instrument.snapshot()["counts"]
    finally:
        instrument.reset()


def test_plain_version_launches_nothing_on_the_cpu():
    keys = _keys((2, 5), 13)
    hcap = torch.tensor([7, 3, 7, 0, 7], dtype=torch.int32)
    mb = torch.tensor([5, 1, 70001, 9, 0], dtype=torch.int32)
    before = kernel.LAUNCHES
    got = kernel.randint_rows(keys, hcap, mb, 9)
    assert kernel.LAUNCHES == before
    assert got.shape == (2, 5, 9)
    for li in range(5):
        h = int(hcap[li])
        want = prng.randint(keys[:, li], (h,), 0, int(mb[li]))
        assert torch.equal(got[:, li, :h], want)
        assert (got[:, li, h:] == 0).all()
    assert (got[:, 1, :3] == 0).all()           # m_b = 1: every draw 0
    assert (got[:, 4, :7] == 0).all()           # m_b <= 0: a span of 1


@pytest.mark.parametrize("case", ["int32 keys", "keys not contiguous",
                                  "not (..., n, 2)", "int64 hcap",
                                  "hcap of another length",
                                  "negative width"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    keys = _keys((4,), 14)
    hcap = torch.full((4,), 8, dtype=torch.int32)
    mb = torch.full((4,), 16, dtype=torch.int32)
    width = 8
    if case == "int32 keys":
        keys = keys.to(torch.int32)
    elif case == "keys not contiguous":
        keys = _keys((4, 2), 14)[:, 0, :]        # (4, 2), rows 4 apart
        assert not keys.is_contiguous()
    elif case == "not (..., n, 2)":
        keys = _keys((4,), 14).reshape(8)
    elif case == "int64 hcap":
        hcap = hcap.to(torch.int64)
    elif case == "hcap of another length":
        hcap = hcap[:3].contiguous()
    else:
        width = -1
    error = TypeError if case in ("int32 keys", "int64 hcap") else ValueError
    with pytest.raises(error):
        kernel.randint_rows(keys, hcap, mb, width)


# (configs, leaves, H, m_b): the epsilon cells' and the covtype cell's
# ticks (H = 16 m_b) and grid8's B = 8 tick
CELL_SHAPES = {
    "epsilon solve": (1, 128, 50_000, 3_125),
    "covtype solve": (1, 128, 72_624, 4_539),
    "epsilon grid8": (8, 128, 50_000, 3_125),
}


@pytest.mark.parametrize("cell,bound_ms", [
    ("epsilon solve", 0.0325), ("covtype solve", 0.0472),
    ("epsilon grid8", 0.2602)])
def test_cost_gives_the_kernel_tables_bounds(cell, bound_ms):
    B, n, H, _ = CELL_SHAPES[cell]
    ops, nbytes = kernel.cost(B * n, B * n * H, H)
    assert ops == kernel.OPS_PER_DRAW * B * n * H
    assert nbytes == B * n * (24 + 4 * H)
    t_ops, t_bytes = ops / hw.PEAK_INT32_OPS, nbytes / hw.HBM_BW
    assert t_ops > t_bytes                       # bound by operations
    assert round(t_ops * 1e3, 4) == bound_ms


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_kernel_equals_randint_at_the_cells_shapes(cell, cuda_device):
    B, n, H, m_b = CELL_SHAPES[cell]
    keys = _keys((B, n), 20, cuda_device)
    hcap = torch.full((n,), H, dtype=torch.int32, device=cuda_device)
    mb = torch.full((n,), m_b, dtype=torch.int32, device=cuda_device)
    before = kernel.LAUNCHES
    got = kernel.randint_rows(keys, hcap, mb, H)
    assert kernel.LAUNCHES == before + 1
    want = prng.randint(keys, (H,), 0, mb.expand(B, n))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, n, H)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (3,)])
def test_kernel_draws_several_h_groups_in_one_launch(lead, cuda_device):
    hs, sizes = PLANS["several H"]
    keys = _keys(lead + (4,), 21)
    want = _executor(hs, sizes).draw_idx(keys)
    ex = _executor(hs, sizes, device=cuda_device)
    before = kernel.LAUNCHES
    got = ex.draw_idx(keys.to(cuda_device))
    assert kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)
    for li, h in enumerate(hs):
        assert (got[..., li, h:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m_b", [1, 65_537, 70_001, 3_000_017,
                                 2 ** 31 - 1])
def test_kernel_equals_randint_for_any_block_size(m_b, cuda_device):
    keys = _keys((2, 64), 22, cuda_device)
    hcap = torch.full((64,), 3_000, dtype=torch.int32, device=cuda_device)
    mb = torch.full((64,), m_b, dtype=torch.int32, device=cuda_device)
    got = kernel.randint_rows(keys, hcap, mb, 3_000)
    want = prng.randint(keys, (3_000,), 0, mb.expand(2, 64))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if m_b == 1:
        assert (got == 0).all()


@pytest.mark.cuda
def test_kernel_refuses_keys_on_another_device_and_never_falls_back(
        cuda_device):
    keys = _keys((4,), 23, cuda_device)
    hcap = torch.full((4,), 8, dtype=torch.int32)        # on the CPU
    mb = torch.full((4,), 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="expected"):
        kernel.randint_rows(keys, hcap, mb, 8)
    with pytest.raises(TypeError):
        kernel.randint_rows(keys.to(torch.int32), hcap.to(cuda_device), mb,
                            8)


@pytest.mark.cuda
def test_each_launch_and_nothing_else_counts_a_kernel_tick(cuda_device):
    keys = _keys((4,), 24, cuda_device)
    hcap = torch.full((4,), 8, dtype=torch.int32, device=cuda_device)
    mb = torch.full((4,), 16, dtype=torch.int32, device=cuda_device)
    kernel.randint_rows(keys, hcap, mb, 8)      # built before the window
    instrument.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            before = kernel.LAUNCHES
            kernel.randint_rows(keys, hcap, mb, 8)
            kernel.randint_rows(keys[None].contiguous(), hcap, mb, 8)
            empty = kernel.randint_rows(keys, hcap, mb, 0)   # no launch
            assert empty.shape == (4, 0)
            assert kernel.LAUNCHES == before + 2
        assert instrument.snapshot()["counts"]["draw.kernel_ticks"] == 2
    finally:
        instrument.reset()
