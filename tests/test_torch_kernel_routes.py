"""The pure-Python parts of the port's kernel wrappers, without a card: the
flash-attention kernel each (dtype, head dim) goes to; the shared memory
the sdca_block wrapper reckons for a leaf (the row ring, w, alpha, y, xsq
and the ring's mbarriers) with its refusal above a limit passed in, and
the batched launch's layout and checks of its config axis (and its CPU
route, the plain version config by config); and
the RG-LRU scan's route (TMA or cp.async copies, by W and alignment), its
time ring and its shared memory.  The card tests
(tests/test_torch_cuda*.py) hold the kernels' own reckoning to these
numbers."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dual  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.rglru import kernel as rg  # noqa: E402
from repro_torch.kernels.sdca import kernel as sk  # noqa: E402

H100_OPTIN = 232_448   # bytes of shared memory a block may opt in to
H100_SMS = 132
H100_SM_SMEM = 233_472  # bytes of shared memory an SM holds for its blocks


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "f32")])
def test_flash_route_is_chosen_by_dtype_alone(dtype, want, D):
    assert fa.route(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_flash_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.route(dtype, 64)


@pytest.mark.parametrize("D", [8, 32, 96, 512])
def test_flash_route_refuses_head_dims_not_compiled(D):
    with pytest.raises(ValueError, match="compiled"):
        fa.route(torch.bfloat16, D)


def test_flash_cpu_tensors_count_no_route():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    before = (fa.LAUNCHES, dict(fa.LAUNCHES_BY_ROUTE))
    fa.flash_attention_kernel(q, q[:, :, :1].contiguous(),
                              q[:, :, :1].contiguous())
    assert (fa.LAUNCHES, fa.LAUNCHES_BY_ROUTE) == before


@pytest.mark.parametrize("d,depth", [(1, 16), (13, 16), (128, 16),
                                     (512, 16), (600, 12), (1000, 8),
                                     (2048, 4), (4096, 4), (65536, 4)])
def test_sdca_ring_depth(d, depth):
    """32 KiB of rows in flight in whole groups of 4, at least 4 and at
    most 16."""
    assert sk.ring_depth(d) == depth


@pytest.mark.parametrize("m_b,d,want", [
    # 16 rows of 512 + w (512) + 3 x 8192, then 2 mbarriers a group of 4
    (8192, 512, 4 * (16 * 512 + 512 + 3 * 8192) + 16 * 4),
    (512, 256, 4 * (17 * 256 + 3 * 512) + 16 * 4),
    # 17 x 13 + 3 x 63 = 410 floats, even
    (63, 13, 4 * 410 + 16 * 4),
    # 17 x 13 + 3 x 64 = 413 floats, padded to 414 for the barriers
    (64, 13, 4 * 414 + 16 * 4),
    (32, 2048, 4 * (5 * 2048 + 3 * 32) + 16 * 1),
])
def test_sdca_smem_bytes(m_b, d, want):
    assert sk.smem_bytes(m_b, d) == want


def test_sdca_main_path_leaf_fits_an_h100_block():
    # the main path's leaf (m_b = 8192, d = 512): 133,184 B of 232,448
    assert sk.check_smem(8192, 512, H100_OPTIN) == 133_184


@pytest.mark.parametrize("m_b,d", [(60_000, 4), (19_000, 512),
                                   (8192, 40_000)])
def test_sdca_check_smem_refuses_a_leaf_above_the_limit(m_b, d):
    with pytest.raises(ValueError, match="shared memory"):
        sk.check_smem(m_b, d, H100_OPTIN)


def test_sdca_check_smem_takes_the_limit_it_is_given():
    need = sk.smem_bytes(1024, 64)
    assert sk.check_smem(1024, 64, need) == need
    with pytest.raises(ValueError, match=f"{need} B exceeds the {need - 8}"):
        sk.check_smem(1024, 64, need - 8)


def test_sdca_cpu_tensors_run_the_plain_version():
    X = torch.randn(2, 8, 12)
    y, alpha = torch.randn(2, 8), torch.zeros(2, 8)
    idx = torch.randint(0, 8, (2, 5), dtype=torch.int32)
    before = sk.LAUNCHES
    da, dw = sk.sdca_block_kernel(X, y, alpha, torch.zeros(12), idx,
                                  loss=dual.squared, lm=1.6)
    assert sk.LAUNCHES == before
    assert da.shape == (2, 8) and dw.shape == (2, 12)


def _batched_operands(B=3, K=2, m_b=8, d=12, H=5, per_leaf=False):
    g = torch.Generator().manual_seed(0)
    X = torch.randn(K, m_b, d, generator=g)
    y = torch.randn(K, m_b, generator=g)
    alpha = 0.1 * torch.randn(B, K, m_b, generator=g)
    w = 0.1 * torch.randn(*((B, K, d) if per_leaf else (B, d)), generator=g)
    lms = [1.6 * (b + 1) for b in range(B)]
    xsq = torch.stack([torch.sum(X * X, dim=2) / v for v in lms])
    idx = torch.randint(0, m_b, (B, K, H), generator=g, dtype=torch.int32)
    mask = (torch.rand(B, K, H, generator=g) < 0.7).float()
    return X, y, alpha, w, xsq, idx, lms, mask


@pytest.mark.parametrize("per_leaf", [False, True])
def test_sdca_batched_layout_of_the_config_axis(per_leaf):
    """B configs over shared X and y: w one row a config (config stride
    d, leaf stride 0) or one a leaf (K d and d)."""
    X, y, alpha, w, xsq, idx, lms, mask = _batched_operands(
        per_leaf=per_leaf)
    got = sk.batched_layout(X, y, alpha, w, xsq, idx, sk.lm_array(lms, "cpu"),
                            mask)
    assert got == (3, 2, 8, 12, 5, 12 if per_leaf else 0,
                   24 if per_leaf else 12)


@pytest.mark.parametrize("case,error,match", [
    ("X 2-D", ValueError, "X must be"),
    ("alpha of another B", ValueError, "xsq must have shape"),
    ("w of another B", ValueError, "w must have shape"),
    ("idx int64", TypeError, "idx must be torch.int32"),
    ("lm of another B", ValueError, "lm must have shape"),
    ("mask of another H", ValueError, "step_mask must have shape"),
    ("alpha not contiguous", ValueError, "alpha must be contiguous"),
    ("y float64", TypeError, "y must be torch.float32"),
    ("no config", ValueError, "B >= 1 configs"),
])
def test_sdca_batched_wrapper_refuses_what_the_kernel_does_not_take(
        case, error, match):
    X, y, alpha, w, xsq, idx, lms, mask = _batched_operands()
    if case == "X 2-D":
        X = X[0]
    elif case == "alpha of another B":
        alpha = alpha[:2]
    elif case == "w of another B":
        w = w[:2]
    elif case == "idx int64":
        idx = idx.long()
    elif case == "lm of another B":
        lms = lms[:2]
    elif case == "mask of another H":
        mask = mask[..., :4]
    elif case == "alpha not contiguous":
        alpha = alpha.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "y float64":
        y = y.double()
    elif case == "no config":
        alpha, w, xsq, idx, mask = (t[:0] for t in (alpha, w, xsq, idx,
                                                     mask))
        lms = []
    with pytest.raises(error, match=match):
        sk.sdca_block_launch_batched(X, y, alpha, w, xsq, idx,
                                     loss=dual.squared, lms=lms,
                                     step_mask=mask)


@pytest.mark.parametrize("per_leaf", [False, True])
def test_sdca_batched_cpu_tensors_run_the_plain_version_config_by_config(
        per_leaf):
    from repro_torch.kernels.sdca.ref import sdca_steps_ref
    X, y, alpha, w, xsq, idx, lms, mask = _batched_operands(
        per_leaf=per_leaf)
    before = (sk.LAUNCHES, sk.LEAVES)
    da, dw = sk.sdca_block_launch_batched(X, y, alpha, w, xsq, idx,
                                          loss=dual.squared, lms=lms,
                                          step_mask=mask)
    assert (sk.LAUNCHES, sk.LEAVES) == before
    assert da.shape == (3, 2, 8) and dw.shape == (3, 2, 12)
    for b in range(3):
        one = sdca_steps_ref(X, y, alpha[b], w[b], xsq[b], idx[b],
                             loss=dual.squared, lm=lms[b],
                             step_mask=mask[b])
        assert torch.equal(da[b], one[0]) and torch.equal(dw[b], one[1])


def test_sdca_lm_array_takes_floats_sequences_and_tensors():
    assert torch.equal(sk.lm_array(1.5, "cpu"), torch.tensor([1.5]))
    assert torch.equal(sk.lm_array([1.5, 2.5], "cpu"),
                       torch.tensor([1.5, 2.5]))
    t = sk.lm_array(torch.tensor([[3.0, 4.0]], dtype=torch.float64), "cpu")
    assert t.dtype == torch.float32 and t.shape == (2,)


def _views(W, a_offset, b_offset, B=2, S=3):
    """a and b of shape (B, S, W), contiguous views a_offset and b_offset
    floats into buffers that start 64-byte aligned (torch's CPU
    allocator)."""
    n = B * S * W
    bufs = [torch.zeros(n + off) for off in (a_offset, b_offset)]
    assert all(t.data_ptr() % 16 == 0 for t in bufs)
    a, b = (t[off:].view(B, S, W) for t, off in zip(bufs, (a_offset,
                                                            b_offset)))
    assert a.is_contiguous() and b.is_contiguous()
    return a, b


@pytest.mark.parametrize("W,a_offset,b_offset,want", [
    (2560, 0, 0, "tma"),        # the serving shape
    (32, 0, 0, "tma"),
    (40, 0, 0, "tma"),          # a tail block: the copies' zero fill
    (4, 0, 0, "tma"),
    (6, 0, 0, "cp_async"),      # rows of 24 B: not a multiple of 16
    (2562, 0, 0, "cp_async"),
    (1, 0, 0, "cp_async"),
    (2560, 1, 0, "cp_async"),   # a 4 bytes past a 16-byte boundary
    (32, 0, 2, "cp_async"),     # b 8 bytes past one
    (32, 4, 8, "tma"),          # views on 16-byte boundaries
])
def test_rglru_route_by_row_bytes_and_alignment(W, a_offset, b_offset, want):
    a, b = _views(W, a_offset, b_offset)
    assert rg.route(a, b) == want


def test_rglru_ring_stages_of_32_time_steps():
    """Two stages, each 32 time steps x 64 channels of a and of b: 32 KiB
    of reads a block."""
    assert (rg.CONSUMERS, rg.STAGE_ROWS, rg.RING_STAGES) == (2, 32, 2)
    assert rg.ring_bytes() == 2 * 2 * 32 * 64 * 4 == 32_768


def test_rglru_ring_keeps_enough_reads_in_flight_at_the_serving_shape():
    """B=4, W=2560 in blocks of 64 channels of a batch row: 160 blocks
    cover all 132 SMs, all resident at once, so every SM holds at least
    one block's ring, at least 24 KiB of reads in flight (~2.3 MB over the
    card at ~0.7 us of DRAM latency)."""
    blocks = 4 * 2560 // (32 * rg.CONSUMERS)
    assert blocks == 160 and blocks >= H100_SMS
    fit = H100_SM_SMEM // (rg.smem_bytes() + 1024)   # 1 KiB reserved a block
    assert fit * H100_SMS >= blocks
    assert rg.ring_bytes() >= 24 * 1024
    assert blocks * rg.ring_bytes() >= 2.3e6


def test_rglru_smem_bytes():
    # alignment slack, the ring, a full and an empty mbarrier a stage
    assert rg.smem_bytes() == 128 + 32_768 + 2 * 16 == 32_928


def test_rglru_check_smem_takes_the_limit_it_is_given():
    need = rg.smem_bytes()
    assert rg.check_smem(need) == need
    assert rg.check_smem(H100_OPTIN) == need
    with pytest.raises(ValueError, match=f"{need} B exceeds the {need - 1}"):
        rg.check_smem(need - 1)


def test_rglru_cpu_tensors_run_the_plain_version():
    a, b = _views(8, 0, 0, B=2, S=5)
    a += 0.5
    b += 1.0
    before = (rg.LAUNCHES, dict(rg.LAUNCHES_BY_ROUTE))
    h, h_last = rg.rglru_scan_kernel(a, b, torch.zeros(2, 8))
    assert (rg.LAUNCHES, rg.LAUNCHES_BY_ROUTE) == before
    assert torch.equal(h_last, h[:, -1])
    assert torch.equal(h[:, 0], torch.ones(2, 8))
