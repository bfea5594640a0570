"""The pure-Python parts of the port's kernel wrappers, without a card: the
flash-attention kernel each (dtype, head dim) goes to, and the shared
memory the sdca_block wrapper reckons for a leaf (the row ring, w, alpha,
y, xsq and the ring's mbarriers) with its refusal above a limit passed in.
The card tests (tests/test_torch_cuda*.py) hold the kernels' own
reckoning to these numbers."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dual  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.sdca import kernel as sk  # noqa: E402

H100_OPTIN = 232_448   # bytes of shared memory a block may opt in to


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
