"""The frozen least-work formulas and peaks give the hand-computed
bounds: 0.973 ms for an epsilon-svm-tree128 launch (128 leaves x 3,125
rows x 2,000 features, 50,000 steps), 0.046 ms for a covtype one (128 x
4,539 x 54, 18,156 steps) and 0.062 ms at the cell's 72,624 steps, all
bounded by bytes."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.costs import h100, sdca_block  # noqa: E402


@pytest.mark.parametrize("K,m_b,d,H,ms", [
    (128, 3125, 2000, 50000, 0.973),
    (128, 4539, 54, 18156, 0.046),
    (128, 4539, 54, 72624, 0.062),
])
def test_launch_bound_by_hand(K, m_b, d, H, ms):
    flops, nbytes = sdca_block.cost(K * m_b, 1, K, m_b, d, H)
    assert nbytes / h100.HBM_BW > flops / h100.PEAK_FLOPS_F32
    assert round(h100.least_seconds(flops, nbytes) * 1e3, 3) == ms


def test_cost_counts_each_part_once():
    flops, nbytes = sdca_block.cost(10, 2, 3, 5, 7, 11)
    assert flops == 4 * 2 * 3 * 11 * 7
    assert nbytes == 10 * 7 * 4 + 3 * 5 * 4 + 2 * 3 * (3 * 5 + 2 * 7) * 4 \
        + 2 * 3 * 11 * 8


def test_expected_rows():
    assert sdca_block.expected_rows(4, 100, 0) == 0
    assert sdca_block.expected_rows(4, 1, 3) == 4
    # H = 16 m_b draws name every row but a share of e^-16
    assert sdca_block.expected_rows(128, 3125, 50000) == \
        pytest.approx(128 * 3125, rel=1e-6)
    assert sdca_block.expected_rows(128, 4539, 18156) == \
        pytest.approx(128 * 4539 * (1 - (1 - 1 / 4539) ** 18156))


def test_least_seconds_of_a_shape():
    shape = {"B": 1, "K": 128, "m_b": 3125, "d": 2000, "H": 50000,
             "draws": 50000}
    assert sdca_block.least_seconds(shape) * 1e3 == pytest.approx(0.973,
                                                                  abs=5e-4)
