"""The inputs' generator: the same seed gives the same inputs, and a
``fixed_sizes`` separator plants the same sizes on every seed, in another
order, so that the seed changes which problem is solved and not how hard
it is."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import data  # noqa: E402

COLUMNS = [{"kind": "gaussian", "count": 10, "standardize": True},
           {"kind": "onehot", "count": 4}, {"kind": "onehot", "count": 40}]
CONFIG = {"rows": 512, "columns": COLUMNS, "row_norm": None,
          "labels": {"kind": "planted", "threshold": "median",
                     "noise": "logistic", "scale": 0.3,
                     "separator": "fixed_sizes"}}


def _w(seed: int, spec=CONFIG["labels"]):
    g = torch.Generator().manual_seed(seed)
    return data.separator(spec, COLUMNS, g, "cpu")


def test_same_seed_same_inputs():
    X1, y1 = data.make(CONFIG, 2 ** 31 + 77, "cpu")
    X2, y2 = data.make(CONFIG, 2 ** 31 + 77, "cpu")
    assert torch.equal(X1, X2) and torch.equal(y1, y2)
    assert int((y1 > 0).sum()) == 256          # half and half
    assert torch.equal(X1[:, 10:14].sum(1), torch.ones(512))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 32 + 9])
def test_fixed_sizes_separator_is_the_same_sizes_on_every_seed(seed):
    base, w = _w(0), _w(seed)
    assert not torch.equal(base, w)
    assert torch.linalg.vector_norm(w[:10]) == pytest.approx(10 ** 0.5)
    for lo, hi in ((10, 14), (14, 54)):
        assert torch.allclose(w[lo:hi].sort().values,
                              base[lo:hi].sort().values)
        assert float(w[lo:hi].mean()) == pytest.approx(0.0, abs=1e-6)
        assert float(w[lo:hi].std(unbiased=False)) == pytest.approx(1.0)


def test_normal_separator_is_a_plain_draw():
    spec = dict(CONFIG["labels"], separator="normal")
    g = torch.Generator().manual_seed(3)
    want = torch.randn(54, generator=g)
    assert torch.equal(_w(3, spec), want)
