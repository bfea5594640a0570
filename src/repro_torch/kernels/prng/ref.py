"""The plain version of the tick's coordinate draws: ``core/prng.py::
randint`` once per distinct H, each leaf's draws in its own columns."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import prng

Tensor = torch.Tensor

Groups = List[Tuple[int, Tensor, Tensor]]


def h_groups(hcap: Tensor, maxval: Tensor) -> Groups:
    """The leaves grouped by H, in increasing H: ``(h, rows, maxval[rows])``
    each, what :func:`randint_rows_ref` draws by.  A caller that draws the
    same leaves every tick builds this once and passes it in."""
    groups = []
    for h in sorted({int(v) for v in hcap.tolist()}):
        rows = torch.nonzero(hcap == h).squeeze(1)
        groups.append((h, rows, maxval[rows]))
    return groups


def randint_rows_ref(keys: Tensor, hcap: Tensor, maxval: Tensor,
                     width: int, groups: Optional[Groups] = None) -> Tensor:
    """``randint(keys[..., l, :], (hcap[l],), 0, maxval[l])`` for every
    leaf l of (..., n, 2) keys, as (..., n, width) int32 with columns from
    ``hcap[l]`` on 0.  The leaves that share an H draw together, exactly
    the randint shape the legacy recursion draws for each (the draw has no
    prefix property), and one H as wide as the output is returned as
    randint gives it.  ``groups`` is ``h_groups(hcap, maxval)``, built
    here when not given."""
    lead = tuple(keys.shape[:-2])
    if groups is None:
        groups = h_groups(hcap, maxval)
    if len(groups) == 1 and groups[0][0] == width:
        return prng.randint(keys, (width,), 0,
                            maxval.expand(lead + tuple(maxval.shape)))
    idx = torch.zeros(lead + (keys.shape[-2], width), dtype=torch.int32,
                      device=keys.device)
    for h, rows, mb in groups:
        idx[..., rows, :h] = prng.randint(
            keys[..., rows, :], (h,), 0, mb.expand(lead + tuple(mb.shape)))
    return idx
