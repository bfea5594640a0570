"""The one generator of the benchmark's inputs: a dataset of the shape a
configuration states, made from the seed on the device with a
``torch.Generator`` there, in a few large calls.

A configuration holds ``rows``, ``columns`` (groups left to right: ``gaussian``
columns, standardized to mean 0 and variance 1 when ``standardize``, or
``onehot`` groups with exactly one 1 a row), ``row_norm`` (``"unit"``
scales every row to L2 norm 1) and ``labels``: ``planted`` labels +-1 are
the sign of the scores of a planted separator ``scale * X @ w*`` (w*
standard normal), after ``logistic`` noise or before a ``flip`` of each
label with probability ``flip``, thresholded at ``zero`` or at the
``median`` (half and half).  With ``"separator": "fixed_sizes"`` every
seed plants a separator of the same sizes, in another order: w*'s part
on a ``gaussian`` group is a direction drawn from the seed at norm
sqrt(count), on a ``onehot`` group the standardized evenly spaced values
of [-1, 1] in an order drawn from the seed -- so that the seed changes
which problem is solved, not how hard it is.  The same seed gives the
same inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def make(config: dict, seed: int, device) -> Tuple[Tensor, Tensor]:
    """(X (rows, d) float32, y (rows,) float32 of +-1) from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    m = int(config["rows"])
    d = sum(int(c["count"]) for c in config["columns"])
    X = torch.empty((m, d), dtype=torch.float32, device=dev)
    off = 0
    for col in config["columns"]:
        k = int(col["count"])
        part = X.narrow(1, off, k)
        if col["kind"] == "gaussian":
            part.normal_(generator=g)
            if col.get("standardize"):
                mean = part.mean(dim=0)
                std = part.std(dim=0, unbiased=False)
                part.sub_(mean).div_(std)
        elif col["kind"] == "onehot":
            hot = torch.randint(0, k, (m, 1), generator=g, device=dev)
            part.zero_().scatter_(1, hot, 1.0)
        else:
            raise ValueError(f"unknown column kind {col['kind']!r}")
        off += k
    if config.get("row_norm") == "unit":
        X.div_(torch.linalg.vector_norm(X, dim=1, keepdim=True))
    return X, labels(config["labels"], X, g, config["columns"])


def separator(spec: dict, columns: list, g: torch.Generator,
              device) -> Tensor:
    """The planted w* (d,) of a ``planted`` label spec."""
    d = sum(int(c["count"]) for c in columns)
    w_star = torch.randn(d, generator=g, device=device)
    kind = spec.get("separator", "normal")
    if kind == "normal":
        return w_star
    if kind != "fixed_sizes":
        raise ValueError(f"unknown separator {kind!r}")
    off = 0
    for col in columns:
        k = int(col["count"])
        part = w_star.narrow(0, off, k)
        if col["kind"] == "onehot" and k > 1:
            vals = torch.linspace(-1.0, 1.0, k, device=device)
            vals = (vals - vals.mean()) / vals.std(unbiased=False)
            part.copy_(vals[torch.randperm(k, generator=g, device=device)])
        else:
            part.mul_(k ** 0.5 / torch.linalg.vector_norm(part))
        off += k
    return w_star


def labels(spec: dict, X: Tensor, g: torch.Generator,
           columns: list) -> Tensor:
    if spec["kind"] != "planted":
        raise ValueError(f"unknown label kind {spec['kind']!r}")
    m, d = X.shape
    w_star = separator(spec, columns, g, X.device)
    z = float(spec.get("scale", 1.0)) * (X @ w_star)
    if spec.get("noise") == "logistic":
        u = torch.rand(m, generator=g, device=X.device).clamp_(1e-7, 1 - 1e-7)
        z = z + torch.log(u) - torch.log1p(-u)
    cut = torch.median(z) if spec.get("threshold") == "median" else 0.0
    y = torch.where(z > cut, 1.0, -1.0)
    flip = float(spec.get("flip", 0.0))
    if flip > 0:
        y = torch.where(torch.rand(m, generator=g, device=X.device) < flip,
                        -y, y)
    return y.to(torch.float32).contiguous()
