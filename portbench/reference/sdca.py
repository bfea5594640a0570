"""Tree-network SDCA (the paper's Algorithms 1-3) in plain PyTorch: the
reference the benchmark holds the port's solves against.

``tree_solve`` runs the recursion of Algorithm 2 over a level-homogeneous
tree (``fanouts`` children per node at each depth, top-down) from alpha =
0, w = 0 for ``rounds`` root rounds, for B members at once (a member is a
lambda, a root key and the local steps it runs):

    for t = 1..rounds (at the root; ``level_rounds[k-1]`` at depth k):
        every child solves from the node's (alpha, w), in parallel
        alpha[child] += delta_alpha / K;  w += sum_k delta_w_k / K

and a leaf runs Procedure P: H sequential exact maximizations of the dual
over coordinates ``randint(leaf_key, (h_cap,), 0, m_b)`` (the first ``h``
of them when a member runs fewer), the keys threaded as the legacy
recursion threads them (``key, *children = split(key, 1 + K)`` each round
of each node).  Every node of a depth runs in step with the others, so a
depth's solves are one batch over its nodes and the members; the leaves'
chains advance one coordinate step at a time for all of them.  It works
out again everything the port derives -- the blocked layout, the draws,
the combinations -- from the inputs alone.

The closed forms are the paper's (squared, hinge); the logistic step is
solved by Newton's method on the logit of u = (alpha + d) y, a different
route to the same scalar argmax than the port's.  On a CUDA device each
chunk of steps is replayed as a CUDA graph of the same operations, which
changes no value.  ``dtype`` is the precision the reference computes in:
float64 for the check, bfloat16 for its control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from portbench.reference import threefry

Tensor = torch.Tensor

NEWTON_STEPS = 5          # from the linearized start
NEWTON_TOL = 1e-4         # the largest |h| a float64 run may leave before
                          # its last Newton step (then off by < 1e-8)
CHUNK = 256               # steps per replayed CUDA graph


# ---------------------------------------------------------------------------
# losses: the scalar step, the loss and its conjugate
# ---------------------------------------------------------------------------
def _step_squared(wx, a, y, xsq, res):
    return (y - wx - a) / (1.0 + xsq)


def _step_hinge(wx, a, y, xsq, res):
    q = torch.addcmul(a * y, 1.0 - y * wx, 1.0 / torch.clamp(xsq, min=1e-12))
    return y * torch.clamp(q, 0.0, 1.0) - a


def _step_logistic(wx, a, y, xsq, res):
    # the argmax over u = (a + d) y in (0, 1) solves, with v = logit(u),
    # h(v) = v + xsq * sigmoid(v) + y * (wx - xsq * a) = 0; h' >= 1, and
    # Newton's steps from the root of h's linearization at 0 converge
    c = y * torch.addcmul(wx, xsq, a, value=-1.0)
    v = torch.add(c, xsq, alpha=0.5).div_(torch.add(xsq, 4.0)).mul_(-4.0)
    for _ in range(NEWTON_STEPS):
        s = torch.sigmoid(v)
        h = torch.addcmul(v + c, xsq, s)
        dh = torch.addcmul(s, s, s, value=-1.0).mul_(xsq).add_(1.0)
        v = torch.addcdiv(v, h, dh, value=-1.0)
    if res is not None:
        torch.maximum(res, h.abs().amax(), out=res)
    return torch.sigmoid(v).mul_(y).sub_(a)


STEPS = {"squared": _step_squared, "hinge": _step_hinge,
         "logistic": _step_logistic}


def loss_value(loss: str, margin: Tensor, y: Tensor) -> Tensor:
    if loss == "squared":
        return 0.5 * (margin - y) ** 2
    if loss == "hinge":
        return torch.clamp(1.0 - y * margin, min=0.0)
    if loss == "logistic":
        return torch.nn.functional.softplus(-y * margin)
    raise KeyError(loss)


def conj_neg(loss: str, alpha: Tensor, y: Tensor) -> Tensor:
    """l*(-alpha), the term of the dual."""
    if loss == "squared":
        return 0.5 * alpha ** 2 - alpha * y
    if loss == "hinge":
        return -alpha * y
    if loss == "logistic":
        u = torch.clamp(alpha * y, 0.0, 1.0)
        return torch.special.xlogy(u, u) + torch.special.xlogy(1.0 - u,
                                                               1.0 - u)
    raise KeyError(loss)


def gap(loss: str, Xc: Tensor, y: Tensor, alpha: Tensor, lam: float
        ) -> float:
    """The duality gap P(w(alpha)) - D(alpha), w(alpha) = X^T alpha /
    (lam m), as a host float."""
    m = Xc.shape[0]
    w = (Xc.T @ alpha) / (lam * m)
    reg = 0.5 * lam * torch.dot(w, w)
    primal = reg + torch.mean(loss_value(loss, Xc @ w, y))
    dual = -reg - torch.mean(conj_neg(loss, alpha, y))
    return float(primal - dual)


# ---------------------------------------------------------------------------
# the leaves' chains
# ---------------------------------------------------------------------------
class _Chain:
    """The sequential coordinate steps of BN leaf chains over shared rows
    ``Xc``: ``a`` (flat duals of every member) and ``w`` (BN, d) advance
    in place.  A step reads its operands from row ``h`` of (G, BN) buffers;
    on a CUDA device G = CHUNK steps are captured once as a graph and
    replayed per chunk, on the CPU they run as they are."""

    def __init__(self, Xc: Tensor, a: Tensor, w: Tensor, inv_lm: Tensor,
                 loss: str, check: bool):
        self.Xc, self.a, self.w, self.inv_lm = Xc, a, w, inv_lm
        self.step_fn = STEPS[loss]
        self.dev = Xc.device
        BN, dt = w.shape[0], Xc.dtype
        self.G = CHUNK if self.dev.type == "cuda" else 1
        z = lambda dtype: torch.zeros((self.G, BN), dtype=dtype,
                                      device=self.dev)
        self.gi, self.ai = z(torch.int64), z(torch.int64)
        self.ys, self.xs, self.mk = z(dt), z(dt), z(dt)
        self.res = (torch.zeros((), dtype=dt, device=self.dev)
                    if check and loss == "logistic" else None)
        self.graph = None
        if self.dev.type == "cuda":
            # the buffers are all zeros, so the warm-up steps are masked
            # off and change no state
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()
            if self.res is not None:
                self.res.zero_()

    def _body(self):
        for h in range(self.G):
            x = self.Xc.index_select(0, self.gi[h])
            wx = torch.bmm(self.w.unsqueeze(1), x.unsqueeze(2)).view(-1)
            a = self.a.index_select(0, self.ai[h])
            d = self.step_fn(wx, a, self.ys[h], self.xs[h], self.res) \
                * self.mk[h]
            self.a.index_add_(0, self.ai[h], d)
            self.w.addcmul_(x, (d * self.inv_lm).unsqueeze(1))

    def run(self, gi: Tensor, ai: Tensor, ys: Tensor, xs: Tensor,
            mk: Tensor) -> None:
        """Every step of (H, BN) operand arrays, H a multiple of G."""
        for c in range(0, gi.shape[0], self.G):
            sl = slice(c, c + self.G)
            self.gi.copy_(gi[sl])
            self.ai.copy_(ai[sl])
            self.ys.copy_(ys[sl])
            self.xs.copy_(xs[sl])
            self.mk.copy_(mk[sl])
            if self.graph is not None:
                self.graph.replay()
            else:
                self._body()


# ---------------------------------------------------------------------------
# the recursion
# ---------------------------------------------------------------------------
class _Tree:
    def __init__(self, Xc, y, sqn, loss, fanouts, level_rounds, h_cap,
                 lams, hs, check):
        self.Xc, self.y, self.sqn, self.loss = Xc, y, sqn, loss
        self.fanouts, self.level_rounds = list(fanouts), list(level_rounds)
        self.h_cap = int(h_cap)
        self.n = math.prod(self.fanouts)
        self.m, self.d = Xc.shape
        self.m_b = self.m // self.n
        self.B = len(lams)
        dev, dt = Xc.device, Xc.dtype
        self.lms = torch.tensor([lam * self.m for lam in lams],
                                dtype=torch.float64, device=dev)
        self.hs = torch.tensor(hs, dtype=torch.int64, device=dev)
        self.check = check
        self.dt = dt

    def solve(self, depth: int, keys: Tensor, alpha: Tensor,
              w: Tensor):
        """(delta alpha (B, m), delta w (B, N, d)) of the N nodes of
        ``depth`` from keys (B, N, 2), the duals (B, m) and each node's w
        (B, N, d)."""
        if depth == len(self.fanouts):
            return self.leaves(keys, alpha, w)
        K = self.fanouts[depth]
        B, N = keys.shape[:2]
        a, wn = alpha.clone(), w.clone()
        for _ in range(self.level_rounds[depth - 1]):
            ks = threefry.split(keys, 1 + K)
            keys = ks[:, :, 0]
            da, dw = self.solve(depth + 1, ks[:, :, 1:].reshape(B, N * K, 2),
                                a, wn.repeat_interleave(K, dim=1))
            a = a + da / K
            wn = wn + dw.view(B, N, K, -1).sum(2) / K
        return a - alpha, wn - w

    def leaves(self, keys: Tensor, alpha: Tensor, w: Tensor):
        B, n, H = self.B, self.n, self.h_cap
        dev = keys.device
        m, m_b, d = self.m, self.m_b, self.d
        idx = threefry.randint(keys, (H,), m_b)               # (B, n, H)
        rows = idx + (torch.arange(n, device=dev) * m_b)[None, :, None]
        flat = rows + (torch.arange(B, device=dev) * m)[:, None, None]
        step = torch.arange(H, device=dev)
        mask = (step[None, None, :] < self.hs[:, None, None]).expand(B, n, H)
        inv_lm = (1.0 / self.lms).to(self.dt)
        xsq = self.sqn[rows] / self.lms[:, None, None]
        G = CHUNK if dev.type == "cuda" else 1
        pad = (-H) % G

        def steps_first(t: Tensor, dtype) -> Tensor:
            t = t.reshape(B * n, H).T.to(dtype)
            if pad:
                t = torch.cat([t, torch.zeros((pad, B * n), dtype=dtype,
                                              device=dev)])
            return t.contiguous()

        a = alpha.reshape(-1).clone()
        wc = w.reshape(B * n, d).clone()
        chain = _Chain(self.Xc, a, wc, inv_lm.repeat_interleave(n),
                       self.loss, self.check)
        chain.run(steps_first(rows, torch.int64),
                  steps_first(flat, torch.int64),
                  steps_first(self.y[rows], self.dt),
                  steps_first(xsq, self.dt),
                  steps_first(mask, self.dt))
        if chain.res is not None and float(chain.res) > NEWTON_TOL:
            raise ArithmeticError(
                f"the reference's logistic Newton steps left |h| = "
                f"{float(chain.res):.3e} > {NEWTON_TOL} before the last")
        return (a - alpha.reshape(-1)).view(B, m), \
            (wc - w.reshape(B * n, d)).view(B, n, d)


def tree_solve(X: Tensor, y: Tensor, *, loss: str, fanouts: Sequence[int],
               level_rounds: Sequence[int], rounds: int, h_cap: int,
               members: Sequence[Dict], dtype=torch.float64
               ) -> List[Dict]:
    """Solve B members on one tree from alpha = 0, w = 0; ``members`` are
    dicts of ``lam``, ``key`` (two uint32 words) and ``h`` (the local
    steps each leaf solve runs, at most ``h_cap``).  Returns per member
    its ``lam``, ``key`` and ``h`` as given, its flat ``alpha`` (m,), ``w``
    (d,) and ``gaps`` (rounds + 1 host floats, round 0 first), in
    ``dtype``."""
    dev = X.device
    Xc = X.to(dtype)
    yc = y.to(dtype)
    sqn = torch.sum(X.double() ** 2, dim=1).to(dtype)
    lams = [float(mb["lam"]) for mb in members]
    tree = _Tree(Xc, yc, sqn, loss, fanouts, level_rounds, h_cap, lams,
                 [int(mb["h"]) for mb in members], dtype == torch.float64)
    B, m, d = len(members), X.shape[0], X.shape[1]
    keys = torch.tensor([[int(k) & threefry.M32 for k in mb["key"]]
                         for mb in members], dtype=torch.int64, device=dev)
    alpha = torch.zeros((B, m), dtype=dtype, device=dev)
    w = torch.zeros((B, d), dtype=dtype, device=dev)
    gaps = [[gap(loss, Xc, yc, alpha[b], lams[b])] for b in range(B)]
    K = fanouts[0]
    for _ in range(int(rounds)):
        ks = threefry.split(keys, 1 + K)
        keys = ks[:, 0]
        da, dw = tree.solve(1, ks[:, 1:], alpha,
                            w[:, None, :].expand(B, K, d).contiguous())
        alpha = alpha + da / K
        w = w + dw.sum(1) / K
        for b in range(B):
            gaps[b].append(gap(loss, Xc, yc, alpha[b], lams[b]))
    return [{"lam": lams[b], "key": list(mb["key"]), "h": int(mb["h"]),
             "alpha": alpha[b], "w": w[b], "gaps": gaps[b]}
            for b, mb in enumerate(members)]
