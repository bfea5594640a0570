"""Job kind ``grid``: one ``Session.sweep`` of the port -- a grid of
configurations through the batched executor, one ``sdca_block`` launch a
solve tick for all of them, the syncs config by config, the history of
every member recorded.

Traffic keys: ``rounds``, ``local_steps`` (the schedule's H), ``h_cap``
(the compiled step capacity, or null), ``lams`` (the lambda axis, or null
for the configuration's), ``seeds`` (how many keys the seed axis holds:
each job draws its own), ``local_hs`` (the runtime-H axis, or null).
"""
from __future__ import annotations

import itertools

from repro_torch.api import Problem, Schedule, Session, Sweep, Topology

from portbench.harness import keys


def debug_traffic(traffic: dict, steps: float, lams: float) -> dict:
    """``traffic`` at the harness's debug size: step counts times
    ``steps``, the lambda axis times ``lams``."""
    def count(v):
        return None if v is None else max(1, round(v * steps))
    hs, ls = traffic.get("local_hs"), traffic.get("lams")
    return dict(traffic, local_steps=count(traffic["local_steps"]),
                h_cap=count(traffic.get("h_cap")),
                local_hs=None if hs is None else [count(h) for h in hs],
                lams=None if ls is None else [v * lams for v in ls])


class Job:
    def __init__(self, config, traffic, X, y, *, device, backend, spans):
        tree = config["tree"]
        self.tree, self.loss = tree, config["loss"]
        self.rounds = int(traffic["rounds"])
        self.H = int(traffic["local_steps"])
        self.cap = traffic.get("h_cap") or self.H
        self.lams = traffic.get("lams")
        self.n_seeds = int(traffic["seeds"])
        self.hs = traffic.get("local_hs")
        self.lam = config["lam"]
        self.d = X.shape[1]
        topo = Topology.balanced(tree["fanouts"], m_leaf=tree["m_leaf"])
        sched = Schedule(rounds=self.rounds,
                         level_rounds=tree["level_rounds"],
                         local_steps=self.H, h_cap=traffic.get("h_cap"))
        with spans("session.compile"):
            self.sess = Session.compile(
                Problem(X, y, loss=self.loss, lam=config["lam"]), topo, sched,
                backend=backend, device=device)

    def run(self, index: int, seed: int, on_round, rounds=None):
        seeds = [keys.job_key(seed, index, s) for s in range(self.n_seeds)]
        return self.sess.sweep(Sweep(lams=self.lams, seeds=seeds,
                                     local_hs=self.hs), rounds=rounds)

    def warmup(self, seed: int) -> None:
        """One root round of the grid under keys no window job uses."""
        self.run(keys.WARMUP, seed, None, rounds=1)

    def expected(self, index: int, seed: int) -> list:
        """The members that job ``index`` has to return, from the traffic
        alone, in the order the port's ``Sweep`` lays a grid out (lambdas
        outermost, then the local steps, then the keys)."""
        lams = self.lams if self.lams is not None else [self.lam]
        hs = self.hs if self.hs is not None else [self.H]
        keys_ = [keys.job_key(seed, index, s).tolist()
                 for s in range(self.n_seeds)]
        return [{"lam": float(lam), "key": key, "h": int(h)}
                for lam, h, key in itertools.product(lams, hs, keys_)]

    def members(self, rs) -> list:
        gaps = rs.history["gap"]
        return [{"lam": pt.lam, "key": pt.seed.tolist(),
                 "h": self.H if pt.local_h is None else int(pt.local_h),
                 "alpha": rs.alphas[b], "w": rs.ws[b],
                 "gaps": [float(g) for g in gaps[b]]}
                for b, pt in enumerate(rs.points)]

    def reference_spec(self) -> dict:
        return {"loss": self.loss, "fanouts": self.tree["fanouts"],
                "level_rounds": self.tree["level_rounds"],
                "rounds": self.rounds, "h_cap": self.cap}

    def launch_shape(self) -> dict:
        n = 1
        for f in self.tree["fanouts"]:
            n *= f
        hs = self.hs or [self.H]
        B = len(self.lams or [None]) * len(hs) * self.n_seeds
        # members under one key draw the same rows: the launch reads the
        # union of each key's longest run of steps
        return {"B": B, "K": n, "m_b": self.tree["m_leaf"], "d": self.d,
                "H": self.cap, "draws": self.n_seeds * max(hs)}
