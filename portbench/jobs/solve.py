"""Job kind ``solve``: one ``Session.run`` of the port from alpha = 0.

The session is compiled once in set-up (``Problem`` + ``Topology.balanced``
+ ``Schedule(rounds, level_rounds, local_steps)`` -> ``Session.compile``
on the card's ``cuda`` backend, the hand-written ``sdca_block`` kernel);
each job runs ``rounds`` root rounds under its own key and streams the
gap of every root round through ``on_round``, as a user following
convergence does.

Traffic keys: ``rounds`` (root rounds a job), ``local_steps`` (H, the
coordinate steps of each leaf solve).
"""
from __future__ import annotations

from repro_torch.api import Problem, Schedule, Session, Topology

from portbench.harness import keys


def debug_traffic(traffic: dict, steps: float, lams: float) -> dict:
    """``traffic`` at the harness's debug size: step counts times
    ``steps`` (lambda is the configuration's, scaled by the harness)."""
    return dict(traffic, local_steps=max(1, round(traffic["local_steps"]
                                                  * steps)))


class Job:
    def __init__(self, config, traffic, X, y, *, device, backend, spans):
        tree = config["tree"]
        self.tree, self.loss, self.lam = tree, config["loss"], config["lam"]
        self.rounds = int(traffic["rounds"])
        self.H = int(traffic["local_steps"])
        self.d = X.shape[1]
        topo = Topology.balanced(tree["fanouts"], m_leaf=tree["m_leaf"])
        sched = Schedule(rounds=self.rounds,
                         level_rounds=tree["level_rounds"],
                         local_steps=self.H)
        with spans("session.compile"):
            self.sess = Session.compile(
                Problem(X, y, loss=self.loss, lam=self.lam), topo, sched,
                backend=backend, device=device)

    def run(self, index: int, seed: int, on_round, rounds=None):
        key = keys.job_key(seed, index)
        return key, self.sess.run(rounds, key=key, on_round=on_round)

    def warmup(self, seed: int) -> None:
        """One root round under keys no window job uses: every kernel and
        shape of a job's rounds."""
        self.run(keys.WARMUP, seed, None, rounds=1)

    def expected(self, index: int, seed: int) -> list:
        """The one member that job ``index`` solves."""
        return [{"lam": float(self.lam),
                 "key": keys.job_key(seed, index).tolist(), "h": self.H}]

    def members(self, out) -> list:
        key, res = out
        return [{"lam": self.lam, "key": key.tolist(), "h": self.H,
                 "alpha": res.alpha, "w": res.w,
                 "gaps": [e["gap"] for e in res.history]}]

    def reference_spec(self) -> dict:
        return {"loss": self.loss, "fanouts": self.tree["fanouts"],
                "level_rounds": self.tree["level_rounds"],
                "rounds": self.rounds, "h_cap": self.H}

    def launch_shape(self) -> dict:
        n = 1
        for f in self.tree["fanouts"]:
            n *= f
        return {"B": 1, "K": n, "m_b": self.tree["m_leaf"], "d": self.d,
                "H": self.H, "draws": self.H}
