"""Declarative, sessionized solver API (the user-facing surface)::

    from repro_torch.api import Problem, Topology, Schedule, Session
    from repro_torch.core.prng import PRNGKey

    prob = Problem(X, y, loss="squared", lam=0.05)
    topo = Topology.two_level(2, 2, 128)
    sess = Session.compile(prob, topo, Schedule(rounds=10))  # cuda default
    res  = sess.run(key=PRNGKey(0))                          # SolveResult
    more = sess.run(rounds=5, warm_start=res)                # exact continuation

The same objects as the JAX package's ``repro.api``, with ``backend=``
``"cuda"`` (the hand-written leaf kernel) or ``"torch"`` (its plain
version) and an explicit ``device=``; ``Schedule(rounds="auto",
delay=DelayModel(...))`` / ``Schedule.auto`` plan H by the paper's eq.
(12), and ``compression=`` ships compressed deltas with error feedback;
``Schedule(acceleration=)`` adds server momentum.  Grids are first-class:
``Session.sweep`` / :func:`sweep` run a :class:`Sweep` over (lambda, seed,
schedule, local-H) axes through one batched executor (one kernel launch
per solve tick for all configs) and return a :class:`RunSet`::

    rs = sess.sweep(lams=[1e-3, 1e-4], seeds=[0, 1])
    rs.best().w

``Session.run(straggler=StragglerPolicy(...))`` (``runtime/
straggler.py``, with ``core/delay.py::StragglerModel``) runs the paper's
straggler-adaptive async rounds.  ``Session.run(checkpoint=
CheckpointPolicy(...))`` snapshots a solve and ``Session.resume`` continues
it bit for bit (``run_with_faults`` drives simulated kill-and-resume
runs); :class:`ElasticSession` runs a solve whose leaves leave and join
mid-run (a :class:`MembershipLog`), and ``Sweep(resume=)`` continues a
checkpointed fleet.  ``Session.compile(..., backend="mesh")`` runs the
solve with one ``torch.distributed`` rank per leaf (every rank making the
same calls; ``runtime/ranks.py`` spawns and joins them on one host).

LM training is the second workload on the same engine:
``Problem.lm(cfg, optimizer, batch=8, seq=128)`` compiled with
``backend="mesh"`` returns an :class:`LMSession` (one rank per replica)
driven by the same Schedule / planner / straggler / checkpoint machinery;
``LMSession.sweep(Sweep(lrs=, seeds=, local_hs=))`` runs an LM grid as B
members on each rank through one executor and returns an
:class:`LMRunSet`.
"""
from repro_torch.api.lm import LMResult, LMRunSet, LMSession  # noqa: F401
from repro_torch.api.problem import LMProblem, Problem        # noqa: F401
from repro_torch.api.schedule import DelayModel, Schedule     # noqa: F401
from repro_torch.api.session import Session, solve            # noqa: F401
from repro_torch.api.sweep import RunSet, Sweep, sweep        # noqa: F401
from repro_torch.api.topology import Topology                 # noqa: F401
from repro_torch.core.instrument import SolveResult           # noqa: F401
from repro_torch.runtime.fault import (                       # noqa: F401
    CheckpointPolicy, ElasticSession, FaultModel, MembershipLog,
    run_with_faults)

__all__ = ["Problem", "LMProblem", "Topology", "Schedule", "DelayModel",
           "Session", "LMSession", "LMResult", "LMRunSet",
           "SolveResult", "Sweep", "RunSet", "solve", "sweep",
           "CheckpointPolicy", "ElasticSession", "FaultModel",
           "MembershipLog", "run_with_faults"]
