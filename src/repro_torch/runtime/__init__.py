"""Runtime policies around a session's run loop: ``straggler`` (the
paper's §6 mechanism in operation: step timing, bounded-skip barriers and
adaptive H), ``checkpoint`` (atomic, keep-k, async snapshots in the JAX
package's file format), ``fault`` (checkpointed carries and
``Session.resume``, permanent membership events, fault injection) and
``elastic`` (moving a state between devices, the per-replica batch of a
mesh), and ``ranks`` (spawning and joining the ranks of a mesh run)."""
from repro_torch.runtime.fault import (  # noqa: F401
    CheckpointPolicy, ElasticSession, FaultModel, MembershipLog,
    run_with_faults)
from repro_torch.runtime.straggler import (  # noqa: F401
    AdaptiveSchedule, BoundedSkip, StepTimer, StragglerPolicy,
    StragglerStep)

__all__ = ["AdaptiveSchedule", "BoundedSkip", "CheckpointPolicy",
           "ElasticSession", "FaultModel", "MembershipLog", "StepTimer",
           "StragglerPolicy", "StragglerStep", "run_with_faults"]
