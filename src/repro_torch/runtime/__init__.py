"""Runtime policies around a session's run loop.  Ported so far:
``straggler`` (the paper's §6 mechanism in operation: step timing,
bounded-skip barriers and adaptive H).  The checkpoint, fault and elastic
runtime is not ported yet (ROADMAP A6)."""
from repro_torch.runtime.straggler import (  # noqa: F401
    AdaptiveSchedule, BoundedSkip, StepTimer, StragglerPolicy,
    StragglerStep)

__all__ = ["AdaptiveSchedule", "BoundedSkip", "StepTimer",
           "StragglerPolicy", "StragglerStep"]
