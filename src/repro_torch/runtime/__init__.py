"""Execution runtime: the one step/round loop (``RoundRunner``) behind
the trainer and the pod launcher, its sync policies (barrier, overlap
and async-elastic), the host-side consensus ``Coordinator`` of the
async policy with its kill/restart ``CoordinatorSupervisor``, and the
deterministic chaos harness (``FaultPlan``).  Port of ``repro/runtime``."""
from repro_torch.runtime.coordinator import (  # noqa: F401
    Coordinator,
    CoordinatorClient,
    CoordinatorStopped,
    CoordinatorSupervisor,
    CoordinatorUnavailable,
    FrameError,
    consensus_digest,
    load_consensus,
)
from repro_torch.runtime.faults import (  # noqa: F401
    CRASH_RC,
    FaultPlan,
    WorkerFaults,
    poison_payload,
)
from repro_torch.runtime.policies import (  # noqa: F401
    POLICY_NAMES,
    AsyncElasticPolicy,
    BarrierPolicy,
    OverlapPolicy,
    SyncPolicy,
    policy_for,
    resolve_train_policy,
)
from repro_torch.runtime.runner import (  # noqa: F401
    CheckpointSpec,
    RoundRunner,
    emit_progress,
)
