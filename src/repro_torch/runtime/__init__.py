"""Execution runtime: the one step/round loop (``RoundRunner``) behind
the trainer, and its sync policies (barrier and overlap).  Port of
``repro/runtime``."""
from repro_torch.runtime.policies import (  # noqa: F401
    POLICY_NAMES,
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
