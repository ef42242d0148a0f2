"""apex_tpu_torch.resilience — fault injection and self-healing recovery.

Counterpart of ``apex_tpu/resilience``.  Failures are made injectable
deterministically (every failure mode a replayable test keyed by a
seed) and survivable, by wiring the port's two recovery primitives
(bitwise window-boundary checkpoints, :mod:`apex_tpu_torch.checkpoint`;
recompute from prompt + generated, :mod:`apex_tpu_torch.serve.engine`)
into self-healing wrappers:

- :mod:`~apex_tpu_torch.resilience.faults`: :class:`FaultPlan` (seeded
  schedules over the host dispatch boundaries, JAX's byte for byte) and
  :class:`FaultInjector` (dispatch errors, simulated preemption and
  engine crashes, NaN meters, loader stalls, stragglers, page-pool
  pressure; no kernel is touched);
- :mod:`~apex_tpu_torch.resilience.train`: :class:`ResilientTrainDriver`,
  a watchdog, bounded retry with backoff and seeded jitter, a
  non-finite sentry that rolls back to the last good checkpoint and
  replays bit for bit, and preemption recovery;
- :mod:`~apex_tpu_torch.resilience.serve`: :class:`ResilientServeEngine`,
  per-request deadlines, bounded boundary retry, admission backpressure
  and engine crash recovery that replays in-flight requests as prompt +
  generated (the same tokens under greedy decoding).

Every recovery lands in the ``resilience.*`` counters and the
``resilience.recovery_ms`` histogram.  The switch is the wrappers'
``enabled`` argument (the port reads no environment variable): off,
they are transparent pass-throughs.
"""
from apex_tpu_torch.resilience.faults import (  # noqa: F401
    DISPATCH_ERROR,
    ENGINE_CRASH,
    EXCHANGE_STALL,
    FAULT_KINDS,
    GANG_FAULT_KINDS,
    HEARTBEAT_DROP,
    HOST_FAULT_KINDS,
    HOST_LOSS,
    HOST_STALL,
    LOADER_STALL,
    NAN_METERS,
    PAGE_PRESSURE,
    PREEMPTION,
    RANK_LOSS,
    RESTART,
    STRAGGLER,
    DispatchFailure,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    HostPreemption,
    InjectedFault,
    gang_site,
    host_site,
    resilience_default,
)
from apex_tpu_torch.resilience.serve import ResilientServeEngine  # noqa: F401
from apex_tpu_torch.resilience.train import (  # noqa: F401
    NonFiniteMeters,
    ResilientTrainDriver,
    RetryBudgetExceeded,
)

__all__ = [
    "DISPATCH_ERROR",
    "ENGINE_CRASH",
    "EXCHANGE_STALL",
    "FAULT_KINDS",
    "GANG_FAULT_KINDS",
    "HEARTBEAT_DROP",
    "HOST_FAULT_KINDS",
    "HOST_LOSS",
    "HOST_STALL",
    "LOADER_STALL",
    "NAN_METERS",
    "PAGE_PRESSURE",
    "PREEMPTION",
    "RANK_LOSS",
    "RESTART",
    "STRAGGLER",
    "DispatchFailure",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "HostPreemption",
    "InjectedFault",
    "NonFiniteMeters",
    "ResilientServeEngine",
    "ResilientTrainDriver",
    "RetryBudgetExceeded",
    "gang_site",
    "host_site",
    "resilience_default",
]
