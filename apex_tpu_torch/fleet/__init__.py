"""apex_tpu_torch.fleet — the serving fleet over the port's engines.

Counterpart of ``apex_tpu/fleet``, its serving half:

- :mod:`~apex_tpu_torch.fleet.serve`: :class:`FleetHost` (a per-host
  :class:`~apex_tpu_torch.resilience.ResilientServeEngine` with its own
  obs registry and tracer and a deterministic health surface) and
  :class:`FleetRouter` (least-loaded and prefix-affinity routing,
  heartbeat eviction, host-loss recovery that resubmits in-flight
  requests to survivors as prompt + generated, straggler detection,
  preflight-gated readmission, prefill/decode roles over the KV handoff,
  SLO-driven autoscaling and host rolls).  Every host down with work
  outstanding raises :class:`FleetUnavailable`, never hangs.
- :mod:`~apex_tpu_torch.fleet.preflight`: the per-host admission gate,
  four checks over the host's own decode window, reported as a
  machine-readable :class:`PreflightReport`.

Host-scoped chaos (``host_loss``, ``host_stall``, ``heartbeat_drop``,
``restart``) comes from :mod:`apex_tpu_torch.resilience.faults`, keyed
``(host_site(h), round)`` and seeded by ``FaultPlan.from_seed(...,
hosts=N)``.  JAX's training half (gangs, the DCN exchange) is not ported
yet.
"""
from apex_tpu_torch.fleet.preflight import (  # noqa: F401
    PreflightCheck,
    PreflightReport,
    run_preflight,
)
from apex_tpu_torch.fleet.serve import (  # noqa: F401
    HOST_ROLES,
    FleetHost,
    FleetRouter,
    FleetUnavailable,
)

__all__ = [
    "FleetHost",
    "FleetRouter",
    "FleetUnavailable",
    "HOST_ROLES",
    "PreflightCheck",
    "PreflightReport",
    "run_preflight",
]
