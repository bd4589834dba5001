"""Runtime kernel: virtual clock + deterministic event bus + service protocol.

The reusable substrate the scenario campaign engine composes its services
on (docs/runtime.md).  Nothing in this package knows about C4, fabrics, or
detection — it schedules opaque events and drives ``Service`` lifecycles
deterministically.
"""
from repro_torch.runtime.bus import LANE_EVENT, LANE_TICK, EventBus
from repro_torch.runtime.clock import ClockError, VirtualClock
from repro_torch.runtime.service import Service

__all__ = ["EventBus", "Service", "VirtualClock", "ClockError",
           "LANE_EVENT", "LANE_TICK"]
