"""The service lifecycle protocol of the runtime kernel.

A ``Service`` is one always-on subsystem (fabric control plane, streaming
detection, downtime accounting, a live trainer ...) registered on an
``EventBus``.  The kernel drives four hooks:

  * ``on_start(kernel)`` — once, before any event is delivered.  The base
    implementation stashes ``kernel`` (and through it the shared clock and
    seeded RNG); override and call ``super().on_start(kernel)``.
  * ``on_event(event)`` — for every event on the bus, scheduled or
    published, in deterministic service order (see below).  Services filter
    by ``isinstance``; unknown event types must be ignored, never an error
    (new services can introduce new events without touching old ones).
  * ``on_tick(t)`` — periodic wall-clock-free heartbeat, every
    ``tick_period_s`` seconds of virtual time (0 disables ticking).  Ticks
    at time t run *after* all events at time t.
  * ``on_stop()`` — once, after the horizon, in the same service order.

Determinism contract: delivery order is ``(priority, name)`` — never
registration order — so two compositions that register the same services in
a different order produce bit-identical runs.  Lower priority runs first;
the convention used by the scenario services is

    accounting/observers (0) < fabric control plane (10)
    < detection (20) < live trainer mirror (30).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for type hints
    from repro_torch.runtime.bus import EventBus


class Service:
    """Base class: a no-op service with a stable (priority, name) identity."""

    name: str = "service"
    priority: int = 0
    tick_period_s: float = 0.0

    def on_start(self, kernel: "EventBus") -> None:
        self.kernel = kernel

    def on_event(self, event: Any) -> None:  # noqa: B027 - intentional no-op
        pass

    def on_tick(self, t: float) -> None:  # noqa: B027 - intentional no-op
        pass

    def on_stop(self) -> None:  # noqa: B027 - intentional no-op
        pass
