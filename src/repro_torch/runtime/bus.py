"""Deterministic heap-based event bus — the runtime kernel's scheduler.

One ``EventBus`` owns the virtual clock, a seeded RNG shared by its
services, and a binary-heap timeline.  Two delivery channels:

  * ``schedule(t, event)`` — timed delivery: the event is popped when the
    clock reaches ``t`` and handed to every service's ``on_event``.
  * ``publish(event)`` — immediate synchronous delivery at the current
    clock time: the full service chain runs before ``publish`` returns, so
    a causal cascade (fault -> detection -> isolation accounting) completes
    atomically within one timestamp, exactly like a nested function call —
    but with the stages living in separate services.

Ordering is fully deterministic and independent of registration order:

  * heap entries sort by ``(t, lane, seq)`` — time first, then lane
    (scheduled events before ticks at the same instant), then a
    monotonically increasing sequence number (FIFO among ties);
  * within a delivery, services run in ``(priority, name)`` order
    (``runtime.service.Service``).

The trace records every delivery (scheduled, published, tick) as a
``(t, kind, event)`` tuple and is the bit-identical artifact the
determinism drill compares; see docs/runtime.md for the full contract.

Drain strategy (the 1M+ event stress characterization): the dominant
costs at high event rates are the per-pop ``heapq`` sift (O(log n) with
Python-level tuple comparisons) and the per-event delivery fan-out
(attribute lookups per service per event).  ``drain`` therefore sorts the
pre-scheduled timeline once (descending, so the next entry pops from the
tail in O(1)) and routes mid-drain ``schedule`` calls to a small side
heap, merging the two streams by comparing heads — the pop order is
provably identical to a pure heap, so the trace stays bit-stable.
Delivery uses a cached list of bound ``on_event`` handlers rebuilt on
``register``.  Measured on the 1M-event benchmark this is ~3.5x the
all-heap baseline (see docs/runtime.md for the table).

Horizon semantics: nothing is ever dropped.  Entries past the horizon
(including tick re-arms) stay queued, so a run can be split —
``start(T); drain()`` then ``run_to(2T)`` is bit-identical to
``start(2T); drain()`` — which is what the continuous fleet layer's
snapshot/resume and the horizon-splitting property tests rely on.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.clock import VirtualClock
from repro_torch.runtime.service import Service

LANE_EVENT = 0   # scheduled events run before ...
LANE_TICK = 1    # ... service ticks at the same timestamp

# trace record: (t, kind, event) — kind in {"event", "publish", "tick"};
# for ticks the event slot holds the service *name* (a str)
TraceRecord = Tuple[float, str, Any]


class EventBus:
    """Single-run deterministic kernel: register services, feed events, run."""

    def __init__(self, seed: int = 0, clock: Optional[VirtualClock] = None):
        self.clock = clock or VirtualClock()
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.services: List[Service] = []
        self.trace: List[TraceRecord] = []
        self._heap: List[Tuple[float, int, int, Any]] = []
        self._side: Optional[List[Tuple[float, int, int, Any]]] = None
        self._handlers: List[Callable[[Any], None]] = []
        self._seq = 0
        self._started = False
        self._until = 0.0

    # ---- composition -------------------------------------------------------
    def register(self, service: Service) -> Service:
        if self._started:
            raise RuntimeError("cannot register services after start()")
        if any(s.name == service.name for s in self.services):
            raise ValueError(f"duplicate service name {service.name!r}")
        self.services.append(service)
        # (priority, name) order — registration order must never matter
        self.services.sort(key=lambda s: (s.priority, s.name))
        self._handlers = [s.on_event for s in self.services]
        return service

    def service(self, name: str) -> Service:
        for s in self.services:
            if s.name == name:
                return s
        raise KeyError(f"no service named {name!r}")

    # ---- event channels ----------------------------------------------------
    def _push(self, t: float, lane: int, payload: Any) -> None:
        self._seq += 1
        target = self._side if self._side is not None else self._heap
        heapq.heappush(target, (t, lane, self._seq, payload))

    def schedule(self, t: float, event: Any) -> None:
        """Timed delivery when the clock reaches ``t``."""
        if t < self.clock.now:
            raise ValueError(f"cannot schedule into the past: {t} < {self.clock.now}")
        self._push(t, LANE_EVENT, event)

    def publish(self, event: Any) -> None:
        """Immediate synchronous delivery at the current clock time."""
        self._deliver(event, kind="publish")

    def _deliver(self, event: Any, kind: str) -> None:
        self.trace.append((self.clock.now, kind, event))
        for handler in self._handlers:
            handler(event)

    # ---- run loop ----------------------------------------------------------
    def start(self, until: float) -> None:
        """Start services (priority order) and arm their tick trains."""
        if self._started:
            raise RuntimeError("start() called twice")
        self._started = True
        self._until = until
        for svc in self.services:
            svc.on_start(self)
        for svc in self.services:
            # armed regardless of the horizon: a first tick past ``until``
            # simply waits in the queue until a later run_to() reaches it
            if svc.tick_period_s > 0:
                self._push(self.clock.now + svc.tick_period_s, LANE_TICK, svc)

    def drain(self) -> None:
        """Deliver everything up to the horizon; leave the rest queued.

        The pre-scheduled timeline is sorted once (descending — the next
        entry is ``timeline[-1]``, an O(1) ``pop``); anything pushed while
        draining (publish cascades, tick re-arms, service schedules) lands
        on a side heap and is merged in by head comparison.  ``(t, lane,
        seq)`` entries are unique, so the merge order equals the pure-heap
        pop order exactly.  The first entry past the horizon is *peeked*,
        never popped — a later ``run_to`` resumes with nothing lost.
        """
        until = self._until
        timeline = self._heap
        timeline.sort(reverse=True)
        side: List[Tuple[float, int, int, Any]] = []
        self._side = side            # reroute _push while draining
        clock = self.clock
        trace = self.trace
        handlers = self._handlers
        pop_side = heapq.heappop
        try:
            while True:
                if side and (not timeline or side[0] < timeline[-1]):
                    entry = side[0]
                    if entry[0] > until:
                        break
                    pop_side(side)
                elif timeline:
                    entry = timeline[-1]
                    if entry[0] > until:
                        break
                    timeline.pop()
                else:
                    break
                t, lane, _, payload = entry
                clock.now = t        # monotone by merge order; skip advance()
                if lane == LANE_TICK:
                    svc = payload
                    trace.append((t, "tick", svc.name))
                    svc.on_tick(t)
                    if svc.tick_period_s > 0:
                        self._push(t + svc.tick_period_s, LANE_TICK, svc)
                else:
                    trace.append((t, "event", payload))
                    for handler in handlers:
                        handler(payload)
        finally:
            # restore one valid ascending heap for pause/resume callers
            self._side = None
            timeline.reverse()
            if side:
                timeline.extend(side)
                heapq.heapify(timeline)

    def run_to(self, t: float) -> None:
        """Extend the horizon to ``t`` and drain up to it (incremental run).

        Splitting a run at any point is bit-identical to running it in one
        go: ``start(T); drain(); run_to(2T)`` equals ``start(2T); drain()``
        because past-horizon entries are retained and tick trains are armed
        independent of the horizon.  The continuous fleet layer steps its
        kernel with this between rolling reports.
        """
        if not self._started:
            raise RuntimeError("run_to() before start()")
        if t < self._until:
            raise ValueError(f"cannot shrink the horizon: {t} < {self._until}")
        self._until = t
        self.drain()

    def stop(self) -> None:
        """Advance to the horizon and run ``on_stop`` in service order."""
        self.clock.advance(self._until)
        for svc in self.services:
            svc.on_stop()

    def run(self, until: float) -> None:
        self.start(until)
        self.drain()
        self.stop()

    # ---- introspection -----------------------------------------------------
    def trace_lines(self) -> List[str]:
        """The delivery trace as stable strings (the determinism artifact).

        Events render via their ``trace_label`` attribute when they define
        one, else ``repr`` — domain events with bulky payloads (e.g. a full
        rate result) define ``trace_label`` to keep the trace compact while
        staying bit-stable."""
        out = []
        for t, kind, ev in self.trace:
            label = getattr(ev, "trace_label", None) or repr(ev)
            out.append(f"{t:.6f} {kind} {label}")
        return out
