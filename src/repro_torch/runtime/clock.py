"""Typed virtual clock shared by every service on a runtime kernel.

The clock only ever moves forward, and only the kernel's pop loop moves it
(services read ``now``; they never advance time themselves).  Keeping the
clock a tiny standalone type — rather than a float attribute buried in an
engine — is what lets independent services agree on "now" without sharing
an engine object, and lets tests drive time directly.
"""
from __future__ import annotations

from dataclasses import dataclass


class ClockError(RuntimeError):
    """Raised on an attempt to move a ``VirtualClock`` backwards."""


@dataclass
class VirtualClock:
    """Monotonic simulated time in seconds."""

    now: float = 0.0

    def advance(self, to_t: float) -> float:
        """Move time forward to ``to_t`` (equal time is a no-op)."""
        if to_t < self.now:
            raise ClockError(f"clock cannot move backwards: {self.now} -> {to_t}")
        self.now = to_t
        return self.now
