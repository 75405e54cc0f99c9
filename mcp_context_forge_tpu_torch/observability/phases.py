"""Per-request wall-time phase attribution (a copy of the JAX package's
``observability/phases.py``; stdlib only).

A :class:`PhaseClock` rides each HTTP request in a contextvar: the
flight-recorder middleware opens it, and each layer that owns a phase
(auth resolution, routing, the engine handoff, serialization) adds its
measured wall into a named bucket.

- Phases are **self-time**: ``phase()`` blocks nest, and a child's wall is
  subtracted from its enclosing phase, so the vector sums to at most the
  request wall.
- The residue (request wall minus every attributed phase) is reported by
  the middleware as ``handler`` (or ``error``), so ``sum(phases) == wall``
  holds by construction.
- Everything is wall time on the event loop: a phase that spans an
  ``await`` includes the loop's time spent on other requests, which is
  what the client waited.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Iterator

_current_clock: contextvars.ContextVar["PhaseClock | None"] = \
    contextvars.ContextVar("mcpforge_phase_clock", default=None)


class PhaseClock:
    """Named wall-time buckets for one request, self-time on nesting."""

    __slots__ = ("phases", "_stack")

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}
        # (name, start, child_seconds) of every open phase() block
        self._stack: list[list] = []

    def add(self, name: str, seconds: float) -> None:
        """Charge ``seconds`` to ``name`` directly (pre-measured work,
        e.g. a DB statement's in-lock time). Counts as child time of any
        enclosing phase() block so wrappers don't double-charge."""
        if seconds < 0.0:
            return
        self.phases[name] = self.phases.get(name, 0.0) + seconds
        if self._stack:
            self._stack[-1][2] += seconds

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Charge the block's SELF time to ``name`` (elapsed minus any
        nested phase()/add() time)."""
        frame = [name, time.perf_counter(), 0.0]
        self._stack.append(frame)
        try:
            yield
        finally:
            elapsed = time.perf_counter() - frame[1]
            # tolerate mis-nesting from concurrent same-request tasks:
            # pop OUR frame wherever it sits rather than corrupting the
            # stack (attribution degrades, accounting never crashes)
            try:
                self._stack.remove(frame)
            except ValueError:  # pragma: no cover - defensive
                pass
            self.add(name, max(0.0, elapsed - frame[2]))

    def total(self) -> float:
        return sum(self.phases.values())

    def vector_ms(self) -> dict[str, float]:
        """{phase: milliseconds} rounded for logs/rings/JSON."""
        return {name: round(seconds * 1e3, 3)
                for name, seconds in sorted(self.phases.items())}


def current_phases() -> PhaseClock | None:
    """The request's clock, or None outside an instrumented request —
    producers must treat None as "attribution off" (zero cost)."""
    return _current_clock.get()


def set_phase_clock(clock: PhaseClock | None) -> contextvars.Token:
    return _current_clock.set(clock)


def reset_phase_clock(token: contextvars.Token) -> None:
    try:
        _current_clock.reset(token)
    except ValueError:  # foreign-context reset (generator teardown)
        pass


def add_phase(name: str, seconds: float) -> None:
    """Charge time to the current request's clock, if any. The one-line
    producer API for layers that only ever add (db/core.py)."""
    clock = _current_clock.get()
    if clock is not None:
        clock.add(name, seconds)


@contextmanager
def phase(name: str) -> Iterator[None]:
    """Self-time phase block against the current clock; no-op without
    one (the same code path serves instrumented and bare calls)."""
    clock = _current_clock.get()
    if clock is None:
        yield
        return
    with clock.phase(name):
        yield
