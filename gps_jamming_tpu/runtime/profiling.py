"""Profiling + structured event tracing.

The reference's observability is wall-clock stamping (`sdrmain.c:195-204`),
a mutex-guarded message ring (`sdrout.c:66-81`), and the (compiled, unused)
RTKLIB trace framework (`lib/rtklib/rtkcmn.c:463-505`). This module is the
framework-native replacement (SURVEY.md §5): a structured JSONL event log,
throughput counters (samples/s per stage), stage timers that synchronize on
device results, and a `jax.profiler` trace context for XLA-level traces.

Timers here use the host-fetch synchronization discipline of bench.py:
`StageTimer.stop(out)` fetches (a tiny slice of) the outputs, which also
waits for the device work behind them.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np


class EventLog:
    """Append-only structured event log with an in-memory ring.

    Replaces the reference's `add_message` 100-entry ring (sdrout.c:66-81):
    thread-safe, typed events, optional JSONL persistence.
    """

    def __init__(self, path: str | None = None, ring_size: int = 1000):
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._ring_size = ring_size
        self._path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def emit(self, kind: str, **fields) -> dict:
        ev = {"t": round(time.time() - self._t0, 6), "kind": kind, **fields}
        with self._lock:
            self._ring.append(ev)
            if len(self._ring) > self._ring_size:
                del self._ring[: len(self._ring) - self._ring_size]
            if self._fh:
                self._fh.write(json.dumps(ev, default=_np_default) + "\n")
                self._fh.flush()
        return ev

    def tail(self, n: int = 100) -> list[dict]:
        with self._lock:
            return list(self._ring[-n:])

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None


def _np_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


@dataclass
class StageStats:
    """Rolling throughput stats for one pipeline stage."""
    name: str
    n_calls: int = 0
    total_s: float = 0.0
    total_samples: int = 0
    _t_start: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t_start = time.perf_counter()

    def stop(self, n_samples: int = 0, out=None) -> float:
        """End the timed region. Passing `out` (any pytree of jax arrays)
        forces a host fetch of one element per leaf so the device queue is
        drained before the clock stops."""
        if out is not None:
            sync(out)
        dt = time.perf_counter() - self._t_start
        self.n_calls += 1
        self.total_s += dt
        self.total_samples += int(n_samples)
        return dt

    @property
    def samples_per_s(self) -> float:
        return self.total_samples / self.total_s if self.total_s else 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.n_calls if self.n_calls else 0.0

    def as_dict(self) -> dict:
        return {"stage": self.name, "calls": self.n_calls,
                "mean_ms": round(self.mean_ms, 3),
                "samples_per_s": round(self.samples_per_s, 1)}


def sync(out) -> None:
    """Drain the device queue: fetch one element of every array leaf.

    A device->host copy of each leaf waits for the work behind it.
    """
    import jax

    def _touch(leaf):
        if hasattr(leaf, "addressable_data") or hasattr(leaf, "device"):
            np.asarray(jax.device_get(
                leaf if getattr(leaf, "ndim", 1) == 0 else
                leaf.reshape(-1)[:1]))
        return leaf

    jax.tree_util.tree_map(_touch, out)


class Profiler:
    """Per-stage samples/s counters + event log + optional XLA traces."""

    def __init__(self, event_log: EventLog | None = None):
        self.stages: dict[str, StageStats] = {}
        self.log = event_log

    @contextlib.contextmanager
    def stage(self, name: str, n_samples: int = 0, out_getter=None):
        st = self.stages.setdefault(name, StageStats(name))
        st.start()
        box = {}
        try:
            yield box
        finally:
            dt = st.stop(n_samples, out=box.get("out"))
            if self.log is not None:
                self.log.emit("stage", stage=name, ms=round(dt * 1e3, 3),
                              samples=n_samples)

    def report(self) -> list[dict]:
        return [s.as_dict() for s in self.stages.values()]


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """jax.profiler trace context (TensorBoard-readable XLA traces)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
