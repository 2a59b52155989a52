"""Low-overhead span/event tracer exporting Chrome trace-event JSON.

Port of ``repro/obs/trace.py``.  The exported file loads in Perfetto or
chrome://tracing: ``X`` complete events for spans, ``i`` instants for
lifecycle transitions, ``b``/``e`` async pairs per request and ``C``
counter samples.  A disabled tracer's ``span()`` returns a shared no-op
context and records nothing; timestamps come from ``time.perf_counter_ns``.

``span(..., annotate=True)`` additionally enters
``torch.profiler.record_function`` (where the reference enters
``jax.profiler.TraceAnnotation``), so spans around engine dispatches line up
with ``torch.profiler`` traces of the card.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List


class _NullContext:
    """Reusable no-op context manager."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class _Span:
    """Context manager recording one ``X`` complete event on exit."""
    __slots__ = ("tracer", "name", "cat", "tid", "args", "t0", "_ann")

    def __init__(self, tracer, name, cat, tid, args, annotate):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self._ann = None
        if annotate:
            import torch.profiler
            self._ann = torch.profiler.record_function(name)

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        t = self.tracer
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "pid": t.pid, "tid": self.tid,
              "ts": (self.t0 - t.epoch_ns) / 1e3, "dur": dur / 1e3}
        if self.args:
            ev["args"] = self.args
        t._events.append(ev)
        return False


class Tracer:
    """Span/event collector; ``enabled=False`` records nothing."""

    def __init__(self, enabled: bool = True, pid: int = 0,
                 process_name: str = "repro-torch-engine"):
        self.enabled = enabled
        self.pid = pid
        self.process_name = process_name
        self.epoch_ns = time.perf_counter_ns()
        self._events: List[Dict[str, Any]] = []

    def _ts(self) -> float:
        return (time.perf_counter_ns() - self.epoch_ns) / 1e3

    def span(self, name: str, cat: str = "engine", tid: int = 0,
             annotate: bool = False, **args):
        """Context manager timing a span; ``annotate=True`` nests a
        ``torch.profiler.record_function`` range."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, cat, tid, args or None, annotate)

    def instant(self, name: str, cat: str = "lifecycle", tid: int = 0,
                **args):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.pid, "tid": tid, "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def begin_async(self, name: str, aid: int, cat: str = "request", **args):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "b", "id": aid,
              "pid": self.pid, "tid": 0, "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def end_async(self, name: str, aid: int, cat: str = "request", **args):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "e", "id": aid,
              "pid": self.pid, "tid": 0, "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, value: float, cat: str = "metrics"):
        if not self.enabled:
            return
        self._events.append(
            {"name": name, "cat": cat, "ph": "C", "pid": self.pid, "tid": 0,
             "ts": self._ts(), "args": {name: value}})

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self._events

    def clear(self):
        self._events.clear()
        self.epoch_ns = time.perf_counter_ns()

    def export(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
                 "ts": 0, "args": {"name": self.process_name}}]
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path


#: shared disabled tracer, the engine's default
NULL_TRACER = Tracer(enabled=False)


def validate_chrome_trace(obj: dict) -> int:
    """Schema check for an exported trace: returns the event count, raising
    ``ValueError`` on any malformed event."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for ev in events:
        if not isinstance(ev, dict):
            raise ValueError(f"event is not an object: {ev!r}")
        for key in ("name", "ph", "pid", "tid", "ts"):
            if key not in ev:
                raise ValueError(f"event missing '{key}': {ev!r}")
        if ev["ph"] not in ("X", "i", "b", "e", "C", "M"):
            raise ValueError(f"unknown phase {ev['ph']!r}: {ev!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event missing 'dur': {ev!r}")
        if ev["ph"] in ("b", "e") and "id" not in ev:
            raise ValueError(f"async event missing 'id': {ev!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"bad ts: {ev!r}")
    return len(events)
