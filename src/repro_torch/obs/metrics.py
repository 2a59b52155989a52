"""Metrics registry: counters, gauges and log-bucket histograms.

The PyTorch port's copy of ``repro/obs/metrics.py`` (pure Python, kept
line for line so the two packages report identical summaries).

Replaces the engines' ad-hoc ``_occ``/``_util`` sample lists and the
benchmark-side percentile helpers with one typed store:

    reg = MetricsRegistry()
    reg.counter("engine_ticks_total", unit="ticks").inc()
    reg.histogram("engine_ttft_ms", unit="ms").record(12.3)
    reg.to_dict()          # JSON export (merged into PagedEngine.stats())
    reg.prometheus_text()  # text exposition for scrape-based deployments

Histograms are log-bucketed (growth factor 1.05, ~5% relative resolution)
with exact count/sum/min/max, so ``percentile()`` is within one bucket of
the numpy reference at any sample volume while storage stays O(buckets)
instead of O(samples).  The full metric-name reference table lives in the
``repro_torch.obs`` package docstring.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

_LOG_BASE = 1.05
_LN_BASE = math.log(_LOG_BASE)


class Counter:
    """Monotonic counter (resettable via the registry)."""
    __slots__ = ("name", "unit", "site", "value")

    def __init__(self, name: str, unit: str = "", site: str = ""):
        self.name, self.unit, self.site = name, unit, site
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n

    def reset(self):
        self.value = 0

    def to_dict(self) -> dict:
        return {"type": "counter", "unit": self.unit, "value": self.value}


class Gauge:
    """Last-written value."""
    __slots__ = ("name", "unit", "site", "value")

    def __init__(self, name: str, unit: str = "", site: str = ""):
        self.name, self.unit, self.site = name, unit, site
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def reset(self):
        self.value = 0.0

    def to_dict(self) -> dict:
        return {"type": "gauge", "unit": self.unit, "value": self.value}


class Histogram:
    """Log-bucket histogram with exact count/sum/min/max.

    Buckets hold counts of samples with ``base**(i-1) < v <= base**i``;
    non-positive samples land in a dedicated underflow bucket.  Percentiles
    interpolate inside the winning bucket, so the error vs a sorted-sample
    reference is bounded by the bucket width (~5% relative)."""
    __slots__ = ("name", "unit", "site", "count", "total", "min", "max",
                 "_buckets")

    def __init__(self, name: str, unit: str = "", site: str = ""):
        self.name, self.unit, self.site = name, unit, site
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}

    def record(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        idx = -(2 ** 31) if v <= 0 else math.ceil(math.log(v) / _LN_BASE)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty.

        The extreme ranks are exact: p == 0 returns the recorded min and
        p == 100 the recorded max (count/min/max are tracked exactly, so
        neither needs a bucket walk — and a bucket walk would be wrong:
        rank 0 trivially satisfies ``seen >= rank`` at the FIRST bucket,
        which is the min's bucket only by accident).  Interior ranks
        interpolate at the winning bucket's midpoint, clamped to the
        extrema."""
        if not self.count:
            return 0.0
        if p <= 0.0:
            return self.min
        if p >= 100.0:
            return self.max
        rank = p / 100.0 * self.count
        seen = 0
        for idx in sorted(self._buckets):
            n = self._buckets[idx]
            seen += n
            if seen >= rank:
                if idx == -(2 ** 31):
                    # non-positive samples share one underflow bucket (no
                    # log midpoint exists): the first sample there is the
                    # recorded min; deeper ranks clamp to the bucket's
                    # upper edge (0) within the recorded extrema
                    if rank <= 1.0:
                        return self.min
                    return min(max(0.0, self.min), self.max)
                lo, hi = _LOG_BASE ** (idx - 1), _LOG_BASE ** idx
                # clamp the edge buckets to the exact extrema
                return min(max((lo + hi) / 2.0, self.min), self.max)
        return self.max

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def reset(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets.clear()

    def to_dict(self) -> dict:
        return {"type": "histogram", "unit": self.unit, **self.summary()}


class MetricsRegistry:
    """Get-or-create registry of named series.

    Thread-safe at the registration level (the engines are single-threaded
    per instance; registration can race when a trainer callback and an
    engine share the default registry)."""

    def __init__(self):
        self._series: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, unit: str, site: str):
        s = self._series.get(name)
        if s is None:
            with self._lock:
                s = self._series.get(name)
                if s is None:
                    s = cls(name, unit, site)
                    self._series[name] = s
        if not isinstance(s, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(s).__name__}, not {cls.__name__}")
        return s

    def counter(self, name: str, unit: str = "", site: str = "") -> Counter:
        return self._get(Counter, name, unit, site)

    def gauge(self, name: str, unit: str = "", site: str = "") -> Gauge:
        return self._get(Gauge, name, unit, site)

    def histogram(self, name: str, unit: str = "",
                  site: str = "") -> Histogram:
        return self._get(Histogram, name, unit, site)

    def get(self, name: str) -> Optional[object]:
        return self._series.get(name)

    def names(self):
        return sorted(self._series)

    def reset(self):
        """Zero every series (registration survives — reporting stays
        stable across benchmark warmup resets)."""
        for s in self._series.values():
            s.reset()

    def to_dict(self) -> dict:
        return {name: self._series[name].to_dict()
                for name in sorted(self._series)}

    def prometheus_text(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition format (histograms as summaries)."""
        out = []
        for name in sorted(self._series):
            s = self._series[name]
            pname = prefix + name
            if isinstance(s, Counter):
                out.append(f"# TYPE {pname} counter")
                out.append(f"{pname} {s.value}")
            elif isinstance(s, Gauge):
                out.append(f"# TYPE {pname} gauge")
                out.append(f"{pname} {s.value}")
            else:
                out.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.9, 0.99):
                    out.append(f'{pname}{{quantile="{q}"}} '
                               f"{s.percentile(q * 100)}")
                out.append(f"{pname}_sum {s.total}")
                out.append(f"{pname}_count {s.count}")
        return "\n".join(out) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry — the kernel-dispatch telemetry sink
    (``kernels.ops``) and the fallback for engines built without one."""
    return _DEFAULT
