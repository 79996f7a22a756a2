"""Lock-cheap metrics registry: counters, gauges, histograms; labeled
families; Prometheus text exposition.

Design constraints (the same as the JAX package's registry, whose
Prometheus text this one renders byte for byte):

- **Always-on but cheap**: the hot paths (pipeline stages, hash dispatch,
  retry backoff) record per-*batch*, never per-file, and every record call
  starts with one module-global read — with ``SD_TELEMETRY=off`` nothing
  past that read runs (no lock, no allocation, no dict walk).
- **Fixed vocabulary**: metric names must match ``^sd_[a-z0-9_]+$``, which
  :meth:`Registry._family` enforces at declaration, and histogram bucket
  boundaries are fixed at family creation, so a
  scrape series never changes shape mid-process.
- **Labeled families**: one family per metric name; series are keyed by
  the label-value tuple in declaration order. Label cardinality is the
  caller's responsibility — the instrumented code only uses small closed
  sets (stage, lane, backend, status, seam:kind).

Thread-safety: family lookup/creation takes the registry lock (rare —
call sites memoize the family at module import); each series carries its
own small lock for the increment (float ``+=`` is not atomic under the
GIL). A scrape renders from a consistent point-in-time copy per series,
not a global stop-the-world.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
from typing import Any, Iterable

#: the one metric-name vocabulary (enforced at every declaration)
METRIC_NAME_RE = re.compile(r"^sd_[a-z0-9_]+$")
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: latency-shaped default buckets (seconds): sub-ms queue pops up to the
#: multi-minute scan wall clocks this system actually produces
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

#: serving-shaped buckets: finer at the low end, capped at the
#: 30 s a client would ever wait. THE one definition — _declare_core,
#: telemetry/requests.py and server/shell.py all declare their request
#: histograms from this constant (a drifted copy would raise the
#: fixed-boundary re-declaration error at import)
REQUEST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: lock-shaped buckets of the sd_lock_* histograms: sanitized-lock
#: waits/holds live in the µs band (the JAX package's lock sanitizer
#: records them; the port has none and declares them for the scrape)
LOCK_BUCKETS = (0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1,
                0.5, 2.5)


def _env_enabled() -> bool:
    return os.environ.get("SD_TELEMETRY", "on").strip().lower() not in (
        "0", "off", "false", "no")


#: the one global the fast path reads; default ON
_ENABLED = _env_enabled()


def enabled() -> bool:
    return _ENABLED


def set_enabled(value: bool) -> None:
    """Runtime toggle — an in-process A/B and the tests use this;
    production processes set ``SD_TELEMETRY`` before start instead."""
    global _ENABLED
    _ENABLED = bool(value)


def reload_enabled() -> bool:
    """Re-read ``SD_TELEMETRY`` after an in-process env change."""
    set_enabled(_env_enabled())
    return _ENABLED


# -- series types --------------------------------------------------------------

class Counter:
    """Monotonically increasing float."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _ENABLED:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-written value."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram:
    """Fixed-boundary histogram: per-bucket counts + sum + count."""

    __slots__ = ("_lock", "boundaries", "bucket_counts", "sum", "count")

    def __init__(self, boundaries: tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.boundaries = boundaries
        self.bucket_counts = [0] * (len(boundaries) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            self.bucket_counts[idx] += 1
            self.sum += value
            self.count += 1

    def read(self) -> tuple[list[int], float, int]:
        """Consistent (bucket_counts, sum, count) under the series lock —
        a scrape racing an observe() must never emit a histogram whose
        cumulative +Inf bucket disagrees with its _count line."""
        with self._lock:
            return list(self.bucket_counts), self.sum, self.count


_SERIES_TYPES = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class Family:
    """One named metric: a set of series keyed by label values."""

    def __init__(self, name: str, help_text: str, typ: str,
                 label_names: tuple[str, ...],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help_text
        self.type = typ
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets)) if typ == HISTOGRAM else ()
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], Any] = {}
        if not label_names:
            # label-less families expose their zero sample immediately, so
            # a scrape always shows the full vocabulary
            self._series[()] = self._new_series()

    def _new_series(self) -> Any:
        if self.type == HISTOGRAM:
            return Histogram(self.buckets)
        return _SERIES_TYPES[self.type]()

    def labels(self, **label_values: str) -> Any:
        """Resolve (create if needed) the series for these label values.
        Call sites on hot paths memoize the returned series."""
        if set(label_values) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(label_values))}")
        key = tuple(str(label_values[n]) for n in self.label_names)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.setdefault(key, self._new_series())
        return series

    # -- label-aware conveniences (gated before any dict work) ---------------
    def inc(self, amount: float = 1.0, **label_values: str) -> None:
        if not _ENABLED:
            return
        self.labels(**label_values).inc(amount)

    def set(self, value: float, **label_values: str) -> None:
        if not _ENABLED:
            return
        self.labels(**label_values).set(value)

    def dec(self, amount: float = 1.0, **label_values: str) -> None:
        if not _ENABLED:
            return
        self.labels(**label_values).dec(amount)

    def observe(self, value: float, **label_values: str) -> None:
        if not _ENABLED:
            return
        self.labels(**label_values).observe(value)

    # -- introspection -------------------------------------------------------
    def series_items(self) -> list[tuple[dict[str, str], Any]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.label_names, key)), s) for key, s in items]

    def _reset(self) -> None:
        with self._lock:
            self._series = {}
            if not self.label_names:
                self._series[()] = self._new_series()


class Registry:
    """All families of one process; the scrape and snapshot surface."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    # -- declaration ---------------------------------------------------------
    def _family(self, name: str, help_text: str, typ: str,
                labels: Iterable[str],
                buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Family:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {METRIC_NAME_RE.pattern}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"{name}: bad label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, help_text, typ, label_names, buckets)
                self._families[name] = fam
                return fam
        if fam.type != typ or fam.label_names != label_names:
            raise ValueError(
                f"metric {name} re-declared as {typ}{label_names} "
                f"(was {fam.type}{fam.label_names})")
        if typ == HISTOGRAM and fam.buckets != tuple(sorted(buckets)):
            # fixed-boundary contract: observations silently landing in
            # someone else's buckets is exactly the shape drift this
            # registry exists to prevent
            raise ValueError(
                f"histogram {name} re-declared with different buckets")
        return fam

    def counter(self, name: str, help_text: str = "",
                labels: Iterable[str] = ()) -> Family:
        return self._family(name, help_text, COUNTER, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Iterable[str] = ()) -> Family:
        return self._family(name, help_text, GAUGE, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Iterable[str] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Family:
        return self._family(name, help_text, HISTOGRAM, labels, buckets)

    # -- reads ---------------------------------------------------------------
    def families(self) -> list[Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def value(self, name: str, **label_values: str) -> float:
        """Point value of a counter/gauge series (0.0 when absent) —
        before/after deltas read through this."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None or fam.type == HISTOGRAM:
            return 0.0
        key = tuple(str(label_values.get(n, "")) for n in fam.label_names)
        series = fam._series.get(key)
        return series.value if series is not None else 0.0

    def series_values(self, name: str) -> list[tuple[dict[str, str], float]]:
        """Every (labels, value) of a counter/gauge family."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None or fam.type == HISTOGRAM:
            return []
        return [(lbls, s.value) for lbls, s in fam.series_items()]

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for fam in self.families():
            series = []
            for lbls, s in fam.series_items():
                if fam.type == HISTOGRAM:
                    counts, total, n = s.read()
                    series.append({"labels": lbls, "count": n,
                                   "sum": round(total, 6),
                                   "buckets": dict(zip(
                                       [str(b) for b in fam.buckets] + ["+Inf"],
                                       counts))})
                else:
                    series.append({"labels": lbls, "value": s.value})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "series": series}
        return out

    # -- Prometheus text exposition (format 0.0.4) --------------------------
    def render_prometheus(self) -> str:
        lines: list[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for lbls, s in fam.series_items():
                if fam.type == HISTOGRAM:
                    counts, total, n = s.read()
                    cumulative = 0
                    for bound, c in zip(fam.buckets, counts):
                        cumulative += c
                        lines.append(_sample(f"{fam.name}_bucket",
                                             {**lbls, "le": _fmt(bound)},
                                             cumulative))
                    cumulative += counts[-1]
                    lines.append(_sample(f"{fam.name}_bucket",
                                         {**lbls, "le": "+Inf"}, cumulative))
                    lines.append(_sample(f"{fam.name}_sum", lbls, total))
                    lines.append(_sample(f"{fam.name}_count", lbls, n))
                else:
                    lines.append(_sample(fam.name, lbls, s.value))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every series and drop labeled ones (tests; families stay
        declared so the vocabulary survives)."""
        for fam in self.families():
            fam._reset()


def estimate_quantiles(boundaries: tuple[float, ...],
                       bucket_counts: list[int],
                       qs: tuple[float, ...] = (0.5, 0.95, 0.99),
                       ) -> dict[float, float]:
    """Classic Prometheus-style quantile estimate from fixed buckets:
    linear interpolation inside the bucket the target rank lands in. The
    +Inf bucket clamps to the last finite boundary (the estimate cannot
    exceed what the buckets resolve). Zero observations → all zeros."""
    total = sum(bucket_counts)
    out: dict[float, float] = {}
    if total == 0:
        return {q: 0.0 for q in qs}
    for q in qs:
        target = q * total
        cum = 0
        lo = 0.0
        value = boundaries[-1] if boundaries else 0.0
        for i, count in enumerate(bucket_counts):
            hi = boundaries[i] if i < len(boundaries) else boundaries[-1]
            if count and cum + count >= target:
                value = lo + (hi - lo) * ((target - cum) / count)
                break
            cum += count
            lo = hi
        out[q] = value
    return out


def _fmt(value: float) -> str:
    return repr(value) if value != int(value) else str(int(value))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _sample(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in labels.items())
        name = f"{name}{{{inner}}}"
    if isinstance(value, float) and value == int(value):
        return f"{name} {int(value)}"
    return f"{name} {value}"
