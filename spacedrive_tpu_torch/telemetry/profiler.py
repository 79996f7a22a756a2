"""Span-tagged wall-clock sampling profiler + process resource watcher.

:class:`SamplingProfiler` wakes ``SD_PROFILE_HZ`` times per second
(default **off** — nothing starts, zero overhead), snapshots every
thread's stack via ``sys._current_frames()``, and attributes each sample
to the sampled thread's innermost **open span**
(:func:`spans.active_span` — the cross-thread mirror of the span
thread-local). Samples aggregate as folded stacks
``<span>;<frame>;<frame> count`` — the flamegraph input format — keyed
by span name, so "where does wall time go *inside* ``pipeline.hash``"
is one grep. Threads with no open span fold under ``other``.

Export: ``<data_dir>/logs/profiles/<name>.folded`` (plus a
``.traces.json`` sidecar mapping trace ids → per-span sample counts, so
``python -m spacedrive_tpu_torch.telemetry --profile <job_id>`` can answer by
job as well as by span). Both use the tempfile→fsync→rename discipline
(atomic.py) like the trace JSONL exports beside them.

:class:`ResourceWatcher` is the cheap always-on sibling: a slow ticker
(``SD_RESOURCE_INTERVAL_S``, default 5 s) publishing
``sd_proc_rss_bytes`` / ``sd_proc_open_fds`` / ``sd_proc_threads`` from
/proc, and refreshing the serving-tier p99 gauges
(:func:`requests.publish_quantiles`) the alert rules read.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any

from . import counter as _counter
from . import gauge as _gauge
from .registry import enabled
from . import spans as _spans

logger = logging.getLogger(__name__)

#: stack depth cap per sample (deep recursion must not bloat keys)
MAX_DEPTH = 48

_SAMPLES = _counter(
    "sd_profile_samples_total",
    "wall-clock profiler samples attributed per active span name "
    "('other' = the sampled thread had no open span)", labels=("span",))

_RSS = _gauge("sd_proc_rss_bytes", "resident set size of this process")
_FDS = _gauge("sd_proc_open_fds", "open file descriptors of this process")
_THREADS = _gauge("sd_proc_threads", "live Python threads in this process")


def profile_hz() -> float:
    """``SD_PROFILE_HZ`` (default 0 = off; clamped to ≤ 1000)."""
    try:
        return min(1000.0, max(0.0, float(
            os.environ.get("SD_PROFILE_HZ", "0"))))
    except ValueError:
        return 0.0


def _fold_frame(frame: Any) -> str:
    """One thread's stack as ``outermost;...;innermost`` frames, each
    ``module:function`` (basename only — paths would bloat every key)."""
    parts: list[str] = []
    while frame is not None and len(parts) < MAX_DEPTH:
        code = frame.f_code
        name = os.path.basename(code.co_filename)
        if name.endswith(".py"):
            name = name[:-3]
        parts.append(f"{name}:{code.co_name}")
        frame = frame.f_back
    return ";".join(reversed(parts))


class SamplingProfiler:
    """Wall-clock sampler over ``sys._current_frames()``. One instance =
    one aggregation window; ``stop()`` freezes it, ``export()`` writes
    the folded file."""

    def __init__(self, hz: float | None = None) -> None:
        self.hz = profile_hz() if hz is None else hz
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._folded: Counter[str] = Counter()
        self._by_span: Counter[str] = Counter()
        #: trace_id -> span name -> samples (the job-id view)
        self._by_trace: dict[str, Counter[str]] = {}
        self.samples = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SamplingProfiler | None":
        """Start sampling; returns None (and starts nothing) at hz 0 —
        the zero-overhead-when-off contract."""
        if self.hz <= 0:
            return None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sd-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        while not self._stop.wait(interval):
            try:
                self._sample_once(own)
            except Exception:  # sampling must never take the process down
                logger.exception("profiler sample failed")

    def _sample_once(self, own_tid: int) -> None:
        frames = sys._current_frames()
        with self._lock:
            for tid, frame in frames.items():
                if tid == own_tid:
                    continue
                active = _spans.active_span(tid)
                span_name = active[1] if active else "other"
                stack = _fold_frame(frame)
                self._folded[f"{span_name};{stack}"] += 1
                self._by_span[span_name] += 1
                if active is not None:
                    self._by_trace.setdefault(
                        active[0], Counter())[span_name] += 1
                self.samples += 1
                _SAMPLES.inc(span=span_name)

    # -- reads ---------------------------------------------------------------
    def totals_by_span(self) -> dict[str, int]:
        with self._lock:
            return dict(self._by_span)

    def totals_by_trace(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {t: dict(c) for t, c in self._by_trace.items()}

    def folded(self, top: int | None = None) -> list[tuple[str, int]]:
        with self._lock:
            rows = self._folded.most_common(top)
        return rows

    # -- export --------------------------------------------------------------
    def export(self, base_dir: str | Path,
               name: str = "profile") -> Path | None:
        """Write the folded aggregation beside the trace exports
        (atomic; best-effort — a full disk degrades like trace export)."""
        if not self.samples:
            return None
        try:
            from ..atomic import atomic_write_text

            out_dir = profiles_dir(base_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = out_dir / f"{name}-{stamp}.folded"
            with self._lock:
                lines = "".join(f"{key} {count}\n" for key, count
                                in sorted(self._folded.items()))
                sidecar = {t: dict(c) for t, c in self._by_trace.items()}
            atomic_write_text(path, lines)
            import json

            atomic_write_text(path.with_suffix(".traces.json"),
                              json.dumps(sidecar, indent=1, sort_keys=True))
            return path
        except OSError as e:
            import errno as _errno

            if getattr(e, "errno", None) == _errno.ENOSPC:
                from ..retry import note_disk_full

                note_disk_full("trace_export")
            logger.exception("could not export profile (aggregation stays "
                             "in memory)")
            return None


def profiles_dir(base_dir: str | Path) -> Path:
    return Path(base_dir) / "logs" / "profiles"


def load_folded(base_dir: str | Path) -> Counter:
    """Merge every exported ``.folded`` file under ``base_dir`` — the
    CLI's ``--profile`` read path."""
    merged: Counter[str] = Counter()
    for path in sorted(profiles_dir(base_dir).glob("*.folded")):
        try:
            for line in path.read_text().splitlines():
                key, _, count = line.rpartition(" ")
                if key and count.isdigit():
                    merged[key] += int(count)
        except OSError:
            continue
    return merged


def load_trace_totals(base_dir: str | Path) -> dict[str, dict[str, int]]:
    """Merge every ``.traces.json`` sidecar (trace id → span → samples)."""
    import json

    merged: dict[str, dict[str, int]] = {}
    for path in sorted(profiles_dir(base_dir).glob("*.traces.json")):
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        if not isinstance(data, dict):
            continue
        for trace_id, by_span in data.items():
            if not isinstance(by_span, dict):
                continue
            agg = merged.setdefault(trace_id, {})
            for span, n in by_span.items():
                agg[span] = agg.get(span, 0) + int(n)
    return merged


# -- process resource watcher --------------------------------------------------

def _read_proc_status() -> tuple[float, float]:
    """(rss_bytes, 0.0-placeholder) from /proc/self/status; (0, 0) when
    /proc is unavailable (non-Linux test hosts)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0, 0.0
    except OSError:
        pass
    return 0.0, 0.0


def _count_fds() -> float:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return 0.0


class ResourceWatcher:
    """Slow ticker publishing process gauges + serving-tier quantile
    gauges. One per Node (started at boot, stopped at shutdown), like the
    alert evaluator."""

    def __init__(self, interval_s: float | None = None) -> None:
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get("SD_RESOURCE_INTERVAL_S", "5"))
            except ValueError:
                interval_s = 5.0
        self.interval_s = max(0.05, interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ResourceWatcher":
        self.tick()  # gauges live from boot, not after the first interval
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sd-resources")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("resource watcher tick failed")

    def tick(self) -> None:
        if not enabled():
            return
        rss, _ = _read_proc_status()
        _RSS.set(rss)
        _FDS.set(_count_fds())
        _THREADS.set(float(threading.active_count()))
        from . import requests as _requests

        _requests.publish_quantiles()
