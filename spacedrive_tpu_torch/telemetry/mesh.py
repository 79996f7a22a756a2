"""Mesh observability: cross-node trace propagation + convergence lag.

The port of ``spacedrive_tpu/telemetry/mesh.py``, with the same wire form,
so a JAX node's envelope decodes here and this node's decodes there. A
compact **trace-context envelope** rides inside sync windows, p2p
hash-batch requests and replica queries, so the receiver's spans parent
under the *sender's* span ids and the JSONL exports of both nodes stitch
into one tree by ``trace_id``:

- :class:`TraceContext` — ``(trace_id, parent span_id, origin node id,
  origin HLC watermark, pending op backlog)``, wire form a 5-key dict;
- per-node **span-id bases** (a 24-bit hash of the node id shifted above
  the local counter) keep ids collision-free when two processes append to
  one logical trace;
- **convergence lag**: every ingest window updates per-peer gauges —
  ``sd_sync_peer_lag_ops`` (the sender-declared backlog left after the
  window) and ``sd_sync_peer_lag_seconds`` (sender HLC watermark minus
  the newest timestamp we applied) — plus an end-to-end
  ``sd_sync_apply_delay_seconds`` histogram (op_created→op_applied from
  the op's HLC stamp). Both lag series return to 0 when a peer pair is
  in sync.

Like the rest of ``spacedrive_tpu_torch.telemetry``, this module imports
nothing from the rest of the package (any layer may instrument without
cycles); the NTP64→unix conversion is inlined rather than imported from
``sync/hlc.py`` for that reason.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any

from . import counter, gauge, histogram, enabled
from . import spans as _spans
from .spans import Span, Trace

__all__ = [
    "TraceContext", "apply_delay_series", "continue_trace", "new_trace",
    "outbound_context", "peer_label", "record_ingest_window", "remote_span",
    "span_id_base",
]

#: sender-declared backlog after each ingest window, per peer
_PEER_LAG_OPS = gauge(
    "sd_sync_peer_lag_ops",
    "CRDT ops the peer has logged that this node has not yet ingested "
    "(sender-declared backlog after each sync window)", labels=("peer",))
_PEER_LAG_SECONDS = gauge(
    "sd_sync_peer_lag_seconds",
    "HLC delta between the peer's watermark and the newest op applied "
    "from it", labels=("peer",))
_APPLY_DELAY = histogram(
    "sd_sync_apply_delay_seconds",
    "op_created -> op_applied end-to-end latency (op HLC stamp vs local "
    "wall clock at ingest)", labels=("peer",))
_REMOTE_WINDOWS = counter(
    "sd_sync_remote_windows_total",
    "sync ingest windows received per peer", labels=("peer",))
_REMOTE_SESSIONS = counter(
    "sd_sync_remote_sessions_total",
    "sync-over-wire sessions completed per peer", labels=("peer",))
_HASH_SERVE = counter(
    "sd_p2p_hash_serve_total",
    "inbound remote-hasher batches served per peer", labels=("peer",))
_HASH_SERVE_BYTES = counter(
    "sd_p2p_hash_serve_bytes_total",
    "cas-message bytes hashed on behalf of remote peers", labels=("peer",))
# admission control: BUSY answers on the p2p receive path —
# sent when OUR budget sheds a peer's work, received when a peer sheds ours
_BUSY_SENT = counter(
    "sd_p2p_busy_replies_total",
    "BUSY answers this node sent (its admission budget shed the request)",
    labels=("peer",))
_BUSY_RECEIVED = counter(
    "sd_p2p_busy_received_total",
    "BUSY answers received from peers (their budget shed our request)",
    labels=("peer",))
_BUSY_BACKOFF_S = counter(
    "sd_p2p_busy_backoff_seconds_total",
    "wall time spent backing off after a peer's BUSY answer")


def peer_label(identity: str | None) -> str:
    """Bounded-cardinality peer label: an 8-hex-char hash of the node's
    identity (never the raw identity — scrape labels must stay short and
    a fleet of peers must not explode series cardinality beyond the
    peer count itself). ``local`` for in-process/transport-less ingest."""
    if not identity:
        return "local"
    return hashlib.blake2s(identity.encode("utf-8", "replace"),
                           digest_size=4).hexdigest()


def span_id_base(origin: str | None) -> int:
    """Per-node span-id base: 24 bits of the node id above bit 32. Two
    nodes appending to one stitched trace allocate from disjoint ranges,
    so a merged JSONL can never collide on span ids."""
    if not origin:
        return 0
    h = hashlib.blake2s(origin.encode("utf-8", "replace"), digest_size=3)
    return int.from_bytes(h.digest(), "big") << 32


def _ntp64_to_unix(ts: int) -> float:
    # sync/hlc.py's NTP64 layout: high 32 bits unix seconds, low 32 fraction
    return (ts >> 32) + (ts & 0xFFFFFFFF) / (1 << 32)


@dataclass(frozen=True)
class TraceContext:
    """The compact envelope a cross-node exchange carries."""

    trace_id: str
    span_id: int          #: the sender-side span the receiver parents under
    origin: str = ""      #: sender node id (attribution/debug, not auth)
    hlc: int = 0          #: sender's HLC watermark when the frame was built
    pending: int | None = None  #: sender-declared ops left AFTER this window

    def to_wire(self) -> dict[str, Any]:
        wire: dict[str, Any] = {"t": self.trace_id, "s": self.span_id,
                                "o": self.origin, "h": self.hlc}
        if self.pending is not None:
            wire["p"] = self.pending
        return wire

    @classmethod
    def from_wire(cls, wire: Any) -> "TraceContext | None":
        """Defensive decode: a malformed envelope from a buggy/malicious
        peer degrades to 'no context', never to an exception — and the
        trace_id is validated against the filename-safe pattern because
        it eventually reaches the traces directory on disk."""
        if not isinstance(wire, dict):
            return None
        trace_id, span_id = wire.get("t"), wire.get("s")
        if not isinstance(trace_id, str) or len(trace_id) > 128 \
                or not _spans._TRACE_ID_RE.match(trace_id):
            return None
        if not isinstance(span_id, int) or isinstance(span_id, bool) \
                or span_id < 0:
            return None
        origin = wire.get("o")
        hlc = wire.get("h")
        pending = wire.get("p")
        return cls(
            trace_id=trace_id, span_id=span_id,
            origin=origin if isinstance(origin, str) else "",
            hlc=hlc if isinstance(hlc, int)
            and not isinstance(hlc, bool) and hlc >= 0 else 0,
            pending=pending if isinstance(pending, int)
            and not isinstance(pending, bool) and pending >= 0 else None)


# -- trace plumbing ------------------------------------------------------------

def new_trace(name: str, origin: str, trace_id: str,
              **attrs: Any) -> Trace | None:
    """Open a mesh trace on the SENDING side (span ids based off this
    node's id); remembered in the process ring like job traces so
    ``telemetry.jobTrace`` serves it by trace_id."""
    if not enabled():
        return None
    trace = Trace(trace_id, name, {**attrs, "origin": origin},
                  span_id_base=span_id_base(origin))
    _spans.remember(trace)
    return trace


def continue_trace(ctx: TraceContext | None, origin: str,
                   name: str = "sync.mesh") -> Trace | None:
    """The RECEIVING side of propagation: append to the trace named by the
    envelope. In-process (same ring) that is the sender's own Trace
    object; cross-process it is a fresh Trace under the same trace_id
    whose span ids come from THIS node's base — the two JSONL exports
    stitch by trace_id."""
    if ctx is None or not enabled():
        return None
    existing = _spans.get_trace(ctx.trace_id)
    if existing is not None and not existing.finished:
        return existing
    trace = Trace(ctx.trace_id, name,
                  {"origin": ctx.origin, "continued_on": origin},
                  span_id_base=span_id_base(origin))
    _spans.remember(trace)
    return trace


def remote_span(trace: Trace | None, ctx: TraceContext | None,
                name: str, **attrs: Any) -> Span:
    """A span parented under the REMOTE span named by the envelope (or a
    bare timer when recording is off)."""
    if trace is None:
        return Span(name, trace=None, attrs=attrs)
    return trace.span(name, parent_id=ctx.span_id if ctx else None, **attrs)


def outbound_context(origin: str = "", hlc: int = 0,
                     pending: int | None = None) -> TraceContext | None:
    """Envelope for an outbound exchange made from inside a span (the
    remote-hasher path): names the calling thread's innermost open span
    so the serving peer's spans stitch under the caller's job trace."""
    if not enabled():
        return None
    trace = _spans.current_trace()
    if trace is None:
        return None
    return TraceContext(trace.trace_id, trace.current_span_id(),
                        origin=origin, hlc=hlc, pending=pending)


#: retention for session-scoped mesh exports: unlike job traces (one file
#: per job id, overwritten on re-run), every sync session writes a fresh
#: uuid-suffixed ``sync-*.jsonl`` — without a cap a chatty long-lived
#: node would grow logs/traces/ unboundedly
MAX_SESSION_TRACE_FILES = 256


def prune_session_traces(base_dir,
                         keep: int = MAX_SESSION_TRACE_FILES) -> None:
    """Drop the oldest session-trace exports beyond ``keep`` (best-effort;
    called after every session export on both the sending and receiving
    side)."""
    try:
        files = sorted(_spans.traces_dir(base_dir).glob("sync-*.jsonl"),
                       key=lambda p: p.stat().st_mtime)
        for stale in files[:-keep] if keep > 0 else files:
            stale.unlink(missing_ok=True)
    except OSError:
        pass


def export_partial(trace: Trace | None, base_dir) -> str | None:
    """Export a mesh trace's records WITHOUT finishing it: no local root
    record is added, so a stitched merge keeps exactly one root — the
    originating node's."""
    if trace is None:
        return None
    path = _spans.export_trace(trace, base_dir)
    prune_session_traces(base_dir)
    return path


# -- convergence lag -----------------------------------------------------------

def record_ingest_window(label: str, ctx: TraceContext | None,
                         max_applied_ts: int) -> None:
    """Update the per-peer lag gauges from one ingest window's envelope.
    ``max_applied_ts`` is the newest HLC timestamp the window carried
    (0 for an empty window)."""
    if not enabled():
        return
    _REMOTE_WINDOWS.inc(peer=label)
    if ctx is None:
        return
    if ctx.pending is not None:
        _PEER_LAG_OPS.set(float(max(0, ctx.pending)), peer=label)
    if ctx.hlc:
        if max_applied_ts:
            _PEER_LAG_SECONDS.set(
                max(0.0, _ntp64_to_unix(ctx.hlc)
                    - _ntp64_to_unix(max_applied_ts)), peer=label)
        elif not ctx.pending:
            # empty final window: nothing newer exists on the peer
            _PEER_LAG_SECONDS.set(0.0, peer=label)


def record_session(label: str) -> None:
    _REMOTE_SESSIONS.inc(peer=label)


def record_hash_serve(label: str, payload_bytes: int) -> None:
    _HASH_SERVE.inc(peer=label)
    _HASH_SERVE_BYTES.inc(payload_bytes, peer=label)


def record_busy_sent(label: str) -> None:
    _BUSY_SENT.inc(peer=label)


def record_busy_received(label: str) -> None:
    _BUSY_RECEIVED.inc(peer=label)


def record_busy_backoff(backoff_s: float) -> None:
    """Wall time ACTUALLY about to be spent sleeping on a peer's BUSY —
    callers record this adjacent to the sleep, after any give-up checks,
    so the counter never claims backoff that was skipped."""
    if backoff_s > 0:
        _BUSY_BACKOFF_S.inc(backoff_s)


def apply_delay_series(label: str):
    """Memoizable per-peer histogram series handle for the per-op
    op_created→op_applied delay (callers hoist this out of the loop)."""
    return _APPLY_DELAY.labels(peer=label)
