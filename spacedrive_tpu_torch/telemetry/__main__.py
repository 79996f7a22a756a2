"""``python -m spacedrive_tpu_torch.telemetry`` — pretty-print a snapshot.

Default: render this process's own registry (useful after driving work
in-process, or to verify the vocabulary). Against a running shell:

    python -m spacedrive_tpu_torch.telemetry --url http://127.0.0.1:8080
    python -m spacedrive_tpu_torch.telemetry --url ... --job <job_id>
    python -m spacedrive_tpu_torch.telemetry --url ... --slo
    python -m spacedrive_tpu_torch.telemetry --prometheus

``--url`` fetches ``telemetry.snapshot`` (or ``telemetry.jobTrace``) over
the rspc HTTP surface; ``--prometheus`` prints the raw text exposition
instead of the table form.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import urllib.error
import urllib.request
from typing import Any


def _headers(auth: str | None) -> dict[str, str]:
    headers = {"content-type": "application/json"}
    if auth:
        headers["Authorization"] = (
            "Basic " + base64.b64encode(auth.encode()).decode())
    return headers


def _fetch(url: str, key: str, arg: Any = None,
           auth: str | None = None) -> Any:
    req = urllib.request.Request(
        f"{url.rstrip('/')}/rspc/{key}",
        data=json.dumps({"arg": arg}).encode(),
        headers=_headers(auth), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        # the shell wraps rspc/auth errors as 4xx JSON bodies — surface
        # the message, not a urllib traceback
        try:
            detail = json.loads(e.read().decode()).get("error", str(e))
        except Exception:
            detail = str(e)
        raise SystemExit(f"{key}: {detail}")
    if "error" in body:
        raise SystemExit(f"{key}: {body['error']}")
    return body["result"]


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels.items()) + "}"


def _fmt_value(v: Any) -> str:
    # defensive: a snapshot can carry inf/NaN gauges (a rate computed over
    # a zero interval) or a missing value — the pretty-printer must render
    # them, never raise (int(inf) is an OverflowError)
    try:
        if isinstance(v, float) and v == int(v):
            return str(int(v))
    except (OverflowError, ValueError):
        return str(v)
    if not isinstance(v, (int, float)):
        return str(v)
    return f"{v:.6g}"


def _bucket_quantiles(buckets: dict[str, Any]) -> dict[float, float] | None:
    """p50/p95/p99 estimates from a snapshot's bucket dict (keys are the
    stringified boundaries + '+Inf'); None when the shape is unusable —
    the pretty-printer must render any snapshot, never raise."""
    try:
        pairs = sorted((float(k), int(v)) for k, v in buckets.items()
                       if k != "+Inf")
        if not pairs:
            return None
        boundaries = tuple(b for b, _ in pairs)
        counts = [c for _, c in pairs] + [int(buckets.get("+Inf", 0))]
        if sum(counts) == 0:
            return None
        from .registry import estimate_quantiles

        return estimate_quantiles(boundaries, counts)
    except (TypeError, ValueError):
        return None


def print_snapshot(snap: dict[str, Any], out=None) -> None:
    # out resolved at CALL time, never bound at import (a def-time
    # sys.stdout freezes whatever stream was active when this module
    # first imported — pytest capture objects die between tests)
    out = out if out is not None else sys.stdout
    print(f"telemetry {'ENABLED' if snap.get('enabled') else 'OFF'}",
          file=out)
    metrics = snap.get("metrics", {})
    for name in sorted(metrics):
        fam = metrics[name]
        series = fam.get("series") or []
        print(f"\n{name} ({fam.get('type', '?')})"
              + (f" — {fam['help']}" if fam.get("help") else ""), file=out)
        if not series:
            # a labeled family after a registry reset has a declared name
            # but no live series — render it empty rather than skipping
            # (the catalogue stays visible) and never raise on it
            print("  (no live series)", file=out)
            continue
        for s in series:
            lbl = _fmt_labels(s.get("labels", {}))
            if fam.get("type") == "histogram":
                count = s.get("count", 0)
                total = s.get("sum", 0.0)
                mean = total / count if count else 0.0
                quantiles = ""
                q = _bucket_quantiles(s.get("buckets") or {})
                if q is not None:
                    quantiles = (f" p50={q[0.5]:.4f}s p95={q[0.95]:.4f}s "
                                 f"p99={q[0.99]:.4f}s")
                print(f"  {lbl or '(all)':40s} count={count} "
                      f"sum={_fmt_value(total)}s mean={mean:.4f}s"
                      f"{quantiles}", file=out)
            else:
                print(f"  {lbl or '(all)':40s} "
                      f"{_fmt_value(s.get('value'))}", file=out)
    events = snap.get("events") or []
    if events:
        print("\nevents:", file=out)
        for e in events[-16:]:
            extra = {k: v for k, v in e.items() if k not in ("name", "unix")}
            print(f"  {e['name']}"
                  + (f" {extra}" if extra else ""), file=out)
    traces = snap.get("recent_traces") or []
    if traces:
        print("\nrecent traces:", file=out)
        for t in traces:
            print(f"  {t['trace_id'][:8]} {t['name']} "
                  f"{t['duration_s']:.3f}s "
                  f"({sum(int(s['count']) for s in t['spans'].values())} "
                  f"spans)", file=out)


def print_tree(node: dict[str, Any], depth: int = 0, out=None) -> None:
    out = out if out is not None else sys.stdout  # call-time, like above
    pad = "  " * depth
    marker = "·" if node.get("event") else "—"
    attrs = node.get("attrs") or {}
    extra = f"  {attrs}" if attrs else ""
    print(f"{pad}{node['name']} {marker} {node.get('duration_s', 0):.4f}s"
          f"{extra}", file=out)
    for child in node.get("children", []):
        print_tree(child, depth + 1, out)


def _follow(url: str, auth: str | None = None, after: int | None = None,
            as_json: bool = False, out=sys.stdout) -> int:
    """Tail ``GET /telemetry/stream`` (SSE): print one line per event.
    Returns when the server closes the stream (shutdown) or on Ctrl-C."""
    query = f"?after={after}" if after is not None else ""
    req = urllib.request.Request(
        f"{url.rstrip('/')}/telemetry/stream{query}", headers=_headers(auth))
    try:
        resp = urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        raise SystemExit(f"/telemetry/stream: {e}")
    try:
        for raw in resp:
            line = raw.decode("utf-8", "replace").rstrip("\n")
            if not line.startswith("data: "):
                continue  # id:/keepalive framing
            if as_json:
                print(line[len("data: "):], file=out, flush=True)
                continue
            try:
                record = json.loads(line[len("data: "):])
            except json.JSONDecodeError:
                continue
            extra = {k: v for k, v in record.items()
                     if k not in ("name", "unix", "seq")}
            print(f"[{record.get('seq', '?')}] {record.get('name', '?')}"
                  + (f" {extra}" if extra else ""), file=out, flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        resp.close()
    return 0


def _print_profile(target: str, data_dir: str, top: int = 20,
                   out=None) -> int:
    """``--profile <job_id|span>``: top folded stacks for a span name (or
    prefix), or per-span sample totals for a trace/job id prefix — read
    from the ``.folded``/``.traces.json`` exports under
    ``<data-dir>/logs/profiles/`` (telemetry/profiler.py)."""
    from .profiler import load_folded, load_trace_totals

    # resolved at CALL time: an ``out=sys.stdout`` default would freeze
    # whatever stdout was at first import (pytest capture objects die
    # between tests)
    out = out if out is not None else sys.stdout

    folded = load_folded(data_dir)
    if not folded:
        print(f"no profile exports under {data_dir!r} (run with "
              f"SD_PROFILE_HZ set; exports land at shutdown)",
              file=sys.stderr)
        return 1
    by_span = [(key, n) for key, n in folded.items()
               if key.split(";", 1)[0].startswith(target)]
    if by_span:
        total = sum(n for _k, n in by_span)
        print(f"{len(by_span)} stacks, {total} samples under span "
              f"'{target}*':", file=out)
        for key, n in sorted(by_span, key=lambda kv: -kv[1])[:top]:
            span, _, stack = key.partition(";")
            frames = stack.split(";")
            tail = ";".join(frames[-4:]) if len(frames) > 4 else stack
            print(f"  {n:6d}  [{span}] …{tail}", file=out)
        return 0
    traces = load_trace_totals(data_dir)
    matches = {t: spans for t, spans in traces.items()
               if t.startswith(target)}
    if matches:
        for trace_id, spans_ in sorted(matches.items()):
            total = sum(spans_.values())
            print(f"trace {trace_id}: {total} samples", file=out)
            for span, n in sorted(spans_.items(), key=lambda kv: -kv[1]):
                print(f"  {n:6d}  {span} ({n / total:.0%})", file=out)
        return 0
    known = sorted({k.split(';', 1)[0] for k in folded})
    print(f"no span or trace matching {target!r}; spans seen: "
          f"{', '.join(known)}", file=sys.stderr)
    return 1


def _print_slo(status: dict[str, Any], out=None) -> int:
    """``--slo``: render ``telemetry.sloStatus`` — one block per
    objective (SLI, budget remaining, burn per window, firing pairs)
    plus the dispatch-admission budget line."""
    out = out if out is not None else sys.stdout  # call-time, like above
    objectives = status.get("objectives") or []
    if not objectives:
        print("no SLO objectives configured", file=out)
    for o in objectives:
        scope = (f"proc={o['proc']}" if o.get("proc")
                 else f"tenant={o['tenant']}" if o.get("tenant")
                 else "all dispatches")
        firing = [p for p, f in (o.get("firing") or {}).items() if f]
        print(f"\n{o['name']} ({scope}): {o['target']:.2%} under "
              f"{o['threshold_s'] * 1000:.0f} ms over "
              f"{o['window_s'] / 3600:.1f} h", file=out)
        sli = o.get("sli")
        print(f"  sli={sli:.4%}  good={_fmt_value(o.get('good'))} "
              f"valid={_fmt_value(o.get('valid'))}  "
              f"budget_remaining={o.get('budget_remaining', 0) * 100:.1f}%",
              file=out)
        burns = o.get("burn") or {}
        if burns:
            rendered = "  ".join(f"{w}={r:g}x" for w, r in burns.items())
            print(f"  burn: {rendered}", file=out)
        print(f"  firing: {', '.join(firing) if firing else 'none'}",
              file=out)
    admission = status.get("dispatch_admission")
    if admission is not None:
        print(f"\ndispatch admission: {admission.get('in_flight', 0)}/"
              f"{admission.get('budget_inflight', 0)} in flight, "
              f"{admission.get('tenants_in_flight', 0)} tenants, "
              f"{_fmt_value(admission.get('shed', 0))} shed", file=out)
    else:
        print("\ndispatch admission: off (SD_RSPC_ADMISSION=0)", file=out)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m spacedrive_tpu_torch.telemetry",
        description="pretty-print a telemetry snapshot or job trace")
    parser.add_argument("--url", default=None,
                        help="running shell to query (default: this "
                             "process's own registry)")
    parser.add_argument("--auth", default=None, metavar="USER:PASSWORD",
                        help="basic-auth credentials for a shell started "
                             "with --auth")
    parser.add_argument("--job", default=None,
                        help="print the span tree of this job id instead "
                             "of the metrics snapshot")
    parser.add_argument("--data-dir", default=None,
                        help="with --job and no --url: read the exported "
                             "JSONL under <data-dir>/logs/traces/")
    parser.add_argument("--prometheus", action="store_true",
                        help="print the raw Prometheus text exposition")
    parser.add_argument("--json", action="store_true",
                        help="print the raw JSON instead of the table")
    parser.add_argument("--follow", action="store_true",
                        help="with --url: tail the node's live event "
                             "stream (GET /telemetry/stream, SSE) — job "
                             "transitions, fault firings, "
                             "sync sessions, alert edges, SLO burn edges "
                             "(slo.burn), admission sheds (rspc.shed), "
                             "pool resizes (pool.resize); Ctrl-C to stop")
    parser.add_argument("--slo", action="store_true",
                        help="render telemetry.sloStatus: each objective's "
                             "live SLI, error-budget remaining, multi-"
                             "window burn rates and firing pairs, plus the "
                             "dispatch-admission budget (without --url: "
                             "evaluated once against this process's own "
                             "registry)")
    parser.add_argument("--after", type=int, default=None, metavar="SEQ",
                        help="with --follow: replay ring events newer "
                             "than this sequence number first")
    parser.add_argument("--profile", default=None, metavar="JOB_OR_SPAN",
                        help="pretty-print top folded stacks for a span "
                             "name/prefix (e.g. pipeline.hash), or "
                             "per-span sample totals for a trace/job id "
                             "prefix — reads the SD_PROFILE_HZ exports "
                             "under <data-dir>/logs/profiles/")
    args = parser.parse_args(argv)

    from . import job_trace, render_prometheus, snapshot

    if args.profile:
        return _print_profile(args.profile, args.data_dir or ".")

    if args.follow:
        if not args.url:
            parser.error("--follow needs --url (it tails a RUNNING shell; "
                         "an in-process registry has no live producer)")
        return _follow(args.url, auth=args.auth, after=args.after,
                       as_json=args.json)

    if args.slo:
        if args.url:
            status = _fetch(args.url, "telemetry.sloStatus", auth=args.auth)
        else:
            # no live shell: evaluate the configured objectives once
            # against this process's own registry (useful after driving
            # work in-process, same spirit as the default snapshot)
            from .slo import SloEngine

            status = {"objectives": SloEngine().evaluate_once(),
                      "dispatch_admission": None}
        if args.json:
            print(json.dumps(status, indent=2, default=str))
            return 0
        return _print_slo(status)

    if args.job:
        if args.url:
            tree = _fetch(args.url, "telemetry.jobTrace", args.job,
                          auth=args.auth)
        else:
            tree = job_trace(args.job, data_dir=args.data_dir)
        if tree is None:
            print(f"no trace recorded for job {args.job!r}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(tree, indent=2, default=str))
        else:
            print_tree(tree)
        return 0

    if args.prometheus:
        if args.url:
            req = urllib.request.Request(
                f"{args.url.rstrip('/')}/metrics",
                headers=_headers(args.auth))
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    sys.stdout.write(resp.read().decode())
            except urllib.error.HTTPError as e:
                raise SystemExit(f"/metrics: {e}")
        else:
            sys.stdout.write(render_prometheus())
        return 0

    snap = (_fetch(args.url, "telemetry.snapshot", auth=args.auth)
            if args.url else snapshot())
    if args.json:
        print(json.dumps(snap, indent=2, default=str))
    else:
        print_snapshot(snap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
