"""Request telemetry and the catalogue of the port against the JAX package's,
on the CPU.

- The same rspc calls (queries, a mutation, a subscription, an
  ``ApiError``, a shed by the dispatch budget, an unexpected error) go to a
  JAX node and a port node: ``sd_rspc_requests_total`` by ``{proc, kind,
  outcome}`` is equal in the two packages, and so is
  ``sd_rspc_tenant_requests_total`` by ``outcome``.
- With ``SD_SLOW_REQUEST_MS=0`` a ``search.paths`` lands in the slow ring
  with its ``db.query`` spans, and ``telemetry.requestStats`` folds in the
  reader pool's ``status()``.
- The port's server shell: ``GET /metrics`` parses line by line, and an
  SSE tail of ``GET /telemetry/stream`` replays the ring, streams new
  events, and ends on a client's disconnect (its pump unregistered and
  joined) and on ``Server.stop``.
- The catalogue: the family names of the two packages' scrapes after the
  same scan, calls and sync round; the port's set is the JAX set minus the
  README's table of families the port does not declare, and equals the
  families of docs/architecture/observability.md's tables minus the same
  table; every shared family has the same type, help text, label names and
  bucket edges.
"""

from __future__ import annotations

import json
import re
import socket
import time
from pathlib import Path

import pytest

from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.models import Location as JaxLocation
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.telemetry import slo as jax_slo
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.api.router import ApiError, BusyError
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import Location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.server import Server
from spacedrive_tpu_torch.telemetry import requests as port_requests
from spacedrive_tpu_torch.telemetry import slo as port_slo
from tests.torch_scan_cases import blob, one_torch_thread  # noqa: F401
from tests.torch_serve_client import get

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """A JAX node and a port node, each with one scanned library of the
    same small tree (media off)."""
    mp = pytest.MonkeyPatch()
    for var, value in (("SD_P2P_DISABLED", "1"), ("SD_SERVE_WORKERS", "0"),
                       ("SD_RSPC_BUDGET", "1")):
        mp.setenv(var, value)
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.set_enabled(True)
    base = tmp_path_factory.mktemp("serving-telemetry")
    tree = base / "tree"
    (tree / "d").mkdir(parents=True)
    for i in range(12):
        (tree / "d" / f"note{i:02d}.txt").write_bytes(blob(i, 300 + 40 * i))
    jax = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
    port = Node(base / "port", device="cpu", watch_locations=False)
    libs = {}
    try:
        for name, node, create, scan in (("jax", jax, jax_create_location, jax_scan_location),
                                         ("port", port, create_location, scan_location)):
            lib = node.libraries.create("served")
            loc = create(lib, str(tree))
            lib.db.update(Location if name == "port" else JaxLocation,
                          {"id": loc["id"]}, {"generate_preview_media": False})
            scan(lib, loc["id"])
            assert node.jobs.wait_idle(120)
            libs[name] = lib
        yield {"jax": jax, "port": port, "libs": libs, "base": base}
    finally:
        port.shutdown()
        jax.shutdown()
        mp.undo()


CALLS = [
    ("query", "search.paths", {"search": "note", "take": 5}, True),
    ("query", "search.pathsCount", {"search": "note0"}, True),
    ("query", "locations.list", None, True),
    ("query", "libraries.list", None, False),
    ("query", "tags.get", 999, True),
    ("query", "jobs.reports", None, True),
    ("mutation", "tags.create", {"name": "t", "color": "#fff"}, True),
    ("query", "telemetry.alerts", None, False),
    ("query", "search.paths", {"search": "note", "take": 2}, True),
]


def _drive(node, lib, tenant_label) -> list[str]:
    """Run CALLS, an unknown library (ApiError), a shed (the budget of 1 held
    by the library's own tenant) and a subscription; the outcomes seen."""
    seen = []
    for _kind, key, arg, scoped in CALLS:
        try:
            node.router.resolve(key, arg, lib.id if scoped else None)
            seen.append("ok")
        except Exception as e:  # noqa: BLE001 — compared by name
            seen.append(type(e).__name__)
    try:
        node.router.resolve("search.paths", {"take": 1}, "no-such-library")
    except Exception as e:  # noqa: BLE001 — compared by name
        seen.append(type(e).__name__)
    held = node.dispatch_budget.try_admit(tenant_label(lib.id))
    try:
        node.router.resolve("locations.list", None, lib.id)
    except Exception as e:  # noqa: BLE001 — compared by name
        seen.append(type(e).__name__)
    finally:
        held.release()
    sub = node.router.subscribe("notifications.listen", None)
    sub.close()
    return seen


def _by_outcome(tel) -> dict:
    return {(lbl["proc"], lbl["kind"], lbl["outcome"]): v
            for lbl, v in tel.series_values("sd_rspc_requests_total") if v}


def test_request_counts_by_proc_kind_and_outcome_equal_the_reference(nodes):
    for tel in (telemetry, jax_telemetry):
        tel.reset()
    seen_port = _drive(nodes["port"], nodes["libs"]["port"], port_slo.tenant_label)
    seen_jax = _drive(nodes["jax"], nodes["libs"]["jax"], jax_slo.tenant_label)
    assert seen_port == seen_jax
    assert seen_port[-2:] == ["ApiError", "BusyError"] and seen_port.count("ApiError") == 2
    port = _by_outcome(telemetry)
    assert port == _by_outcome(jax_telemetry)
    assert port[("search.paths", "query", "api_error")] == 1
    assert port[("tags.get", "query", "api_error")] == 1
    assert port[("locations.list", "query", "shed")] == 1
    assert port[("notifications.listen", "subscription", "ok")] == 1
    tenants = {(lbl["outcome"]): v for lbl, v in
               telemetry.series_values("sd_rspc_tenant_requests_total") if v}
    assert tenants == {(lbl["outcome"]): v for lbl, v in
                       jax_telemetry.series_values("sd_rspc_tenant_requests_total") if v}
    assert telemetry.value("sd_rspc_shed_total", tenant=port_slo.tenant_label(
        nodes["libs"]["port"].id)) == 1
    assert telemetry.value("sd_rspc_in_flight") == 0
    assert any(e["name"] == "rspc.shed" for e in telemetry.recent_events())


def test_an_unexpected_error_counts_as_error(nodes):
    node, lib = nodes["port"], nodes["libs"]["port"]
    telemetry.reset()
    proc = node.router.procedures["locations.list"]
    original = proc.fn
    proc.fn = lambda *_a: 1 / 0
    try:
        with pytest.raises(ZeroDivisionError):
            node.router.resolve("locations.list", None, lib.id)
    finally:
        proc.fn = original
    assert telemetry.value("sd_rspc_requests_total", proc="locations.list", kind="query",
                           outcome="error") == 1


def test_a_slow_search_lands_in_the_ring_with_its_queries(nodes, monkeypatch):
    node, lib = nodes["port"], nodes["libs"]["port"]
    telemetry.reset()
    monkeypatch.setenv("SD_SLOW_REQUEST_MS", "0")
    node.router.resolve("search.paths", {"search": "note", "take": 3}, lib.id)
    [entry] = [e for e in port_requests.slow_requests() if e["proc"] == "search.paths"]
    assert entry["outcome"] == "ok" and entry["kind"] == "query"

    def names(n):
        return [n["name"]] + [x for c in n.get("children", []) for x in names(c)]

    tree = entry["tree"]
    assert tree["name"] == "rspc.search.paths"
    [resolve] = tree["children"]
    assert resolve["name"] == "rspc.resolve"
    queries = [c for c in resolve["children"] if c["name"] == "db.query"]
    assert queries and all("SELECT" in q["attrs"]["sql"].upper() for q in queries)
    assert names(tree).count("db.query") == len(queries)
    assert telemetry.value("sd_rspc_slow_requests_total", proc="search.paths") == 1
    stats = node.router.resolve("telemetry.requestStats", {"slow_limit": 4})
    assert stats["slow"][0]["proc"] == "search.paths" and stats["serve_pool"] is None
    assert stats["procedures"]["search.paths"]["count"] == 1


def test_request_stats_fold_in_the_pool(nodes):
    node = nodes["port"]

    class Pool:
        def status(self):
            return {"workers": 3, "alive": 3}

    node.reader_pool = Pool()
    try:
        assert node.router.resolve("telemetry.requestStats")["serve_pool"] == \
            {"workers": 3, "alive": 3}
    finally:
        node.reader_pool = None


# -- the shell ----------------------------------------------------------------------

@pytest.fixture()
def shell(nodes):
    server = Server(nodes["port"], "127.0.0.1", 0)
    server.start()
    try:
        yield server, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


_SAMPLE = re.compile(r'^sd_[a-z0-9_]+(\{[a-z_]+="(?:[^"\\]|\\.)*"(,[a-z_]+="(?:[^"\\]|\\.)*")*\})?'
                     r' (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def test_metrics_parses_line_by_line(nodes, shell):
    _server, url = shell
    status, headers, body = get(url, "/metrics")
    assert status == 200 and headers["content-type"].startswith("text/plain; version=0.0.4")
    lines = body.decode().splitlines()
    typed = set()
    for line in lines:
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            assert kind in ("counter", "gauge", "histogram")
            typed.add(name)
            continue
        assert _SAMPLE.match(line), line
        base = line.split("{")[0].split(" ")[0]
        assert re.sub(r"_(bucket|sum|count)$", "", base) in typed or base in typed, line
    assert "sd_rspc_requests_total" in typed and "sd_hash_mfu" in typed
    status, _h, _b = get(url, "/nowhere")
    assert telemetry.value("sd_http_requests_total", route="metrics", status="200") >= 1
    assert telemetry.value("sd_http_requests_total", route="other", status="404") >= 1


def _sse(url: str, path: str = "/telemetry/stream") -> socket.socket:
    host, port = url.split("//")[1].split(":")
    sock = socket.create_connection((host, int(port)), timeout=10)
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    return sock


def _read_until(sock: socket.socket, needle: bytes, timeout: float = 10.0) -> bytes:
    buf = b""
    deadline = time.monotonic() + timeout
    while needle not in buf:
        sock.settimeout(max(0.05, deadline - time.monotonic()))
        chunk = sock.recv(65536)
        if not chunk:
            break
        buf += chunk
        if time.monotonic() > deadline:
            break
    return buf


def _wait(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_the_sse_tail_streams_and_ends_on_disconnect(nodes, shell):
    server, url = shell
    telemetry.reset()
    telemetry.event("test.before", n=1)
    sock = _sse(url, "/telemetry/stream?after=0")
    head = _read_until(sock, b'"test.before"')
    assert head.startswith(b"HTTP/1.1 200 OK") and b"text/event-stream" in head
    assert _wait(lambda: server.sse_tails() == 1)
    telemetry.event("test.live", n=2)
    live = _read_until(sock, b'"test.live"')
    frame = live[live.rindex(b"id: "):]
    seq, data = frame.split(b"\n")[0][4:], json.loads(frame.split(b"data: ")[1].split(b"\n")[0])
    assert data["name"] == "test.live" and int(seq) == data["seq"]
    sock.close()
    assert _wait(lambda: server.sse_tails() == 0)
    assert telemetry.value("sd_http_requests_total", route="stream", status="200") == 1


def test_the_sse_tail_ends_on_server_stop(nodes):
    server = Server(nodes["port"], "127.0.0.1", 0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    sock = _sse(url)
    _read_until(sock, b"text/event-stream")
    assert _wait(lambda: server.sse_tails() == 1)
    tails = list(server._sse_tails)
    server.stop()
    assert all(not thread.is_alive() for _stop, thread, _sub in tails)
    sock.settimeout(10)
    rest = b""
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            break
        rest += chunk
    sock.close()


# -- the catalogue -------------------------------------------------------------------

def _absent_table() -> set[str]:
    text = (REPO / "README.md").read_text()
    section = text.split("Families the port does not declare", 1)[1].split("\n\n", 2)[1]
    return set(re.findall(r"^\| `(sd_[a-z0-9_]+)` \|", section, re.M))


def _declared_in(package: str) -> set[str]:
    names: set[str] = set()
    for path in (REPO / package).rglob("*.py"):
        names |= set(re.findall(r'"(sd_[a-z0-9_]+)"', path.read_text()))
    return names


def _families(tel, package: str) -> dict:
    """name -> (type, help, label names, buckets) of the families the
    package's own code declares (a test may declare its own)."""
    own = _declared_in(package)
    return {f.name: (f.type, f.help, f.label_names, f.buckets)
            for f in tel.registry().families() if f.name in own}


def _typed(text: str) -> set[str]:
    return {line.split(" ")[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def test_the_catalogue_equals_the_reference_minus_the_readme_table(nodes, shell):
    _server, url = shell
    # a sync round on each node: a library's own ops ingested by a second
    # library of the same node (both packages' ingest modules run)
    for name, node in (("jax", nodes["jax"]), ("port", nodes["port"])):
        lib = nodes["libs"][name]
        node.router.resolve("tags.create", {"name": f"sync-{name}", "color": "#000"}, lib.id)
    absent = _absent_table()
    assert len(absent) == 16
    port = _families(telemetry, "spacedrive_tpu_torch")
    jax = _families(jax_telemetry, "spacedrive_tpu")
    _s, _h, body = get(url, "/metrics")
    assert _typed(body.decode()) & _declared_in("spacedrive_tpu_torch") == set(port)
    assert _typed(jax_telemetry.render_prometheus()) >= set(jax)
    assert not absent & set(port)
    assert set(port) == set(jax) - absent
    for name, spec in port.items():
        assert spec == jax[name], name
    doc = set()
    for line in (REPO / "docs/architecture/observability.md").read_text().splitlines():
        if line.startswith("|"):
            doc |= set(re.findall(r"sd_[a-z0-9_]+", line))
    assert absent <= doc
    assert set(port) == doc - absent
