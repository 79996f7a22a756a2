"""Trace propagation and convergence lag across the two packages.

- ``TraceContext``: a context built by either package travels as the same
  5-key wire dict and decodes in the other; a malformed envelope decodes to
  None in both. ``peer_label`` and ``span_id_base`` are equal.
- A port node and a JAX node over loopback TCP (as in
  ``tests/test_torch_p2p_jax.py``): a tag written on either side reaches
  the other in a sync session. The originator exports the session's root
  and window spans, the responder its ``sync.apply`` spans without a root;
  the two JSONL files stitch into one tree by ``trace_id``, every apply
  span under one of the sender's window spans, and each receiver's
  ``sd_sync_peer_lag_ops`` for the sender is back to 0 once the rows are
  equal.
"""

from __future__ import annotations

import json
import random

import pytest

from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu.models import Tag as JaxTag
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.telemetry import mesh as jax_mesh
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.models import Tag
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.telemetry import mesh, spans
from tests.torch_p2p_cases import addr_of, count, wait_for
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

pytest.importorskip("cryptography")

WIRES = [
    {"t": "sync-abc-123", "s": 5, "o": "node-a", "h": 1 << 40, "p": 7},
    {"t": "sync-abc-123", "s": 0, "o": "", "h": 0},
    {"t": "job.x_y-z", "s": 1 << 40, "o": 3, "h": -1, "p": -2},
    {"t": "../etc", "s": 1},
    {"t": "a" * 129, "s": 1},
    {"t": "ok", "s": True},
    {"t": "ok", "s": -1},
    {"t": "ok"},
    {"s": 3},
    ["t", "s"],
    None,
    {"t": "ok", "s": 2, "h": True, "p": False},
]


def _fields(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.origin, ctx.hlc,
                                     ctx.pending)


@pytest.mark.parametrize("wire", WIRES, ids=[str(i) for i in range(len(WIRES))])
def test_a_wire_envelope_decodes_the_same_in_both_packages(wire):
    assert _fields(mesh.TraceContext.from_wire(wire)) == \
        _fields(jax_mesh.TraceContext.from_wire(wire))


def test_contexts_cross_in_both_directions():
    rng = random.Random(3)
    for _ in range(50):
        args = (f"sync-{rng.getrandbits(32):08x}", rng.getrandbits(40),
                f"node-{rng.getrandbits(16)}", rng.getrandbits(63),
                rng.choice([None, 0, rng.getrandbits(20)]))
        ours, theirs = mesh.TraceContext(*args), jax_mesh.TraceContext(*args)
        assert ours.to_wire() == theirs.to_wire()
        assert json.dumps(ours.to_wire()) == json.dumps(theirs.to_wire())
        assert _fields(jax_mesh.TraceContext.from_wire(ours.to_wire())) == _fields(ours)
        assert _fields(mesh.TraceContext.from_wire(theirs.to_wire())) == _fields(theirs)


def test_peer_labels_and_span_id_bases_are_equal():
    rng = random.Random(4)
    idents = [None, "", "x", "ünïcode"] + [rng.randbytes(32).hex() for _ in range(50)]
    for ident in idents:
        assert mesh.peer_label(ident) == jax_mesh.peer_label(ident)
        assert mesh.span_id_base(ident) == jax_mesh.span_id_base(ident)


# -- a sync session across the packages ---------------------------------------------

@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.delenv("SD_P2P_DISABLED", raising=False)
    mp.setenv("SD_SERVE_WORKERS", "0")
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.set_enabled(True)
    base = tmp_path_factory.mktemp("mesh-telemetry")
    jax = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
    port = Node(base / "port", device="cpu", watch_locations=False)
    try:
        for node in (jax, port):
            assert node.p2p is not None
            node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
        lib_p = port.libraries.create("mesh")
        port.config.write(p2p_auto_accept_library=lib_p.id)
        jax.router.resolve("p2p.pair", {"peer_id": addr_of(port)})
        lib_j = wait_for(lambda: next((x for x in jax.libraries.list() if x.id == lib_p.id),
                                      None), msg="the JAX mirror of the port library")
        yield {"jax": jax, "port": port, "lib_p": lib_p, "lib_j": lib_j}
    finally:
        port.shutdown()
        jax.shutdown()
        mp.undo()


def _records(data_dir) -> dict:
    """trace_id -> records of every exported session trace under data_dir."""
    out: dict = {}
    for path in spans.traces_dir(data_dir).glob("sync-*.jsonl"):
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            out.setdefault(rec["trace_id"], []).append(rec)
    return out


def _stitched(sender_dir, receiver_dir) -> list[tuple[list, list]]:
    """(sender's records, receiver's records) of every session trace that
    both nodes exported."""
    sent, got = _records(sender_dir), _records(receiver_dir)
    return [(sent[t], got[t]) for t in sorted(set(sent) & set(got))]


def _lag_back_to_zero(tel, label: str) -> bool:
    values = dict((lbl["peer"], v) for lbl, v in tel.series_values("sd_sync_peer_lag_ops"))
    return label in values and values[label] == 0


@pytest.mark.parametrize("origin", ["port", "jax"])
def test_a_session_stitches_by_trace_id_and_the_lag_settles(paired, origin):
    jax, port, lib_p, lib_j = paired["jax"], paired["port"], paired["lib_p"], paired["lib_j"]
    n0 = count(lib_p.db, "tag")
    if origin == "port":
        lib_p.sync.write_ops([lib_p.sync.shared_create(Tag, "port-tag", {"name": "p"})],
                             lambda db: db.insert(Tag, {"pub_id": "port-tag", "name": "p"}))
        sender, receiver, tel_r = port, jax, jax_telemetry
    else:
        lib_j.sync.write_ops([lib_j.sync.shared_create(JaxTag, "jax-tag", {"name": "j"})],
                             lambda db: db.insert(JaxTag, {"pub_id": "jax-tag", "name": "j"}))
        sender, receiver, tel_r = jax, port, telemetry
    wait_for(lambda: count(lib_p.db, "tag") == count(lib_j.db, "tag") == n0 + 1, timeout=30,
             msg="the tag on both nodes")
    label = (jax_mesh if tel_r is jax_telemetry else mesh).peer_label(
        sender.p2p.remote_identity.encode())
    wait_for(lambda: _lag_back_to_zero(tel_r, label), timeout=30, msg="the lag back to 0")

    def stitched():
        pairs = _stitched(sender.data_dir, receiver.data_dir)
        return [p for p in pairs if any(r["name"] == "sync.apply" for r in p[1])]

    pairs = wait_for(stitched, timeout=30, msg="both halves of a session exported")
    sent, got = pairs[-1]
    roots = [r for r in sent + got if r["parent_id"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "sync.push"
    windows = {r["span_id"] for r in sent if r["name"] == "sync.window"}
    applies = [r for r in got if r["name"] == "sync.apply"]
    assert windows and applies and all(a["parent_id"] in windows for a in applies)
    assert not {r["span_id"] for r in sent} & {r["span_id"] for r in got}
    tree = spans.build_tree(roots[0]["trace_id"], sent + got)
    nested = [c for w in tree["children"] if w["name"] == "sync.window"
              for c in w["children"] if c["name"] == "sync.apply"]
    assert len(nested) == len(applies)
    # the receiver counts the session after it exported its half
    wait_for(lambda: tel_r.value("sd_sync_remote_sessions_total", peer=label) >= 1,
             msg="the session counted")
