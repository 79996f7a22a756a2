"""The port's telemetry core against the JAX package's, on the CPU.

- The registry: one seeded script of counter, gauge and histogram calls on
  a fresh registry of each package renders the same Prometheus text, byte
  for byte, and ``estimate_quantiles`` gives the same estimates.
- The scan's trace: the same tree is scanned pipelined by a JAX node and a
  port node with 16-file pages, with one gather shard and with four. The
  identify jobs' trees have the same span names, with the same count for
  each. In the port: pages = hashes = ``pipeline_batches``, commits =
  ``commit_txns``, every ``identifier.gather`` sits directly inside its
  page (one for each slice of the page; the JAX package's tree nests none
  there when the pages are sharded, since its gather threads open the span
  under the slice's ``pipeline.gather``), each stage's span sum is within
  5% of the report's ``pipeline_*_s``, and the exported JSONL rebuilds the
  tree.
- Telemetry off: a disabled registry records nothing, there is no trace,
  and the scan still reports its stage timings.
- Chaos: the fault and quarantine counters equal what the run's fault plan
  and report say.
"""

from __future__ import annotations

import random
from pathlib import Path

import pytest

from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import file_identifier as jax_fi
from spacedrive_tpu.pipeline import executor as jax_executor
from spacedrive_tpu.telemetry.registry import Registry as JaxRegistry
from spacedrive_tpu.telemetry.registry import estimate_quantiles as jax_estimate_quantiles
from spacedrive_tpu_torch import faults, telemetry
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import JobRow, Location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import file_identifier as fi
from spacedrive_tpu_torch.pipeline import executor
from spacedrive_tpu_torch.telemetry import spans
from spacedrive_tpu_torch.telemetry.registry import (LOCK_BUCKETS, REQUEST_BUCKETS, Registry,
                                                     estimate_quantiles)
from tests.torch_scan_cases import PAGE, make_tree, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_registries():
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.set_enabled(True)
    yield
    faults.clear()
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.reload_enabled()


# -- the registry --------------------------------------------------------------

def _script(reg, seed: int) -> str:
    """A seeded run of record calls on ``reg``; its Prometheus text."""
    rng = random.Random(seed)
    fams = [
        reg.counter("sd_parity_ops_total", "ops by kind", labels=("kind",)),
        reg.counter("sd_parity_plain_total", "a label-less counter"),
        reg.gauge("sd_parity_depth", "queue depth\nsecond line", labels=("lane", "peer")),
        reg.histogram("sd_parity_latency_seconds", "latency", labels=("stage",)),
        reg.histogram("sd_parity_request_seconds", 'a "quoted" help \\ text',
                      buckets=REQUEST_BUCKETS),
        reg.histogram("sd_parity_lock_seconds", "locks", labels=("name",),
                      buckets=LOCK_BUCKETS),
    ]
    words = ["page", "hash", "commit", 'q"uote', "back\\slash", "new\nline"]
    for _ in range(400):
        fam = rng.choice(fams)
        labels = {n: rng.choice(words) for n in fam.label_names}
        if fam.type == "counter":
            fam.inc(rng.choice([1, 2.5, 0.125, 1e-7, 3e9]), **labels)
        elif fam.type == "gauge":
            op = rng.randrange(3)
            value = rng.uniform(-1e3, 1e3)
            (fam.set if op == 0 else fam.inc if op == 1 else fam.dec)(value, **labels)
        else:
            fam.observe(rng.choice([0.0, 1e-6, 0.001, 0.3, 7.0, 1e4, rng.random()]), **labels)
    return reg.render_prometheus()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_prometheus_text_of_one_script_is_byte_equal(seed):
    port = _script(Registry(), seed)
    assert port == _script(JaxRegistry(), seed)
    assert port.count("# TYPE ") == 6 and 'le="+Inf"' in port


def test_estimate_quantiles_equals_the_reference():
    rng = random.Random(5)
    cases = [((), [0]), ((1.0,), [0, 0]), ((0.1, 1.0), [3, 0, 4])]
    for _ in range(200):
        bounds = tuple(sorted({round(rng.uniform(0.0, 100.0), 3)
                               for _ in range(rng.randrange(1, 12))}))
        cases.append((bounds, [rng.choice([0, 0, 1, 7, 300]) for _ in range(len(bounds) + 1)]))
    for qs in ((0.5, 0.95, 0.99), (0.0, 0.25, 1.0)):
        for bounds, counts in cases:
            assert estimate_quantiles(bounds, counts, qs) == \
                jax_estimate_quantiles(bounds, counts, qs), (bounds, counts)


def test_names_labels_and_buckets_are_checked_at_declaration():
    reg = Registry()
    for bad in ("Sd_x", "sd-x", "x_total", "sd_X"):
        with pytest.raises(ValueError):
            reg.counter(bad)
    with pytest.raises(ValueError):
        reg.counter("sd_ok_total", labels=("Bad",))
    reg.histogram("sd_fixed_seconds", buckets=(0.1, 1.0))
    with pytest.raises(ValueError):
        reg.histogram("sd_fixed_seconds", buckets=(0.1, 2.0))
    with pytest.raises(ValueError):
        reg.gauge("sd_fixed_seconds")


# -- the scan's trace ------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("telemetry") / "tree")


def _env(mp, shards: int) -> None:
    """16-file pages in both packages; a commit group waits for its pages
    (the slow CPU hash must not split groups by the clock)."""
    mp.setattr(jax_fi, "BATCH_SIZE", PAGE)
    mp.setattr(fi, "BATCH_SIZE", PAGE)
    mp.setattr(jax_executor, "GROUP_LINGER_S", 60.0)
    mp.setattr(executor, "GROUP_LINGER_S", 60.0)
    mp.setenv("SD_P2P_DISABLED", "1")
    mp.setenv("SD_CDC_KERNEL", "numpy")
    mp.setenv("SD_SCAN_SHARDS", str(shards))
    for var in ("SD_PIPELINE", "SD_COMMIT_GROUP", "SD_SCAN_BATCH", "SD_SCAN_ADAPT",
                "SD_CHUNK_MANIFESTS"):
        mp.delenv(var, raising=False)


def _jax_identify(data_dir: Path, tree: Path):
    node = JaxNode(data_dir, probe_accelerator=False, watch_locations=False)
    try:
        lib = node.libraries.create("jax")
        loc = jax_create_location(lib, tree)
        args = {"location_id": loc["id"]}
        node.jobs.spawn(lib, [JaxIndexerJob(args), jax_fi.FileIdentifierJob(dict(args))])
        assert node.jobs.wait_idle(120)
        jid = lib.db.query("SELECT id FROM job WHERE name = 'file_identifier'")[0]["id"]
        return jax_telemetry.job_trace(jid, data_dir=data_dir)
    finally:
        node.shutdown()


def _port_identify(data_dir: Path, tree: Path):
    node = Node(data_dir, device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        job = lib.db.find_one(JobRow, {"name": "file_identifier"})
        tree_ = node.router.resolve("telemetry.jobTrace", job["id"])
        return tree_, job
    finally:
        node.shutdown()


@pytest.fixture(scope="module", params=[1, 4], ids=["one-shard", "four-shards"])
def traces(request, tree, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, request.param)
        for tel in (telemetry, jax_telemetry):
            tel.reset()
        base = tmp_path_factory.mktemp(f"scan-s{request.param}")
        jax_tree = _jax_identify(base / "jax", tree)
        port_tree, job = _port_identify(base / "port", tree)
    return request.param, jax_tree, port_tree, job, base / "port"


def _named(node: dict, name: str, out: list | None = None) -> list[dict]:
    out = [] if out is None else out
    if node["name"] == name:
        out.append(node)
    for child in node.get("children", []):
        _named(child, name, out)
    return out


def _counts(node: dict, out: dict | None = None) -> dict:
    out = {} if out is None else out
    out[node["name"]] = out.get(node["name"], 0) + 1
    for child in node.get("children", []):
        _counts(child, out)
    return out


def test_the_span_names_and_counts_equal_the_reference(traces):
    _shards, jax_tree, port_tree, _job, _dir = traces
    assert port_tree["name"] == jax_tree["name"] == "job.file_identifier"
    assert _counts(port_tree) == _counts(jax_tree)


def test_pages_hashes_and_commits_match_the_report(traces):
    shards, _jax, tree_, job, _dir = traces
    meta = job["metadata"]
    assert job["status"] == JobStatus.COMPLETED
    pages = _named(tree_, "pipeline.page")
    assert meta["pipeline_batches"] == 5 == len(pages) == len(_named(tree_, "pipeline.hash"))
    assert len(_named(tree_, "pipeline.commit")) == meta["commit_txns"]
    assert meta["pipeline_shards"] == str(shards)
    [run] = _named(tree_, "pipeline.run")
    assert {c["name"] for c in run["children"]} == {"pipeline.page", "pipeline.hash",
                                                    "pipeline.commit"}
    assert meta["trace"]["spans"]["pipeline.page"]["count"] == 5


def test_every_page_holds_its_gather(traces):
    """One ``identifier.gather`` directly inside each page for each of its
    slices; the JAX package's tree holds none there once pages are sharded
    (ROADMAP Queue 3, the reference's unnested gather)."""
    shards, jax_tree, tree_, _job, _dir = traces
    for page in _named(tree_, "pipeline.page"):
        gathers = [c for c in page["children"] if c["name"] == "identifier.gather"]
        slices = [c for c in page["children"] if c["name"] == "pipeline.gather"]
        assert len(gathers) == max(1, len(slices)) >= 1
        if shards == 1:
            assert len(gathers) == 1 and not slices
    jax_nested = sum(1 for p in _named(jax_tree, "pipeline.page")
                     for c in p["children"] if c["name"] == "identifier.gather")
    assert jax_nested == (5 if shards == 1 else 0)
    assert len(_named(tree_, "identifier.gather")) == len(_named(jax_tree, "identifier.gather"))


def test_stage_span_sums_reconcile_with_the_report(traces):
    _shards, _jax, tree_, job, _dir = traces
    meta = job["metadata"]
    for name, key in (("pipeline.page", "pipeline_page_s"), ("pipeline.hash", "pipeline_hash_s"),
                      ("pipeline.commit", "pipeline_commit_s"),
                      ("pipeline.run", "pipeline_wall_s")):
        total = sum(s["duration_s"] for s in _named(tree_, name))
        assert total == pytest.approx(meta[key], rel=0.05, abs=1e-5), name
    assert sum(s["duration_s"] for s in _named(tree_, "identifier.gather")) == \
        pytest.approx(meta["gather_s"], rel=0.05, abs=1e-5) or meta["pipeline_shards"] != "1"


def test_the_exported_jsonl_rebuilds_the_tree(traces):
    _shards, _jax, tree_, job, data_dir = traces
    path = spans.traces_dir(data_dir) / f"{job['id']}.jsonl"
    assert path.is_file()
    again = spans.load_trace_tree(job["id"], data_dir)

    def shape(node):
        return (node["name"], node["span_id"],
                sorted(shape(c) for c in node.get("children", [])))

    assert shape(again) == shape(tree_)
    assert spans.load_trace_tree("../escape", data_dir) is None


# -- telemetry off ----------------------------------------------------------------

def test_disabled_telemetry_records_nothing_and_the_scan_still_times(tree, tmp_path,
                                                                    monkeypatch):
    _env(monkeypatch, 4)
    telemetry.set_enabled(False)
    tree_, job = _port_identify(tmp_path / "off", tree)
    assert tree_ is None
    # the scrape may show families the boot declared, all at zero
    recorded = [line for line in telemetry.render_prometheus().splitlines()
                if not line.startswith("#") and not line.endswith(" 0")]
    assert recorded == []
    assert telemetry.recent_events() == []
    meta = job["metadata"]
    assert "trace" not in meta and meta["pipeline_batches"] == 5
    for key in ("pipeline_page_s", "pipeline_hash_s", "pipeline_commit_s", "pipeline_wall_s"):
        assert meta[key] > 0, key
    assert not (tmp_path / "off" / "logs" / "traces").exists()


# -- chaos -------------------------------------------------------------------------

def test_chaos_counters_equal_the_report(tmp_path, monkeypatch):
    """``gather:eio:skip60`` on an 80-file tree: every file whose read
    starts after the 60th hit fails its three attempts and is quarantined."""
    _env(monkeypatch, 4)
    root = tmp_path / "tree"
    root.mkdir()
    rng = random.Random(6)
    for i in range(80):
        (root / f"f{i:02d}.dat").write_bytes(rng.randbytes(500 + i))
    faults.install("gather:eio:skip60")
    try:
        _tree, job = _port_identify(tmp_path / "chaos", root)
        fired = faults.fired()
    finally:
        faults.clear()
    meta = job["metadata"]
    assert job["status"] == JobStatus.COMPLETED_WITH_ERRORS
    by_rule = {f"{lbl['seam']}:{lbl['kind']}": int(v)
               for lbl, v in telemetry.series_values("sd_faults_fired_total") if v}
    assert by_rule == fired == {"gather:eio": 3 * 20}
    assert telemetry.value("sd_quarantined_files_total") == meta["quarantined_files"] == 20
    assert telemetry.value("sd_retry_gave_up_total") == 20
    assert telemetry.value("sd_retry_attempts_total") == 40
    events = [e for e in telemetry.recent_events(limit=256) if e["name"] == "fault.fired"]
    assert len(events) == 60 and {e["seam"] for e in events} == {"gather"}
