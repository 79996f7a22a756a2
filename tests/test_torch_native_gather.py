"""The port's native cas gather (spacedrive_tpu_torch/native/) against the
JAX package's, on the CPU.

- Rows: ``gather_batch`` rows and lengths equal the reference's
  ``cas_native.gather_batch`` and ``read_sampled_batch`` byte for byte, at
  the sampling edges (1 B, 16 KiB + 3, 100 KiB, 100 KiB + 1, an odd tail, a
  sparse 300 MiB file), on the ring (8 files or more), on pread threads
  (``SD_NO_URING=1``, fewer than 8 files) and at gather depths 1 and 4096.
- Errors: a vanished file, a file that shrank after its stat and a row
  stride too short route as the reference's ``read_sampled_batch_fast``
  routes them (the same bytes, or the same exception type and errno).
- An armed ``gather`` fault seam routes the batch through the Python path in
  both packages; the thread autotune's EWMA follows the reference's.
- The scan goes through the native gather and writes the JAX Node's rows;
  the fused ``DeviceHasher.hash_batch`` equals ``generate_cas_id``.
"""

import collections
import errno
import os
import sys
import threading

import numpy as np
import pytest
import torch

from spacedrive_tpu import faults as jax_faults
from spacedrive_tpu.native import cas_native as jax_native
from spacedrive_tpu.objects import cas as jax_cas
from spacedrive_tpu_torch import faults
from spacedrive_tpu_torch.native import NativeBuildError, build_shared, cas_native
from spacedrive_tpu_torch.objects import cas, hasher
from spacedrive_tpu_torch.objects.hasher import DeviceHasher
from tests.test_torch_scan import jax_scan, port_scan
from tests.torch_scan_cases import make_tree, one_torch_thread  # noqa: F401

#: the sampling edges: whole-file messages, the 100 KiB switch, a sampled
#: file whose samples end on an odd tail
SIZES = (1, 5000, 16 * 1024 + 3, 102400, 102401, 300_007, 150_001, 777)
STRIDE = 102464  # the longest message, 102,408 B, to a 64-byte boundary


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """SIZES as files, then a sparse 300 MiB file with only its samples
    written."""
    root = tmp_path_factory.mktemp("gather")
    paths = []
    for i, size in enumerate(SIZES):
        path = root / f"f{i}.bin"
        path.write_bytes(blob(i, size))
        paths.append(str(path))
    sparse = root / "sparse.bin"
    size = 300 << 20
    with open(sparse, "wb") as fh:
        fh.truncate(size)
        for k, (off, ln) in enumerate(cas.sample_offsets(size)):
            fh.seek(off)
            fh.write(blob(100 + k, ln))
    paths.append(str(sparse))
    return paths


def sizes_of(paths):
    return [os.path.getsize(p) for p in paths]


def gather_both(paths, sizes, stride=STRIDE):
    """(port rows, port lengths, port path), (reference rows, lengths)."""
    out = []
    for module in (cas_native, jax_native):
        rows = np.full((len(paths), stride), 0xAB, np.uint8)
        lengths = np.full(len(paths), -1, np.int32)
        path = module.gather_batch(paths, sizes, rows, lengths)
        out.append((rows, lengths, path))
    return out


def test_build_is_named_by_the_source_hash_and_raises_without_gxx(monkeypatch):
    lib = build_shared("sdcasgather", ["cas_gather.cc"])
    assert lib.exists() and lib.parent.name == "_build"
    assert build_shared("sdcasgather", ["cas_gather.cc"]) == lib
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(NativeBuildError, match="g\\+\\+ not found"):
        build_shared("sdnothere", ["cas_gather.cc"])  # a new name: not built yet


@pytest.mark.parametrize("env, take, path", [
    ({}, None, "ring"),
    ({"SD_NO_URING": "1"}, None, "threads"),
    ({}, 5, "threads"),
    ({"SD_CAS_GATHER_DEPTH": "1"}, None, "ring"),
    ({"SD_CAS_GATHER_DEPTH": "4096"}, None, "ring"),
], ids=["ring", "no-uring", "under-8", "depth-1", "depth-4096"])
def test_rows_equal_the_reference(monkeypatch, files, env, take, path):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    paths = files[:take]
    sizes = sizes_of(paths)
    (rows, lengths, served), (ref_rows, ref_lengths, _) = gather_both(paths, sizes)
    assert served == path
    assert np.array_equal(lengths, ref_lengths)
    assert np.array_equal(rows, ref_rows)
    messages = jax_cas.read_sampled_batch(paths, sizes)
    for i, msg in enumerate(messages):
        assert lengths[i] == len(msg) == cas.message_len(sizes[i])
        assert rows[i, : lengths[i]].tobytes() == msg
        pad = -len(msg) % 64  # zeroed to the block boundary
        assert not rows[i, len(msg) : len(msg) + pad].any()


def test_fast_gather_equals_both_gathers(files):
    sizes = sizes_of(files)
    before = sum(cas_native.GATHER_BATCHES.values())
    got = cas.read_sampled_batch_fast(files, sizes)
    assert got == jax_cas.read_sampled_batch_fast(files, sizes)
    assert got == cas.read_sampled_batch(files, sizes)
    assert sum(cas_native.GATHER_BATCHES.values()) == before + 1
    assert cas.read_sampled_batch_fast([], []) == []


def same_items(a, b) -> bool:
    """Bytes equal, or exceptions of one type and errno."""
    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b) and getattr(a, "errno", None) == getattr(b, "errno", None)
    return a == b


@pytest.mark.parametrize("n", [3, 9], ids=["threads", "ring"])
def test_vanished_and_shrunk_files_route_like_the_reference(tmp_path, n):
    paths = []
    for i in range(n):
        path = tmp_path / f"f{i}.bin"
        path.write_bytes(blob(i, 120_000 if i % 2 else 3000))
        paths.append(str(path))
    sizes = sizes_of(paths)
    os.unlink(paths[0])          # vanished after its stat
    sizes[1] += 50_000           # shrank after its stat: sampled
    sizes[2] += 10               # shrank after its stat: whole file
    rereads = cas.PYTHON_ROUTES["reread"]
    got = cas.read_sampled_batch_fast(paths, sizes)
    want = jax_cas.read_sampled_batch_fast(paths, sizes)
    assert all(same_items(a, b) for a, b in zip(got, want))
    assert isinstance(got[0], FileNotFoundError) and got[0].errno == errno.ENOENT
    assert isinstance(got[1], EOFError) and isinstance(got[2], EOFError)
    assert not any(isinstance(m, Exception) for m in got[3:])
    assert cas.PYTHON_ROUTES["reread"] == rereads + 3


def test_a_row_stride_too_short(monkeypatch, files):
    """A row the stride cannot hold gets length 0 in both gathers; in the
    fast gather of sampled files (the stride sized from a sampled message
    length shrunk in both packages) the Python path re-reads every row, and
    the messages still agree."""
    sizes = sizes_of(files)
    (rows, lengths, _), (ref_rows, ref_lengths, _) = gather_both(files, sizes, stride=4096)
    assert np.array_equal(lengths, ref_lengths) and np.array_equal(rows, ref_rows)
    assert [int(n) for n in lengths] == [cas.message_len(s) if cas.message_len(s) <= 4096 else 0
                                         for s in sizes]
    monkeypatch.setattr(cas, "SAMPLED_MESSAGE_LEN", 1000)
    monkeypatch.setattr(jax_cas, "SAMPLED_MESSAGE_LEN", 1000)
    sampled = [p for p, s in zip(files, sizes) if s > cas.MINIMUM_FILE_SIZE]
    sizes = sizes_of(sampled)
    rereads = cas.PYTHON_ROUTES["reread"]
    got = cas.read_sampled_batch_fast(sampled, sizes)
    assert got == jax_cas.read_sampled_batch_fast(sampled, sizes)
    assert got == jax_cas.read_sampled_batch(sampled, sizes)
    assert cas.PYTHON_ROUTES["reread"] - rereads == len(sampled) == 4


def test_an_armed_gather_seam_routes_the_batch_through_python(files):
    sizes = sizes_of(files)
    faults.install("gather:eio:once")
    jax_faults.install("gather:eio:once")
    routed = cas.PYTHON_ROUTES["seam_armed"]
    batches = sum(cas_native.GATHER_BATCHES.values())
    try:
        got = cas.read_sampled_batch_fast(files, sizes)
        want = jax_cas.read_sampled_batch_fast(files, sizes)
        assert faults.fired() == jax_faults.fired() == {"gather:eio": 1}
    finally:
        faults.clear()
        jax_faults.clear()
    assert got == want == cas.read_sampled_batch(files, sizes)  # retried clean
    assert cas.PYTHON_ROUTES["seam_armed"] == routed + 1
    assert sum(cas_native.GATHER_BATCHES.values()) == batches


def test_fault_spec_grammar():
    plan = faults.install("gather:eio:once; chunk:eio")
    try:
        for _ in range(3):
            with pytest.raises(OSError):
                faults.inject("chunk", key="x")
        with pytest.raises(OSError) as info:
            faults.inject("gather", key="p")
        assert info.value.errno == errno.EIO and "p" in str(info.value)
        faults.inject("gather", key="p")  # once: fired already
        assert plan.fired() == {"gather:eio": 1, "chunk:eio": 3}
        assert not faults.seam_armed("commit")
    finally:
        faults.clear()
    faults.inject("gather")  # disarmed: nothing
    for bad in ("", "gather", "gather:hang", "gather:eio:2", "gather:eio:x", "gather:kill:skip"):
        with pytest.raises(faults.FaultSpecError):
            faults.install(bad)


def test_concurrent_gathers_keep_their_rows_and_counts(files):
    """More gathering threads than cores (the scan runs one per shard, each
    with its own pread threads or ring), a short switch interval: every
    batch returns its own rows, and no count is lost."""
    sizes = sizes_of(files)
    want = cas.read_sampled_batch(files, sizes)
    before = sum(cas_native.GATHER_BATCHES.values())
    results: list = []
    n_threads, rounds = 2 * (os.cpu_count() or 1) + 2, 4

    def work(k: int) -> None:
        for _ in range(rounds):
            order = files[k % len(files):] + files[: k % len(files)]
            got = cas.read_sampled_batch_fast(order, sizes_of(order))
            results.append(got == [want[files.index(p)] for p in order])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == [True] * (n_threads * rounds)
    assert sum(cas_native.GATHER_BATCHES.values()) == before + n_threads * rounds


def test_thread_autotune_follows_the_reference(monkeypatch):
    monkeypatch.setattr(cas_native, "_ewma_us", None)
    monkeypatch.setattr(jax_native, "_ewma_us", None)
    monkeypatch.delenv("SD_CAS_GATHER_THREADS", raising=False)
    ns = (1, 3, 8, 100, 5000)

    def both(n):
        return cas_native._default_gather_threads(n), jax_native._default_gather_threads(n)

    assert all(a == b for a, b in map(both, ns))  # cold start
    for wall_s, n, threads in ((0.5, 2048, 16), (0.0, 10, 2), (0.002, 100, 4), (1.0, 0, 3),
                               (0.03, 512, 8), (2e-5, 8, 2)):
        cas_native._observe_gather(wall_s, n, threads)
        jax_native._observe_gather(wall_s, n, threads)
        assert cas_native._ewma_us == pytest.approx(jax_native._ewma_us, rel=0, abs=0)
        assert all(a == b for a, b in map(both, ns))
    for raw in ("3", "0", "junk", "64"):
        monkeypatch.setenv("SD_CAS_GATHER_THREADS", raw)
        assert all(a == b for a, b in map(both, ns))


def test_scan_goes_through_the_native_gather_and_matches_jax(tmp_path, monkeypatch):
    tree = make_tree(tmp_path / "tree")
    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_CDC_KERNEL", "numpy")
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    want = jax_scan(tmp_path / "jax", tree)
    cas_native.reset_counts()
    routes = collections.Counter(cas.PYTHON_ROUTES)
    got = port_scan(tmp_path / "port", tree)
    assert sum(cas_native.GATHER_BATCHES.values()) > 0
    assert cas.PYTHON_ROUTES == routes  # no file re-read, no batch routed
    assert got == want


def test_fused_hash_batch_equals_the_oracle(tmp_path, monkeypatch):
    """Sampled files in sub-batches of 2 (three batches: the double buffer
    collects each a step late), small files bucketed, a vanished file of
    each class as its error."""
    monkeypatch.setattr(hasher, "PIPELINE_BATCH", 2)
    sizes = (102_401, 7, 0, 250_000, 4096, 1 << 20, 99_999, 150_000, 131_072)
    paths = []
    for i, size in enumerate(sizes):
        path = tmp_path / f"f{i}"
        path.write_bytes(blob(50 + i, size))
        paths.append(str(path))
    want = [cas.generate_cas_id(p) for p in paths]
    got = DeviceHasher(torch.device("cpu")).hash_batch(paths, list(sizes))
    assert got == want
    os.unlink(paths[0])
    os.unlink(paths[1])
    got = DeviceHasher(torch.device("cpu")).hash_batch(paths, list(sizes))
    assert isinstance(got[0], OSError) and isinstance(got[1], FileNotFoundError)
    assert got[2:] == want[2:]
