"""The port's gather retries and payload cap against the JAX package's.

The cas message read (``objects/cas.py`` ``read_sampled_batch``) and the
chunk payload read (``objects/manifest.py`` ``pipeline_chunk_gather``) retry
EINTR, EIO, EAGAIN and EBUSY up to 3 times in both packages, and quarantine
any other read error at once; the payload cap follows
``SD_CHUNK_MAX_BYTES``. Faults come from ``open`` patched in each package's
module, failing a path's first opens; in the scan, each package uses its own
``faults`` seams. Outputs are bytes and DB rows, so every comparison is
exact.
"""

import builtins
import collections
import errno
import os

import numpy as np
import pytest

from spacedrive_tpu import faults
from spacedrive_tpu.objects import cas as jax_cas
from spacedrive_tpu.objects import manifest as jax_manifest
from spacedrive_tpu_torch import faults as port_faults
from spacedrive_tpu_torch import retry
from spacedrive_tpu_torch.objects import cas
from spacedrive_tpu_torch.objects import manifest
from tests.test_torch_scan import jax_scan, make_tree, port_scan

#: file sizes: whole-file messages, the 100 KiB edge, sampled messages
SIZES = (10, 5000, 102400, 102401, 300_000)
TRANSIENT = (errno.EIO, errno.EINTR, errno.EAGAIN, errno.EBUSY)


class FlakyOpen:
    """``open`` that fails the first ``fails`` opens of each path in
    ``only`` (all paths if None) with ``OSError(err)``, then opens."""

    def __init__(self, fails: int, err: int = errno.EIO, only=None) -> None:
        self.fails, self.err, self.only = fails, err, only
        self.calls: collections.Counter = collections.Counter()

    def __call__(self, path, *args, **kwargs):
        key = str(path)
        self.calls[key] += 1
        if (self.only is None or key in self.only) and self.calls[key] <= self.fails:
            raise OSError(self.err, os.strerror(self.err), key)
        return builtins.open(path, *args, **kwargs)


@pytest.fixture()
def files(tmp_path):
    paths = []
    for i, size in enumerate(SIZES):
        path = tmp_path / f"f{i}.bin"
        path.write_bytes(np.random.default_rng(i).integers(0, 256, size, np.uint8).tobytes())
        paths.append(str(path))
    return paths


def gather_both(monkeypatch, paths, make_open):
    """(port result, reference result, port opens, reference opens) of
    ``read_sampled_batch`` with ``open`` patched in each cas module."""
    out = []
    for module in (cas, jax_cas):
        flaky = make_open()
        monkeypatch.setattr(module, "open", flaky, raising=False)
        out.append((module.read_sampled_batch(paths, [os.path.getsize(p) for p in paths]),
                    flaky.calls))
    (port, port_calls), (ref, ref_calls) = out
    return port, ref, port_calls, ref_calls


def same_items(a, b) -> bool:
    """Bytes equal, or exceptions of one type and errno."""
    if isinstance(a, Exception) or isinstance(b, Exception):
        return type(a) is type(b) and getattr(a, "errno", None) == getattr(b, "errno", None)
    return a == b


@pytest.mark.parametrize("err", TRANSIENT, ids=errno.errorcode.get)
def test_cas_gather_retries_a_transient_error_like_the_reference(monkeypatch, files, err):
    port, ref, port_calls, ref_calls = gather_both(monkeypatch, files,
                                                   lambda: FlakyOpen(1, err, {files[1], files[3]}))
    assert not any(isinstance(m, Exception) for m in port)
    assert port == ref
    assert port_calls == ref_calls and port_calls[files[3]] == 2


def test_cas_gather_gives_up_after_three_attempts(monkeypatch, files):
    port, ref, port_calls, ref_calls = gather_both(monkeypatch, files,
                                                   lambda: FlakyOpen(99, errno.EIO, {files[2]}))
    assert all(same_items(a, b) for a, b in zip(port, ref))
    assert isinstance(port[2], OSError) and port[2].errno == errno.EIO
    assert port_calls[files[2]] == ref_calls[files[2]] == cas.GATHER_RETRY.attempts == 3


@pytest.mark.parametrize("err", (errno.ENOENT, errno.EACCES), ids=errno.errorcode.get)
def test_cas_gather_quarantines_a_fatal_error_at_once(monkeypatch, files, err):
    port, ref, port_calls, ref_calls = gather_both(monkeypatch, files,
                                                   lambda: FlakyOpen(1, err, {files[4]}))
    assert all(same_items(a, b) for a, b in zip(port, ref))
    assert isinstance(port[4], OSError) and port[4].errno == err
    assert port_calls[files[4]] == ref_calls[files[4]] == 1


def test_cas_gather_quarantines_a_truncated_file_at_once(monkeypatch, files):
    sizes = [os.path.getsize(p) + 7 for p in files]  # every file shrank
    for module in (cas, jax_cas):
        flaky = FlakyOpen(0)
        monkeypatch.setattr(module, "open", flaky, raising=False)
        got = module.read_sampled_batch(files, sizes)
        assert all(isinstance(m, EOFError) for m in got)
        assert set(flaky.calls.values()) == {1}


def chunk_gather_both(monkeypatch, paths, make_open):
    """Each package's ``pipeline_chunk_gather`` rows over ``paths``, with
    ``open`` patched in its manifest module; the cas messages come from an
    unpatched gather."""
    sizes = [os.path.getsize(p) for p in paths]
    messages = cas.read_sampled_batch(paths, sizes)
    out = []
    for module in (manifest, jax_manifest):
        rows = [{"size_in_bytes": s} for s in sizes]
        flaky = make_open()
        monkeypatch.setattr(module, "open", flaky, raising=False)
        module.pipeline_chunk_gather(paths, rows, messages)
        out.append(([r["_chunk_payload"] for r in rows], flaky.calls))
    return out


@pytest.mark.parametrize("cap", ["", "5000", "102401", "200000", "0", "-3", "junk"])
def test_payload_cap_follows_sd_chunk_max_bytes(monkeypatch, files, cap):
    monkeypatch.setenv("SD_CHUNK_MAX_BYTES", cap)
    assert manifest.payload_cap() == jax_manifest.payload_cap()
    (port, _), (ref, _) = chunk_gather_both(monkeypatch, files, lambda: FlakyOpen(0))
    assert port == ref
    limit = manifest.payload_cap()
    assert [p is None for p in port] == [s > limit for s in SIZES]


@pytest.mark.parametrize("fails", [1, 2, 3])
def test_payload_read_retries_like_the_reference(monkeypatch, files, fails):
    """One or two EIOs retry clean; three outlast PAYLOAD_RETRY and the
    file's payload is the error (quarantined at commit)."""
    monkeypatch.setenv("SD_CHUNK_MAX_BYTES", "200000")
    (port, port_calls), (ref, ref_calls) = chunk_gather_both(
        monkeypatch, files, lambda: FlakyOpen(fails, errno.EIO, {files[3]}))
    assert all(same_items(a, b) for a, b in zip(port, ref))
    assert port_calls[files[3]] == ref_calls[files[3]] == min(fails + 1, 3)
    assert isinstance(port[3], OSError) == (fails == 3)
    assert port[4] is None  # over the cap: skipped, never read


def test_retry_policy_and_taxonomy_match_the_reference():
    from spacedrive_tpu.utils import retry as jax_retry

    assert retry.TRANSIENT_ERRNOS == jax_retry.TRANSIENT_ERRNOS
    for mine, ref in ((cas.GATHER_RETRY, jax_cas.GATHER_RETRY),
                      (manifest.PAYLOAD_RETRY, jax_manifest.PAYLOAD_RETRY)):
        assert vars(mine) == vars(ref)
    assert vars(retry.RetryPolicy()) == vars(jax_retry.RetryPolicy())
    for exc in (OSError(errno.EIO, "x"), OSError(errno.ENOENT, "x"), EOFError(), ValueError()):
        assert retry.is_transient_io(exc) == jax_retry.is_transient_io(exc)


def test_scan_with_a_transient_error_and_a_cap_matches_jax(tmp_path, monkeypatch):
    """Both Nodes scan one tree with ``SD_CHUNK_MAX_BYTES`` below two of its
    files and one EIO, from each package's fault seams, in the first cas read
    and the first payload read; each fires once and is retried: the rows,
    objects and manifests agree, and no file is quarantined."""
    tree = make_tree(tmp_path / "tree")
    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_CDC_KERNEL", "numpy")
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    monkeypatch.setenv("SD_CHUNK_MAX_BYTES", "200000")
    faults.install("gather:eio:once;chunk:eio:once")
    try:
        want = jax_scan(tmp_path / "jax", tree)
        assert faults.fired() == {"gather:eio": 1, "chunk:eio": 1}
    finally:
        faults.clear()
    # the port's own seams: an armed gather seam routes the scan's native
    # gather through the per-file Python path, where the EIO fires
    port_faults.install("gather:eio:once;chunk:eio:once")
    routes = collections.Counter(cas.PYTHON_ROUTES)
    try:
        got = port_scan(tmp_path / "port", tree)
        assert port_faults.fired() == {"gather:eio": 1, "chunk:eio": 1}
    finally:
        port_faults.clear()
    assert cas.PYTHON_ROUTES["seam_armed"] > routes["seam_armed"]
    assert got == want
    paths, _groups, manifests = got
    assert len([r for r in paths if r[3] and r[4]]) >= 38  # as in a scan without faults
    sizes = {r[4]: r[3] for r in paths if r[4]}
    assert all(sizes[c] <= 200000 for c in manifests)
    assert any(s > 200000 for s in sizes.values())
