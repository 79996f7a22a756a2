"""The port's device mesh (spacedrive_tpu_torch.parallel.mesh) against the JAX
package's, on the same inputs: ``sharded_hasher`` on 8 shards and with
``seq = 2``, ``sharded_row_hasher``, ``identify_step`` (duplicates across
shards, empty lanes) and ``sharded_resizer`` give the same bytes. The JAX
programs run on the 8-device virtual CPU mesh that conftest forces, one mesh
per shape for the whole file; the port's meshes repeat the CPU device.

Also: the mesh's errors, a ``tpu-sharded`` location's scan against a default
one, the sharded hasher's fused path, and a two-process gloo run that flags
a duplicate sitting on the other rank.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spacedrive_tpu.objects.blake3_ref import blake3
from spacedrive_tpu.objects.cas import cas_message_from_bytes
from spacedrive_tpu.ops.blake3_jax import pack_messages
from spacedrive_tpu.parallel import mesh as jm
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.cas import generate_cas_id
from spacedrive_tpu_torch.objects.hasher import DeviceHasher, ShardedHasher, get_hasher
from spacedrive_tpu_torch.ops import blake3 as b3
from spacedrive_tpu_torch.parallel import mesh as tm
from tests.torch_scan_cases import make_tree, rows_of, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _msgs(n, max_bytes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, max_bytes)), dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_meshes():
    return {"data": jm.make_mesh(8), "seq": jm.make_mesh(8, seq=2)}


def words_of(digests) -> np.ndarray:
    """(8, B) digest words of either package as u32."""
    if isinstance(digests, torch.Tensor):
        return b3.u32(digests).numpy().astype(np.uint32)
    return np.asarray(digests).astype(np.uint32)


@pytest.mark.parametrize("seq", [1, 2], ids=["data8", "seq2"])
def test_sharded_hasher_matches_jax(jax_meshes, seq):
    msgs = _msgs(16, 4 * 1024) if seq == 1 else _msgs(8, 8 * 1024, seed=1)
    words, lengths = pack_messages(msgs, 4 if seq == 1 else 8)
    want = words_of(jm.sharded_hasher(jax_meshes["data" if seq == 1 else "seq"])(words, lengths))
    mesh = tm.make_mesh(seq=seq, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8 // seq, "seq": seq}
    got = words_of(tm.sharded_hasher(mesh)(words, lengths))
    assert np.array_equal(got, want)
    assert b3.digests_to_hex(got) == [blake3(m).hex() for m in msgs]


def test_seq_shards_equal_the_one_device_call():
    """Four seq shards of 2 chunks: windows at offsets 0, 2, 4, 6 of each
    message, one-chunk and empty messages among them."""
    msgs = [b"", b"x", bytes(1024), bytes(1025)] + _msgs(4, 8 * 1024, seed=4)
    words, lengths = pack_messages(msgs, 8)
    one = tm.sharded_hasher(tm.make_mesh(devices=["cpu"]))(words, lengths)
    four = tm.sharded_hasher(tm.make_mesh(seq=4, devices=["cpu"] * 8))(words, lengths)
    assert torch.equal(b3.u32(four), b3.u32(one))


def test_sharded_row_hasher_matches_jax(jax_meshes):
    msgs = _msgs(16, 6 * 1024, seed=5)
    rows, lengths = b3.pack_rows(msgs, 6)
    want = words_of(jm.sharded_row_hasher(jax_meshes["data"])(rows.view(np.uint32), lengths))
    got = words_of(tm.sharded_row_hasher(tm.make_mesh(devices=["cpu"] * 8))(rows, lengths))
    assert np.array_equal(got, want)


def test_identify_step_matches_jax_across_shards(jax_meshes):
    base = _msgs(8, 2 * 1024, seed=2)
    msgs = base + [base[0], base[3]] + _msgs(5, 2 * 1024, seed=3) + [b""]
    msgs = [cas_message_from_bytes(m) if m else b"" for m in msgs]
    words, lengths = pack_messages(msgs, 4)
    j_dig, j_dup = jm.identify_step(jax_meshes["data"])(words, lengths)
    t_dig, t_dup = tm.identify_step(tm.make_mesh(devices=["cpu"] * 8))(words, lengths)
    assert np.array_equal(words_of(t_dig), words_of(j_dig))
    assert t_dup.tolist() == np.asarray(j_dup).tolist()
    assert t_dup[8] and t_dup[9] and not t_dup[:8].any() and not t_dup[15]


def test_dup_flags_ignore_empty_lanes():
    prefix = torch.tensor([5, 5, 7, 5, 7, 9])
    valid = torch.tensor([False, True, True, True, True, False])
    assert tm.dup_flags(prefix, valid).tolist() == [False, False, False, True, True, False]


def test_sharded_resizer_matches_jax(jax_meshes):
    from spacedrive_tpu.ops.resize_jax import target_dims

    rng = np.random.default_rng(9)
    n, h_in, w_in = 8, 96, 144
    imgs = rng.integers(0, 256, (n, h_in, w_in, 3), dtype=np.uint8)
    th, tw = target_dims(w_in, h_in)
    src = np.tile(np.int32([h_in, w_in]), (n, 1))
    tgt = np.tile(np.int32([th, tw]), (n, 1))
    want = np.asarray(jm.sharded_resizer(jax_meshes["data"])(imgs, src, tgt))
    got = tm.sharded_resizer(tm.make_mesh(devices=["cpu"] * 8))(imgs, src, tgt)
    assert np.array_equal(got.numpy(), want)


def test_make_mesh_errors_match_the_reference():
    with pytest.raises(ValueError, match="asked for 9 devices, have 8"):
        tm.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="n_devices 6 not divisible by seq 4"):
        tm.make_mesh(6, seq=4, devices=["cpu"] * 8)
    assert tm.pad_batch_for_mesh(5, tm.make_mesh(devices=["cpu"] * 4)) == 8
    with pytest.raises(ValueError, match="does not divide"):
        tm.sharded_hasher(tm.make_mesh(devices=["cpu"] * 4))(*pack_messages(_msgs(6, 99), 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_multihost("localhost:1", 2, 0)


def test_sharded_hasher_fused_and_bucket_paths_match_the_device_hasher(tmp_path):
    paths, sizes = [], []
    for i, n in enumerate((0, 10, 5000, 200_000, 150_000, 333)):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(np.random.default_rng(i).integers(0, 256, n, dtype=np.uint8).tobytes())
        paths.append(p)
        sizes.append(n)
    sharded = ShardedHasher(["cpu"] * 2)
    assert sharded.mesh.shape == {"data": 2, "seq": 1}
    # the fused path: two files over 100 KiB in one (8, 57-chunk) tier
    want = [generate_cas_id(p) for p in paths[1:]]
    assert sharded.hash_batch(paths[1:], sizes[1:]) == want
    msgs = [p.read_bytes() for p in paths[:3]]
    assert sharded.hash_gathered(msgs) == DeviceHasher(torch.device("cpu")).hash_gathered(msgs)


def test_a_tpu_sharded_location_scans_like_a_default_one(tmp_path):
    tree = make_tree(tmp_path / "tree")
    node = Node(tmp_path / "data", device="cpu", mesh_devices=["cpu"] * 4, watch_locations=False)
    try:
        rows = {}
        for hasher in (None, "tpu-sharded"):
            lib = node.libraries.create(f"lib-{hasher}")
            loc = create_location(lib, tree, hasher=hasher)
            assert loc["hasher"] == (hasher or "cpu")
            scan_location(lib, loc["id"])
            assert node.jobs.wait_idle(120)
            rows[hasher] = rows_of(lib.db)
        assert rows["tpu-sharded"] == rows[None]
        assert len([r for r in rows[None][0] if r[4]]) >= 70
        assert get_hasher("tpu-sharded", node) is node.sharded_hasher
        assert node.sharded_hasher.mesh.shape == {"data": 4, "seq": 1}
        assert get_hasher("cpu", node) is get_hasher("hybrid", node) is node.hasher
    finally:
        node.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_flag_a_duplicate_on_the_other_rank():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    worker = str(REPO / "tests" / "torch_multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(rank), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    assert "MULTIHOST OK rank 0 dup [False, False, False, False]" in outs[0]
    assert "MULTIHOST OK rank 1 dup [False, True, False, False]" in outs[1]
