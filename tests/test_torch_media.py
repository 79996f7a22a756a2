"""The port's media processor (spacedrive_tpu_torch/objects/media/) against
the JAX package's, on the CPU.

One tree at the location's root (so that the reference's warm start per
top-level directory spawns nothing): PNGs above and below the canvas, a
JPEG with EXIF camera fields and a GPS fix written with PIL, a 2000x1500
PNG that forces the host box-reduce, a 1x1 image, a 3000x60 strip and a
corrupt ``.jpg``. The JAX Node scans it with its ``tpuThumbnails`` feature
on and its sticky resize verdict set to the device (a test-side setting),
so both packages take the batched route; the port's ``Node(device="cpu", watch_locations=False)``
scans it too. The pair of scans runs twice: with the native codecs where
they build, and with both packages' codec probe answered "none", so that
PIL decodes, reduces (``Image.reduce``) and encodes, as on a host without
libjpeg, libpng and libwebp. Compared on each: the thumbnail set, the
resized arrays before encode (max |diff| <= 1; 0 differing values on this
CPU when written), the WebP bytes wherever the arrays are equal, the
``media_data`` rows by cas_id, the ``new_thumbnail`` events, the corrupt
file's error and the codec routes the port counted.

Also: a device resize that raises fails the media step (pipelined and
sequential), and no file is then thumbnailed through PIL; a
``thumbnail:enospc:once`` fault skips one batched thumbnail on both sides,
which the per-file retry then makes; ``encode_pluscode`` gives the
reference's codes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from spacedrive_tpu import faults as jax_faults
from spacedrive_tpu.config import BackendFeature
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.media import metadata as jax_metadata
from spacedrive_tpu.objects.media import thumbnail as jax_thumbnail
from spacedrive_tpu_torch import faults, retry
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.media import metadata, processor, thumbnail
from spacedrive_tpu_torch.ops import resize
from tests.torch_scan_cases import one_torch_thread  # noqa: F401


def smooth(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth seeded field with light noise (compresses like a photo)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6.28, 3)
    rgb = [127 + 100 * np.sin(x / (17 + 9 * c) + y / (23 + 5 * c) + phase[c]) for c in range(3)]
    noise = rng.normal(0, 4, (h, w, 3))
    return np.clip(np.stack(rgb, axis=-1) + noise, 0, 255).astype(np.uint8)


def write_exif_jpeg(path: Path, pixels: np.ndarray) -> None:
    exif = Image.Exif()
    exif[271], exif[272] = "Canon", "EOS 5D Mark IV"
    exif[306], exif[274] = "2024:05:01 10:00:00", 6
    exif[0x8769] = {33434: TiffImagePlugin.IFDRational(1, 250),
                    33437: TiffImagePlugin.IFDRational(28, 10), 34855: 400}
    exif[0x8825] = {1: "N", 2: (47.0, 21.0, 56.12), 3: "E", 4: (8.0, 31.0, 29.99)}
    Image.fromarray(pixels).save(path, quality=90, exif=exif)


def make_media_tree(root: Path) -> Path:
    root.mkdir(parents=True)
    for name, (h, w) in {"p0": (480, 640), "p1": (200, 300), "big": (1500, 2000),
                         "one": (1, 1), "strip": (60, 3000)}.items():
        Image.fromarray(smooth(len(name) * 7 + h, h, w)).save(root / f"{name}.png",
                                                                compress_level=1)
    write_exif_jpeg(root / "exif.jpg", smooth(3, 600, 800))
    (root / "bad.jpg").write_bytes(np.random.default_rng(9).bytes(5000))
    (root / "notes.txt").write_bytes(b"not an image\n")
    return root


def spy_on_encode(mp, module) -> dict:
    """{cas_id: RGB array} of every thumbnail handed to ``module._save_webp``."""
    seen = {}
    real = module._save_webp

    def spy(img, tmp):
        arr = img if isinstance(img, np.ndarray) else np.asarray(img.convert("RGB"))
        seen[Path(tmp).name.split(".")[0]] = arr.copy()
        return real(img, tmp)

    mp.setattr(module, "_save_webp", spy)
    return seen


JSON_COLUMNS = ("dimensions", "media_location", "camera_data", "streams")


def collect(node, lib, events: list) -> dict:
    db = lib.db
    rows = {}
    for r in db.query("SELECT fp.cas_id, md.* FROM media_data md "
                      "JOIN file_path fp ON fp.object_id = md.object_id"):
        row = {k: r[k] for k in r.keys() if k not in ("id", "object_id", "cas_id")}
        rows[r["cas_id"]] = {k: json.loads(v) if k in JSON_COLUMNS and v else v
                             for k, v in row.items()}
    media = db.query("SELECT status, errors_text FROM job WHERE name = 'media_processor'")
    thumbs = {p.stem: p.read_bytes() for p in Path(node.data_dir).glob("thumbnails/*/*.webp")}
    names = {r["name"]: r["cas_id"] for r in db.query(
        "SELECT name, cas_id FROM file_path WHERE is_dir = 0")}
    return {"rows": rows, "job": tuple(media[0]), "thumbs": thumbs, "names": names,
            "events": sorted(e.payload["cas_id"] for e in events if e.kind == "new_thumbnail")}


def jax_scan(data_dir: Path, tree: Path) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SD_P2P_DISABLED", "1")
        mp.setitem(jax_thumbnail._DEVICE_VERDICT, "value", True)
        seen = spy_on_encode(mp, jax_thumbnail)
        node = JaxNode(data_dir, probe_accelerator=False, watch_locations=False)
        try:
            features = node.config.get().get("features", [])
            node.config.write(features=[*features, BackendFeature.TPU_THUMBNAILS])
            events: list = []
            node.events.on(events.append)
            lib = node.libraries.create("jax")
            jax_scan_location(lib, jax_create_location(lib, tree)["id"])
            assert node.jobs.wait_idle(120)
            return {**collect(node, lib, events), "arrays": seen}
        finally:
            node.shutdown()


def port_scan(data_dir: Path, tree: Path) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        seen = spy_on_encode(mp, thumbnail)
        node = Node(data_dir, device="cpu", watch_locations=False)
        try:
            events: list = []
            node.events.on(events.append)
            lib = node.libraries.create("port")
            scan_location(lib, create_location(lib, tree)["id"])
            assert node.jobs.wait_idle(120)
            return {**collect(node, lib, events), "arrays": seen}
        finally:
            node.shutdown()


@pytest.fixture(scope="module")
def media_tree(tmp_path_factory):
    return make_media_tree(tmp_path_factory.mktemp("media") / "tree")


@pytest.fixture(scope="module", params=["native", "pil"])
def scans(request, media_tree, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"media-{request.param}")
    tree = media_tree
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "pil":
            mp.setattr(jax_thumbnail, "_NATIVE_IMAGES", [None])
            mp.setattr(thumbnail, "_NATIVE_IMAGES", [None])
        jax = jax_scan(base / "jax", tree)
        resize.reset_counts()
        thumbnail.reset_counts()
        processor.SCALAR_RETRIES.clear()
        port = port_scan(base / "port", tree)
        routes = {"native": thumbnail._native_images() is not None,
                  "decodes": dict(thumbnail.DECODES), "encodes": dict(thumbnail.ENCODES)}
    return jax, port, dict(resize.CALLS), dict(processor.SCALAR_RETRIES), routes


def test_thumbnails_and_events_match_the_jax_node(scans):
    jax, port, calls, retries, routes = scans
    assert port["names"] == jax["names"]
    images = {port["names"][n] for n in ("p0", "p1", "big", "one", "strip", "exif")}
    assert set(port["thumbs"]) == set(jax["thumbs"]) == images
    assert port["events"] == jax["events"] == sorted(images)
    # one device call of the six decodable images, padded to the largest
    # reduced one (1000x750 from the 2000x1500 PNG)
    assert calls == {("cpu", (6, 750, 1000)): 1}
    assert retries == {"jpg": 1}
    # the codec each image took (successes only: the corrupt .jpg fails
    # both its batched decode and its per-file retry)
    route = "native" if routes["native"] else "pil"
    assert routes["decodes"] == {route: 6} and routes["encodes"] == {route: 6}


def test_resized_arrays_and_webp_bytes_match_the_jax_node(scans):
    jax, port, *_ = scans
    assert set(port["arrays"]) == set(jax["arrays"])
    differing = 0
    for cas_id, arr in port["arrays"].items():
        want = jax["arrays"][cas_id]
        assert arr.shape == want.shape
        diff = np.abs(arr.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1
        differing += int((diff != 0).sum())
        if not diff.any():
            assert port["thumbs"][cas_id] == jax["thumbs"][cas_id]
    assert differing == 0
    big = port["names"]["big"]
    assert port["arrays"][big].shape == (384, 512, 3)
    assert port["thumbs"][big][:4] == b"RIFF" and port["thumbs"][big][8:12] == b"WEBP"


def test_media_rows_match_the_jax_node(scans):
    jax, port, *_ = scans
    assert port["rows"] == jax["rows"]
    exif = port["rows"][port["names"]["exif"]]
    assert exif["camera_data"]["camera_make"] == "Canon"
    assert exif["media_location"]["pluscode"] == "8FVC9G8F+6X"
    assert exif["media_date"] == "2024:05:01 10:00:00"
    assert port["rows"][port["names"]["one"]]["dimensions"] == {"width": 1, "height": 1}
    assert port["names"]["notes"] not in port["rows"]


def test_the_corrupt_file_fails_alike(scans):
    jax, port, *_ = scans
    assert port["job"] == (JobStatus.COMPLETED_WITH_ERRORS, jax["job"][1])
    assert port["job"][1].endswith("bad.jpg: thumbnail failed (batched + scalar retry)")
    assert port["names"]["bad"] not in port["thumbs"]


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_a_failed_device_resize_fails_the_step(tmp_path, monkeypatch, pipeline):
    tree = tmp_path / "tree"
    tree.mkdir()
    for i in range(2):
        Image.fromarray(smooth(i, 300, 400)).save(tree / f"a{i}.png")
    monkeypatch.setenv("SD_PIPELINE", pipeline)

    def lost(*_args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(resize, "resize_batch", lost)
    thumbnail.reset_counts()
    processor.SCALAR_RETRIES.clear()
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("port")
        scan_location(lib, create_location(lib, tree)["id"])
        assert node.jobs.wait_idle(60)
        jobs = {r["name"]: r for r in lib.db.query("SELECT * FROM job")}
        assert jobs["media_processor"]["status"] == JobStatus.FAILED
        assert "illegal memory access" in jobs["media_processor"]["errors_text"]
        assert jobs["dedup_detector"]["status"] == JobStatus.CANCELED
        assert not list(node.data_dir.glob("thumbnails/*/*.webp"))
        assert lib.db.query("SELECT COUNT(*) AS n FROM media_data")[0]["n"] == 0
    finally:
        node.shutdown()
    assert not processor.SCALAR_RETRIES and not thumbnail.ENCODES
    assert sum(thumbnail.DECODES.values()) == 2


def test_a_full_disk_skips_one_batched_thumbnail_on_both_sides(tmp_path, monkeypatch):
    tree = tmp_path / "tree"
    tree.mkdir()
    for i in range(3):
        Image.fromarray(smooth(10 + i, 240, 320)).save(tree / f"s{i}.png")
    jax_full: list = []
    monkeypatch.setattr(jax_thumbnail, "note_disk_full", jax_full.append)
    retry.DISK_FULL.clear()
    processor.SCALAR_RETRIES.clear()
    jax_faults.install("thumbnail:enospc:once", seed=0)
    try:
        jax = jax_scan(tmp_path / "jax", tree)
    finally:
        jax_faults.clear()
    faults.install("thumbnail:enospc:once")
    try:
        port = port_scan(tmp_path / "port", tree)
        assert faults.fired() == {"thumbnail:enospc": 1}
    finally:
        faults.clear()
    assert jax_full == ["thumbnail"] and retry.DISK_FULL == {"thumbnail": 1}
    # the skipped file was made by the per-file retry, on both sides
    assert processor.SCALAR_RETRIES == {"png": 1}
    assert port["job"][0] == jax["job"][0] == JobStatus.COMPLETED
    assert port["thumbs"] == jax["thumbs"] and len(port["thumbs"]) == 3
    assert port["events"] == jax["events"]


@pytest.mark.parametrize("lat, lon", [(47.365590, 8.524997), (0.0, 0.0), (90.0, 180.0),
                                      (-90.0, -180.0), (-33.8688, 151.2093),
                                      (40.7128, -74.0060), (12.5, 540.25), (-0.0000625, 359.9)])
def test_encode_pluscode_matches_the_reference(lat, lon):
    assert metadata.encode_pluscode(lat, lon) == jax_metadata.encode_pluscode(lat, lon)
    if (lat, lon) == (47.365590, 8.524997):
        assert metadata.encode_pluscode(lat, lon) == "8FVC9G8F+6X"
