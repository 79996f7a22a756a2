"""HEIF images, videos and audio in the port's media processor, against
the JAX package's, on the CPU.

One tree at the location's root (so that the reference's warm start per
top-level directory spawns nothing) holds smooth seeded HEICs of 64x48,
640x480 and 1600x1200 (the last box-reduced by k = 2 on the host), a
corrupt ``.heic``, ``.mp4``, ``.mkv`` and ``.avi`` clips from the test
encoder (64x48 and 320x240, 10-24 frames), a corrupt ``.mp4``, one PNG (so
that HEIF images share a resize sub-batch with another image) and a WAV.
Both Nodes scan it twice: with libheif and the libav wrapper as this host
has them, and with every probe of both packages answered "none"
(``_native_heif``, ``_native_ffmpeg``, the ``ffmpeg`` and ``ffprobe`` CLIs,
the libav header glob). Compared on each: the thumbnail set, the resized
arrays before encode (max |diff| <= 1; 0 values differ on this CPU when
written), the WebP bytes where the arrays are equal, the ``media_data``
rows by cas_id, the ``new_thumbnail`` events and the job's errors.

Also: the native wrappers' answers (``probe``, ``decode_frame_rgb``,
``dims``, ``decode_rgb``), the video helpers (``video_to_webp_bytes`` with
and without the film strip, ``film_strip_filter``), audio rows of mono and
stereo WAVs at 8 kHz and 44.1 kHz, the ffprobe branch of ``_extract_av``
on canned JSON, the device rule on a batch with HEIF images, and that
importing the wrappers builds nothing. Everything that needs libheif, its
encoder or the libav headers skips, with that reason, where they are
missing.
"""

import glob
import importlib.util
import json
import logging
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.objects.media import metadata as jax_metadata
from spacedrive_tpu.objects.media import thumbnail as jax_thumbnail
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.native import NativeBuildError, ffmpeg_native, heif_native
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.media import metadata, processor, thumbnail
from spacedrive_tpu_torch.ops import resize
from tests.test_torch_media import jax_scan, port_scan, smooth
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

HEICS = {"h_small": (48, 64), "h_mid": (480, 640), "h_big": (1200, 1600)}
VIDEOS = {"v_tiny.mp4": (64, 48, 10), "v_mkv.mkv": (320, 240, 24), "v_avi.avi": (320, 240, 16)}


def smooth_field(seed: int, h: int, w: int) -> np.ndarray:
    """A noiseless seeded field: HEVC encodes it in well under a second."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6.28, 3)
    rgb = [127 + 100 * np.sin(x / (41 + 9 * c) + y / (53 + 5 * c) + phase[c]) for c in range(3)]
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


def write_wav(path: Path, rate: int, channels: int, seconds: float = 0.25) -> None:
    n = int(rate * seconds)
    t = np.arange(n) / rate
    tone = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat(tone[:, None], channels, axis=1).tobytes())


def need_heif() -> None:
    try:
        ok = heif_native.available()
    except NativeBuildError as e:
        pytest.skip(f"the libheif binding does not build here: {e}")
    if not ok:
        pytest.skip("the libheif runtime (libheif.so.1) is not present")


def need_ffmpeg() -> None:
    try:
        ffmpeg_native.library()
    except NativeBuildError as e:
        pytest.skip(f"the libav wrapper does not build here (libav headers missing?): {e}")


@pytest.fixture(scope="module")
def formats_tree(tmp_path_factory):
    need_heif()
    need_ffmpeg()
    root = tmp_path_factory.mktemp("formats") / "tree"
    root.mkdir()
    for i, (name, (h, w)) in enumerate(HEICS.items()):
        if not heif_native.encode_file(root / f"{name}.heic", smooth_field(i, h, w)):
            pytest.skip("this libheif build has no HEVC or AV1 encoder")
    (root / "h_bad.heic").write_bytes(np.random.default_rng(5).bytes(3000))
    for name, (w, h, frames) in VIDEOS.items():
        ffmpeg_native.write_test_video(root / name, width=w, height=h, frames=frames, fps=12)
    (root / "v_bad.mp4").write_bytes(np.random.default_rng(6).bytes(4000))
    Image.fromarray(smooth(3, 300, 400)).save(root / "p.png", compress_level=1)
    write_wav(root / "a.wav", 8000, 1)
    return root


def answer_none(mp) -> None:
    """Every codec probe of both packages answers "none"."""
    for module in (jax_thumbnail, thumbnail):
        mp.setattr(module, "_NATIVE_HEIF", [None])
        mp.setattr(module, "_NATIVE_FFMPEG", [None])
        mp.setattr(module, "_FFMPEG", None)
    for module in (jax_metadata, metadata):
        mp.setattr(module, "_FFPROBE", None)
    mp.setattr(glob, "glob", lambda _pattern: [])


@pytest.fixture(scope="module", params=["present", "none"])
def scans(request, formats_tree, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"formats-{request.param}")
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "none":
            answer_none(mp)
        jax = jax_scan(base / "jax", formats_tree)
        resize.reset_counts()
        thumbnail.reset_counts()
        metadata.reset_counts()
        processor.SCALAR_RETRIES.clear()
        port = port_scan(base / "port", formats_tree)
        counts = {"calls": dict(resize.CALLS), "decodes": dict(thumbnail.DECODES),
                  "encodes": dict(thumbnail.ENCODES), "probes": dict(metadata.PROBES),
                  "retries": dict(processor.SCALAR_RETRIES)}
    return request.param, jax, port, counts


def test_thumbnails_and_events_match_the_jax_node(scans):
    case, jax, port, counts = scans
    names = port["names"]
    assert names == jax["names"]
    assert set(port["thumbs"]) == set(jax["thumbs"])
    assert port["events"] == jax["events"]
    png = names["p"]
    if case == "none":
        assert set(port["thumbs"]) == {png}
        assert counts["calls"] == {("cpu", (1, 300, 400)): 1}
        assert counts["retries"] == {} and counts["probes"] == {}
        return
    heics = {names[n] for n in HEICS}
    videos = {names[Path(n).stem] for n in VIDEOS}
    assert set(port["thumbs"]) == heics | videos | {png}
    # one sub-batch: three HEIFs (the 1600x1200 reduced to 800x600) and the PNG
    assert counts["calls"] == {("cpu", (4, 600, 800)): 1}
    assert counts["decodes"] == {"heif": 3, "video_native": 3, "native": 1}
    assert counts["encodes"] == {"native": 7}
    # the corrupt files: each batched or per-file try, then its retry
    assert counts["retries"] == {"heic": 1, "mp4": 1}
    assert counts["probes"] == {"heif": 3, "native": 3}


def test_resized_arrays_and_webp_bytes_match_the_jax_node(scans):
    case, jax, port, _counts = scans
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
    if case == "present":
        names = port["names"]
        assert port["arrays"][names["h_big"]].shape == (384, 512, 3)
        assert port["arrays"][names["h_small"]].shape == (48, 64, 3)
        assert port["arrays"][names["v_mkv"]].shape[2] == 3


def test_media_rows_match_the_jax_node(scans):
    case, jax, port, _counts = scans
    assert port["rows"] == jax["rows"]
    rows, names = port["rows"], port["names"]
    if case == "none":
        assert set(rows) == {names["p"]}
        return
    assert rows[names["h_big"]]["dimensions"] == {"width": 1600, "height": 1200}
    tiny = rows[names["v_tiny"]]
    assert tiny["dimensions"] == {"width": 64, "height": 48}
    assert tiny["streams"][0]["codec_type"] == "video"
    assert names["h_bad"] not in rows and names["v_bad"] not in rows
    # the media job selects no audio (the reference's _thumbable_extensions)
    assert names["a"] not in rows


def test_errors_match_the_jax_node(scans):
    case, jax, port, _counts = scans
    assert port["job"] == jax["job"]
    if case == "none":
        # no codec, no try: the gates leave these files without an error
        assert port["job"] == (JobStatus.COMPLETED, None)
        return
    assert port["job"][0] == JobStatus.COMPLETED_WITH_ERRORS
    errors = sorted(port["job"][1].split("\n\n"))
    assert [e.rsplit("/", 1)[1] for e in errors] == [
        "h_bad.heic: thumbnail failed (batched + scalar retry)",
        "v_bad.mp4: thumbnail failed (batched + scalar retry)"]


def test_native_wrappers_match_the_reference(formats_tree):
    from spacedrive_tpu.native import ffmpeg_native as jax_ffmpeg
    from spacedrive_tpu.native import heif_native as jax_heif

    for name in HEICS:
        path = formats_tree / f"{name}.heic"
        assert heif_native.dims(path) == jax_heif.dims(path)
        got = heif_native.decode_rgb(path)
        assert got.tobytes() == jax_heif.decode_rgb(path).tobytes()
        assert got.shape == (*HEICS[name], 3)
    for bad in (formats_tree / "h_bad.heic", formats_tree / "missing.heic"):
        with pytest.raises(heif_native.HeifError):
            heif_native.decode_rgb(bad)
    for name, (w, h, _frames) in VIDEOS.items():
        path = formats_tree / name
        assert ffmpeg_native.probe(path) == jax_ffmpeg.probe(path)
        frame = ffmpeg_native.decode_frame_rgb(path)
        assert frame.shape == (h, w, 3) and frame.std() > 10
        assert frame.tobytes() == jax_ffmpeg.decode_frame_rgb(path).tobytes()
    with pytest.raises(ffmpeg_native.FfmpegError):
        ffmpeg_native.probe(formats_tree / "v_bad.mp4")


@pytest.mark.parametrize("film_strip", [False, True])
def test_video_helpers_match_the_reference(formats_tree, tmp_path, film_strip):
    clip = formats_tree / "v_mkv.mkv"
    got = thumbnail.video_to_webp_bytes(clip, size=96, film_strip=film_strip)
    assert got == jax_thumbnail.video_to_webp_bytes(clip, size=96, film_strip=film_strip)
    assert got[:4] == b"RIFF" and got[8:12] == b"WEBP"
    out, want = tmp_path / "sub" / "port.webp", tmp_path / "jax.webp"
    thumbnail.video_to_thumbnail(clip, out, size=64, film_strip=film_strip)
    jax_thumbnail.video_to_thumbnail(clip, want, size=64, film_strip=film_strip)
    assert out.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("h, w", [(48, 64), (97, 13), (4, 4)])
def test_film_strip_filter_matches_the_reference(h, w):
    arr = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = thumbnail.film_strip_filter(arr)
    assert got.dtype == np.uint8 and got.tobytes() == jax_thumbnail.film_strip_filter(arr).tobytes()


@pytest.mark.parametrize("rate, channels", [(8000, 1), (8000, 2), (44100, 1), (44100, 2)])
def test_audio_rows_match_the_reference(tmp_path, rate, channels):
    need_ffmpeg()
    path = tmp_path / "tone.wav"
    write_wav(path, rate, channels)
    got = metadata.extract_media_data(str(path), "wav")
    assert got == jax_metadata.extract_media_data(str(path), "wav")
    assert got["streams"] == [{"codec_type": "audio", "codec": "pcm_s16le",
                               "channels": channels, "sample_rate": rate}]
    assert got["duration_seconds"] == 0.25 and "dimensions" not in got
    with pytest.MonkeyPatch.context() as mp:
        answer_none(mp)
        assert metadata.extract_media_data(str(path), "wav") is None
        assert jax_metadata.extract_media_data(str(path), "wav") is None


FFPROBE_JSON = {
    "format": {"duration": "12.345678", "bit_rate": "128000",
               "tags": {"artist": "Someone", "creation_time": "2024-05-01T10:00:00.000000Z"}},
    "streams": [
        {"codec_type": "video", "codec_name": "mjpeg", "width": 600, "height": 600,
         "avg_frame_rate": "0/0", "disposition": {"attached_pic": 1}},
        {"codec_type": "video", "codec_name": "h264", "width": 1920, "height": 1080,
         "avg_frame_rate": "30000/1001", "disposition": {"attached_pic": 0}},
        {"codec_type": "audio", "codec_name": "aac", "channels": 2, "sample_rate": "48000"},
        {"codec_type": "subtitle", "codec_name": "mov_text"},
    ],
}


@pytest.mark.parametrize("answer", ["json", "fails", "empty"])
def test_the_ffprobe_branch_matches_the_reference(monkeypatch, answer):
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        if answer == "fails":
            raise subprocess.CalledProcessError(1, cmd)
        body = FFPROBE_JSON if answer == "json" else {}
        return subprocess.CompletedProcess(cmd, 0, json.dumps(body).encode(), b"")

    for module in (jax_thumbnail, thumbnail):
        monkeypatch.setattr(module, "_NATIVE_FFMPEG", [None])
    for module in (jax_metadata, metadata):
        monkeypatch.setattr(module, "_FFPROBE", "/opt/bin/ffprobe")
    monkeypatch.setattr(subprocess, "run", fake_run)
    metadata.reset_counts()
    got = metadata._extract_av("/media/clip.mp4")
    assert got == jax_metadata._extract_av("/media/clip.mp4")
    assert calls[0] == calls[1] and calls[0][0] == "/opt/bin/ffprobe"
    if answer != "json":
        assert got is None and metadata.PROBES == {}
        return
    assert metadata.PROBES == {"ffprobe": 1}
    assert got["dimensions"] == {"width": 1920, "height": 1080}
    assert got["streams"][1]["fps"] == 29.97 and got["streams"][2]["sample_rate"] == 48000
    assert "fps" not in got["streams"][0]
    assert (got["duration_seconds"], got["bit_rate"]) == (12.346, 128000)
    assert got["media_date"] == "2024-05-01T10:00:00.000000Z" and got["artist"] == "Someone"


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_a_failed_device_resize_fails_a_step_with_heif_images(formats_tree, tmp_path,
                                                               monkeypatch, pipeline):
    tree = tmp_path / "tree"
    tree.mkdir()
    for name in ("h_small", "h_mid"):
        shutil.copy(formats_tree / f"{name}.heic", tree)
    shutil.copy(formats_tree / "p.png", tree)
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
        assert not list(node.data_dir.glob("thumbnails/*/*.webp"))
    finally:
        node.shutdown()
    assert not processor.SCALAR_RETRIES and not thumbnail.ENCODES
    assert thumbnail.DECODES["heif"] == 2


def test_importing_the_wrappers_builds_nothing(tmp_path, monkeypatch):
    """A fresh import of each wrapper runs no g++ and writes no library;
    its first use where g++ is missing raises NativeBuildError."""
    ran = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: ran.append(a))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    for module in (heif_native, ffmpeg_native):
        spec = importlib.util.spec_from_file_location(f"{module.__name__}_fresh", module.__file__)
        fresh = importlib.util.module_from_spec(spec)
        fresh.__package__ = native.__name__
        spec.loader.exec_module(fresh)
        assert fresh._lib is None
        with pytest.raises(NativeBuildError, match="g\\+\\+ not found"):
            fresh.library()
    assert not ran and not (tmp_path / "build").exists()


def test_a_failed_build_is_logged_once_and_gates_video(tmp_path, monkeypatch, caplog):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ffmpeg_native, "_lib", None)
    monkeypatch.setattr(ffmpeg_native, "LIBS", ("-lsd_no_such_library",))
    monkeypatch.setattr(thumbnail, "_NATIVE_FFMPEG", None)
    monkeypatch.setattr(thumbnail, "_FFMPEG", None)
    with caplog.at_level(logging.WARNING, logger=thumbnail.__name__):
        assert thumbnail._native_ffmpeg() is None
        assert thumbnail._native_ffmpeg() is None
        assert not thumbnail.can_generate_thumbnail("mp4")
        assert thumbnail.can_generate_thumbnail("png")
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 1 and "sd_no_such_library" in warned[0]
    assert "g++ failed building libsdffmpeg" in warned[0]
