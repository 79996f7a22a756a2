"""Thumbnails of images, HEIF images and videos: WebP previews in a
cas_id-sharded cache.

Counterpart of ``spacedrive_tpu/objects/media/thumbnail.py``: a target
area of 262,144 px² at WebP quality 30, the cache at
``<data_dir>/thumbnails/<cas_id[:2]>/<cas_id>.webp`` beside a
``version.txt``.

The batched route (:func:`generate_thumbnails_batched`) decodes each
image (HEIF images too) on the host, reduces anything with an edge over ``MAX_INPUT_EDGE``
by an integer box factor, resizes each sub-batch of ``RESIZE_SUB_BATCH``
images on the node's device (:func:`..ops.resize.resize_batch_host`) and
encodes the thumbnails on the host. The reference's sticky per-process
verdict (its ``_DEVICE_VERDICT``, ``_measure_device_verdict``,
``_device_resize_allowed``, ``_pil_resize_all``) and its scalar fallback
after a failed device resize are not ported: on the node's device the
batched route always resizes there, and a failure of the device resize
raises out of :func:`generate_thumbnails_batched`. :func:`generate_thumbnail`
is the reference's per-file route (decode, PIL resize, encode), which the
processor takes for a file whose host decode or encode failed in the
batch, and which every video takes, as in the reference: one frame (the
native helper's, else the ``ffmpeg`` CLI's), a PIL resize, WebP.

Codecs are a host choice, in the reference's order: for images the native
helper (``native/sd_images.cc``: libjpeg, libpng, libwebp) where it
builds, else PIL; for HEIF images libheif through ``native/sd_heif.cc``;
for video frames ``native/sd_ffmpeg.cc`` (libav*), else the ``ffmpeg``
CLI. Each probe runs once and logs its outcome, with the build error when
there is one. A missing library is a capability, as the reference's gates
(:func:`can_generate_thumbnail`, :func:`_ffmpeg_capable`) decide: its
files are not thumbnailable. :data:`DECODES` and :data:`ENCODES` count the
route each decode and encode took.
"""

from __future__ import annotations

import glob
import logging
import math
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ... import faults
from ...atomic import atomic_path, atomic_write_bytes, atomic_write_text
from ...ops._kernels import count
from ...ops.resize import MAX_INPUT_EDGE, resize_batch_host
from ...retry import is_disk_full, note_disk_full

logger = logging.getLogger(__name__)

TARGET_PX = 262_144.0
WEBP_QUALITY = 30
THUMBNAIL_VERSION = 1

THUMBNAILABLE_IMAGE_EXTENSIONS = {
    "jpg", "jpeg", "png", "gif", "bmp", "webp", "tiff", "tif", "ico",
}
THUMBNAILABLE_VIDEO_EXTENSIONS = {
    "mp4", "mkv", "avi", "mov", "webm", "m4v", "mpg", "mpeg",
}
#: decoded through libheif (``native/sd_heif.cc``) where its runtime loads
HEIF_EXTENSIONS = {"heic", "heif", "avif"}

_FFMPEG = shutil.which("ffmpeg")

#: images decoded, resized and encoded per device call: bounds the padded
#: batch and the decoded arrays held at once
RESIZE_SUB_BATCH = 32

#: decodes and encodes that succeeded, by route: "native" / "pil" (images),
#: "heif" (libheif), "video_native" (a frame from ``sd_ffmpeg.cc``) and
#: "video_cli" (a frame, and its WebP, from the ``ffmpeg`` CLI)
DECODES: Counter = Counter()
ENCODES: Counter = Counter()


def reset_counts() -> None:
    DECODES.clear()
    ENCODES.clear()


_THUMB_DIRS_READY: set[str] = set()


def thumbnail_dir(data_dir: str | Path) -> Path:
    d = Path(data_dir) / "thumbnails"
    # made and stamped once per data dir and process; a concurrent first
    # call repeats idempotent work
    key = str(d)
    if key not in _THUMB_DIRS_READY:
        d.mkdir(parents=True, exist_ok=True)
        version_file = d / "version.txt"
        if not version_file.exists():
            atomic_write_text(version_file, str(THUMBNAIL_VERSION))
        _THUMB_DIRS_READY.add(key)
    return d


def thumbnail_path(data_dir: str | Path, cas_id: str) -> Path:
    """The cache path: sharded by the first two hex digits of the cas_id."""
    return thumbnail_dir(data_dir) / cas_id[:2] / f"{cas_id}.webp"


def can_generate_thumbnail(extension: str | None) -> bool:
    ext = (extension or "").lower()
    return ext in THUMBNAILABLE_IMAGE_EXTENSIONS or (
        ext in THUMBNAILABLE_VIDEO_EXTENSIONS and _ffmpeg_capable()
    ) or (ext in HEIF_EXTENSIONS and _native_heif() is not None)


def _ffmpeg_capable() -> bool:
    """Can some route decode video here? Answered without compiling, as
    listing paths ask it: the ``ffmpeg`` CLI, else the native probe's
    answer once it ran, else whether the libav headers exist. The build
    itself happens at the first video thumbnail, inside a job."""
    if _FFMPEG is not None:
        return True
    if _NATIVE_FFMPEG is not None:
        return _NATIVE_FFMPEG[0] is not None
    return bool(glob.glob("/usr/include/libavformat")
                or glob.glob("/usr/include/*/libavformat")
                or glob.glob("/usr/local/include/libavformat"))


def generate_thumbnail(source: str | Path, data_dir: str | Path, cas_id: str,
                       extension: str | None = None) -> Path | None:
    """Make (or reuse) one file's WebP thumbnail on the host; returns its
    path, or None after logging any failure. A full disk (the
    ``thumbnail`` seam rehearses one) skips the file: a thumbnail can be
    made again later. The write is atomic."""
    out = thumbnail_path(data_dir, cas_id)
    if out.exists():
        return out
    ext = (extension or Path(source).suffix.lstrip(".")).lower()
    try:
        faults.inject("thumbnail", key=cas_id)
        if ext in THUMBNAILABLE_VIDEO_EXTENSIONS:
            return _video_thumbnail(Path(source), out)
        return _image_thumbnail(Path(source), out, ext)
    except Exception as e:
        if is_disk_full(e):
            note_disk_full("thumbnail")
        logger.warning("thumbnail failed for %s: %s", source, e)
        return None


_NATIVE_IMAGES: list | None = None  # [module or None] once probed
_NATIVE_FFMPEG: list | None = None
_NATIVE_HEIF: list | None = None


def _native_heif():
    """The libheif binding if it builds and the runtime loads, else None
    (HEIF images are then not thumbnailable). Probed once a process."""
    global _NATIVE_HEIF
    if _NATIVE_HEIF is None:
        from ...native import heif_native

        try:
            if heif_native.available():
                logger.info("libheif loaded: HEIF images decode natively")
                _NATIVE_HEIF = [heif_native]
            else:
                logger.warning("heif support unavailable: the libheif runtime "
                               "(libheif.so.1) did not load")
                _NATIVE_HEIF = [None]
        except Exception as e:
            logger.warning("heif support unavailable: %s", e)
            _NATIVE_HEIF = [None]
    return _NATIVE_HEIF[0]


def _native_ffmpeg():
    """The linked FFmpeg wrapper if it builds, else None (videos then take
    the ``ffmpeg`` CLI where it exists). Probed once a process: a failed
    build costs a g++ run."""
    global _NATIVE_FFMPEG
    if _NATIVE_FFMPEG is None:
        from ...native import ffmpeg_native

        try:
            path = ffmpeg_native.library()
            logger.info("native ffmpeg built: %s", path)
            _NATIVE_FFMPEG = [ffmpeg_native]
        except Exception as e:
            logger.warning("native ffmpeg unavailable, %s: %s",
                           "using the ffmpeg CLI" if _FFMPEG else "no ffmpeg CLI either", e)
            _NATIVE_FFMPEG = [None]
    return _NATIVE_FFMPEG[0]


def _native_images():
    """The native codecs if they build here, else None (then PIL). The
    probe runs once a process: a failed build costs a g++ run."""
    global _NATIVE_IMAGES
    if _NATIVE_IMAGES is None:
        from ...native import images_native

        try:
            path = images_native.library()
            logger.info("native image codecs built: %s", path)
            _NATIVE_IMAGES = [images_native]
        except Exception as e:
            logger.warning("native image codecs unavailable, decoding and encoding with "
                           "PIL: %s", e)
            _NATIVE_IMAGES = [None]
    return _NATIVE_IMAGES[0]


def _native_decode(source: Path):
    """RGB array from the native decoder, or None: the caller uses PIL."""
    native = _native_images()
    ext = source.suffix.lstrip(".").lower()
    if native is None or ext not in native.NATIVE_DECODE_EXTENSIONS:
        return None
    try:
        arr = native.decode_rgb(source, MAX_INPUT_EDGE)
    except Exception as e:
        logger.debug("native decode fell back to PIL for %s: %s", source, e)
        return None
    count(DECODES, "native")
    return arr


def _heif_decode(source: Path) -> np.ndarray:
    heif = _native_heif()
    if heif is None:
        raise RuntimeError("libheif runtime not available")
    arr = heif.decode_rgb(source)
    count(DECODES, "heif")
    return arr


def _fit_target_area(img):
    """``img`` (PIL) scaled by PIL so that w*h is about TARGET_PX, if it is
    larger: the per-file route's resize."""
    w, h = img.size
    if w * h > TARGET_PX:
        factor = math.sqrt(TARGET_PX / (w * h))
        img = img.resize((max(1, round(w * factor)), max(1, round(h * factor))))
    return img


def _image_thumbnail(source: Path, out: Path, ext: str | None = None) -> Path:
    from PIL import Image

    if (ext or source.suffix.lstrip(".").lower()) in HEIF_EXTENSIONS:
        arr = _heif_decode(source)
    else:
        # native decode (a JPEG scaled down in DCT space near the target)
        arr = _native_decode(source)
    img = Image.fromarray(arr) if arr is not None else Image.open(source)
    with img:
        img = _fit_target_area(img.convert("RGB") if img.mode not in ("RGB", "RGBA") else img)
        with atomic_path(out) as tmp:
            _save_webp(img, tmp)
    if arr is None:
        count(DECODES, "pil")
    return out


def _save_webp(img, tmp: Path) -> None:
    """Write ``img`` (a PIL image, or an RGB uint8 array from the batched
    route, which then needs no PIL on a host with the native encoder) as
    WebP at ``tmp``."""
    native = _native_images()
    if native is not None:
        try:
            rgb = img if isinstance(img, np.ndarray) else np.asarray(img.convert("RGB"),
                                                                     dtype=np.uint8)
            tmp.write_bytes(native.encode_webp(rgb, WEBP_QUALITY))
            count(ENCODES, "native")
            return
        except Exception as e:
            logger.debug("native webp encode fell back to PIL: %s", e)
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(tmp, "WEBP", quality=WEBP_QUALITY)
    count(ENCODES, "pil")


def _video_thumbnail(source: Path, out: Path) -> Path | None:
    """One frame (cover art first, else 10% in) from the native wrapper,
    resized to the target area by PIL and encoded as WebP; else the
    ``ffmpeg`` CLI grabs the frame and writes the WebP. None when neither
    route made it."""
    native = _native_ffmpeg()
    if native is not None:
        try:
            from PIL import Image

            frame = native.decode_frame_rgb(source)
            count(DECODES, "video_native")
            img = _fit_target_area(Image.fromarray(frame))
            with atomic_path(out) as tmp:
                _save_webp(img, tmp)
            return out
        except Exception as e:
            logger.warning("native video decode failed for %s (%s)%s", source, e,
                           "; trying the ffmpeg CLI" if _FFMPEG else "")
    if _FFMPEG is None:
        return None
    with atomic_path(out) as tmp:
        _cli_grab_frame(source, tmp, 512, webp_quality=WEBP_QUALITY)
    count(DECODES, "video_cli")
    count(ENCODES, "video_cli")
    return out


def _cli_grab_frame(source: Path, out: Path, size: int, webp_quality: int | None = None) -> None:
    """One frame through the ``ffmpeg`` CLI: the one place its command
    lives (seek, scale filter, time limit) for the thumbnail and the bytes
    helper."""
    cmd = [_FFMPEG, "-y", "-loglevel", "error", "-ss", "00:00:01",
           "-i", str(source), "-frames:v", "1",
           "-vf", f"scale='min({size},iw)':-2"]
    if webp_quality is not None:
        # the atomic write's temporary has no .webp suffix to infer from
        cmd += ["-f", "webp", "-quality", str(webp_quality)]
    subprocess.run(cmd + [str(out)], check=True, timeout=30, capture_output=True)


# ---------------------------------------------------------------------------
# video helpers (the reference's to_thumbnail / to_webp_bytes and its film
# strip filter)
# ---------------------------------------------------------------------------


def film_strip_filter(arr) -> np.ndarray:
    """Sprocket-hole strips down both edges, drawn procedurally: a dark
    band with repeating light holes."""
    arr = np.asarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    strip_w = max(4, w // 16)
    hole_h = max(2, strip_w // 2)
    period = hole_h * 2
    out = arr.copy()
    hole_w = max(1, strip_w // 2)
    x_off = (strip_w - hole_w) // 2
    for x0 in (0, w - strip_w):
        strip = out[:, x0:x0 + strip_w]
        strip[:] = (strip * 0.15).astype(np.uint8)
        for y0 in range(period // 2, h - hole_h, period):
            strip[y0:y0 + hole_h, x_off:x_off + hole_w] = 230
    return out


def video_to_webp_bytes(source: str | Path, size: int = 256, quality: int = WEBP_QUALITY,
                        film_strip: bool = False) -> bytes:
    """One video thumbnail as WebP bytes, the frame scaled to ``size`` on
    its long edge; the film strip is opt-in. The native wrapper first, else
    the ``ffmpeg`` CLI, as :func:`generate_thumbnail` chooses."""
    import io
    import tempfile

    from PIL import Image

    frame = None
    native = _native_ffmpeg()
    if native is not None:
        try:
            frame = native.decode_frame_rgb(Path(source), target_edge=size)
        except Exception as e:
            logger.warning("native video decode failed for %s (%s)%s", source, e,
                           "; trying the ffmpeg CLI" if _FFMPEG else "")
    if frame is None:
        if _FFMPEG is None:
            raise RuntimeError("no video decode backend (libav libs or ffmpeg CLI required)")
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td) / "frame.png"
            _cli_grab_frame(Path(source), tmp, size)
            with Image.open(tmp) as img:
                frame = np.asarray(img.convert("RGB"), dtype=np.uint8)
    if film_strip:
        frame = film_strip_filter(frame)
    images = _native_images()
    if images is not None:
        try:
            return images.encode_webp(frame, quality)
        except Exception:
            logger.debug("native webp encode failed; using PIL", exc_info=True)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "WEBP", quality=quality)
    return buf.getvalue()


def video_to_thumbnail(source: str | Path, out: str | Path, size: int = 256,
                       quality: int = WEBP_QUALITY, film_strip: bool = False) -> None:
    """Write one video thumbnail file, atomically."""
    atomic_write_bytes(Path(out), video_to_webp_bytes(source, size, quality, film_strip))


def _decode_for_device(source: Path) -> np.ndarray:
    """Decode (libheif for HEIF; native libjpeg / libpng where they build,
    a JPEG scaled down in DCT space) and box-reduce by an integer factor to
    at most MAX_INPUT_EDGE: a cheap antialiasing pass on the host before
    the device's fractional bilinear step."""
    if source.suffix.lstrip(".").lower() in HEIF_EXTENSIONS:
        arr = _heif_decode(source)
    else:
        arr = _native_decode(source)
    if arr is not None:
        edge = max(arr.shape[0], arr.shape[1])
        if edge > MAX_INPUT_EDGE:  # PNG and HEIF have no in-decode scaling
            k = -(-edge // MAX_INPUT_EDGE)
            h, w = (arr.shape[0] // k) * k, (arr.shape[1] // k) * k
            arr = arr[:h, :w].reshape(h // k, k, w // k, k, 3) \
                .mean(axis=(1, 3)).astype(np.uint8)
        return arr
    from PIL import Image

    with Image.open(source) as img:
        img = img.convert("RGB")
        edge = max(img.size)
        if edge > MAX_INPUT_EDGE:
            img = img.reduce(-(-edge // MAX_INPUT_EDGE))
        arr = np.asarray(img, dtype=np.uint8)
    count(DECODES, "pil")
    return arr


def resize_images(arrays: list[np.ndarray], device: torch.device) -> list[np.ndarray]:
    """The batch resize of decoded RGB arrays on ``device``: the seam the
    processor and ``chip_smoke.py`` measure. It never routes elsewhere; a
    device failure raises."""
    return resize_batch_host(arrays, device)


def generate_thumbnails_batched(entries: list[tuple[str, str, str | None]],
                                data_dir: str | Path, device: torch.device) -> dict[str, Path]:
    """Thumbnails of ``entries`` ([(source path, cas_id, extension)]):
    host decode, the resize on ``device`` in RESIZE_SUB_BATCH sub-batches,
    host WebP encode; a video takes the per-file route. Returns {cas_id:
    path} for every thumbnail that exists afterwards. A file whose decode
    or encode fails is logged and left out (the processor retries it
    alone); a failure of the resize raises."""
    out_paths: dict[str, Path] = {}
    todo = []  # (source, cas_id, out path) still needing a thumbnail
    for source, cas_id, ext in entries:
        out = thumbnail_path(data_dir, cas_id)
        if out.exists():
            out_paths[cas_id] = out
            continue
        ext = (ext or Path(source).suffix.lstrip(".")).lower()
        if ext in THUMBNAILABLE_VIDEO_EXTENSIONS:
            made = generate_thumbnail(source, data_dir, cas_id, ext)
            if made is not None:
                out_paths[cas_id] = made
            continue
        todo.append((source, cas_id, out))

    for start in range(0, len(todo), RESIZE_SUB_BATCH):
        arrays, made_for = [], []
        for source, cas_id, out in todo[start : start + RESIZE_SUB_BATCH]:
            try:
                arrays.append(_decode_for_device(Path(source)))
                made_for.append((cas_id, out))
            except Exception as e:
                logger.warning("decode failed for %s: %s", source, e)
        if not arrays:
            continue
        thumbs = resize_images(arrays, device)
        for (cas_id, out), thumb in zip(made_for, thumbs):
            try:
                faults.inject("thumbnail", key=cas_id)
                with atomic_path(out) as tmp:
                    _save_webp(thumb, tmp)
                out_paths[cas_id] = out
            except Exception as e:
                if is_disk_full(e):
                    note_disk_full("thumbnail")
                logger.warning("thumbnail encode failed for %s: %s", cas_id, e)
    return out_paths
