"""Thumbnails of images: WebP previews in a cas_id-sharded cache.

Counterpart of the image part of ``spacedrive_tpu/objects/media/
thumbnail.py``: a target area of 262,144 px² at WebP quality 30, the cache
at ``<data_dir>/thumbnails/<cas_id[:2]>/<cas_id>.webp`` beside a
``version.txt``.

The batched route (:func:`generate_thumbnails_batched`) decodes each
image on the host, reduces anything with an edge over ``MAX_INPUT_EDGE``
by an integer box factor, resizes each sub-batch of ``RESIZE_SUB_BATCH``
images on the node's device (:func:`..ops.resize.resize_batch_host`) and
encodes the thumbnails on the host. The reference's sticky per-process
verdict (its ``_DEVICE_VERDICT``, ``_measure_device_verdict``,
``_device_resize_allowed``, ``_pil_resize_all``) and its scalar fallback
after a failed device resize are not ported: on the node's device the
batched route always resizes there, and a failure of the device resize
raises out of :func:`generate_thumbnails_batched`. :func:`generate_thumbnail`
is the reference's per-file route (decode, PIL resize, encode), which the
processor takes only for a file whose host decode or encode failed in the
batch.

Codecs are a host choice, in the reference's order: the native helper
(``native/sd_images.cc``: libjpeg, libpng, libwebp) where it builds, else
PIL. The probe runs once and logs its outcome, with the build error when
there is one; :data:`DECODES` and :data:`ENCODES` count the route each
decode and encode took.

Video, audio and HEIF are not ported: :func:`can_generate_thumbnail`
answers for image extensions only.
"""

from __future__ import annotations

import logging
import math
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ... import faults
from ...atomic import atomic_path, atomic_write_text
from ...ops.resize import MAX_INPUT_EDGE, resize_batch_host
from ...retry import is_disk_full, note_disk_full

logger = logging.getLogger(__name__)

TARGET_PX = 262_144.0
WEBP_QUALITY = 30
THUMBNAIL_VERSION = 1

THUMBNAILABLE_IMAGE_EXTENSIONS = {
    "jpg", "jpeg", "png", "gif", "bmp", "webp", "tiff", "tif", "ico",
}

#: images decoded, resized and encoded per device call: bounds the padded
#: batch and the decoded arrays held at once
RESIZE_SUB_BATCH = 32

#: decodes and encodes that succeeded, by route ("native" / "pil")
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
    return (extension or "").lower() in THUMBNAILABLE_IMAGE_EXTENSIONS


def generate_thumbnail(source: str | Path, data_dir: str | Path, cas_id: str) -> Path | None:
    """Make (or reuse) one file's WebP thumbnail on the host; returns its
    path, or None after logging any failure. A full disk (the
    ``thumbnail`` seam rehearses one) skips the file: a thumbnail can be
    made again later. The write is atomic."""
    out = thumbnail_path(data_dir, cas_id)
    if out.exists():
        return out
    try:
        faults.inject("thumbnail", key=cas_id)
        return _image_thumbnail(Path(source), out)
    except Exception as e:
        if is_disk_full(e):
            note_disk_full("thumbnail")
        logger.warning("thumbnail failed for %s: %s", source, e)
        return None


_NATIVE_IMAGES: list | None = None  # [module or None] once probed


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
    DECODES["native"] += 1
    return arr


def _image_thumbnail(source: Path, out: Path) -> Path:
    from PIL import Image

    # native decode (a JPEG scaled down in DCT space near the target)
    arr = _native_decode(source)
    img = Image.fromarray(arr) if arr is not None else Image.open(source)
    with img:
        img = img.convert("RGB") if img.mode not in ("RGB", "RGBA") else img
        w, h = img.size
        # scale so that w*h is about TARGET_PX
        if w * h > TARGET_PX:
            factor = math.sqrt(TARGET_PX / (w * h))
            img = img.resize((max(1, round(w * factor)), max(1, round(h * factor))))
        with atomic_path(out) as tmp:
            _save_webp(img, tmp)
    if arr is None:
        DECODES["pil"] += 1
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
            ENCODES["native"] += 1
            return
        except Exception as e:
            logger.debug("native webp encode fell back to PIL: %s", e)
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(tmp, "WEBP", quality=WEBP_QUALITY)
    ENCODES["pil"] += 1


def _decode_for_device(source: Path) -> np.ndarray:
    """Decode (native libjpeg / libpng where they build, a JPEG scaled down
    in DCT space) and box-reduce by an integer factor to at most
    MAX_INPUT_EDGE: a cheap antialiasing pass on the host before the
    device's fractional bilinear step."""
    arr = _native_decode(source)
    if arr is not None:
        edge = max(arr.shape[0], arr.shape[1])
        if edge > MAX_INPUT_EDGE:  # PNG has no in-decode scaling
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
    DECODES["pil"] += 1
    return arr


def resize_images(arrays: list[np.ndarray], device: torch.device) -> list[np.ndarray]:
    """The batch resize of decoded RGB arrays on ``device``: the seam the
    processor and ``chip_smoke.py`` measure. It never routes elsewhere; a
    device failure raises."""
    return resize_batch_host(arrays, device)


def generate_thumbnails_batched(entries: list[tuple[str, str]], data_dir: str | Path,
                                device: torch.device) -> dict[str, Path]:
    """Thumbnails of ``entries`` ([(source path, cas_id)]): host decode,
    the resize on ``device`` in RESIZE_SUB_BATCH sub-batches, host WebP
    encode. Returns {cas_id: path} for every thumbnail that exists
    afterwards. A file whose decode or encode fails is logged and left
    out (the processor retries it alone); a failure of the resize raises."""
    out_paths: dict[str, Path] = {}
    todo = []  # (source, cas_id, out path) still needing a thumbnail
    for source, cas_id in entries:
        out = thumbnail_path(data_dir, cas_id)
        if out.exists():
            out_paths[cas_id] = out
        else:
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
