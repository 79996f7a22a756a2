"""Media metadata as a ``media_data`` row: EXIF and the GPS fix of an
image, the dimensions of a HEIF image, the streams of a video or an audio
file.

Counterpart of ``spacedrive_tpu/objects/media/metadata.py``
(``extract_media_data`` :39, ``_extract_heif`` :55, ``_extract_image``
:72, ``_extract_av`` :122, ``_native_probe`` :184, ``_gps_to_decimal``
:232, ``encode_pluscode`` :260). An image gets its dimensions, capture
date, camera fields (make, model, orientation, software, exposure,
aperture, ISO, focal length, flash, lens) and the GPS location with its
Open Location Code, read with PIL only, as in the reference: without PIL
an image gets no row. A HEIF image gets the dimensions libheif reads from
its container, with no HEVC decode. A video or an audio file gets its
duration, bit rate, container tags and streams from the linked libav
probe (``native/sd_ffmpeg.cc``), else from an ``ffprobe`` subprocess,
both shaped alike; with neither (or no libheif) the file gets no row.
:data:`PROBES` counts the rows each route made.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from collections import Counter
from typing import Any

from ...ops._kernels import count
from . import thumbnail
from .thumbnail import HEIF_EXTENSIONS, THUMBNAILABLE_IMAGE_EXTENSIONS, THUMBNAILABLE_VIDEO_EXTENSIONS

logger = logging.getLogger(__name__)

_EXIF_TAGS = {
    271: "camera_make", 272: "camera_model", 306: "media_date",
    36867: "media_date", 315: "artist", 33432: "copyright", 36864: "exif_version",
}

#: ExifIFD (0x8769) camera detail tags → camera_data keys
_EXIF_IFD_TAGS = {
    33434: "exposure_time", 33437: "f_number", 34855: "iso",
    37386: "focal_length", 37385: "flash", 42035: "lens_make",
    42036: "lens_model",
}


AUDIO_EXTENSIONS = {"mp3", "wav", "flac", "ogg", "m4a", "aac", "opus", "wma"}

_FFPROBE = shutil.which("ffprobe")

#: rows made, by route: "heif" (container dimensions), "native" (the libav
#: probe), "ffprobe"
PROBES: Counter = Counter()


def reset_counts() -> None:
    PROBES.clear()


def extract_media_data(path: str, extension: str) -> dict[str, Any] | None:
    if extension in THUMBNAILABLE_IMAGE_EXTENSIONS:
        return _extract_image(path)
    if extension in HEIF_EXTENSIONS:
        return _extract_heif(path)
    if extension in THUMBNAILABLE_VIDEO_EXTENSIONS or extension in AUDIO_EXTENSIONS:
        return _extract_av(path)
    return None


def _extract_heif(path: str) -> dict[str, Any] | None:
    """The primary image's dimensions, read from the container without an
    HEVC decode (PIL opens no HEIF; EXIF inside HEIF is not read, as in the
    reference)."""
    heif = thumbnail._native_heif()
    if heif is None:
        return None
    try:
        w, h = heif.dims(path)
    except Exception as e:
        logger.debug("no media data for %s: %s", path, e)
        return None
    count(PROBES, "heif")
    return {"dimensions": {"width": w, "height": h}}


def _extract_image(path: str) -> dict[str, Any] | None:
    try:
        from PIL import Image

        with Image.open(path) as img:
            out: dict[str, Any] = {"dimensions": {"width": img.width, "height": img.height}}
            exif = img.getexif()
            camera: dict[str, Any] = {}
            for tag, value in exif.items():
                name = _EXIF_TAGS.get(tag)
                if name in ("artist", "copyright", "media_date", "exif_version"):
                    out[name] = str(value)
                elif name in ("camera_make", "camera_model"):
                    camera[name] = str(value)
            orientation = exif.get(274)
            if orientation:
                camera["orientation"] = int(orientation)
            software = exif.get(305)
            if software:
                camera["software"] = str(software)
            try:
                ifd = exif.get_ifd(0x8769)
                for tag, name in _EXIF_IFD_TAGS.items():
                    if tag in ifd:
                        value = ifd[tag]
                        camera[name] = (float(value)
                                        if isinstance(value, (int, float)) or
                                        hasattr(value, "__float__")
                                        else str(value))
            except Exception:
                # the file still gets base metadata; only the EXIF sub-IFD
                # (exposure/aperture/ISO) is skipped — but say so, or a
                # corrupt IFD looks like a camera that wrote no EXIF at all
                logger.debug("unreadable EXIF sub-IFD in %s", path,
                             exc_info=True)
            if camera:
                out["camera_data"] = camera
            gps = exif.get_ifd(0x8825) if hasattr(exif, "get_ifd") else None
            if gps:
                loc = _gps_to_decimal(gps)
                if loc:
                    loc["pluscode"] = encode_pluscode(
                        loc["latitude"], loc["longitude"])
                    out["media_location"] = loc
            return out
    except Exception as e:
        logger.debug("no media data for %s: %s", path, e)
        return None


def _extract_av(path: str) -> dict[str, Any] | None:
    """Stream metadata (duration, codecs, dimensions, rates): the linked
    libav probe where the native wrapper builds, else ``ffprobe``."""
    native = _native_probe(path)
    if native is not None:
        count(PROBES, "native")
        return native
    if _FFPROBE is None:
        return None
    try:
        proc = subprocess.run(
            [_FFPROBE, "-v", "error", "-print_format", "json",
             "-show_format", "-show_streams", path],
            capture_output=True, timeout=30, check=True)
        probe = json.loads(proc.stdout.decode())
    except Exception as e:
        logger.debug("ffprobe failed for %s: %s", path, e)
        return None
    out: dict[str, Any] = {}
    fmt = probe.get("format", {})
    streams_out = []
    for stream in probe.get("streams", []):
        entry: dict[str, Any] = {
            "codec_type": stream.get("codec_type"),
            "codec": stream.get("codec_name"),
        }
        if stream.get("codec_type") == "video":
            entry["width"] = stream.get("width")
            entry["height"] = stream.get("height")
            rate = stream.get("avg_frame_rate", "0/1")
            try:
                num, _, den = rate.partition("/")
                entry["fps"] = round(float(num) / float(den or 1), 3)
            except (ValueError, ZeroDivisionError):
                pass
            # the first real video stream gives the dimensions; cover art
            # never does (as in the native probe: rows shaped alike)
            attached = (stream.get("disposition") or {}).get("attached_pic")
            if "width" in stream and "height" in stream and not attached:
                out.setdefault("dimensions", {"width": stream["width"],
                                              "height": stream["height"]})
        elif stream.get("codec_type") == "audio":
            entry["channels"] = stream.get("channels")
            # ffprobe writes sample_rate as a string, the native probe an int
            rate = stream.get("sample_rate")
            entry["sample_rate"] = int(rate) if rate is not None else None
        streams_out.append(entry)
    duration = fmt.get("duration")
    if duration is not None:
        out["duration_seconds"] = round(float(duration), 3)
    if fmt.get("bit_rate"):
        out["bit_rate"] = int(fmt["bit_rate"])
    if streams_out:
        out["streams"] = streams_out
    tags = fmt.get("tags", {}) or {}
    for src, dst in (("artist", "artist"), ("copyright", "copyright"),
                     ("creation_time", "media_date")):
        if tags.get(src):
            out[dst] = str(tags[src])
    if out:
        count(PROBES, "ffprobe")
    return out or None


def _native_probe(path: str) -> dict[str, Any] | None:
    """The ``media_data`` fields from the linked libav probe, shaped as the
    ffprobe branch shapes them, so that either route fills the same
    columns."""
    native = thumbnail._native_ffmpeg()
    if native is None:
        return None
    try:
        probe = native.probe(path)
    except Exception as e:
        logger.debug("native probe failed for %s: %s", path, e)
        return None
    out: dict[str, Any] = {}
    streams_out = []
    for stream in probe.get("streams", []):
        entry: dict[str, Any] = {
            "codec_type": stream.get("codec_type"),
            "codec": stream.get("codec"),
        }
        if stream.get("codec_type") == "video":
            entry["width"] = stream.get("width")
            entry["height"] = stream.get("height")
            if stream.get("fps"):
                entry["fps"] = stream["fps"]
            # cover art never gives the media's dimensions
            if not stream.get("attached_pic") and "width" in stream:
                out.setdefault("dimensions", {"width": stream["width"],
                                              "height": stream["height"]})
        elif stream.get("codec_type") == "audio":
            entry["channels"] = stream.get("channels")
            entry["sample_rate"] = stream.get("sample_rate")
        streams_out.append(entry)
    if probe.get("duration_seconds") is not None:
        out["duration_seconds"] = probe["duration_seconds"]
    if probe.get("bit_rate"):
        out["bit_rate"] = int(probe["bit_rate"])
    if streams_out:
        out["streams"] = streams_out
    tags = probe.get("tags", {}) or {}
    lower = {k.lower(): v for k, v in tags.items()}
    for src, dst in (("artist", "artist"), ("copyright", "copyright"),
                     ("creation_time", "media_date")):
        if lower.get(src):
            out[dst] = str(lower[src])
    return out or None


def _gps_to_decimal(gps: dict) -> dict[str, float] | None:
    try:
        lat, lat_ref = gps.get(2), gps.get(1, "N")
        lon, lon_ref = gps.get(4), gps.get(3, "E")
        if not lat or not lon:
            return None

        def to_deg(v):
            d, m, s = (float(x) for x in v)
            return d + m / 60 + s / 3600

        latitude = to_deg(lat) * (-1 if lat_ref in ("S", b"S") else 1)
        longitude = to_deg(lon) * (-1 if lon_ref in ("W", b"W") else 1)
        return {"latitude": latitude, "longitude": longitude}
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Open Location Code (plus codes) — implemented from the public spec
# (as the reference's, from the public spec)
# ---------------------------------------------------------------------------

_OLC_ALPHABET = "23456789CFGHJMPQRVWX"
_OLC_SEPARATOR = "+"
_OLC_PAIR_CODE_LEN = 10


def encode_pluscode(latitude: float, longitude: float) -> str:
    """Standard 10-digit plus code (e.g. 8FVC9G8F+6X)."""
    lat = min(90.0, max(-90.0, latitude))
    lon = longitude
    while lon < -180.0:
        lon += 360.0
    while lon >= 180.0:
        lon -= 360.0
    # positive integer space at the finest pair resolution: 1/8000 degree
    # (5 base-20 digit pairs); the 90°/180° edge clips into the last cell
    lat_val = min(int((lat + 90.0) * 8000), 180 * 8000 - 1)
    lon_val = min(int((lon + 180.0) * 8000), 360 * 8000 - 1)
    digits: list[str] = []
    for _ in range(_OLC_PAIR_CODE_LEN // 2):
        digits.append(_OLC_ALPHABET[lon_val % 20])
        digits.append(_OLC_ALPHABET[lat_val % 20])
        lat_val //= 20
        lon_val //= 20
    code = "".join(reversed(digits))
    return code[:8] + _OLC_SEPARATOR + code[8:]
