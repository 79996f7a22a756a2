"""Image metadata: EXIF fields and the GPS fix as a ``media_data`` row.

Counterpart of the image part of ``spacedrive_tpu/objects/media/
metadata.py`` (``extract_media_data`` :39, ``_extract_image`` :72,
``_gps_to_decimal`` :232, ``encode_pluscode`` :260): the image's
dimensions, capture date, camera fields (make, model, orientation,
software, exposure, aperture, ISO, focal length, flash, lens), and the GPS
location with its Open Location Code. EXIF is read with PIL only, as in the
reference: without PIL an image gets no row. Audio, video and HEIF wait for
their slice; ``extract_media_data`` answers None for them.
"""

from __future__ import annotations

import logging
from typing import Any

from .thumbnail import THUMBNAILABLE_IMAGE_EXTENSIONS

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


def extract_media_data(path: str, extension: str) -> dict[str, Any] | None:
    if extension in THUMBNAILABLE_IMAGE_EXTENSIONS:
        return _extract_image(path)
    return None


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
