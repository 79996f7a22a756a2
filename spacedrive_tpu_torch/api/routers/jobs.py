"""jobs procedures (``spacedrive_tpu/api/routers/jobs.py``), trimmed to the
object validator."""

from __future__ import annotations

from ...objects.validator import ObjectValidatorJob


def object_validator(node, library, arg) -> str:
    """jobs.objectValidator: spawn the validator over a location (or its
    ``sub_path``); ``revalidate`` checks the stored checksums. Returns the
    job id."""
    return node.jobs.spawn(library, [ObjectValidatorJob({
        "location_id": arg["location_id"],
        "sub_path": arg.get("sub_path"),
        "revalidate": arg.get("revalidate", False)})])
