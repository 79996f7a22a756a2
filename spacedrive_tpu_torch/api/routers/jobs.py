"""jobs procedures (``spacedrive_tpu/api/routers/jobs.py`` :16-88) as plain
functions of ``(node, library, arg)`` or ``(node, arg)``: the reports,
``isActive``, ``clear``, ``clearAll``, ``pause``, ``resume``, ``cancel`` and
the job launchers. The router, its query invalidation and the
``jobs.progress`` / ``jobs.newThumbnail`` subscriptions are not ported (the
events they serve, ``job_progress`` and ``new_thumbnail``, are on the node's
bus)."""

from __future__ import annotations

from ...jobs import JobStatus
from ...models import JobRow
from ...objects.validator import ObjectValidatorJob

_ACTIVE = {JobStatus.QUEUED, JobStatus.RUNNING, JobStatus.PAUSED}


def reports(node, library, _arg=None) -> list[dict]:
    """jobs.reports: every report, newest first, children grouped under
    their chain's head; the serialized state stays internal."""
    by_parent: dict[str | None, list] = {}
    for r in library.db.find(JobRow, order_by="date_created DESC"):
        r.pop("data", None)
        r["status_name"] = JobStatus.NAMES.get(r["status"], "?")
        by_parent.setdefault(r["parent_id"], []).append(r)
    out = []
    for head in by_parent.get(None, []):
        head["children"] = by_parent.get(head["id"], [])
        out.append(head)
    return out


def is_active(node, _arg=None) -> bool:
    return node.jobs.is_active()


def clear(node, library, job_id: str) -> None:
    library.db.delete(JobRow, {"id": job_id})


def clear_all(node, library, _arg=None) -> None:
    """jobs.clearAll: remove every report that is not active."""
    for row in library.db.find(JobRow):
        if row["status"] not in _ACTIVE:
            library.db.delete(JobRow, {"id": row["id"]})


def pause(node, job_id: str) -> bool:
    return node.jobs.pause(job_id)


def resume(node, library, job_id: str) -> bool:
    return node.jobs.resume(library, job_id)


def cancel(node, job_id: str) -> bool:
    return node.jobs.cancel(job_id)


def object_validator(node, library, arg) -> str:
    """jobs.objectValidator: spawn the validator over a location (or its
    ``sub_path``); ``revalidate`` checks the stored checksums. Returns the
    job id."""
    return node.jobs.spawn(library, [ObjectValidatorJob({
        "location_id": arg["location_id"],
        "sub_path": arg.get("sub_path"),
        "revalidate": arg.get("revalidate", False)})])


def identify_unique_files(node, library, arg) -> str:
    from ...objects.file_identifier import FileIdentifierJob

    return node.jobs.spawn(library, [FileIdentifierJob({
        "location_id": arg["location_id"], "sub_path": arg.get("sub_path")})])


def generate_thumbs_for_location(node, library, arg) -> str:
    from ...objects.media.processor import MediaProcessorJob

    return node.jobs.spawn(library, [MediaProcessorJob({
        "location_id": arg["location_id"], "sub_path": arg.get("sub_path"),
        "regenerate": arg.get("regenerate", False)})])
