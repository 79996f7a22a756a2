"""jobs.* procedures (``spacedrive_tpu/api/routers/jobs.py``): the reports,
``isActive``, ``clear``, ``clearAll``, ``pause``, ``resume``, ``cancel``, the
job launchers, and the ``jobs.progress`` / ``jobs.newThumbnail``
subscriptions to the ``job_progress`` and ``new_thumbnail`` events of the
library. Each handler is a plain function of ``(node, library, arg)`` or
``(node, arg)`` too; :func:`mount` registers them under the reference's
keys."""

from __future__ import annotations

from ...jobs import JobStatus
from ...models import JobRow
from ...objects.validator import ObjectValidatorJob
from ..invalidate import invalidate_query
from ._util import filtered_subscription

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
    invalidate_query(library, "jobs.reports")


def clear_all(node, library, _arg=None) -> None:
    """jobs.clearAll: remove every report that is not active."""
    for row in library.db.find(JobRow):
        if row["status"] not in _ACTIVE:
            library.db.delete(JobRow, {"id": row["id"]})
    invalidate_query(library, "jobs.reports")


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


def progress(node, library, _arg=None):
    """jobs.progress: the library's job_progress events."""
    return filtered_subscription(node, {"job_progress"}, library.id)


def new_thumbnail(node, library, _arg=None):
    """jobs.newThumbnail: the library's new_thumbnail events."""
    return filtered_subscription(node, {"new_thumbnail"}, library.id)


def mount(router) -> None:
    router.library_query("jobs.reports")(reports)
    router.query("jobs.isActive")(is_active)
    router.library_mutation("jobs.clear")(clear)
    router.library_mutation("jobs.clearAll")(clear_all)
    router.mutation("jobs.pause")(pause)
    router.library_mutation("jobs.resume")(resume)
    router.mutation("jobs.cancel")(cancel)
    router.library_mutation("jobs.objectValidator")(object_validator)
    router.library_mutation("jobs.identifyUniqueFiles")(identify_unique_files)
    router.library_mutation("jobs.generateThumbsForLocation")(generate_thumbs_for_location)
    router.library_subscription("jobs.progress")(progress)
    router.library_subscription("jobs.newThumbnail")(new_thumbnail)
