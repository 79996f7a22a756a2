"""The contract a batched job hands the streaming executor.

Counterpart of ``spacedrive_tpu/pipeline/spec.py`` (:15-89). Stage
callables follow the ``pipeline_page`` / ``pipeline_process`` /
``pipeline_commit`` naming of the JAX package: prefetch and dispatch stages
never write the database, and every write goes through the committer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class PipelineSpec:
    """Three stage callables and optional sharded-prefetch callables. The
    queue depth and the commit group are the executor's
    (``SD_PIPELINE_DEPTH``, ``SD_COMMIT_GROUP``), not the spec's.

    ``page(ctx, data, scratch) -> payload | None``
        Prefetch thread. Pages the next batch of rows (database *reads*
        only) and gathers its cas messages (file I/O). ``scratch`` is a
        pipeline-local dict, never checkpointed, seeded with
        ``step_index`` / ``steps`` / ``shards``; page keeps its speculative
        cursor there, never in ``data``. Returns ``None`` when the job is
        out of work.

    ``process(ctx, data, payload) -> payload``
        Dispatch thread. Device compute over the gathered batch; may mutate
        and return the payload. Its exceptions fail the job unless they are
        transient (``retry.is_transient``): there is no CPU re-dispatch.

    ``commit(ctx, data, payload) -> StepResult``
        Job thread, strict batch order, the only stage that may write the
        database and the only place the checkpoint cursor in ``data``
        advances. RETRY CONTRACT: the committer re-invokes ``commit`` on
        transient failures (``executor.COMMIT_RETRY``), so an exception
        escaping ``commit`` must mean nothing durable happened for this
        batch. GROUP-COMMIT CONTRACT: the committer may run several
        ``commit`` calls inside ONE outer transaction and roll them back
        together, so durable writes go through ``db.transaction()`` (which
        joins the outer scope), reads that must see earlier pages of the
        group go through ``db.query`` on this thread (the writer), and
        checkpoint mutations of ``data`` are top-level key assignments: the
        committer restores a shallow snapshot of ``data`` when a group
        attempt fails.

    Sharded prefetch (``SD_SCAN_SHARDS`` > 1 and all three set; otherwise
    the executor runs ``page``):

    ``split(ctx, data, scratch) -> header | None``
        Split thread. Pages the next cursor window (an id-only read),
        advances the speculative cursor in ``scratch`` and returns a header
        whose ``"parts"`` is a list of disjoint, contiguous, ordered work
        slices, one a gather shard. ``None`` when out of work. Read-only.

    ``shard(ctx, data, part) -> part_result``
        Gather threads, several at once. One slice's row read and gather;
        pure per slice (no writes, no shared mutable state): slices of one
        page run in any order and interleave with later pages' slices.

    ``merge(ctx, data, header, results) -> payload``
        Merge thread. Reassembles the slice results, in slice order, into
        exactly the payload ``page`` would have returned for the same
        cursor window.
    """

    page: Callable[..., Any]
    process: Callable[..., Any]
    commit: Callable[..., Any]
    #: sharded-prefetch callables (all three or none)
    split: Callable[..., Any] | None = None
    shard: Callable[..., Any] | None = None
    merge: Callable[..., Any] | None = None
    #: True when the job sizes its own pages from the executor's measured
    #: ``stage_shares`` (in scratch): the page count may then differ from
    #: init's step estimate, so that budget is advisory and the run ends
    #: when ``page`` returns None
    adaptive: bool = False
