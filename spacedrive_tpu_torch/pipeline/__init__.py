"""Streaming scan pipeline: overlap database paging, file I/O, device
dispatch and commit across a batched job's steps.

Counterpart of ``spacedrive_tpu/pipeline/``. A batched job opts in by
returning a :class:`PipelineSpec` from ``StatefulJob.pipeline_spec()``; the
:class:`PipelineExecutor` runs its stages on threads joined by bounded
queues (``SD_PIPELINE_DEPTH``, default 2):

- prefetch: ``pipeline_page`` pages the next step's rows and gathers their
  cas messages while the current batch is on the card; with
  ``SD_SCAN_SHARDS`` > 1 each page fans out across gather threads and an
  ordered merger re-serializes them;
- dispatch: ``pipeline_process`` launches the scan kernels;
- commit: ``pipeline_commit`` on the job's thread, in strict batch order,
  ``SD_COMMIT_GROUP`` pages a transaction; the only stage that writes.

``SD_PIPELINE=0`` runs the same three stages back to back in the job's
sequential step loop. Commits are ordered and the cursor in ``data``
advances only with committed work, so both schedules write the same rows.
"""

from .executor import (PipelineExecutor, pipeline_depth, pipeline_enabled,
                       scan_shards)
from .spec import PipelineSpec

__all__ = ["PipelineExecutor", "PipelineSpec", "pipeline_depth",
           "pipeline_enabled", "scan_shards"]
