"""The constant tables the kernels carry, as tensors.

The system has no learned weights; what carries across from the JAX package
is its constant tables: the gear table of the chunker, the BLAKE3 IV and
message permutation, and the per-round message schedule baked into the
Pallas compression kernel (``blake3_pallas.py:54-65``). The port derives its
own; :func:`tables_from_reference` turns the JAX package's numpy arrays into
the same form, so a test can hold the two equal.
"""

from __future__ import annotations

import torch

from ..objects.blake3_ref import IV, MSG_PERMUTATION
from .blake3 import MSG_SCHEDULE, message_schedule
from .cdc import GEAR


def _as_tensor(values) -> torch.Tensor:
    return torch.tensor([int(v) for v in values], dtype=torch.int64)


def port_tables() -> dict[str, torch.Tensor]:
    """The tables the port's kernels and plain versions use."""
    return {"gear": GEAR.clone(), "iv": _as_tensor(IV),
            "perm": _as_tensor(MSG_PERMUTATION),
            "schedule": torch.tensor(MSG_SCHEDULE, dtype=torch.int64)}


def tables_from_reference(gear, iv, perm) -> dict[str, torch.Tensor]:
    """The JAX package's ``GEAR`` (256,) u32, ``IV`` (8,) and
    ``MSG_PERMUTATION`` (16,) as the port's int64 tensors; the round schedule
    is derived from the permutation as the Pallas kernel derives it."""
    return {"gear": _as_tensor(gear), "iv": _as_tensor(iv), "perm": _as_tensor(perm),
            "schedule": torch.tensor(message_schedule(perm), dtype=torch.int64)}
