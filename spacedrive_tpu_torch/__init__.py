"""PyTorch/CUDA port of spacedrive_tpu's location scan and search serving.

The package runs the location scan (indexer → file identifier: cas_ids,
objects and chunk manifests → media processor: image thumbnails and
metadata → MinHash near-duplicates) and serves ``search.paths`` /
``search.pathsCount`` from a device-resident index, with its device work in
hand-written CUDA kernels for Hopper (``csrc/``), built with nvcc at first
use, and in PyTorch ops where the reference used plain XLA programs (the
MinHash signatures, the thumbnail resize). It imports torch and never
jax, and nothing of the ``spacedrive_tpu`` package: what it shares with it
(the BLAKE3 oracle, the gear table, the schema) is kept here as its own copy.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``,
which selects each kernel's plain PyTorch version (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the port
    never moves quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev
