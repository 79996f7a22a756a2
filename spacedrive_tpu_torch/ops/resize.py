"""Batched bilinear resize of decoded images: the thumbnailer's device work.

Counterpart of ``spacedrive_tpu/ops/resize_jax.py`` (``CANVAS`` :40,
``_interp_matrix`` :42, ``resize_batch`` :63, ``target_dims`` :85,
``resize_batch_host`` :106; its ``_bucket`` :139 has no use here, see
Padding below). The reference is a jitted XLA program, not a Pallas
kernel, and it ports as PyTorch (no hand-written kernel replaces anything
here). On a CPU tensor the same function is the plain version the tests
use; on a CUDA tensor it runs on the card or raises. Nothing routes a card
failure to the CPU.

Each image is resized separably, first along its rows, then along its
columns, with per-image sampling built from the source and target sizes,
which are data, not shapes. The reference multiplies by dense bilinear
matrices (out = A_y . img . A_x^T), whose rows hold two nonzero taps; here
each pass gathers those two taps and sums them in the order a matrix
product accumulates them (ascending source index, fused multiply-add): the
first tap's product rounded to fp32, the second's added to it with one
rounding, the zero weights of every other source index adding nothing.
The CPU tests hold the pixels to the reference's on that order. Output
coordinates at or past the image's own target size get zero weights, which
masks the canvas outside the thumbnail. The sums are fp32 (bf16 would band
8-bit channels), then rounded half to even, as ``jnp.round`` does, and
clipped to u8.

TF32: no matrix product runs, so the caller's
``torch.set_float32_matmul_precision`` or ``allow_tf32`` cannot reach the
pixels, and nothing here reads or sets them.

What bounds it on the card: the work reads each u8 input once and writes
each u8 output once (for a (32, 1024, 1024, 3) batch 100.66 MB + 25.17 MB,
~0.038 ms at 3.35 TB/s). The two passes here are a few gather and
elementwise programs each, with fp32 and fp64 temporaries in device
memory; a kernel that does both passes in one would approach the bound
(ROADMAP, After the port). The reference's dense form would compute
2*B*512*H_in*W_in*3 + 2*B*512*512*W_in*3 fp32 operations (154.6 GFLOP at
that shape).

Padding: the reference rounds the batch up to a power of two and each edge
up to a multiple of 256 only so that XLA compiles few programs; padded
lanes and columns get zero weight, so the pixels do not depend on it.
PyTorch compiles nothing, and ``resize_batch_host`` here pads only to the
batch's largest image and adds no lanes.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from . import _kernels

#: output canvas edge: ceil(sqrt(262144)), the thumbnail's target area
CANVAS = 512

#: the longest input edge ``resize_batch_host`` takes: at most twice the
#: canvas, so the two-tap bilinear skips no source pixel; the thumbnailer
#: box-reduces anything larger on the host first
MAX_INPUT_EDGE = 1024

#: calls of ``resize_batch`` by (device type, (B, H_in, W_in)), counted
#: under ``_kernels.count``'s lock (a media-lane job and another library's
#: media job may resize at once), so a run can show where the resize ran
#: and at which shapes
CALLS: Counter = Counter()


def reset_counts() -> None:
    CALLS.clear()


def _taps(actual: torch.Tensor, target: torch.Tensor):
    """The two source taps and their weights for each of the CANVAS output
    coordinates of one axis, each (B, CANVAS): taps floor(s), floor(s)+1
    with weights (1-w, w), where s = (i+0.5)*actual/target - 0.5, in the
    reference's fp32 operation order; both weights are zero at i >= target
    (the mask). At the clamped edge the two taps are one index and w is 0,
    as the reference's overlapping one-hots sum to (1, 0)."""
    dev = actual.device
    actual_f = actual.to(torch.float32)[:, None]
    target_f = target.to(torch.float32)[:, None]
    idx = torch.arange(CANVAS, dtype=torch.float32, device=dev)[None, :]
    src = torch.minimum(torch.maximum((idx + 0.5) * (actual_f / target_f) - 0.5,
                                      torch.zeros((), device=dev)),
                        actual_f - 1.0)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.minimum(i0 + 1, actual.to(torch.int64)[:, None] - 1)
    w = src - i0.to(torch.float32)
    keep = idx < target_f
    zero = torch.zeros((), device=dev)
    return i0, i1, torch.where(keep, 1.0 - w, zero), torch.where(keep, w, zero)


def _two_tap(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """Resample ``x`` (B, ., ., 3, u8 or fp32) along ``dim`` (1 or 2) to
    CANVAS with ``taps`` from :func:`_taps`, in fp32. The first tap's
    product is rounded to fp32; the second's is exact in fp64, so adding it
    there and rounding to fp32 once more is how a matrix product's fused
    multiply-add accumulates it."""
    i0, i1, w0, w1 = taps
    view = [x.shape[0], 1, 1, 1]
    view[dim] = CANVAS
    shape = list(x.shape)
    shape[dim] = CANVAS

    def tap(i: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, dim, i.view(view).expand(shape))

    first = tap(i0).to(torch.float32) * w0.view(view)
    return torch.addcmul(first.double(), tap(i1).double(), w1.view(view).double()).float()


def resize_batch(images: torch.Tensor, src_hw: torch.Tensor,
                 tgt_hw: torch.Tensor) -> torch.Tensor:
    """(B, H_in, W_in, 3) uint8 -> (B, CANVAS, CANVAS, 3) uint8 on the
    images' device.

    ``src_hw`` / ``tgt_hw``: (B, 2) int32 actual and target (h, w) of each
    image, on the same device; the region outside each image's (tgt_h,
    tgt_w) is zero. The u8 images are widened on their device, so a batch
    crosses to the card at one byte a channel."""
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"resize_batch wants (B, H, W, 3) uint8, got "
                         f"{tuple(images.shape)} {images.dtype}")
    B, h_in, w_in, _ = images.shape
    if tuple(src_hw.shape) != (B, 2) or tuple(tgt_hw.shape) != (B, 2):
        raise ValueError("src_hw and tgt_hw must be (B, 2)")
    if src_hw.device != images.device or tgt_hw.device != images.device:
        raise ValueError("images, src_hw and tgt_hw must be on one device")
    _kernels.count(CALLS, (images.device.type, (B, h_in, w_in)))
    rows = _two_tap(images, 1, _taps(src_hw[:, 0], tgt_hw[:, 0]))   # vertical pass
    out = _two_tap(rows, 2, _taps(src_hw[:, 1], tgt_hw[:, 1]))      # horizontal pass
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def target_dims(w: int, h: int) -> tuple[int, int]:
    """sqrt(CANVAS**2 / wh) scale preserving aspect; returns (th, tw). An
    extreme-aspect image whose longer edge would exceed the canvas is
    scaled down further so that it fits, as in the reference."""
    area = float(CANVAS * CANVAS)
    if w * h <= area:
        factor = 1.0
    else:
        factor = math.sqrt(area / (w * h))
    longest = max(w, h) * factor
    if longest > CANVAS:
        factor *= CANVAS / longest
    th = max(1, min(CANVAS, round(h * factor)))
    tw = max(1, min(CANVAS, round(w * factor)))
    return th, tw


def resize_batch_host(arrays: list[np.ndarray], device: torch.device) -> list[np.ndarray]:
    """Decoded RGB uint8 arrays of any sizes -> their thumbnails, each
    cropped to its own target dims, resized on ``device`` (the node's,
    passed explicitly).

    Arrays with an edge over ``MAX_INPUT_EDGE`` must be reduced by the
    caller first. The batch pads to its largest image; on the card it is staged
    in pinned memory and copied as u8."""
    if not arrays:
        return []
    bad = [i for i, a in enumerate(arrays) if max(a.shape[0], a.shape[1]) > MAX_INPUT_EDGE]
    if bad:
        raise ValueError(f"inputs {bad} exceed MAX_INPUT_EDGE={MAX_INPUT_EDGE}")
    device = torch.device(device)
    n = len(arrays)
    h_in = max(a.shape[0] for a in arrays)
    w_in = max(a.shape[1] for a in arrays)
    pin = device.type == "cuda"
    batch = torch.zeros((n, h_in, w_in, 3), dtype=torch.uint8, pin_memory=pin)
    hw = torch.empty((2, n, 2), dtype=torch.int32, pin_memory=pin)
    staged, dims = batch.numpy(), hw.numpy()
    for i, a in enumerate(arrays):
        staged[i, : a.shape[0], : a.shape[1]] = a
        dims[0, i] = (a.shape[0], a.shape[1])
        dims[1, i] = target_dims(a.shape[1], a.shape[0])
    images = batch.to(device, non_blocking=True)
    src_tgt = hw.to(device, non_blocking=True)
    out = resize_batch(images, src_tgt[0], src_tgt[1]).cpu().numpy()
    return [out[i, : dims[1, i, 0], : dims[1, i, 1]] for i in range(n)]
