"""The card's INT32 roofline for the BLAKE3 kernels: ``sd_hash_mfu``.

The model is PERF.md's bound model for the BLAKE3 rows of its kernel
table: one compression of a 64-byte block is 680 INT32 operations as the
card issues them (7 rounds × 8 G functions, each four adds with
``a + b + m`` one three-input IADD3, four xors and four rotates, then the
8 feed-forward xors of a chaining value: 7 × 8 × 12 + 8), and the card
issues 64 INT32 operations a clock on each SM. The peak is therefore

    SMs × 64 × the SM clock

(on an H100 SXM: 132 × 64 × 1.98 GHz = 16.73e12 operations a second).
The SM count comes from ``torch.cuda.get_device_properties``; the clock
is the card's maximum SM clock as ``nvidia-smi`` reports it, read once a
device and logged with the card's name. Like the JAX package's model the
figure counts payload bytes only (parent compressions and padding are not
counted), so it never flatters the kernel. There is no environment
override, and on a CPU device there is no roofline: the gauge is declared
but never set.
"""

from __future__ import annotations

import logging
import subprocess
import threading

import torch

logger = logging.getLogger(__name__)

#: INT32 operations of one BLAKE3 compression (one 64-byte block)
OPS_PER_BLOCK = 680
#: bytes a compression consumes
BLOCK_BYTES = 64
#: INT32 operations an SM issues a clock (Hopper: four 16-lane INT32 units)
INT32_LANES_PER_SM = 64

_LOCK = threading.Lock()
#: device index -> its roofline (or None when it could not be read)
_CARDS: dict[int, dict | None] = {}


def _max_sm_clock_mhz(index: int) -> float:
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=30).stdout
    return float(out.strip().splitlines()[0])


def card_roofline(device: torch.device) -> dict | None:
    """``{name, sms, sm_clock_mhz, int32_ops_per_s, bytes_per_s}`` of a
    CUDA device (read once, then cached), None for a CPU device or when the
    card's clock cannot be read (logged once)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _LOCK:
        if index in _CARDS:
            return _CARDS[index]
        props = torch.cuda.get_device_properties(index)
        try:
            clock_mhz = _max_sm_clock_mhz(index)
        except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
            logger.warning("card %d (%s): max SM clock unreadable (%s); sd_hash_mfu stays "
                           "unset", index, props.name, e)
            _CARDS[index] = None
            return None
        ops = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
        card = {"name": props.name, "sms": props.multi_processor_count,
                "sm_clock_mhz": clock_mhz, "int32_ops_per_s": ops,
                "bytes_per_s": ops / OPS_PER_BLOCK * BLOCK_BYTES}
        logger.info("card %d: %s, %d SMs at %.0f MHz: BLAKE3 roofline %.3fe12 INT32 ops/s "
                    "(%.1f GB/s of payload)", index, props.name, card["sms"], clock_mhz,
                    ops / 1e12, card["bytes_per_s"] / 1e9)
        _CARDS[index] = card
        return card


def mfu(bytes_per_sec: float, device: torch.device) -> float | None:
    """The share of ``device``'s BLAKE3 roofline a measured payload rate
    reaches; None where the device has no roofline."""
    card = card_roofline(device)
    if card is None:
        return None
    if bytes_per_sec <= 0:
        return 0.0
    return bytes_per_sec / card["bytes_per_s"]
