"""
Device policy of the port: full-float32 arithmetic and explicit devices.

The JAX package pins ``Precision.HIGHEST`` on the matmuls of the mask
builder and the metrics (ops/filters.py gaussian_blur2d, core/metrics.py
crowding_metrics_batch): a lower-precision blur flipped watershed topology
of close stars (PARITY.md).  On the card the counterpart is to keep TF32 out
of every float32 matmul and convolution, set here once at import.

Devices are always explicit.  ``resolve_device("cuda")`` raises when no
card is present: nothing on the photometry path carries on on the CPU when
a CUDA device was asked for.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """A ``torch.device`` for ``device``; raises if CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
    return dev
