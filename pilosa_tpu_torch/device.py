"""Device selection (counterpart of ``pilosa_tpu/platform.py``).

The port runs on the card unless the caller asks for the CPU. There is no
fallback: asking for ``cuda`` where no CUDA device exists raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` for ``device`` (default ``cuda``). Raises
    ``RuntimeError`` for a CUDA device when CUDA is unavailable, and
    ``ValueError`` for a device type the port does not run on."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev
