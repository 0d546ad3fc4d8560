"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless the caller names another
device (the tests pass ``device="cpu"``).  Without a GPU and without an
explicit device, they raise: a silent move to the CPU would hide a
missing card behind a slow run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  A
    CUDA device gets its index (the current device if none is named),
    so it compares equal to a tensor's device.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
