"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without CUDA raises
instead of falling back quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is requested
    (explicitly or by default) and ``torch.cuda.is_available()`` is
    false. Pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

