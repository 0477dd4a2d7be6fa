"""Device choice for the port's entry points.

The port runs on the GPU. The CPU is used only when the caller asks for it
(the tests do); with no GPU and no explicit request the entry points raise
instead of carrying on slowly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` by default; ``"cpu"`` only on request.

    Raises ``RuntimeError`` when CUDA is needed (``device`` is None or a
    CUDA device) and ``torch.cuda.is_available()`` is False.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
