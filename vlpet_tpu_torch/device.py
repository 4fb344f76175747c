"""Where the port allocates: on the card unless the caller asks otherwise.

Every constructor and entry point of the port that allocates takes
``device="cuda"`` by default and passes it through ``resolve_device``. A
host without CUDA then raises instead of quietly building on the CPU; the
CPU (the tests' lane) and ``"meta"`` (shape-only builds) are taken only
when the caller names them.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device on a host
    where torch.cuda is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda is not available "
            f"on this host; pass device='cpu' to run on the CPU")
    return dev
