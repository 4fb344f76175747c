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


def deterministic_kernels() -> None:
    """The library kernels' settings of a seeded run, set where the port
    seeds one (``train.trainer.Trainer``): fp32 matmuls and convolutions
    in full fp32, not rounded to TF32 (the JAX package's fp32 arithmetic),
    and cuDNN's deterministic convolution algorithms without the
    autotuner's per-shape choice, so that raw-path steps taken again from
    the same state compute the trunk's convolutions and their gradients
    bit for bit as before (chip_smoke.py phase 6i repeats them and holds
    them equal). The hand-written kernels are deterministic by
    themselves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
