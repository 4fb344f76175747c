"""Ops of the port: plain PyTorch functions and the wrappers of the
hand-written CUDA kernels (each kernel's plain twin lives in its module).

The model's kernel call sites pick between a kernel wrapper and its plain
twin through ``route``; inside ``with plain_twins():`` they take the twins,
so a run on the card can be held against the plain path on the same
inputs. The wrappers themselves never fall back: a CUDA tensor given to a
wrapper launches its kernel or raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

_kernels_on = True


@contextlib.contextmanager
def plain_twins() -> Iterator[None]:
    """Run the model's kernel call sites through the plain twins."""
    global _kernels_on
    prev, _kernels_on = _kernels_on, False
    try:
        yield
    finally:
        _kernels_on = prev


def route(kernel: Callable, plain: Callable) -> Callable:
    """``kernel`` (the wrapper: plain twin on CPU tensors, the CUDA kernel on
    CUDA tensors), or ``plain`` inside ``plain_twins()``."""
    return kernel if _kernels_on else plain
