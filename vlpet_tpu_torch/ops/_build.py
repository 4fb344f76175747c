"""Build and load the port's CUDA kernels.

All of ``vlpet_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` into one shared
library with a plain C interface (no PyTorch headers: a build of seconds,
not minutes) and loaded with ctypes. The build runs at the first launch of
any kernel, never at import, and is keyed on a hash of the sources, so an
edited source rebuilds and an unchanged one reuses
``vlpet_tpu_torch/_build/``.

CPU tensors never reach this module: each op wrapper sends them to its plain
PyTorch version. A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported launcher: pointers, ints, then the stream.
# Each returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # q, k, v, mask, out, B, L, S, H, Dh, mask_batched, is_bf16, stream
    "vlpet_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w1, b1, w2, b2, y, N, D, F, act, is_bf16, stream
    "vlpet_ffn_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, anc, out, B, K, J, Lc, H, Dh, pos, is_bf16, stream
    "vlpet_beam_attend": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # x, vals, idx, lse, R, V, k, stream
    "vlpet_topk_lse": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version).
    Anything else raises: there is no third route."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all be on CPU or all on CUDA, "
                     f"got devices {sorted(kinds)}")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built on this host")


def build() -> Path:
    """Compile csrc/*.cu into _build/libvlpet_<hash>.so unless that exact
    library exists; returns its path."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libvlpet_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels requested but torch.cuda is not "
                           "available on this host")
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream; raise on a nonzero
    cudaGetLastError()."""
    fn = getattr(lib(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Kernel input guard: dtype, rank, contiguity."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
