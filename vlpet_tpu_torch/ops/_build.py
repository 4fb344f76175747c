"""Build and load the port's CUDA kernels.

Each ``vlpet_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` (all
started together), and the objects are linked into one shared library with
a plain C interface (no PyTorch headers: a build of seconds, not minutes),
loaded with ctypes. The build runs at the first launch of any kernel, never
at import, and is keyed on a hash of the sources, so an edited source
rebuilds and an unchanged one reuses ``vlpet_tpu_torch/_build/``.

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
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher: pointers, ints, floats, then the
# stream. Each returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # q, k, v, mask, bias (or NULL), seed (or NULL), out, lse (or NULL), B,
    # L, S, H, Dh, mask_batched, causal, is_bf16, tc (the tensor-core
    # route), drop, thr, scale, stream
    "vlpet_attention_fwd": [_P] * 8 + [_I] * 11 + [_F, _P],
    # q, k, v, mask, bias (or NULL), seed (or NULL), do, dq, dk, dv, dbias
    # partials (or NULL), dbias (or NULL), B, L, S, H, Dh, mask_batched,
    # causal, is_bf16, tc (the tensor-core route), drop, thr, scale, stream
    "vlpet_attention_bwd": [_P] * 12 + [_I] * 11 + [_F, _P],
    # q, k, v, mask, bias (or NULL), seed (or NULL), out, lse, do, dq, dk,
    # dv, delta, dbias (or NULL), B, L, S, H, Dh, mask_batched, causal,
    # is_bf16, tc (the tensor-core route), drop, thr, scale, stream
    "vlpet_attention_bwd_long": [_P] * 14 + [_I] * 11 + [_F, _P],
    # w1, w2, wt (F1's re-laid weights), D, F, stream
    "vlpet_ffn_w_tiles": [_P] * 3 + [_I] * 2 + [_P],
    # x, w1, b1, w2, b2, seed (or NULL), wt (bf16; NULL for fp32), partials
    # (or NULL), y, N, D, F, splits, act, is_bf16, drop, thr, scale, stream
    "vlpet_ffn_fwd": [_P] * 9 + [_I] * 8 + [_F, _P],
    # w0, w1, wo, F3's re-laid weights (gt) or F4's others (bt), D, F,
    # stream
    "vlpet_gated_w_tiles": [_P] * 4 + [_I] * 2 + [_P],
    "vlpet_gated_bwd_tiles": [_P] * 4 + [_I] * 2 + [_P],
    # x, w0, w1, wo, seed (or NULL), gt (bf16; NULL for fp32), partials (or
    # NULL), y, N, D, F, splits, act, is_bf16, drop, thr, scale, stream
    "vlpet_gated_ffn_fwd": [_P] * 8 + [_I] * 8 + [_F, _P],
    # x, dy, w0, w1, wo, seed (or NULL), dy re-laid (scratch), gt, bt (bf16;
    # NULL for fp32), partials (or NULL), dx, N, D, F, splits, act, is_bf16,
    # drop, thr, scale, stream
    "vlpet_gated_ffn_bwd": [_P] * 11 + [_I] * 8 + [_F, _P],
    # x, dy, w1, b1, w2, seed (or NULL), dy re-laid (scratch), wt (F1's
    # re-laid weights; both NULL for fp32), partials of dx (or NULL), dx,
    # bias partials, db1, db2, N, D, F, G, splits, act, is_bf16, drop, thr,
    # scale, stream
    "vlpet_ffn_bwd": [_P] * 13 + [_I] * 9 + [_F, _P],
    # h, res, gamma, beta, seed, y, N, D, drop, thr, scale, eps, is_bf16,
    # then the plan (ops/fused_ln.py ln_plan): stages, blocks; stream
    "vlpet_ln_fwd": [_P] * 6 + [_I] * 4 + [_F, _F] + [_I] * 3 + [_P],
    # h, res, gamma, seed, dy, dh, dres, partial (blocks, 2, D), dgamma and
    # dbeta (2, D), N, D, drop, thr, scale, eps, is_bf16, stages, blocks,
    # evict_first, stream
    "vlpet_ln_bwd": [_P] * 9 + [_I] * 4 + [_F, _F] + [_I] * 4 + [_P],
    # q, k, v, anc (int32 or int64), bias row (or NULL), out, B, K, J, Lc,
    # H, Dh, pos, anc64, bias row's head and slot strides, is_bf16, tc (the
    # route), heads a block, tile rows, shared memory bytes (ops/decode.py
    # beam_route, tc_heads, beam_plan), stream
    "vlpet_beam_attend": [_P] * 6 + [_I] * 15 + [_P],
    # q, k cache, v cache, k new, v new, anc, bias row (or NULL), own bias
    # (or NULL), out, B, K, Lc, H, Dh, pos, anc64, bias row's strides, own
    # bias's stride, is_bf16, tc, heads a block, tile rows, shared memory
    # bytes, stream
    "vlpet_beam_attend_update": [_P] * 9 + [_I] * 15 + [_P],
    # x, vals, idx, lse, R, V, k, then the plan (ops/topk.py topk_plan):
    # threads, float4s a thread a group, ring stages, shared bytes; stream
    "vlpet_topk_lse": [_P] * 4 + [_I] * 7 + [_P],
    # cache, new, second cache and new (or NULL, NULL), N, L, row elements,
    # element bytes, pos, stream
    "vlpet_cache_update": [_P] * 4 + [_I] * 5 + [_P],
    # w, b, tiled W (C1 and C2's re-laid head), V, D, stream
    "vlpet_ce_w_tiles": [_P] * 3 + [_I] * 2 + [_P],
    # x, w, b, labels, tiled W (bf16; NULL for fp32), partials, loss, lse,
    # N, D, V, splits, is_bf16, stream
    "vlpet_ce_fwd": [_P] * 8 + [_I] * 5 + [_P],
    # x, w, b, labels, lse, dloss, tiled W (bf16; NULL for fp32), partials,
    # dx, N, D, V, splits, is_bf16, stream
    "vlpet_ce_bwd": [_P] * 9 + [_I] * 5 + [_P],
}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version).
    Anything else raises: there is no third route."""
    if all(t.is_cuda for t in tensors):  # no device objects on this path
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
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
    library exists; returns its path. One nvcc per source, run together,
    then one link."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libvlpet_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        errors = []
        for src, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *[str(obj) for _, obj, _ in jobs]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels requested but torch.cuda is not "
                           "available on this host")


def multiprocessors(device: torch.device) -> int:
    """The SM count of the card ``device``, for sizing a launch."""
    _require_cuda()
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    _require_cuda()
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream of the current device
    (its raw handle, without building a torch.cuda.Stream: the launch is on
    every decode step's host path); raise on a nonzero
    cudaGetLastError()."""
    fn = getattr(lib(), name)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice()))
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
