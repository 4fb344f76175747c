"""PyTorch port of vlpet_tpu for NVIDIA Hopper (H100).

The JAX package ``vlpet_tpu`` is the reference; this package mirrors its
module paths and class names (``vlpet_tpu_torch/models/bart.py`` <->
``vlpet_tpu/models/bart.py``) and its parameter names, so
``vlpet_tpu_torch.convert`` maps a flax parameter tree onto a port
``state_dict`` by renames and transposes only.

Slice ported so far: the caption-eval decode path (BART-base + VL-PET-large,
greedy and beam search), eval mode only. Every Pallas kernel on that path is
a hand-written CUDA kernel for sm_90a (``csrc/``), built with nvcc at first
use and bound through ctypes (``ops/_build.py``); each keeps its plain
PyTorch twin in the same module, which CPU tensors take.

Nothing here imports jax or flax. The framework-free ``vlpet_tpu.config``
is the one module shared with the JAX package; the port reaches it only
through ``vlpet_tpu_torch.config``.
"""
