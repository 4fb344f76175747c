"""PyTorch port of vlpet_tpu for NVIDIA Hopper (H100).

The JAX package ``vlpet_tpu`` is the reference; this package mirrors its
module paths and class names (``vlpet_tpu_torch/models/bart.py`` <->
``vlpet_tpu/models/bart.py``) and its parameter names, so
``vlpet_tpu_torch.convert`` maps a flax parameter tree onto a port
``state_dict`` by renames and transposes only.

Slices ported so far, both for BART-base + VL-PET-large: the caption-eval
decode path (greedy and beam search) and the training step (forward,
backward, clip, HF AdamW; ``train/``). Every Pallas kernel on those paths
is a hand-written CUDA kernel for sm_90a (``csrc/``), built with nvcc at
first use and bound through ctypes (``ops/_build.py``); each keeps its
plain PyTorch twin in the same module, which CPU tensors take.

Nothing here imports jax, flax or any module of the JAX package: the
configuration dataclasses are the port's own copy (``config.py``).
Constructors and entry points allocate on the card unless the caller asks
for another device (``device.py``).
"""
