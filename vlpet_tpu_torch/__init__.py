"""PyTorch port of vlpet_tpu for NVIDIA Hopper (H100).

The JAX package ``vlpet_tpu`` is the reference; this package mirrors its
module paths and class names (``vlpet_tpu_torch/models/bart.py`` <->
``vlpet_tpu/models/bart.py``) and its parameter names, so
``vlpet_tpu_torch.convert`` maps a flax parameter tree onto a port
``state_dict`` by renames and transposes only.

Ported: BART-base and T5-base with every VL-PET gate (small, middleX,
middleY, large), the decode path (greedy and beam search), the training
step (forward, backward, clip, HF AdamW), the image-text trainer,
checkpoints, data pipeline and evaluators (``train/``, ``data/``,
``evalsuite/``), the image-text and video CLIs (``python -m
vlpet_tpu_torch.cli.multitask``, ``cli.multitask_infer``,
``cli.multitask_video``, ``cli.single_task``), the CLIP trunks, the
raw-image path and the feature extractor (``vision/``), the HF / CLIP
checkpoint importers (``models/hf_import.py``, ``vision/clip_import.py``)
and data parallelism, one process per card over torch.distributed
(``parallel/``, ``--distributed``).
Every Pallas
kernel is a hand-written CUDA kernel for sm_90a (``csrc/``), built with
nvcc at first use and bound through ctypes (``ops/_build.py``); each keeps
its plain PyTorch twin in the same module, which CPU tensors take.

Nothing here imports jax, flax or any module of the JAX package: the
configuration dataclasses, the data pipeline, the evaluators and the CLI's
argument parser are the port's own copies.
Constructors and entry points allocate on the card unless the caller asks
for another device (``device.py``).
"""
