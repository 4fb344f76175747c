"""Feature pre-extraction tool: raw images -> packed grid features, ported
from vlpet_tpu/vision/extract.py.

The reference ships precomputed CLIP grid features as one h5 per image
(seek-heavy). This tool runs the port's CLIP trunk (fp32) in batches and
writes the memory-mapped packed layout that
``data.features.PackedFeatureSource`` reads: ``{prefix}.npy`` (N, L, C)
fp32 grid features, ``{prefix}_boxes.npy`` (N, L, 4) zeros and
``{prefix}_index.json`` {image id: row}.

Usage:
    python -m vlpet_tpu_torch.vision.extract --images <dir> --out <prefix> \\
        --backbone RN101 --image_size 224 [--clip_ckpt local_clip.pt] \\
        [--device cuda]

``write_features`` is the batched encode-and-write loop on preprocessed
(H, W, 3) arrays; ``extract_features`` feeds it images through
``preprocess_image`` (PIL, imported where it is used).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.vision.clip import CLIPVisualEncoder

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(img: np.ndarray, image_size: int) -> np.ndarray:
    """Resize-shorter-side + center-crop + CLIP normalization; img HWC
    uint8 -> (image_size, image_size, 3) float32."""
    from PIL import Image

    im = Image.fromarray(img).convert("RGB")
    w, h = im.size
    scale = image_size / min(w, h)
    im = im.resize((max(image_size, int(round(w * scale))),
                    max(image_size, int(round(h * scale)))), Image.BICUBIC)
    w, h = im.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    im = im.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(im, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


@torch.no_grad()
def write_features(encoder: CLIPVisualEncoder,
                   load: Callable[[str], np.ndarray], img_ids: List[str],
                   out_prefix: str, batch_size: int = 32) -> np.ndarray:
    """Encode ``load(img_id)`` (a preprocessed (H, W, 3) float32 image) for
    every id in batches of ``batch_size`` on the encoder's device and
    write the packed layout; returns the (N, L, C) features."""
    device = next(encoder.parameters()).device
    feats = None
    index: Dict[str, int] = {}
    for start in range(0, len(img_ids), batch_size):
        ids = img_ids[start:start + batch_size]
        imgs = torch.from_numpy(np.stack([load(i) for i in ids]))
        imgs = imgs.to(device).permute(0, 3, 1, 2).contiguous()  # NCHW
        grid = encoder(imgs)[0].float().cpu().numpy()
        if feats is None:
            feats = np.empty((len(img_ids),) + grid.shape[1:], np.float32)
        feats[start:start + len(ids)] = grid
        for j, img_id in enumerate(ids):
            index[str(img_id)] = start + j
    np.save(out_prefix + ".npy", feats)
    np.save(out_prefix + "_boxes.npy",
            np.zeros(feats.shape[:2] + (4,), np.float32))
    with open(out_prefix + "_index.json", "w") as f:
        json.dump(index, f)
    return feats


def extract_features(image_loader: Callable[[str], np.ndarray],
                     img_ids: List[str], out_prefix: str,
                     backbone: str = "RN101", image_size: int = 224,
                     batch_size: int = 32,
                     encoder: Optional[CLIPVisualEncoder] = None,
                     device: Device = "cuda") -> None:
    """Run the trunk over ``img_ids`` (``image_loader`` gives HWC uint8
    images, preprocessed here) and write {prefix}.npy + the boxes and the
    index json. Without ``encoder`` a seeded fp32 trunk is built on
    ``device``."""
    if encoder is None:
        encoder = CLIPVisualEncoder(backbone=backbone, image_size=image_size,
                                    device=device)
        encoder.init_weights(torch.Generator(
            device=resolve_device(device)).manual_seed(0))
    write_features(encoder,
                   lambda i: preprocess_image(image_loader(i), image_size),
                   img_ids, out_prefix, batch_size)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backbone", default="RN101")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    files = sorted(os.listdir(args.images))
    ids = [os.path.splitext(f)[0] for f in files]

    def load(img_id):
        from PIL import Image

        for f in files:
            if os.path.splitext(f)[0] == img_id:
                return np.asarray(Image.open(os.path.join(args.images, f)))
        raise KeyError(img_id)

    device = resolve_device(args.device)
    enc = CLIPVisualEncoder(backbone=args.backbone,
                            image_size=args.image_size, device=device)
    enc.init_weights(torch.Generator(device=device).manual_seed(0))
    if args.clip_ckpt:
        from vlpet_tpu_torch.vision.clip_import import load_clip_state_dict

        sd = torch.load(args.clip_ckpt, map_location="cpu",
                        weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        report = load_clip_state_dict(enc, sd)
        print(f"loaded {len(report['filled'])} CLIP tensors")
    extract_features(load, ids, args.out, args.backbone, args.image_size,
                     args.batch_size, encoder=enc)
    print(f"wrote {args.out}.npy for {len(ids)} images")


if __name__ == "__main__":
    main()
