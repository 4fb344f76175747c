"""Visual feature readers + a TPU-friendly packed format.

Reference layouts:
* clip grid features: one h5 per image, key "{img_id}/features", zero boxes
  (reference: src/vqa_clip_data.py:160-200)
* butd Faster-RCNN: monolithic h5 with features + boxes normalized to [0,1]
  by img_w/img_h (reference: src/vqa_data.py 'butd' family)
* video: one .npz per clip with CLIP-ViT frame features, time-resized to
  n_boxes by pad-or-adaptive-max-pool (reference: src/video/tvqa_data.py:34-47)

The per-image-h5 layout is seek-heavy (SURVEY.md §7 risk); ``pack_features``
converts any source into one memory-mapped .npy + a json index, giving
sequential reads and zero-copy slicing for the input pipeline.

The port's own copy of vlpet_tpu/data/features.py. The raw-image source
preprocesses through vision/extract.py; h5py and PIL are imported only
where an h5 file or an image is read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


class DictFeatureSource:
    """In-memory source (tests / synthetic runs)."""

    def __init__(self, feats: Dict[str, np.ndarray],
                 boxes: Optional[Dict[str, np.ndarray]] = None):
        self.feats = feats
        self.boxes = boxes or {}

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        f = np.asarray(self.feats[img_id], np.float32)
        b = self.boxes.get(img_id)
        if b is None:
            b = np.zeros((f.shape[0], 4), np.float32)
        return f, np.asarray(b, np.float32)

    def ids(self):
        return list(self.feats)


class PerImageH5Source:
    """{dir}/{img_id}.h5 with dataset '{img_id}/features'; boxes are zeros
    (clip grid features carry no geometry)."""

    def __init__(self, directory: str):
        self.directory = directory

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        import h5py

        path = os.path.join(self.directory, f"{img_id}.h5")
        with h5py.File(path, "r") as f:
            feats = f[f"{img_id}/features"][...]
        return (np.asarray(feats, np.float32),
                np.zeros((feats.shape[0], 4), np.float32))


class MonolithicH5Source:
    """One h5 holding every image: '{img_id}/features', '{img_id}/boxes',
    '{img_id}/img_w', '{img_id}/img_h'; boxes normalized to [0,1]."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def _file(self):
        import h5py

        if self._f is None:
            self._f = h5py.File(self.path, "r")
        return self._f

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        f = self._file()
        feats = np.asarray(f[f"{img_id}/features"][...], np.float32)
        boxes = np.asarray(f[f"{img_id}/boxes"][...], np.float32)
        img_w = float(f[f"{img_id}/img_w"][()])
        img_h = float(f[f"{img_id}/img_h"][()])
        boxes[:, (0, 2)] /= img_w
        boxes[:, (1, 3)] /= img_h
        return feats, np.clip(boxes, 0.0, 1.0)


def resize_time_axis(feats: np.ndarray, n_frames: int) -> np.ndarray:
    """Pad (tile-last) or adaptive-max-pool the time axis to n_frames
    (reference: video/tvqa_data.py:34-47)."""
    t = feats.shape[0]
    if t == n_frames:
        return feats
    if t < n_frames:
        pad = np.repeat(feats[-1:], n_frames - t, axis=0)
        return np.concatenate([feats, pad], axis=0)
    out = np.empty((n_frames,) + feats.shape[1:], feats.dtype)
    for i in range(n_frames):
        a = (i * t) // n_frames
        b = max(a + 1, -(-((i + 1) * t) // n_frames))
        out[i] = feats[a:b].max(axis=0)
    return out


class NpzVideoSource:
    """{dir}/{clip_id}.npz with array 'features' (T, D); time axis resized to
    n_frames; boxes zeros."""

    def __init__(self, directory: str, n_frames: int = 64,
                 key: str = "features"):
        self.directory = directory
        self.n_frames = n_frames
        self.key = key

    def get(self, clip_id: str) -> Tuple[np.ndarray, np.ndarray]:
        with np.load(os.path.join(self.directory, f"{clip_id}.npz")) as z:
            feats = np.asarray(z[self.key], np.float32)
        feats = resize_time_axis(feats, self.n_frames)
        return feats, np.zeros((feats.shape[0], 4), np.float32)


class PackedFeatureSource:
    """Memory-mapped packed features: {prefix}.npy (N, L, D) + boxes
    {prefix}_boxes.npy + {prefix}_index.json {img_id: row}."""

    def __init__(self, prefix: str):
        self.feats = np.load(prefix + ".npy", mmap_mode="r")
        boxes_path = prefix + "_boxes.npy"
        self.boxes = (np.load(boxes_path, mmap_mode="r")
                      if os.path.exists(boxes_path) else None)
        with open(prefix + "_index.json") as f:
            self.index = json.load(f)

    def get(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        row = self.index[str(img_id)]
        f = np.asarray(self.feats[row], np.float32)
        b = (np.asarray(self.boxes[row], np.float32) if self.boxes is not None
             else np.zeros((f.shape[0], 4), np.float32))
        return f, b

    def ids(self):
        return list(self.index)


def pack_features(source, img_ids: Iterable[str], prefix: str) -> None:
    """Pack any source into the memory-mapped layout (sequential IO for the
    TPU input pipeline)."""
    img_ids = list(img_ids)
    f0, b0 = source.get(img_ids[0])
    feats = np.empty((len(img_ids),) + f0.shape, np.float32)
    boxes = np.empty((len(img_ids),) + b0.shape, np.float32)
    index = {}
    for i, img_id in enumerate(img_ids):
        f, b = source.get(img_id)
        feats[i], boxes[i] = f, b
        index[str(img_id)] = i
    np.save(prefix + ".npy", feats)
    np.save(prefix + "_boxes.npy", boxes)
    with open(prefix + "_index.json", "w") as f:
        json.dump(index, f)


class ImageFolderSource:
    """Raw-image source for the raw_* feature_type: {dir}/{img_id}.{jpg,png}
    loaded with PIL and CLIP-preprocessed to (H, W, 3) float32. Used with
    vision.vis_encoder.RawInputVLModel (the batch carries images, not
    features): ``is_raw`` makes TaskDataset emit example['images'] and the
    raw Trainer path run the CLIP trunk inside the train step."""

    is_raw = True

    def __init__(self, directory: str, image_size: int = 224):
        self.directory = directory
        self.image_size = image_size
        self._ext = {}
        for f in os.listdir(directory):
            stem, ext = os.path.splitext(f)
            if ext.lower() in (".jpg", ".jpeg", ".png", ".bmp"):
                self._ext[stem] = ext

    def get_image(self, img_id: str) -> np.ndarray:
        from PIL import Image

        from vlpet_tpu_torch.vision.extract import preprocess_image

        path = os.path.join(self.directory, f"{img_id}{self._ext[str(img_id)]}")
        img = np.asarray(Image.open(path).convert("RGB"))
        return preprocess_image(img, self.image_size)

    def get(self, img_id: str):
        """Feature-source interface: returns the preprocessed image as the
        'features' slot; collation must route it to batch['images']."""
        img = self.get_image(img_id)
        return img, np.zeros((1, 4), np.float32)

    def ids(self):
        return list(self._ext)
