"""Data pipeline of the port: feature readers, per-task datasets,
fixed-shape collation, multitask mixing, tokenization and the video-text
loaders (TVQA / How2QA / TVC / YC2C) -- copies of vlpet_tpu/data/."""

from vlpet_tpu_torch.data.tokenization import get_tokenizer, WhitespaceTokenizer
from vlpet_tpu_torch.data.features import (
    DictFeatureSource,
    MonolithicH5Source,
    NpzVideoSource,
    PackedFeatureSource,
    PerImageH5Source,
    pack_features,
)
from vlpet_tpu_torch.data.datasets import (
    Loader,
    TaskDataset,
    build_image_text_dataset,
    synthetic_task_data,
)
from vlpet_tpu_torch.data.multitask import MultitaskLoader
