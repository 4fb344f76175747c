"""CLIP visual encoders of the port (vlpet_tpu/vision/): the trunks of the
raw-image ("raw_*" feature_type) path, the feature extractor and the
OpenAI CLIP importer."""

from vlpet_tpu_torch.vision.clip import (
    AttentionPool2d,
    CLIPVisualEncoder,
    ModifiedResNet,
    VisualAdapter,
    VisualTransformer,
    get_vis_encoder,
)
