"""Configuration of the port: its own copy of the dataclasses of
``vlpet_tpu.config`` that the port reads (``AdapterSpec``, ``LoraSpec``,
``PromptSpec``, ``HyperformerSpec``, ``PetConfig``, ``VisConfig``,
``BartConfig``, ``T5Config``, ``VLModelConfig``),
``vlpet_recipe``, and the full-width configurations the port runs:
``flagship_cfg``, ``video_cfg`` and ``t5_cfg``.

The fields, their names and their defaults are those of the JAX package
(tests/test_torch_ops.py holds the two copies equal), so a configuration
moves between the packages by ``dataclasses.asdict``. Every ``PetConfig``
flag is kept, including the ones the port does not implement, so that
``models/vlbart.py:check_supported`` can see and reject each of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["AdapterSpec", "LoraSpec", "PromptSpec", "HyperformerSpec",
           "BartConfig", "PetConfig", "T5Config", "VisConfig",
           "VLModelConfig", "vlpet_recipe", "FLAGSHIP_TASKS", "flagship_cfg",
           "VIDEO_TASKS", "video_cfg", "t5_cfg"]


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class AdapterSpec:
    """Bottleneck-adapter hyperparameters.

    Mirrors the reference ``AdapterConfig`` dataclass
    (reference: src/adapters/config.py:5-57) plus the VL-PET down-dim
    override and parallel/scaling switches consumed by
    ``AdapterController`` (src/adapters/adapter_controller.py:131-163).
    """

    d_model: int = 768
    reduction_factor: int = 16
    non_linearity: str = "gelu_new"
    use_adapter_down_dim: bool = False
    adapter_down_dim: int = 96
    use_parallel_adapter: bool = False
    use_scaling_factor: bool = False
    scaling_factor: float = 1.0
    add_layer_norm_before_adapter: bool = False
    add_layer_norm_after_adapter: bool = False
    # routing / sharing
    tasks: Tuple[str, ...] = ("default",)
    use_single_adapter: bool = False
    share_up_sampler: bool = False
    share_down_sampler: bool = False
    # adapter family: 'bottleneck' | 'compacter' (PHM) | 'lowrank'
    kind: str = "bottleneck"
    # compacter / PHM (reference: src/adapters/config.py:79-128)
    hypercomplex_division: int = 4
    phm_rank: int = 1
    shared_phm_rule: bool = True
    factorized_phm: bool = True
    factorized_phm_rule: bool = False
    learn_phm: bool = True
    phm_init_range: float = 0.01
    phm_c_init: str = "normal"
    shared_phm_rule_over_tasks: bool = False
    # model-shared Compacter W (down/up slow weights live once at the model
    # root and are injected into every PHMDense, like shared_phm_rule).
    # NOTE: the reference declares this flag (src/adapters/config.py:35) but
    # its wiring is dead code — PHMLinear.set_W (hypercomplex/layers.py:160)
    # is never called, so enabling it there crashes. Implemented working here.
    shared_W_phm: bool = False
    kronecker_prod: bool = False
    # low-rank adapter (reference: src/adapters/config.py:129-173)
    low_rank_rank: int = 1
    low_rank_w_init: str = "glorot-uniform"
    # activation-z tracking for the L2 regularizer (reference: track_z)
    track_z: bool = False

    @property
    def down_dim(self) -> int:
        if self.use_adapter_down_dim:
            return self.adapter_down_dim
        return self.d_model // self.reduction_factor



@dataclass(frozen=True)
class LoraSpec:
    """LoRA hyperparameters (reference: src/lora/config.py:5-9)."""

    lora_dim: int = 4
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    tasks: Tuple[str, ...] = ("default",)
    use_single_lora: bool = False


@dataclass(frozen=True)
class PromptSpec:
    """Prompt-tuning hyperparameters (reference: src/prompt/config.py:5-22)."""

    prompt_len: int = 0
    mid_dim: int = 768
    use_single_prompt: bool = False
    tasks: Tuple[str, ...] = ("default",)


@dataclass(frozen=True)
class HyperformerSpec:
    """Hyperformer hypernetwork settings
    (reference: src/adapters/config.py:58-78, adapter_hypernetwork.py)."""

    task_embedding_dim: int = 512
    projected_task_embedding_dim: int = 64
    layer_id_embedding_dim: int = 64
    hidden_dim: int = 128
    unique_hyper_net: bool = False
    efficient_unique_hyper_net: bool = False
    unique_hyper_net_layer_norm: bool = True
    train_task_embeddings: bool = False


@dataclass(frozen=True)
class PetConfig:
    """All PET flags, names preserved from the reference CLI
    (reference: src/param.py:141-394). Defaults match argparse defaults."""

    tasks: Tuple[str, ...] = ("default",)

    # --- serial adapters / compacter / low-rank adapter --------------------
    use_adapter: bool = False
    use_compacter: bool = False
    use_lradapter: bool = False
    use_single_adapter: bool = False
    share_down_sampler: bool = False
    share_up_sampler: bool = False
    reduction_factor: int = 16
    use_adapter_down_dim: bool = False
    adapter_down_dim: int = 96
    add_layer_norm_before_adapter: bool = False
    add_layer_norm_after_adapter: bool = False
    no_encoder_adapter: bool = False
    no_decoder_adapter: bool = False
    no_encoder_attn_adapter: bool = False
    add_adapter_cross_attn: bool = True
    use_encoder_attn_adapter_scaling: bool = False
    encoder_attn_adapter_scaling_factor: float = 1.0
    use_encoder_ff_adapter_scaling: bool = False
    encoder_ff_adapter_scaling_factor: float = 1.0
    track_z: bool = False
    lambda_z: float = 0.001

    # compacter / PHM
    hypercomplex_division: int = 4
    phm_rank: int = 1
    shared_phm_rule: bool = True
    factorized_phm: bool = True
    factorized_phm_rule: bool = False
    learn_phm: bool = True
    phm_init_range: float = 0.01
    shared_phm_rule_over_tasks: bool = False
    shared_W_phm: bool = False  # see AdapterSpec.shared_W_phm
    low_rank_rank: int = 1

    # --- hyperformer --------------------------------------------------------
    use_hyperformer: bool = False
    unique_hyper_net: bool = False
    efficient_unique_hyper_net: bool = False
    projected_task_embedding_dim: int = -1

    # --- LoRA ----------------------------------------------------------------
    use_lora: bool = False
    lora_dim: int = 4
    lora_alpha: float = 32.0
    use_single_lora: bool = False

    # --- prompt tuning -------------------------------------------------------
    encoder_prompt_len: int = 0
    decoder_prompt_len: int = 0
    use_single_prompt: bool = False
    use_attn_prefix: bool = False
    mid_dim: int = 768

    # --- lm-head adapter ----------------------------------------------------
    use_lm_head_adapter: bool = False

    # --- VL-PET encoder multihead adapters ----------------------------------
    use_encoder_adapter_down_multihead: bool = False
    use_encoder_adapter_up_multihead: bool = False
    use_encoder_adapter_down_up_multihead: bool = False
    use_encoder_adapter_down_up_pair_multihead: bool = False
    encoder_adapter_multihead_num_head: int = 1

    # --- VL-PET decoder multihead adapters ----------------------------------
    use_decoder_adapter_down_multihead: bool = False
    decoder_adapter_multihead_num_head: int = 1

    # --- encoder granularity gates (on adapter output) ----------------------
    use_encoder_adapter_gating_large_x: bool = False
    use_encoder_adapter_gating_large_x_lowrank: bool = False
    adapter_gating_down_dim: int = 96
    use_encoder_adapter_gating_small_xy_cat: bool = False
    use_encoder_adapter_gating_middle_xy_add: bool = False
    use_encoder_adapter_gating_middle_ia3_add: bool = False
    use_encoder_adapter_gating_layernorm: bool = False
    use_encoder_adapter_gating_l2norm: bool = False
    use_encoder_adapter_gating_add: bool = False

    # --- standalone encoder gating (replaces adapter) ------------------------
    use_encoder_gating_large_x_lowrank: bool = False
    gating_down_dim: int = 96
    use_encoder_gating_large_x_lowrank_add_x2_deltay: bool = False

    # --- encoder/decoder scaling ---------------------------------------------
    use_encoder_gating_scaling: bool = False
    encoder_gating_scaling_factor: float = 1.0
    use_encoder_adapter_scaling: bool = False
    encoder_adapter_scaling_factor: float = 1.0
    use_encoder_x2_scaling: bool = False
    encoder_x2_scaling_factor: float = 1.0

    # --- decoder cross-attn value/key parallel adapters (VPA/KPA) ------------
    use_decoder_enc_attn_value_parallel_adapter_down_dim: bool = False
    decoder_enc_attn_value_parallel_adapter_down_dim: int = 96
    use_decoder_enc_attn_value_parallel_adapter_scaling: bool = False
    decoder_enc_attn_value_parallel_adapter_scaling_factor: float = 1.0
    use_decoder_enc_attn_key_parallel_adapter_down_dim: bool = False
    decoder_enc_attn_key_parallel_adapter_down_dim: int = 96
    use_decoder_enc_attn_key_value_adapter_down_dim: bool = False
    decoder_enc_attn_key_value_adapter_down_dim: int = 96
    use_decoder_enc_attn_adapter_down_dim: bool = False
    decoder_enc_attn_adapter_down_dim: int = 96
    use_decoder_enc_attn_adapter_gating_large_x_lowrank: bool = False
    decoder_enc_attn_adapter_gating_large_x_lowrank_down_dim: int = 96
    use_decoder_enc_attn_value_sequential_adapter_down_dim: bool = False
    decoder_enc_attn_value_sequential_adapter_down_dim: int = 96
    use_decoder_enc_attn_value_residual_connection: bool = False
    use_decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank: bool = False
    decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank_down_dim: int = 96
    use_decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank: bool = False
    decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank_down_dim: int = 96
    use_decoder_enc_attn_value_parallel_adapter_down_multihead: bool = False
    use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead: bool = False
    decoder_enc_attn_value_parallel_adapter_multihead_num_head: int = 1

    # --- decoder self-attn value adapters ------------------------------------
    use_decoder_self_attn_value_parallel_adapter_down_dim: bool = False
    decoder_self_attn_value_parallel_adapter_down_dim: int = 96
    use_decoder_self_attn_adapter_down_dim: bool = False
    decoder_self_attn_adapter_down_dim: int = 96
    use_decoder_ff_adapter_down_dim: bool = False
    decoder_ff_adapter_down_dim: int = 96

    # --- encoder self-attn value adapters ------------------------------------
    use_encoder_attn_value_parallel_adapter_down_dim: bool = False
    encoder_attn_value_parallel_adapter_down_dim: int = 96

    # --- IA3 ------------------------------------------------------------------
    use_decoder_enc_attn_value_ia3: bool = False
    use_decoder_enc_attn_value_ia3_add: bool = False
    use_decoder_enc_attn_value_ia3_one_init: bool = False
    use_decoder_self_attn_value_ia3: bool = False
    use_decoder_self_attn_value_ia3_add: bool = False
    use_decoder_self_attn_value_ia3_one_init: bool = False
    use_decoder_ff_ia3: bool = False
    use_decoder_ff_ia3_add: bool = False
    use_decoder_ff_ia3_one_init: bool = False
    use_encoder_attn_value_ia3: bool = False
    use_encoder_attn_value_ia3_add: bool = False
    use_encoder_attn_value_ia3_one_init: bool = False

    # --- post-hoc weight-init overrides (reference: trainer_base.py:544-599) -
    use_encoder_multihead_up_zero_init: bool = False
    use_encoder_gating_large_x_lowrank_up_zero_init: bool = False
    use_decoder_enc_vpa_up_zero_init: bool = False
    use_encoder_gating_small_up_zero_init: bool = False
    use_encoder_gating_middle_up_zero_init: bool = False
    use_encoder_gating_middle_ia3_one_init: bool = False
    use_encoder_gating_middle_ia3_zero_init: bool = False

    # --- freezing flags (reference: trainer_base.py:308-542) -----------------
    freeze_vis_emb: bool = False
    unfreeze_language_model: bool = False
    unfreeze_lm_head: bool = False
    unfreeze_layer_norms: bool = False
    unfreeze_encoder_layer_norms: bool = False
    unfreeze_decoder_layer_norms: bool = False
    unfreeze_decoder_input_layer_norms: bool = False
    unfreeze_decoder_self_attn_layer_norms: bool = False
    unfreeze_decoder_encoder_attn_layer_norms: bool = False
    unfreeze_decoder_ff_layer_norms: bool = False
    unfreeze_bias: bool = False
    unfreeze_encoder_bias: bool = False
    unfreeze_decoder_bias: bool = False
    unfreeze_batch_norms: bool = False
    unfreeze_vis_encoder: bool = False
    unfreeze_vis_last_layer: bool = False
    use_vis_adapter: bool = False

    # ------------------------------------------------------------------
    # Derived specs
    # ------------------------------------------------------------------

    def adapter_spec(self, d_model: int) -> AdapterSpec:
        """The base AdapterSpec, as built by the reference trainer
        (reference: trainer_base.py:118-178)."""
        kind = "bottleneck"
        if self.use_compacter:
            kind = "compacter"
        elif self.use_lradapter:
            kind = "lowrank"
        return AdapterSpec(
            d_model=d_model,
            reduction_factor=self.reduction_factor,
            use_adapter_down_dim=self.use_adapter_down_dim,
            adapter_down_dim=self.adapter_down_dim,
            add_layer_norm_before_adapter=self.add_layer_norm_before_adapter,
            add_layer_norm_after_adapter=self.add_layer_norm_after_adapter,
            tasks=self.tasks,
            use_single_adapter=self.use_single_adapter,
            share_up_sampler=self.share_up_sampler,
            share_down_sampler=self.share_down_sampler,
            kind=kind,
            hypercomplex_division=self.hypercomplex_division,
            phm_rank=self.phm_rank,
            shared_phm_rule=self.shared_phm_rule,
            factorized_phm=self.factorized_phm,
            factorized_phm_rule=self.factorized_phm_rule,
            learn_phm=self.learn_phm,
            phm_init_range=self.phm_init_range,
            shared_phm_rule_over_tasks=self.shared_phm_rule_over_tasks,
            shared_W_phm=self.shared_W_phm,
            low_rank_rank=self.low_rank_rank,
            track_z=self.track_z,
        )

    def down_dim_spec(self, d_model: int, down_dim: int, *, parallel: bool = False,
                      scaling: Optional[float] = None) -> AdapterSpec:
        """Deepcopy-with-down-dim pattern the reference uses for every
        VPA/KPA/down-dim adapter (e.g. my_transformers/modeling_bart.py:1452-1464)."""
        spec = self.adapter_spec(d_model)
        spec = _replace(spec, use_adapter_down_dim=True, adapter_down_dim=down_dim,
                        use_parallel_adapter=parallel)
        if scaling is not None:
            spec = _replace(spec, use_scaling_factor=True, scaling_factor=scaling)
        return spec

    def lora_spec(self) -> LoraSpec:
        return LoraSpec(lora_dim=self.lora_dim, lora_alpha=self.lora_alpha,
                        tasks=self.tasks, use_single_lora=self.use_single_lora)

    def hyperformer_spec(self) -> HyperformerSpec:
        """The spec every hypernet of the JAX BART builds
        (vlpet_tpu/models/bart.py:905-909, vlpet_tpu/models/vlbart.py:55-58):
        the projected task-embedding width, 64 when the flag is unset."""
        return HyperformerSpec(
            projected_task_embedding_dim=(self.projected_task_embedding_dim
                                          if self.projected_task_embedding_dim
                                          > 0 else 64),
            unique_hyper_net=self.unique_hyper_net,
            efficient_unique_hyper_net=self.efficient_unique_hyper_net)


@dataclass(frozen=True)
class VisConfig:
    """Visual-embedding settings (reference: src/param.py:94-114,378-388)."""

    feat_dim: int = 2048
    pos_dim: int = 4
    n_images: int = 2
    n_boxes: int = 36
    use_vis_order_embedding: bool = True
    use_vis_layer_norm: bool = True
    individual_vis_layer_norm: bool = True
    share_vis_lang_layer_norm: bool = False
    no_vis: bool = False
    downsample: bool = False
    oneddownsample: bool = False
    sparse_sample: bool = False
    expand_vis_embedding: bool = False
    n_image_tokens: int = 4
    vis_use_transformer: bool = False
    additional_visual_embedding_layers: int = 0
    # prefix-variant: feed visual features as per-encoder-layer KV prompts
    # instead of sequence concat (reference: PrefixJointEncoder,
    # modeling_bart.py:901-1085 + ResidualVisualEmbedding :442)
    use_vis_prefix: bool = False
    # VL-PET lightweight visual projector (reference: modeling_bart.py:195)
    use_lowrank_visual_projector: bool = False
    visual_projector_down_dim: int = 96
    visual_projector_multihead_num_head: int = 1
    use_visual_projector_gating_large_x_lowrank: bool = False
    visual_projector_gating_down_dim: int = 96
    use_visual_projector_residual_connection: bool = False
    # default object-order ids exist in the reference but are unused defaults
    default_obj_order_ids: Tuple[int, ...] = ()



@dataclass(frozen=True)
class BartConfig:
    """facebook/bart-base architecture (HF 4.2.1 semantics).

    Reference: src/my_transformers/modeling_bart.py (BartConfig usage);
    position offset 2 at :122-140; post-LN layers; layernorm_embedding.
    """

    vocab_size: int = 50265
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    activation_function: str = "gelu"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    init_std: float = 0.02
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    encoder_layerdrop: float = 0.0
    decoder_layerdrop: float = 0.0
    is_t5: bool = False

    @property
    def num_heads(self) -> int:
        return self.encoder_attention_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads



@dataclass(frozen=True)
class T5Config:
    """t5-base architecture (HF 4.2.1 semantics).

    Reference: src/my_transformers/modeling_t5.py (T5Stack/T5Attention);
    relative position bias at :509; RMS LayerNorm; no biases in linears.
    """

    vocab_size: int = 32100
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0
    feed_forward_proj: str = "relu"
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    tie_word_embeddings: bool = True
    is_t5: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_kv


@dataclass(frozen=True)
class VLModelConfig:
    """Everything a VL model needs: backbone + vis + pet."""

    backbone: BartConfig | T5Config = field(default_factory=BartConfig)
    vis: VisConfig = field(default_factory=VisConfig)
    pet: PetConfig = field(default_factory=PetConfig)
    # loss / head options
    classifier: bool = False
    num_answers: int = 3129  # VQAv2 topk answers (classifier head)
    # compute dtype for activations ('float32' | 'bfloat16')
    dtype: str = "float32"
    # kernel routing of the JAX package; the port runs its own kernels on
    # CUDA tensors and does not read this one
    use_pallas_attention: Optional[bool] = None
    # fused beam attend + in-place cache write (not ported: raises)
    use_fused_beam: bool = False
    # fused linear + cross-entropy (not ported: raises)
    use_fused_ce: bool = False
    # per-layer rematerialization policy ('none' | 'dots' | 'full'; only
    # 'none' is ported)
    remat: str = "none"
    # stacked layer params under lax.scan (not ported: raises)
    scan_layers: bool = False
    # fused fc1 -> act -> fc2 (kernel F1/F2); off, or a trainable language
    # model, takes the plain fc1 -> act -> fc2
    use_fused_ffn: bool = True

    @property
    def is_t5(self) -> bool:
        return self.backbone.is_t5

    @property
    def d_model(self) -> int:
        return self.backbone.d_model


_VLPET_COMMON = dict(
    use_adapter=True,
    use_single_adapter=True,
    no_encoder_adapter=True,
    no_decoder_adapter=True,
    use_adapter_down_dim=True,
    use_encoder_adapter_down_multihead=True,
    encoder_adapter_multihead_num_head=4,
    unfreeze_encoder_layer_norms=True,
    use_decoder_enc_attn_value_parallel_adapter_down_dim=True,
)


def vlpet_recipe(variant: str, r: int = 96, num_heads: int = 4, gate_dim: int = 96,
                 dec_r: Optional[int] = None, tasks: Tuple[str, ...] = ("default",),
                 t5: bool = False) -> PetConfig:
    """Build the PetConfig for one of the four published VL-PET variants.

    Reference flag recipes: scripts/image-text/VL-PET-{small,middleX,middleY,large}.sh
    and T5 variants with zero-init + gate-scaling flags
    (scripts/image-text/T5-VL-PET-large.sh).
    """
    dec_r = r if dec_r is None else dec_r
    kw = dict(_VLPET_COMMON)
    kw.update(
        adapter_down_dim=r,
        encoder_adapter_multihead_num_head=num_heads,
        decoder_enc_attn_value_parallel_adapter_down_dim=dec_r,
        tasks=tuple(tasks),
    )
    if variant == "small":
        kw.update(use_encoder_adapter_gating_small_xy_cat=True)
    elif variant == "middleX":
        kw.update(use_encoder_adapter_gating_middle_xy_add=True)
    elif variant == "middleY":
        kw.update(use_encoder_adapter_gating_middle_ia3_add=True)
    elif variant == "large":
        kw.update(use_encoder_adapter_gating_large_x_lowrank=True,
                  adapter_gating_down_dim=gate_dim)
    elif variant == "none":
        pass
    else:
        raise ValueError(f"unknown VL-PET variant: {variant}")
    if t5:
        kw.update(
            use_encoder_multihead_up_zero_init=True,
            use_encoder_gating_large_x_lowrank_up_zero_init=True,
            use_decoder_enc_vpa_up_zero_init=True,
            use_encoder_gating_scaling=True,
            encoder_gating_scaling_factor=0.3,
        )
    return PetConfig(**kw)


FLAGSHIP_TASKS = ("vqa", "gqa", "nlvr", "caption")


def flagship_cfg(dtype: str = "float32") -> VLModelConfig:
    """BART-base + VL-PET-large at full width, the configuration of
    ``__graft_entry__._flagship_cfg``: the published recipe
    (scripts/image-text/VL-PET-large.sh: r 96, 4 heads, gate 96), multitask
    image-text (``FLAGSHIP_TASKS``), 36 boxes of 2048-d features."""
    pet = vlpet_recipe("large", r=96, num_heads=4, gate_dim=96,
                       tasks=FLAGSHIP_TASKS)
    return VLModelConfig(backbone=BartConfig(),
                         vis=VisConfig(feat_dim=2048, n_boxes=36), pet=pet,
                         dtype=dtype)


VIDEO_TASKS = ("tvqa", "how2qa", "tvc", "yc2c")


def video_cfg(dtype: str = "float32") -> VLModelConfig:
    """BART-base + VL-PET-large for video-text multitask, the configuration
    that vlpet_tpu/cli/multitask_video.py builds from
    scripts/video-text/VL-PET-large.sh: r 96, 4 heads, gate 96,
    ``VIDEO_TASKS``, 64 CLIP-ViT frames of 512-d features (the joint
    sequence is 64 frames + the text tokens: S 604 at 540 text tokens).
    The script's ``--reduction_factor 8`` is kept, though adapters sized by
    ``adapter_down_dim`` do not read it."""
    pet = dataclasses.replace(
        vlpet_recipe("large", r=96, num_heads=4, gate_dim=96,
                     tasks=VIDEO_TASKS), reduction_factor=8)
    return VLModelConfig(backbone=BartConfig(),
                         vis=VisConfig(feat_dim=512, n_boxes=64), pet=pet,
                         dtype=dtype)


def t5_cfg(dtype: str = "float32", gated: bool = False) -> VLModelConfig:
    """T5-base + VL-PET-large at full width, with the flags of
    scripts/image-text/T5-VL-PET-large.sh: r 192, 4 heads, gate 192,
    multitask image-text (``FLAGSHIP_TASKS``), 36 boxes of 2048-d features,
    and ``t5=True`` (zero-init ups, encoder gating scale 0.3), which
    ``__graft_entry__._flagship_t5_cfg`` leaves off. The backbone is
    ``T5Config()``: d 768, 12 heads, d_kv 64, FFN 3072 relu, 12+12 layers,
    vocab 32100, the tied head with the d_model**-0.5 rescale.

    ``gated=True`` puts the same PET on the dimensions of the public
    google/t5-v1_1-base config.json: d_ff 2048, ``gated-gelu`` FFN, vocab
    32128 and an untied ``lm_head``; every other T5Config default stays."""
    pet = vlpet_recipe("large", r=192, num_heads=4, gate_dim=192,
                       tasks=FLAGSHIP_TASKS, t5=True)
    backbone = (T5Config(d_ff=2048, feed_forward_proj="gated-gelu",
                         vocab_size=32128, tie_word_embeddings=False)
                if gated else T5Config())
    return VLModelConfig(backbone=backbone,
                         vis=VisConfig(feat_dim=2048, n_boxes=36), pet=pet,
                         dtype=dtype)


def t5_video_cfg(dtype: str = "float32") -> VLModelConfig:
    """T5-base + VL-PET-large at the video shape: ``t5_cfg()`` (relu FFN,
    tied head, the T5 recipe's PET and tasks) with 64 CLIP-ViT frames of
    512-d features, as scripts/bench_step_variants.py's ``t5_video_base``
    variant builds it (``_bench_variant`` with ``_video`` and ``_t5``: the
    joint sequence is 64 frames + 540 text tokens, S 604, at batch 50). The
    one difference from that variant is ``t5_cfg``'s ``t5=True``."""
    cfg = t5_cfg(dtype)
    return dataclasses.replace(cfg, vis=dataclasses.replace(
        cfg.vis, feat_dim=512, n_boxes=64))
