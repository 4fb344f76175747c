"""Argparse surface preserving the reference flag names
(reference: src/param.py:59-419) — the published scripts pass these
positionally, so names and semantics are the public contract. parse_args()
returns the namespace; build_model_config() maps it onto the port's
configuration dataclasses (vlpet_tpu_torch/config.py).

The port's copy of vlpet_tpu/cli/param.py, flag for flag, plus three flags
of its own: ``--device`` (where the CLIs run: "cuda" by default, "cpu" on
request, never a silent fallback) and ``--use_fused_ce`` /
``--use_fused_beam``, which set the VLModelConfig fields of the same names
(C1/C2 and D2). ``--distributed`` and its topology flags start one
process per card over torch.distributed (parallel/multihost.py), and
``--mesh_model_axis`` splits the backbone over a model axis of that many
processes (parallel/mesh.py). ``--pallas_attention`` (TPU kernel routing)
is accepted and not read.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from vlpet_tpu_torch.config import BartConfig, PetConfig, T5Config, VisConfig, VLModelConfig


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("vlpet_tpu")
    add = p.add_argument

    add("--seed", type=int, default=9595)
    add("--train", default="train")
    add("--valid", default="valid")
    add("--test", default=None)
    add("--test_only", action="store_true")
    add("--submit", action="store_true")
    add("--train_topk", type=float, default=-1)
    add("--valid_topk", type=float, default=-1)
    add("--output", type=str, default="snap/test")
    add("--load", type=str, default=None)
    add("--resume", action="store_true",
        help="resume params+optimizer+step from the latest checkpoint in --output")
    add("--from_scratch", action="store_true")
    add("--run_name", type=str, default="")

    # runtime
    add("--multiGPU", action="store_const", default=False, const=True)
    add("--fp16", action="store_true")
    add("--bf16", action="store_true", help="bfloat16 compute")
    add("--device", type=str, default="cuda",
        help="torch device the CLI runs on (cuda: raises without CUDA)")
    add("--use_fused_ce", action="store_true",
        help="streamed linear + cross-entropy (C1/C2) on a frozen head")
    add("--use_fused_beam", action="store_true",
        help="beam self-attend with the cache-slot write (D2)")
    add("--distributed", action="store_true",
        help="one process per card: torch.distributed.init_process_group "
             "at entry (parallel/multihost.py maybe_initialize_distributed;"
             " torchrun's environment also starts it); --batch_size is "
             "per process")
    add("--coordinator_address", type=str, default=None,
        help="rendezvous host:port (else MASTER_ADDR:MASTER_PORT, else "
             "127.0.0.1:29500)")
    add("--num_processes", type=int, default=None,
        help="world size (else WORLD_SIZE, else 1)")
    add("--process_id", type=int, default=None,
        help="this process's rank (else RANK, else 0)")
    add("--num_workers", default=0, type=int)
    add("--local_rank", type=int, default=-1,
        help="this process's card where LOCAL_RANK is not set")
    add("--mesh_model_axis", type=int, default=1,
        help="tensor-parallel axis size of the process mesh (1 where it "
             "does not divide the world size)")
    add("--pallas_attention", type=str, default="auto",
        choices=("auto", "on", "off"),
        help="fused Pallas attention (auto: on for TPU; T5 falls back "
             "under --unfreeze_language_model — the kernel's relative "
             "bias is non-differentiable)")

    # backbone / vision
    add("--backbone", type=str, default="t5-base")
    add("--tokenizer", type=str, default=None)
    add("--backbone_ckpt", type=str, default=None,
        help="local HF checkpoint (.bin/.safetensors) to import")
    add("--tokenizer_path", type=str, default=None,
        help="local tokenizer directory")
    add("--feat_dim", type=float, default=2048)
    add("--pos_dim", type=float, default=4)
    add("--image_size", type=str, default="(448,448)")
    add("--use_vision", default=True, type=str2bool)
    add("--use_vis_order_embedding", default=True, type=str2bool)
    add("--use_vis_layer_norm", default=True, type=str2bool)
    add("--individual_vis_layer_norm", default=True, type=str2bool)
    add("--share_vis_lang_layer_norm", action="store_true")
    add("--n_boxes", type=int, default=36)
    add("--max_n_boxes", type=int, default=36)
    add("--max_text_length", type=int, default=20)
    add("--additional_visual_embedding_layers", type=int, default=0)
    add("--downsample", action="store_true")
    add("--oneddownsample", action="store_true")
    add("--expand_vis_embedding", action="store_true")
    add("--n_image_tokens", type=int, default=4)
    add("--vis_use_transformer", action="store_true")
    add("--sparse_sample", action="store_true")
    add("--n_images", type=int, default=2)

    # optimization
    add("--batch_size", type=int, default=256)
    add("--valid_batch_size", type=int, default=None)
    add("--optim", default="adamw")
    add("--warmup_ratio", type=float, default=0.05)
    add("--weight_decay", type=float, default=0.01)
    add("--clip_grad_norm", type=float, default=-1.0)
    add("--gradient_accumulation_steps", type=int, default=1)
    add("--lr", type=float, default=1e-4)
    add("--vis_lr", type=float, default=1e-4)
    add("--vis_weight_decay", type=float, default=0.01)
    add("--adam_eps", type=float, default=1e-6)
    add("--adam_beta1", type=float, default=0.9)
    add("--adam_beta2", type=float, default=0.999)
    add("--epochs", type=int, default=12)
    add("--dropout", type=float, default=0.1)
    add("--losses", default="lm,obj,attr,feat", type=str)
    add("--log_train_accuracy", action="store_true")

    # prompts
    add("--encoder_prompt_len", type=int, default=0)
    add("--decoder_prompt_len", type=int, default=0)
    add("--use_single_prompt", action="store_true")
    add("--use_attn_prefix", action="store_true")
    add("--mid_dim", type=int, default=768)

    # adapters / compacter / hyperformer
    add("--use_adapter", action="store_true")
    add("--use_hyperformer", action="store_true")
    add("--use_compacter", action="store_true")
    add("--use_lradapter", action="store_true")
    add("--use_single_adapter", action="store_true")
    add("--efficient_unique_hyper_net", action="store_true")
    add("--unique_hyper_net", action="store_true")
    add("--projected_task_embedding_dim", default=-1, type=int)
    add("--share_down_sampler", action="store_true")
    add("--share_up_sampler", action="store_true")
    add("--hypercomplex_division", type=int, default=4)
    add("--phm_rank", type=int, default=1)
    add("--shared_phm_rule", type=str2bool, default=True)
    add("--factorized_phm", type=str2bool, default=True)
    add("--add_adapter_cross_attn", type=str2bool, default=True)
    add("--low_rank_rank", type=int, default=1)
    add("--phm_init_range", type=float, default=0.01)
    add("--shared_phm_rule_over_tasks", action="store_true")
    # extension: working version of the reference's declared-but-dead
    # shared_W_phm mode (src/adapters/config.py:35; set_W never called)
    add("--shared_W_phm", type=str2bool, default=False)
    add("--add_layer_norm_before_adapter", action="store_true")
    add("--add_layer_norm_after_adapter", action="store_true")
    add("--reduction_factor", type=int, default=16)
    add("--track_z", action="store_true")
    add("--lambda_z", type=float, default=0.001)

    # vision encoder / freezing
    add("--vis_pooling_output", action="store_true")
    add("--use_vis_adapter", action="store_true")
    add("--use_separate_optimizer_for_visual", action="store_true")
    add("--use_adam_for_visual", action="store_true")
    add("--freeze_ln_statistics", action="store_true")
    add("--freeze_bn_statistics", action="store_true")
    add("--vis_adapter_type", type=str, default="middle-bottleneck")
    add("--vis_reduction_factor", type=int, default=2)
    add("--clip_ckpt", type=str, default=None,
        help="local OpenAI CLIP .pt state dict for the raw_* trunk "
             "(offline substitute for the reference's clip.load)")
    add("--unfreeze_vis_encoder", action="store_true")
    add("--unfreeze_vis_last_layer", action="store_true")
    add("--unfreeze_batch_norms", action="store_true")
    add("--remove_bn_vis_adapter", action="store_true")
    add("--unfreeze_lm_head", action="store_true")
    add("--use_lm_head_adapter", action="store_true")
    add("--use_data_augmentation", action="store_true")
    add("--deepspeed", type=str, default=None)

    # lora
    add("--use_lora", action="store_true")
    add("--lora_dim", type=int, default=4)
    add("--lora_alpha", type=float, default=32)
    add("--use_single_lora", action="store_true")

    # inference
    add("--num_beams", type=int, default=1)
    add("--gen_max_length", type=int, default=20)

    # data
    add("--caption_only", action="store_true")
    add("--coco_only", action="store_true")
    add("--caption_cocoonly", default=True, type=str2bool)
    add("--do_lower_case", action="store_true")
    add("--oscar_tags", action="store_true")
    add("--prefix", type=str, default=None)
    add("--prompt", type=str, default="vqa: ")
    add("--post_prompt", type=str, default="")
    add("--feature_type", type=str, default="butd")
    add("--itm_cocoonly", default=True, type=str2bool)
    add("--single_vqa_prefix", action="store_true")
    add("--no_prefix", action="store_true")
    add("--raw_label", action="store_true")
    add("--answer_normalize", action="store_true")
    add("--classifier", action="store_true")
    add("--test_answerable", action="store_true")
    add("--data_root", type=str, default=None,
        help="root of the dataset files; synthetic data when absent")
    add("--synthetic_examples", type=int, default=0,
        help="use N synthetic examples per task instead of real data")

    # multitask
    add("--multitask_sampling", type=str, default="roundrobin")
    add("--tasks", type=str, default="")
    add("--use_tasks_prompts", action="store_true")
    add("--testing", action="store_true")
    add("--comment", type=str, default="")
    add("--dry", action="store_true")

    # freezing flags
    add("--unfreeze_language_model", action="store_true")
    add("--unfreeze_layer_norms", action="store_true")
    add("--no_decoder_adapter", action="store_true")
    add("--unfreeze_encoder_layer_norms", action="store_true")
    add("--unfreeze_decoder_layer_norms", action="store_true")
    add("--unfreeze_decoder_input_layer_norms", action="store_true")
    add("--unfreeze_decoder_self_attn_layer_norms", action="store_true")
    add("--unfreeze_decoder_encoder_attn_layer_norms", action="store_true")
    add("--unfreeze_decoder_ff_layer_norms", action="store_true")
    add("--unfreeze_bias", action="store_true")
    add("--unfreeze_encoder_bias", action="store_true")
    add("--unfreeze_decoder_bias", action="store_true")

    # VL-PET gates
    add("--use_encoder_adapter_gating_large_x", action="store_true")
    add("--use_encoder_adapter_gating_large_x_lowrank", action="store_true")
    add("--adapter_gating_down_dim", type=int, default=96)
    add("--use_encoder_gating_large_x_lowrank", action="store_true")
    add("--gating_down_dim", type=int, default=96)
    add("--use_encoder_gating_large_x_lowrank_add_x2_deltay", action="store_true")
    add("--use_adapter_down_dim", action="store_true")
    add("--adapter_down_dim", type=int, default=96)
    add("--use_encoder_adapter_gating_small_xy_cat", action="store_true")
    add("--use_encoder_adapter_gating_middle_xy_add", action="store_true")
    add("--use_encoder_adapter_gating_middle_ia3_add", action="store_true")
    add("--use_encoder_adapter_gating_layernorm", action="store_true")
    add("--use_encoder_adapter_gating_l2norm", action="store_true")
    add("--use_encoder_adapter_gating_add", action="store_true")

    # decoder VPA family
    add("--use_decoder_enc_attn_value_parallel_adapter_down_dim", action="store_true")
    add("--decoder_enc_attn_value_parallel_adapter_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_key_parallel_adapter_down_dim", action="store_true")
    add("--decoder_enc_attn_key_parallel_adapter_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_key_value_adapter_down_dim", action="store_true")
    add("--decoder_enc_attn_key_value_adapter_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_adapter_down_dim", action="store_true")
    add("--decoder_enc_attn_adapter_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_adapter_gating_large_x_lowrank", action="store_true")
    add("--decoder_enc_attn_adapter_gating_large_x_lowrank_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_value_sequential_adapter_down_dim", action="store_true")
    add("--decoder_enc_attn_value_sequential_adapter_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_value_residual_connection", action="store_true")
    add("--use_decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank", action="store_true")
    add("--decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank_down_dim", type=int, default=96)
    add("--use_decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank", action="store_true")
    add("--decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank_down_dim", type=int, default=96)

    # IA3
    add("--use_decoder_enc_attn_value_ia3", action="store_true")
    add("--use_decoder_enc_attn_value_ia3_add", action="store_true")
    add("--use_decoder_enc_attn_value_ia3_one_init", action="store_true")
    add("--use_decoder_self_attn_value_ia3", action="store_true")
    add("--use_decoder_self_attn_value_ia3_add", action="store_true")
    add("--use_decoder_self_attn_value_ia3_one_init", action="store_true")
    add("--use_decoder_ff_ia3", action="store_true")
    add("--use_decoder_ff_ia3_add", action="store_true")
    add("--use_decoder_ff_ia3_one_init", action="store_true")
    add("--no_encoder_attn_adapter", action="store_true")
    add("--use_encoder_attn_value_parallel_adapter_down_dim", action="store_true")
    add("--encoder_attn_value_parallel_adapter_down_dim", type=int, default=96)
    add("--use_encoder_attn_value_ia3", action="store_true")
    add("--use_encoder_attn_value_ia3_add", action="store_true")
    add("--use_encoder_attn_value_ia3_one_init", action="store_true")

    # scalings
    add("--use_decoder_enc_attn_value_parallel_adapter_scaling", action="store_true")
    add("--decoder_enc_attn_value_parallel_adapter_scaling_factor", type=float, default=1.0)
    add("--use_encoder_attn_adapter_scaling", action="store_true")
    add("--encoder_attn_adapter_scaling_factor", type=float, default=1.0)
    add("--use_encoder_ff_adapter_scaling", action="store_true")
    add("--encoder_ff_adapter_scaling_factor", type=float, default=1.0)

    # multihead adapters
    add("--no_encoder_adapter", action="store_true")
    add("--use_encoder_adapter_down_multihead", action="store_true")
    add("--use_encoder_adapter_up_multihead", action="store_true")
    add("--use_encoder_adapter_down_up_multihead", action="store_true")
    add("--use_encoder_adapter_down_up_pair_multihead", action="store_true")
    add("--encoder_adapter_multihead_num_head", type=int, default=1)
    add("--use_decoder_adapter_down_multihead", action="store_true")
    add("--decoder_adapter_multihead_num_head", type=int, default=1)
    add("--use_decoder_enc_attn_value_parallel_adapter_down_multihead", action="store_true")
    add("--use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead", action="store_true")
    add("--decoder_enc_attn_value_parallel_adapter_multihead_num_head", type=int, default=1)
    add("--use_decoder_self_attn_value_parallel_adapter_down_dim", action="store_true")
    add("--decoder_self_attn_value_parallel_adapter_down_dim", type=int, default=96)
    add("--use_decoder_self_attn_adapter_down_dim", action="store_true")
    add("--decoder_self_attn_adapter_down_dim", type=int, default=96)
    add("--use_decoder_ff_adapter_down_dim", action="store_true")
    add("--decoder_ff_adapter_down_dim", type=int, default=96)

    # scaling / init
    add("--use_encoder_gating_scaling", action="store_true")
    add("--encoder_gating_scaling_factor", type=float, default=1.0)
    add("--use_encoder_adapter_scaling", action="store_true")
    add("--encoder_adapter_scaling_factor", type=float, default=1.0)
    add("--use_encoder_multihead_up_zero_init", action="store_true")
    add("--use_encoder_gating_large_x_lowrank_up_zero_init", action="store_true")
    add("--use_decoder_enc_vpa_up_zero_init", action="store_true")
    add("--use_encoder_x2_scaling", action="store_true")
    add("--encoder_x2_scaling_factor", type=float, default=1.0)
    add("--use_encoder_gating_small_up_zero_init", action="store_true")
    add("--use_encoder_gating_middle_up_zero_init", action="store_true")
    add("--use_encoder_gating_middle_ia3_one_init", action="store_true")
    add("--use_encoder_gating_middle_ia3_zero_init", action="store_true")

    # vis projector
    add("--no_vis", action="store_true")
    add("--freeze_vis_emb", action="store_true")
    add("--use_vis_noise", action="store_true")
    add("--use_vis_prefix", action="store_true",
        help="feed visual features as per-layer KV prefixes (PrefixJointEncoder)")
    add("--use_lowrank_visual_projector", action="store_true")
    add("--visual_projector_down_dim", type=int, default=96)
    add("--visual_projector_multihead_num_head", type=int, default=1)
    add("--use_visual_projector_gating_large_x_lowrank", action="store_true")
    add("--visual_projector_gating_down_dim", type=int, default=96)
    add("--use_visual_projector_residual_connection", action="store_true")

    # infer / gate dump
    add("--use_store_gate_large", action="store_true")
    add("--store_gate_path", type=str, default=None)
    add("--infer_only", action="store_true")
    add("--load_trained_model_path", type=str, default=None)

    args = p.parse_args(argv)
    if args.tokenizer is None:
        args.tokenizer = args.backbone
    if args.valid_batch_size is None:
        args.valid_batch_size = args.batch_size
    return args


_PET_FIELDS = {f.name for f in dataclasses.fields(PetConfig)}
_VIS_FIELDS = {f.name for f in dataclasses.fields(VisConfig)}


def build_model_config(args, tasks: Tuple[str, ...],
                       vocab_size: Optional[int] = None) -> VLModelConfig:
    """args → VLModelConfig (the reference's create_config role,
    trainer_base.py:71-222)."""
    pet_kwargs = {k: getattr(args, k) for k in _PET_FIELDS
                  if hasattr(args, k)}
    pet_kwargs["tasks"] = tuple(tasks)
    pet_kwargs["lora_alpha"] = float(args.lora_alpha)
    pet = PetConfig(**pet_kwargs)

    vis_kwargs = {k: getattr(args, k) for k in _VIS_FIELDS if hasattr(args, k)}
    vis_kwargs["feat_dim"] = int(args.feat_dim)
    vis_kwargs["pos_dim"] = int(args.pos_dim)
    vis_kwargs["no_vis"] = args.no_vis or not args.use_vision
    vis = VisConfig(**vis_kwargs)

    if "t5" in args.backbone:
        backbone = T5Config(dropout_rate=args.dropout)
        if vocab_size:
            backbone = dataclasses.replace(backbone, vocab_size=vocab_size)
    else:
        backbone = BartConfig(dropout=args.dropout)
        if vocab_size:
            backbone = dataclasses.replace(backbone, vocab_size=vocab_size)
    dtype = "bfloat16" if (args.bf16 or args.fp16) else "float32"
    pallas_attn = {"auto": None, "on": True, "off": False}[
        getattr(args, "pallas_attention", "auto")]
    return VLModelConfig(backbone=backbone, vis=vis, pet=pet,
                         classifier=args.classifier, dtype=dtype,
                         use_pallas_attention=pallas_attn,
                         use_fused_ce=getattr(args, "use_fused_ce", False),
                         use_fused_beam=getattr(args, "use_fused_beam", False))


class Config:
    """Attr-bag with yaml round trip (reference: src/param.py:422-447)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)

    def save(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump({k: v for k, v in self.__dict__.items()}, f)

    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(**yaml.safe_load(f))

    def __repr__(self):
        import pprint

        return pprint.pformat(self.__dict__)
