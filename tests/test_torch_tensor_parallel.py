"""The port's tensor parallelism on the CPU, against the JAX package: ranks
spawned over gloo (vlpet_tpu_torch.parallel.launch.run_ranks), each
holding its shard of the backbone on the 'model' axis of a (data, model)
mesh (vlpet_tpu_torch/parallel/mesh.py), held to the JAX step on one
device.

* The tiny flagship (BART + VL-PET-large, __graft_entry__._flagship_cfg
  (tiny=True): 4 heads, FFN 128), dropout 0, fp32, global batch 8, K = 3
  steps at (data, model) = (1, 2), (2, 2) and (1, 4), vqa and caption,
  against the JAX make_train_step on the whole batch (the JAX test,
  tests/test_tensor_parallel.py, holds that its own TP equals one
  device). Per step the loss and the gradient norm within 1e-5
  relative; the trainable tensors at the end within the lockstep's rtol
  1e-3, atol 1e-5 * max|p|; every rank holding the same trainable
  tensors bit for bit; each rank's q/k/v, out_proj, fc1 and fc2 1/M of
  the whole.
* ``sharding_report``: every rule-matched family split at M 2 and 4, each
  shard 1/M; ``shared`` whole by design; none silently whole (LoRA's base
  q / v split too; under BitFit the split biases say "split, trains");
  base-shape divisibility for M 2 and 4 on both backbones.
* ``check_tensor_parallel``: the four VL-PET recipes (and the scripts'
  configs) pass; so do the flags once refused under a split (LoRA, the
  prefixes, IA3, the multihead and key VPAs, BitFit, full fine-tuning,
  the classifier, remat, the visual prefix), each sharded at M 2 with a
  reason for every rule-matched parameter; ``scan_layers``, which one
  process refuses, still raises.

The weights are the JAX model's random init (std 0.2), carried to the
port by convert.load_flax_params. The ranks (tests/torch_dist_ranks.py)
import no JAX.
"""

import dataclasses
import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from chip_smoke import script_flags
from test_torch_distributed import _batch
from test_torch_gates import port_cfg, setup_cfg
from torch_dist_ranks import tp_ranks
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.cli.param import build_model_config, parse_args
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.parallel.launch import run_ranks
from vlpet_tpu_torch.parallel.mesh import (Layout, check_tensor_parallel,
                                           shard_model, sharding_report)
from vlpet_tpu_torch.train.freezing import apply_freezing

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
TASKS = ("vqa", "gqa", "nlvr", "caption")
LAYOUTS = [(1, 2), (2, 2), (1, 4)]  # (data, model)
SPAWN_TIMEOUT_S = 120
SPLIT = (r"(q_proj|k_proj|v_proj|out_proj)\.weight$", r"fc1\.weight$",
         r"fc2\.weight$")


def jax_steps(jmodel, jcfg, params, batch, task, tasks=TASKS):
    """K steps of the JAX make_train_step on one device: per-step losses
    and gradient norms, the trainable tensors at the end (port names)."""
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    step = jmake_step(jmodel, tx, tasks)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(K):
        state, m = step(state, frozen, jbatch, jax.random.PRNGKey(0),
                        tasks.index(task))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": flax_to_state_dict(jax.device_get(state.params))}


def spawn_layouts(cases, layouts=LAYOUTS, gen_cases=()):
    """tp_ranks of the train ``cases`` (and the generation cases) at each
    of ``layouts``, the layouts' process groups spawned at once: {layout:
    the ranks' results}."""
    def run(layout):
        data, model = layout
        return run_ranks(tp_ranks, data * model,
                         [dict(c, model_axis=model) for c in cases],
                         [dict(c, model_axis=model) for c in gen_cases],
                         timeout=SPAWN_TIMEOUT_S)

    with ThreadPoolExecutor(len(layouts)) as pool:
        return dict(zip(layouts, pool.map(run, layouts)))


def check_step(ranks, want, case_index, model):
    """One case's per-step figures and end state against ``want``, every
    rank bit for bit with rank 0, and each rank's split weights 1/M of the
    whole."""
    got = ranks[0]["train"][case_index]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    for name, w in want["params"].items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got["params"][name].numpy(), w, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(w).max()), err_msg=name)
    for other in ranks[1:]:
        res = other["train"][case_index]
        assert res["losses"] == got["losses"]
        for name, p in got["params"].items():
            assert torch.equal(res["params"][name], p), name
    return got["shapes"]


def tiny_flagship():
    """The tiny flagship at dropout 0: (JAX config, JAX model, params,
    the port's model of the same weights, the global batch of 8)."""
    jcfg, _ = _flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, dropout=0.0))
    _, jmodel, params, _, _, port = setup_cfg(jcfg)
    bk = jcfg.backbone
    batch = _batch(bk.vocab_size, jcfg.vis.n_boxes, jcfg.vis.feat_dim)
    return jcfg, jmodel, params, port, batch


@pytest.fixture(scope="module")
def bart():
    """The JAX runs and the ranks' runs at every layout."""
    jcfg, jmodel, params, port, batch = tiny_flagship()
    cfg, state = port_cfg(jcfg), port.state_dict()
    cases = [dict(cfg=cfg, state=state, batch=batch, tasks=TASKS, task=t,
                  steps=K, opt=OPT) for t in ("vqa", "caption")]
    want = {t: jax_steps(jmodel, jcfg, params, batch, t)
            for t in ("vqa", "caption")}
    return want, spawn_layouts(cases), port


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("task", ["vqa", "caption"])
def test_tp_step_matches_jax(bart, layout, task):
    want, ranks, port = bart
    shapes = check_step(ranks[layout], want[task],
                        ("vqa", "caption").index(task), layout[1])
    whole = {n: tuple(p.shape) for n, p in port.named_parameters()}
    n_split = 0
    for name, shape in shapes.items():
        if any(re.search(p, name) for p in SPLIT):
            n_split += 1
            assert np.prod(shape) * layout[1] == np.prod(whole[name]), name
        elif "shared" in name or "layer_norm" in name:
            assert shape == whole[name], name
    assert n_split == 2 * 4 + 2 * 8 + 2 * 2 + 2 * 2  # 2 + 2 layers


def _tiny(backbone: str, gated: bool = False, pet: str = ""):
    """The tiny flagship (BART) or a tiny T5 with VL-PET-large; ``pet``
    "lora" / "bitfit": BART with single_lora.sh's or bitfit.sh's flags
    instead (BitFit's trainables marked by ``apply_freezing``)."""
    if backbone == "bart":
        jcfg, _ = _flagship_cfg(tiny=True)
        cfg = port_cfg(jcfg)
        if pet:
            flags = (dict(use_lora=True, lora_dim=4, use_single_lora=True)
                     if pet == "lora" else dict(unfreeze_bias=True))
            cfg = dataclasses.replace(cfg, pet=pc.PetConfig(
                tasks=cfg.pet.tasks, **flags))
        model = VLBart(cfg, device="cpu")
        apply_freezing(model, cfg.pet)
        return model
    cfg = pc.VLModelConfig(
        backbone=pc.T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                             num_layers=2, num_decoder_layers=2, num_heads=4,
                             feed_forward_proj="gated-gelu" if gated
                             else "relu", tie_word_embeddings=not gated),
        vis=pc.VisConfig(feat_dim=16, n_boxes=4),
        pet=pc.vlpet_recipe("large", r=8, num_heads=4, gate_dim=8,
                            tasks=TASKS, t5=True))
    return VLT5(cfg, device="cpu")


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("backbone", ["bart", "t5", "t5_gated", "bart_lora",
                                      "bart_bitfit"])
def test_sharding_report_splits_every_family(backbone, model_axis):
    """Every rule-matched family splits, none silently whole, and
    shard_model leaves each split tensor 1/M of its whole size (on a
    rank's Layout; shard_model runs no collective). LoRA's base q / v
    split (its reason says so) and ``lora_A`` / ``lora_B`` stay whole;
    BitFit's split biases say "split, trains"."""
    model = _tiny(backbone.split("_")[0], gated=backbone.endswith("gated"),
                  pet=backbone.partition("_")[2])
    whole = {n: p.shape for n, p in model.named_parameters()}
    report = sharding_report(model, model_axis)
    split = {n for n, dim, sharded, why in report if sharded}
    kept = {n: why for n, dim, sharded, why in report if not sharded}
    assert set(kept.values()) == {"whole by design"}
    assert all(re.search(r"(^|\.)(shared|lm_head\.weight)$", n) for n in kept)
    fams = ((r"\.(q|k|v|o)\.weight$", r"\.wi(_0|_1)?\.weight$",
             r"\.wo\.weight$") if not backbone.startswith("bart") else
            (r"\.(q_proj|k_proj|v_proj|out_proj)(\.base)?\.weight$",
             r"\.(q_proj|k_proj|v_proj)(\.base)?\.bias$",
             r"fc1\.(weight|bias)$", r"fc2\.weight$"))
    for fam in fams:
        assert any(re.search(fam, n) for n in split), fam
    why = {n: w for n, _, _, w in report}
    if backbone == "bart_lora":
        for proj in ("q_proj", "v_proj"):
            base = [n for n in split if f"{proj}.base." in n]
            assert base and all("LoRA's base" in why[n] for n in base)
        assert not any("lora_" in n for n in why)
    if backbone == "bart_bitfit":
        trains = {n for n in split if why[n].endswith(", trains")}
        assert trains == {n for n in split if n.endswith("bias")} != set()
    assert not any(re.search(r"relative_attention_bias|out_proj\.bias|"
                             r"fc2\.bias|layer_norm|adapter|gating", n)
                   for n in split)
    shard_model(model, Layout(data=1, model=model_axis,
                              model_index=model_axis - 1))
    for n, p in model.named_parameters():
        frac = model_axis if n in split else 1
        assert p.numel() * frac == whole[n].numel(), n


@pytest.mark.parametrize("model_axis", [2, 4])
def test_base_shapes_divide(model_axis):
    """The published BART-base and T5-base split whole heads and hidden
    columns at M 2 and 4 (as test_tp_rules_actually_shard holds for the
    JAX rules)."""
    bart, t5 = pc.BartConfig(), pc.T5Config()
    for heads, ffn in ((bart.encoder_attention_heads, bart.encoder_ffn_dim),
                       (bart.decoder_attention_heads, bart.decoder_ffn_dim),
                       (t5.num_heads, t5.d_ff)):
        assert heads % model_axis == 0 and ffn % model_axis == 0
        assert (ffn // model_axis) % 64 == 0  # the bf16 FFN kernels' chunk


def _scripts():
    return sorted(glob.glob(os.path.join(
        os.path.dirname(__file__), "..", "scripts", "*", "*VL-PET-*.sh")))


def test_vlpet_recipes_pass_the_allowlist():
    for variant in ("small", "middleX", "middleY", "large"):
        for t5 in (False, True):
            check_tensor_parallel(pc.VLModelConfig(
                pet=pc.vlpet_recipe(variant, tasks=TASKS, t5=t5)))
    for path in _scripts():
        args = parse_args(script_flags(path, ["0", "96", "4", "96", "96",
                                              "1e-3", "9595"]))
        cfg = build_model_config(args, tuple(args.tasks.split(",")))
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, attention_dropout=0.1, activation_dropout=0.1)
            if not cfg.is_t5 else cfg.backbone, vis=dataclasses.replace(
                cfg.vis, sparse_sample=True), use_fused_ce=True,
            use_fused_beam=True)
        check_tensor_parallel(cfg)


REFUSED = {
    "lora": dict(use_lora=True),
    "prefix": dict(use_attn_prefix=True),
    "ia3": dict(use_decoder_enc_attn_value_ia3=True),
    "multihead_vpa": dict(
        use_decoder_enc_attn_value_parallel_adapter_down_multihead=True),
    "key_vpa": dict(use_decoder_enc_attn_key_parallel_adapter_down_dim=True),
    "bitfit": dict(unfreeze_bias=True),
    "full_ft": dict(unfreeze_language_model=True),
}


@pytest.mark.parametrize("name", sorted(REFUSED) + ["classifier", "remat",
                                                    "vis_prefix",
                                                    "scan_layers"])
def test_flags_outside_the_allowlist_raise(name):
    """The flags once refused under a model axis > 1 (an allowlist) now run
    split: each configuration passes ``check_tensor_parallel``, shards at
    M 2, and ``sharding_report`` gives every rule-matched parameter a
    reason. ``scan_layers``, which one process refuses, still raises."""
    jcfg, _ = _flagship_cfg(tiny=True)
    cfg = port_cfg(jcfg)
    if name in REFUSED:
        flags = {k: v for k, v in REFUSED[name].items()
                 if hasattr(cfg.pet, k)}
        assert flags, name
        cfg = dataclasses.replace(cfg, pet=dataclasses.replace(cfg.pet,
                                                               **flags))
    elif name == "vis_prefix":
        cfg = dataclasses.replace(cfg, vis=dataclasses.replace(
            cfg.vis, use_vis_prefix=True))
    elif name == "classifier":
        cfg = dataclasses.replace(cfg, classifier=True, num_answers=3)
    elif name == "scan_layers":
        with pytest.raises(NotImplementedError, match="scan_layers"):
            check_tensor_parallel(dataclasses.replace(cfg, scan_layers=True))
        return
    else:
        cfg = dataclasses.replace(cfg, remat="full")
    check_tensor_parallel(cfg)
    model = VLBart(cfg, device="cpu")
    apply_freezing(model, cfg.pet)
    report = sharding_report(model, 2)
    reasons = {why for _, _, _, why in report}
    assert reasons and all(reasons)
    assert reasons <= {"split", "split, trains", "whole by design",
                       "split (LoRA's base rows; lora_B's columns in the "
                       "forward)", "split (LoRA's base rows; lora_B's "
                       "columns in the forward), trains"}, reasons
    shard_model(model, Layout(data=1, model=2, model_index=1))
    assert model.tp.size == 2
