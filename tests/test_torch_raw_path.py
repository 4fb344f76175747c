"""The port's raw-image path (vlpet_tpu_torch/vision/vis_encoder.py
RawInputVLModel, through train/steps.py make_train_step with the images in
the vis_feats slot, the Trainer's raw mode and the multitask CLI's raw_*
feature types) against the JAX package's, on the CPU.

The model-level cases use a tiny CLIP ResNet ("RN_tiny": layers (1, 1, 1,
1), width 16, 512-d grid features, 2 x 2 grid at 64 px), added to both
packages' ``_RESNET_CONFIGS`` for this module, under a tiny BART (and one
tiny T5) with the serial adapter and the middle-bottleneck visual adapters
(--use_vis_adapter). The JAX variables, BatchNorm statistics included, go
to the port by ``convert.load_flax_params``; the images go in NHWC to JAX
and NCHW to the port. Logits agree within 1e-5 * (1 + max|jax|) in fp32;
the 3-step lockstep at dropout 0 holds phase 6's rules (loss and gradient
norm 1e-5 relative a step, parameters rtol 1e-3, atol 1e-5 max|p|), the
trainable sets are equal under the name map, and the trunk's BatchNorm
statistics are unchanged by training; greedy and beam-3 tokens are
identical. The CLI case runs tests/test_raw_path.py's ARGV and data root
through both multitask mains from one set of weights, with the trunk
swapped for RN_tiny (raw_RN_tiny, feat_dim 512, to keep the file short;
RN50 at 64 px is held module by module in tests/test_torch_vision.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.vision.clip as jclip
import vlpet_tpu_torch.vision.clip as tclip
from vlpet_tpu.config import (BartConfig, PetConfig, T5Config, VisConfig,
                              VLModelConfig)
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_raw_train_step as jstep_fn
from vlpet_tpu.vision.vis_encoder import RawInputVLModel as JRaw
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import (attention_heads, flax_leaves,
                                     flax_to_state_dict, load_flax_params)
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step
from vlpet_tpu_torch.vision.vis_encoder import RawInputVLModel

torch.set_num_threads(2)  # several xdist workers share the host

TINY_RN = dict(layers=(1, 1, 1, 1), width=16, output_dim=32)
B, L_TXT, L_TGT, IMG = 4, 6, 4, 64
K = 3
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
TASKS = ("vqa", "nlvr")
ADAPTER = "middle-bottleneck"


@pytest.fixture(scope="module", autouse=True)
def tiny_resnet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jclip._RESNET_CONFIGS, "RN_tiny", TINY_RN)
        mp.setitem(tclip._RESNET_CONFIGS, "RN_tiny", TINY_RN)
        yield


def _jax_cfg(t5=False):
    # the port's T5 has no serial adapters: the visual adapters alone there
    pet = PetConfig(use_vis_adapter=True, use_adapter=not t5,
                    use_single_adapter=not t5, tasks=TASKS)
    vis = VisConfig(feat_dim=512, n_boxes=4)
    if t5:
        return VLModelConfig(
            backbone=T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                              num_layers=2, num_decoder_layers=2, num_heads=4,
                              dropout_rate=0.0), vis=vis, pet=pet)
    return VLModelConfig(
        backbone=BartConfig(vocab_size=64, d_model=32, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=64,
                            dropout=0.0), vis=vis, pet=pet)


def _port_cfg(jcfg) -> pc.VLModelConfig:
    d = dataclasses.asdict(jcfg)
    b = d.pop("backbone")
    backbone = (pc.T5Config if jcfg.is_t5 else pc.BartConfig)(**b)
    return pc.VLModelConfig(backbone=backbone, vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    tol = 1e-5 * (1.0 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= tol, (what, err, tol)


def _batch(rng, V, n_images=1):
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, L_TXT - 2:] = 0
    targets = rng.integers(3, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100
    shape = (B, IMG, IMG, 3) if n_images == 1 else (B, n_images, IMG, IMG, 3)
    return dict(input_ids=rng.integers(3, V, (B, L_TXT)).astype(np.int32),
                attention_mask=mask,
                images=rng.normal(size=shape).astype(np.float32),
                target_ids=targets,
                scores=rng.uniform(0.3, 1.0, B).astype(np.float32))


def _torch_batch(batch):
    """The port's batch: the images NCHW in the vis_feats slot, as
    train/trainer.py array_batch puts them."""
    out = {k: torch.from_numpy(v).long() if v.dtype == np.int32
           else torch.from_numpy(v) for k, v in batch.items()}
    out["vis_feats"] = out.pop("images").movedim(-1, -3).contiguous()
    return out


def _spread_stats(variables, rng):
    """The trunk's BatchNorm scales, biases and statistics off their
    identity init (numpy copies)."""
    v = jax.tree_util.tree_map(np.array, jax.device_get(variables))

    def walk(tree, under_bn):
        for k, x in tree.items():
            if isinstance(x, dict):
                walk(x, under_bn or k.startswith(("bn", "downsample_bn")))
            elif under_bn and k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
            elif under_bn and k in ("bias", "mean"):
                tree[k] = (0.1 * rng.normal(size=x.shape)).astype(x.dtype)

    walk(v["params"]["vis_encoder"], False)
    walk(v["batch_stats"]["vis_encoder"], False)
    return v


def _models(jcfg, seed=0):
    """(JAX model, its variables, the port model holding them)."""
    rng = np.random.default_rng(seed)
    jmodel = JRaw(jcfg, vis_backbone="RN_tiny", image_size=IMG,
                  vis_adapter_type=ADAPTER, vis_reduction_factor=2)
    b = _batch(rng, jcfg.backbone.vocab_size)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(b["input_ids"]),
        jnp.asarray(b["attention_mask"]), jnp.asarray(b["images"]),
        labels=jnp.asarray(b["target_ids"]), ctx=JCtx()))()
    variables = _spread_stats(variables, rng)
    port = RawInputVLModel(_port_cfg(jcfg), vis_backbone="RN_tiny",
                           image_size=IMG, vis_adapter_type=ADAPTER,
                           vis_reduction_factor=2, device="cpu")
    load_flax_params(port, variables["params"], variables["batch_stats"])
    return jmodel, variables, port


@pytest.fixture(scope="module")
def bart():
    return _models(_jax_cfg())


@pytest.mark.parametrize("n_images", [1, 2])
def test_logits_and_order_ids(bart, n_images):
    """One image, and the NLVR pair: 2 * V_L visual tokens with
    img_order_ids 0/1 and tiled obj_order_ids."""
    jmodel, variables, port = bart
    b = _batch(np.random.default_rng(1), 64, n_images)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x["input_ids"], x["attention_mask"], x["images"],
        labels=x["target_ids"], ctx=JCtx(task="nlvr", task_idx=1)))(
            variables, jb)
    tb = _torch_batch(b)
    with torch.no_grad():
        got = port(tb["input_ids"], tb["attention_mask"], tb["vis_feats"],
                   labels=tb["target_ids"],
                   ctx=PetContext(task="nlvr", task_idx=1))
    _close(got["logits"], want["logits"], "logits")
    jf = jax.jit(lambda v, x: jmodel.apply(v, x, method=JRaw.vis_forward))(
        variables, jb["images"])
    with torch.no_grad():
        tf = port.vis_forward(tb["vis_feats"])
    _close(tf[0], jf[0], "features")
    assert tf[0].shape[1] == 4 * n_images
    for g, w in zip(tf[2:], jf[2:]):
        if n_images == 1:
            assert g is None and w is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _names(port):
    """The port's trainable names as "/"-joined flax paths."""
    heads = attention_heads(port)
    return {"/".join(p) for n, t in apply_freezing(port, port.cfg.pet).items()
            for p, _ in flax_leaves(n, t, heads=heads.get(n))}


@pytest.mark.parametrize("flag", ["use_vis_adapter", "unfreeze_vis_encoder",
                                  "unfreeze_vis_last_layer", "unfreeze_bias",
                                  "unfreeze_batch_norms"])
def test_trunk_freezing_rules_match_jax(bart, flag):
    """train/freezing.py's rules select the same trunk tensors under the
    port's names (OpenAI's, ``layer4.0``, BatchNorm ``weight``) as under
    the JAX package's (``layer4_0``, ``scale``), for each flag that reads
    a trunk name."""
    from vlpet_tpu.config import PetConfig as JPet

    from vlpet_tpu_torch.train.freezing import path_is_trainable

    jmodel, variables, port = bart
    base = dict(tasks=TASKS, use_vis_adapter=False)
    base[flag] = True
    mask = trainable_mask(variables["params"], JPet(**base))
    want = {"/".join(str(getattr(k, "key", k)) for k in p)
            for p, v in jax.tree_util.tree_flatten_with_path(mask)[0]
            if v and p[0].key == "vis_encoder"}
    pet = pc.PetConfig(**base)
    heads = attention_heads(port)
    got = {"/".join(p) for n, t in port.named_parameters()
           if n.startswith("vis_encoder.") and path_is_trainable(n, pet)
           for p, _ in flax_leaves(n, t, heads=heads.get(n))}
    assert got == want
    assert want or flag == "unfreeze_batch_norms"


def test_raw_lockstep(bart):
    """3 raw vqa steps at dropout 0 with --use_vis_adapter, JAX vs port:
    the trainable sets equal under the name map (the visual adapters in,
    the trunk out), each step's loss and gradient norm, the parameters
    after; the trunk's BatchNorm statistics unchanged."""
    jmodel, variables, _ = bart
    jcfg = jmodel.cfg
    params, stats = variables["params"], variables["batch_stats"]
    mask = trainable_mask(params, jcfg.pet)
    trainable, frozen = split_params(params, mask)
    tx = jbuild_optimizer(trainable, **OPT)
    step = jstep_fn(jmodel, tx, TASKS)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    b = _batch(np.random.default_rng(2), 64)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = []
    for _ in range(K):
        state, m = step(state, frozen, stats, jb, jax.random.PRNGKey(0), 0)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    want_params = flax_to_state_dict(jax.device_get(state.params))

    port = RawInputVLModel(_port_cfg(jcfg), vis_backbone="RN_tiny",
                           image_size=IMG, vis_adapter_type=ADAPTER,
                           vis_reduction_factor=2, device="cpu")
    load_flax_params(port, params, stats)
    jnames = {"/".join(str(getattr(k, "key", k)) for k in p)
              for p, v in jax.tree_util.tree_flatten_with_path(mask)[0] if v}
    assert _names(port) == jnames
    assert any("middle_adapter" in n for n in jnames)
    assert not any("vis_encoder" in n and "adapter" not in n for n in jnames)
    tp = apply_freezing(port, port.cfg.pet)
    assert set(tp) == set(want_params)
    buffers = {n: b.clone() for n, b in port.named_buffers()}
    assert buffers and all("vis_encoder" in n for n in buffers)
    tstep = make_train_step(port, build_optimizer(tp, **OPT), TASKS,
                            device="cpu")
    tb = _torch_batch(b)
    port.train()
    for i in range(K):
        out = tstep(tb, torch.Generator().manual_seed(0), 0)
        for key, w in zip(("loss", "grad_norm"), want[i]):
            np.testing.assert_allclose(float(out[key]), w, rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    for n, p in tp.items():
        w = want_params[n].numpy()
        tol = 1e-3 * np.abs(w) + 1e-5 * np.abs(w).max()
        assert (np.abs(p.detach().numpy() - w) <= tol).all(), n
    for n, b0 in buffers.items():
        assert torch.equal(dict(port.named_buffers())[n], b0), n


def test_generation_tokens(bart):
    """Greedy and beam-3 tokens with images in the vis_feats slot, the VL
    model's weights at a scale that decodes varied tokens (std 0.2)."""
    jmodel, variables, _ = bart
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["vl"] = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)),
        params["vl"])
    jvars = {"params": params, "batch_stats": variables["batch_stats"]}
    port = RawInputVLModel(_port_cfg(jmodel.cfg), vis_backbone="RN_tiny",
                           image_size=IMG, vis_adapter_type=ADAPTER,
                           vis_reduction_factor=2, device="cpu")
    load_flax_params(port, params, variables["batch_stats"])
    b = _batch(rng, 64)
    tb = _torch_batch(b)
    for beams in (1, 3):
        # one jitted program a width (the eager generation compiles each
        # trunk and encoder op on its own)
        want = np.asarray(jax.jit(lambda v, x, n=beams: jgen.seq2seq_generate(
            jmodel, v, input_ids=x["input_ids"],
            attention_mask=x["attention_mask"], vis_feats=x["images"],
            ctx=JCtx(task="vqa", task_idx=0), num_beams=n, max_length=8))(
                jvars, {k: jnp.asarray(v) for k, v in b.items()}))
        got = tgen.seq2seq_generate(
            port, input_ids=tb["input_ids"],
            attention_mask=tb["attention_mask"], vis_feats=tb["vis_feats"],
            ctx=PetContext(task="vqa", task_idx=0), num_beams=beams,
            max_length=8)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len({t for row in want[:, 1:] for t in row}) > 2


def test_t5_raw_forward():
    jmodel, variables, port = _models(_jax_cfg(t5=True), seed=4)
    b = _batch(np.random.default_rng(5), 64)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x["input_ids"], x["attention_mask"], x["images"],
        labels=x["target_ids"], ctx=JCtx()))(variables, jb)
    tb = _torch_batch(b)
    with torch.no_grad():
        got = port(tb["input_ids"], tb["attention_mask"], tb["vis_feats"],
                   labels=tb["target_ids"], ctx=PetContext())
    _close(got["logits"], want["logits"], "t5 logits")


def test_pooling_output_raises_where_jax_raises():
    """--vis_pooling_output feeds the pooled (B, 1, output_dim) vector to
    the feature projection: with feat_dim 512 (the grid's width, not the
    pooled 32) both packages raise."""
    jcfg = _jax_cfg()
    b = _batch(np.random.default_rng(6), 64)
    jmodel = JRaw(jcfg, vis_backbone="RN_tiny", image_size=IMG,
                  vis_pooling_output=True)
    with pytest.raises(TypeError):
        jax.jit(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(b["input_ids"]),
            jnp.asarray(b["attention_mask"]), jnp.asarray(b["images"]),
            labels=jnp.asarray(b["target_ids"]), ctx=JCtx()))()
    port = RawInputVLModel(_port_cfg(jcfg), vis_backbone="RN_tiny",
                           image_size=IMG, vis_pooling_output=True,
                           device="cpu")
    tb = _torch_batch(b)
    with pytest.raises(RuntimeError):
        port(tb["input_ids"], tb["attention_mask"], tb["vis_feats"],
             labels=tb["target_ids"])


# --- the CLI: tests/test_raw_path.py's ARGV and data root ---------------

CLI_TINY = dict(vocab_size=50265, d_model=32, encoder_layers=1,
                decoder_layers=1, encoder_attention_heads=4,
                decoder_attention_heads=4, encoder_ffn_dim=64,
                decoder_ffn_dim=64, max_position_embeddings=64)


def _cli_argv(tmp_path):
    from test_raw_path import ARGV, make_data_root

    root = make_data_root(tmp_path, n=16)
    # batches of 8: whole batches for the JAX Trainer's 8 CPU devices
    return ARGV + ["--backbone", "facebook/bart-base", "--batch_size", "8",
                   "--valid_batch_size", "8", "--dropout", "0.0",
                   "--gen_max_length", "4", "--feature_type", "raw_RN_tiny",
                   "--feat_dim", "512", "--data_root", str(root)]


@pytest.fixture
def cli_tiny(monkeypatch):
    """The tiny backbone forced through both packages' multitask CLIs."""
    import vlpet_tpu.cli.multitask as jm
    import vlpet_tpu.cli.param as jp
    import vlpet_tpu_torch.cli.multitask as tm
    import vlpet_tpu_torch.cli.param as tp

    def patch(orig, bart):
        def patched(args, tasks, vocab_size=None):
            cfg = orig(args, tasks, vocab_size)
            return dataclasses.replace(
                cfg, backbone=bart(**CLI_TINY, dropout=args.dropout))
        return patched

    monkeypatch.setattr(jm, "build_model_config",
                        patch(jp.build_model_config, BartConfig))
    monkeypatch.setattr(tm, "build_model_config",
                        patch(tp.build_model_config, pc.BartConfig))
    return jm, jp, tm


def test_cli_matches_jax(tmp_path, monkeypatch, cli_tiny):
    """``cli.multitask.main`` vs the JAX main with a raw trunk at 64 px and
    the visual adapters, from one LAST.npz of the JAX init (--load): the
    epoch's train loss within 1e-5 relative, the vqa score identical. The
    JAX Trainer's model init runs jitted (the same values, one compile);
    its run writes no output (no checkpoint manager to import)."""
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu.train.checkpoint import save_params_npz

    jm, jp, tm = cli_tiny
    argv = _cli_argv(tmp_path)
    args = jp.parse_args(argv)
    tok, added = get_tokenizer(args.backbone, None)
    cfg = jm.build_model_config(args, ("vqa",),
                                effective_vocab_size(tok, added))
    jmodel = JRaw(cfg, vis_backbone="RN_tiny", image_size=IMG,
                  vis_adapter_type=ADAPTER)
    params = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), jnp.ones((2, IMG, IMG, 3)),
        labels=jnp.ones((2, 3), jnp.int32), ctx=JCtx())["params"])()
    npz = str(tmp_path / "w.npz")
    save_params_npz(jax.device_get(params), npz)
    argv += ["--load", npz]
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load
    eager_init = JRaw.init

    def jitted_init(self, rng, *a, **kw):
        return jax.jit(lambda r: eager_init(self, r, *a, **kw))(rng)

    monkeypatch.setattr(JRaw, "init", jitted_init)

    _, want = jm.main(argv + ["--output", ""])
    trainer, got = tm.main(argv + ["--output", str(tmp_path / "port")],
                           device="cpu")
    assert trainer.raw and trainer.train_step.accumulator is None
    assert sorted(got) == sorted(want) == [0]
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"],
                               rtol=1e-5)
    scores = {k: v for k, v in want[0].items()
              if "/" in k and not k.endswith("seconds")}
    assert scores and {k: got[0][k] for k in scores} == scores


def test_cli_device_cuda_raises(tmp_path, monkeypatch, cli_tiny):
    """--device left at its default (cuda) raises on a host without CUDA:
    the raw path does not fall back to the CPU."""
    _, _, tm = cli_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        tm.main(_cli_argv(tmp_path) + ["--output", str(tmp_path / "run")])
