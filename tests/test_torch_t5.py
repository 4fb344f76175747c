"""The ported T5 eval path against the JAX package: a tiny T5 (2+2 layers,
d 32, 4 heads, vocab 80, as tests/test_t5.py tiny_t5_cfg) with visual
features (4 boxes of 16-d) and VL-PET-large at r 8 (the T5 recipe flags:
zero-init ups, gating scale 0.3), in two forms: relu FFN with the tied head,
and the gated-gelu FFN with an untied lm_head. fp32 on CPU; JAX VLT5
params, spread with a seed (at the init the zero-init ups would make the
adapters and gates contribute nothing), carried by vlpet_tpu_torch.convert.
Modules and logits within 1e-5 * (1 + max|jax|), the first decode step's
top-k equal, whole generations token for token (greedy, beam 3, beam 5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.models.t5 import VLT5 as JVLT5
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5
TASKS = ("vqa", "gqa", "nlvr", "caption")
CAPTION = 3
B, L_TXT, N_BOX, FEAT = 3, 6, 4, 16


def _jax_cfg(gated: bool) -> VLModelConfig:
    extra = (dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)
             if gated else {})
    return VLModelConfig(
        backbone=T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_decoder_layers=2, num_heads=4,
                          dropout_rate=0.0, **extra),
        vis=VisConfig(feat_dim=FEAT, n_boxes=N_BOX),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS,
                         t5=True))


def _port_cfg(jcfg) -> pc.VLModelConfig:
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.T5Config(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _spread(params, rng):
    """Every leaf at a seeded scale that decodes varied tokens: norm scales
    1 + N(0, 0.1), everything else N(0, 0.2)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), params)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    tol = TOL * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


@pytest.fixture(scope="module", params=["relu_tied", "gated_untied"])
def t5_models(request):
    cfg = _jax_cfg(gated=request.param == "gated_untied")
    rng = np.random.default_rng(0)
    V = cfg.backbone.vocab_size
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, 4:] = 0
    batch = dict(input_ids=rng.integers(2, V, (B, L_TXT)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B, N_BOX, FEAT)).astype(np.float32),
                 boxes=rng.uniform(size=(B, N_BOX, 4)).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLT5(cfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), **jbatch, labels=jnp.ones((B, 3), jnp.int32),
        ctx=JCtx(task="caption", task_idx=CAPTION))["params"])
    params = _spread(params, rng)
    port = load_flax_params(VLT5(_port_cfg(cfg), device="cpu"), params)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    return cfg, jmodel, {"params": params}, jbatch, port, tbatch


JCTX = JCtx(task="caption", task_idx=CAPTION)
CTX = PetContext(task="caption", task_idx=CAPTION)


def _jax_encode(jmodel, variables, jbatch):
    enc, jm = jmodel.apply(variables, jbatch["input_ids"],
                           jbatch["attention_mask"], jbatch["vis_feats"],
                           jbatch["boxes"], None, None, None, JCTX,
                           method=JVLT5.encode)
    kvs = jmodel.apply(variables, enc, JCTX, method=JVLT5.init_decode)
    return enc, jm, kvs


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket(num_buckets, max_distance, bidirectional):
    """Both directions, distances well past max_distance."""
    from vlpet_tpu.models.t5 import relative_position_bucket as jbucket
    from vlpet_tpu_torch.models.t5 import relative_position_bucket

    rel = np.arange(-3 * max_distance, 3 * max_distance + 1)
    want = np.asarray(jbucket(jnp.asarray(rel, jnp.int32), bidirectional,
                              num_buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                   num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == num_buckets - 1  # the far buckets are reached


def test_rms_norm_matches_flax():
    import flax.linen as nn

    from vlpet_tpu_torch.models.norm import RMSNorm

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 32)) * 3.0 + 1.5).astype(np.float32)
    params = {"scale": (1.0 + 0.1 * rng.normal(size=(32,))).astype(np.float32)}
    want = nn.RMSNorm(epsilon=1e-6).apply({"params": params}, jnp.asarray(x))
    port = load_flax_params(RMSNorm(32, eps=1e-6, device="cpu"), params)
    _close(port(_t(x)), want)


def test_t5_visual_embedding():
    from vlpet_tpu.models.visual import VisualEmbedding as JMod
    from vlpet_tpu_torch.models.visual import VisualEmbedding

    rng = np.random.default_rng(3)
    vis = VisConfig(feat_dim=24, n_boxes=6)
    feats = rng.normal(size=(2, 6, 24)).astype(np.float32)
    boxes = rng.uniform(size=(2, 6, 4)).astype(np.float32)
    table = rng.normal(size=(40, 32)).astype(np.float32)
    jmod = JMod(vis, 32, init_std=None, t5_style_ln=True)
    params = _spread(jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(boxes),
        jnp.asarray(table))["params"]), rng)
    assert set(params["feat_layer_norm"]) == {"scale"}  # RMSNorm
    port = load_flax_params(
        VisualEmbedding(pc.VisConfig(**dataclasses.asdict(vis)), 32,
                        device="cpu", t5_style_ln=True), params)
    want = jmod.apply({"params": params}, jnp.asarray(feats),
                      jnp.asarray(boxes), jnp.asarray(table))
    _close(port(_t(feats), _t(boxes), _t(table)), want)


@pytest.mark.parametrize("is_decoder", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_t5_block(is_decoder, gated):
    """One block with the relative bias: the encoder block with a padding
    mask and the VL-PET hooks; the teacher-forced decoder block with the
    bias plus the causal triangle and cross-attention (VPA on V)."""
    from vlpet_tpu.models.bart import expand_mask as jexpand
    from vlpet_tpu.models.t5 import T5Attention as JAttn
    from vlpet_tpu.models.t5 import T5Block as JBlock
    from vlpet_tpu_torch.models.bart import expand_mask
    from vlpet_tpu_torch.models.t5 import T5Block

    cfg = _jax_cfg(gated)
    rng = np.random.default_rng(4)
    T, S, H = 5, 7, cfg.backbone.num_heads
    h = rng.normal(size=(2, T if is_decoder else S, 32)).astype(np.float32)
    enc = rng.normal(size=(2, S, 32)).astype(np.float32)
    m = np.ones((2, S), np.int32)
    m[1, 5:] = 0
    jmask = jexpand(jnp.asarray(m), 1, jnp.float32)
    jblock = JBlock(cfg, is_decoder=is_decoder,
                    has_relative_attention_bias=True)
    n = T if is_decoder else S
    role = "dec_self" if is_decoder else "enc_self"
    # the block's own bias table, through the JAX compute_bias
    rel = (0.5 * rng.normal(size=(32, H))).astype(np.float32)
    jbias = JAttn(cfg, role=role, has_relative_attention_bias=True).apply(
        {"params": {"relative_attention_bias": jnp.asarray(rel)}}, n, n,
        method=JAttn.compute_bias)
    if is_decoder:
        causal = jnp.where(jnp.arange(n)[None, :] <= jnp.arange(n)[:, None],
                           0.0, -1e9)[None, None]
        kw = dict(position_bias=jbias + causal,
                  encoder_hidden_states=jnp.asarray(enc),
                  encoder_attention_mask=jmask)
    else:
        kw = dict(position_bias=jbias, pad_mask=jmask)
    params = _spread(jax.device_get(jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(h), JCtx(), **kw)["params"]), rng)
    params["self_attn"]["relative_attention_bias"] = rel
    want, _ = jblock.apply({"params": params}, jnp.asarray(h), JCtx(), **kw)
    port = load_flax_params(T5Block(_port_cfg(cfg), is_decoder=is_decoder,
                                    has_relative_attention_bias=True,
                                    device="cpu"), params)
    tmask = expand_mask(_t(m), 1, torch.float32)
    with torch.no_grad():
        bias = port.self_attn.compute_bias(n, n)
        np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
        if is_decoder:
            got = port(_t(h), PetContext(), bias=bias, causal=True,
                       encoder_hidden_states=_t(enc), cross_mask=tmask)
        else:
            got = port(_t(h), PetContext(), mask=tmask, bias=bias)
    _close(got, want)


def test_joint_encoder_and_cross_kv(t5_models):
    cfg, jmodel, variables, jbatch, port, tbatch = t5_models
    enc, jm, kvs = _jax_encode(jmodel, variables, jbatch)
    with torch.no_grad():
        tenc, tjm = port.encode(**tbatch, ctx=CTX)
        consts = port.init_decode(tenc, CTX)
    assert tenc.shape == (B, L_TXT + N_BOX, 32)
    _close(tenc, enc)
    np.testing.assert_array_equal(tjm.numpy(), np.asarray(jm))
    for (tk, tv), (k, v) in zip(consts.cross_kvs, kvs):
        _close(tk, np.asarray(k).reshape(tk.shape))
        _close(tv, np.asarray(v).reshape(tv.shape))


def test_forward_logits(t5_models):
    """The teacher-forced deterministic forward: relative bias + causal in
    the decoder, cross-attention, the tied (rescaled) or untied head."""
    cfg, jmodel, variables, jbatch, port, tbatch = t5_models
    dec = np.random.default_rng(7).integers(
        2, cfg.backbone.vocab_size, (B, 5)).astype(np.int32)
    want = jmodel.apply(variables, **jbatch, decoder_input_ids=jnp.asarray(dec),
                        ctx=JCTX)["logits"]
    with torch.no_grad():
        got = port(**tbatch, decoder_input_ids=torch.from_numpy(dec).long(),
                   ctx=CTX)["logits"]
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("beams", [1, 3])
def test_first_decode_step_topk(t5_models, beams):
    cfg, jmodel, variables, jbatch, port, tbatch = t5_models
    enc, jm, kvs = _jax_encode(jmodel, variables, jbatch)
    n, max_len, k = B * beams, 8, 2 * beams
    start = cfg.backbone.decoder_start_token_id
    jcache = jgen.init_self_cache(cfg, n, max_len)
    janc = tanc = None
    if beams > 1:
        janc = jnp.broadcast_to(
            jnp.arange(beams, dtype=jnp.int32)[None, :, None],
            (B, beams, max_len))
        tanc = torch.from_numpy(np.array(janc)).long()
    want = jmodel.apply(variables, jnp.full((n, 1), start, jnp.int32), jm,
                        kvs, jcache, 0, k, JCTX, janc,
                        method=JVLT5.decode_step_topk)
    with torch.no_grad():
        tenc, tjm = port.encode(**tbatch, ctx=CTX)
        consts = port.init_decode(tenc, CTX)
        cache = tgen.init_self_cache(port.cfg, n, max_len, device="cpu")
        vals, toks, lse, cache = port.decode_step_topk(
            torch.full((n, 1), start), tjm, consts, cache, 0, k, CTX, tanc)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[1]))
    _close(vals, want[0])
    _close(lse, want[2])
    for tc, jc in zip(cache, want[3]):
        _close(tc["k"][:1], np.asarray(jc["k"])[:1])
        _close(tc["v"][:1], np.asarray(jc["v"])[:1])


@pytest.mark.parametrize("beams", [1, 3, 5])
def test_generate_token_parity(t5_models, beams):
    cfg, jmodel, variables, jbatch, port, tbatch = t5_models
    want = np.asarray(jgen.seq2seq_generate(jmodel, variables, **jbatch,
                                            ctx=JCTX, num_beams=beams,
                                            max_length=10))
    got = tgen.seq2seq_generate(port, **tbatch, ctx=CTX, num_beams=beams,
                                max_length=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] == 0).all()  # T5's start token is pad (0)
    # a degenerate decode (one token everywhere) would prove little
    assert len(np.unique(want[:, 1:])) > 2


def test_t5_training_and_unported_options_raise():
    """Every T5 option the port lacks raises; no call falls back to a plain
    path. A trainable relative_attention_bias trains: under unfreeze_bias
    the gradient of a training forward reaches the bias of both stacks.
    vis.sparse_sample trains (the visual tokens subsampled to n_boxes) and
    the classifier answer head builds and classifies."""
    cfg = _port_cfg(_jax_cfg(gated=False))
    model = VLT5(dataclasses.replace(cfg, pet=dataclasses.replace(
        cfg.pet, unfreeze_bias=True)), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    apply_freezing(model, model.cfg.pet)
    ids = torch.ones((1, 3), dtype=torch.long)
    out = model(ids, ids, decoder_input_ids=ids, deterministic=False)
    biases = [p for n, p in model.named_parameters()
              if n.endswith("relative_attention_bias")]
    assert len(biases) == 2
    grads = torch.autograd.grad(out["logits"].square().sum(), biases)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)
    sparse = VLT5(dataclasses.replace(cfg, vis=dataclasses.replace(
        cfg.vis, sparse_sample=True)), device="cpu")
    sparse.init_weights(torch.Generator().manual_seed(0))
    apply_freezing(sparse, sparse.cfg.pet)
    n_boxes = sparse.cfg.vis.n_boxes
    feats = torch.randn(1, n_boxes + 3, sparse.cfg.vis.feat_dim)
    out = sparse(ids, ids, feats, torch.rand(1, n_boxes + 3, 4), labels=ids,
                 deterministic=False, generator=torch.Generator())
    assert out["encoder_last_hidden_state"].shape[1] == 3 + n_boxes
    assert bool(torch.isfinite(out["loss"]).all())
    classifier = VLT5(dataclasses.replace(cfg, classifier=True,
                                          num_answers=5), device="cpu")
    classifier.init_weights(torch.Generator().manual_seed(0))
    assert classifier.classify(ids, ids).shape == (1, 5)
    for change in (dict(pet=dataclasses.replace(cfg.pet, use_attn_prefix=True,
                                                decoder_prompt_len=2)),
                   dict(pet=dataclasses.replace(cfg.pet,
                                                use_lm_head_adapter=True))):
        with pytest.raises(NotImplementedError):
            VLT5(dataclasses.replace(cfg, **change), device="cpu")


@pytest.mark.parametrize("gated", [False, True])
def test_t5_cfg_is_the_recipe(gated):
    """t5_cfg: T5Config() (or the t5-v1.1-base dimensions) + the flags of
    scripts/image-text/T5-VL-PET-large.sh, field for field as the JAX
    package builds them."""
    backbone = (T5Config(d_ff=2048, feed_forward_proj="gated-gelu",
                         vocab_size=32128, tie_word_embeddings=False)
                if gated else T5Config())
    want = VLModelConfig(backbone=backbone,
                         vis=VisConfig(feat_dim=2048, n_boxes=36),
                         pet=vlpet_recipe("large", r=192, num_heads=4,
                                          gate_dim=192, tasks=TASKS,
                                          t5=True), dtype="bfloat16")
    got = pc.t5_cfg("bfloat16", gated=gated)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_t5 and got.pet.encoder_gating_scaling_factor == 0.3
