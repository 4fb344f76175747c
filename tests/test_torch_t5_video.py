"""T5 at the video shape and T5 with a trainable relative bias: the port
against the JAX package, on CPU.

The JAX kernels run in interpret mode; the port's wrappers take their plain
twins (the tensors lie on the CPU). Inputs come from seeded numpy. Checked:

* the long backward's new modes against the per-head and query-strip
  Pallas backwards (_pallas_attention_perhead_bwd, the A3 kernel, and
  _pallas_attention_ltiled_bwd, A5): the relative bias and the probability
  dropout, over several batches and row blocks (block_l 8), so that a mask
  keyed on a block's own row index would fail; A1's output and row
  logsumexp with the same terms;
* dbias, the bias's cotangent summed over the batch: autograd of
  fused_attention and A6's wrapper against _pallas_attention_bwd(...,
  bias_grad=True) over a batch the TPU kernel splits into two programs,
  and the long backward's twin against _pallas_attention_perhead_bwd(...,
  bias_grad=True);
* a tiny T5 shaped like the video model (12 text tokens + 8 frames with
  zero boxes): a 3-step train lockstep against the JAX make_train_step;
* unfreeze_language_model, unfreeze_bias (BitFit) and
  unfreeze_encoder_bias: the trainable set by name against the JAX
  freezing engine, and a 3-step lockstep whose checked parameters include
  the updated relative_attention_bias (only the encoder's under
  unfreeze_encoder_bias);
* config.t5_video_cfg against the JAX variant's configuration.

fp32; ops within 1e-5 * (1 + max|jax|). The lockstep runs at dropout 0.0,
as tests/test_torch_t5_train.py explains, with its tolerances: loss and
gradient norm within 1e-5 relative, trainable parameters within rtol 1e-3,
atol 1e-5 * max|p|, frozen parameters unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.models.t5 import VLT5 as JVLT5
from vlpet_tpu.ops import attention as jatt
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5
RATE = 0.1
SEED = np.array([1357911], np.int32)
H, Dh, BLOCK_L = 2, 16, 8

# L, S, causal, bias: the T5 video encoder (ragged padding, the relative
# bias), the cross-attention (10 queries over the joint sequence, no bias)
# and a causal case with past offset S - L
LONG_CASES = {"enc": (40, 40, False, True), "cross": (10, 72, False, False),
              "causal": (36, 44, True, True)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    want = np.asarray(want)
    tol = TOL * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=tol, err_msg=msg)


def _attn_inputs(B, L, S, has_bias, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.2
    keep[-1, ..., S - 5:] = False
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    bias = (rng.normal(size=(1, H, L, S)).astype(np.float32)
            if has_bias else None)
    return q, k, v, mask, do, bias


def _jax_long(family):
    if family == "perhead":
        return (lambda *a: jatt._pallas_attention_perhead(*a, interpret=True),
                lambda *a, **kw: jatt._pallas_attention_perhead_bwd(
                    *a, **kw, interpret=True))
    return (lambda *a: jatt._pallas_attention_ltiled(
        *a, block_l=BLOCK_L, interpret=True),
        lambda *a: jatt._pallas_attention_ltiled_bwd(
            *a, block_l=BLOCK_L, interpret=True))


def _port_long(q, k, v, mask, do, bias, causal, bias_grad=False):
    """The port's long route on CPU: the forward's twin (dropped output,
    row logsumexp) and the long backward's twin."""
    tb = None if bias is None else _t(bias)
    out, lse = tatt.fused_attention_fwd_lse(_t(q), _t(k), _t(v), _t(mask), H,
                                            causal, tb, RATE, _t(SEED))
    grads = tatt.fused_attention_bwd_long(_t(q), _t(k), _t(v), _t(mask), out,
                                          lse, _t(do), H, causal, tb, RATE,
                                          _t(SEED), bias_grad)
    return out, grads


@pytest.mark.parametrize("family", ["perhead", "ltiled"])
@pytest.mark.parametrize("case", list(LONG_CASES))
def test_long_backward_bias_dropout_matches_pallas(case, family):
    """A3 / A5 with the bias and rate 0.1 over 3 batches and 5 row blocks
    of 8: the forward's output and every gradient of the long backward's
    twin, and autograd of fused_attention (the reference), agree."""
    L, S, causal, has_bias = LONG_CASES[case]
    q, k, v, mask, do, bias = _attn_inputs(3, L, S, has_bias, L * 100 + S)
    fwd, bwd = _jax_long(family)
    j = list(map(jnp.asarray, (q, k, v, mask)))
    jb = None if bias is None else jnp.asarray(bias)
    jseed = jnp.asarray(SEED)
    want = np.asarray(fwd(*j, H, causal, jb, RATE, jseed))
    assert not np.allclose(want, np.asarray(fwd(*j, H, causal, jb)))
    wgrads = bwd(*j, jnp.asarray(do), H, causal, jb, RATE, jseed)

    out, grads = _port_long(q, k, v, mask, do, bias, causal)
    _close(out, want, "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
        _close(g, w, name + " (long backward)")
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tatt.fused_attention(*leaves, _t(mask), H, causal,
                               None if bias is None else _t(bias), RATE,
                               _t(SEED))
    for name, g, w in zip(("dq", "dk", "dv"),
                          torch.autograd.grad(got, leaves, _t(do)), wgrads):
        _close(g, w, name + " (autograd)")


@pytest.mark.parametrize("case", ["enc", "causal"])
def test_long_backward_dbias_matches_pallas_perhead(case):
    """A3's bias_grad mode: dbias[h] = sum_b ds[b, h], the twin against
    _pallas_attention_perhead_bwd(..., bias_grad=True), with dropout."""
    L, S, causal, _ = LONG_CASES[case]
    q, k, v, mask, do, bias = _attn_inputs(3, L, S, True, L * 7 + S)
    _, bwd = _jax_long("perhead")
    wgrads = bwd(*map(jnp.asarray, (q, k, v, mask, do)), H, causal,
                 jnp.asarray(bias), RATE, jnp.asarray(SEED), bias_grad=True)
    _, grads = _port_long(q, k, v, mask, do, bias, causal, bias_grad=True)
    assert len(grads) == len(wgrads) == 4
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        _close(g, w, name)
    assert grads[3].shape == (1, H, L, S) and grads[3].dtype == torch.float32


# L, S, causal: the T5 encoder self-attention and the decoder's causal one
A6_SITES = {"enc_self": (7, 7, False), "dec_self": (5, 5, True)}


@pytest.mark.parametrize("site", list(A6_SITES))
def test_a6_dbias_matches_pallas(site):
    """A6's bias_grad mode at rate 0.1 over a batch of 12 (two programs of
    the TPU kernel, which accumulate dbias across its sequential grid):
    autograd of fused_attention with a bias that requires a gradient, and
    fused_attention_bwd(..., bias_grad=True), against the Pallas kernel."""
    L, S, causal = A6_SITES[site]
    q, k, v, mask, do, bias = _attn_inputs(12, L, S, True, L * 13 + S)
    wgrads = jatt._pallas_attention_bwd(
        *map(jnp.asarray, (q, k, v, mask, do)), H, causal, jnp.asarray(bias),
        RATE, jnp.asarray(SEED), bias_grad=True, interpret=True)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = tatt.fused_attention(*leaves[:3], _t(mask), H, causal, leaves[3],
                               RATE, _t(SEED))
    ggrads = torch.autograd.grad(out, leaves, _t(do))
    bwd = tatt.fused_attention_bwd(_t(q), _t(k), _t(v), _t(mask), _t(do), H,
                                   causal, _t(bias), RATE, _t(SEED), True)
    for name, g, b, w in zip(("dq", "dk", "dv", "dbias"), ggrads, bwd,
                             wgrads):
        _close(g, w, name + " (autograd)")
        _close(b, w, name + " (bwd wrapper)")


# --- whole models --------------------------------------------------------

TASKS = ("vqa", "gqa", "nlvr", "caption")
K = 3
B, L_TGT = 4, 4
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
VIDEO = dict(text=12, frames=8, feat=16)
IMAGE = dict(text=6, frames=4, feat=16)
BIAS_FLAGS = ("unfreeze_language_model", "unfreeze_bias",
              "unfreeze_encoder_bias")


def _jax_cfg(shape, flag=None) -> VLModelConfig:
    pet = vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS,
                       t5=True)
    if flag is not None:
        pet = dataclasses.replace(pet, **{flag: True})
    return VLModelConfig(
        backbone=T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_decoder_layers=2, num_heads=4,
                          dropout_rate=0.0),
        vis=VisConfig(feat_dim=shape["feat"], n_boxes=shape["frames"]),
        pet=pet)


def _port_cfg(jcfg) -> pc.VLModelConfig:
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.T5Config(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _batch(rng, shape, V, video):
    n, frames = shape["text"], shape["frames"]
    mask = np.ones((B, n), np.int32)
    mask[1, n - 3:] = 0
    targets = rng.integers(2, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100  # padded labels
    boxes = (np.zeros((B, frames, 4), np.float32) if video
             else rng.uniform(size=(B, frames, 4)).astype(np.float32))
    return dict(input_ids=rng.integers(2, V, (B, n)).astype(np.int32),
                attention_mask=mask,
                vis_feats=rng.normal(size=(B, frames, shape["feat"]))
                .astype(np.float32),
                boxes=boxes, target_ids=targets,
                scores=rng.uniform(0.3, 1.0, B).astype(np.float32))


def _spread(params, rng):
    """Every leaf at a seeded scale where the zero-init ups, the adapters
    and the gates all contribute: norm scales 1 + N(0, 0.1), everything
    else N(0, 0.2)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), params)


def _lockstep(jcfg, shape, video):
    """3 steps of vqa through the JAX and the port's make_train_step from
    the same weights; returns the port's trainable names."""
    rng = np.random.default_rng(0)
    batch = _batch(rng, shape, jcfg.backbone.vocab_size, video)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLT5(jcfg)
    params = _spread(jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jbatch["input_ids"], jbatch["attention_mask"],
        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
        labels=jbatch["target_ids"], ctx=JCtx())["params"]), rng)
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, TASKS)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    want_losses, want_norms = [], []
    for _ in range(K):
        state, metrics = jstep(state, frozen, jbatch, jax.random.PRNGKey(0),
                               0)
        want_losses.append(float(metrics["loss"]))
        want_norms.append(float(metrics["grad_norm"]))
    want_params = flax_to_state_dict(jax.device_get(state.params))

    model = load_flax_params(VLT5(_port_cfg(jcfg), device="cpu"), params)
    trainable = apply_freezing(model, model.cfg.pet)
    assert set(trainable) == set(want_params)
    frozen_before = {n: p.detach().clone()
                     for n, p in model.named_parameters()
                     if n not in trainable}
    step = make_train_step(model, build_optimizer(trainable, **OPT), TASKS,
                           device="cpu")
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    generator = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(K):
        out = step(tbatch, generator, 0)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for name, p in trainable.items():
        want = want_params[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(want).max()), err_msg=name)
    for name, p in model.named_parameters():
        if name in frozen_before:
            assert torch.equal(p, frozen_before[name]), name
    return set(trainable)


def test_t5_video_shape_lockstep_with_jax():
    """The video model's shape at tiny width: 12 text tokens + 8 frames of
    16-d features with zero boxes (a joint sequence of 20), relu/tied,
    3 steps of vqa against the JAX make_train_step."""
    got = _lockstep(_jax_cfg(VIDEO), VIDEO, video=True)
    assert not any("relative_attention_bias" in n for n in got)


def _bias_names(names):
    return {n for n in names if n.endswith("relative_attention_bias")}


@pytest.mark.parametrize("flag", BIAS_FLAGS)
def test_bias_flags_lockstep_with_jax(flag):
    """3 steps of vqa with the relative bias trainable, against the JAX
    make_train_step: the checked parameters include each trained
    relative_attention_bias (the encoder's only, under
    unfreeze_encoder_bias, whose decoder sites then compute no dbias)."""
    got = _lockstep(_jax_cfg(IMAGE, flag), IMAGE, video=False)
    enc = "model.encoder.blocks_0.self_attn.relative_attention_bias"
    dec = "model.decoder.blocks_0.self_attn.relative_attention_bias"
    want = {enc} if flag == "unfreeze_encoder_bias" else {enc, dec}
    assert _bias_names(got) == want


@pytest.mark.parametrize("flag", BIAS_FLAGS)
def test_bias_flags_trainable_set_matches_jax(flag):
    """By name, on the tiny model: the port's apply_freezing selects what
    the JAX trainable_mask selects under each flag whose "bias" rule
    matches relative_attention_bias."""
    jcfg = _jax_cfg(IMAGE, flag)
    jmodel = JVLT5(jcfg)
    kw = dict(vis_feats=jnp.zeros((1, IMAGE["frames"], IMAGE["feat"])),
              boxes=jnp.zeros((1, IMAGE["frames"], 4)),
              labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx())
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 3), jnp.int32),
        jnp.ones((1, 3), jnp.int32), **kw))["params"]
    want = set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, m: np.zeros(p.shape, np.float32) if m else None, params,
        trainable_mask(params, jcfg.pet))))
    model = VLT5(_port_cfg(jcfg), device="meta")
    got = set(apply_freezing(model, model.cfg.pet))
    assert got == want
    assert _bias_names(got)
    if flag == "unfreeze_language_model":
        assert got == {n for n, _ in model.named_parameters()}


def test_t5_video_cfg_is_the_variant():
    """t5_video_cfg: scripts/bench_step_variants.py's t5_video_base, i.e.
    __graft_entry__._flagship_t5_cfg() with 64 frames of 512-d features,
    field for field; the one difference is t5_cfg's t5=True."""
    from __graft_entry__ import _flagship_t5_cfg

    jcfg, tasks = _flagship_t5_cfg()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16", vis=dataclasses.replace(
        jcfg.vis, feat_dim=512, n_boxes=64))
    got = pc.t5_video_cfg("bfloat16")
    t5_pet = vlpet_recipe("large", r=192, num_heads=4, gate_dim=192,
                          tasks=tasks, t5=True)
    want = dataclasses.asdict(dataclasses.replace(jcfg, pet=t5_pet))
    assert dataclasses.asdict(got) == want
    differ = {k for k, v in dataclasses.asdict(jcfg.pet).items()
              if want["pet"][k] != v}
    assert differ == {"use_encoder_multihead_up_zero_init",
                      "use_encoder_gating_large_x_lowrank_up_zero_init",
                      "use_decoder_enc_vpa_up_zero_init",
                      "use_encoder_gating_scaling",
                      "encoder_gating_scaling_factor"}
    assert got.is_t5 and not got.backbone.feed_forward_proj.startswith(
        "gated") and got.backbone.tie_word_embeddings
    assert (got.vis.feat_dim, got.vis.n_boxes) == (512, 64)
