"""The last single-card paths of the port against the JAX package, on CPU:
BART's attention and activation dropout, ``vis.sparse_sample``, per-layer
remat and the profiling helpers. fp32, tolerance 1e-5 * (1 + max|jax|)
unless a test states another.

* Dropout at BART's sites, op by op (the JAX BART draws its model-level
  masks with jax.random off the TPU, so the models are compared at rate
  0): A1 and A6 at rate 0.1 with one seed at the encoder, causal decoder,
  cross and one-token classify decoder shapes against the Pallas kernels
  in interpret mode; F1 / F2 gelu with hidden dropout against the jax.vjp
  of fused_ffn in interpret mode; ``dropout_sites`` counts what a training
  step consumes, under LoRA too.
* ``sparse_sample`` given the JAX function's scores; the BART and T5
  training paths given the same indices (the JAX function monkeypatched to
  the test's scores, the port's ``sparse_scores`` to the same).
* ``remat`` "full" and "dots" against "none" at dropout 0.1 (loss and
  every gradient equal: the replay takes the same seeds), and against the
  JAX remat loss on tests/test_remat.py's configuration at dropout 0;
  generation through the remat'd decoder unchanged.
* ``utils.profiling``: StepTimer, trace and device_sync on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import BartConfig, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import bart as tbart
from vlpet_tpu_torch.models import vlbart as tvlbart
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.visual import sparse_sample
from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.utils import profiling

from test_torch_gates import port_cfg

torch.set_num_threads(2)  # several xdist workers share the host

RATE = 0.1
SEED = np.array([13572468], np.int32)
TASKS = ("vqa", "caption")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(want).max()),
                               err_msg=msg)


# --- dropout at BART's sites, op by op --------------------------------------

# L, S, causal: the encoder's self-attention (ragged padding), the
# decoder's causal self-attention, its cross-attention, and the classify
# decoder's one token over the encoder states and over itself
SITES = {"enc_self": (9, 9, False), "dec_self": (5, 5, True),
         "cross": (5, 9, False), "classify_cross": (1, 9, False),
         "classify_self": (1, 1, True)}


@pytest.mark.parametrize("site", list(SITES))
def test_attention_dropout_at_bart_sites_match_pallas_interpret(site):
    from vlpet_tpu.ops.attention import (_pallas_attention,
                                         _pallas_attention_bwd)

    L, S, causal = SITES[site]
    rng = np.random.default_rng(L * 10 + S)
    B, H, Dh = 16, 4, 8
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.3
    keep[..., 0] = True
    mask = (np.zeros((1, 1, 1, S), np.float32) if causal
            else np.where(keep, 0.0, -1e9).astype(np.float32))
    jargs = list(map(jnp.asarray, (q, k, v, mask)))
    jseed = jnp.asarray(SEED)
    want = _pallas_attention(*jargs, H, causal, None, RATE, jseed,
                             interpret=True)
    wgrads = _pallas_attention_bwd(*jargs, jnp.asarray(do), H, causal, None,
                                   RATE, jseed, interpret=True)
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tatt.fused_attention(*args, _t(mask), H, causal, None, RATE,
                               _t(SEED))
    _close(got, want)
    for name, g, w in zip(("dq", "dk", "dv"),
                          torch.autograd.grad(got, args, _t(do)), wgrads):
        _close(g, w, msg=name)
    if S > 1:  # dropped: not the rate-0 output
        assert not np.allclose(np.asarray(want), np.asarray(
            _pallas_attention(*jargs, H, causal, interpret=True)))


def test_gelu_ffn_hidden_dropout_matches_jax_interpret(monkeypatch):
    """F1 / F2 gelu (BART's FFN) at rate 0.1 with both biases, N 37 over
    row tiles of 16: y, dx, db1, db2."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    rng = np.random.default_rng(5)
    N, D, F = 37, 32, 64
    x, dy = (rng.normal(size=(N, D)).astype(np.float32) for _ in range(2))
    w1 = rng.normal(size=(D, F)).astype(np.float32) * D ** -0.5
    w2 = rng.normal(size=(F, D)).astype(np.float32) * F ** -0.5
    b1 = rng.normal(size=(F,)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.2
    seed = jnp.asarray(SEED)
    want, vjp = jax.vjp(lambda a, c, e: jffn.fused_ffn(
        a, jnp.asarray(w1), c, jnp.asarray(w2), e, "gelu", RATE, seed),
        *map(jnp.asarray, (x, b1, b2)))
    wgrads = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_() for a in (x, b1, b2)]
    y = tffn.fused_ffn(args[0], _t(w1.T), args[1], _t(w2.T), args[2], "gelu",
                       RATE, _t(SEED))
    _close(y, want)
    for name, g, w in zip(("dx", "db1", "db2"),
                          torch.autograd.grad(y, args, _t(dy)), wgrads):
        _close(g, w, msg=name)


def _tiny_cfg(**backbone):
    """tests/test_remat.py's configuration (BART d 32, 2+2 layers,
    VL-PET-large r 8), the backbone's fields replaced by ``backbone``."""
    pet = vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS)
    return VLModelConfig(
        backbone=BartConfig(vocab_size=128, d_model=32, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=64,
                            **backbone),
        vis=VisConfig(feat_dim=16, n_boxes=4), pet=pet)


def _batch(B=2, boxes=4):
    rng = np.random.default_rng(0)
    return dict(
        input_ids=rng.integers(3, 128, (B, 6)).astype(np.int32),
        attention_mask=np.ones((B, 6), np.int32),
        vis_feats=rng.normal(size=(B, boxes, 16)).astype(np.float32),
        boxes=rng.uniform(size=(B, boxes, 4)).astype(np.float32),
        target_ids=rng.integers(3, 128, (B, 5)).astype(np.int32))


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


class _Counted(tvlbart.DropoutSeeds):
    """DropoutSeeds that remember each step's draw."""
    drawn = []

    def __init__(self, n, generator, device):
        super().__init__(n, generator, device)
        _Counted.drawn.append(self)


@pytest.mark.parametrize("flags", [
    dict(dropout=0.1),
    dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1),
    dict(dropout=0.0, attention_dropout=0.1),
    dict(dropout=0.0, activation_dropout=0.1, lora=True),
    dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
         ia3=True)])
def test_dropout_sites_count_what_a_step_consumes(flags, monkeypatch):
    flags = dict(flags)
    lora, ia3 = flags.pop("lora", False), flags.pop("ia3", False)
    cfg = port_cfg(_tiny_cfg(**flags))
    if lora:
        cfg = dataclasses.replace(cfg, pet=dataclasses.replace(
            cfg.pet, use_lora=True))
    if ia3:  # the decoder FFN's IA3: the plain chain drops the hidden
        cfg = dataclasses.replace(cfg, pet=dataclasses.replace(
            cfg.pet, use_decoder_ff_ia3=True))
    b = cfg.backbone
    per_attn = (1 + (b.attention_dropout > 0)
                + 2 * (lora and cfg.pet.lora_spec().lora_dropout > 0))
    want = (2 + b.encoder_layers * (per_attn + 1 + (b.activation_dropout > 0))
            + b.decoder_layers * (2 * per_attn + 1
                                  + (b.activation_dropout > 0)))
    model = tvlbart.VLBart(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert model.dropout_sites() == want
    apply_freezing(model, cfg.pet)
    monkeypatch.setattr(tvlbart, "DropoutSeeds", _Counted)
    _Counted.drawn.clear()
    t = _torch_batch(_batch())
    outs = [model(t["input_ids"], t["attention_mask"], t["vis_feats"],
                  t["boxes"], labels=t["target_ids"], deterministic=False,
                  generator=torch.Generator().manual_seed(s))["loss"]
            for s in (1, 2)]
    assert [d.used for d in _Counted.drawn] == [want, want]
    assert not torch.equal(outs[0], outs[1])  # other seeds, other masks


# --- sparse_sample ----------------------------------------------------------

def test_sparse_sample_given_the_jax_scores():
    from vlpet_tpu.models.visual import sparse_sample as jsparse

    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 10, 5)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jsparse(jnp.asarray(feats), 4, key)
    scores = jax.random.uniform(key, (3, 10))  # the JAX function's draw
    got = sparse_sample(_t(feats), 4, _t(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # kept in their order, 4 distinct rows of each example
    for row, src in zip(got.numpy(), feats):
        idx = [int(np.flatnonzero((src == r).all(1))[0]) for r in row]
        assert idx == sorted(set(idx)) and len(idx) == 4


@pytest.mark.parametrize("backbone", ["bart", "t5"])
def test_sparse_sample_training_path_matches_jax(backbone, monkeypatch):
    """A training forward at dropout 0 with 7 visual tokens subsampled to
    n_boxes 4, both packages handed the same scores."""
    import vlpet_tpu.models.visual as jvis
    from vlpet_tpu.config import T5Config
    from vlpet_tpu_torch.models import t5 as tt5

    jcfg = _tiny_cfg(dropout=0.0)
    if backbone == "t5":
        jcfg = dataclasses.replace(jcfg, backbone=T5Config(
            vocab_size=128, d_model=32, num_layers=2, num_decoder_layers=2,
            num_heads=4, d_kv=8, d_ff=64, dropout_rate=0.0))
    jcfg = dataclasses.replace(jcfg, vis=dataclasses.replace(
        jcfg.vis, sparse_sample=True))
    b = _batch(boxes=7)
    scores = np.random.default_rng(9).uniform(size=(2, 7)).astype(np.float32)
    orig = jvis.sparse_sample
    monkeypatch.setattr(jvis, "sparse_sample", lambda f, n, rng: orig(
        f, n, None) if rng is None else _jax_sparse(f, n, scores))
    for mod in (tbart, tt5):
        monkeypatch.setattr(mod, "sparse_scores",
                            lambda shape, g, device: _t(scores))
    if backbone == "t5":
        from vlpet_tpu.models.t5 import VLT5 as J
        model = tt5.VLT5(port_cfg(jcfg), device="cpu")
    else:
        from vlpet_tpu.models.vlbart import VLBart as J
        model = tvlbart.VLBart(port_cfg(jcfg), device="cpu")
    jm = J(jcfg)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    kw = dict(vis_feats=j["vis_feats"], boxes=j["boxes"],
              labels=j["target_ids"], ctx=JCtx())
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), j["input_ids"], j["attention_mask"],
        **kw)["params"])
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(s.dtype), shapes)
    load_flax_params(model, params)
    apply_freezing(model, model.cfg.pet)
    want = jax.jit(lambda p: jm.apply(
        {"params": p}, j["input_ids"], j["attention_mask"], **kw,
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)}))(params)
    t = _torch_batch(b)
    got = model(t["input_ids"], t["attention_mask"], t["vis_feats"],
                t["boxes"], labels=t["target_ids"], ctx=PetContext(),
                deterministic=False, generator=torch.Generator())
    assert got["encoder_last_hidden_state"].shape[1] == 6 + 4
    _close(got["encoder_last_hidden_state"],
           want["encoder_last_hidden_state"])
    _close(got["loss"], want["loss"])


def _jax_sparse(feats, out_len, scores):
    idx = jnp.sort(jnp.argsort(jnp.asarray(scores), axis=-1)[:, :out_len],
                   axis=-1)
    return jnp.take_along_axis(feats, idx[..., None], axis=1)


# --- remat ------------------------------------------------------------------

def _loss_and_grads(cfg, params, b, remat):
    model = tvlbart.VLBart(dataclasses.replace(cfg, remat=remat),
                           device="cpu")
    load_flax_params(model, params)
    trainable = apply_freezing(model, model.cfg.pet)
    t = _torch_batch(b)
    loss = model(t["input_ids"], t["attention_mask"], t["vis_feats"],
                 t["boxes"], labels=t["target_ids"], deterministic=False,
                 generator=torch.Generator().manual_seed(4))["loss"].mean()
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss, grads, model


@pytest.fixture(scope="module")
def remat_params():
    from vlpet_tpu.models.vlbart import VLBart as J

    jcfg = _tiny_cfg(dropout=0.0)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    return jax.device_get(jax.jit(lambda: J(jcfg).init(
        jax.random.PRNGKey(0), b["input_ids"], b["attention_mask"],
        vis_feats=b["vis_feats"], boxes=b["boxes"], labels=b["target_ids"],
        ctx=JCtx())["params"])())


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_matches_no_remat_and_jax(mode, remat_params):
    from vlpet_tpu.models.vlbart import VLBart as J

    b = _batch()
    # the port, at dropout 0.1 on every site: the replay takes the seeds
    # of the first run, so loss and gradients are those of "none"
    drop = port_cfg(_tiny_cfg(dropout=0.1, attention_dropout=0.1,
                              activation_dropout=0.1))
    ref_loss, ref_grads, _ = _loss_and_grads(drop, remat_params, b, "none")
    loss, grads, _ = _loss_and_grads(drop, remat_params, b, mode)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # against the JAX remat'd step (tests/test_remat.py) at dropout 0
    jcfg = dataclasses.replace(_tiny_cfg(dropout=0.0), remat=mode)
    jm = J(jcfg)
    j = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        return jm.apply({"params": p}, j["input_ids"], j["attention_mask"],
                        vis_feats=j["vis_feats"], boxes=j["boxes"],
                        labels=j["target_ids"], ctx=JCtx(),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})["loss"].mean()

    want = float(jax.jit(loss_fn)(remat_params))
    got, grads, model = _loss_and_grads(port_cfg(jcfg), remat_params, b,
                                        mode)
    assert abs(float(got.detach()) - want) <= 1e-5 * (1.0 + abs(want))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # generation goes through the decoder's incremental path unchanged
    t = _torch_batch(b)
    kw = dict(input_ids=t["input_ids"], attention_mask=t["attention_mask"],
              vis_feats=t["vis_feats"], boxes=t["boxes"], ctx=PetContext(),
              max_length=5, num_beams=2)
    _, _, plain = _loss_and_grads(port_cfg(jcfg), remat_params, b, "none")
    with torch.no_grad():
        assert torch.equal(seq2seq_generate(model, **kw),
                           seq2seq_generate(plain, **kw))


# --- profiling --------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path):
    x = torch.arange(6.0).reshape(2, 3) + 1.0
    assert profiling.device_sync({"a": [x]}) == 1.0
    assert profiling.device_sync(None) == 0.0
    timer = profiling.StepTimer(torch.device("cpu"))
    assert not timer.cuda
    for _ in range(3):
        (x @ x.t()).sum()
        timer.step(8)
    assert timer.steps == 3 and timer.examples == 24
    rate = timer.rate(x)
    assert rate > 0 and np.isfinite(rate)
    timer.reset()
    assert timer.examples == 0 and timer.seconds() >= 0.0
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.nn.functional.gelu(x @ x.t())
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("gelu" in str(e.get("name", "")) for e in events)
