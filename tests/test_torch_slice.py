"""The ported decode slice as a whole against the JAX package: the tiny
flagship configuration (BART + VL-PET-large, __graft_entry__._flagship_cfg
(tiny=True)), fp32 on CPU. JAX VLBart params -> vlpet_tpu_torch.convert ->
the port; encode output and cross K/V within 1e-5, the first decode step's
top-k indices equal (values and logsumexp within 1e-5), and whole
generations token for token (greedy, beam 3, beam 5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.pet.modules import PetContext

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5
B, L_TXT = 3, 6
CAPTION = 3  # task index of "caption" in the flagship task tuple


def _port_cfg(jcfg):
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.BartConfig(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


@pytest.fixture(scope="module")
def slice_models():
    cfg, tasks = _flagship_cfg(tiny=True)
    assert tasks[CAPTION] == "caption"
    rng = np.random.default_rng(0)
    V, nb, fd = cfg.backbone.vocab_size, cfg.vis.n_boxes, cfg.vis.feat_dim
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, 4:] = 0
    batch = dict(input_ids=rng.integers(3, V, (B, L_TXT)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B, nb, fd)).astype(np.float32),
                 boxes=rng.uniform(size=(B, nb, 4)).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLBart(cfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), **jbatch,
        labels=jnp.ones((B, 3), jnp.int32))["params"])
    # seeded random weights of a larger scale than the init: a model at the
    # 0.02 init decodes the same token everywhere, which would prove little
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), params)
    port = load_flax_params(VLBart(_port_cfg(cfg), device="cpu"), params)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    return cfg, jmodel, {"params": params}, jbatch, port, tbatch


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _jax_encode(jmodel, variables, jbatch, ctx):
    enc, jm = jmodel.apply(variables, jbatch["input_ids"],
                           jbatch["attention_mask"], jbatch["vis_feats"],
                           jbatch["boxes"], None, None, None, ctx,
                           method=JVLBart.encode)
    kvs = jmodel.apply(variables, enc, ctx, method=JVLBart.init_decode)
    return enc, jm, kvs


def test_encode_and_cross_kv(slice_models):
    cfg, jmodel, variables, jbatch, port, tbatch = slice_models
    enc, jm, kvs = _jax_encode(jmodel, variables, jbatch,
                               JCtx(task="caption", task_idx=CAPTION))
    ctx = PetContext(task="caption", task_idx=CAPTION)
    with torch.no_grad():
        tenc, tjm = port.encode(**tbatch, ctx=ctx)
        tkvs = port.init_decode(tenc, ctx)
    _close(tenc, enc)
    np.testing.assert_array_equal(tjm.numpy(), np.asarray(jm))
    for (tk, tv), (k, v) in zip(tkvs.cross_kvs, kvs):
        _close(tk, np.asarray(k).reshape(tk.shape))
        _close(tv, np.asarray(v).reshape(tv.shape))


@pytest.mark.parametrize("beams", [1, 3])
def test_first_decode_step_topk(slice_models, beams):
    cfg, jmodel, variables, jbatch, port, tbatch = slice_models
    jctx = JCtx(task="caption", task_idx=CAPTION)
    ctx = PetContext(task="caption", task_idx=CAPTION)
    enc, jm, kvs = _jax_encode(jmodel, variables, jbatch, jctx)
    n, max_len, k = B * beams, 8, 2 * beams
    start = cfg.backbone.decoder_start_token_id
    jcache = jgen.init_self_cache(cfg, n, max_len)
    janc = tanc = None
    if beams > 1:
        janc = jnp.broadcast_to(jnp.arange(beams, dtype=jnp.int32)[None, :, None],
                                (B, beams, max_len))
        tanc = torch.from_numpy(np.array(janc)).long()
    want = jmodel.apply(variables, jnp.full((n, 1), start, jnp.int32), jm, kvs,
                        jcache, 0, k, jctx, janc,
                        method=JVLBart.decode_step_topk)
    with torch.no_grad():
        tenc, tjm = port.encode(**tbatch, ctx=ctx)
        tkvs = port.init_decode(tenc, ctx)
        cache = tgen.init_self_cache(port.cfg, n, max_len, device="cpu")
        vals, toks, lse, cache = port.decode_step_topk(
            torch.full((n, 1), start), tjm, tkvs, cache, 0, k, ctx, tanc)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[1]))
    _close(vals, want[0])
    _close(lse, want[2])
    # the step wrote its K/V into slot 0 of every layer's cache
    for tc, jc in zip(cache, want[3]):
        _close(tc["k"][:1], np.asarray(jc["k"])[:1])


@pytest.mark.parametrize("beams", [1, 3, 5])
def test_generate_token_parity(slice_models, beams):
    cfg, jmodel, variables, jbatch, port, tbatch = slice_models
    want = jgen.seq2seq_generate(jmodel, variables, **jbatch,
                                 ctx=JCtx(task="caption", task_idx=CAPTION),
                                 num_beams=beams, max_length=10)
    got = tgen.seq2seq_generate(port, **tbatch,
                                ctx=PetContext(task="caption",
                                               task_idx=CAPTION),
                                num_beams=beams, max_length=10)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    # a degenerate decode (one token everywhere) would prove little
    assert len(np.unique(want[:, 1:])) > 2
