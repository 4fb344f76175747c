"""The fused beam step (D2) and the cache slot write (U1) of the port
against the JAX package, on CPU.

* U1, ``ops.cache_update.cache_slot_update`` on CPU tensors (its plain
  twin), against ``jax.lax.dynamic_update_slice``: U1's pallas_call has no
  interpret switch, and its docstring defines it as this write. The written
  slot and every other slot bit for bit, and the result is the input
  tensor, updated in place; also the decode's time-major cache as the
  N = 1 case.
* D2, ``ops.decode.beam_decode_attend_update`` on CPU tensors, against
  vlpet_tpu.ops.decode.beam_decode_attend_update with its Pallas kernel in
  interpret mode (as tests/test_ops.py runs it): B 8, K 3 and 5, H 2, Dh 8,
  L 6, pos 0, 3 and L - 1, with and without T5's bias row (and the
  distance-0 own bias). The output and both caches within 2e-5, the JAX
  test's own tolerance; the output also equals the two-step path (U1, then
  D1's plain twin over slots l <= pos).
* The decode paths with ``use_fused_beam``: the tiny BART
  (tests/test_torch_slice.py) and the tiny T5 relu/tied
  (tests/test_torch_t5.py), beam 5 and greedy to length 10, tokens
  identical to the JAX model's (which on the CPU takes its dus +
  beam_decode_attend path, the same function) and to the port without the
  flag. Every beam step's self-attention goes through D2 and no other
  decode-step slot write happens there; greedy steps write through U1, K
  and V in one call a layer and step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.ops.decode as jdecode
from __graft_entry__ import _flagship_cfg
from test_torch_slice import _port_cfg as _bart_port_cfg
from test_torch_t5 import _jax_cfg as _t5_jax_cfg
from test_torch_t5 import _port_cfg as _t5_port_cfg
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.models.t5 import VLT5 as JVLT5
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import bart as tbart
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.models import t5 as tt5
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import cache_update, decode
from vlpet_tpu_torch.pet.modules import PetContext

torch.set_num_threads(2)  # several xdist workers share the host

CAPTION = 3
B_GEN, L_TXT = 3, 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5])
def test_cache_slot_update_is_dynamic_update_slice(dtype, pos):
    rng = np.random.default_rng(pos)
    tdt = getattr(torch, dtype)
    for shape in ((3, 6, 2, 8), (1, 6, 4, 16)):  # (N, L, H, Dh); time-major
        N, L = shape[:2]
        cache = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        cache = cache.to(tdt)
        new = torch.from_numpy(rng.normal(size=(N,) + shape[2:])
                               .astype(np.float32))
        want = jax.lax.dynamic_update_slice(
            jnp.asarray(cache.float().numpy(), dtype),
            jnp.asarray(new.numpy(), dtype)[:, None], (0, pos, 0, 0))
        before = cache.clone()
        got = cache_update.cache_slot_update(cache, new, pos)
        assert got is cache
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        assert torch.equal(got[:, pos], new.to(tdt))
        others = [t for t in range(L) if t != pos]
        assert torch.equal(got[:, others], before[:, others])


def _d2_inputs(K: int, pos: int, bias: bool):
    rng = np.random.default_rng(5 + K + pos)
    B, H, Dh, L = 8, 2, 8, 6
    mk = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    anc = rng.integers(0, K, (B, K, L)).astype(np.int32)
    anc[:, :, pos] = np.arange(K)[None]
    bias_row = mk(1, H, 1, L) if bias else None
    return dict(q=mk(B * K, 1, H, Dh), k_cache=mk(L, B * K, H * Dh),
                v_cache=mk(L, B * K, H * Dh), k_new=mk(B * K, 1, H, Dh),
                v_new=mk(B * K, 1, H, Dh), anc=anc, bias_row=bias_row,
                own_bias=None if bias_row is None else bias_row[0, :, 0, pos])


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("pos", [0, 3, 5])
@pytest.mark.parametrize("K", [3, 5])
def test_beam_decode_attend_update_matches_jax_kernel(K, pos, bias):
    a = _d2_inputs(K, pos, bias)
    opt = lambda x: None if x is None else jnp.asarray(x)
    jdecode._INTERPRET = True
    try:
        want, want_k, want_v = jdecode.beam_decode_attend_update(
            jnp.asarray(a["q"]), jnp.asarray(a["k_cache"]),
            jnp.asarray(a["v_cache"]), jnp.asarray(a["k_new"]),
            jnp.asarray(a["v_new"]), jnp.asarray(a["anc"]), pos,
            own_bias=opt(a["own_bias"]), bias_row=opt(a["bias_row"]))
    finally:
        jdecode._INTERPRET = False
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in a.items()}
    t["anc"] = t["anc"].long()
    kc, vc = t["k_cache"].clone(), t["v_cache"].clone()
    got = decode.beam_decode_attend_update(
        t["q"], kc, vc, t["k_new"], t["v_new"], t["anc"], pos,
        own_bias=t["own_bias"], bias_row=t["bias_row"])
    assert got.shape == (t["q"].shape[0], 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(kc.numpy(), np.asarray(want_k), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(vc.numpy(), np.asarray(want_v), rtol=2e-5,
                               atol=2e-5)
    # the two-step path: the slot write (U1), then D1 over l <= pos
    k2, v2 = t["k_cache"].clone(), t["v_cache"].clone()
    for c, new in ((k2, t["k_new"]), (v2, t["v_new"])):
        cache_update.cache_slot_update(c.view((1,) + c.shape),
                                       new.reshape(1, c.shape[1], -1), pos)
    assert torch.equal(k2, kc) and torch.equal(v2, vc)
    two_step = decode.beam_decode_attend_reference(t["q"], k2, v2, t["anc"],
                                                   pos, t["bias_row"])
    np.testing.assert_allclose(got.numpy(), two_step.numpy(), rtol=2e-5,
                               atol=2e-5)


def _spread(params, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), params)


@pytest.fixture(scope="module", params=["bart", "t5"])
def fused_beam_models(request):
    """(JAX model with use_fused_beam, its variables, the JAX batch, the
    port without and with the flag, the port batch, the port module whose
    D2/U1 names the model calls)."""
    if request.param == "bart":
        cfg, _ = _flagship_cfg(tiny=True)
        jcls, pcls, port_cfg, lo = JVLBart, VLBart, _bart_port_cfg, 3
    else:
        cfg = _t5_jax_cfg(gated=False)
        jcls, pcls, port_cfg, lo = JVLT5, VLT5, _t5_port_cfg, 2
    cfg = dataclasses.replace(cfg, use_fused_beam=True)
    rng = np.random.default_rng(0)
    V, nb, fd = cfg.backbone.vocab_size, cfg.vis.n_boxes, cfg.vis.feat_dim
    mask = np.ones((B_GEN, L_TXT), np.int32)
    mask[1, 4:] = 0
    batch = dict(input_ids=rng.integers(lo, V, (B_GEN, L_TXT)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B_GEN, nb, fd)).astype(np.float32),
                 boxes=rng.uniform(size=(B_GEN, nb, 4)).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jcls(cfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), **jbatch,
        labels=jnp.ones((B_GEN, 3), jnp.int32),
        ctx=JCtx(task="caption", task_idx=CAPTION))["params"])
    params = _spread(params, rng)
    ports = {flag: load_flax_params(pcls(port_cfg(dataclasses.replace(
        cfg, use_fused_beam=flag)), device="cpu"), params)
        for flag in (False, True)}
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    mod = tbart if request.param == "bart" else tt5
    return jmodel, {"params": params}, jbatch, ports, tbatch, mod


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def spy(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("beams", [1, 5])
def test_fused_beam_generate_token_parity(fused_beam_models, beams,
                                          monkeypatch):
    jmodel, variables, jbatch, ports, tbatch, mod = fused_beam_models
    max_len = 10
    want = np.asarray(jgen.seq2seq_generate(
        jmodel, variables, **jbatch, ctx=JCtx(task="caption",
                                              task_idx=CAPTION),
        num_beams=beams, max_length=max_len))
    ctx = PetContext(task="caption", task_idx=CAPTION)
    unfused = tgen.seq2seq_generate(ports[False], **tbatch, ctx=ctx,
                                    num_beams=beams, max_length=max_len)
    counts = {}
    for name in ("beam_decode_attend_update", "beam_decode_attend"):
        _counting(monkeypatch, mod, name, counts)
    _counting(monkeypatch, tbart, "cache_slots_update", counts)
    _counting(monkeypatch, ports[True], "decode_step_topk", counts)
    fused = tgen.seq2seq_generate(ports[True], **tbatch, ctx=ctx,
                                  num_beams=beams, max_length=max_len)
    np.testing.assert_array_equal(fused.numpy(), want)
    np.testing.assert_array_equal(unfused.numpy(), want)
    assert len(np.unique(want[:, 1:])) > 2  # not a degenerate decode
    cfg = ports[True].cfg
    layers = (cfg.backbone.num_decoder_layers if cfg.is_t5
              else cfg.backbone.decoder_layers)
    if beams > 1:
        assert counts.get("beam_decode_attend", 0) == 0
        assert counts.get("cache_slots_update", 0) == 0
        assert counts["beam_decode_attend_update"] % layers == 0
        assert counts["beam_decode_attend_update"] > 0
    else:
        assert counts.get("beam_decode_attend_update", 0) == 0
        # K and V in one U1 call: one a layer and step
        assert counts["decode_step_topk"] > 0
        assert counts["cache_slots_update"] == layers * counts[
            "decode_step_topk"]
