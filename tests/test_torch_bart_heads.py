"""The port's BART classification and QA heads (models/bart_heads.py)
against vlpet_tpu/models/bart_heads.py, on CPU, on tests/test_bart_heads.py's
cases: a tiny text-only BART (d 32, 2+2 layers, vocabulary 64), rows ending
in <eos> with an earlier <eos> in row 0. Seeded normal(0, 0.2) weights of
the JAX tree go to both through vlpet_tpu_torch.convert.

* BartForSequenceClassification: the logits of the last-<eos> pooling and
  the CE loss within 1e-5 * (1 + max|jax|); a row without <eos> pools to
  NaN in both; a training forward and backward (dropout 0.1, the head and
  the backbone's LayerNorms trainable) reaches both.
* BartForQuestionAnswering: start and end logits and the span loss, with
  positions in range and out of range (clamped to the ignored index T;
  with every row ignored the loss is 0 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import BartConfig, PetConfig, VisConfig, VLModelConfig
from vlpet_tpu.models import bart_heads as jh
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import bart_heads as th
from vlpet_tpu_torch.train.freezing import apply_freezing

from test_torch_gates import port_cfg

torch.set_num_threads(2)  # several xdist workers share the host


def _cfg(dropout=0.0):
    return VLModelConfig(
        backbone=BartConfig(vocab_size=64, d_model=32, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=32,
                            dropout=dropout),
        vis=VisConfig(no_vis=True), pet=PetConfig())


def _batch(B=3, T=7):
    rng = np.random.default_rng(0)
    eos = 2
    ids = rng.integers(4, 64, (B, T)).astype(np.int32)
    ids[:, -1] = eos  # every row ends with <eos>
    ids[0, 3] = eos   # row 0 has an earlier eos too: the LAST one pools
    return ids, np.ones((B, T), np.int32)


def _pair(jcls, tcls, **kw):
    """The JAX module, its seeded normal(0, 0.2) parameters (the tree's
    shapes from jax.eval_shape) and the port module holding them."""
    jcfg = _cfg()
    jm = jcls(jcfg, **kw)
    ids, mask = map(jnp.asarray, _batch())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids, mask,
                                            ctx=JCtx())["params"])
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(s.dtype), shapes)
    tm = load_flax_params(tcls(port_cfg(jcfg), device="cpu", **kw), params)
    return jm, params, tm


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * (1.0 + np.nanmax(np.abs(want))))


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_sequence_classification_matches_jax():
    jm, params, tm = _pair(jh.BartForSequenceClassification,
                           th.BartForSequenceClassification, num_labels=3)
    ids, mask = _batch()
    no_eos = ids.copy()
    no_eos[2, -1] = 5  # row 2 has no <eos> left: NaN in both
    labels = np.array([0, 1, 2], np.int32)

    @jax.jit
    def jax_side(p):
        return [jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                         labels=jnp.asarray(labels), ctx=JCtx())
                for x in (ids, no_eos)]

    want, want_nan = jax_side(params)
    with torch.no_grad():
        got = tm(_t(ids), _t(mask), labels=_t(labels))
        got_nan = tm(_t(no_eos), _t(mask))
    _close(got["logits"], want["logits"])
    _close(got["loss"], want["loss"])
    nan_rows = np.isnan(np.asarray(want_nan["logits"])).all(-1)
    assert nan_rows.tolist() == [False, False, True]
    np.testing.assert_array_equal(torch.isnan(got_nan["logits"]).all(-1)
                                  .numpy(), nan_rows)
    _close(got_nan["logits"][:2], np.asarray(want_nan["logits"])[:2])
    # a training pass at dropout 0.1 with the backbone's LayerNorms and the
    # head trainable (the FFN kernels take no weight gradient) reaches both
    cfg = port_cfg(_cfg(dropout=0.1))
    train = th.BartForSequenceClassification(cfg, num_labels=3, device="cpu")
    train.load_state_dict(tm.state_dict())
    apply_freezing(train, PetConfig(unfreeze_layer_norms=True))
    train.classification_head.requires_grad_(True)
    out = train(_t(ids), _t(mask), labels=_t(labels), deterministic=False,
                generator=torch.Generator().manual_seed(0))
    out["loss"].backward()
    for name in ("classification_head.out_proj.weight",
                 "model.encoder.layers_0.final_layer_norm.scale",
                 "model.decoder.layers_1.self_attn_layer_norm.bias"):
        g = train.get_parameter(name).grad
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0, name
    assert float(out["loss"].detach()) != pytest.approx(float(got["loss"]),
                                                        abs=1e-6)


@pytest.mark.parametrize("positions", ["in_range", "ignored", "all_ignored"])
def test_question_answering_matches_jax(positions):
    jm, params, tm = _pair(jh.BartForQuestionAnswering,
                           th.BartForQuestionAnswering)
    ids, mask = _batch()
    sp, ep = {"in_range": ([1, 2, 3], [2, 3, 4]),
              "ignored": ([1, 50, -3], [2, 50, 7]),
              "all_ignored": ([7, 50, 9], [8, 70, 7])}[positions]
    sp, ep = np.array(sp, np.int32), np.array(ep, np.int32)
    want = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(ids), jnp.asarray(mask),
        start_positions=jnp.asarray(sp), end_positions=jnp.asarray(ep),
        ctx=JCtx()))(params)
    x = _t(ids)
    with torch.no_grad():
        got = tm(x, _t(mask), start_positions=_t(sp), end_positions=_t(ep))
    assert got["start_logits"].shape == (3, 7)
    for k in ("start_logits", "end_logits", "loss"):
        _close(got[k], want[k])
    if positions == "all_ignored":
        assert float(got["loss"]) == 0.0
