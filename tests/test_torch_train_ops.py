"""The training slice's ops of the port against the JAX package, on CPU.

Every port wrapper takes its plain PyTorch twin here (the tensors lie on
the CPU); the JAX side runs its Pallas kernels in interpret mode, as
tests/test_ops.py does. Inputs come from seeded numpy and reach both
frameworks as the same arrays. Covered: the hash dropout mask (bit for
bit), the fused dropout + add + LayerNorm (flat L1/L2 and 3-D L3/L4
layouts), attention forward and backward (A1, A6) with and without the
causal triangle, the FFN backward (F2), linear_ce, the task losses, and the
freezing and decay rules. fp32 tolerance 1e-5 unless a test states another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.ops import ce as tce
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.ops import fused_ln as tln
from vlpet_tpu_torch.ops import hashdrop as thd

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=tol, atol=tol,
        err_msg=msg)


def _port_cfg(jcfg):
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.BartConfig(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


# --- hash dropout ----------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("row_base", [0, 2 ** 32 - 7])
def test_keep_mask_bit_equal(rate, row_base):
    from vlpet_tpu.ops.hashdrop import keep_mask

    for shape in ((7, 13), (3, 5, 64), (2, 3, 4, 5)):
        for seed in (0, 123456789, 2 ** 31 - 2):
            want = np.asarray(keep_mask(shape, jnp.uint32(row_base),
                                        jnp.int32(seed), rate))
            got = thd.keep_mask(shape, row_base,
                                torch.tensor([seed], dtype=torch.int32), rate)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{shape} seed {seed}")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_and_head_seed_bit_equal(rate):
    from vlpet_tpu.ops.attention import head_seed
    from vlpet_tpu.ops.hashdrop import hash_dropout

    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    seed = 987654321
    want = np.asarray(hash_dropout(jnp.asarray(x), jnp.int32(seed), rate))
    got = thd.hash_dropout(_t(x), torch.tensor([seed], dtype=torch.int32),
                           rate)
    np.testing.assert_array_equal(got.numpy(), want)
    for h in range(12):
        assert int(thd.head_seed(torch.tensor([seed], dtype=torch.int32), h)) \
            == int(head_seed(jnp.int32(seed), h))


def test_dropout_seeds_hand_out_views_in_order():
    g = torch.Generator().manual_seed(0)
    seeds = thd.DropoutSeeds(3, g, "cpu")
    got = [seeds.next() for _ in range(3)]
    assert all(s.shape == (1,) and s.dtype == torch.int32 for s in got)
    assert torch.equal(torch.cat(got), seeds.seeds)
    assert int(seeds.seeds.min()) >= 0
    with pytest.raises(RuntimeError, match="more dropout sites"):
        seeds.next()


# --- fused dropout + add + LayerNorm (L1/L2, L3/L4) -----------------------

@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("shape", [(4, 8, 128), (3, 5, 64), (3, 7, 128)],
                         ids=["flat", "3d", "ragged"])
def test_fused_ln_plain_matches_pallas_interpret(shape, rate, monkeypatch):
    """D 128 takes the flat kernels, D 64 the 3-D ones, N = 21 the flat
    kernels with a padded last block."""
    import vlpet_tpu.ops.fused_ln as jln

    monkeypatch.setattr(jln, "_INTERPRET", True)
    rng = np.random.default_rng(sum(shape))
    h, res, dy = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    D = shape[-1]
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    seed = np.array([1234567], np.int32)
    want, vjp = jax.vjp(lambda a, b, g, be: jln.fused_dropout_add_ln(
        a, b, g, be, jnp.asarray(seed), rate, 1e-5),
        *map(jnp.asarray, (h, res, gamma, beta)))
    wgrads = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_() for a in (h, res, gamma, beta)]
    got = tln.fused_dropout_add_ln(*args, _t(seed), rate)
    _close(got, want)
    ggrads = torch.autograd.grad(got, args, _t(dy))
    bwd = tln.fused_dropout_add_ln_bwd(_t(h), _t(res), _t(gamma), _t(seed),
                                       _t(dy), rate)
    for name, g, b, w in zip(("dh", "dres", "dgamma", "dbeta"), ggrads, bwd,
                             wgrads):
        _close(g, w, msg=name)
        _close(b, w, msg=name + " (bwd wrapper)")


# --- attention forward and backward (A1, A6) -------------------------------

ATTN_CASES = {
    "encoder": (7, 7, False, True),     # L, S, causal, batched padding mask
    "dec_self": (5, 5, True, False),
    "cross": (5, 9, False, True),
    "causal_offset": (4, 6, True, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_fwd_bwd_match_pallas_interpret(case):
    from vlpet_tpu.ops.attention import (_pallas_attention,
                                         _pallas_attention_bwd)

    L, S, causal, batched = ATTN_CASES[case]
    rng = np.random.default_rng(L * 10 + S)
    B, H, Dh = 3, 4, 16
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    if batched:
        keep = rng.uniform(size=(B, 1, 1, S)) > 0.3
        keep[..., 0] = True
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    else:
        mask = np.zeros((1, 1, 1, S), np.float32)
    jq, jk, jv, jm, jdo = map(jnp.asarray, (q, k, v, mask, do))
    want = _pallas_attention(jq, jk, jv, jm, H, causal, interpret=True)
    wgrads = _pallas_attention_bwd(jq, jk, jv, jm, jdo, H, causal,
                                   interpret=True)
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tatt.fused_attention(*args, _t(mask), H, causal)
    _close(got, want)
    ggrads = torch.autograd.grad(got, args, _t(do))
    bwd = tatt.fused_attention_bwd(_t(q), _t(k), _t(v), _t(mask), _t(do), H,
                                   causal)
    for name, g, b, w in zip(("dq", "dk", "dv"), ggrads, bwd, wgrads):
        _close(g, w, msg=name)
        _close(b, w, msg=name + " (bwd wrapper)")


# --- FFN backward (F2) -----------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_ffn_bwd_matches_jax_vjp_interpret(act, monkeypatch):
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    rng = np.random.default_rng(7)
    N, D, F = 37, 32, 64  # ragged N: the JAX kernel pads, the port does not
    x, dy = (rng.normal(size=(N, D)).astype(np.float32) for _ in range(2))
    w1 = rng.normal(size=(D, F)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(F,)).astype(np.float32) * 0.2
    w2 = rng.normal(size=(F, D)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.2
    _, vjp = jax.vjp(lambda a, c, e: jffn.fused_ffn(a, jnp.asarray(w1), c,
                                                     jnp.asarray(w2), e, act),
                     *map(jnp.asarray, (x, b1, b2)))
    wdx, wdb1, wdb2 = vjp(jnp.asarray(dy))
    # port weights are in torch Linear layout (out, in) and frozen
    tw1, tw2 = _t(w1.T), _t(w2.T)
    args = [_t(a).requires_grad_() for a in (x, b1, b2)]
    y = tffn.fused_ffn(args[0], tw1, args[1], tw2, args[2], act)
    for g, w in zip(torch.autograd.grad(y, args, _t(dy)), (wdx, wdb1, wdb2)):
        _close(g, w)
    for g, w in zip(tffn.fused_ffn_bwd(_t(x), _t(dy), tw1, _t(b1), tw2, act),
                    (wdx, wdb1, wdb2)):
        _close(g, w)
    with pytest.raises(ValueError, match="frozen"):
        tffn.fused_ffn(_t(x), tw1.requires_grad_(), _t(b1), tw2, _t(b2), act)


# --- losses ------------------------------------------------------------------

def test_linear_ce_value_and_dx_match_jax():
    """nll within 1e-5; dx within 1e-5 plus one bf16 step of the dlogits
    (both sides round dlogits to bf16 from fp32 values that may differ in
    the last bit)."""
    from vlpet_tpu.models.vlbart import cross_entropy_with_ignore
    from vlpet_tpu.ops.ce import linear_ce

    rng = np.random.default_rng(11)
    N, d, V = 12, 16, 50
    x = rng.normal(size=(N, d)).astype(np.float32)
    w = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    b = rng.normal(size=(V,)).astype(np.float32) * 0.1
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[[2, 7]] = -100
    g = rng.uniform(0.5, 1.5, N).astype(np.float32)
    want, vjp = jax.vjp(lambda a: linear_ce(a, jnp.asarray(w), jnp.asarray(b),
                                            jnp.asarray(labels)),
                        jnp.asarray(x))
    (wdx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    nll, logits = tce.linear_ce(xt, _t(w), _t(b), _t(labels).long())
    assert logits.dtype == torch.bfloat16 and logits.shape == (N, V)
    _close(nll, want)
    (gdx,) = torch.autograd.grad(nll, xt, _t(g))
    atol = TOL + 2 ** -8 * float(np.abs(w).sum(axis=0).max())
    np.testing.assert_allclose(gdx.numpy(), np.asarray(wdx), rtol=TOL,
                               atol=atol)
    lg = rng.normal(size=(2, 6, V)).astype(np.float32)
    lb = labels[:12].reshape(2, 6)
    for reduce in (False, True):
        _close(tce.cross_entropy_with_ignore(_t(lg), _t(lb).long(), reduce),
               cross_entropy_with_ignore(jnp.asarray(lg), jnp.asarray(lb),
                                         reduce))


@pytest.mark.parametrize("task", ["vqa", "gqa", "caption"])
def test_task_loss_matches_jax(task):
    from vlpet_tpu.models.heads import task_loss

    from vlpet_tpu_torch.models.heads import task_loss as ttask_loss

    rng = np.random.default_rng(3)
    per_tok = rng.uniform(0, 5, (4, 6)).astype(np.float32)
    labels = rng.integers(3, 50, (4, 6)).astype(np.int32)
    labels[1, 3:] = -100
    labels[2, :] = -100
    scores = rng.uniform(0, 1, 4).astype(np.float32)
    sc = scores if task == "vqa" else None
    want = task_loss(task, jnp.asarray(per_tok), jnp.asarray(labels),
                     None if sc is None else jnp.asarray(sc))
    got = ttask_loss(task, _t(per_tok), _t(labels).long(),
                     None if sc is None else _t(sc))
    _close(got, want)


# --- freezing and decay rules ------------------------------------------------

def _jax_names(tree):
    """Flat flax paths, ``kernel`` renamed ``weight`` as convert.py does."""
    from vlpet_tpu.train.freezing import flatten_with_paths

    out = {}
    for name, val in flatten_with_paths(tree):
        head, _, leaf = name.rpartition(".")
        out[f"{head}.weight" if leaf == "kernel" else name] = val
    return out


def test_trainable_and_decay_sets_match_jax():
    from __graft_entry__ import _flagship_cfg
    from vlpet_tpu.models.vlbart import VLBart as JVLBart
    from vlpet_tpu.train.freezing import split_params, trainable_mask
    from vlpet_tpu.train.optim import decay_mask

    from vlpet_tpu_torch.models.vlbart import VLBart
    from vlpet_tpu_torch.train.freezing import apply_freezing
    from vlpet_tpu_torch.train.optim import decay_mask as tdecay_mask

    jcfg, _ = _flagship_cfg(tiny=True)
    B = 2
    params = jax.eval_shape(lambda: JVLBart(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((B, 5), jnp.int32),
        jnp.ones((B, 5), jnp.int32),
        vis_feats=jnp.ones((B, jcfg.vis.n_boxes, jcfg.vis.feat_dim)),
        boxes=jnp.zeros((B, jcfg.vis.n_boxes, 4)),
        labels=jnp.ones((B, 3), jnp.int32)))["params"]
    mask = _jax_names(trainable_mask(params, jcfg.pet))
    trainable, _ = split_params(params, trainable_mask(params, jcfg.pet))
    decay = _jax_names(decay_mask(trainable))

    model = VLBart(_port_cfg(jcfg), device="cpu")
    got = apply_freezing(model, model.cfg.pet)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert set(got) == {n for n, m in mask.items() if m}
    assert all(p.requires_grad == mask[n]
               for n, p in model.named_parameters())
    assert tdecay_mask(got) == {n: bool(v) for n, v in decay.items()}


def test_full_width_trainable_share_is_published():
    """VL-PET-large on BART-base trains 4.16% of the parameters (the
    published Params(%); tests/test_freezing.py pins it for the JAX
    package), counted without allocating on the meta device."""
    from vlpet_tpu_torch.models.vlbart import VLBart
    from vlpet_tpu_torch.train.freezing import trainable_report

    cfg = pc.flagship_cfg()
    rep = trainable_report(VLBart(cfg, device="meta"), cfg.pet)
    assert abs(rep["percentage"] - 4.16) < 0.05, rep
