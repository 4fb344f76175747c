"""The streamed linear + CE (C1/C2) of the port against the JAX package, on
CPU.

* ``ops.fused_ce.fused_linear_ce`` on CPU tensors (its plain twins) against
  vlpet_tpu.ops.fused_ce.fused_linear_ce with the Pallas kernels in
  interpret mode (as tests/test_ops.py runs them): N 48, D 64, V 5000 (a
  ragged last vocab tile of the TPU's 4096 and of the port's 64), two
  labels at -100, a weighted cotangent. Loss, lse and dx: fp32 within
  1e-5 * (1 + |jax|); bf16 x within 2e-2 * (1 + max|jax|), for the one-ulp
  flips of the g the backward rounds to bf16.
* The ``use_fused_ce`` route: the tiny BART and the tiny T5 relu/tied
  (tests/test_torch_train.py, tests/test_torch_t5_train.py) with the flag
  on, fp32, in a 3-step lockstep with the JAX make_train_step, vqa and
  caption, at those files' tolerances. On the CPU the JAX package routes
  the flag to its dense CE (vlpet_tpu/models/vlbart.py:234,
  models/t5.py:1041), the same function. On the fused route the training
  output has no logits; with ``unfreeze_lm_head`` the flag takes the dense
  route and ``shared`` gets its gradient; the gated/untied T5 ignores the
  flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.ops.fused_ce as jfc
from test_torch_t5_train import _jax_cfg as _t5_jax_cfg
from test_torch_t5_train import _batch as _t5_batch
from test_torch_t5_train import _jax_run as _t5_jax_run
from test_torch_t5_train import _port_cfg as _t5_port_cfg
from test_torch_t5_train import _spread, TASKS as T5_TASKS
from test_torch_train import _check_lockstep, _setup
from vlpet_tpu.models.t5 import VLT5 as JVLT5
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import make_train_step as jmake_step
from __graft_entry__ import _flagship_cfg
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.ops import fused_ce
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

N, D, V = 48, 64, 5000
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K = 3
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)


def _inputs(dtype: str):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    labels[3] = labels[17] = -100
    weights = rng.uniform(0.5, 2.0, (N,)).astype(np.float32)
    return x, w, b, labels, weights


def _jax_fused(x, w, b, labels, weights, dtype):
    """JAX fused_linear_ce with the Pallas kernels in interpret mode:
    (loss, lse, dx of sum(loss * weights))."""
    run_fwd, run_bwd = jfc._run_fwd, jfc._run_bwd
    jfc._run_fwd = lambda *a, **k: run_fwd(*a, interpret=True, **k)
    jfc._run_bwd = lambda *a, **k: run_bwd(*a, interpret=True, **k)
    try:
        jx = jnp.asarray(x, dtype)
        jw, jb = jnp.asarray(w), jnp.asarray(b)
        jl = jnp.asarray(labels)
        loss = jfc.fused_linear_ce(jx, jw, jb, jl)
        _, lse = jfc._run_fwd(jx, jw.astype(jx.dtype), jb.reshape(1, -1),
                              jl.reshape(-1, 1))
        dx = jax.grad(lambda v: jnp.sum(
            jfc.fused_linear_ce(v, jw, jb, jl) * jnp.asarray(weights)))(jx)
    finally:
        jfc._run_fwd, jfc._run_bwd = run_fwd, run_bwd
    return (np.asarray(loss), np.asarray(lse)[:, 0],
            np.asarray(dx.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_linear_ce_matches_jax_kernels(dtype):
    x, w, b, labels, weights = _inputs(dtype)
    want_loss, want_lse, want_dx = _jax_fused(x, w, b, labels, weights, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss, lse = fused_ce.fused_linear_ce(tx, torch.from_numpy(w),
                                         torch.from_numpy(b),
                                         torch.from_numpy(labels).long())
    (dx,) = torch.autograd.grad((loss * torch.from_numpy(weights)).sum(), tx)
    assert loss.dtype == lse.dtype == torch.float32 and dx.dtype == tx.dtype
    assert loss[3] == 0.0 and loss[17] == 0.0
    tol = TOL[dtype]
    for got, want, scaled in ((loss, want_loss, False),
                              (lse, want_lse, False), (dx, want_dx, True)):
        got = got.detach().float().numpy()
        bound = tol * (1.0 + (np.abs(want).max() if scaled and
                              dtype == "bfloat16" else np.abs(want)))
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def test_fused_linear_ce_backward_twin_is_its_autograd():
    """In fp32 the plain backward twin (the kernel's arithmetic, the
    autograd Function's CPU backward) equals autograd of the plain
    forward."""
    x, w, b, labels, weights = _inputs("float32")
    tx = torch.from_numpy(x).requires_grad_()
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    tl, tg = torch.from_numpy(labels).long(), torch.from_numpy(weights)
    loss, lse = fused_ce.fused_linear_ce_reference(tx, tw, tb, tl)
    (want,) = torch.autograd.grad((loss * tg).sum(), tx)
    got = fused_ce.fused_linear_ce_bwd_reference(tx.detach(), tw, tb, tl,
                                                 lse.detach(), tg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fused_linear_ce_keeps_the_head_frozen():
    """W and b get no gradient: the wrapper raises when either requires
    one while autograd is on (the JAX package returns zeros instead)."""
    x, w, b, labels, _ = _inputs("float32")
    args = [torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            torch.from_numpy(labels).long()]
    for i in (1, 2):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(ValueError, match="frozen"):
            fused_ce.fused_linear_ce(*bad)
        with torch.no_grad():
            fused_ce.fused_linear_ce(*bad)  # no autograd: nothing to refuse


@pytest.fixture(scope="module")
def bart_fused_lockstep():
    jcfg, tasks = _flagship_cfg(tiny=True)
    return _setup(dataclasses.replace(jcfg, use_fused_ce=True), tasks, 6)


@pytest.mark.parametrize("task", ["vqa", "caption"])
def test_bart_fused_ce_train_step_lockstep_with_jax(bart_fused_lockstep,
                                                    task):
    assert bart_fused_lockstep[0].use_fused_ce
    _check_lockstep(bart_fused_lockstep, task)


def test_bart_fused_ce_route(bart_fused_lockstep):
    """The training forward on the fused route has no logits and the same
    loss as the dense route; with unfreeze_lm_head the flag takes the dense
    route and ``shared`` gets its gradient."""
    from test_torch_train import _port_cfg
    from vlpet_tpu_torch.models.vlbart import VLBart

    jcfg, tasks, _, params, _, tbatch, _, _ = bart_fused_lockstep
    args = (tbatch["input_ids"], tbatch["attention_mask"],
            tbatch["vis_feats"], tbatch["boxes"])
    losses = {}
    for flag in (True, False):
        cfg = _port_cfg(dataclasses.replace(jcfg, use_fused_ce=flag))
        model = load_flax_params(VLBart(cfg, device="cpu"), params)
        apply_freezing(model, cfg.pet)
        out = model(*args, labels=tbatch["target_ids"], deterministic=False,
                    reduce_loss=True)
        assert ("logits" in out) != flag
        losses[flag] = out["loss"]
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-6,
                               atol=0)
    cfg = _port_cfg(dataclasses.replace(jcfg, use_fused_ce=True, pet=(
        dataclasses.replace(jcfg.pet, unfreeze_lm_head=True))))
    model = load_flax_params(VLBart(cfg, device="cpu"), params)
    trainable = apply_freezing(model, cfg.pet)
    assert "model.shared" in trainable
    out = model(*args, labels=tbatch["target_ids"], deterministic=False,
                reduce_loss=True)
    assert "logits" in out
    (g,) = torch.autograd.grad(out["loss"], model.model.shared)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def _t5_setup(gated: bool, fused: bool):
    jcfg = dataclasses.replace(_t5_jax_cfg(gated=gated), use_fused_ce=fused)
    rng = np.random.default_rng(0)
    batch = _t5_batch(rng, jcfg.backbone.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLT5(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jbatch["input_ids"], jbatch["attention_mask"],
        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
        labels=jbatch["target_ids"], ctx=JCtx())["params"])
    params = _spread(params, rng)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, jmodel, params, jbatch, tbatch


@pytest.fixture(scope="module")
def t5_fused_lockstep():
    jcfg, jmodel, params, jbatch, tbatch = _t5_setup(False, True)
    trainable, _ = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    return jcfg, params, jbatch, tbatch, tx, jmake_step(jmodel, tx, T5_TASKS)


@pytest.mark.parametrize("task", ["vqa", "caption"])
def test_t5_fused_ce_train_step_lockstep_with_jax(t5_fused_lockstep, task):
    jcfg, params, jbatch, tbatch, tx, jstep = t5_fused_lockstep
    task_idx = T5_TASKS.index(task)
    want_losses, want_norms, want_params = _t5_jax_run(
        jcfg, params, jbatch, tx, jstep, task_idx)
    model = load_flax_params(VLT5(_t5_port_cfg(jcfg), device="cpu"), params)
    assert model.cfg.use_fused_ce
    trainable = apply_freezing(model, model.cfg.pet)
    step = make_train_step(model, build_optimizer(trainable, **OPT), T5_TASKS,
                           device="cpu")
    generator = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(K):
        out = step(tbatch, generator, task_idx)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for name, p in trainable.items():
        want = want_params[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_fused_ce_route(gated):
    """Tied: the fused route has no logits and the dense route's loss.
    Gated/untied: the flag is ignored, the loss identical with and without
    it, logits present."""
    out = {}
    for flag in (True, False):
        jcfg, _, params, _, tbatch = _t5_setup(gated, flag)
        model = load_flax_params(VLT5(_t5_port_cfg(jcfg), device="cpu"),
                                 params)
        apply_freezing(model, model.cfg.pet)
        out[flag] = model(tbatch["input_ids"], tbatch["attention_mask"],
                          tbatch["vis_feats"], tbatch["boxes"],
                          labels=tbatch["target_ids"], deterministic=False,
                          reduce_loss=True)
    assert ("logits" in out[True]) == gated
    assert "logits" in out[False]
    if gated:
        assert torch.equal(out[True]["loss"], out[False]["loss"])
    else:
        torch.testing.assert_close(out[True]["loss"], out[False]["loss"],
                                   rtol=1e-6, atol=0)
