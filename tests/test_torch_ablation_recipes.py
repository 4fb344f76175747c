"""The VL-PET ablation flags on the port's BART against the JAX package, on
CPU: the encoder-side recipes of tests/test_pet_variants.py VARIANTS (the
three other multihead adapter shapes, the LayerNorm and L2 gates, the
standalone gate in both forms, the add-combined VL-PET-large gate, the
low-rank visual projector) and a port-side one, VL-PET-large with the
LayerNorm gate; tests/test_torch_ablation_decoder.py runs the
cross-attention, decoder and IA3 recipes and ``lambda_z`` with the helpers
below.

Each recipe is parsed with the BASE flags by the JAX CLI on the tiny BART
of tests/test_torch_pet_recipes.py (d 32, 2+2 layers, 4 heads, FFN 64,
vocab 512; fp32, dropout 0), weights spread by
tests/test_torch_gates.py ``setup_cfg``. The module-scoped fixture runs
the JAX package once a recipe -- 3 vqa steps of vlpet_tpu/train/steps.py
make_train_step (with the recipe's ``lambda_z`` under ``track_z``) -- and
every test reuses that run. Per recipe:

* the trainable set, by name, equal to the JAX freezing engine's;
* the port's make_train_step in lockstep with that run: per-step loss and
  gradient norm within 1e-5 relative, every trainable parameter after the
  3 steps within rtol 1e-3, atol 1e-5 * max|p| (the gates' tolerances),
  frozen ones unchanged; the value hooks that never fire (the self
  roles' IA3 vectors and VPAs) have no parameters in either package;
* beam-5 tokens identical to the JAX seq2seq_generate (caption, or the
  task of ``BEAM_TASK``); the decode must not repeat one token everywhere,
  except where ``DEGENERATE`` says both packages do;
* LAST.npz both ways: the JAX export loads into the port and the port's
  export into the JAX tree, every leaf bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pet_variants import BASE, VARIANTS
from test_torch_gates import (OPT, _models, check_beam5, port_cfg,
                              setup_cfg)
from test_torch_pet_recipes import TASKS, TINY, check_trainable
from vlpet_tpu.cli.param import build_model_config, parse_args
from vlpet_tpu.config import BartConfig
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train import checkpoint as jckpt
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train import checkpoint as tckpt
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
_LARGE = VARIANTS["vlpet_large_gating_add"]
_GATE = _LARGE.index("--use_encoder_adapter_gating_large_x_lowrank")
# port-side recipes: flags after BASE, as VARIANTS holds them
PORT_RECIPES = {
    # VL-PET-large with the LayerNorm gate in place of the low-rank one:
    # the LayerNorm gate with a decode that varies (see DEGENERATE)
    "vlpet_large_gating_layernorm": (
        _LARGE[:_GATE] + ["--use_encoder_adapter_gating_layernorm"]
        + _LARGE[_GATE + 4:]),
    # the VPA with the residual connection and its gate, and the multihead
    # and pair VPAs
    "vpa_residual_gate": [
        "--use_decoder_enc_attn_value_parallel_adapter_down_dim",
        "--decoder_enc_attn_value_parallel_adapter_down_dim", "8",
        "--use_decoder_enc_attn_value_residual_connection",
        "--use_decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank",
        "--decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank_down_dim",
        "8"],
    "sequential_va_gate": VARIANTS["sequential_va"] + [
        "--use_decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank",
        "--decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank_down_dim",
        "8"],
    "mh_vpa": [
        "--use_decoder_enc_attn_value_parallel_adapter_down_multihead",
        "--decoder_enc_attn_value_parallel_adapter_down_dim", "8",
        "--decoder_enc_attn_value_parallel_adapter_multihead_num_head", "4"],
    "pair_vpa": [
        "--use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead",
        "--decoder_enc_attn_value_parallel_adapter_down_dim", "8",
        "--decoder_enc_attn_value_parallel_adapter_multihead_num_head", "4"],
    # the value hooks that never fire, beside the cross IA3 / VPA that do
    "unfired_ia3": ["--use_encoder_attn_value_ia3",
                    "--use_decoder_self_attn_value_ia3",
                    "--use_decoder_enc_attn_value_ia3"],
    "unfired_vpa": [
        "--use_encoder_attn_value_parallel_adapter_down_dim",
        "--encoder_attn_value_parallel_adapter_down_dim", "8",
        "--use_decoder_self_attn_value_parallel_adapter_down_dim",
        "--decoder_self_attn_value_parallel_adapter_down_dim", "8",
        "--use_decoder_enc_attn_value_parallel_adapter_down_dim",
        "--decoder_enc_attn_value_parallel_adapter_down_dim", "8"],
    # single_adapter.sh's flags with the z regularizer
    "track_z": VARIANTS["single_adapter"] + ["--track_z", "--lambda_z",
                                             "1e-3"],
}
# the task of the beam-5 check where the caption decode repeats one token
BEAM_TASK = {"decoder_mh_kv_adapter": "vqa", "unfired_vpa": "vqa"}
# recipes whose beam-5 decode at the spread weights repeats one token in
# every row, in both packages and on both tasks: the LayerNorm gate
# without a decoder adapter (vlpet_large_gating_layernorm holds the gate's
# decode with the VPA); the tokens are still held equal
DEGENERATE = ("gating_layernorm",)
# the modules of the value hooks that never fire: the self-attention
# roles' IA3 vectors and VPAs (vlpet_tpu/models/bart.py:243-257), which
# the JAX package defines in setup and never calls
UNFIRED = ("self_attn.value_ia3", "self_attn.attn_value_parallel_adapter")


def ablation_cfg(name: str):
    """The JAX config of a VARIANTS or PORT_RECIPES recipe on the tiny
    BART."""
    flags = PORT_RECIPES[name] if name in PORT_RECIPES else VARIANTS[name]
    cfg = build_model_config(parse_args(BASE + flags), TASKS, vocab_size=512)
    return dataclasses.replace(cfg, backbone=BartConfig(**TINY))


def lambda_z_of(cfg) -> float:
    """The trainers' ``lambda_z``: the recipe's under ``track_z``."""
    return cfg.pet.lambda_z if cfg.pet.track_z else 0.0


def jax_run(s, task="vqa", tasks=TASKS):
    """K steps of the JAX make_train_step: (losses, grad norms, the
    trainable parameters after them by port name)."""
    jcfg, jmodel, params, jbatch, _, _ = s
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, tasks, lambda_z=lambda_z_of(jcfg))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    losses, norms = [], []
    for _ in range(K):
        state, m = jstep(state, frozen, jbatch, jax.random.PRNGKey(0),
                         tasks.index(task))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, flax_to_state_dict(jax.device_get(state.params))


def check_lockstep_with(s, run, task="vqa", tasks=TASKS):
    """The port's K steps against ``jax_run``'s (module docstring)."""
    jcfg, _, params, _, tbatch, _ = s
    want_losses, want_norms, want_params = run
    _, T = _models(jcfg)
    model = load_flax_params(T(port_cfg(jcfg), device="cpu"), params)
    named = apply_freezing(model, model.cfg.pet)
    assert set(named) == set(want_params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, build_optimizer(named, **OPT), tasks,
                           lambda_z=lambda_z_of(jcfg), device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(K):
        out = step(tbatch, gen, tasks.index(task))
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for name, p in named.items():
        want = want_params[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(want).max()), err_msg=name)
    for name, p in model.named_parameters():
        if name not in named:
            assert torch.equal(p, start[name]), name
    return model, start


def check_unfired(s, model):
    """The value hooks that never fire have no parameters in either tree:
    flax creates none for a module its forward never calls, and the port
    builds none."""
    params = s[2]
    for tree in (flax_to_state_dict(params), dict(model.named_parameters())):
        assert not [n for n in tree if any(u in n for u in UNFIRED)]


def check_beam5_tokens(name, s, tasks=TASKS):
    """Beam-5 tokens equal to JAX's; not one repeated token unless the
    recipe is in DEGENERATE."""
    task = BEAM_TASK.get(name, "caption")
    if name not in DEGENERATE:
        return check_beam5(s, task, tasks)
    jcfg, jmodel, params, jbatch, tbatch, port = s
    ti = tasks.index(task)
    keys = ("input_ids", "attention_mask", "vis_feats", "boxes")
    want = np.asarray(jgen.seq2seq_generate(
        jmodel, {"params": params}, **{k: jbatch[k] for k in keys},
        ctx=JCtx(task=task, task_idx=ti), num_beams=5, max_length=8))
    with torch.no_grad():
        got = tgen.seq2seq_generate(port, **{k: tbatch[k] for k in keys},
                                    ctx=PetContext(task=task, task_idx=ti),
                                    num_beams=5, max_length=8)
    np.testing.assert_array_equal(got.numpy(), want)


def check_last_npz(s, tmp_path):
    """LAST.npz both ways, every leaf bit for bit."""
    jcfg, _, params, _, _, _ = s
    _, T = _models(jcfg)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    want = flax_to_state_dict(params)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(params, jpath)
    port = T(port_cfg(jcfg), device="cpu")
    _, n = tckpt.load_params_npz(jpath, port)
    assert n == n_leaves
    for k, p in port.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    port.init_weights(torch.Generator().manual_seed(7))
    tpath = str(tmp_path / "port.npz")
    tckpt.save_params_npz(dict(port.named_parameters()), tpath)
    loaded, n = jckpt.load_params_npz(
        tpath, jax.tree_util.tree_map(np.zeros_like, params))
    assert n == n_leaves
    got = flax_to_state_dict(jax.device_get(loaded))
    for k, p in port.named_parameters():
        assert torch.equal(got[k], p.detach()), k


def ablation_tests(names):
    """The module-scoped fixture (one JAX run a recipe) and the four tests
    of the module docstring over ``names``, for a test module to take into
    its namespace (``globals().update(ablation_tests(...))``)."""
    @pytest.fixture(scope="module", params=names)
    def recipe(request):
        s = setup_cfg(ablation_cfg(request.param))
        return request.param, s, jax_run(s)

    def test_trainable_set_matches_jax(recipe):
        check_trainable(recipe[1])

    def test_train_lockstep_with_jax(recipe):
        name, s, run = recipe
        model, _ = check_lockstep_with(s, run)
        if name.startswith("unfired"):
            check_unfired(s, model)

    def test_beam5_tokens_match_jax(recipe):
        check_beam5_tokens(recipe[0], recipe[1])

    def test_last_npz_round_trips_between_the_packages(recipe, tmp_path):
        check_last_npz(recipe[1], tmp_path)

    return {k: v for k, v in locals().items() if k != "names"}


globals().update(ablation_tests([
    "mh_up", "mh_down_up", "mh_pair", "gating_layernorm", "gating_l2norm",
    "standalone_gating", "standalone_gating_add_x2", "vlpet_large_gating_add",
    "lowrank_visual_projector", "vlpet_large_gating_layernorm"]))
