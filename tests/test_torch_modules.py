"""The port's modules against their flax counterparts, weights moved by
vlpet_tpu_torch.convert: VL-PET modules, LayerNorms, the visual embedding
and a whole encoder layer. CPU (every port module is built with
device="cpu"), fp32, tolerance 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import (BartConfig, PetConfig, VisConfig, VLModelConfig,
                              vlpet_recipe)
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _init(mod, *args, **kw):
    return jax.device_get(mod.init(jax.random.PRNGKey(0), *args, **kw)["params"])


def _port_cfg(jcfg):
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.BartConfig(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.fixture
def x():
    return np.random.default_rng(0).normal(size=(2, 5, 32)).astype(np.float32)


def test_multihead_down_adapter(x):
    from vlpet_tpu.pet.modules import MultiheadDownAdapter as JMod
    from vlpet_tpu_torch.pet.modules import MultiheadDownAdapter

    jmod = JMod(32, 16, 4)  # torch-default init: nonzero biases
    params = _init(jmod, jnp.asarray(x))
    assert params["down_kernel"].shape == (4, 32, 4)
    port = load_flax_params(MultiheadDownAdapter(32, 16, 4, device="cpu"),
                            params)
    assert port.down_kernel.shape == (4, 32, 4)  # per-head shape kept
    _close(port(_t(x)), jmod.apply({"params": params}, jnp.asarray(x)))


def test_gate_large_x_lowrank(x):
    from vlpet_tpu.pet.modules import GateLargeXLowRank as JMod
    from vlpet_tpu_torch.pet.modules import GateLargeXLowRank

    jmod = JMod(32, 8)
    params = _init(jmod, jnp.asarray(x))
    port = load_flax_params(GateLargeXLowRank(32, 8, device="cpu"), params)
    jg, jpre = jmod.apply({"params": params}, jnp.asarray(x),
                          return_pre_sigmoid=True)
    g, pre = port(_t(x), return_pre_sigmoid=True)
    _close(g, jg)
    _close(pre, jpre)


@pytest.mark.parametrize("single", [True, False])
def test_vpa_adapter_controller(x, single):
    """The value-parallel adapter: out = A(x) + y, shared or per-task."""
    from vlpet_tpu.pet.modules import AdapterController as JMod
    from vlpet_tpu.pet.modules import PetContext as JCtx
    from vlpet_tpu_torch.pet.modules import AdapterController, PetContext

    pet = PetConfig(tasks=("vqa", "gqa", "caption"), use_single_adapter=single)
    spec = pet.down_dim_spec(32, 12, parallel=True)
    port_spec = pc.PetConfig(**dataclasses.asdict(pet)).down_dim_spec(
        32, 12, parallel=True)
    y = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jmod = JMod(spec)
    params = _init(jmod, jnp.asarray(x), JCtx(), y=jnp.asarray(y))
    if not single:  # per-task kernels keep their task axis, (T, out, in)
        assert flax_to_state_dict(params)["adapters.down_sampler.weight"].shape \
            == (3, 12, 32)
    port = load_flax_params(AdapterController(port_spec, device="cpu"), params)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      JCtx(task="caption", task_idx=2), y=jnp.asarray(y))
    _close(port(_t(x), PetContext(task="caption", task_idx=2), y=_t(y)), want)


def test_layer_norms_match_flax(x):
    import flax.linen as nn

    from vlpet_tpu.models.bart import ResidualDropoutLayerNorm as JRes
    from vlpet_tpu_torch.models.bart import ResidualDropoutLayerNorm
    from vlpet_tpu_torch.models.norm import LayerNorm

    rng = np.random.default_rng(2)
    xs = x * 3.0 + 1.5  # a large mean stresses the fast-variance form
    params = {"scale": rng.normal(size=(32,)).astype(np.float32),
              "bias": rng.normal(size=(32,)).astype(np.float32)}
    want = nn.LayerNorm(epsilon=1e-5).apply({"params": params}, jnp.asarray(xs))
    _close(load_flax_params(LayerNorm(32, device="cpu"), params)(_t(xs)), want)
    res = rng.normal(size=x.shape).astype(np.float32)
    want = JRes(rate=0.1).apply({"params": params}, jnp.asarray(xs),
                                jnp.asarray(res), True)
    port = load_flax_params(
        ResidualDropoutLayerNorm(32, torch.float32, device="cpu"), params)
    _close(port(_t(xs), _t(res)), want)


def test_visual_embedding():
    from vlpet_tpu.models.visual import VisualEmbedding as JMod
    from vlpet_tpu_torch.models.visual import VisualEmbedding

    rng = np.random.default_rng(3)
    vis = VisConfig(feat_dim=24, n_boxes=6)
    feats = rng.normal(size=(2, 6, 24)).astype(np.float32)
    boxes = rng.uniform(size=(2, 6, 4)).astype(np.float32)
    table = rng.normal(size=(40, 32)).astype(np.float32)
    jmod = JMod(vis, 32)
    params = _init(jmod, jnp.asarray(feats), jnp.asarray(boxes),
                   jnp.asarray(table))
    port = load_flax_params(
        VisualEmbedding(pc.VisConfig(**dataclasses.asdict(vis)), 32,
                        device="cpu"), params)
    want = jmod.apply({"params": params}, jnp.asarray(feats),
                      jnp.asarray(boxes), jnp.asarray(table))
    _close(port(_t(feats), _t(boxes), _t(table)), want)


def test_downsample_vis_matches_jax():
    from vlpet_tpu.models.visual import downsample_vis as jdown
    from vlpet_tpu_torch.models.visual import downsample_vis

    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 49, 8)).astype(np.float32)
    boxes = rng.uniform(size=(2, 49, 4)).astype(np.float32)
    for oned, n in ((False, 9), (False, 16), (True, 10)):
        want = jdown((jnp.asarray(feats), jnp.asarray(boxes)), n, oned=oned)
        got = downsample_vis((_t(feats), _t(boxes)), n, oned=oned)
        for g, w in zip(got, want):
            _close(g, w)


def test_encoder_layer_vlpet_hooks():
    """A whole encoder layer: fused QKV, masked attention, the multihead
    down adapter + low-rank gate after both sublayers, FFN, LayerNorms."""
    from vlpet_tpu.models.bart import BartEncoderLayer as JLayer
    from vlpet_tpu.models.bart import expand_mask as jexpand
    from vlpet_tpu.pet.modules import PetContext as JCtx
    from vlpet_tpu_torch.models.bart import BartEncoderLayer, expand_mask
    from vlpet_tpu_torch.pet.modules import PetContext

    cfg = VLModelConfig(
        backbone=BartConfig(d_model=32, encoder_attention_heads=4,
                            encoder_ffn_dim=64),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8))
    rng = np.random.default_rng(5)
    h = rng.normal(size=(3, 7, 32)).astype(np.float32)
    m = np.ones((3, 7), np.int32)
    m[1, 5:] = 0
    jmask = jexpand(jnp.asarray(m), 1, jnp.float32)
    jlayer = JLayer(cfg)
    params = _init(jlayer, jnp.asarray(h), jmask, JCtx())
    # move every leaf off its init value so biases and gates matter
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)
    port = load_flax_params(BartEncoderLayer(_port_cfg(cfg), device="cpu"),
                            params)
    want = jlayer.apply({"params": params}, jnp.asarray(h), jmask, JCtx())
    with torch.no_grad():  # the fused FFN's weights are frozen
        got = port(_t(h), expand_mask(_t(m), 1, torch.float32), PetContext())
    _close(got, want)


def test_converter_rejects_mismatched_trees(x):
    from vlpet_tpu.pet.modules import GateLargeXLowRank as JMod
    from vlpet_tpu_torch.pet.modules import GateLargeXLowRank

    params = _init(JMod(32, 8), jnp.asarray(x))
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not placed"):
        load_flax_params(GateLargeXLowRank(32, 8, device="cpu"), extra)
    missing = {"down": params["down"]}
    with pytest.raises(ValueError, match="unset"):
        load_flax_params(GateLargeXLowRank(32, 8, device="cpu"), missing)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_params(GateLargeXLowRank(32, 4, device="cpu"), params)


def test_unported_flags_raise_at_build():
    from vlpet_tpu_torch.models.vlbart import VLBart

    base = pc.VLModelConfig(backbone=pc.BartConfig(vocab_size=64, d_model=32,
                                             encoder_layers=1, decoder_layers=1,
                                             encoder_attention_heads=4,
                                             decoder_attention_heads=4,
                                             encoder_ffn_dim=64,
                                             decoder_ffn_dim=64),
                         vis=pc.VisConfig(feat_dim=8, n_boxes=2),
                         pet=pc.vlpet_recipe("large", r=8, num_heads=4,
                                             gate_dim=8))
    VLBart(base, device="cpu")  # the slice itself builds

    for change in (dict(scan_layers=True), dict(classifier=True),
                   dict(remat="dots"),
                   dict(pet=dataclasses.replace(base.pet, use_lora=True)),
                   dict(pet=dataclasses.replace(base.pet, decoder_prompt_len=2)),
                   dict(pet=pc.vlpet_recipe("small", r=8, num_heads=4)),
                   dict(pet=pc.PetConfig(use_adapter=True)),
                   dict(vis=dataclasses.replace(base.vis,
                                                use_lowrank_visual_projector=True))):
        with pytest.raises(NotImplementedError):
            VLBart(dataclasses.replace(base, **change), device="cpu")
