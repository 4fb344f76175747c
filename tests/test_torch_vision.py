"""The port's CLIP trunks, importer and extractor (vlpet_tpu_torch/vision/)
against the JAX package's (vlpet_tpu/vision/) on the CPU.

The same seeded numpy inputs go through both; the JAX variables (with the
BatchNorm scales, biases and statistics spread away from their identity
init) are carried into the port by ``convert.load_flax_params(...,
vision=True)``. Modules and features agree within 1e-5 * (1 + max|jax|) in
fp32; the importer's filled tensors and report, the extractor's index,
``preprocess_image``'s bytes and the BPE ids are identical.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.vision.clip as jclip
import vlpet_tpu_torch.vision.clip as tclip
from vlpet_tpu_torch.convert import (attention_heads, flax_leaves,
                                     flax_to_state_dict, load_flax_params)


def _close(got, want, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = 1e-5 * (1.0 + np.abs(want).max())
    assert err <= tol, f"{what}: max |port - jax| {err:.3e} > {tol:.3e}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@torch.no_grad()
def _seeded(module, seed=0):
    """``module`` with the trunk's seeded init, then every BatchNorm /
    LayerNorm weight, bias and statistic and every dense bias moved off its
    init."""
    g = torch.Generator().manual_seed(seed)
    tclip.init_clip_weights(module, g)
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        noise = torch.randn(t.shape, generator=g)
        if leaf == "running_var":
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
        elif t.dim() == 1 and leaf == "weight":
            t.copy_(1.0 + 0.1 * noise)
        elif leaf in ("bias", "in_proj_bias", "running_mean"):
            t.copy_(0.1 * noise)
    return module


def _flax_vars(port, root=()):
    """The flax variables {"params", "batch_stats"} of a port trunk module
    (convert.flax_leaves), under the path ``root``."""
    heads = attention_heads(port)
    out = {"params": {}, "batch_stats": {}}
    for name, t in port.state_dict().items():
        coll = "batch_stats" if name.endswith(("running_mean",
                                               "running_var")) else "params"
        for path, arr in flax_leaves(name, t, vision=True,
                                     heads=heads.get(name)):
            node = out[coll]
            for k in root + path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = arr
    return {k: v for k, v in out.items() if v}


def _pair(jmod, tmod, seed=0):
    """(JAX variables, the port module carrying them): the port module's
    seeded weights as a flax tree (the port -> flax direction), loaded back
    into a fresh module by load_flax_params (flax -> port), which must give
    every tensor back."""
    src = _seeded(tmod(), seed)
    variables = _flax_vars(src)
    port = load_flax_params(tmod(), variables["params"],
                            variables.get("batch_stats"), vision=True)
    for k, v in src.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    return variables, port


def _apply(jmod, variables, x):
    return jax.jit(jmod.apply)(variables, jnp.asarray(x))


@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
@pytest.mark.parametrize("use_bn", [True, False])
def test_visual_adapter(kind, use_bn):
    x = np.random.default_rng(1).normal(size=(2, 5, 5, 16)).astype(np.float32)
    jmod = jclip.VisualAdapter(16, 32, kind, 4, use_bn)
    variables, port = _pair(jmod, lambda: tclip.VisualAdapter(
        16, 32, kind, 4, use_bn, device="cpu"))
    want = _apply(jmod, variables, x)
    got = port(_nchw(x))
    _close(got.permute(0, 2, 3, 1), want, f"{kind} bn={use_bn}")


@pytest.mark.parametrize("pos", [None, "front", "middle", "back",
                                 "transition"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("use_bn", [True, False])
def test_bottleneck(pos, stride, use_bn):
    """Each adapter position at stride 1 and 2, with and without the
    adapters' BatchNorms; without an adapter at stride 1 the block keeps
    its identity path (inplanes = 4 * planes: no downsample)."""
    inplanes = 32 if pos is None else 16
    atype = f"{pos}-bottleneck" if pos else None
    x = np.random.default_rng(2).normal(size=(2, 6, 6, inplanes)).astype(
        np.float32)
    jmod = jclip.Bottleneck(inplanes, 8, stride, atype, 2, use_bn)
    variables, port = _pair(jmod, lambda: tclip.Bottleneck(
        inplanes, 8, stride, atype, 2, use_bn, device="cpu"))
    want = _apply(jmod, variables, x)
    assert hasattr(port, "downsample") == (stride > 1 or inplanes != 32)
    _close(port(_nchw(x)).permute(0, 2, 3, 1), want, f"{pos} s{stride}")


@pytest.mark.parametrize("grid", [3, 4])
def test_attention_pool(grid):
    """num_positions 10 (a 3x3 grid + the mean token): at grid 4 the
    positional embedding is resized to 17 inside the forward."""
    x = np.random.default_rng(3).normal(size=(2, grid, grid, 32)).astype(
        np.float32)
    jmod = jclip.AttentionPool2d(32, 4, 16, num_positions=10)
    variables, port = _pair(jmod, lambda: tclip.AttentionPool2d(
        32, 4, 16, num_positions=10, device="cpu"))
    want = _apply(jmod, variables, x)
    _close(port(_nchw(x)), want, f"grid {grid}")


@pytest.mark.parametrize("new_g", [14, 5])
def test_resize_pos_embed(new_g):
    """jax.image.resize's cubic (Keys a = -0.5, antialiased when shrinking)
    in plain torch: 7 -> 14 grows, 7 -> 5 shrinks; the CLS row is kept."""
    pos = np.random.default_rng(4).normal(size=(50, 24)).astype(np.float32)
    want = jclip.resize_pos_embed(jnp.asarray(pos), new_g * new_g + 1)
    got = tclip.resize_pos_embed(torch.from_numpy(pos), new_g * new_g + 1)
    _close(got, want, f"7 -> {new_g}")
    assert torch.equal(got[0], torch.from_numpy(pos[0]))


def _tiny_resnet(pkg, **kw):
    return pkg.ModifiedResNet(layers=(1, 1, 1, 1), output_dim=32, heads=8,
                              input_resolution=64, width=16,
                              adapter_type="middle-bottleneck",
                              reduction_factor=2, **kw)


def _tiny_vit(pkg, **kw):
    return pkg.VisualTransformer(input_resolution=64, patch_size=16,
                                 width=32, layers=2, heads=4, output_dim=16,
                                 **kw)


@pytest.mark.parametrize("which", ["resnet", "vit"])
def test_tiny_trunk(which):
    """A tiny ModifiedResNet (layers (1, 1, 1, 1), width 16, middle
    bottleneck adapters) and a tiny ViT (width 32, 2 layers, 4 heads)
    carried across by convert.py both ways: grid and pooled outputs."""
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    make = _tiny_resnet if which == "resnet" else _tiny_vit
    jmod = make(jclip)
    variables, port = _pair(jmod, lambda: make(tclip, device="cpu"))
    grid, pooled = _apply(jmod, variables, x)
    g, p = port(_nchw(x))
    if which == "resnet":
        g = g.permute(0, 2, 3, 1)
    _close(g, grid, "grid")
    _close(p, pooled, "pooled")


@pytest.fixture(scope="module")
def rn50():
    """CLIPVisualEncoder RN50 at 64 px: the JAX module, its variables and
    the port encoder holding them."""
    enc = jclip.CLIPVisualEncoder(backbone="RN50", image_size=64)
    variables, port = _pair(enc, lambda: tclip.CLIPVisualEncoder(
        "RN50", 64, device="cpu"), seed=7)
    return enc, variables, port


def test_rn50_encoder(rn50):
    enc, variables, port = rn50
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    grid, pooled = _apply(enc, variables, x)
    g, p = port(_nchw(x))
    assert g.shape == (2, 4, 2048) and p.shape == (2, 1, 1024)
    _close(g, grid, "grid")
    _close(p, pooled, "pooled")


def _openai_dict(which):
    """A seeded OpenAI-CLIP-named visual state dict for the tiny trunk,
    torch layouts: the ResNet's from a 96 px trunk (its attention pool's
    10 positions resized to the model's 5, in the patched (1, N, C) form),
    plus keys either importer passes over or skips."""
    torch.manual_seed(11)
    if which == "resnet":
        src = tclip.ModifiedResNet(layers=(1, 1, 1, 1), output_dim=32,
                                   heads=8, input_resolution=96, width=16,
                                   device="cpu")
    else:
        src = _tiny_vit(tclip, device="cpu")
    sd = {}
    for k, v in src.state_dict().items():
        v = torch.randn(v.shape) * 0.1 + (1.0 if k.endswith("running_var")
                                          else 0.0)
        if k == "attnpool.positional_embedding":
            v = v[None]
        sd["visual." + k] = v
    sd["visual.proj"] = torch.randn(32, 16)
    sd["visual.layer1.0.bn1.num_batches_tracked"] = torch.tensor(3)
    sd["visual.layer1.0.unknown.weight"] = torch.randn(3)
    sd["visual.mystery"] = torch.randn(2)
    sd["transformer.resblocks.0.ln_1.weight"] = torch.randn(8)  # text tower
    return sd


@pytest.mark.parametrize("which", ["resnet", "vit"])
def test_clip_import(which):
    """load_clip_state_dict against clip_torch_to_flax on one seeded
    OpenAI-named dict: the same tensors after conversion, the same
    filled / skipped report."""
    from vlpet_tpu.vision.clip_import import clip_torch_to_flax

    from vlpet_tpu_torch.vision.clip_import import load_clip_state_dict

    make = _tiny_resnet if which == "resnet" else _tiny_vit
    # the JAX importer's template: the trunk's variables under "visual"
    variables = _flax_vars(_seeded(make(tclip, device="cpu")), ("visual",))
    sd = _openai_dict(which)
    want_vars, want = clip_torch_to_flax(sd, variables)

    port = torch.nn.Module()  # the same seeded trunk as the template
    port.visual = _seeded(make(tclip, device="cpu"))
    got = load_clip_state_dict(port, sd)
    assert got == want
    assert want["skipped"] and want["filled"]
    ref = flax_to_state_dict(want_vars["params"],
                             want_vars.get("batch_stats"), vision=True)
    own = port.state_dict()
    assert set(ref) == set(own)
    for k, v in ref.items():
        if k.endswith("attnpool.positional_embedding"):  # resized: fp32 sums
            _close(own[k], v.numpy(), k)
        else:
            np.testing.assert_array_equal(own[k].numpy(), v.numpy(),
                                          err_msg=k)


@pytest.fixture(scope="module")
def five_images():
    rng = np.random.default_rng(0)
    return {f"img{i}": (rng.uniform(0, 255, (80, 96, 3))).astype(np.uint8)
            for i in range(5)}


def test_preprocess_image_identical(five_images):
    from vlpet_tpu.vision.extract import preprocess_image as jpre

    from vlpet_tpu_torch.vision.extract import preprocess_image as tpre

    small = np.random.default_rng(9).uniform(0, 255, (30, 50, 3)).astype(
        np.uint8)
    for img in list(five_images.values()) + [small]:
        for size in (64, 224):
            want, got = jpre(img, size), tpre(img, size)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_extract_features(tmp_path, rn50, five_images):
    """extract_features on five PIL-preprocessed images, batch 2, with the
    same RN50 weights: the index identical, the features within
    tolerance, PackedFeatureSource reading back the port's."""
    from vlpet_tpu.vision.extract import extract_features as jext

    from vlpet_tpu_torch.data.features import PackedFeatureSource
    from vlpet_tpu_torch.vision.extract import extract_features as text

    _, variables, port = rn50
    ids = list(five_images)
    jext(lambda i: five_images[i], ids, str(tmp_path / "jax"),
         backbone="RN50", image_size=64, batch_size=2,
         clip_variables=variables)
    text(lambda i: five_images[i], ids, str(tmp_path / "port"),
         backbone="RN50", image_size=64, batch_size=2, encoder=port,
         device="cpu")
    for suffix in ("_index.json",):
        assert (json.loads((tmp_path / f"port{suffix}").read_text())
                == json.loads((tmp_path / f"jax{suffix}").read_text()))
    _close(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"),
           "features")
    np.testing.assert_array_equal(np.load(tmp_path / "port_boxes.npy"),
                                  np.load(tmp_path / "jax_boxes.npy"))
    f, b = PackedFeatureSource(str(tmp_path / "port")).get("img3")
    assert f.shape == (4, 2048) and b.shape == (4, 4)


def test_clip_tokenizer_identical(tmp_path):
    from vlpet_tpu.vision.clip_tokenizer import ClipBPETokenizer as J

    from vlpet_tpu_torch.vision.clip_tokenizer import ClipBPETokenizer as T

    merges = tmp_path / "merges.txt"
    merges.write_text("#version: fixture\nc a\nca t</w>\nd o\ndo g</w>\n")
    j, t = J(str(merges)), T(str(merges))
    texts = ["Cat  DOG", "ox", "a cat's dog, 42!", "caté &amp; dog"]
    for s in texts:
        assert t.encode(s) == j.encode(s)
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    np.testing.assert_array_equal(t(texts, context_length=12, truncate=True),
                                  j(texts, context_length=12, truncate=True))
    assert (t.vocab_size, t.sot_id, t.eot_id) == (j.vocab_size, j.sot_id,
                                                 j.eot_id)
