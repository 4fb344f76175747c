"""The port's HF importer (vlpet_tpu_torch/models/hf_import.py) against the
JAX package's (vlpet_tpu/models/hf_import.py) and against HF itself, on the
CPU, with random-init HF models built from configs (no download): BART
(with and without LoRA on q / v) and T5 in its relu / tied and gated /
untied forms, each with a model vocabulary larger than the checkpoint's
(the tokenizer's added <vis_extra_id_*> rows).

* the port's import equals the JAX import after conversion, tensor for
  tensor, with the same filled / skipped report;
* the grown vocabulary rows keep their init;
* text-only logits match the HF model's (the second oracle, at the JAX
  package's own HF tolerance, tests/test_hf_parity.py);
* ``.bin`` and ``.safetensors`` files load equal, and the port's
  safetensors reader equals ``safetensors.numpy.load_file`` (and the
  torch loader for bf16);
* a ``Trainer(backbone_ckpt=...)`` on the CPU starts from the JAX
  Trainer's parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from vlpet_tpu.config import (BartConfig, PetConfig, T5Config,  # noqa: E402
                              VisConfig, VLModelConfig)
from vlpet_tpu.models import hf_import as jimp  # noqa: E402
from vlpet_tpu.models.t5 import VLT5 as JVLT5  # noqa: E402
from vlpet_tpu.models.vlbart import VLBart as JVLBart  # noqa: E402
from vlpet_tpu.pet.modules import PetContext as JCtx  # noqa: E402
from vlpet_tpu_torch import config as pc  # noqa: E402
from vlpet_tpu_torch.convert import (flax_path, flax_to_state_dict,  # noqa
                                     load_flax_params)
from vlpet_tpu_torch.models import hf_import as timp  # noqa: E402
from vlpet_tpu_torch.models.t5 import VLT5  # noqa: E402
from vlpet_tpu_torch.models.vlbart import VLBart  # noqa: E402
from vlpet_tpu_torch.pet.modules import PetContext  # noqa: E402

torch.set_num_threads(2)  # several xdist workers share the host

HF_V = {"bart": 99, "t5": 80}  # the checkpoint's vocabulary
GROW = 11  # rows the model's vocabulary adds


def _hf(kind):
    torch.manual_seed(0)
    if kind.startswith("bart"):
        cfg = transformers.BartConfig(
            vocab_size=HF_V["bart"], d_model=32, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_position_embeddings=48, pad_token_id=1, bos_token_id=0,
            eos_token_id=2, decoder_start_token_id=2,
            activation_function="gelu", dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, scale_embedding=False,
            attn_implementation="eager")
        hf = transformers.BartForConditionalGeneration(cfg).eval()
        with torch.no_grad():  # a nonzero bias, so its copy is seen
            hf.final_logits_bias.normal_()
        return hf
    gated = kind == "t5_gated_untied"
    cfg = transformers.T5Config(
        vocab_size=HF_V["t5"], d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4, dropout_rate=0.0,
        feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings=not gated, pad_token_id=0, eos_token_id=1,
        decoder_start_token_id=0, attn_implementation="eager")
    return transformers.T5ForConditionalGeneration(cfg).eval()


def _jax_cfg(kind) -> VLModelConfig:
    vis = VisConfig(no_vis=True)
    if kind.startswith("bart"):
        return VLModelConfig(
            backbone=BartConfig(vocab_size=HF_V["bart"] + GROW, d_model=32,
                                encoder_layers=2, decoder_layers=2,
                                encoder_attention_heads=4,
                                decoder_attention_heads=4, encoder_ffn_dim=64,
                                decoder_ffn_dim=64,
                                max_position_embeddings=48, dropout=0.0),
            vis=vis, pet=PetConfig(use_lora=kind == "bart_lora"))
    gated = kind == "t5_gated_untied"
    extra = (dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)
             if gated else {})
    return VLModelConfig(
        backbone=T5Config(vocab_size=HF_V["t5"] + GROW, d_model=32, d_kv=8,
                          d_ff=64, num_layers=2, num_decoder_layers=2,
                          num_heads=4, dropout_rate=0.0, **extra),
        vis=vis, pet=PetConfig())


def _port_cfg(jcfg) -> pc.VLModelConfig:
    d = dataclasses.asdict(jcfg)
    b = d.pop("backbone")
    backbone = (pc.T5Config if jcfg.is_t5 else pc.BartConfig)(**b)
    return pc.VLModelConfig(backbone=backbone, vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


KINDS = ["bart", "bart_lora", "t5_relu_tied", "t5_gated_untied"]


@pytest.fixture(scope="module", params=KINDS)
def imported(request):
    """(kind, hf, jcfg, the JAX init params, the JAX import and report,
    the port model after its import and its report, the init port state)."""
    kind = request.param
    hf = _hf(kind)
    jcfg = _jax_cfg(kind)
    jmodel = (JVLT5 if jcfg.is_t5 else JVLBart)(jcfg)
    init = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), labels=jnp.ones((2, 3), jnp.int32),
        ctx=JCtx())["params"])())
    conv = jimp.t5_hf_to_flax if jcfg.is_t5 else jimp.bart_hf_to_flax
    sd = hf.state_dict()
    jparams, jrep = conv(sd, init)
    port = load_flax_params((VLT5 if jcfg.is_t5 else VLBart)(
        _port_cfg(jcfg), device="cpu"), init)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    tconv = timp.t5_hf_to_port if jcfg.is_t5 else timp.bart_hf_to_port
    rep = tconv(sd, port)
    return kind, hf, jcfg, jmodel, jparams, jrep, port, rep, before


def test_import_matches_jax(imported):
    kind, hf, jcfg, jmodel, jparams, jrep, port, rep, _ = imported
    assert rep["skipped"] == jrep["skipped"]
    assert ["/".join(flax_path(n)[0]) for n in rep["filled"]] == jrep["filled"]
    assert rep["filled"], kind
    want = flax_to_state_dict(jparams)
    own = port.state_dict()
    assert set(want) == set(own)
    for k, v in want.items():
        assert torch.equal(own[k], v), k
    if kind == "bart_lora":
        assert "model.encoder.layers_0.self_attn.q_proj.base.weight" in \
            rep["filled"]


def test_grown_rows_keep_init(imported):
    kind, hf, jcfg, _, _, _, port, _, before = imported
    V = HF_V["t5" if jcfg.is_t5 else "bart"]
    own = port.state_dict()
    grown = {"model.shared": 0}
    if jcfg.is_t5 and not jcfg.backbone.tie_word_embeddings:
        grown["lm_head.weight"] = 0
    if not jcfg.is_t5:
        grown["final_logits_bias"] = 1
    sd = hf.state_dict()
    for name, axis in grown.items():
        tail = [slice(None)] * own[name].dim()
        tail[axis] = slice(V, None)
        assert torch.equal(own[name][tuple(tail)], before[name][tuple(tail)])
        head = [slice(None)] * own[name].dim()
        head[axis] = slice(0, V)
        src = {"model.shared": "model.shared.weight" if not jcfg.is_t5
               else "shared.weight", "lm_head.weight": "lm_head.weight",
               "final_logits_bias": "final_logits_bias"}[name]
        assert torch.equal(own[name][tuple(head)], sd[src]), name


def test_text_only_logits_match_hf(imported):
    kind, hf, jcfg, _, _, _, port, _, _ = imported
    V = HF_V["t5" if jcfg.is_t5 else "bart"]
    rng = np.random.default_rng(0)
    B, L, T = 2, 7, 5
    input_ids = rng.integers(3, V, (B, L))
    if not jcfg.is_t5:
        input_ids[:, -1] = 2
    attn = np.ones((B, L), np.int64)
    attn[1, -2:] = 0
    labels = rng.integers(3, V, (B, T))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(input_ids),
                  attention_mask=torch.tensor(attn),
                  labels=torch.tensor(labels)).logits.numpy()
        got = port(torch.tensor(input_ids), torch.tensor(attn),
                   labels=torch.tensor(labels), ctx=PetContext())["logits"]
    np.testing.assert_allclose(got[..., :V].numpy(), want, rtol=2e-4,
                               atol=2e-5)


def test_bin_and_safetensors_load_equal(tmp_path):
    """torch.save (.bin) and safetensors (.safetensors) of one HF state dict
    load equal through load_torch_state_dict; the port's reader equals
    safetensors' numpy loader, and its torch loader for bf16 / fp16 / int
    tensors."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as t_load, save_file

    sd = {k: v.clone().contiguous() for k, v in _hf("bart").state_dict().items()}
    torch.save(sd, tmp_path / "m.bin")
    save_file(sd, str(tmp_path / "m.safetensors"))
    a = timp.load_torch_state_dict(str(tmp_path / "m.bin"))
    b = timp.load_torch_state_dict(str(tmp_path / "m.safetensors"))
    ref = np_load(str(tmp_path / "m.safetensors"))
    assert set(a) == set(b) == set(ref) == set(sd)
    for k in sd:
        assert torch.equal(a[k], sd[k]) and torch.equal(b[k], sd[k]), k
        np.testing.assert_array_equal(b[k].numpy(), ref[k])
    g = torch.Generator().manual_seed(3)
    mixed = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "f16": torch.randn(7, generator=g).half(),
             "f64": torch.randn(2, 2, generator=g).double(),
             "i64": torch.arange(6).reshape(2, 3),
             "i32": torch.arange(4, dtype=torch.int32),
             "u8": torch.arange(5, dtype=torch.uint8),
             "bool": torch.tensor([True, False, True]),
             "scalar": torch.tensor(2.5)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"),
              metadata={"format": "pt"})
    got = timp.read_safetensors(str(tmp_path / "mixed.safetensors"))
    want = t_load(str(tmp_path / "mixed.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_trainer_backbone_ckpt_matches_jax(tmp_path, monkeypatch):
    """Trainer(backbone_ckpt=<.safetensors>) on the CPU, in both packages,
    from one JAX init of the PET parameters (``load`` of an npz without the
    backbone tensors, so the import is what fills the backbone): every
    parameter of the port trainer equals the JAX trainer's. The model's
    vocabulary is the checkpoint's here (grown rows would keep two inits).
    The JAX Trainer's model init runs jitted (the same values, one
    compile instead of one a layer)."""
    from safetensors.torch import save_file

    from vlpet_tpu.config import vlpet_recipe
    from vlpet_tpu.train.trainer import Trainer as JTrainer

    from vlpet_tpu_torch.train.trainer import Trainer

    hf = _hf("bart")
    ckpt = str(tmp_path / "bart.safetensors")
    save_file({k: v.clone().contiguous() for k, v in hf.state_dict().items()},
              ckpt)
    tasks = ("vqa", "caption")
    base = _jax_cfg("bart")
    jcfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone,
                                           vocab_size=HF_V["bart"]),
        vis=VisConfig(feat_dim=8, n_boxes=4),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=tasks))
    eager_init = JVLBart.init

    def jitted_init(self, rng, *args, **kw):
        return jax.jit(lambda r: eager_init(self, r, *args, **kw))(rng)

    monkeypatch.setattr(JVLBart, "init", jitted_init)
    jmodel = JVLBart(jcfg)
    init = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), vis_feats=jnp.ones((2, 4, 8)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=JCtx())["params"])())
    _, jrep = jimp.bart_hf_to_flax(hf.state_dict(), init)
    filled = set(jrep["filled"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(init)[0]}
    npz = str(tmp_path / "pet.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in flat.items()
                     if k not in filled})
    kw = dict(lr=1e-3, total_steps=2, backbone_ckpt=ckpt, load=npz,
              verbose=False)
    jt = JTrainer(jcfg, tasks, **kw)
    pt = Trainer(_port_cfg(jcfg), tasks, device="cpu", **kw)
    want = flax_to_state_dict(jax.device_get(jt.merged_params))
    got = pt.named_weights()
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
