"""The classifier answer head of the port against the JAX package's, on CPU.

* ``AnswerHead``, ``classify`` and ``forward``'s "answer_logits" on a
  tiny BART and a tiny T5 (seeded normal(0, 0.2) weights of the JAX tree,
  carried by vlpet_tpu_torch.convert), and ``classifier_bce_loss``, within
  1e-5 * (1 + max|jax|).
* A 3-step lockstep of the port's Trainer and the JAX Trainer on the setup
  of tests/test_train_step.py's classifier test (BART d 32, 2+2 layers,
  VL-PET-large r 8, dropout 0, an answer vocabulary of 3; here batch 8 for
  the JAX Trainer's 8 CPU devices): per-step BCE losses within 1e-5
  relative and the trainable tensors within rtol 1e-3, atol 1e-5 *
  max|p|; then ``predict_classifier`` and ``evaluate`` give identical
  answers and scores.
* The trainable set under each recipe equals the JAX freezing engine's
  (``answer_head`` trains only where a rule names it), and the head
  crosses both ways through LAST.npz.
* ``cli.multitask.main`` with ``--classifier`` against the JAX main on one
  argv (tests/test_torch_cli.py's tiny backbone, one ``--load``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import (BartConfig, PetConfig, T5Config, VisConfig,
                              VLModelConfig, vlpet_recipe)
from vlpet_tpu.data import datasets as jds
from vlpet_tpu.data.tokenization import WhitespaceTokenizer
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train import checkpoint as jckpt
from vlpet_tpu.train.freezing import trainable_mask
from vlpet_tpu_torch.convert import (flax_path, flax_to_state_dict,
                                     load_flax_params)
from vlpet_tpu_torch.data import datasets as tds
from vlpet_tpu_torch.models.heads import classifier_bce_loss
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train import checkpoint as tckpt
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.trainer import Trainer

from test_torch_gates import port_cfg

torch.set_num_threads(2)  # several xdist workers share the host

TASKS = ("vqa", "caption")
ANS2LABEL = {"yes": 0, "no": 1, "2": 2}
BS = 8


def _bart(classifier=True, pet=None):
    return VLModelConfig(
        backbone=BartConfig(vocab_size=60, d_model=32, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=32,
                            dropout=0.0),
        vis=VisConfig(feat_dim=16, n_boxes=4),
        pet=pet or vlpet_recipe("large", r=8, num_heads=4, gate_dim=8,
                                tasks=TASKS),
        classifier=classifier, num_answers=len(ANS2LABEL))


def _t5(pet=None):
    return VLModelConfig(
        backbone=T5Config(vocab_size=60, d_model=32, num_layers=2,
                          num_decoder_layers=2, num_heads=4, d_kv=8, d_ff=64,
                          dropout_rate=0.0),
        vis=VisConfig(feat_dim=16, n_boxes=4),
        pet=pet or vlpet_recipe("large", r=8, num_heads=4, gate_dim=8,
                                tasks=TASKS),
        classifier=True, num_answers=len(ANS2LABEL))


def _models(jcfg):
    if jcfg.is_t5:
        from vlpet_tpu.models.t5 import VLT5 as J
        from vlpet_tpu_torch.models.t5 import VLT5 as T
    else:
        from vlpet_tpu.models.vlbart import VLBart as J
        from vlpet_tpu_torch.models.vlbart import VLBart as T
    return J(jcfg), T(port_cfg(jcfg), device="cpu")


def _inputs(B=4, T=6):
    rng = np.random.default_rng(3)
    mask = np.ones((B, T), np.int32)
    mask[1, T - 2:] = 0
    return dict(input_ids=rng.integers(3, 60, (B, T)).astype(np.int32),
                attention_mask=mask,
                vis_feats=rng.normal(size=(B, 4, 16)).astype(np.float32),
                boxes=rng.uniform(size=(B, 4, 4)).astype(np.float32))


def _init(jmodel, b):
    """Seeded normal(0, 0.2) parameters of the JAX model's tree (its shapes
    from jax.eval_shape: nothing compiles)."""
    j = {k: jnp.asarray(v) for k, v in b.items()}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), j["input_ids"], j["attention_mask"],
        vis_feats=j["vis_feats"], boxes=j["boxes"],
        labels=j["input_ids"][:, :3], ctx=JCtx())["params"])
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(s.dtype), shapes)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(want).max()))


@pytest.mark.parametrize("backbone", ["bart", "t5"])
def test_answer_head_classify_match_jax(backbone):
    jcfg = _bart() if backbone == "bart" else _t5()
    jmodel, model = _models(jcfg)
    b = _inputs()
    params = _init(jmodel, b)
    load_flax_params(model, params)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v).long() if v.dtype == np.int32
         else torch.from_numpy(v) for k, v in b.items()}
    ctx, jctx = PetContext(task="vqa"), JCtx(task="vqa")
    dec_ids = b["input_ids"][:, :3]

    @jax.jit
    def jax_side(p):
        """classify, and forward's answer_logits: one compile."""
        common = dict(vis_feats=j["vis_feats"], boxes=j["boxes"], ctx=jctx)
        return (jmodel.apply({"params": p}, j["input_ids"],
                             j["attention_mask"], **common,
                             method=type(jmodel).classify),
                jmodel.apply({"params": p}, j["input_ids"],
                             j["attention_mask"], **common,
                             decoder_input_ids=jnp.asarray(dec_ids)
                             )["answer_logits"])

    want, want_fwd = jax_side(params)
    with torch.no_grad():
        got = model.classify(t["input_ids"], t["attention_mask"],
                             t["vis_feats"], t["boxes"], ctx=ctx)
    assert got.shape == (4, len(ANS2LABEL)) and got.dtype == torch.float32
    _close(got, want)
    # the head alone, and forward's answer_logits on the last decoder state
    dec = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    from vlpet_tpu.models.vlbart import AnswerHead as JHead
    jhead = JHead(32, len(ANS2LABEL), name="answer_head")
    _close(model.answer_head(torch.from_numpy(dec)),
           jhead.apply({"params": params["answer_head"]}, jnp.asarray(dec)))
    with torch.no_grad():
        out = model(t["input_ids"], t["attention_mask"], t["vis_feats"],
                    t["boxes"], decoder_input_ids=torch.from_numpy(
                        dec_ids).long(), ctx=ctx)
    _close(out["answer_logits"], want_fwd)


def test_bce_matches_jax():
    from vlpet_tpu.models.heads import classifier_bce_loss as jbce

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 7)) * 30).astype(np.float32)  # both tails
    tgt = rng.uniform(size=(5, 7)).astype(np.float32)
    tgt[0] = 0.0
    want = float(jbce(jnp.asarray(x), jnp.asarray(tgt)))
    got = float(classifier_bce_loss(torch.from_numpy(x),
                                    torch.from_numpy(tgt)))
    assert abs(got - want) <= 1e-5 * (1.0 + abs(want))
    got_bf16 = classifier_bce_loss(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(tgt))
    assert got_bf16.dtype == torch.float32


def _loader(ds_mod, tok, mode):
    examples, source = ds_mod.synthetic_task_data("vqa", 16, n_boxes=4,
                                                  feat_dim=16, seed=0)
    answers = list(ANS2LABEL)
    for i, ex in enumerate(examples):  # scores over the answer vocabulary
        ex["label"] = {answers[i % 3]: 1.0, answers[(i + 1) % 3]: 0.3}
    cfg = ds_mod.DatasetConfig(task="vqa", max_text_length=8,
                               gen_max_length=4, n_boxes=4, feat_dim=16,
                               classifier=True, ans2label=ANS2LABEL)
    ds = ds_mod.TaskDataset(cfg, examples, source, tok, mode=mode, seed=0)
    from vlpet_tpu_torch.evalsuite import VQAEvaluator
    return ds_mod.Loader(ds, BS, shuffle=False, drop_last=False,
                         evaluator=VQAEvaluator({e["question_id"]: e
                                                 for e in examples}),
                         prefetch=0)


def _jit_init(monkeypatch, cls):
    """The JAX model's ``init`` as one compiled program (the Trainer calls
    it eagerly, an XLA compile per op on the CPU): the same values."""
    init = cls.init

    def jitted(self, rng, *args, ctx=None, **kw):
        return jax.jit(lambda r, a, k: init(self, r, *a, ctx=ctx, **k))(
            rng, args, kw)

    monkeypatch.setattr(cls, "init", jitted)


def test_classifier_trainer_lockstep_and_predict_match_jax(monkeypatch):
    from vlpet_tpu.models.vlbart import VLBart as JVLBart
    from vlpet_tpu.train.trainer import Trainer as JTrainer

    _jit_init(monkeypatch, JVLBart)
    jcfg = _bart()
    tok = WhitespaceTokenizer(vocab_size=60)
    opt = dict(lr=1e-2, total_steps=4, warmup_ratio=0.1)
    jt = JTrainer(jcfg, TASKS, **opt, seed=5, tokenizer=tok, verbose=False)
    tt = Trainer(port_cfg(jcfg), TASKS, **opt, seed=5, tokenizer=tok,
                 verbose=False, device="cpu")
    load_flax_params(tt.model, jax.device_get(jt.merged_params))
    jl, tl = _loader(jds, tok, "train"), _loader(tds, tok, "train")
    jlosses, tlosses = [], []
    for _ in range(2):
        for jb, tb in zip(jl, tl):
            assert tb["target"].shape == (BS, len(ANS2LABEL))
            jlosses.append(float(jt.do_train_step(jb)["loss"]))
            tlosses.append(float(tt.do_train_step(tb)["loss"]))
            if len(tlosses) == 3:
                break
        if len(tlosses) == 3:
            break
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jt.state.params))
    assert set(want) == set(tt.trainable)
    for name, p in tt.trainable.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-3,
                                   atol=max(1e-8, 1e-5 * np.abs(w).max()),
                                   err_msg=name)
    # from the same weights: identical answers and scores
    load_flax_params(tt.model, jax.device_get(jt.merged_params))
    label2ans = {v: k for k, v in ANS2LABEL.items()}
    jv, tv = _loader(jds, tok, "val"), _loader(tds, tok, "val")
    want = jt.predict_classifier(jv, label2ans)["quesid2ans"]
    got = tt.predict_classifier(tv, label2ans)["quesid2ans"]
    assert got == want and len(got) == 16
    assert tt.evaluate(tv) == jt.evaluate(jv)


RECIPES = {
    "vlpet_large": None,
    "layer_norms": PetConfig(unfreeze_layer_norms=True, tasks=TASKS),
    "bias": PetConfig(unfreeze_bias=True, tasks=TASKS),
    "lora": PetConfig(use_lora=True, tasks=TASKS),
    "full_ft": PetConfig(unfreeze_language_model=True, tasks=TASKS),
}


@pytest.mark.parametrize("backbone", ["bart", "t5"])
def test_trainable_set_and_npz_both_ways(backbone, tmp_path):
    heads = set()
    for name, pet in RECIPES.items():
        jcfg = _bart(pet=pet) if backbone == "bart" else _t5(pet=pet)
        jmodel, model = _models(jcfg)
        params = _init(jmodel, _inputs(B=2))
        flat = {"/".join(str(k.key) for k in path): bool(m) for path, m in
                jax.tree_util.tree_flatten_with_path(
                    trainable_mask(params, jcfg.pet))[0]}
        names = [n for n, _ in model.named_parameters()]
        assert sorted(flat) == sorted("/".join(flax_path(n)[0])
                                      for n in names)
        want = {n for n in names if flat["/".join(flax_path(n)[0])]}
        got = set(apply_freezing(model, model.cfg.pet))
        assert got == want, name
        heads.add(frozenset(n for n in got if n.startswith("answer_head.")))
    assert len(heads) > 1  # some recipes train parts of the head
    # LAST.npz both ways, the head included
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(params, path)
    _, n = tckpt.load_params_npz(path, model)
    assert n == len(dict(model.named_parameters()))
    _close(model.answer_head.fc1.weight.t(),
           params["answer_head"]["fc1"]["kernel"])
    with torch.no_grad():
        model.answer_head.fc2.bias.add_(1.0)
    tckpt.save_params_npz(dict(model.named_parameters()),
                          str(tmp_path / "port.npz"))
    back, _ = jckpt.load_params_npz(str(tmp_path / "port.npz"), params)
    np.testing.assert_array_equal(
        np.asarray(back["answer_head"]["fc2"]["bias"]),
        model.answer_head.fc2.bias.detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(back["answer_head"]["mlp_layer_norm"]["scale"]),
        model.answer_head.mlp_layer_norm.scale.detach().numpy())
