"""The ranks of the port's data- and tensor-parallel tests
(test_torch_distributed.py, test_torch_distributed_eval.py,
test_torch_tensor_parallel.py, test_torch_tp_*.py), spawned by
vlpet_tpu_torch.parallel.launch.run_ranks over gloo on the CPU.

Every rank imports this module again, so it imports torch and the port
only (no JAX: the tests compute the JAX references in their own process).
Its helpers also compute the one-process runs the ranks are held to.
"""

import dataclasses
import os
import zlib

import torch

from vlpet_tpu_torch.config import BartConfig
from vlpet_tpu_torch.data.datasets import (DatasetConfig, Loader,
                                           TaskDataset, synthetic_task_data)
from vlpet_tpu_torch.data.multitask import MultitaskLoader
from vlpet_tpu_torch.data.tokenization import WhitespaceTokenizer
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.parallel.mesh import MeshConfig, build_mesh, shard_model
from vlpet_tpu_torch.parallel.multihost import data_shard
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step
from vlpet_tpu_torch.train.trainer import Trainer, check_task_order


# --- the training step --------------------------------------------------

def share(batch, rank: int, world: int):
    """The rank's contiguous share of a global batch of numpy arrays."""
    b = len(batch["input_ids"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def no_lora_dropout() -> None:
    """LoRA dropout 0 in this process (the JAX LoRADense draws its mask
    from jax.random: the JAX lockstep tests run LoRA without it)."""
    from vlpet_tpu_torch.config import PetConfig

    orig = PetConfig.lora_spec
    if not getattr(orig, "no_dropout", False):
        def spec(self):
            return dataclasses.replace(orig(self), lora_dropout=0.0)

        spec.no_dropout = True
        PetConfig.lora_spec = spec


TINY_RN = dict(layers=(1, 1, 1, 1), width=16, output_dim=32)


def build_model(cfg, raw=None):
    """The port's model of ``cfg`` on the CPU: VLBart / VLT5, or with
    ``raw`` (RawInputVLModel's keyword arguments) the raw-image model, the
    tiny CLIP ResNet "RN_tiny" registered as tests/test_torch_raw_path.py
    registers it."""
    if raw is None:
        return (VLT5 if cfg.is_t5 else VLBart)(cfg, device="cpu")
    import vlpet_tpu_torch.vision.clip as tclip
    from vlpet_tpu_torch.vision.vis_encoder import RawInputVLModel

    tclip._RESNET_CONFIGS.setdefault("RN_tiny", TINY_RN)
    return RawInputVLModel(cfg, device="cpu", **raw)


def run_steps(cfg, state, batch, tasks, task, steps, opt, accumulation=1,
              model_axis=1, lambda_z=0.0, lora_dropout0=False, raw=None):
    """``steps`` train steps of the model of ``cfg`` at ``state``, on this
    process's data shard of ``batch`` (the whole batch without a process
    group) under a (world / ``model_axis``, ``model_axis``) mesh, dropout
    seeds from generator seed 0, the optimizer updating every
    ``accumulation``-th step (``lambda_z``: the z regularizer;
    ``lora_dropout0``: LoRA at dropout 0; ``raw``: the raw-image model,
    ``build_model``). Returns the per-step losses and gradient norms, the
    trainable tensors at the end, gathered whole, and the shapes of the
    model's parameters on this rank."""
    from vlpet_tpu_torch.parallel.mesh import gather_state_dict

    if lora_dropout0:
        no_lora_dropout()
    layout = build_mesh(MeshConfig(model=model_axis))
    rank, world = layout.data_index, layout.data
    model = build_model(cfg, raw)
    model.load_state_dict(state)
    trainable = apply_freezing(model, cfg.pet)
    shard_model(model, layout)
    step = make_train_step(model, build_optimizer(trainable, **opt), tasks,
                           lambda_z=lambda_z, device="cpu",
                           accumulation_steps=accumulation)
    generator = torch.Generator().manual_seed(0)
    t = to_torch(share(batch, rank, world))
    losses, norms = [], []
    for _ in range(steps):
        out = step(t, generator, tasks.index(task))
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    whole = gather_state_dict({n: p.detach() for n, p in trainable.items()},
                              model)
    return {"losses": losses, "norms": norms,
            "params": {n: p.clone() for n, p in whole.items()},
            "local": {n: tuple(p.shape) for n, p in trainable.items()},
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def train_ranks(rank, world, cases):
    """``run_steps`` of each case (a dict of its arguments), in order."""
    return [run_steps(**case) for case in cases]


def generate(cfg, state, batch, tasks, task, model_axis=1, max_length=8,
             lora_dropout0=False, raw=None):
    """Beam-5 and greedy tokens of the model of ``cfg`` at ``state`` on
    this process's data shard of ``batch``, under a (world /
    ``model_axis``, ``model_axis``) mesh."""
    if lora_dropout0:
        no_lora_dropout()
    layout = build_mesh(MeshConfig(model=model_axis))
    model = build_model(cfg, raw)
    model.load_state_dict(state)
    shard_model(model, layout)
    t = to_torch(share(batch, layout.data_index, layout.data))
    keys = ("input_ids", "attention_mask", "vis_feats", "boxes")
    ctx = PetContext(task=task, task_idx=tasks.index(task))
    return {n: seq2seq_generate(model, **{k: t[k] for k in keys if k in t},
                                ctx=ctx, num_beams=n, max_length=max_length)
            for n in (5, 1)}


def tp_ranks(rank, world, train_cases, generate_cases=()):
    """``run_steps`` of each train case, then ``generate`` of each
    generation case."""
    return {"train": [run_steps(**case) for case in train_cases],
            "generate": [generate(**case) for case in generate_cases]}


# --- evaluation, checkpoints, the task order -----------------------------

class StableTokenizer(WhitespaceTokenizer):
    """The WhitespaceTokenizer with word ids from crc32, not from Python's
    per-process str hash: every rank and the test's own process agree."""

    def _tok2id(self, tok: str) -> int:
        h = 5 + zlib.crc32(tok.encode()) % (self.vocab_size - 10)
        while h in self._special:
            h += 1
        self._cache[h] = tok
        return h


EVAL_TASKS = ("vqa", "nlvr", "caption")


def tiny_trainer(output_dir=None, pet=None, **kw):
    """A tiny BART (d 32, 2+2 layers, vocab 60) with VL-PET-large (or the
    PetConfig ``pet``), fp32, dropout 0, on the CPU; seeded, so every
    process builds the same."""
    from vlpet_tpu_torch.config import VisConfig, VLModelConfig, vlpet_recipe

    cfg = VLModelConfig(
        backbone=BartConfig(vocab_size=60, d_model=32, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=32,
                            dropout=0.0),
        vis=VisConfig(feat_dim=16, n_boxes=4),
        pet=pet or vlpet_recipe("large", r=8, num_heads=4, gate_dim=8,
                                tasks=EVAL_TASKS))
    return Trainer(cfg, EVAL_TASKS, tokenizer=StableTokenizer(vocab_size=60),
                   output_dir=output_dir, verbose=False, device="cpu", **kw)


def loader(task: str, n: int, batch_size: int, train: bool = False):
    """This process's shard of ``n`` synthetic ``task`` examples, padded
    to fixed lengths (so every shard's batch has the global batch's
    shapes)."""
    from vlpet_tpu_torch.cli.multitask import make_evaluator

    shard, num_shards = data_shard()
    examples, source = synthetic_task_data(task, n, n_boxes=4, feat_dim=16)
    ds = TaskDataset(DatasetConfig(task=task, max_text_length=8,
                                   gen_max_length=6, n_boxes=4, feat_dim=16,
                                   pad_to_max=True),
                     examples, source, StableTokenizer(vocab_size=60),
                     mode="train" if train else "val")
    return Loader(ds, batch_size, shuffle=train, drop_last=train,
                  evaluator=make_evaluator(task, ds.examples), shard=shard,
                  num_shards=num_shards, prefetch=0)


def evaluate_all(trainer):
    """Beam-5 caption and greedy vqa predictions, the nlvr scoring, and
    the evaluators' scores, over 7 examples a task at batch 2 (shards of
    4 and 3 at world 2)."""
    cap, vqa, nlvr = (loader(t, 7, 2) for t in ("caption", "vqa", "nlvr"))
    return {"caption": trainer.predict(cap, num_beams=5, max_length=6),
            "vqa": trainer.predict(vqa, num_beams=1, max_length=6),
            "nlvr": trainer.predict_nlvr(nlvr),
            "scores": {ld.task: trainer.evaluate(ld, max_length=6)
                       for ld in (loader("caption", 7, 2),
                                  loader("vqa", 7, 2))}}


def train_caption(trainer, epochs: int, batch_size: int):
    """``trainer.train`` on this process's shard of 16 caption examples;
    the trainable tensors after it, whole (gathered over a model
    group)."""
    from vlpet_tpu_torch.parallel.mesh import gather_state_dict

    mt = MultitaskLoader([loader("caption", 16, batch_size, train=True)])
    trainer.train(mt, epochs=epochs, log_every=1000)
    whole = gather_state_dict({n: p.detach() for n, p in
                               trainer.trainable.items()}, trainer.model)
    return {n: p.clone() for n, p in whole.items()}


def eval_ranks(rank, world, out_dir):
    """The evaluation, the first training epoch (checkpointed under
    ``out_dir``) and a task order that differs on the last rank."""
    res = {"eval": evaluate_all(tiny_trainer())}
    trainer = tiny_trainer(output_dir=out_dir, lr=1e-2, total_steps=8)
    res["lead"] = trainer.lead
    res["epoch1"] = train_caption(trainer, epochs=1, batch_size=2)
    order = ["vqa", "caption"] + (["vqa"] if rank == world - 1 else [])
    try:
        check_task_order(order)
        res["order_check"] = None
    except RuntimeError as e:
        res["order_check"] = str(e)
    return res


# --- the four CLIs ---------------------------------------------------------

_UNPATCHED = {}  # the functions _record_writes wraps, as first found
TINY = dict(vocab_size=50265, d_model=32, encoder_layers=1, decoder_layers=1,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=1024)


def _tiny_backbone():
    """The CLIs' configuration with the tiny BART backbone."""
    import vlpet_tpu_torch.cli.multitask as tm
    import vlpet_tpu_torch.cli.multitask_infer as tmi
    import vlpet_tpu_torch.cli.multitask_video as tmv
    import vlpet_tpu_torch.cli.param as tp
    import vlpet_tpu_torch.cli.single_task as tst

    def patched(args, tasks, vocab_size=None):
        cfg = tp.build_model_config(args, tasks, vocab_size)
        return dataclasses.replace(cfg, backbone=BartConfig(
            **TINY, dropout=args.dropout))

    for mod in (tm, tmi, tmv, tst):
        mod.build_model_config = patched


def _record_writes(rank):
    """(the (task, question id) of every trained example, the writes of
    this rank): rank 0's checkpoint and LAST.npz writes are counted,
    another rank's raise."""
    import vlpet_tpu_torch.train.trainer as tt
    from vlpet_tpu_torch.train.checkpoint import CheckpointManager

    seen, writes = [], []
    step, save, npz = _UNPATCHED.setdefault("fns", (
        Trainer.do_train_step, CheckpointManager.save, tt.save_params_npz))

    def do_train_step(self, batch):
        seen.extend((batch["task"], q) for q in batch["question_ids"])
        return step(self, batch)

    def guard(fn, what):
        def write(*a, **kw):
            if rank != 0:
                raise AssertionError(f"rank {rank} wrote {what}")
            writes.append(what)
            return fn(*a, **kw)
        return write

    Trainer.do_train_step = do_train_step
    CheckpointManager.save = guard(save, "checkpoint")
    tt.save_params_npz = guard(npz, "LAST.npz")
    return seen, writes


CLI_FLAGS = ["--backbone", "facebook/bart-base", "--batch_size", "2",
             "--valid_batch_size", "2", "--feat_dim", "8", "--n_boxes", "4",
             "--synthetic_examples", "8", "--lr", "1e-3", "--epochs", "1",
             "--gen_max_length", "4", "--num_beams", "2", "--dropout", "0.1",
             "--use_adapter", "--use_single_adapter", "--no_encoder_adapter",
             "--use_adapter_down_dim", "--use_encoder_adapter_down_multihead",
             "--adapter_down_dim", "8",
             "--encoder_adapter_multihead_num_head", "4",
             "--unfreeze_encoder_layer_norms", "--no_decoder_adapter",
             "--use_decoder_enc_attn_value_parallel_adapter_down_dim",
             "--decoder_enc_attn_value_parallel_adapter_down_dim", "8",
             "--use_encoder_adapter_gating_large_x_lowrank",
             "--adapter_gating_down_dim", "8", "--distributed"]


def cli_ranks(rank, world, out_dir, extra=()):
    """Each CLI with ``--distributed`` (and the flags ``extra``) on
    synthetic data: multitask (vqa and caption, one epoch, then
    multitask_infer on its LAST.npz), multitask_video (tvqa) and
    single_task (vqa). Returns per run the examples this rank trained on,
    its writes, the files of its output directory and what the run
    returned."""
    import vlpet_tpu_torch.cli.multitask as tm
    import vlpet_tpu_torch.cli.multitask_infer as tmi
    import vlpet_tpu_torch.cli.multitask_video as tmv
    import vlpet_tpu_torch.cli.single_task as tst

    _tiny_backbone()
    out = {}

    def run(name, fn, argv):
        seen, writes = _record_writes(rank)
        path = os.path.join(out_dir, name)
        ret = fn(CLI_FLAGS + list(extra) + argv + ["--output", path])
        trainer = ret[0] if isinstance(ret, tuple) else ret
        out[name] = {"seen": seen, "writes": writes,
                     "files": sorted(os.listdir(path))
                     if os.path.isdir(path) else [],
                     "logs": trainer.logger.jsonl is not None,
                     "world": trainer.world, "step": trainer.step,
                     "layout": (trainer.layout.data, trainer.layout.model),
                     "shapes": {n: tuple(p.shape) for n, p
                                in trainer.model.named_parameters()}}

    run("multitask", lambda a: tm.main(a, device="cpu"),
        ["--tasks", "vqa,caption"])
    run("multitask_infer", lambda a: tmi.main(a, device="cpu"),
        ["--tasks", "vqa,caption", "--load_trained_model_path",
         os.path.join(out_dir, "multitask", "LAST.npz")])
    run("multitask_video", lambda a: tmv.main(a, device="cpu"),
        ["--tasks", "tvqa"])
    run("single_task", lambda a: tst.main("vqa", a, device="cpu"), [])
    return out


def cli_scripts_ranks(rank, world, runs):
    """``cli_script_ranks`` of each (output directory, argv) of ``runs``."""
    return [cli_script_ranks(rank, world, d, argv) for d, argv in runs]


def cli_script_ranks(rank, world, out_dir, argv):
    """cli.multitask.main on ``argv`` (a script's flags with
    ``--distributed`` and the tiny sizes; the tiny BART backbone): one
    epoch with its evaluations, then ``--resume`` from its checkpoint.
    Returns both runs' steps, layouts and state digests (collective: every
    rank computes them), the first run's history keys and its trainable
    tensors, gathered whole."""
    import vlpet_tpu_torch.cli.multitask as tm
    from vlpet_tpu_torch.parallel.mesh import gather_state_dict

    _tiny_backbone()
    argv = list(argv) + ["--output", os.path.join(out_dir, "run")]
    trainer, history = tm.main(argv, device="cpu")
    out = {"step": trainer.step, "digest": trainer.state_digest(),
           "layout": (trainer.layout.data, trainer.layout.model),
           "history": sorted(history[0]),
           "trainable": gather_state_dict(
               {n: p.detach() for n, p in trainer.trainable.items()},
               trainer.model),
           "local": {n: tuple(p.shape) for n, p in trainer.trainable.items()}}
    again, history = tm.main(argv + ["--resume"], device="cpu")
    out.update(resumed_step=again.step, resumed_history=history,
               resumed_digest=again.state_digest())
    return out


def eval_cli_ranks(rank, world, ckpt_dir, cli_dir):
    """``eval_ranks`` then ``cli_ranks``, in one process group."""
    return {"eval": eval_ranks(rank, world, ckpt_dir),
            "cli": cli_ranks(rank, world, cli_dir)}


# --- tensor parallelism: checkpoints across layouts ------------------------

def tp_checkpoint_ranks(rank, world, out_dir, model_axis, stage, pet=None,
                        clip=5.0):
    """Stage "save": the sharded evaluation, then one caption epoch at
    batch 2 a data shard, checkpointed (and LAST.npz written) under
    ``out_dir``. Stage "resume": restore that checkpoint under this
    layout, load its LAST.npz into the sharded model, and train to the
    end of the second epoch at batch 4 a data shard. ``pet``: the recipe
    (VL-PET-large without one; the sharded evaluation only then),
    ``clip``: the clip norm."""
    from vlpet_tpu_torch.train.checkpoint import load_params_npz

    kw = dict(output_dir=out_dir, lr=1e-2, total_steps=8, pet=pet,
              clip_grad_norm=clip, mesh_model_axis=model_axis)
    if stage == "save":
        res = ({"eval": evaluate_all(tiny_trainer(mesh_model_axis=model_axis))}
               if pet is None else {})
        trainer = tiny_trainer(**kw)
        res["params"] = train_caption(trainer, epochs=1, batch_size=2)
    else:
        trainer = tiny_trainer(**kw)
        res = {"restored": trainer.restore()}
        res["digest"] = trainer.state_digest()
        _, res["npz_loaded"] = load_params_npz(
            os.path.join(out_dir, "LAST.npz"), trainer.model)
        res["params"] = train_caption(trainer, epochs=2, batch_size=4)
    res.update(layout=(trainer.layout.data, trainer.layout.model),
               step=trainer.step,
               shapes={n: tuple(p.shape)
                       for n, p in trainer.model.named_parameters()})
    return res
