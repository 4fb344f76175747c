"""Trainer orchestration, ported from vlpet_tpu/train/trainer.py.

Reference control flow (src/trainer_base.py + src/multitask.py): model ->
seeded init and the recipe's re-inits -> optional weight load -> freeze /
unfreeze -> optimizer and schedule -> per-epoch multitask loop -> per-task
eval (generation + evaluator) -> checkpoint and LAST export.

On the card every training step and every generation runs the port's
hand-written kernels (ops/); the losses stay device tensors until a log
point, so the host waits for the card once a log interval, not once a
step. Dropped as TPU artefacts: the device mesh and batch sharding, the
scoped-VMEM retry, the rbg PRNG and the scan twin of the generation model.
With ``raw_vis_backbone`` (the raw_* feature types) the model is
vision/vis_encoder.py's RawInputVLModel: the CLIP trunk runs inside the
train step and the generation, on the batch's images, which ``array_batch``
puts in the vis_feats slot. The weights go in as the JAX Trainer takes
them: the seeded init, then ``clip_ckpt`` (an OpenAI CLIP visual state
dict, raw mode only), then ``backbone_ckpt`` (an HF BART / T5 state dict),
then the recipe's re-inits, then ``load``. Under ``cfg.classifier`` the
vqa batches carry ``target`` (the answer scores): the step trains the
answer head on the BCE and ``evaluate`` answers by ``predict_classifier``.

Under a process group (parallel/multihost.py: one process per card) the
step sums the ranks' gradients (train/steps.py) and the Trainer keeps the
ranks in step: every rank restores the checkpoint, rank 0 alone logs and
writes the checkpoints and LAST.npz (a barrier after each write), each
epoch's task order is checked equal on every rank, and the predictions
of the ranks' eval shards are merged (``all_gather_objects``), so every
rank scores the whole split.

``mesh_model_axis`` M > 1 (tensor parallelism, parallel/mesh.py): the
processes form a (data, M) mesh -- a model axis that does not divide them
falls back to 1, as in the JAX Trainer -- the model is built whole from
its seed, imported and loaded, then each rank keeps its shard of the
split families (``shard_model``). The data shards, the step's sums and
the merged predictions count the data axis (one part a data index);
LAST.npz and the checkpoints hold whole tensors (``gather_state_dict``:
a trainable that is split -- BitFit's biases, full fine-tuning's weights
-- with its optimizer state and accumulated gradient), and a restore cuts
them to the rank's shards again, so a run resumes under any layout.
Every configuration that one process runs runs split, the raw-image path
included (its CLIP trunk whole on every rank).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.convert import attention_heads
from vlpet_tpu_torch.device import Device, deterministic_kernels, resolve_device
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                           gather_state_dict, shard_model,
                                           shard_state_dict)
from vlpet_tpu_torch.parallel.multihost import (all_gather_objects, barrier,
                                                data_parts, host_shard,
                                                merge_predict_results)
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_params_npz,
                                              save_params_npz)
from vlpet_tpu_torch.train.freezing import (apply_freezing, trainable_report,
                                            weight_initialization)
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step
from vlpet_tpu_torch.utils.logging import LossMeter, MetricsLogger

ARRAY_BATCH_KEYS = ("input_ids", "attention_mask", "vis_feats", "boxes",
                    "img_order_ids", "obj_order_ids", "vis_attention_mask",
                    "target_ids", "scores", "decoder_input_ids", "images",
                    "target")


def _task_loaders(loader) -> List:
    """The per-task loaders of a MultitaskLoader, or the loader itself."""
    return list(getattr(loader, "loaders", [loader]))


def data_rng_state(loader) -> Dict[str, Any]:
    """Each task dataset's sampling RNG state (the VQA answer draw) by
    task: saved at an epoch's end beside the train state, so a resumed run
    draws what an uninterrupted one draws."""
    return {ld.task: ld.dataset.rng.bit_generator.state
            for ld in _task_loaders(loader)
            if hasattr(getattr(ld, "dataset", None), "rng")}


def check_task_order(epoch_tasks: List[str]) -> None:
    """Raise unless every rank's epoch holds the same task order: a
    mismatch would sum one task's gradients into another's. The order
    depends only on the epoch and the per-task batch counts, which the
    shards share (data/multitask.py); one gather of its digest an
    epoch."""
    digest = hashlib.sha256("\n".join(epoch_tasks).encode()).hexdigest()
    digests = all_gather_objects(digest)
    if len(set(digests)) > 1:
        raise RuntimeError(f"the ranks' epochs differ in task order "
                           f"(digests by rank: {digests})")


def merged_dict(part: Dict) -> Dict:
    """The union of every data shard's ``part`` (their eval shards are
    disjoint); ``part``'s items in one process."""
    merged: Dict = {}
    for p in data_parts(part):
        merged.update(p)
    return merged


def array_batch(batch: Dict[str, Any], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """The model inputs of a collated batch as tensors on ``device``:
    integer arrays as int64, floating ones as fp32; the raw path's
    ``images`` (B, [2,] H, W, 3) as the trunk's NCHW (B, [2,] 3, H, W),
    contiguous, under ``vis_feats``, the slot where RawInputVLModel takes
    them."""
    out = {}
    for k, v in batch.items():
        if k not in ARRAY_BATCH_KEYS or v is None:
            continue
        a = np.asarray(v)
        t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iub"
                             else a.astype(np.float32, copy=False))
        t = t.to(device, non_blocking=True)
        if k == "images":
            k, t = "vis_feats", t.movedim(-1, -3).contiguous()
        out[k] = t
    return out


class Trainer:
    def __init__(self, cfg: VLModelConfig, tasks: Tuple[str, ...], *,
                 lr: float = 1e-3, total_steps: int = 1000,
                 warmup_ratio: float = 0.1, weight_decay: float = 0.01,
                 clip_grad_norm: float = 5.0, adam_eps: float = 1e-6,
                 adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                 seed: int = 9595, output_dir: Optional[str] = None,
                 tokenizer=None, backbone_ckpt: Optional[str] = None,
                 load: Optional[str] = None, mesh_model_axis: int = 1,
                 gradient_accumulation_steps: int = 1,
                 verbose: bool = True, use_wandb: bool = False,
                 raw_vis_backbone: Optional[str] = None,
                 image_size: int = 224,
                 vis_adapter_type: Optional[str] = None,
                 vis_pooling_output: bool = False,
                 clip_ckpt: Optional[str] = None, device: Device = "cuda"):
        self.cfg = cfg
        self.tasks = tuple(tasks)
        self.tokenizer = tokenizer
        self.output_dir = output_dir
        self.rank, self.world = host_shard()
        self.lead = self.rank == 0  # the rank that logs and writes
        self.verbose = verbose = verbose and self.lead
        # the CLIs build the mesh before their Loaders, and say where the
        # model axis falls back
        self.layout = build_mesh(MeshConfig(model=mesh_model_axis),
                                 verbose=False)
        # this process's data shard: its eval shard, its batch's place
        self.shard_index, self.shards = (self.layout.data_index,
                                         self.layout.data)
        self.device = dev = resolve_device(device)
        deterministic_kernels()
        self.logger = MetricsLogger(output_dir if self.lead else None,
                                    use_wandb=use_wandb and self.lead,
                                    verbose=verbose)

        # --- params: seeded init (with the recipe's re-inits), the CLIP
        # and backbone imports, the re-inits again, load ------------------
        # raw_* feature types: the CLIP trunk runs inside the train step so
        # --unfreeze_vis_encoder / --use_vis_adapter gradients flow end to
        # end (reference: multitask.py:648-660 raw feature_type +
        # vis_forward)
        self.raw = raw_vis_backbone is not None
        if self.raw:
            from vlpet_tpu_torch.vision.vis_encoder import RawInputVLModel

            self.model = RawInputVLModel(
                cfg, vis_backbone=raw_vis_backbone, image_size=image_size,
                vis_adapter_type=(vis_adapter_type
                                  if cfg.pet.use_vis_adapter else None),
                vis_pooling_output=vis_pooling_output, device=dev)
        else:
            self.model = (VLT5 if cfg.is_t5 else VLBart)(cfg, device=dev)
        self.model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        if self.raw and clip_ckpt:
            from vlpet_tpu_torch.models.hf_import import load_torch_state_dict
            from vlpet_tpu_torch.vision.clip_import import load_clip_state_dict

            report = load_clip_state_dict(self.model.vis_encoder,
                                          load_torch_state_dict(clip_ckpt))
            if verbose:
                print(f"CLIP import: {len(report['filled'])} tensors")
        if backbone_ckpt:
            from vlpet_tpu_torch.models.hf_import import (
                bart_hf_to_port, load_torch_state_dict, t5_hf_to_port)

            conv = t5_hf_to_port if cfg.is_t5 else bart_hf_to_port
            report = conv(load_torch_state_dict(backbone_ckpt),
                          self.model.vl if self.raw else self.model)
            if verbose:
                print(f"imported {len(report['filled'])} tensors from "
                      f"{backbone_ckpt}; {len(report['skipped'])} skipped")
        weight_initialization(self.model, cfg.pet)
        if load:
            _, n = load_params_npz(load, self.model)
            if verbose:
                print(f"loaded {n} tensors from {load}")

        # --- freezing, the model axis's placement, optimizer ---------------
        self.trainable = apply_freezing(self.model, cfg.pet)
        self.report = trainable_report(self.model, cfg.pet)  # whole counts
        if verbose:
            r = self.report
            print(f"Trainable param percentage: {r['percentage']:.2f}% "
                  f"({r['trainable']}/{r['total']})")
        shard_model(self.model, self.layout)
        self.optimizer = build_optimizer(
            self.trainable, lr=lr, total_steps=total_steps,
            warmup_ratio=warmup_ratio, weight_decay=weight_decay,
            adam_beta1=adam_beta1, adam_beta2=adam_beta2, adam_eps=adam_eps,
            clip_grad_norm=clip_grad_norm)
        # the JAX raw step takes no z regularizer
        self.lambda_z = (cfg.pet.lambda_z if cfg.pet.track_z and not self.raw
                         else 0.0)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.tasks, lambda_z=self.lambda_z,
            device=dev, accumulation_steps=gradient_accumulation_steps)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.step = 0  # micro-batch steps taken, as the JAX state.step
        self._data_rng: Optional[Dict[str, Any]] = None  # from restore
        self.ckpt = (CheckpointManager(os.path.join(output_dir, "ckpt"))
                     if output_dir else None)

        # NLVR scoring constants (reference: multitask.py:78-80,
        # nlvr_model.py:70-77,199-206)
        if tokenizer is not None and "nlvr" in self.tasks:
            self.true_id = tokenizer("true", add_special_tokens=False).input_ids[0]
            self.false_id = tokenizer("false", add_special_tokens=False).input_ids[0]
        else:
            self.true_id = self.false_id = None
        self.nlvr_position = 0 if cfg.is_t5 else 1

    # ------------------------------------------------------------------
    def task_idx(self, task: str) -> int:
        return self.tasks.index(task)

    def named_weights(self) -> Dict[str, torch.Tensor]:
        """Every parameter by name, a trainable one of lower precision as
        its fp32 master copy (what the JAX package keeps and exports)."""
        master = self.optimizer.state_dict()["master"]
        return {n: master.get(n, p) for n, p in self.model.named_parameters()}

    def do_train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        arr = array_batch(batch, self.device)
        metrics = self.train_step(arr, self.generator,
                                  self.task_idx(batch["task"]))
        self.step += 1
        return metrics

    def train(self, train_loader, epochs: int, val_loaders=None,
              eval_every: int = 1, save_every: Optional[int] = None,
              log_every: int = 20) -> Dict[str, Any]:
        """The JAX loop: per epoch the train batches, then every
        ``eval_every`` epochs each val loader's evaluation, then the epoch's
        checkpoint every ``save_every`` epochs; at the end a checkpoint and
        LAST.npz. A restored trainer (``restore``) goes on from its step:
        the epochs and batches it already took are skipped, and the
        datasets' sampling RNGs take the states saved with the step. Each epoch's
        record also holds its host-clocked train seconds and steps and each
        task's eval seconds. Under a process group every rank runs it on
        its own train shard; the examples counted are the global
        batch's."""
        history = {}
        step = self.step
        per_epoch = max(1, len(train_loader))
        if self._data_rng:
            for ld in _task_loaders(train_loader):
                if ld.task in self._data_rng:
                    ld.dataset.rng.bit_generator.state = self._data_rng[ld.task]
            self._data_rng = None
        for epoch in range(step // per_epoch, epochs):
            train_loader.set_epoch(epoch)
            if self.world > 1 and hasattr(train_loader, "epoch_tasks"):
                check_task_order(train_loader.epoch_tasks)
            skip = step - epoch * per_epoch
            meter = LossMeter()
            t0 = time.time()
            n_examples = n_steps = 0
            pending: List[torch.Tensor] = []  # device scalars until a log
            for batch in train_loader:
                if skip > 0:
                    skip -= 1
                    continue
                metrics = self.do_train_step(batch)
                pending.append(metrics["loss"])
                n_examples += len(batch["input_ids"]) * self.shards
                n_steps += 1
                step += 1
                if step % log_every == 0:
                    for v in torch.stack(pending).tolist():  # one host sync
                        meter.update(v)
                    pending.clear()
                    self.logger.log({"epoch": epoch, "loss": meter.val,
                                     "examples_per_sec":
                                         n_examples / (time.time() - t0)},
                                    step=step)
            if pending:
                for v in torch.stack(pending).tolist():
                    meter.update(v)
                pending.clear()
            train_s = time.time() - t0
            epoch_metrics = {"train_loss": meter.val, "train_seconds": train_s,
                             "train_steps": n_steps,
                             "train_examples": n_examples}
            if val_loaders and (epoch + 1) % eval_every == 0:
                for loader in val_loaders:
                    t1 = time.time()
                    scores = self.evaluate(loader)
                    epoch_metrics[f"{loader.task}/eval_seconds"] = (
                        time.time() - t1)
                    for k, v in scores.items():
                        epoch_metrics[f"{loader.task}/{k}"] = v
            self.logger.log({"epoch": epoch, **{k: v for k, v in
                                                epoch_metrics.items()
                                                if isinstance(v, (int, float))}},
                            step=step)
            history[epoch] = epoch_metrics
            if save_every and self.ckpt and (epoch + 1) % save_every == 0:
                self.save(step, train_loader)
        if self.ckpt:
            self.save(step, train_loader)
        if self.output_dir:
            named = gather_state_dict(self.named_weights(), self.model)
            if self.lead:
                save_params_npz(named,
                                os.path.join(self.output_dir, "LAST.npz"),
                                heads=attention_heads(self.model))
            barrier()
        return history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, loader, num_beams: int = 1, max_length: int = 20
                ) -> Dict[str, Any]:
        """Generate predictions for a loader; returns quesid2ans (+raw).
        Under a process group the loader is the rank's eval shard and the
        data shards' results are merged (``merge_predict_results``)."""
        quesid2ans: Dict[Any, str] = {}
        predictions: List[str] = []
        targets: List = []
        offset = 0  # running fallback id: batch-local range() would collide
        for batch in loader:
            arr = array_batch(batch, self.device)
            ctx = PetContext(task=batch["task"],
                             task_idx=self.task_idx(batch["task"]))
            seqs = seq2seq_generate(
                self.model, input_ids=arr["input_ids"],
                attention_mask=arr["attention_mask"],
                vis_feats=arr.get("vis_feats"), boxes=arr.get("boxes"),
                img_order_ids=arr.get("img_order_ids"),
                obj_order_ids=arr.get("obj_order_ids"),
                vis_attention_mask=arr.get("vis_attention_mask"), ctx=ctx,
                num_beams=num_beams, max_length=max_length)
            texts = self.tokenizer.batch_decode(seqs[:, 1:].cpu().numpy(),
                                                skip_special_tokens=True)
            predictions.extend(texts)
            if "targets" in batch:
                targets.extend(batch["targets"])
            qids = batch.get("question_ids", self._fallback_ids(offset,
                                                                len(texts)))
            offset += len(texts)
            for qid, text in zip(qids, texts):
                quesid2ans[qid] = text.strip()
        res = {"quesid2ans": quesid2ans, "predictions": predictions,
               "targets": targets}
        if self.world > 1:
            res = merge_predict_results(data_parts(res))
        return res

    def _fallback_ids(self, offset: int, n: int) -> range:
        """Ids of a batch without question ids: the examples' positions in
        the unshuffled split, which a data shard's strided share (Loader:
        every shards-th example from its index) gives as index + i *
        shards."""
        i, n_shards = self.shard_index, self.shards
        return range(i + offset * n_shards, i + (offset + n) * n_shards,
                     n_shards)

    @torch.no_grad()
    def predict_classifier(self, loader, label2ans) -> Dict[str, Any]:
        """Classifier-head prediction: per example the answer of the argmax
        over the answer vocabulary (vlpet_tpu/train/trainer.py:513-537;
        the first of tied maxima, as numpy's)."""
        quesid2ans: Dict[Any, str] = {}
        ctx = PetContext(task=loader.task, task_idx=self.task_idx(loader.task))
        offset = 0
        for batch in loader:
            arr = array_batch(batch, self.device)
            logits = self.model.classify(
                arr["input_ids"], arr["attention_mask"],
                vis_feats=arr.get("vis_feats"), boxes=arr.get("boxes"),
                img_order_ids=arr.get("img_order_ids"),
                obj_order_ids=arr.get("obj_order_ids"), ctx=ctx)
            ids = logits.argmax(-1).tolist()
            qids = batch.get("question_ids",
                             self._fallback_ids(offset, len(ids)))
            offset += len(ids)
            for qid, i in zip(qids, ids):
                quesid2ans[qid] = label2ans[int(i)]
        return {"quesid2ans": merged_dict(quesid2ans)}

    def fixed_step_logits(self, batch: Dict[str, Any], task: str
                          ) -> torch.Tensor:
        """The logits at ``nlvr_position`` of one deterministic forward on
        the fixed decoder input [decoder_start, bos] (BART) or
        [decoder_start] (T5): the true/false scoring of NLVR and of the
        matching formulation (reference: nlvr_model.py:240-258)."""
        b = self.cfg.backbone
        dec = ([b.decoder_start_token_id] if self.cfg.is_t5
               else [b.decoder_start_token_id, b.bos_token_id])
        ctx = PetContext(task=task, task_idx=self.task_idx(task))
        arr = array_batch(batch, self.device)
        B = arr["input_ids"].shape[0]
        dec_ids = torch.tensor([dec], dtype=torch.long,
                               device=self.device).expand(B, -1)
        logits = self.model(
            arr["input_ids"], arr["attention_mask"],
            vis_feats=arr.get("vis_feats"), boxes=arr.get("boxes"),
            img_order_ids=arr.get("img_order_ids"),
            obj_order_ids=arr.get("obj_order_ids"),
            decoder_input_ids=dec_ids, ctx=ctx,
            deterministic=True)["logits"]
        return logits[:, self.nlvr_position, :]

    @torch.no_grad()
    def predict_nlvr(self, loader) -> Dict[Any, int]:
        """True/false-logit scoring, no generation (``fixed_step_logits``)."""
        out: Dict[Any, int] = {}
        for batch in loader:
            step = self.fixed_step_logits(batch, "nlvr")
            preds = (step[:, self.true_id] > step[:, self.false_id]).tolist()
            for qid, p in zip(batch["question_ids"], preds):
                out[qid] = int(p)
        return merged_dict(out)

    def evaluate(self, loader, num_beams: Optional[int] = None,
                 max_length: Optional[int] = None) -> Dict[str, float]:
        """Per-task eval dispatch (reference: multitask.py:344-466)."""
        task = loader.task
        ev = loader.evaluator
        if task == "nlvr":
            quesid2ans = self.predict_nlvr(loader)
            if ev is None:
                return {}
            res = ev.evaluate(quesid2ans)
            return res if isinstance(res, dict) else {"accuracy": res}
        if task in ("caption", "tvc", "yc2c"):
            res = self.predict(loader, num_beams=num_beams or 5,
                               max_length=max_length or 40)
            if ev is None:
                return {}
            return ev.evaluate(res["predictions"], res["targets"])
        # QA-style tasks: the answer head where the model and the loader's
        # dataset both have the classifier (vlpet_tpu/train/trainer.py:623)
        ds_cfg = getattr(getattr(loader, "dataset", None), "cfg", None)
        if (self.cfg.classifier and getattr(ds_cfg, "classifier", False)
                and ds_cfg.ans2label):
            label2ans = {v: k for k, v in ds_cfg.ans2label.items()}
            res = self.predict_classifier(loader, label2ans)
        else:
            res = self.predict(loader, num_beams=num_beams or 1,
                               max_length=max_length or 20)
        if ev is None:
            return {}
        if hasattr(ev, "evaluate_raw") and getattr(ev, "id2datum_gt", None):
            return {"score": ev.evaluate_raw(res["quesid2ans"])["overall"]}
        if hasattr(ev, "eval"):  # TVQA style
            preds = [{"question_id": q, "answer": a}
                     for q, a in res["quesid2ans"].items()]
            return ev.eval(preds)
        return {"score": ev.evaluate(res["quesid2ans"]) * 100.0}

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """The resumable state: the step, the trainable tensors, the
        optimizer's, the gradient accumulator's and the dropout
        generator's. Under tensor parallelism the split trainables, their
        moments, master copies and accumulated gradients are gathered
        whole (``gather_state_dict``): collective over the model group,
        so every rank calls it; each then holds the same state."""
        def whole(named):
            return gather_state_dict(named, self.model)

        opt = self.optimizer.state_dict()
        opt.update({k: whole(opt[k]) for k in ("mu", "nu", "master")})
        acc = self.train_step.accumulator
        if acc is not None:
            acc = acc.state_dict()
            acc["acc"] = list(whole(dict(zip(self.optimizer.names,
                                             acc["acc"]))).values())
        return {"step": self.step,
                "params": whole(dict(self.trainable)),
                "opt_state": opt, "accumulator": acc,
                "generator": self.generator.get_state()}

    def state_digest(self) -> str:
        """sha256 over the bytes of ``state()``, in a fixed order: two
        trainers whose digests agree hold the same state bit for bit (the
        whole state under tensor parallelism: every rank calls it)."""
        h = hashlib.sha256()

        def feed(x):
            if isinstance(x, torch.Tensor):
                t = x.detach().contiguous().cpu()
                h.update(str((t.dtype, tuple(t.shape))).encode())
                h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
            elif isinstance(x, dict):
                for k in sorted(x):
                    h.update(str(k).encode())
                    feed(x[k])
            elif isinstance(x, (list, tuple)):
                for v in x:
                    feed(v)
            else:
                h.update(repr(x).encode())

        feed(self.state())
        return h.hexdigest()

    def save(self, step: int, train_loader=None):
        """Checkpoint ``state()`` at ``step``; with the train loader (at an
        epoch's end) also its datasets' sampling RNG states, one dict a
        data shard (``data_rng``, in data order). Under a process group
        every rank calls it: each gathers the whole train state
        (``state``), the same on all, rank 0 writes it, and the others
        wait for the write."""
        if self.ckpt:
            rngs = (data_parts(data_rng_state(train_loader))
                    if train_loader is not None else None)
            state = self.state()
            if self.lead:
                if rngs is not None:
                    state["data_rng"] = rngs
                self.ckpt.save(step, state)
            barrier()

    @torch.no_grad()
    def restore(self) -> Optional[int]:
        """Load the newest checkpoint in place; returns its step, or None
        when there is none. Every rank loads it, at any world size and
        layout; the datasets' sampling RNGs take this data shard's saved
        states where the checkpoint was written with as many data shards,
        else they start afresh (rank 0 says so). The whole tensors are cut
        to this rank's shards (``shard_state_dict``)."""
        if not self.ckpt:
            return None
        data = self.ckpt.restore(map_location=self.device)
        if data is None:
            return None

        def mine(named):
            return shard_state_dict(named, self.model)

        params = mine(data["params"])
        for name, p in self.trainable.items():
            p.copy_(params[name])
        opt = dict(data["opt_state"])
        opt.update({k: mine(opt[k]) for k in ("mu", "nu", "master")})
        self.optimizer.load_state_dict(opt)
        acc = self.train_step.accumulator
        if acc is not None:
            state = dict(data["accumulator"])
            state["acc"] = list(mine(dict(zip(self.optimizer.names,
                                              state["acc"]))).values())
            acc.load_state_dict(state)
        self.generator.set_state(data["generator"].cpu())
        self.step = int(data["step"])
        rngs = data.get("data_rng")
        if isinstance(rngs, dict):  # one process's, as written before ranks
            rngs = [rngs]
        self._data_rng = None
        if rngs is not None and len(rngs) == self.shards:
            self._data_rng = rngs[self.shard_index]
        elif rngs is not None and self.lead:
            print(f"checkpoint written by {len(rngs)} data shards, restored "
                  f"by {self.shards}: the train state is kept; the datasets' "
                  f"sampling draws start afresh")
        return self.step


@torch.no_grad()
def predict_matching(trainer: Trainer, loader, task: str = "tvqa"
                     ) -> Dict[str, Dict[str, float]]:
    """Matching-variant scoring (reference: video_matching_model.py's
    true-token scoring; vlpet_tpu/train/trainer.py predict_matching): per
    row the true logit minus the false logit of
    ``Trainer.fixed_step_logits``, grouped by question. Row ids are
    "<question id>/<candidate>" (``data.video.expand_matching_examples``).
    Returns {group_id: {candidate: true_score}}, merged over the ranks'
    eval shards under a process group."""
    if trainer.true_id is None:
        trainer.true_id = trainer.tokenizer(
            "true", add_special_tokens=False).input_ids[0]
        trainer.false_id = trainer.tokenizer(
            "false", add_special_tokens=False).input_ids[0]
    groups: Dict[str, Dict[str, float]] = {}
    for batch in loader:
        step = trainer.fixed_step_logits(batch, task)
        scores = (step[:, trainer.true_id]
                  - step[:, trainer.false_id]).float().tolist()
        for qid, sc in zip(batch["question_ids"], scores):
            gid, cand = str(qid).rsplit("/", 1)
            groups.setdefault(gid, {})[cand] = float(sc)
    if trainer.world > 1:  # a group's candidates may lie on several ranks
        merged: Dict[str, Dict[str, float]] = {}
        for part in data_parts(groups):
            for gid, cands in part.items():
                merged.setdefault(gid, {}).update(cands)
        groups = merged
    return groups
