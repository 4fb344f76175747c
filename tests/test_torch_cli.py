"""The port's CLIs on CPU, in the manner of tests/test_cli_entries.py: a
tiny BART backbone (d 32, 1+1 layers at the BART vocabulary) forced
through ``build_model_config``, synthetic data, ``main([...],
device="cpu")``.

* ``vlpet_tpu_torch.cli.multitask`` trains the four image-text tasks with
  the VL-PET-small flags and evaluates each epoch, writes its checkpoints
  and LAST.npz; ``--resume`` restores the saved state bit for bit (the
  state digests agree) and trains on; ``--test_only`` evaluates a LAST.npz.
* ``--device cuda`` raises on a host without CUDA: nothing falls back.
* Restoring under the WhitespaceTokenizer fallback (``--resume``,
  ``--load``, ``--load_trained_model_path``) needs PYTHONHASHSEED fixed:
  without it the CLI refuses. The runs here restore in the process that
  saved, so their word ids agree whatever the seed; they set it as a user
  must.
* ``--use_fused_ce`` and ``--use_fused_beam`` train and evaluate through
  the same CLI (on the CPU, the kernels' plain twins).

tests/test_torch_cli_gate_dump.py holds ``multitask_infer``'s gate dump
against the JAX one with these helpers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=50265, d_model=32, encoder_layers=1, decoder_layers=1,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64)

GATE_FLAGS = {
    "small": ["--use_encoder_adapter_gating_small_xy_cat"],
    "middleX": ["--use_encoder_adapter_gating_middle_xy_add"],
    "middleY": ["--use_encoder_adapter_gating_middle_ia3_add"],
    "large": ["--use_encoder_adapter_gating_large_x_lowrank",
              "--adapter_gating_down_dim", "8"],
}


def _argv(extra, gate="small"):
    return (["--backbone", "facebook/bart-base", "--batch_size", "4",
             "--feat_dim", "8", "--n_boxes", "4", "--synthetic_examples", "8",
             "--lr", "1e-3", "--gen_max_length", "4", "--num_beams", "5",
             "--use_tasks_prompts", "--use_adapter", "--use_single_adapter",
             "--no_encoder_adapter", "--use_adapter_down_dim",
             "--use_encoder_adapter_down_multihead", "--adapter_down_dim",
             "8", "--encoder_adapter_multihead_num_head", "4",
             "--unfreeze_encoder_layer_norms", "--no_decoder_adapter",
             "--use_decoder_enc_attn_value_parallel_adapter_down_dim",
             "--decoder_enc_attn_value_parallel_adapter_down_dim", "8"]
            + GATE_FLAGS[gate] + extra)


@pytest.fixture(autouse=True)
def tiny_backbone(monkeypatch):
    """Force the tiny backbone through both packages' CLI paths."""
    import vlpet_tpu.cli.multitask_infer as jmi
    import vlpet_tpu.cli.param as jp
    import vlpet_tpu_torch.cli.multitask as tm
    import vlpet_tpu_torch.cli.multitask_infer as tmi
    import vlpet_tpu_torch.cli.param as tp
    from vlpet_tpu.config import BartConfig as JBart
    from vlpet_tpu_torch.config import BartConfig as TBart

    def patch(orig, bart):
        def patched(args, tasks, vocab_size=None):
            cfg = orig(args, tasks, vocab_size)
            return dataclasses.replace(
                cfg, backbone=bart(**TINY, dropout=args.dropout))
        return patched

    tpatched = patch(tp.build_model_config, TBart)
    monkeypatch.setattr(tm, "build_model_config", tpatched)
    monkeypatch.setattr(tmi, "build_model_config", tpatched)
    monkeypatch.setattr(jmi, "build_model_config",
                        patch(jp.build_model_config, JBart))
    torch.set_num_threads(2)
    yield


def test_multitask_trains_resumes_and_evaluates(tmp_path, capsys,
                                               monkeypatch):
    from vlpet_tpu_torch.cli.multitask import main

    monkeypatch.setenv("PYTHONHASHSEED", "0")

    out = str(tmp_path / "run")
    base = _argv(["--tasks", "vqa,gqa,nlvr,caption", "--output", out])
    trainer, history = main(base + ["--epochs", "1"], device="cpu")
    assert trainer.device.type == "cpu" and trainer.step > 0
    assert np.isfinite(history[0]["train_loss"])
    for task in ("vqa", "gqa", "caption"):
        assert f"{task}/eval_seconds" in history[0]
    assert "nlvr/accuracy" in history[0] and "caption/CIDEr" in history[0]
    assert os.path.exists(os.path.join(out, "LAST.npz"))
    digest, step = trainer.state_digest(), trainer.step

    # nothing left to train: the restored state is saved again unchanged
    again, history = main(base + ["--epochs", "1", "--resume"], device="cpu")
    assert history == {} and again.step == step
    assert again.state_digest() == digest
    assert f"resumed from step {step}" in capsys.readouterr().out
    # one more epoch goes on from there
    more, history = main(base + ["--epochs", "2", "--resume"], device="cpu")
    assert sorted(history) == [1] and more.step == 2 * step

    evald = main(base + ["--test_only", "--load_trained_model_path",
                         os.path.join(out, "LAST.npz")], device="cpu")
    printed = capsys.readouterr().out
    assert "vqa {" in printed and "caption {" in printed
    assert evald.step == 0


def test_device_cuda_raises_without_cuda(tmp_path, monkeypatch):
    from vlpet_tpu_torch.cli.multitask import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        main(_argv(["--tasks", "vqa", "--epochs", "1", "--output",
                    str(tmp_path / "run"), "--device", "cuda"]))


@pytest.mark.parametrize("restore", [
    ["--resume"], ["--load", "w.npz"], ["--test_only",
                                        "--load_trained_model_path", "w.npz"]])
def test_restoring_needs_a_fixed_hash_seed(tmp_path, monkeypatch, restore):
    from vlpet_tpu_torch.cli import multitask, multitask_infer

    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    argv = _argv(["--tasks", "vqa", "--epochs", "1", "--output",
                  str(tmp_path / "run")] + restore)
    for cli in (multitask, multitask_infer):
        with pytest.raises(ValueError, match="PYTHONHASHSEED"):
            cli.main(argv, device="cpu")
    monkeypatch.setenv("PYTHONHASHSEED", "random")
    with pytest.raises(ValueError, match="PYTHONHASHSEED"):
        multitask.main(argv, device="cpu")


def test_fused_ce_and_fused_beam_flags(tmp_path):
    from vlpet_tpu_torch.cli.multitask import main

    trainer, history = main(_argv([
        "--tasks", "vqa,caption", "--epochs", "1", "--output",
        str(tmp_path / "run"), "--use_fused_ce", "--use_fused_beam"]),
        device="cpu")
    cfg = trainer.model.cfg
    assert cfg.use_fused_ce and cfg.use_fused_beam
    assert np.isfinite(history[0]["train_loss"])
    assert "caption/CIDEr" in history[0] and "vqa/score" in history[0]
