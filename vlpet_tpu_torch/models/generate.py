"""Greedy and reorder-free beam-search decoding, ported from
vlpet_tpu/models/generate.py.

``encode`` runs once and the cross-attention K/V (VPA included) are
precomputed once. The self-attention KV cache is preallocated time-major
(L, B, H*Dh) and written in place one slot per step; beam search never
reorders it, carrying an ancestry index per beam instead (ops/decode.py).
The JAX while_loops become Python loops: the stop test reads one value
from the device per step.

Tie order: every lax.top_k of the JAX package is ops.topk.stable_topk here
(a stable descending sort), so equal scores -- the many NEG_INF entries
among the candidates in particular -- resolve to the lower index, as
lax.top_k does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.bart import compute_dtype
from vlpet_tpu_torch.ops import route
from vlpet_tpu_torch.ops import topk as topk_ops
from vlpet_tpu_torch.ops.topk import stable_topk

NEG_INF = -1.0e7


def topk_lse(logits: torch.Tensor, k: int):
    """(top_vals (R, k) f32, top_toks (R, k) int32, lse (R,) f32) from raw
    last-token logits: the beam/greedy scoring policy, through kernel 4 or
    its plain twin (ops.route). Exact lax.top_k semantics either way."""
    return route(topk_ops.topk_lse, topk_ops.topk_lse_reference)(logits, k)


def init_self_cache(cfg, batch_size: int, max_len: int,
                    dtype: torch.dtype = torch.float32,
                    device: Device = "cuda", model_axis: int = 1):
    """Per-layer self-attention KV cache, time-major (L, B, H*Dh): of the
    rank's H / ``model_axis`` heads under tensor parallelism."""
    b = cfg.backbone
    if cfg.is_t5:
        n_layers, inner = b.num_decoder_layers, b.num_heads * b.d_kv
    else:
        n_layers, inner = b.decoder_layers, b.d_model
    inner //= model_axis
    device = resolve_device(device)

    def layer():
        return {"k": torch.zeros((max_len, batch_size, inner), dtype=dtype,
                                 device=device),
                "v": torch.zeros((max_len, batch_size, inner), dtype=dtype,
                                 device=device)}

    return tuple(layer() for _ in range(n_layers))


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K_in, ...) -> (B, K_out, ...) picking beams idx (B, K_out)."""
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, index)


def _len_norm(n: int, length_penalty: float, device) -> torch.Tensor:
    """n ** length_penalty as an f32 scalar (the JAX f32 arithmetic)."""
    return torch.tensor(float(n), dtype=torch.float32,
                        device=device) ** length_penalty


def greedy_generate(decode_topk: Callable, cache, batch_size: int,
                    max_length: int, decoder_start_token_id: int,
                    eos_token_id: int, pad_token_id: int,
                    device: Device = "cuda") -> torch.Tensor:
    """decode_topk(token_ids (B, 1), pos, cache, beam_anc, k) ->
    (top_vals, top_toks, lse, cache). Returns (B, max_length) with the
    start token at position 0."""
    device = resolve_device(device)
    seqs = torch.full((batch_size, max_length), pad_token_id, dtype=torch.long,
                      device=device)
    seqs[:, 0] = decoder_start_token_id
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    i = 0
    while i < max_length - 1 and not bool(finished.all()):
        _, toks, _, cache = decode_topk(seqs[:, i:i + 1], i, cache, None, 1)
        next_tok = torch.where(finished, pad_token_id, toks[:, 0].long())
        seqs[:, i + 1] = next_tok
        finished = finished | (next_tok == eos_token_id)
        i += 1
    return seqs


def beam_generate(decode_topk: Callable, cache, batch_size: int, num_beams: int,
                  max_length: int, decoder_start_token_id: int,
                  eos_token_id: int, pad_token_id: int,
                  length_penalty: float = 1.0, device: Device = "cuda",
                  pos_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder-free beam search with HF semantics (finished score =
    logprob_sum / len**length_penalty, early_stopping=False).

    ``cache`` has B*K physical rows that are never reordered; anc[b, k, t]
    names the physical row of beam k's KV at slot t. decode_topk(token_ids
    (B*K, 1), pos, cache, anc, k) -> (top_vals (B*K, k), top_toks, lse,
    cache). ``pos_offset`` is the first writable cache slot: step i writes
    slot pos_offset + i (vlpet_tpu/models/generate.py:238), the slots
    before it (a decoder prefix or prompt, the same in every row) keep the
    identity ancestry. Returns (best_sequences (B, max_length),
    best_scores (B,))."""
    B, K = batch_size, num_beams
    device = resolve_device(device)
    cache_len = cache[0]["k"].shape[0]
    f32 = torch.float32

    alive_seqs = torch.full((B, K, max_length), pad_token_id, dtype=torch.long,
                            device=device)
    alive_seqs[:, :, 0] = decoder_start_token_id
    # only beam 0 is live at step 0, so identical beams do not duplicate
    alive_logp = torch.tensor([0.0] + [NEG_INF] * (K - 1), dtype=f32,
                              device=device).repeat(B, 1)
    fin_seqs = torch.full((B, K, max_length), pad_token_id, dtype=torch.long,
                          device=device)
    fin_scores = torch.full((B, K), NEG_INF, dtype=f32, device=device)
    # int32, as the JAX loop holds it: the attends read it in place
    own_row = torch.arange(K, dtype=torch.int32, device=device)
    anc = own_row[None, :, None].expand(B, K, cache_len).clone()

    i = 0
    while i < max_length - 1:
        # early_stopping=False: stop when the best alive score at the
        # current length can no longer beat the worst finished score
        norm = (_len_norm(i + 1, length_penalty, device)
                if length_penalty > 0 else 1.0)
        best_alive = alive_logp.max(dim=1).values / norm
        if bool((fin_scores.min(dim=1).values >= best_alive).all()):
            break
        tok = alive_seqs[:, :, i]
        # this step's KV lands in each beam's own physical row
        anc[:, :, pos_offset + i] = own_row
        top_vals, top_tok, lse, cache = decode_topk(tok.reshape(B * K, 1), i,
                                                    cache, anc, 2 * K)
        top_lp = (top_vals - lse[:, None]).reshape(B, K, 2 * K)
        top_lp = top_lp + alive_logp[..., None]
        top_logp, flat_idx = stable_topk(top_lp.reshape(B, K * 2 * K), 2 * K)
        beam_idx = flat_idx // (2 * K)
        tok_idx = torch.gather(top_tok.reshape(B, K * 2 * K).long(), 1,
                               flat_idx)

        cand_seqs = _gather_beams(alive_seqs, beam_idx)  # (B, 2K, L)
        cand_seqs[:, :, i + 1] = tok_idx
        is_eos = tok_idx == eos_token_id

        fin_cand = torch.where(
            is_eos, top_logp / _len_norm(i + 1, length_penalty, device),
            NEG_INF)
        all_fin_scores = torch.cat([fin_scores, fin_cand], dim=1)
        all_fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        fin_scores, top_fin_idx = stable_topk(all_fin_scores, K)
        fin_seqs = _gather_beams(all_fin_seqs, top_fin_idx)

        alive_cand = torch.where(is_eos, NEG_INF, top_logp)
        alive_logp, alive_idx = stable_topk(alive_cand, K)
        alive_seqs = _gather_beams(cand_seqs, alive_idx)

        # inherit the chosen parents' ancestry: an integer gather over
        # (B, K, L) instead of reordering the KV cache
        anc = _gather_beams(anc, torch.gather(beam_idx, 1, alive_idx))
        i += 1

    # hypotheses still alive at max length join the pool (scored over their
    # generated length, with eos appended)
    norm = (_len_norm(max_length - 1, length_penalty, device)
            if length_penalty > 0 else 1.0)
    alive_final = alive_logp / norm
    best_fin, best_fin_score = fin_seqs[:, 0], fin_scores[:, 0]
    best_alive_idx = alive_final.argmax(dim=1)
    best_alive = _gather_beams(alive_seqs, best_alive_idx[:, None])[:, 0]
    best_alive[:, -1] = eos_token_id
    best_alive_score = torch.gather(alive_final, 1, best_alive_idx[:, None])[:, 0]
    pick_alive = best_alive_score > best_fin_score
    seqs = torch.where(pick_alive[:, None], best_alive, best_fin)
    scores = torch.where(pick_alive, best_alive_score, best_fin_score)
    return seqs, scores


@torch.inference_mode()
def seq2seq_generate(model, *, input_ids, attention_mask, vis_feats=None,
                     boxes=None, img_order_ids=None, obj_order_ids=None,
                     vis_attention_mask=None, ctx=None, num_beams: int = 1,
                     max_length: int = 20,
                     length_penalty: float = 1.0) -> torch.Tensor:
    """End-to-end generation for a port VLBart or VLT5, with the
    backbone's start, eos and pad ids (T5: 0, 1, 0). Returns token ids
    (B, max_length) with the start token at position 0. In beam mode the
    joint mask and the cross K/V stay at B rows, shared by the K beams.
    A decoder prefix or input prompt of P slots (``model.prefill_kvs``)
    is written into the first P slots of a cache of max_length + P once,
    and step i decodes at position P + i (vlpet_tpu/models/
    generate.py:356-393)."""
    cfg = model.cfg
    bk = cfg.backbone
    B = input_ids.shape[0]
    device = input_ids.device
    enc_out, joint_mask = model.encode(input_ids, attention_mask, vis_feats,
                                       boxes, img_order_ids, obj_order_ids,
                                       vis_attention_mask, ctx)
    consts = model.init_decode(enc_out, ctx)
    n = B * num_beams if num_beams > 1 else B
    dtype = compute_dtype(cfg)
    prefill = model.prefill_kvs(n, ctx)
    P = prefill[0][0].shape[1] if prefill is not None else 0
    tp = getattr(model, "tp", None)
    cache = init_self_cache(cfg, n, max_length + P, dtype, device,
                            model_axis=tp.size if tp is not None else 1)
    for layer, (k, v) in zip(cache, prefill or ()):
        layer["k"][:P] = k.transpose(0, 1).to(dtype)
        layer["v"][:P] = v.transpose(0, 1).to(dtype)

    def decode_topk(tok, pos, cache, beam_anc, k):
        return model.decode_step_topk(tok, joint_mask, consts, cache, pos + P,
                                      k, ctx, beam_anc)

    start, eos, pad = (bk.decoder_start_token_id, bk.eos_token_id,
                       bk.pad_token_id)
    if num_beams > 1:
        seqs, _ = beam_generate(decode_topk, cache, B, num_beams, max_length,
                                start, eos, pad, length_penalty,
                                device=device, pos_offset=P)
        return seqs
    return greedy_generate(decode_topk, cache, B, max_length, start, eos, pad,
                           device=device)
