"""Beam search for the Qwen3-ASR decoder — port of
``qwen3_asr_swift_tpu/models/qwen3_asr/beam.py``.

The beam folds into the batch axis (B·K rows). The prompt is prefilled
once at batch B, then the cache is tiled to B·K hypotheses. Each step:

- one batched ``decode_step`` over all hypotheses (K1 at B·K rows for a
  packed decoder, K3 on an int8 cache);
- candidate scores ``scores + log_softmax(logits)`` over ``[B, K·V]`` and
  one top-k per request;
- the hypothesis reorder as a row gather, the KV cache included.

A finished hypothesis (it emitted EOS) is frozen: its only continuation
is ``pad`` at +0 score (``pad_row``), so it competes unchanged while live
ones grow. The loop stops when every hypothesis is finished or the budget
is spent. The final choice is GNMT-style: among finished hypotheses (all,
if none finished), the argmax of ``score / len**length_penalty``.

The output contract is the greedy path's: (tokens [B, max_new], logprobs
[B, max_new]) with EOS stored in place and pads elsewhere, so ``n_gen``
and the postprocessing are shared.
"""

from __future__ import annotations

import torch

from ...ops.kv_cache import gather_cache, repeat_cache
from ...ops.sampling import NEG_INF
from .decoder import decode_step


@torch.inference_mode()
def beam_search(model, audio_tokens, n_audio, prompt, max_new: int, beam: int,
                length_penalty: float = 1.0):
    """Beam search of width ``beam`` for every clip of the batch."""
    dcfg = model.cfg.decoder
    eos, pad = model.cfg.eos_id, model.cfg.pad_id
    dev = model.device
    k = beam
    t_prompt = prompt.prefix_ids.shape[1] + audio_tokens.shape[1] + prompt.suffix_ids.shape[1]
    logits0, cache, _ = model._prefill(audio_tokens, n_audio, prompt, t_prompt + max_new,
                                       model.kv_dtype)
    b, v = logits0.shape
    logp0 = torch.log_softmax(logits0.float(), dim=-1)
    scores0, tok0 = torch.topk(logp0, k, dim=-1)                   # [B, K]
    cache = repeat_cache(cache, k)
    bk = b * k
    tok = tok0.reshape(bk)
    tokens = torch.full((bk, max_new), pad, dtype=torch.int64, device=dev)
    tokens[:, 0] = tok
    lps = torch.zeros((bk, max_new), dtype=torch.float32, device=dev)
    lps[:, 0] = scores0.reshape(bk)
    scores = scores0.reshape(bk)
    fin = tok == eos
    # the row a finished hypothesis keeps feeding decode_step is pad; its
    # writes land on rows the final selection never reads
    pad_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
    pad_row[pad] = 0.0
    base = torch.arange(b, device=dev)[:, None] * k

    step = 1
    while step < max_new and not bool(fin.all()):   # the reference's loop condition
        logits, cache = decode_step(model.decoder_params, dcfg, tok, cache, model._mesh)
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(fin[:, None], pad_row[None, :], logp)
        cand = (scores[:, None] + logp).reshape(b, k * v)
        new_scores, idx = torch.topk(cand, k, dim=-1)               # [B, K]
        tok = (idx % v).reshape(bk)
        gidx = (base + idx // v).reshape(bk)
        tokens = tokens.index_select(0, gidx)
        lps = lps.index_select(0, gidx)
        was_fin = fin.index_select(0, gidx)
        old_scores = scores.index_select(0, gidx)
        cache = gather_cache(cache, gidx)
        scores = new_scores.reshape(bk)
        emit = ~was_fin
        tokens[:, step] = torch.where(emit, tok, torch.full_like(tok, pad))
        lps[:, step] = torch.where(emit, scores - old_scores, torch.zeros_like(scores))
        fin = was_fin | (tok == eos)
        step += 1

    lens = (tokens != pad).sum(dim=1).float()
    norm = (scores / lens.clamp(min=1.0) ** length_penalty).reshape(b, k)
    fin_bk = fin.reshape(b, k)
    any_fin = fin_bk.any(dim=1, keepdim=True)
    ranked = torch.where(fin_bk | ~any_fin, norm, torch.full_like(norm, -torch.inf))
    sel = base[:, 0] + ranked.argmax(dim=1)
    return tokens.index_select(0, sel), lps.index_select(0, sel)
