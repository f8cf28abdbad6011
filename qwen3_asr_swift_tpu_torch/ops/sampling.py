"""On-device token selection — port of ``qwen3_asr_swift_tpu/ops/sampling.py``.

Greedy (argmax), temperature (Gumbel-max), the repetition penalty, the
no-repeat-n-gram mask, top-k and top-p, each a tensor transform on the
logits' device: the decode loop never fetches logits to the host.

The temperature noise comes from an explicit ``torch.Generator`` on the
logits' device. It cannot reproduce ``jax.random``'s bits, so sampled
tokens match the reference in distribution, not token by token; the
penalties, top-k and top-p are deterministic and match it exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

#: the reference's mask value for sampling (the attention code uses -1e30)
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingOptions:
    """The reference's ``SamplingOptions`` fields, unchanged."""

    max_tokens: int = 448
    repetition_penalty: float = 1.0
    no_repeat_ngram: int = 0
    temperature: float = 0.0
    top_k: int = 0
    #: bench/test knob: force EOS at this decode step (0 = off)
    force_eos_after: int = 0
    #: beam width (0/1 = greedy or sampled decode)
    beam: int = 0
    #: GNMT length penalty α of beam's final selection: score / len**α
    length_penalty: float = 1.0

    @property
    def is_greedy(self) -> bool:
        return (self.repetition_penalty == 1.0 and self.no_repeat_ngram == 0
                and self.temperature == 0.0 and self.top_k == 0)


def check_supported(opts: SamplingOptions) -> None:
    """Reject what the reference rejects (its ``model.py`` beam dispatch)."""
    if opts.beam > 1:
        if not opts.is_greedy:
            raise ValueError(
                "beam search is deterministic; SamplingOptions(beam=K) "
                "requires greedy scoring (no temperature/top_k/"
                "penalties)")
        if opts.force_eos_after:
            raise ValueError("beam does not support force_eos_after")


def _lengths(gen_len: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    return torch.as_tensor(gen_len, device=device).reshape(-1).expand(b)


def apply_repetition_penalty(logits: torch.Tensor, generated: torch.Tensor, gen_len,
                             penalty: float) -> torch.Tensor:
    """HF-style: logits of tokens among the first ``gen_len`` entries of
    ``generated`` [B, L] are divided (if > 0) or multiplied (if ≤ 0) by
    ``penalty``. logits [B, V] fp32."""
    b, v = logits.shape
    l = generated.shape[-1]
    valid = torch.arange(l, device=logits.device)[None, :] < _lengths(gen_len, b, logits.device)[:, None]
    seen = torch.zeros((b, v), dtype=torch.int32, device=logits.device)
    seen.scatter_add_(1, generated.long(), valid.to(torch.int32))
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen > 0, penalized, logits)


def apply_no_repeat_ngram(logits: torch.Tensor, generated: torch.Tensor, gen_len,
                          n: int) -> torch.Tensor:
    """Mask (to NEG_INF) every token that would complete an n-gram already
    in the first ``gen_len`` entries of ``generated`` [B, L]: all L windows
    are compared with the trailing (n-1)-gram at once."""
    if n <= 0:
        return logits
    b, v = logits.shape
    l = generated.shape[-1]
    dev = logits.device
    g = generated.long()
    glen = _lengths(gen_len, b, dev).long()
    span = torch.arange(n - 1, device=dev)
    tail_idx = glen[:, None] - (n - 1) + span[None, :]                        # [B, n-1]
    tail = torch.where(tail_idx >= 0, g.gather(1, tail_idx.clamp(0, l - 1)),
                       torch.full_like(tail_idx, -1))
    starts = torch.arange(l, device=dev)
    win_idx = (starts[:, None] + span[None, :]).clamp(0, l - 1)               # [L, n-1]
    windows = g[:, win_idx]                                                    # [B, L, n-1]
    complete = (starts[None, :] + n - 1) < glen[:, None]                       # [B, L]
    match = (windows == tail[:, None, :]).all(dim=-1) & complete & (glen >= n - 1)[:, None]
    forbidden = g[:, (starts + n - 1).clamp(0, l - 1)]                         # [B, L]
    hit = torch.zeros((b, v), dtype=torch.int32, device=dev)
    hit.scatter_add_(1, forbidden, match.to(torch.int32))
    return torch.where(hit > 0, torch.full_like(logits, NEG_INF), logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every logit ``>=`` the k-th largest (ties with it survive)."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest descending-probability prefix whose
    cumulative probability reaches ``p`` (the crossing token included)."""
    if p >= 1.0:
        return logits
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < p).sum(dim=-1, keepdim=True)                    # >= 1
    cutoff = desc.gather(-1, n_keep - 1)
    return torch.where(logits >= cutoff, logits, torch.full_like(logits, NEG_INF))


def sample_token(logits: torch.Tensor, opts: SamplingOptions,
                 generator: Optional[torch.Generator] = None,
                 generated: Optional[torch.Tensor] = None, gen_len=None,
                 noise_rows: Optional[tuple] = None) -> torch.Tensor:
    """Select the next token: logits [B, V] → int64 [B] (first maximum on
    ties, as ``jnp.argmax``). The penalties read ``generated`` [B, L] up to
    ``gen_len``; temperature draws its Gumbel noise from ``generator``.
    ``noise_rows`` (first row, rows of the request): the logits are rows of
    a larger batch (a dp rank's); the noise is drawn for the request's rows
    and this rank's kept, so the draws do not depend on how the batch is
    split. Rows past the request (the copies of its last clip that pad it
    for dp) take the last row's noise."""
    lg = logits.float()
    if opts.repetition_penalty != 1.0 and generated is not None:
        lg = apply_repetition_penalty(lg, generated, gen_len, opts.repetition_penalty)
    if opts.no_repeat_ngram > 0 and generated is not None:
        lg = apply_no_repeat_ngram(lg, generated, gen_len, opts.no_repeat_ngram)
    if opts.top_k > 0:
        lg = apply_top_k(lg, opts.top_k)
    if opts.temperature > 0.0:
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        # Gumbel-max: argmax(logits/T + G) ~ Categorical(softmax(logits/T))
        if noise_rows is None:
            u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
        else:
            first, total = noise_rows
            u = torch.rand((total, lg.shape[-1]), generator=generator, device=lg.device,
                           dtype=torch.float32)
            rows = torch.arange(first, first + lg.shape[0], device=lg.device)
            u = u[rows.clamp(max=total - 1)]
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        lg = lg / opts.temperature + gumbel
    return torch.argmax(lg, dim=-1)


def force_eos_after(tok: torch.Tensor, step: int, opts: SamplingOptions, eos_id: int) -> torch.Tensor:
    """The bench/test stop: EOS from step ``opts.force_eos_after`` on."""
    if opts.force_eos_after and step >= opts.force_eos_after:
        return torch.full_like(tok, eos_id)
    return tok


def log_softmax_confidence(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Per-row log-prob of the selected ids, fp32 [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, token_ids.long()[..., None])[..., 0]
