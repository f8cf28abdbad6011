"""Token selection — port of the greedy part of ``qwen3_asr_swift_tpu/ops/sampling.py``.

Greedy selection is an argmax on device; the decode loop never fetches
logits to the host. Temperature, top-k, the repetition and n-gram
penalties and beam search are not ported yet: :func:`check_supported`
raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses

import torch


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
    #: beam width (0/1 = greedy)
    beam: int = 0
    length_penalty: float = 1.0

    @property
    def is_greedy(self) -> bool:
        return (self.repetition_penalty == 1.0 and self.no_repeat_ngram == 0
                and self.temperature == 0.0 and self.top_k == 0)


def check_supported(opts: SamplingOptions) -> None:
    if not opts.is_greedy:
        raise NotImplementedError(
            "only greedy decoding is ported: temperature, top_k and the "
            "repetition / n-gram penalties are not")
    if opts.beam > 1:
        raise NotImplementedError("beam search is not ported")


def sample_token(logits: torch.Tensor, opts: SamplingOptions) -> torch.Tensor:
    """Greedy selection: logits [B, V] → int64 [B] (first maximum on ties,
    as ``jnp.argmax``)."""
    check_supported(opts)
    return torch.argmax(logits.float(), dim=-1)


def force_eos_after(tok: torch.Tensor, step: int, opts: SamplingOptions, eos_id: int) -> torch.Tensor:
    """The bench/test stop: EOS from step ``opts.force_eos_after`` on."""
    if opts.force_eos_after and step >= opts.force_eos_after:
        return torch.full_like(tok, eos_id)
    return tok


def log_softmax_confidence(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Per-row log-prob of the selected ids, fp32 [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, token_ids.long()[..., None])[..., 0]
