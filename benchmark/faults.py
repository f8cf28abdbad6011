"""Faults planted in the program, so that the check can be seen to come out
false: each ``plant`` sets a fault and returns what undoes it. Plant before
the family's ``Runner`` builds the model: it wraps the methods it finds."""

from __future__ import annotations

from typing import Callable


def _token_altered():
    """Every sampled token moved one up the vocabulary, where it is produced."""
    import qwen3_asr_swift_tpu_torch.models.qwen3_asr.model as module

    sample = module.sample_token
    return module, "sample_token", lambda lg, *a, **kw: (sample(lg, *a, **kw) + 1) % lg.shape[-1]


def _state_unchanged():
    """A decode step that leaves the cache as it found it."""
    import qwen3_asr_swift_tpu_torch.models.qwen3_asr.decoder as module

    return module, "write_token", lambda layer, k, v, cursor: layer


def _half_batch():
    """The second half of the rows never encoded: the first half's mean in their place."""
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.model import Qwen3ASR

    encode = Qwen3ASR._encode

    def half(self, st):
        tokens, n = encode(self, st)
        h = max(tokens.shape[0] // 2, 1)
        tokens = tokens.clone()
        tokens[h:] = tokens[:h].mean(dim=0, keepdim=True)
        return tokens, n

    return Qwen3ASR, "_encode", half


FAULTS = {"token_altered": _token_altered, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


def plant(name: str) -> Callable[[], None]:
    """Set fault ``name`` in the program; returns its undo."""
    owner, attr, fault = FAULTS[name]()
    orig = getattr(owner, attr)
    setattr(owner, attr, fault)
    return lambda: setattr(owner, attr, orig)
