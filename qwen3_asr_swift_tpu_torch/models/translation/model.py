"""MADLAD-400 translation (T5 v1.1 encoder-decoder) — port of
``qwen3_asr_swift_tpu/models/translation/model.py``.

The target language is chosen by prepending ``<2xx>`` to the source text;
SentencePiece tokenizer; greedy decode with a static self-attention cache
of ``max_new`` slots. T5: relative-position-bucket attention bias (32
buckets, max distance 128; bidirectional in the encoder), pre-RMSNorm,
no 1/√d attention scaling, gated-GELU (tanh) FFN, a separate LM head on
``x · d_model^-0.5``.

The bucket function takes a float32 ``log`` and truncates it to an int, so
at a bucket's edge two implementations of ``log`` can pick different
buckets. The port computes its bucket tables on the host with numpy's
float32 ``log`` (equal to the reference's XLA on the CPU at every relative
position the tests try) once per shape, and moves them to the device.

The decode loop runs its steps on the device: the done flags are read on
the host every ``DONE_CHECK_STEPS`` steps, and a row's writes after its
EOS are masked to pad, so the ids equal those of the reference's
``while_loop``, which stops once every row is done. The cross-attention
keys and values of the encoder output are taken once, before the loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import TranslationModel
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import embedding_lookup, linear, rms_norm

#: decode steps between two host reads of the done flags
DONE_CHECK_STEPS = 8


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256000
    d_model: int = 1024
    d_kv: int = 128
    num_heads: int = 16
    d_ff: int = 8192
    num_encoder_layers: int = 32
    num_decoder_layers: int = 32
    rel_buckets: int = 32
    rel_max_distance: int = 128
    rms_norm_eps: float = 1e-6
    eos_token_id: int = 1
    pad_token_id: int = 0
    decoder_start_token_id: int = 0


CONFIG_3B = T5Config()


def config_tiny(vocab: int = 128) -> T5Config:
    return T5Config(vocab_size=vocab, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                    num_encoder_layers=2, num_decoder_layers=2)


def relative_position_bucket(rel_pos, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """T5 bucket function (HF semantics) in numpy, float32 as the
    reference's: int array ``rel_pos`` → buckets."""
    n = -np.asarray(rel_pos, np.int64)
    ret = 0
    if bidirectional:
        num_buckets //= 2
        ret = np.where(n < 0, num_buckets, 0)
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    x = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-9)
    val_large = max_exact + (np.log(x) / np.float32(np.log(max_distance / max_exact))
                             * np.float32(num_buckets - max_exact)).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


@functools.lru_cache(maxsize=32)
def bucket_table(q_len: int, k_len: int, bidirectional: bool, num_buckets: int,
                 max_distance: int, q_offset: int = 0) -> np.ndarray:
    """[q_len, k_len] buckets of key j for query i at position q_offset + i."""
    rel = np.arange(k_len)[None, :] - (np.arange(q_len)[:, None] + q_offset)
    return relative_position_bucket(rel, bidirectional, num_buckets, max_distance)


def rel_bias(table: torch.Tensor, buckets: np.ndarray) -> torch.Tensor:
    """table [buckets, heads], a bucket table [q, k] → bias [1, heads, q, k]
    (fp32)."""
    idx = torch.from_numpy(np.ascontiguousarray(buckets)).to(table.device)
    return table[idx].permute(2, 0, 1)[None].float()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _draw_params(cfg: T5Config, normal, ones) -> dict:
    inner = cfg.num_heads * cfg.d_kv

    def lin(i, o):
        return {"kernel": normal((i, o), 1.0 / np.sqrt(i))}

    def attn():
        return {"q": lin(cfg.d_model, inner), "k": lin(cfg.d_model, inner),
                "v": lin(cfg.d_model, inner), "o": lin(inner, cfg.d_model)}

    def ffn():
        return {"wi_0": lin(cfg.d_model, cfg.d_ff), "wi_1": lin(cfg.d_model, cfg.d_ff),
                "wo": lin(cfg.d_ff, cfg.d_model)}

    def norm():
        return {"weight": ones(cfg.d_model)}

    params = {
        "shared": normal((cfg.vocab_size, cfg.d_model), 0.02),
        "lm_head": lin(cfg.d_model, cfg.vocab_size),
        "enc_rel": normal((cfg.rel_buckets, cfg.num_heads), 0.1),
        "dec_rel": normal((cfg.rel_buckets, cfg.num_heads), 0.1),
        "enc_final_norm": norm(), "dec_final_norm": norm(),
        "encoder": [], "decoder": [],
    }
    for _ in range(cfg.num_encoder_layers):
        params["encoder"].append({"ln1": norm(), "attn": attn(), "ln2": norm(), "ffn": ffn()})
    for _ in range(cfg.num_decoder_layers):
        params["decoder"].append({"ln1": norm(), "self_attn": attn(), "ln2": norm(),
                                  "cross_attn": attn(), "ln3": norm(), "ffn": ffn()})
    return params


def init_t5_params(rng: np.random.Generator, cfg: T5Config) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.ones((n,), np.float32))


def init_t5_params_on_device(cfg: T5Config, generator: torch.Generator,
                             dtype: torch.dtype = torch.float32) -> dict:
    """The same tree drawn on the generator's device, each leaf drawn in
    fp32 and kept in ``dtype`` (so the 3B's fp32 draws never live at once)."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: (torch.randn(shape, generator=generator, device=dev)
                                   * scale).to(dtype),
        lambda n: torch.ones((n,), device=dev, dtype=dtype))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, _, t, _ = x.shape
    return x.transpose(1, 2).reshape(b, t, -1)


def _t5_attn(p, q_in, kv_in, cfg: T5Config, bias=None):
    q = _heads(linear(q_in, p["q"]), cfg)
    k = _heads(linear(kv_in, p["k"]), cfg)
    v = _heads(linear(kv_in, p["v"]), cfg)
    out = sdpa(q, k, v, 1.0, mask=bias)  # T5: no 1/sqrt(d) scaling
    return linear(_merge(out), p["o"])


def _t5_ffn(p, x):
    gate = torch.nn.functional.gelu(linear(x, p["wi_0"]), approximate="tanh")
    return linear(gate * linear(x, p["wi_1"]), p["wo"])


def _pad_bias(valid: torch.Tensor) -> torch.Tensor:
    """valid [B, T] bool → additive bias [B, 1, 1, T] (fp32)."""
    return torch.where(valid[:, None, None, :], 0.0, NEG_INF).to(torch.float32)


def t5_encode(params, cfg: T5Config, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    x = embedding_lookup(params["shared"], ids)
    t = ids.shape[1]
    bias = rel_bias(params["enc_rel"], bucket_table(t, t, True, cfg.rel_buckets,
                                                    cfg.rel_max_distance))
    bias = bias + _pad_bias(valid)
    for p in params["encoder"]:
        h = rms_norm(x, p["ln1"]["weight"], cfg.rms_norm_eps)
        x = x + _t5_attn(p["attn"], h, h, cfg, bias)
        h = rms_norm(x, p["ln2"]["weight"], cfg.rms_norm_eps)
        x = x + _t5_ffn(p["ffn"], h)
    return rms_norm(x, params["enc_final_norm"]["weight"], cfg.rms_norm_eps)


def cross_kv(params, cfg: T5Config, enc_out: torch.Tensor):
    """Every decoder layer's cross-attention keys and values of the encoder
    output, [B, H, T, D] each (the reference computes them at every step)."""
    return [(_heads(linear(enc_out, p["cross_attn"]["k"]), cfg),
             _heads(linear(enc_out, p["cross_attn"]["v"]), cfg)) for p in params["decoder"]]


def decoder_bias(params, cfg: T5Config, max_new: int) -> torch.Tensor:
    """Each step's self-attention bias over the ``max_new`` cache slots:
    [max_new, 1, heads, 1, max_new], relative position and causal mask."""
    table = bucket_table(max_new, max_new, False, cfg.rel_buckets, cfg.rel_max_distance)
    bias = rel_bias(params["dec_rel"], table)[0]                      # [H, steps, slots]
    dev = bias.device
    causal = (torch.arange(max_new, device=dev)[None, :]
              <= torch.arange(max_new, device=dev)[:, None])
    bias = bias + torch.where(causal, 0.0, NEG_INF)[None]
    return bias.permute(1, 0, 2)[:, None, :, None, :]


def t5_decode_step(params, cfg: T5Config, tok: torch.Tensor, enc_kv, enc_bias, self_kv,
                   step: int, step_bias: torch.Tensor) -> torch.Tensor:
    """tok [B]; enc_kv from :func:`cross_kv`; enc_bias [B, 1, 1, T];
    self_kv a list of (k [B, H, L, D], v) a layer, written in place at
    ``step``; step_bias [1, H, 1, L] (:func:`decoder_bias`'s row). Returns
    fp32 logits [B, V]."""
    x = embedding_lookup(params["shared"], tok)[:, None]
    for li, p in enumerate(params["decoder"]):
        h = rms_norm(x, p["ln1"]["weight"], cfg.rms_norm_eps)
        q = _heads(linear(h, p["self_attn"]["q"]), cfg)
        kc, vc = self_kv[li]
        kc[:, :, step: step + 1] = _heads(linear(h, p["self_attn"]["k"]), cfg).to(kc.dtype)
        vc[:, :, step: step + 1] = _heads(linear(h, p["self_attn"]["v"]), cfg).to(vc.dtype)
        attn = sdpa(q, kc, vc, 1.0, mask=step_bias)
        x = x + linear(_merge(attn), p["self_attn"]["o"])

        h = rms_norm(x, p["ln2"]["weight"], cfg.rms_norm_eps)
        ck, cv = enc_kv[li]
        cq = _heads(linear(h, p["cross_attn"]["q"]), cfg)
        x = x + linear(_merge(sdpa(cq, ck, cv, 1.0, mask=enc_bias)), p["cross_attn"]["o"])
        h = rms_norm(x, p["ln3"]["weight"], cfg.rms_norm_eps)
        x = x + _t5_ffn(p["ffn"], h)
    x = rms_norm(x, params["dec_final_norm"]["weight"], cfg.rms_norm_eps)
    logits = linear(x[:, 0] * (cfg.d_model ** -0.5), params["lm_head"])
    return logits.float()


def greedy_translate(params, cfg: T5Config, ids: torch.Tensor, valid: torch.Tensor,
                     max_new: int, on_step=None):
    """The reference's ``_translate``: encode, then greedy steps until every
    row has emitted EOS or ``max_new`` steps ran; a row's ids after its EOS
    are pad. → (ids [B, max_new], steps run, host reads of the flags). The
    self-attention bias is expanded to the batch, so rows past the first
    run too (the reference's step fails there: ROADMAP §3).
    ``on_step(step, logits)``, where given, sees each step's logits."""
    enc_out = t5_encode(params, cfg, ids, valid)
    b = ids.shape[0]
    dev = ids.device
    enc_kv = cross_kv(params, cfg, enc_out)
    enc_bias = _pad_bias(valid)
    biases = decoder_bias(params, cfg, max_new)
    kv = [(enc_out.new_zeros((b, cfg.num_heads, max_new, cfg.d_kv)),
           enc_out.new_zeros((b, cfg.num_heads, max_new, cfg.d_kv)))
          for _ in range(cfg.num_decoder_layers)]
    out = torch.full((b, max_new), cfg.pad_token_id, dtype=torch.long, device=dev)
    tok = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pad = torch.tensor(cfg.pad_token_id, device=dev)
    steps = reads = 0
    for step in range(max_new):
        logits = t5_decode_step(params, cfg, tok, enc_kv, enc_bias, kv, step,
                                biases[step].expand(b, -1, -1, -1))
        if on_step is not None:
            on_step(step, logits)
        tok = torch.where(done, pad, torch.argmax(logits, dim=-1))
        out[:, step] = tok
        done = done | (tok == cfg.eos_token_id)
        steps = step + 1
        if steps % DONE_CHECK_STEPS == 0 and steps < max_new:
            reads += 1
            if bool(done.all()):
                break
    return out, steps, reads


class MADLADTranslator(TranslationModel):
    """MADLAD-400 on one device (the card unless the caller asks for the
    CPU). ``params`` is a tree in the reference's layout."""

    def __init__(self, cfg: T5Config, params, tokenizer=None, dtype: torch.dtype = torch.float32,
                 *, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        #: the last decode's loop: {"steps", "reads"} (host reads of the
        #: done flags)
        self.last_loop = {"steps": 0, "reads": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[T5Config] = None, seed: int = 0, *, device="cuda",
                    **kw) -> "MADLADTranslator":
        """Random weights (``config_tiny()`` by default) drawn from a
        ``torch.Generator`` seeded ``seed`` on the host."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_t5_params_on_device(cfg, torch.Generator().manual_seed(seed)),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[T5Config] = None, seed: int = 0, *,
                              device="cuda", dtype: torch.dtype = torch.float32,
                              **kw) -> "MADLADTranslator":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``,
        kept in ``dtype``: the quick way to build the 3B."""
        cfg = cfg or CONFIG_3B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_t5_params_on_device(cfg, generator, dtype), device=dev,
                   dtype=dtype, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "google/madlad400-3b-mt", cache_dir=None,
                        offline_mode: bool = False, dtype: torch.dtype = torch.bfloat16,
                        **kw) -> "MADLADTranslator":
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``), loaded in bf16 as the
        reference loads it."""
        from pathlib import Path

        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from ...tokenizers.sentencepiece_model import SentencePieceModel
        from .convert import convert_t5_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        cfg = CONFIG_3B
        params = convert_t5_checkpoint(load_safetensors(model_dir), cfg)
        spm = sorted(Path(model_dir).glob("*.model"))
        tokenizer = SentencePieceModel.load(spm[0]) if spm else None
        return cls(cfg, params, tokenizer=tokenizer, dtype=dtype, **kw)

    def prepare(self, ids: Sequence[int]):
        """Source ids → (ids [1, bucket], valid [1, bucket]) on the device,
        the bucket a multiple of 16."""
        n = len(ids)
        t_bucket = max(16, ((n + 15) // 16) * 16)
        arr = np.full((1, t_bucket), self.cfg.pad_token_id, np.int64)
        arr[0, :n] = ids
        valid = np.zeros((1, t_bucket), bool)
        valid[0, :n] = True
        return torch.from_numpy(arr).to(self.device), torch.from_numpy(valid).to(self.device)

    @torch.inference_mode()
    def translate_ids(self, ids: Sequence[int], max_new: int = 128) -> List[int]:
        arr, valid = self.prepare(ids)
        out, steps, reads = greedy_translate(self.params, self.cfg, arr, valid, max_new)
        self.last_loop = {"steps": steps, "reads": reads}
        toks = []
        for t in out[0].tolist():
            if t == self.cfg.eos_token_id:
                break
            if t != self.cfg.pad_token_id:
                toks.append(t)
        return toks

    def translate(self, text: str, target_lang: str = "en", max_new: int = 128, **kwargs) -> str:
        """Prepend the ``<2xx>`` target-language token (reference:
        MADLADTranslator.swift — '<2de> text' form)."""
        if self.tokenizer is None:
            raise RuntimeError("translation requires a tokenizer")
        prompt = f"<2{target_lang}> {text}"
        ids = self.tokenizer.encode(prompt) + [self.cfg.eos_token_id]
        out_ids = self.translate_ids(ids, max_new=max_new)
        return self.tokenizer.decode(out_ids)

    def translate_stream(self, text: str, target_lang: str = "en", **kw) -> Iterator[str]:
        yield self.translate(text, target_lang, **kw)

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
