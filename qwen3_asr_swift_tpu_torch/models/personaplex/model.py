"""PersonaPlex 7B: Moshi-architecture full-duplex speech-to-speech — port of
the offline path of ``qwen3_asr_swift_tpu/models/personaplex/model.py``.

- 17 token streams (1 text + 8 user-audio + 8 agent-audio codebooks),
  embedded and summed into the temporal transformer's input each 80 ms
  frame (:func:`embed_frame`);
- the temporal transformer (32 layers, d 4096, RoPE base 1e4) over the
  port's KV cache (float, read through ``cache_kv`` + plain ``sdpa``, as in
  the reference); q/k/v and gate/up fuse, and a packed tree's products at
  ≤ 256 rows (every frame step, the text head, the 96-row prompt prefill)
  run kernel K1;
- the depformer (6 layers, d 1024) with per-codebook weight banks, a
  ``dep_context``-step attention window and no positional encoding,
  generating the 16 codebooks of a frame in turn;
- the published stream delays (text and the two semantic codebooks at
  delay 0, acoustic 1-7 at delay 1: :func:`user_stream_reads`,
  :func:`depformer_provided_tokens`) and the 5-phase prompt (voice prompt
  embeddings | 0.5 s silence | system prompt | 0.5 s silence | user audio
  consumed a frame a step);
- sampling: top-k with the repetition penalty over a 30-token window,
  Gumbel noise from a ``torch.Generator`` when the temperature is above 0
  (greedy is exact; sampled tokens match the reference in distribution).

The reference runs the conversation as one ``lax.while_loop`` with an
on-device silence counter. Here :meth:`PersonaPlex._converse` is a host
loop of device ops that reads the stop flag every
:data:`STOP_CHECK_FRAMES` frames; frames after the stop record nothing, so
the codes and ``n_steps`` do not depend on the cadence.
``model.last_loop`` holds the frames the loop ran and its host reads.

The full-duplex :class:`RealtimeSession` (``PersonaPlex.realtime_session``)
runs one 80 ms frame a call: streaming Mimi encode, the temporal step with
the stream delays, the text sampler and the depformer over the session's
rolling repetition histories, streaming Mimi decode; ``batch`` sessions
step together.

:meth:`PersonaPlex.shard` spreads the model over a tp mesh of ranks
(``parallel/``, one process a device, each running the same conversation):
the temporal layers are column- (q/k/v, gate/up) and row-parallel (o,
down: a sum over tp each), the text head column-parallel with its logits
gathered before the sampler, the depformer banks ``[steps, in, out]``
split on ``out`` for ``in_proj``/``gating_in``/``dep_heads_bank`` (each of
the fused q|k|v and gate|value blocks split alike) and on ``in`` for
``out_proj``/``gating_out``; Mimi stays whole. Packed temporal products
run K1 on each rank's shard. Every rank samples from the gathered logits
with its own ``torch.Generator`` seeded alike, so every rank draws the
same tokens.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.logging import inference as log
from ...core.params import _normal, params_from_jax
from ...core.protocols import SpeechToSpeechModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.kv_cache import after_prefill, after_token, cache_kv, init_cache, write_prompt, write_token
from ...ops.nn import (fuse_qkv_gate_up, linear, out_features, rms_norm, row_linear,
                       swiglu_mlp, unfuse_qkv_gate_up)
from ...ops.quant import cast_tree, quantize_tree
from ...ops.rope import apply_rope, rope_angles
from ...parallel.mesh import sharded
from .mimi import (MimiConfig, init_mimi_decoder_stream, init_mimi_encoder_stream,
                   init_mimi_params, mimi_decode, mimi_decode_frame, mimi_encode,
                   mimi_encode_frame)
from .mimi import config_tiny as mimi_tiny

#: the stop flag (silence or entropy) is read on the host every this many
#: frames; what a frame records does not depend on it
STOP_CHECK_FRAMES = 8
#: the group size of packed trees: ``quant_bits``'s and the published
#: checkpoint's
GROUP_SIZE = 64

#: 440 Hz reference-tone codes fed on the user streams during prompting
#: (reference: Configuration.swift:82)
SINE_TOKENS = (430, 1268, 381, 1611, 1095, 1495, 56, 472)
#: silence codes fed on the agent streams during prompting and matched by
#: the silence early-stop (reference: Configuration.swift:85)
SILENCE_TOKENS = (948, 243, 1178, 546, 1736, 1030, 1978, 2008)
#: "<system> You are a helpful assistant. ..." pre-tokenized with the
#: upstream tokenizer_spm_32k_3.model (reference: Configuration.swift:90)
DEFAULT_SYSTEM_PROMPT_TOKENS = (
    607, 4831, 578, 493, 298, 272, 3850, 5019, 263,
    506, 1292, 2366, 267, 22876, 362, 263, 934, 4831, 578,
)


@dataclasses.dataclass(frozen=True)
class PersonaPlexConfig:
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    head_dim: int = 128
    intermediate_size: int = 11264
    rope_theta: float = 1e4
    context: int = 3000
    text_vocab: int = 32001   # sentencepiece + pad
    audio_vocab: int = 2049   # 2048 codes + initial/pad token
    num_codebooks: int = 16   # depformer output
    temporal_codebooks: int = 8  # per side in the temporal input
    dep_d_model: int = 1024
    dep_layers: int = 6
    dep_heads: int = 16
    dep_ff: int = 2816        # depformer gating feed-forward width
    dep_context: int = 8      # depformer attention context (Configuration.swift:154)
    rms_norm_eps: float = 1e-8
    text_pad: int = 3         # silence/pad text token
    audio_pad: int = 2048     # initial audio token
    mimi: MimiConfig = MimiConfig()

    @property
    def num_streams(self) -> int:
        return 1 + 2 * self.temporal_codebooks  # 17

    @property
    def audio_card(self) -> int:
        """Audio head output size: card (2048); the +1 initial token exists
        only in embeddings (Depformer.swift:231)."""
        return self.audio_vocab - 1


CONFIG_7B = PersonaPlexConfig()


def config_tiny() -> PersonaPlexConfig:
    return PersonaPlexConfig(
        d_model=32, num_layers=2, num_heads=2, head_dim=16, intermediate_size=64,
        context=64, text_vocab=64, audio_vocab=2049, num_codebooks=16,
        temporal_codebooks=8, dep_d_model=32, dep_layers=2, dep_heads=2,
        dep_ff=48, mimi=mimi_tiny(),
    )


@dataclasses.dataclass(frozen=True)
class PersonaSampling:
    """reference: docs/models/personaplex.md:130-135."""

    audio_top_k: int = 250
    audio_temperature: float = 0.8
    audio_repetition_penalty: float = 1.2
    text_top_k: int = 25
    text_temperature: float = 0.7
    text_repetition_penalty: float = 1.2
    #: tokens of history the repetition penalties look back over
    #: (Configuration.swift:291 repetitionWindow)
    repetition_window: int = 30
    max_steps: int = 500
    #: stop after this many consecutive all-silence agent frames once the
    #: user audio has been consumed; 0 disables (personaplex.md:134)
    silence_stop_frames: int = 15
    #: stop when text-logit entropy stays below this for
    #: ``entropy_stop_window`` consecutive post-user steps; 0 disables
    #: (the reference's default — Configuration.swift:293)
    entropy_stop_threshold: float = 0.0
    entropy_stop_window: int = 10


def _draw_params(cfg: PersonaPlexConfig, normal, ones, finish_linear=None, finish_layer=None):
    """The reference's tree and scales (temporal linears ``{"kernel": [in,
    out]}``, depformer banks ``[steps, in, out]``): ``normal(shape, scale)``
    draws, ``ones(n)`` fills the norms, ``finish_linear`` takes each
    temporal linear and the text head as drawn, ``finish_layer`` each
    temporal layer."""
    d, dd, s, hd = cfg.d_model, cfg.dep_d_model, cfg.num_codebooks, cfg.head_dim
    finish_linear = finish_linear or (lambda p: p)
    finish_layer = finish_layer or (lambda p: p)

    def lin(d_in, d_out):
        return finish_linear({"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))})

    params = {
        "text_embed": normal((cfg.text_vocab, d), 0.02),
        "audio_embed": normal((2 * cfg.temporal_codebooks, cfg.audio_vocab, d), 0.02),
        "text_head": lin(d, cfg.text_vocab),
        "norm": {"weight": ones(d)},
        "layers": [],
        "dep_in": normal((s, d, dd), 0.02),
        "dep_text_emb": normal((cfg.text_vocab, dd), 0.02),
        "dep_embed": normal((s - 1, cfg.audio_vocab, dd), 0.02),
        "dep_heads_bank": normal((s, dd, cfg.audio_card), 0.02),
        "dep_layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(finish_layer({
            "input_layernorm": {"weight": ones(d)},
            "post_attention_layernorm": {"weight": ones(d)},
            "q_proj": lin(d, cfg.num_heads * hd), "k_proj": lin(d, cfg.num_heads * hd),
            "v_proj": lin(d, cfg.num_heads * hd), "o_proj": lin(cfg.num_heads * hd, d),
            "mlp": {"gate_proj": lin(d, cfg.intermediate_size),
                    "up_proj": lin(d, cfg.intermediate_size),
                    "down_proj": lin(cfg.intermediate_size, d)},
        }))
    for _ in range(cfg.dep_layers):
        params["dep_layers"].append({
            "norm1": {"weight": ones(dd)},
            "norm2": {"weight": ones(dd)},
            "in_proj": normal((s, dd, 3 * dd), 0.02),
            "out_proj": normal((s, dd, dd), 0.02),
            "gating_in": normal((s, dd, 2 * cfg.dep_ff), 0.02),
            "gating_out": normal((s, cfg.dep_ff, dd), 0.02),
        })
    return params


def init_personaplex_params(rng: np.random.Generator, cfg: PersonaPlexConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(cfg, lambda shape, scale: _normal(rng, shape, scale),
                        lambda n: np.ones((n,), np.float32))


def init_personaplex_params_on_device(cfg: PersonaPlexConfig, generator: torch.Generator,
                                      quant_bits: Optional[int] = None) -> dict:
    """The same tree drawn on the generator's device; with ``quant_bits``
    each temporal linear and the text head is packed (MLX group 64) as soon
    as it is drawn, so the fp32 temporal stack never exists whole (the 7B's
    is over 26 GB). The layers come fused, for the constructor to pass
    through."""
    dev = generator.device

    def packed(p):
        return quantize_tree(p, quant_bits, GROUP_SIZE, embed_keys=()) if quant_bits else p

    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.ones((n,), device=dev), finish_linear=packed,
        finish_layer=lambda layer: fuse_qkv_gate_up({"layers": [layer]})["layers"][0])


def fuse_temporal_params(params) -> dict:
    """q/k/v → "qkv_proj" and gate/up → "gate_up_proj" in every temporal
    layer (exact output-row concat); no-op on fused trees."""
    return fuse_qkv_gate_up(params)


def unfuse_temporal_params(params, cfg: PersonaPlexConfig) -> dict:
    """Exact inverse of :func:`fuse_temporal_params` (output-row slices)."""
    d = cfg.num_heads * cfg.head_dim
    return unfuse_qkv_gate_up(params, d, d)


def embed_frame(params, cfg: PersonaPlexConfig, text_tok, user_codes, agent_codes):
    """Sum the 17 stream embeddings of one frame. text_tok: [B]; user_codes,
    agent_codes: [B, K]. Negative audio codes contribute zero. → [B, d]."""
    e = params["text_embed"][text_tok.clamp(min=0)]
    k = cfg.temporal_codebooks
    table = params["audio_embed"]

    def gather(first, codes):
        streams = torch.arange(first, first + k, device=codes.device)[None]
        emb = table[streams, codes.clamp(min=0)]                         # [B, K, d]
        return torch.where((codes >= 0)[..., None], emb, torch.zeros_like(emb))

    return e + gather(0, user_codes).sum(dim=1) + gather(k, agent_codes).sum(dim=1)


def user_stream_reads(user_codes, pred_user_prev, step: int, user_frames: int, k: int):
    """User-stream values the temporal input reads at generation step
    ``step`` (cache position ``step-1``), honouring the published delays:
    cb0 has delay 0 (position p holds frame p), cb1-7 delay 1 (frame p-1).
    Before the user audio the positions hold the prompt's sine tokens;
    after it the depformer's own user predictions.

    user_codes: [B, >=k, T]; pred_user_prev: [B, k]; step: a host int. → [B, k]."""
    b = user_codes.shape[0]
    sine = torch.tensor(SINE_TOKENS[:k], device=user_codes.device).expand(b, k)
    p = step - 1
    if p < 0:
        cb0 = sine[:, 0]
    elif p < user_frames:
        cb0 = user_codes[:, 0, p]
    else:
        cb0 = pred_user_prev[:, 0]
    if p < 1:
        ac = sine[:, 1:]
    elif p < user_frames:
        ac = user_codes[:, 1:k, p - 1]
    else:
        ac = pred_user_prev[:, 1:]
    return torch.cat([cb0[:, None], ac], dim=1).long()


def depformer_provided_tokens(user_codes, step: int, user_frames: int, cfg: PersonaPlexConfig):
    """Teacher-forced depformer tokens for generation step ``step``: during
    the user phase the user-codebook steps (8-15) are the real user tokens
    at the current target position (cb0 frame ``step``, cb1-7 frame
    ``step-1``); -1 = sample. → [B, num_codebooks]."""
    k = cfg.temporal_codebooks
    b = user_codes.shape[0]
    dev = user_codes.device
    agent_bank = torch.full((b, cfg.num_codebooks - k), -1, dtype=torch.long, device=dev)
    if step >= user_frames:
        return torch.cat([agent_bank, agent_bank.new_full((b, k), -1)], dim=1)
    cb0 = user_codes[:, 0, min(max(step, 0), user_frames - 1)]
    if step < 1:
        ac = torch.tensor(SINE_TOKENS[1:k], device=dev).expand(b, k - 1)
    else:
        ac = user_codes[:, 1:k, min(step - 1, user_frames - 1)]
    return torch.cat([agent_bank, cb0[:, None].long(), ac.long()], dim=1)


def temporal_heads(params, cfg: PersonaPlexConfig) -> int:
    """The temporal heads this rank's tree holds (all unless tp cut them)."""
    p = params["layers"][0]
    return cfg.num_heads if "q_proj" not in p else out_features(p["q_proj"]) // cfg.head_dim


def text_logits(params, cfg: PersonaPlexConfig, hidden, mesh=None) -> torch.Tensor:
    """The text head's fp32 logits, gathered over tp where it is cut."""
    logits = linear(hidden, params["text_head"]).float()
    head = sharded(mesh, out_features(params["text_head"]), cfg.text_vocab)
    return logits if head is None else mesh.tp_gather(logits, dim=-1)


def _temporal_layer(p, x, positions, mask, layer_kv, cfg, decode: bool, cursor: int = 0,
                    mesh=None):
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    if "qkv_proj" in p:
        qkv = linear(h, p["qkv_proj"]).reshape(b, t, 3, cfg.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = linear(h, p["q_proj"]).reshape(b, t, -1, hd)
        k = linear(h, p["k_proj"]).reshape(b, t, -1, hd)
        v = linear(h, p["v_proj"]).reshape(b, t, -1, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    if decode:
        write_token(layer_kv, k, v, cursor)
        ck, cv = cache_kv(layer_kv, k.dtype)
        attn = sdpa(q, ck, cv, 1.0 / np.sqrt(hd), mask)
    else:
        write_prompt(layer_kv, k, v)
        attn = sdpa(q, k, v, 1.0 / np.sqrt(hd), mask)
    x = x + row_linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"],
                       sharded(mesh, q.shape[1], cfg.num_heads))
    h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    gate = p["mlp"].get("gate_proj")
    return x + swiglu_mlp(h2, p["mlp"], None if gate is None else
                          sharded(mesh, out_features(gate), cfg.intermediate_size))


def temporal_prefill(params, cfg, embeds, valid, cache, mesh=None):
    """The prompt through every temporal layer into ``cache`` (in place).
    embeds [B, T, d], valid [B, T] bool → (hidden [B, T, d], cache).
    ``mesh``: the tree is this tp rank's shard."""
    t = embeds.shape[1]
    dev = embeds.device
    vi = valid.to(torch.int32)
    positions = (torch.cumsum(vi, dim=1) - 1) * vi
    rows = torch.arange(t, device=dev)[None, :, None]
    cols = torch.arange(t, device=dev)[None, None, :]
    mask = torch.where((cols <= rows) & valid[:, None, :], 0.0, NEG_INF).to(torch.float32)[:, None]
    x = embeds
    for p, layer_kv in zip(params["layers"], cache.layers):
        x = _temporal_layer(p, x, positions, mask, layer_kv, cfg, False, mesh=mesh)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return x, after_prefill(cache, valid, t)


def temporal_step(params, cfg, embeds, cache, mesh=None):
    """One frame: embeds [B, 1, d] → (hidden [B, d], cache advanced)."""
    positions = cache.positions[:, None]
    written = torch.arange(cache.valid.shape[1], device=embeds.device)[None, :] == cache.cursor
    mask = torch.where(cache.valid | written, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    x = embeds
    for p, layer_kv in zip(params["layers"], cache.layers):
        x = _temporal_layer(p, x, positions, mask, layer_kv, cfg, True, cache.cursor, mesh)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return x[:, 0], after_token(cache)


def _sample_topk(logits, generator: Optional[torch.Generator], top_k: int, temperature: float,
                 history=None, penalty: float = 1.0):
    """Top-k Gumbel-max sampling with an optional repetition penalty over
    ``history`` [B, W] (entries outside the vocabulary are inactive): the
    logits of in-history tokens divide by ``penalty`` when positive and
    multiply when not, before the top-k cut. Greedy (first maximum) at
    temperature 0. → int64 [B]."""
    lg = logits.float()
    v = lg.shape[-1]
    if history is not None and penalty != 1.0:
        live = (history >= 0) & (history < v)
        seen = torch.zeros(lg.shape, dtype=torch.int32, device=lg.device)
        seen.scatter_add_(1, history.clamp(0, v - 1).long(), live.to(torch.int32))
        penalized = torch.where(lg > 0, lg / penalty, lg * penalty)
        lg = torch.where(seen > 0, penalized, lg)
    if top_k > 0:
        kth = torch.topk(lg, min(top_k, v), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    if temperature > 0:
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        lg = lg / temperature + gumbel
    return torch.argmax(lg, dim=-1)


def _bank_sum(h, bank, mesh):
    """``h @ bank`` of a row-parallel bank slice, summed over tp: each
    rank's partial in fp32 (none rounds before the sum), the sum rounded
    once to h's dtype."""
    if mesh is None:
        return torch.matmul(h, bank)
    return mesh.tp_sum(torch.matmul(h.float(), bank.float())).to(h.dtype)


def _dep_heads(params, cfg: PersonaPlexConfig) -> int:
    """The depformer heads this rank's ``in_proj`` bank holds."""
    return params["dep_layers"][0]["in_proj"].shape[-1] // 3 // (cfg.dep_d_model // cfg.dep_heads)


def _dep_logits(params, cfg: PersonaPlexConfig, x, step: int, mesh=None):
    """Codebook ``step``'s head on the depformer output, gathered over tp
    where the bank is cut."""
    bank = params["dep_heads_bank"]
    logits = torch.matmul(x, bank[step])
    head = sharded(mesh, bank.shape[-1], cfg.audio_card)
    return logits if head is None else mesh.tp_gather(logits, dim=-1)


def _depformer_step(params, cfg: PersonaPlexConfig, x, step: int, k_caches, v_caches,
                    mesh=None):
    """One depformer forward (t=1) at codebook position ``step``: the
    step's weight banks, a ``dep_context``-window attention with no
    positional encoding, gated-SiLU FFN. The caches [B, nh, S, dh] a layer
    are written in place (this rank's heads under tp)."""
    b = x.shape[0]
    dd = cfg.dep_d_model
    dh = dd // cfg.dep_heads
    nh = _dep_heads(params, cfg)
    attn_mesh = sharded(mesh, nh, cfg.dep_heads)
    cols = torch.arange(cfg.num_codebooks, device=x.device)
    mask = torch.where((cols <= step) & (cols > step - cfg.dep_context), 0.0,
                       NEG_INF).to(torch.float32)[None, None, None, :]
    for li, p in enumerate(params["dep_layers"]):
        h = rms_norm(x, p["norm1"]["weight"], cfg.rms_norm_eps)
        qkv = torch.matmul(h, p["in_proj"][step]).reshape(b, 1, 3, nh, dh)
        q = qkv[:, :, 0].transpose(1, 2)
        k_caches[li][:, :, step] = qkv[:, 0, 1].to(k_caches[li].dtype)
        v_caches[li][:, :, step] = qkv[:, 0, 2].to(v_caches[li].dtype)
        attn = sdpa(q, k_caches[li], v_caches[li], 1.0 / np.sqrt(dh), mask)
        attn = attn.transpose(1, 2).reshape(b, 1, nh * dh)
        x = x + _bank_sum(attn, p["out_proj"][step], attn_mesh)
        h2 = rms_norm(x, p["norm2"]["weight"], cfg.rms_norm_eps)
        gate, value = torch.matmul(h2, p["gating_in"][step]).chunk(2, dim=-1)
        ffn_mesh = sharded(mesh, gate.shape[-1], cfg.dep_ff)
        x = x + _bank_sum(torch.nn.functional.silu(gate) * value, p["gating_out"][step],
                          ffn_mesh)
    return x


def _dep_caches(cfg: PersonaPlexConfig, b: int, like: torch.Tensor, heads: int = None):
    dh = cfg.dep_d_model // cfg.dep_heads
    shape = (b, heads or cfg.dep_heads, cfg.num_codebooks, dh)
    return ([like.new_zeros(shape) for _ in range(cfg.dep_layers)],
            [like.new_zeros(shape) for _ in range(cfg.dep_layers)])


def _dep_input(params, temporal_hidden, step: int, prev_emb):
    cond = torch.matmul(temporal_hidden, params["dep_in"][step])
    return (cond + prev_emb)[:, None].to(temporal_hidden.dtype)


def depformer_generate(params, cfg: PersonaPlexConfig, temporal_hidden, text_token,
                       generator: Optional[torch.Generator], sampling: PersonaSampling,
                       provided=None, history=None, mesh=None):
    """The 16 codebooks of one frame: step k's input is
    ``dep_in[k](temporal_hidden) + emb(prev)``, prev the sampled text token
    at k = 0 (``dep_text_emb``) and the previous code after; heads apply to
    the hidden state directly. ``provided`` [B, 16] forces tokens (-1 =
    sample); ``history`` [B, 16, W] holds each codebook's recent codes for
    the audio repetition penalty. temporal_hidden [B, d]; text_token [B] →
    codes int64 [B, 16]. ``mesh``: the banks are this tp rank's shard."""
    b = temporal_hidden.shape[0]
    k_caches, v_caches = _dep_caches(cfg, b, temporal_hidden, _dep_heads(params, cfg))
    prev_emb = params["dep_text_emb"][text_token]
    codes = []
    for step in range(cfg.num_codebooks):
        x = _depformer_step(params, cfg, _dep_input(params, temporal_hidden, step, prev_emb),
                            step, k_caches, v_caches, mesh)
        logits = _dep_logits(params, cfg, x[:, 0], step, mesh)
        code = _sample_topk(logits, generator, sampling.audio_top_k, sampling.audio_temperature,
                            history=None if history is None else history[:, step],
                            penalty=sampling.audio_repetition_penalty)
        if provided is not None:
            code = torch.where(provided[:, step] >= 0, provided[:, step], code)
        codes.append(code)
        if step < cfg.num_codebooks - 1:
            prev_emb = params["dep_embed"][step][code]
    return torch.stack(codes, dim=1)


def depformer_forward_logits(params, cfg: PersonaPlexConfig, temporal_hidden, text_token,
                             audio_tokens, mesh=None):
    """Teacher-forced depformer logits: step k's input is the GIVEN previous
    token (text at k = 0, audio_tokens[:, k-1] after).
    → [B, num_codebooks, audio_card]."""
    b = temporal_hidden.shape[0]
    k_caches, v_caches = _dep_caches(cfg, b, temporal_hidden, _dep_heads(params, cfg))
    prev_emb = params["dep_text_emb"][text_token]
    logits = []
    for step in range(cfg.num_codebooks):
        x = _depformer_step(params, cfg, _dep_input(params, temporal_hidden, step, prev_emb),
                            step, k_caches, v_caches, mesh)
        logits.append(_dep_logits(params, cfg, x[:, 0], step, mesh))
        if step < cfg.num_codebooks - 1:
            prev_emb = params["dep_embed"][step][audio_tokens[:, step]]
    return torch.stack(logits, dim=1)


def shard_persona_params(params, cfg: PersonaPlexConfig, mesh) -> dict:
    """This rank's shard of the temporal transformer and depformer by
    ``PERSONAPLEX_RULES``: the temporal q/k/v and gate/up are unfused so
    that each projection takes its own rule, and re-fused only where tp
    leaves them whole; the depformer's fused banks are cut block by block."""
    from ...parallel import PERSONAPLEX_RULES, shard_pytree

    layer, dep = r"((?:.*/)?layers/\d+/)", r"(.*dep_layers/\d+/)"
    p = shard_pytree(
        unfuse_temporal_params(params, cfg), mesh, PERSONAPLEX_RULES,
        heads=((r"(?:.*/)?layers/\d+/(q_proj|k_proj|v_proj|o_proj)/", cfg.num_heads),
               (r".*dep_layers/\d+/(in_proj|out_proj)$", cfg.dep_heads)),
        fused=((r".*dep_layers/\d+/in_proj$", 3), (r".*dep_layers/\d+/gating_in$", 2)),
        ties=(layer + r"(q_proj|k_proj|v_proj|o_proj)/",
              layer + r"mlp/(gate_proj|up_proj|down_proj)/",
              dep + r"(in_proj|out_proj)$", dep + r"(gating_in|gating_out)$"))
    return fuse_temporal_params(p) if mesh.tp == 1 else p


class PersonaPlex(SpeechToSpeechModel):
    """PersonaPlex on one device. ``params`` and ``mimi_params`` are trees in
    the JAX package's layout (numpy arrays or tensors), carried onto
    ``device``; ``quant_bits`` packs the temporal linears and the text head
    (MLX group 64) there. The temporal stack fuses before the cast, so the
    card never holds a fused and an unfused copy in ``dtype``."""

    def __init__(self, cfg: PersonaPlexConfig, params, mimi_params, tokenizer=None, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 quant_bits: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tokenizer = tokenizer  # SentencePieceModel for the text stream
        #: text stream of the last respond()/respond_diagnostic() call
        self.last_text_tokens: Optional[np.ndarray] = None
        self.last_transcript: Optional[str] = None
        p = params_from_jax(params, self.device, torch.float32)
        del params
        if quant_bits:
            p = quantize_tree(p, quant_bits, GROUP_SIZE, embed_keys=())
        self.params = cast_tree(fuse_temporal_params(p), dtype)
        del p
        self.mimi_params = params_from_jax(mimi_params, self.device, torch.float32)
        self._mesh = None  # set by shard()
        #: snapshot directory (set by from_pretrained) — named voice presets
        self.model_dir: Optional[str] = None
        #: frames the last conversation loop ran, and its host reads of the
        #: stop flag
        self.last_loop = {"frames_run": 0, "stop_reads": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[PersonaPlexConfig] = None, seed: int = 0, *,
                    dtype: torch.dtype = torch.float32, quant_bits: Optional[int] = None,
                    **kw) -> "PersonaPlex":
        """Random weights drawn with numpy from ``seed`` (the LM, then Mimi);
        ``quant_bits`` packs the temporal linears and the text head on the
        device. Depformer banks and embeddings stay dense."""
        cfg = cfg or config_tiny()
        rng = np.random.default_rng(seed)
        params = init_personaplex_params(rng, cfg)
        return cls(cfg, params, init_mimi_params(rng, cfg.mimi), dtype=dtype,
                   quant_bits=quant_bits, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[PersonaPlexConfig] = None, seed: int = 0, *,
                              device="cuda", dtype: torch.dtype = torch.bfloat16,
                              quant_bits: Optional[int] = None, **kw) -> "PersonaPlex":
        """Random weights drawn on ``device`` from a seeded
        ``torch.Generator`` (:func:`init_personaplex_params_on_device`, each
        temporal layer packed as drawn) and Mimi drawn with numpy: the way to
        build the full-size model, whose numpy draw takes minutes."""
        cfg = cfg or CONFIG_7B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        params = init_personaplex_params_on_device(cfg, generator, quant_bits)
        mimi = init_mimi_params(np.random.default_rng(seed), cfg.mimi)
        return cls(cfg, params, mimi, device=dev, dtype=dtype, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "nvidia/personaplex-7b-v1", cache_dir=None,
                        offline_mode: bool = False, progress_handler=None, *,
                        dtype: torch.dtype = torch.bfloat16,
                        cfg: Optional[PersonaPlexConfig] = None,
                        quant_bits: Optional[int] = None, **kw) -> "PersonaPlex":
        """The upstream split-safetensors layout from a local directory:
        ``temporal.safetensors`` (MLX 4-bit), ``embeddings.safetensors``,
        ``depformer.safetensors``, ``mimi.safetensors``, and
        ``tokenizer_spm_32k_3.model`` and ``voices/`` when present.
        ``quant_bits`` re-packs the temporal linears and the text head after
        conversion. A model id is found in the cache or fetched
        (``core/hub.py``)."""
        from ...core.hub import download_weights
        from ...core.weights import read_safetensors_file
        from .convert import convert_mimi_tree, convert_moshi_tree, dequantize_state_dict

        cfg = cfg or CONFIG_7B
        model_dir = Path(download_weights(
            model_id, cache_dir=cache_dir, offline_mode=offline_mode,
            additional_patterns=["voices/*", "*.model"]))
        tok_path = model_dir / "tokenizer_spm_32k_3.model"
        if "tokenizer" not in kw and tok_path.exists():
            from ...tokenizers.sentencepiece_model import SentencePieceModel

            kw["tokenizer"] = SentencePieceModel.load(tok_path)

        def read(name):
            path = model_dir / name
            if not path.exists():
                raise FileNotFoundError(f"missing {name} in {model_dir}")
            return read_safetensors_file(path)

        lm_sd = dequantize_state_dict({**read("temporal.safetensors"),
                                       **read("embeddings.safetensors"),
                                       **read("depformer.safetensors")})
        params = convert_moshi_tree(lm_sd, cfg)
        del lm_sd
        mimi_params = convert_mimi_tree(read("mimi.safetensors"), cfg.mimi)
        model = cls(cfg, params, mimi_params, dtype=dtype, quant_bits=quant_bits, **kw)
        model.model_dir = str(model_dir)
        return model

    VOICE_PROMPT_CAP = 32  # frames; fixed so one compiled program serves all prompts
    DELAY_RING = 4         # maxDelay + 3 (PersonaPlex.swift:210)
    PROMPT_CAP = 64        # spacer+text+spacer steps; fixed for one compiled program

    #: upstream voice preset names — voices/<name>.safetensors in the
    #: snapshot (reference: PersonaPlexVoice, Configuration.swift:313-321)
    VOICES = tuple(f"NAT{g}{i}" for g in "FM" for i in range(4)) + \
             tuple(f"VAR{g}{i}" for g in "FM" for i in range(5))

    @property
    def available_voices(self) -> list:
        """Voice presets with a file present in the loaded snapshot
        (empty for random-weight models with no snapshot dir)."""
        d = getattr(self, "model_dir", None)
        if d is None:
            return []
        voices_dir = Path(d) / "voices"
        return sorted(p.stem for p in voices_dir.glob("*.safetensors")) \
            if voices_dir.is_dir() else []

    def voice(self, name: str) -> dict:
        """Load a named voice preset from the snapshot's ``voices/`` dir
        (the reference's `voice: .NATM0` selection,
        PersonaPlex.swift:131-146). ``respond(voice_prompt="NATM0")``
        resolves through here."""
        d = getattr(self, "model_dir", None)
        if d is None:
            raise ValueError("no snapshot directory — named voices need "
                             "from_pretrained(); pass a voice dict instead")
        path = Path(d) / "voices" / f"{name}.safetensors"
        if not path.exists():
            raise FileNotFoundError(
                f"voice {name!r} not in snapshot; available: "
                f"{self.available_voices or self.VOICES}")
        return self.load_voice_prompt(str(path))

    @torch.inference_mode()
    def _embed_voice_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """agent-stream code prefix [1, 16, T] → temporal-input embeddings
        [1, T, d]: the text stream carries PAD and the user streams the sine
        reference tone during the voice phase."""
        cfg = self.cfg
        k = cfg.temporal_codebooks
        t = codes.shape[2]
        sine = torch.tensor(SINE_TOKENS[:k], device=self.device).expand(t, k)
        text = torch.full((t,), cfg.text_pad, dtype=torch.long, device=self.device)
        return embed_frame(self.params, cfg, text, sine, codes[0, :k].T.long())[None]

    @torch.inference_mode()
    def _encode_audio(self, audio: np.ndarray) -> torch.Tensor:
        """24 kHz samples (whole frames) → Mimi codes [1, 16, F] on the device."""
        wave = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        return mimi_encode(self.mimi_params, self.cfg.mimi, wave)

    def make_voice_prompt(self, audio: np.ndarray, sample_rate: int = 24000,
                          path: Optional[str] = None) -> dict:
        """Reference audio → voice prompt in the upstream format
        (``embeddings`` [T, 1, 1, d] temporal-input embeddings + ``cache``
        [1, 17, 4] delay-ring token snapshot); saved to ``path`` when given."""
        cfg = self.cfg
        sr = cfg.mimi.sample_rate
        if sample_rate != sr:
            from ...audio.resample import resample

            audio = resample(np.asarray(audio, np.float32), sample_rate, sr)
        spf = cfg.mimi.samples_per_frame
        n = max(1, -(-len(audio) // spf))  # ceil: pad the tail to a whole frame
        audio = np.pad(audio, (0, n * spf - len(audio)))[: n * spf]
        codes = self._encode_audio(audio)[:, :, : self.VOICE_PROMPT_CAP]
        embeds = self._embed_voice_codes(codes).float().cpu().numpy()     # [1,T,d]
        codes = codes.cpu().numpy().astype(np.int32)
        ring = self._build_voice_ring(codes[0], codes.shape[2])
        out = {"embeddings": embeds.transpose(1, 0, 2)[:, :, None].astype(np.float32),
               "cache": ring[None].astype(np.float32)}
        if path:
            from safetensors.numpy import save_file

            save_file(out, path)
        return out

    def _build_voice_ring(self, codes: np.ndarray, n_voice: int) -> np.ndarray:
        """Delay-ring token snapshot [17, DELAY_RING] for a locally built
        voice prompt, in the upstream convention that ``_prompt_reads``
        consumes: ring slot ``(p + 1) % RING`` holds the token WRITTEN at
        flat position ``p`` (the +1 is the reference's documented
        offset-after-init-skip mapping, ``tokenCache[flatPos] =
        cache[s, (flatPos + 1) % CT]`` — PersonaPlex.swift:203-223).

        During the voice phase the AGENT streams carry the voice clip's
        first ``k`` codebooks written at their delayed positions (stream
        delay d: position p holds frame p-d), the USER streams carry sine
        tokens and the text stream PAD (PersonaPlex.swift:184-199).

        codes: [>=k, T] Mimi codes of the voice clip."""
        cfg = self.cfg
        k = cfg.temporal_codebooks
        ring = np.full((cfg.num_streams, self.DELAY_RING), cfg.text_pad, np.int32)
        delays = [0, 0] + [1] * (k - 1) + [0] + [1] * (k - 1)
        sine = SINE_TOKENS[:k]
        last = codes.shape[1] - 1
        for s in range(cfg.num_streams):
            d = delays[s]
            for p in range(max(0, n_voice + d - self.DELAY_RING), n_voice + d):
                if s == 0:
                    val = cfg.text_pad
                elif s <= k:  # agent rows: voice codes at delayed positions
                    f = p - d
                    val = int(codes[s - 1, min(max(f, 0), last)]) if f >= 0 else cfg.audio_pad
                else:         # user rows: sine reference tone
                    val = sine[s - 1 - k]
                ring[s, (p + 1) % self.DELAY_RING] = val
        return ring

    @staticmethod
    def load_voice_prompt(path: str) -> dict:
        """Load an upstream-format voice .safetensors (or a legacy .npz code
        prefix, converted lazily at use)."""
        if str(path).endswith(".npz"):
            return {"codes": np.load(path)["codes"]}
        from safetensors import safe_open

        with safe_open(str(path), framework="np") as f:
            return {k: f.get_tensor(k) for k in f.keys()}

    def _voice_inputs(self, voice_prompt):
        """voice_prompt (dict with 'embeddings'+'cache', dict with 'codes',
        raw code array, a path, a preset name, or None) → (voice_embeds
        [1, CAP, d] on the device, n_voice, ring [17, DELAY_RING] or None)."""
        cfg = self.cfg
        cap = self.VOICE_PROMPT_CAP
        d = cfg.d_model
        embeds = np.zeros((1, cap, d), np.float32)
        ring_out = None
        n_voice = 0
        if voice_prompt is None:
            return torch.from_numpy(embeds).to(self.device), 0, None
        if isinstance(voice_prompt, str):
            # path-like strings load directly (missing files raise the
            # plain file error); bare names resolve as snapshot presets
            import os

            if (os.sep in voice_prompt or voice_prompt.endswith((".safetensors", ".npz"))):
                voice_prompt = self.load_voice_prompt(voice_prompt)
            else:
                voice_prompt = self.voice(voice_prompt)  # preset name → dict
        vp = voice_prompt if isinstance(voice_prompt, dict) else {"codes": np.asarray(voice_prompt)}
        if "embeddings" in vp:
            e = np.asarray(vp["embeddings"], np.float32)   # [T, 1, 1, d]
            e = e.reshape(e.shape[0], -1)[:, -d:]
            n_voice = min(e.shape[0], cap)
            embeds[0, :n_voice] = e[:n_voice]
            ring = vp.get("cache")
            if ring is not None:
                ring_out = np.asarray(ring, np.float32)[0].astype(np.int32)  # [17, RING]
        else:
            codes = np.asarray(vp["codes"], np.int32)
            n_voice = min(codes.shape[2], cap)
            e = self._embed_voice_codes(torch.as_tensor(codes[:, :, :n_voice], device=self.device))
            embeds[0, :n_voice] = e[0].float().cpu().numpy()
            ring_out = self._build_voice_ring(codes[0, :, :n_voice], n_voice)
        if ring_out is not None:
            ring_out[0] = np.clip(ring_out[0], 0, cfg.text_vocab - 1)
            ring_out[1:] = np.clip(ring_out[1:], 0, cfg.audio_vocab - 1)
        return torch.from_numpy(embeds).to(self.device), n_voice, ring_out

    def _silence_spacer_frames(self) -> int:
        """0.5 s of frames at the Mimi frame rate (PersonaPlex.swift:154)."""
        return max(1, int(0.5 * self.cfg.mimi.frame_rate))

    def _prompt_tokens(self, system_prompt) -> list:
        """system_prompt: None (built-in default), str (SentencePiece'd via
        the model tokenizer), or a pre-tokenized id sequence."""
        if system_prompt is None:
            toks = list(DEFAULT_SYSTEM_PROMPT_TOKENS)
            if max(toks) >= self.cfg.text_vocab:  # tiny test configs
                toks = []
        elif isinstance(system_prompt, str):
            if self.tokenizer is None:
                raise ValueError("string system_prompt needs the SentencePiece "
                                 "tokenizer; pass token ids instead")
            toks = list(self.tokenizer.encode(system_prompt))
        else:
            toks = [int(t) for t in np.asarray(system_prompt).reshape(-1)]
        budget = self.PROMPT_CAP - 2 * self._silence_spacer_frames()
        if len(toks) > budget:
            from ...core.logging import inference as log

            log.warning(
                "system prompt is %d tokens but only %d fit the compiled "
                "prompt window (PROMPT_CAP=%d minus two %d-frame spacers) — "
                "truncating; raise PersonaPlex.PROMPT_CAP to fit longer prompts",
                len(toks), budget, self.PROMPT_CAP, self._silence_spacer_frames())
        return toks[:budget]

    def _prompt_reads(self, system_prompt, n_voice: int, ring):
        """Build the per-step READ tokens for the non-voice prompt phases
        (silence spacer | text prompt | spacer — PersonaPlex.swift:226-287).

        The prompt phases WRITE each frame's tokens at position
        ``t + delays[stream]`` (text/semantic 0, acoustic 1) and every step
        READS position step-1, so this materializes the write-side token
        cache on the host — including the voice delay-ring overlay at the
        voice boundary (PersonaPlex.swift:203-223) — then shifts by one.
        Returns (reads [17, PROMPT_CAP] int32 with -1 = no audio input,
        n_prompt valid steps)."""
        cfg = self.cfg
        k = cfg.temporal_codebooks
        sf = self._silence_spacer_frames()
        toks = self._prompt_tokens(system_prompt)
        n_text = len(toks)
        prompt_len = n_voice + 2 * sf + n_text
        sil = np.asarray(SILENCE_TOKENS[:k], np.int32)
        sine = np.asarray(SINE_TOKENS[:k], np.int32)

        cache = np.full((cfg.num_streams, prompt_len + 2), -1, np.int32)
        cache[0, :prompt_len] = cfg.text_pad
        ts = n_voice + sf
        cache[0, ts: ts + n_text] = toks
        cache[1, :prompt_len] = sil[0]                       # agent semantic, delay 0
        cache[2: 1 + k, 1: prompt_len + 1] = sil[1:, None]   # agent acoustic, delay 1
        cache[1 + k, :prompt_len] = sine[0]                  # user semantic, delay 0
        cache[2 + k: 1 + 2 * k, 1: prompt_len + 1] = sine[1:, None]
        if ring is not None and n_voice > 0:
            delays = [0, 0] + [1] * (k - 1) + [0] + [1] * (k - 1)
            for s in range(cfg.num_streams):
                for kk in range(delays[s] + 1):
                    cache[s, n_voice - 1 + kk] = ring[s, (n_voice + kk) % self.DELAY_RING]

        reads = np.full((cfg.num_streams, prompt_len), -1, np.int32)
        reads[0, 0] = cfg.text_pad  # step 0 has no previous position
        if prompt_len > 1:
            reads[:, 1:] = cache[:, : prompt_len - 1]
        nonvoice = reads[:, n_voice:]
        out = np.full((cfg.num_streams, self.PROMPT_CAP), -1, np.int32)
        out[0] = cfg.text_pad
        out[:, : nonvoice.shape[1]] = nonvoice
        return out, nonvoice.shape[1]

    # ------------------------------------------------------------------ #
    # the conversation loop
    # ------------------------------------------------------------------ #

    def _prefill(self, user_codes, voice_embeds, n_voice, prompt_reads, n_prompt,
                 max_steps: int, kv_dtype=None):
        """Phases 1-4: the voice embeddings [B, CAP, d] and the spacer |
        prompt | spacer reads [B, 17, PROMPT_CAP] through the temporal stack
        into a cache of ``CAP + PROMPT_CAP + max_steps`` slots in
        ``kv_dtype`` (the model's dtype by default). ``n_voice`` and
        ``n_prompt`` (ints, or [B] for rows of their own) mark each row's
        valid slots; the block layout is shared and positions follow the
        valid count, so a shorter prompt stays contiguous. → cache."""
        cfg, p, dev = self.cfg, self.params, self.device
        k = cfg.temporal_codebooks
        b, v_cap = voice_embeds.shape[:2]
        p_cap = prompt_reads.shape[2]
        cache = init_cache(cfg.num_layers, b, temporal_heads(p, cfg), v_cap + p_cap + max_steps,
                           cfg.head_dim, kv_dtype or self.dtype, device=dev)
        reads = prompt_reads.transpose(1, 2).reshape(b * p_cap, -1)      # [B·P, 17]
        prompt_emb = embed_frame(p, cfg, reads[:, 0], reads[:, 1 + k:], reads[:, 1:1 + k])
        embeds = torch.cat([voice_embeds.to(self.dtype),
                            prompt_emb.reshape(b, p_cap, -1).to(self.dtype)], dim=1)
        n_voice = torch.as_tensor(n_voice, device=dev).reshape(-1, 1)
        n_prompt = torch.as_tensor(n_prompt, device=dev).reshape(-1, 1)
        valid = torch.cat([torch.arange(v_cap, device=dev)[None] < n_voice,
                           torch.arange(p_cap, device=dev)[None] < n_prompt], dim=1)
        _, cache = temporal_prefill(p, cfg, embeds, valid.expand(b, -1), cache, self._mesh)
        return cache

    def _frame_hidden(self, cache, text_prev, user_read, agent_prev):
        """One temporal step: (hidden [1, d], text logits [1, V] fp32)."""
        embeds = embed_frame(self.params, self.cfg, text_prev, user_read, agent_prev)
        hidden, cache = temporal_step(self.params, self.cfg, embeds[:, None].to(self.dtype), cache,
                                      self._mesh)
        return hidden, text_logits(self.params, self.cfg, hidden, self._mesh)

    @torch.inference_mode()
    def _converse(self, user_codes, voice_embeds, n_voice: int, prompt_reads, n_prompt: int,
                  generator, *, user_frames: int, max_steps: int, sampling: PersonaSampling,
                  diag: bool = False):
        """The reference's ``_converse`` as a host loop. user_codes
        [1, 16, user_frames]; voice_embeds [1, CAP, d]; prompt_reads
        [1, 17, PROMPT_CAP]. Returns (agent codes [1, 16, max_steps],
        n_steps, per-step stats) on the device; frames after the stop
        record nothing."""
        cfg, dev = self.cfg, self.device
        b, k = 1, cfg.temporal_codebooks
        cache = self._prefill(user_codes, voice_embeds, n_voice, prompt_reads, n_prompt,
                              max_steps)
        agent_out = torch.full((b, cfg.num_codebooks, max_steps), cfg.audio_pad,
                               dtype=torch.long, device=dev)
        silence = torch.tensor(SILENCE_TOKENS[:k], device=dev)
        rep_w = min(sampling.repetition_window, max_steps)
        use_audio_hist = rep_w > 0 and sampling.audio_repetition_penalty != 1.0
        use_text_hist = rep_w > 0 and sampling.text_repetition_penalty != 1.0
        entropy_stop = sampling.entropy_stop_threshold > 0 and sampling.entropy_stop_window > 0
        can_stop = sampling.silence_stop_frames > 0 or entropy_stop

        agent_prev = silence[None].expand(b, k)
        pred_user_prev = torch.tensor(SINE_TOKENS[:k], device=dev)[None].expand(b, k)
        text_prev = torch.full((b,), cfg.text_pad, dtype=torch.long, device=dev)
        run = torch.zeros((b,), dtype=torch.long, device=dev)
        ent_run = torch.zeros_like(run)
        text_hist = torch.full((b, max(rep_w, 1)), cfg.text_vocab, dtype=torch.long, device=dev)
        n_steps = torch.full((b,), max_steps, dtype=torch.long, device=dev)
        stats = {"text_tokens": torch.zeros((b, max_steps), dtype=torch.long, device=dev)}
        if diag:
            stats.update(text_top_token=torch.zeros((b, max_steps), dtype=torch.long, device=dev),
                         text_top_logit=torch.zeros((b, max_steps), device=dev),
                         text_entropy=torch.zeros((b, max_steps), device=dev),
                         hidden_stats=torch.zeros((b, max_steps, 4), device=dev))
        reads = 0
        step = 0
        while step < max_steps:
            if can_stop and step and step % STOP_CHECK_FRAMES == 0:
                reads += 1
                if not bool((n_steps >= max_steps).any()):
                    break
            live = n_steps >= max_steps                      # not stopped before this frame
            user_read = user_stream_reads(user_codes, pred_user_prev, step, user_frames, k)
            hidden, text_logits = self._frame_hidden(cache, text_prev, user_read, agent_prev)
            text_tok = _sample_topk(text_logits, generator, sampling.text_top_k,
                                    sampling.text_temperature,
                                    history=text_hist if use_text_hist else None,
                                    penalty=sampling.text_repetition_penalty)
            provided = depformer_provided_tokens(user_codes, step, user_frames, cfg)
            audio_hist = None
            if use_audio_hist:
                # the reference's window: ``lax.dynamic_slice`` wraps a
                # negative start by the buffer's length, then clamps it, so
                # before step rep_w the window is the buffer's tail, not
                # the last rep_w frames (ROADMAP §3)
                start = step - rep_w
                if start < 0:
                    start += max_steps
                start = min(max(start, 0), max_steps - rep_w)
                audio_hist = agent_out[:, :, start:start + rep_w]
            codes = depformer_generate(self.params, cfg, hidden, text_tok, generator, sampling,
                                       provided=provided, history=audio_hist, mesh=self._mesh)
            agent_out[:, :, step] = torch.where(live[:, None], codes, agent_out[:, :, step])
            counted = step >= user_frames
            if counted:
                text_hist = torch.cat([text_hist[:, 1:], text_tok[:, None]], dim=1)
                is_sil = (codes[:, :k] == silence[None]).all(dim=1)
                run = torch.where(is_sil, run + 1, torch.zeros_like(run))
            stopped = (run >= sampling.silence_stop_frames if sampling.silence_stop_frames > 0
                       else torch.zeros((b,), dtype=torch.bool, device=dev))
            if diag or entropy_stop:
                lp = torch.log_softmax(text_logits, dim=-1)
                ent = -(torch.exp(lp) * lp).sum(dim=-1)
            if entropy_stop and counted:
                low = ent < sampling.entropy_stop_threshold
                ent_run = torch.where(low, ent_run + 1, torch.zeros_like(ent_run))
            if entropy_stop:
                stopped = stopped | (ent_run >= sampling.entropy_stop_window)

            def record(name, value):
                stats[name][:, step] = torch.where(live.reshape((b,) + (1,) * (value.dim() - 1)),
                                                   value, stats[name][:, step])

            record("text_tokens", text_tok)
            if diag:
                hf = hidden.float()
                record("text_top_token", torch.argmax(text_logits, dim=-1))
                record("text_top_logit", text_logits.max(dim=-1).values)
                record("text_entropy", ent)
                record("hidden_stats", torch.stack([hf.mean(-1), hf.std(-1, correction=0),
                                                    hf.amin(-1), hf.amax(-1)], dim=-1))
            n_steps = torch.where(stopped & live, torch.full_like(n_steps, step + 1), n_steps)
            agent_prev, pred_user_prev, text_prev = codes[:, :k], codes[:, k:], text_tok
            step += 1
        self.last_loop = {"frames_run": step, "stop_reads": reads}
        return agent_out, torch.minimum(n_steps, torch.full_like(n_steps, step)), stats

    def _conversation_inputs(self, audio, sample_rate, voice_prompt, system_prompt):
        """(user codes [1, 16, F], F, voice_embeds, n_voice, prompt reads
        [1, 17, PROMPT_CAP], n_prompt) on the device for a user clip."""
        sr = self.cfg.mimi.sample_rate
        if sample_rate != sr:
            from ...audio.resample import resample

            audio = resample(np.asarray(audio, np.float32), sample_rate, sr)
        spf = self.cfg.mimi.samples_per_frame
        n_frames = max(1, -(-len(audio) // spf))  # ceil: whole frames
        audio = np.pad(audio, (0, n_frames * spf - len(audio)))[: n_frames * spf]
        user_codes = self._encode_audio(audio)
        voice_embeds, n_voice, ring = self._voice_inputs(voice_prompt)
        reads, n_prompt = self._prompt_reads(system_prompt, n_voice, ring)
        reads = torch.as_tensor(reads[None], dtype=torch.long, device=self.device)
        return user_codes, n_frames, voice_embeds, n_voice, reads, n_prompt

    def _run_converse(self, audio, sample_rate, sampling, max_extra_s, voice_prompt,
                      system_prompt=None, seed: int = 0, diag: bool = False):
        user_codes, n_frames, voice_embeds, n_voice, reads, n_prompt = \
            self._conversation_inputs(audio, sample_rate, voice_prompt, system_prompt)
        max_steps = min(sampling.max_steps,
                        n_frames + int(max_extra_s * self.cfg.mimi.frame_rate))
        agent, n_steps, stats = self._converse(
            user_codes, voice_embeds, n_voice, reads, n_prompt,
            torch.Generator(device=self.device).manual_seed(seed),
            user_frames=n_frames, max_steps=max_steps, sampling=sampling, diag=diag)
        n_done = int(n_steps[0])
        clipped = torch.clamp(agent, 0, self.cfg.mimi.codebook_size - 1)
        return clipped, n_frames, n_done, stats

    @torch.inference_mode()
    def _decode(self, codes: torch.Tensor) -> np.ndarray:
        """Agent codes [1, 16, F] → 24 kHz samples [F·1920] on the host."""
        return mimi_decode(self.mimi_params, self.cfg.mimi, codes)[0].float().cpu().numpy()

    def shard(self, mesh=None, dp: Optional[int] = None, tp: Optional[int] = None
              ) -> "PersonaPlex":
        """Spread the temporal transformer and the depformer over a mesh of
        ranks by ``PERSONAPLEX_RULES`` (the 7B's d-4096 layers are the tp
        target; Mimi, a small conv codec, stays whole). Every rank calls
        this with the same arguments on the same weights. Returns self.

            model = PersonaPlex.init_random_on_device(device=f"cuda:{rank}").shard(tp=2)
        """
        from ...parallel import make_mesh

        mesh = mesh or make_mesh(dp=dp, tp=tp, device=self.device)
        self.params = shard_persona_params(self.params, self.cfg, mesh)
        self._mesh = mesh
        return self

    def respond(self, audio: np.ndarray, sample_rate: int = 16000,
                sampling: Optional[PersonaSampling] = None, max_extra_s: float = 4.0,
                voice_prompt: Optional[np.ndarray] = None,
                system_prompt=None, seed: int = 0, **kwargs) -> AudioChunk:
        """``system_prompt``: None = the built-in assistant prompt; a str
        (SentencePiece'd) or pre-tokenized ids steer the response."""
        t0 = time.perf_counter()
        sampling = sampling or PersonaSampling()
        sr = self.cfg.mimi.sample_rate
        agent, n_frames, n_done, stats = self._run_converse(
            audio, sample_rate, sampling, max_extra_s, voice_prompt,
            system_prompt=system_prompt, seed=seed)
        self._set_text_outputs(stats, n_done)
        # the whole buffer decodes, then the host trims the early-stopped
        # tail — Mimi is causal, so the leading frames decode alike
        out = self._decode(agent)[: n_done * self.cfg.mimi.samples_per_frame]
        dur = len(out) / sr
        log.info("personaplex: %d user frames → %d agent frames, RTF %.2f",
                 n_frames, n_done, (time.perf_counter() - t0) / max(dur, 1e-6))
        return AudioChunk(out, sr)

    def _set_text_outputs(self, stats, n_done: int) -> None:
        """The conversation's sampled text stream: the ids in
        ``last_text_tokens``, SentencePiece-decoded in ``last_transcript``
        when the tokenizer is loaded (None otherwise)."""
        toks = stats["text_tokens"][0, :n_done].cpu().numpy().astype(np.int32)
        self.last_text_tokens = toks
        self.last_transcript = (self.tokenizer.decode([int(t) for t in toks])
                                if self.tokenizer is not None else None)

    def respond_diagnostic(self, audio: np.ndarray, sample_rate: int = 16000,
                           sampling: Optional[PersonaSampling] = None,
                           max_extra_s: float = 4.0, voice_prompt=None,
                           system_prompt=None, seed: int = 0
                           ) -> Tuple[AudioChunk, dict]:
        """``respond`` plus per-step capture: ``(audio, diag)`` with, trimmed
        to the generated steps, the sampled ``text_tokens`` [T], per-codebook
        ``agent_tokens`` [16, T], ``text_top_token``/``text_top_logit``/
        ``text_entropy`` [T] and ``hidden_stats`` [T, 4] (mean/std/min/max
        of the temporal hidden state)."""
        sampling = sampling or PersonaSampling()
        sr = self.cfg.mimi.sample_rate
        agent, _, n_done, stats = self._run_converse(
            audio, sample_rate, sampling, max_extra_s, voice_prompt,
            system_prompt=system_prompt, seed=seed, diag=True)
        self._set_text_outputs(stats, n_done)
        out = self._decode(agent)[: n_done * self.cfg.mimi.samples_per_frame]
        diag = {k: v.cpu().numpy()[0, :n_done] for k, v in stats.items()}
        diag["agent_tokens"] = agent.cpu().numpy()[0, :, :n_done]
        return AudioChunk(out, sr), diag

    def respond_stream(self, audio: np.ndarray, sample_rate: int = 16000,
                       sampling: Optional[PersonaSampling] = None,
                       max_extra_s: float = 4.0,
                       voice_prompt: Optional[np.ndarray] = None,
                       system_prompt=None,
                       chunk_frames: int = 25, left_context: int = 25):
        """Streaming response: the agent codes decode through Mimi in
        ``chunk_frames`` chunks with ``left_context`` frames of left
        context, trimmed at the seam (the reference's windowed re-decode;
        exact only with the full history, since the decoder transformer
        attends over a 250-frame window)."""
        sampling = sampling or PersonaSampling()
        sr = self.cfg.mimi.sample_rate
        spf = self.cfg.mimi.samples_per_frame
        agent, _, n_done, stats = self._run_converse(
            audio, sample_rate, sampling, max_extra_s, voice_prompt,
            system_prompt=system_prompt)
        self._set_text_outputs(stats, n_done)
        emitted = 0
        while emitted < n_done:
            ctx = min(left_context, emitted)
            end = min(emitted + chunk_frames, n_done)
            wav = self._decode(agent[:, :, emitted - ctx: end])
            yield AudioChunk(wav[ctx * spf:], sr)
            emitted = end

    def realtime_session(self, sampling: Optional[PersonaSampling] = None,
                         context_frames: int = 8,
                         voice_prompt: Optional[np.ndarray] = None,
                         system_prompt=None,
                         seed: int = 0, batch: int = 1,
                         kv_dtype=None) -> "RealtimeSession":
        """Full-duplex frame loop: one user frame in, one agent frame out, at
        12.5 Hz (:class:`RealtimeSession`). ``batch`` > 1 steps that many
        independent sessions together; ``voice_prompt``/``system_prompt``
        may then be per-session lists. ``kv_dtype=torch.int8`` quantizes the
        temporal cache (per-slot symmetric scales, ``ops/kv_cache.py``): at
        the 7B config the bf16 cache of a session is 32 layers × K and V ×
        3096 slots × 4096 × 2 B ≈ 1.62 GB, int8 about half of it.
        ``context_frames`` is kept for the reference's signature; the
        carried-state codec needs no window."""
        return RealtimeSession(self, sampling or PersonaSampling(), voice_prompt, seed,
                               system_prompt=system_prompt, batch=batch, kv_dtype=kv_dtype)

    def warm_up(self) -> None:
        spf = self.cfg.mimi.samples_per_frame
        self.respond(np.zeros(spf, np.float32), self.cfg.mimi.sample_rate,
                     sampling=PersonaSampling(max_steps=2))

    def unload(self) -> None:
        self.params = None
        self.mimi_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


class RealtimeSession:
    """The reference's full-duplex session: a frame is the streaming Mimi
    encode of 80 ms of user audio, the temporal step (user codebook 0 read
    from the previous frame, 1-7 from two frames back; the depformer's user
    steps forced to codebook 0 of this frame and 1-7 of the previous one),
    the text sampler and the depformer over the session's rolling repetition
    histories, and the streaming Mimi decode of the agent's codes. Every
    carry (the codec streams, the temporal cache, the code histories) stays
    on the device; the noise comes from one ``torch.Generator`` seeded by
    ``seed``. The cache holds ``VOICE_PROMPT_CAP + PROMPT_CAP +
    cfg.context`` slots, filled by the 5-phase prefill, and every frame
    reads all of them, as the reference does."""

    def __init__(self, model: PersonaPlex, sampling: PersonaSampling, voice_prompt, seed: int,
                 system_prompt=None, batch: int = 1, kv_dtype=None):
        self.model = model
        cfg = self.cfg = model.cfg
        self.sampling = sampling
        self.batch = batch
        self.frames_done = 0
        #: the last frame's 16-codebook agent codes [batch, 16] (device)
        self.last_codes: Optional[torch.Tensor] = None
        dev = model.device
        k = cfg.temporal_codebooks

        def per_session(prompt):
            return prompt if isinstance(prompt, (list, tuple)) else [prompt] * batch

        v_embeds, n_voices, all_reads, n_prompts = [], [], [], []
        for vp, sp in zip(per_session(voice_prompt), per_session(system_prompt)):
            embeds, n_voice, ring = model._voice_inputs(vp)
            reads, n_prompt = model._prompt_reads(sp, n_voice, ring)
            v_embeds.append(embeds[0])
            n_voices.append(n_voice)
            all_reads.append(reads)
            n_prompts.append(n_prompt)
        with torch.inference_mode():
            self._cache = model._prefill(
                None, torch.stack(v_embeds), n_voices,
                torch.as_tensor(np.stack(all_reads), dtype=torch.long, device=dev), n_prompts,
                cfg.context, kv_dtype)
            # the generation-start reads: agent silence, the user history
            # seeded with the sine tokens the prompt phases wrote
            sine = torch.tensor(SINE_TOKENS[:k], device=dev)[None].expand(batch, k)
            self._user1 = self._user2 = sine
            self._agent = torch.tensor(SILENCE_TOKENS[:k], device=dev)[None].expand(batch, k)
            self._text = torch.full((batch,), cfg.text_pad, dtype=torch.long, device=dev)
            w = max(sampling.repetition_window, 1)
            # out-of-range entries are empty slots (audio card 2048, text vocab)
            self._audio_hist = torch.full((batch, cfg.num_codebooks, w), cfg.audio_pad,
                                          dtype=torch.long, device=dev)
            self._text_hist = torch.full((batch, w), cfg.text_vocab, dtype=torch.long,
                                         device=dev)
            self._enc = init_mimi_encoder_stream(model.mimi_params, cfg.mimi, batch=batch)
            self._dec = init_mimi_decoder_stream(model.mimi_params, cfg.mimi, batch=batch)
        self._generator = torch.Generator(device=dev).manual_seed(seed)

    def _frame(self, samples: torch.Tensor) -> torch.Tensor:
        model, cfg, sampling = self.model, self.cfg, self.sampling
        p, k, b = model.params, cfg.temporal_codebooks, self.batch
        if self._cache.cursor >= self._cache.valid.shape[1]:
            raise ValueError(f"the session's context of {cfg.context} frames is full")
        enc, self._enc = mimi_encode_frame(model.mimi_params, cfg.mimi, self._enc, samples)
        enc = enc[:, :, 0]                                                  # [B, 16]
        user_read = torch.cat([self._user1[:, :1], self._user2[:, 1:k]], dim=1)
        provided = torch.cat([torch.full((b, cfg.num_codebooks - k), -1, dtype=torch.long,
                                         device=enc.device),
                              enc[:, :1], self._user1[:, 1:k]], dim=1)
        embeds = embed_frame(p, cfg, self._text, user_read, self._agent)[:, None]
        hidden, self._cache = temporal_step(p, cfg, embeds.to(model.dtype), self._cache,
                                            model._mesh)
        # both repetition penalties run over the session's own rolling
        # histories every frame (unlike respond(), whose text history starts
        # after the user's turn)
        rep_on = sampling.repetition_window > 0
        text_tok = _sample_topk(text_logits(p, cfg, hidden, model._mesh), self._generator,
                                sampling.text_top_k, sampling.text_temperature,
                                history=self._text_hist if rep_on else None,
                                penalty=sampling.text_repetition_penalty)
        codes = depformer_generate(p, cfg, hidden, text_tok, self._generator, sampling,
                                   provided=provided,
                                   history=self._audio_hist if rep_on else None,
                                   mesh=model._mesh)
        self._audio_hist = torch.cat([self._audio_hist[:, :, 1:], codes[:, :, None]], dim=2)
        self._text_hist = torch.cat([self._text_hist[:, 1:], text_tok[:, None]], dim=1)
        wav, self._dec = mimi_decode_frame(
            model.mimi_params, cfg.mimi, self._dec,
            torch.clamp(codes, 0, cfg.mimi.codebook_size - 1)[:, :, None])
        self._user2, self._user1 = self._user1, enc[:, :k]
        self._agent, self._text = codes[:, :k], text_tok
        self.last_codes = codes
        self.frames_done += 1
        return wav

    def push_frame(self, samples: np.ndarray) -> np.ndarray:
        """One 80 ms user frame (``samples_per_frame`` samples at 24 kHz) in,
        one agent frame of audio out."""
        spf = self.cfg.mimi.samples_per_frame
        if self.batch != 1:
            raise ValueError("batched session: use push_frames([B, spf])")
        if len(samples) != spf:
            raise ValueError(f"push_frame expects exactly {spf} samples")
        return self.push_frames(np.asarray(samples, np.float32)[None])[0]

    def push_frames(self, samples: np.ndarray) -> np.ndarray:
        """One 80 ms frame a session in, one agent frame a session out:
        ``samples`` [batch, samples_per_frame] → float32 [batch, spf]."""
        return self.push_frames_async(samples).float().cpu().numpy()

    @torch.inference_mode()
    def push_frames_async(self, samples: np.ndarray) -> torch.Tensor:
        """:meth:`push_frames` without the host fetch: the agent audio comes
        back as a device tensor [batch, spf], its frame queued behind the
        launches; the caller fetches when it needs the PCM."""
        spf = self.cfg.mimi.samples_per_frame
        samples = np.asarray(samples, np.float32)
        if samples.shape != (self.batch, spf):
            raise ValueError(
                f"push_frames expects shape {(self.batch, spf)}, got {samples.shape}")
        return self._frame(torch.from_numpy(samples).to(self.model.device))
