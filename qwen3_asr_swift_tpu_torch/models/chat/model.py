"""Qwen3.5 hybrid chat LLM — port of ``qwen3_asr_swift_tpu/models/chat/model.py``.

Most layers are DeltaNet linear attention (an O(1) recurrent state
``[B, H, Dv, Dk]`` a layer, no KV growth); every
``full_attention_interval``-th layer is gated full attention (8 query heads
× 256, 2 KV heads, RoPE over the first 64 dims, a sigmoid output gate);
SwiGLU MLPs; tied embeddings.

The DeltaNet recurrence, in fp32 as an explicit loop over time:

    S ← g·S;  Δ = (v − S·k)·β;  S ← S + k⊗Δ;  y = S·q

with g = exp(−exp(A_log)·softplus(a + dt_bias)), β = sigmoid(b), q and k
L2-normalized with 1/√D scalings, a depthwise causal conv (k = 4) + SiLU on
the fused QKV stream, and the gated RMSNorm output ``norm(y)·silu(z)``. Pad
steps of a left-padded prompt leave the state untouched.

Packed products (``quant_bits``, MLX group 64) at ≤ 256 rows — every decode
step and the 32-row bucketed prefill — and the tied LM head over the packed
table run kernel K1 through ``ops/nn.linear`` and ``tied_lm_head``. The
reference decodes in one ``lax.while_loop``; here :meth:`Qwen3Chat._gen_chunk`
is a host loop of device ops with no host read inside a chunk, and the host
reads the tokens and the done flags between chunks. Greedy tokens are the
reference's; sampled ones follow its sampler in distribution (the noise
comes from a ``torch.Generator``). Implements ``PipelineLLM`` for the voice
agent.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _normal, params_from_jax
from ...core.protocols import PipelineLLM
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import embedding_lookup, linear, rms_norm, tied_lm_head
from ...ops.quant import cast_tree, quantize_tree
from ...ops.rope import apply_rope, rope_angles
from ...ops.sampling import apply_top_k, apply_top_p

#: decode steps a chunk of ``generate_ids`` runs between host reads
DECODE_CHUNK = 16
GROUP_SIZE = 64


@dataclasses.dataclass(frozen=True)
class ChatConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    # full attention
    num_heads: int = 8
    num_kv_heads: int = 2
    head_dim: int = 256
    partial_rotary_factor: float = 0.25
    rope_theta: float = 1e6
    # DeltaNet
    linear_num_heads: int = 16
    linear_head_dim: int = 128
    conv_kernel: int = 4
    full_attention_interval: int = 4
    intermediate_size: int = 3072
    vocab_size: int = 151936
    rms_norm_eps: float = 1e-6
    eos_token_id: int = 151645

    def layer_type(self, i: int) -> str:
        return "full" if (i + 1) % self.full_attention_interval == 0 else "linear"


@dataclasses.dataclass(frozen=True)
class ChatSamplingConfig:
    """Chat sampling knobs, reference defaults and presets
    (reference: Qwen3ChatConfig.swift:121-146 ChatSamplingConfig;
    sampler semantics ChatSampler.swift:17-106 — repetition penalty over
    the last 64 prompt+generated tokens, temperature<=0 = greedy, then
    temperature → top-k → nucleus top-p → categorical sample)."""

    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    max_tokens: int = 256
    repetition_penalty: float = 1.1

    #: history window of the repetition penalty (ChatSampler.swift:26)
    REP_WINDOW = 64

    @classmethod
    def creative(cls) -> "ChatSamplingConfig":
        return cls(temperature=0.9, top_p=0.95)

    @classmethod
    def precise(cls) -> "ChatSamplingConfig":
        return cls(temperature=0.3, top_k=20, top_p=0.8)


def chat_sample(logits: torch.Tensor, generator: Optional[torch.Generator],
                scfg: ChatSamplingConfig, history: torch.Tensor) -> torch.Tensor:
    """The reference's sampler: logits [B, V], history [B, W] (entries that
    are negative or ≥ V are empty slots) → int64 [B]. The repetition penalty
    over the history, then greedy at temperature ≤ 0, else temperature →
    top-k → top-p and Gumbel-max over what is left (the filters keep the
    ranks, so this samples the same distribution)."""
    lg = logits.float()
    v = lg.shape[-1]
    if scfg.repetition_penalty > 1.0:
        live = (history >= 0) & (history < v)
        seen = torch.zeros(lg.shape, dtype=torch.int32, device=lg.device)
        seen.scatter_add_(1, history.clamp(0, v - 1).long(), live.to(torch.int32))
        penalized = torch.where(lg > 0, lg / scfg.repetition_penalty,
                                lg * scfg.repetition_penalty)
        lg = torch.where(seen > 0, penalized, lg)
    if scfg.temperature <= 0:
        return torch.argmax(lg, dim=-1)
    # temperature scales before the filters: the nucleus is taken on the
    # temperature-scaled distribution (ChatSampler.swift:52-95)
    lg = apply_top_p(apply_top_k(lg / scfg.temperature, scfg.top_k), scfg.top_p)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(lg + gumbel, dim=-1)


CONFIG_08B = ChatConfig()


def config_tiny(vocab: int = 256) -> ChatConfig:
    return ChatConfig(
        hidden_size=32, num_layers=4, num_heads=2, num_kv_heads=1, head_dim=16,
        linear_num_heads=2, linear_head_dim=16, intermediate_size=64,
        vocab_size=vocab, eos_token_id=vocab - 1,
    )


def _draw_params(cfg: ChatConfig, normal, ones, zeros, finish=None) -> dict:
    """The reference's tree and scales: ``normal(shape, scale)`` draws,
    ``ones(n)``/``zeros(n)`` fill norms and gate parameters, ``finish`` takes
    each layer as drawn."""
    h = cfg.hidden_size
    finish = finish or (lambda p: p)

    def lin(d_in, d_out):
        return {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}

    params = {"embed_tokens": normal((cfg.vocab_size, h), 0.02),
              "norm": {"weight": ones(h)}, "layers": []}
    for i in range(cfg.num_layers):
        layer = {
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "mlp": {"gate_proj": lin(h, cfg.intermediate_size),
                    "up_proj": lin(h, cfg.intermediate_size),
                    "down_proj": lin(cfg.intermediate_size, h)},
        }
        if cfg.layer_type(i) == "linear":
            nh, hd = cfg.linear_num_heads, cfg.linear_head_dim
            qkv = 3 * nh * hd
            layer["deltanet"] = {
                "in_proj_qkv": lin(h, qkv), "in_proj_z": lin(h, nh * hd),
                "in_proj_b": lin(h, nh), "in_proj_a": lin(h, nh),
                "conv_weight": normal((qkv, cfg.conv_kernel), 0.2),
                "dt_bias": zeros(nh), "A_log": zeros(nh),
                "norm": {"weight": ones(hd)},
                "out_proj": lin(nh * hd, h),
            }
        else:
            qd = cfg.num_heads * cfg.head_dim
            layer["attn"] = {
                "q_proj": lin(h, 2 * qd),  # Q + gate
                "k_proj": lin(h, cfg.num_kv_heads * cfg.head_dim),
                "v_proj": lin(h, cfg.num_kv_heads * cfg.head_dim),
                "o_proj": lin(qd, h),
                "q_norm": {"weight": ones(cfg.head_dim)},
                "k_norm": {"weight": ones(cfg.head_dim)},
            }
        params["layers"].append(finish(layer))
    return params


def init_chat_params(rng: np.random.Generator, cfg: ChatConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(cfg, lambda shape, scale: _normal(rng, shape, scale),
                        lambda n: np.ones((n,), np.float32), lambda n: np.zeros((n,), np.float32))


def init_chat_params_on_device(cfg: ChatConfig, generator: torch.Generator,
                               quant_bits: Optional[int] = None) -> dict:
    """The same tree drawn on the generator's device; with ``quant_bits``
    each layer is packed (MLX group 64) as soon as it is drawn, and the
    embedding table at the end, as the reference's ``quantize_tree`` packs."""
    dev = generator.device

    def packed(p):
        return quantize_tree(p, quant_bits, GROUP_SIZE) if quant_bits else p

    params = _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.ones((n,), device=dev), lambda n: torch.zeros((n,), device=dev),
        finish=packed)
    return packed(params)


# -- DeltaNet ----------------------------------------------------------------

def _swiglu_mlp(x, p):
    return linear(F.silu(linear(x, p["gate_proj"])) * linear(x, p["up_proj"]), p["down_proj"])


def _l2_norm(x, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def deltanet_forward(p, x, cfg: ChatConfig, state, valid=None):
    """x [B, T, H]; state (S [B, Hh, Dv, Dk], conv ring [B, C, K-1]); valid
    [B, T] bool — invalid (pad) steps leave the recurrent state as it is
    (g = 1, β = 0) and put zeros into the conv ring, so a left-padded prompt
    leaves the state the unpadded prompt would. → (out [B, T, H], state)."""
    b, t, _ = x.shape
    nh, hd = cfg.linear_num_heads, cfg.linear_head_dim
    kdim = nh * hd

    qkv = linear(x, p["in_proj_qkv"])        # [B, T, 3·kdim]
    z = linear(x, p["in_proj_z"])
    b_raw = linear(x, p["in_proj_b"])        # [B, T, nh]
    a_raw = linear(x, p["in_proj_a"])

    s_prev, conv_prev = state
    if valid is not None:
        qkv = torch.where(valid[..., None], qkv, torch.zeros_like(qkv))
    # depthwise causal conv over time on the qkv stream
    kk = cfg.conv_kernel
    # dtypes promote as the reference's do: an fp32 ring makes the conv fp32
    padded = torch.cat([conv_prev, qkv.transpose(1, 2)], dim=2)  # [B, C, T+K-1]
    new_conv = padded[:, :, -(kk - 1):]
    w = p["conv_weight"]                     # [C, K]
    conv_out = sum(padded[:, :, i: i + t] * w[None, :, i: i + 1] for i in range(kk))
    qkv_act = F.silu(conv_out.transpose(1, 2))

    q = qkv_act[..., :kdim].reshape(b, t, nh, hd)
    k = qkv_act[..., kdim: 2 * kdim].reshape(b, t, nh, hd)
    v = qkv_act[..., 2 * kdim:].reshape(b, t, nh, hd)
    # the scalings are numpy float64 scalars in the reference, which promote
    # its q and k to fp32 whatever their dtype
    inv = 1.0 / np.sqrt(hd)
    q = float(np.float32(inv * inv)) * _l2_norm(q).float()
    k = float(np.float32(inv)) * _l2_norm(k).float()

    dt = F.softplus(a_raw.float() + p["dt_bias"].float())
    g = torch.exp(-torch.exp(p["A_log"].float()) * dt)                 # [B, T, nh]
    beta = torch.sigmoid(b_raw.float())
    if valid is not None:
        vf = valid[..., None].float()
        g = g * vf + (1.0 - vf)      # pad: no decay
        beta = beta * vf             # pad: no update

    s = s_prev.float()
    qf, kf, vf_ = q, k, v.float()
    ys = []
    for i in range(t):
        s = s * g[:, i, :, None, None]
        kv_mem = torch.einsum("bhvk,bhk->bhv", s, kf[:, i])
        delta = (vf_[:, i] - kv_mem) * beta[:, i, :, None]
        s = s + torch.einsum("bhk,bhv->bhvk", kf[:, i], delta)
        ys.append(torch.einsum("bhvk,bhk->bhv", s, qf[:, i]))
    y = torch.stack(ys, dim=1).to(x.dtype)                            # [B, T, nh, hd]

    gated = rms_norm(y, p["norm"]["weight"], cfg.rms_norm_eps) * F.silu(z.reshape(b, t, nh, hd))
    out = linear(gated.reshape(b, t, kdim), p["out_proj"])
    return out, (s.to(x.dtype), new_conv)


def init_deltanet_state(cfg: ChatConfig, batch: int, dtype=torch.float32, device="cuda"):
    """A DeltaNet layer's zero state on ``device`` (the card unless the
    caller passes the CPU)."""
    device = resolve_device(device)
    nh, hd = cfg.linear_num_heads, cfg.linear_head_dim
    return (torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),
            torch.zeros((batch, 3 * nh * hd, cfg.conv_kernel - 1), dtype=dtype, device=device))


# -- gated full attention -----------------------------------------------------

def gated_attention_forward(p, x, cfg: ChatConfig, kv_state, positions, valid=None):
    """kv_state (k cache [B, Hkv, L, D], v cache, key_valid [B, L] bool,
    length — a host int, the next write row). The new keys, values and
    valid flags are written in place at ``length``; a query sees the keys
    written before it (causal by write order) that are valid.
    → (out, (k cache, v cache, key_valid, length + T))."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    rope_dims = int(hd * cfg.partial_rotary_factor)

    qg = linear(x, p["q_proj"]).reshape(b, t, cfg.num_heads, 2 * hd)
    q, gate = qg[..., :hd], qg[..., hd:]  # interleaved per head
    k = linear(x, p["k_proj"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = linear(x, p["v_proj"]).reshape(b, t, cfg.num_kv_heads, hd)
    q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps).transpose(1, 2)
    k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps).transpose(1, 2)
    v = v.transpose(1, 2)

    cos, sin = rope_angles(positions, rope_dims, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    q = torch.cat([apply_rope(q[..., :rope_dims], cos, sin), q[..., rope_dims:]], dim=-1)
    k = torch.cat([apply_rope(k[..., :rope_dims], cos, sin), k[..., rope_dims:]], dim=-1)

    k_cache, v_cache, key_valid, length = kv_state
    k_cache[:, :, length: length + t] = k.to(k_cache.dtype)
    v_cache[:, :, length: length + t] = v.to(v_cache.dtype)
    key_valid[:, length: length + t] = valid if valid is not None else True
    lmax = k_cache.shape[2]
    cols = torch.arange(lmax, device=x.device)[None, None, None, :]
    rows = (length + torch.arange(t, device=x.device))[None, None, :, None]
    mask = torch.where((cols <= rows) & key_valid[:, None, None, :], 0.0,
                       NEG_INF).to(torch.float32)
    attn = sdpa(q, k_cache, v_cache, 1.0 / np.sqrt(hd), mask)
    attn = attn * torch.sigmoid(gate.transpose(1, 2))
    out = linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"])
    return out, (k_cache, v_cache, key_valid, length + t)


# -- full model ---------------------------------------------------------------

def chat_forward(params, cfg: ChatConfig, token_ids, states, positions, valid=None):
    """token_ids [B, T]; states a list a layer (DeltaNet tuple or KV tuple).
    → (fp32 logits [B, T, V], new states)."""
    x = embedding_lookup(params["embed_tokens"], token_ids, cfg.hidden_size)
    new_states = []
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        if cfg.layer_type(i) == "linear":
            out, st = deltanet_forward(p["deltanet"], h, cfg, states[i], valid)
        else:
            out, st = gated_attention_forward(p["attn"], h, cfg, states[i], positions, valid)
        new_states.append(st)
        x = x + out
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + _swiglu_mlp(h2, p["mlp"])
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return tied_lm_head(x, params["embed_tokens"]).float(), new_states


def init_states(cfg: ChatConfig, batch: int, max_len: int, dtype=torch.float32, device="cuda"):
    """Every layer's zero state on ``device`` (the card unless the caller
    passes the CPU)."""
    device = resolve_device(device)
    states = []
    for i in range(cfg.num_layers):
        if cfg.layer_type(i) == "linear":
            states.append(init_deltanet_state(cfg, batch, dtype, device))
        else:
            shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
            states.append((torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros((batch, max_len), dtype=torch.bool, device=device), 0))
    return states


def packed_products(params) -> int:
    """The packed products of one forward pass, the tied head included: K1's
    launches a decode step, and a prefill's of at most 256 rows."""
    def count(node):
        if isinstance(node, dict):
            return 1 if "codes" in node else sum(count(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        return 0

    return count(params)


@dataclasses.dataclass
class _DecodeState:
    step: int
    out: torch.Tensor           # [B, max_new] int64, EOS where nothing was written
    states: list
    done: torch.Tensor          # [B] bool
    tok: torch.Tensor           # [B] the last token
    hist: torch.Tensor          # [B, REP_WINDOW] the penalty's history ring
    generator: Optional[torch.Generator]


class Qwen3Chat(PipelineLLM):
    """Chat LLM with streaming generation (``PipelineLLM`` for the voice
    agent). ``params`` is a tree in the JAX package's layout (numpy arrays
    or tensors) carried onto ``device``; ``quant_bits`` packs the eligible
    linears and the embedding table there (MLX group 64)."""

    def __init__(self, cfg: ChatConfig, params, tokenizer=None, *, device="cuda",
                 dtype: torch.dtype = torch.float32, quant_bits: Optional[int] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.dtype = dtype
        p = params_from_jax(params, self.device, torch.float32)
        del params
        if quant_bits:
            p = quantize_tree(p, quant_bits, GROUP_SIZE)
        self.params = cast_tree(p, dtype)
        #: the token budget of :meth:`chat`: a depth cut for smoke runs and
        #: tests, as ``Qwen3ASR.max_tokens`` is, not a user option (the
        #: reference's chat always takes ``generate_ids_stream``'s 128)
        self.max_new = 128
        #: decode steps the last generation ran and its host reads
        self.last_loop = {"steps_run": 0, "host_reads": 0}

    @classmethod
    def init_random(cls, cfg: Optional[ChatConfig] = None, seed: int = 0,
                    quant_bits: Optional[int] = None, **kw) -> "Qwen3Chat":
        """Random weights drawn with numpy from ``seed``; ``quant_bits`` packs
        the eligible linears and the embedding table on the device."""
        cfg = cfg or CONFIG_08B
        return cls(cfg, init_chat_params(np.random.default_rng(seed), cfg),
                   quant_bits=quant_bits, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[ChatConfig] = None, seed: int = 0,
                              quant_bits: Optional[int] = None, *, device="cuda",
                              **kw) -> "Qwen3Chat":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``
        (each layer packed as drawn): the way to build the full-size model."""
        cfg = cfg or CONFIG_08B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_chat_params_on_device(cfg, generator, quant_bits), device=dev,
                   **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "Qwen/Qwen3.5-0.8B", cache_dir=None,
                        offline_mode: bool = False, dtype: torch.dtype = torch.bfloat16,
                        cfg: Optional[ChatConfig] = None, **kw) -> "Qwen3Chat":
        """A checkpoint from a local directory (safetensors, HF or MLX-packed
        layout, with ``vocab.json``, ``merges.txt`` and
        ``tokenizer_config.json``). Hub download is not ported."""
        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from ...tokenizers.bpe import BPETokenizer
        from .convert import convert_chat_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        cfg = cfg or CONFIG_08B
        params = convert_chat_checkpoint(load_safetensors(model_dir), cfg)
        return cls(cfg, params, tokenizer=tokenizer, dtype=dtype, **kw)

    # -- generation ------------------------------------------------------------

    @torch.inference_mode()
    def _gen_start(self, ids: torch.Tensor, n_valid: torch.Tensor, max_new: int,
                   max_len: int, sampling: Optional[ChatSamplingConfig],
                   generator: Optional[torch.Generator]) -> _DecodeState:
        """Prefill and the first token. ``ids`` [B, T] are left-padded: a
        prompt fills the last ``n_valid`` slots. ``sampling`` None is greedy;
        otherwise the reference's sampler with a prompt + generated history
        ring for the repetition penalty."""
        cfg = self.cfg
        b, t_bucket = ids.shape
        dev = ids.device
        states = init_states(cfg, b, max_len, self.dtype, dev)
        pad = t_bucket - n_valid
        ar = torch.arange(t_bucket, device=dev)[None]
        valid = ar >= pad[:, None]
        positions = torch.clamp(ar - pad[:, None], min=0)
        logits, states = chat_forward(self.params, cfg, ids, states, positions, valid)
        last = logits[:, -1]
        # the penalty's history starts with the prompt's tail (the reference
        # passes promptTokens + generatedTokens, MLXGenerator.swift:230)
        w_max = ChatSamplingConfig.REP_WINDOW
        w = min(w_max, t_bucket)
        hist = torch.where(valid[:, -w:], ids[:, -w:], torch.full_like(ids[:, -w:], -1))
        if w < w_max:
            hist = torch.cat([torch.full((b, w_max - w), -1, dtype=hist.dtype, device=dev), hist],
                             dim=1)
        tok = (torch.argmax(last, dim=-1) if sampling is None
               else chat_sample(last, generator, sampling, hist))
        hist = torch.cat([hist[:, 1:], tok[:, None]], dim=1)
        out = torch.full((b, max_new), cfg.eos_token_id, dtype=torch.long, device=dev)
        out[:, 0] = tok
        return _DecodeState(1, out, states, tok == cfg.eos_token_id, tok, hist, generator)

    @torch.inference_mode()
    def _gen_chunk(self, s: _DecodeState, n_valid: torch.Tensor, end: int,
                   sampling: Optional[ChatSamplingConfig] = None) -> _DecodeState:
        """Decode steps ``s.step .. end-1`` with no host read: a row that
        has emitted EOS keeps writing EOS and stops adding to its history,
        so the tokens are the reference's, whose loop exits early instead."""
        cfg = self.cfg
        eos = torch.full_like(s.tok, cfg.eos_token_id)
        for step in range(s.step, end):
            pos = (n_valid + step - 1)[:, None]   # the prompt's length + generated so far
            logits, s.states = chat_forward(self.params, cfg, s.tok[:, None], s.states, pos)
            tok = (torch.argmax(logits[:, 0], dim=-1) if sampling is None
                   else chat_sample(logits[:, 0], s.generator, sampling, s.hist))
            tok = torch.where(s.done, eos, tok)
            s.hist = torch.where(s.done[:, None], s.hist,
                                 torch.cat([s.hist[:, 1:], tok[:, None]], dim=1))
            s.out[:, step] = tok
            s.done = s.done | (tok == cfg.eos_token_id)
            s.tok = tok
        s.step = max(s.step, end)
        return s

    def _prompt(self, prompt_ids: Sequence[int]):
        n = len(prompt_ids)
        t_bucket = max(32, ((n + 31) // 32) * 32)
        ids = np.zeros((1, t_bucket), np.int64)
        ids[0, t_bucket - n:] = prompt_ids  # left-padded
        return (torch.from_numpy(ids).to(self.device),
                torch.tensor([n], device=self.device), t_bucket)

    def _generator(self, seed: int, sampling) -> Optional[torch.Generator]:
        return None if sampling is None else torch.Generator(device=self.device).manual_seed(seed)

    def generate_ids(self, prompt_ids: Sequence[int], max_new: int = 128, seed: int = 0,
                     sampling: Optional[ChatSamplingConfig] = None) -> List[int]:
        """``sampling`` None is greedy (deterministic); a
        :class:`ChatSamplingConfig` (``ChatSamplingConfig()`` is the
        reference's temperature 0.7, top-k 50, top-p 0.9, penalty 1.1; or
        ``creative()``/``precise()``) samples from ``seed``. The decode runs
        in chunks of :data:`DECODE_CHUNK` steps and stops after the chunk in
        which the row emits EOS."""
        ids, n_valid, t_bucket = self._prompt(prompt_ids)
        s = self._gen_start(ids, n_valid, max_new, t_bucket + max_new, sampling,
                            self._generator(seed, sampling))
        reads = 1
        while s.step < max_new and not bool(s.done.all()):
            s = self._gen_chunk(s, n_valid, min(s.step + DECODE_CHUNK, max_new), sampling)
            reads += 1
        self.last_loop = {"steps_run": s.step, "host_reads": reads}
        toks = []
        for t in s.out[0].tolist():
            if t == self.cfg.eos_token_id:
                break
            toks.append(t)
        return toks

    def generate_ids_stream(self, prompt_ids: Sequence[int], max_new: int = 128,
                            seed: int = 0, chunk: int = 16,
                            sampling: Optional[ChatSamplingConfig] = None) -> Iterator[int]:
        """Yield token ids as they decode: the first after the prefill, then
        ``chunk`` tokens a host read; stops at EOS. The tokens are
        :meth:`generate_ids`' (the same steps)."""
        ids, n_valid, t_bucket = self._prompt(prompt_ids)
        s = self._gen_start(ids, n_valid, max_new, t_bucket + max_new, sampling,
                            self._generator(seed, sampling))
        reads = 1
        self.last_loop = {"steps_run": s.step, "host_reads": reads}
        tok0 = int(s.tok[0])
        if tok0 == self.cfg.eos_token_id:
            return
        yield tok0
        step = 1
        while step < max_new:
            end = min(step + chunk, max_new)
            s = self._gen_chunk(s, n_valid, end, sampling)
            out = s.out[0, step:end].tolist()
            reads += 1
            self.last_loop = {"steps_run": s.step, "host_reads": reads}
            for t in out:
                if t == self.cfg.eos_token_id:
                    return
                yield t
            step = end

    # -- chat API ------------------------------------------------------------

    @staticmethod
    def apply_chat_template(messages: Sequence[dict]) -> str:
        """reference: ChatTemplate.swift — <|im_start|>role\\n…<|im_end|>."""
        parts = []
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def chat(self, messages: Sequence[dict], tools: Sequence[dict] = (),
             sampling: Optional[ChatSamplingConfig] = None) -> Iterator[str]:
        """Stream the reply's text pieces for a chat history, up to
        ``self.max_new`` tokens. ``sampling`` None is greedy; pass
        ``ChatSamplingConfig()`` for the reference server's sampled decoding."""
        if self.tokenizer is None:
            raise RuntimeError("chat requires a tokenizer")
        from ...tokenizers.bpe import StreamingDecoder

        ids = self.tokenizer.encode(self.apply_chat_template(messages))
        dec = StreamingDecoder(self.tokenizer)
        for t in self.generate_ids_stream(ids, max_new=self.max_new, sampling=sampling):
            piece = dec.push(t)
            if piece:
                yield piece
        tail = dec.finish()
        if tail:
            yield tail
