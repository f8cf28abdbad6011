"""Plain PyTorch reference of Qwen3-ASR transcription, and the weights and
clips that both it and the program are given.

Nothing here imports the program or the JAX package. The reference
follows the published model:

- log-mel: reflect pad, periodic Hann window, |rfft|^2 of 512 points,
  Slaney mel filterbank, log10, the last frame dropped, clamp to max - 8,
  (x + 4) / 4 (Whisper's feature extractor);
- encoder: the mel cut into 100-frame chunks (the last one zero-padded),
  three 3x3 stride-2 convs with GELU, channel-major flatten, ``conv_out``,
  sinusoidal positions within each chunk, the valid tokens concatenated,
  pre-LN transformer layers attending inside windows of 104 tokens,
  ``ln_post``, ``proj1``, GELU, ``proj2``;
- decoder: the chat prompt ``<|im_start|>system\\n<|im_end|>\\n
  <|im_start|>user\\n<|audio_start|> audio <|audio_end|><|im_end|>\\n
  <|im_start|>assistant\\n<asr_text>`` and the transcript, a Qwen3 stack
  (RMSNorm, GQA with per-head q/k RMSNorm and split-half RoPE, SwiGLU),
  final RMSNorm, the tied embedding as the head.

Each quantized weight is worked out again from the raw draw by the MLX
affine rule (per group of 64 inputs: scale = (max - min) / levels, code =
round((w - min) / scale), w' = code * scale + min). With an int8 KV cache
the keys and values that a decode step reads are quantized per slot
(scale = max|x| / 127, round half to even), as the configuration states;
the prompt's own attention reads them unquantized. Everything is fp32 with
TF32 off, one request at a time, teacher-forced over the tokens served.

``act`` rounds the input of every product (linear, conv, head) to a lower
precision: :func:`fp8_rows` is the control's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# inputs: weights drawn on the device from the seed, in the served dtype
# --------------------------------------------------------------------------- #

def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and a path."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *path]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def _layout(cfg: dict):
    """(encoder normals, encoder ones, encoder zeros, decoder normals,
    decoder ones): each a list of (path, shape, scale) in draw order. A
    path is a tuple of keys into the parameter tree (layer index as int)."""
    e, d = cfg["encoder"], cfg["decoder"]
    dm, ch = e["d_model"], e["downsample_hidden"]
    enc_n, enc_1, enc_0 = [], [], []

    def lin(pre, d_in, d_out, bias=True):
        enc_n.append((pre + ("kernel",), (d_in, d_out), 1.0 / math.sqrt(d_in)))
        if bias:
            enc_0.append((pre + ("bias",), (d_out,), 0.0))

    def conv(name, c_in):
        enc_n.append(((name, "kernel"), (3, 3, c_in, ch), 1.0 / math.sqrt(9 * c_in)))
        enc_0.append(((name, "bias"), (ch,), 0.0))

    def ln(pre, dim):
        enc_1.append((pre + ("weight",), (dim,), 1.0))
        enc_0.append((pre + ("bias",), (dim,), 0.0))

    conv("conv1", 1)
    conv("conv2", ch)
    conv("conv3", ch)
    enc_n.append((("conv_out", "kernel"), (e["conv_out_input_dim"], dm),
                  cfg["init"]["conv_out_gain"] / math.sqrt(e["conv_out_input_dim"])))
    ln(("ln_post",), dm)
    lin(("proj1",), dm, dm)
    lin(("proj2",), dm, e["output_dim"])
    for i in range(e["num_layers"]):
        pre = ("layers", i)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(pre + (name,), dm, dm)
        ln(pre + ("attn_ln",), dm)
        lin(pre + ("fc1",), dm, e["ffn_dim"])
        lin(pre + ("fc2",), e["ffn_dim"], dm)
        ln(pre + ("final_ln",), dm)

    h, hd = d["hidden_size"], d["head_dim"]
    qk = cfg["init"]["qk_norm_weight"]
    dec_n = [(("embed_tokens",), (d["vocab_size"], h), 0.02)]
    dec_1 = [(("norm", "weight"), (h,), 1.0)]
    for i in range(d["num_layers"]):
        pre = ("layers", i)
        for name, d_in, d_out in (("q_proj", h, d["num_heads"] * hd),
                                  ("k_proj", h, d["num_kv_heads"] * hd),
                                  ("v_proj", h, d["num_kv_heads"] * hd),
                                  ("o_proj", d["num_heads"] * hd, h)):
            dec_n.append((pre + (name, "kernel"), (d_in, d_out), 1.0 / math.sqrt(d_in)))
        for name in ("gate_proj", "up_proj"):
            dec_n.append((pre + ("mlp", name, "kernel"), (h, d["intermediate_size"]),
                          1.0 / math.sqrt(h)))
        dec_n.append((pre + ("mlp", "down_proj", "kernel"), (d["intermediate_size"], h),
                      1.0 / math.sqrt(d["intermediate_size"])))
        for name, dim in (("input_layernorm", h), ("post_attention_layernorm", h)):
            dec_1.append((pre + (name, "weight"), (dim,), 1.0))
        for name in ("q_norm", "k_norm"):
            dec_1.append((pre + (name, "weight"), (hd,), qk))
    return enc_n, enc_1, enc_0, dec_n, dec_1


def _put(tree: dict, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _fill(tree: dict, specs, buf: torch.Tensor) -> None:
    off = 0
    for path, shape, scale in specs:
        n = math.prod(shape)
        view = buf[off:off + n].view(shape)
        if scale not in (0.0, 1.0):
            view.mul_(scale)
        _put(tree, path, view)
        off += n


def draw_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """(encoder tree, decoder tree) in the layout the program takes
    (dense kernels [in, out], conv kernels HWIO), raw and unquantized, in
    ``dtype``. Each group of leaves is one draw into one buffer on
    ``device`` from a ``torch.Generator`` seeded from ``seed``; the same
    seed on the same device gives the same values. Kernels are normal with
    std 1/sqrt(fan-in), the table 0.02, biases 0, norm weights 1, but for
    two gains of the configuration's ``init``, without which a random model
    answers alike whatever it hears:

    - ``qk_norm_weight``, the per-head q/k norms' weight: at 1 every query
      attends almost evenly and every row decodes one token over and over;
      at 4 the 28 layers turn bf16 rounding into other tokens;
    - ``conv_out_gain`` on ``conv_out``: at 1 the sinusoidal positions
      (rms 0.71) outweigh the conv front end's output and every clip
      encodes within a few per cent of every other."""
    enc_n, enc_1, enc_0, dec_n, dec_1 = _layout(cfg)
    enc, dec = {}, {}
    for tree, specs, kind, stream in ((enc, enc_n, "normal", 1), (enc, enc_1, "ones", 0),
                                      (enc, enc_0, "zeros", 0), (dec, dec_n, "normal", 2),
                                      (dec, dec_1, "ones", 0)):
        total = sum(math.prod(s) for _, s, _ in specs)
        if kind == "normal":
            gen = torch.Generator(device=device).manual_seed(derived_seed(seed, stream))
            buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        else:
            buf = (torch.ones if kind == "ones" else torch.zeros)(total, device=device, dtype=dtype)
        _fill(tree, specs, buf)
    return enc, dec


# --------------------------------------------------------------------------- #
# lower precision for the control
# --------------------------------------------------------------------------- #

def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (max |x| to 448), back in fp32."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# --------------------------------------------------------------------------- #
# the reference
# --------------------------------------------------------------------------- #

def mlx_dequantize(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """w [out, in] → the fp32 weight its MLX affine packing stands for."""
    out_dim, in_dim = w.shape
    levels = (1 << bits) - 1
    g = w.float().reshape(out_dim, in_dim // group, group)
    gmax, gmin = g.amax(dim=-1, keepdim=True), g.amin(dim=-1, keepdim=True)
    scale = (gmax - gmin) / torch.tensor(float(levels), device=w.device)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    codes = torch.clamp(torch.round((g - gmin) / scale), 0, levels)
    return (codes * scale + gmin).reshape(out_dim, in_dim)


def slaney_filterbank(n_mels: int, n_freqs: int, sample_rate: int, padded_fft: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters [n_freqs, n_mels]."""
    def hz_to_mel(hz):
        hz = np.asarray(hz, np.float64)
        lin = 3.0 * hz / 200.0
        log = 15.0 + np.log(np.maximum(hz, 1e-12) / 1000.0) * (27.0 / np.log(6.4))
        return np.where(hz < 1000.0, lin, log)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m < 15.0, 200.0 * m / 3.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0))

    freqs = np.arange(n_freqs) * sample_rate / padded_fft
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb


class Reference:
    """The reference over one configuration and one draw of weights.

    ``cfg`` is the configuration file's content; ``enc``/``dec`` the raw
    trees of :func:`draw_weights`. The float weights are taken in fp32,
    the decoder's linears and table through :func:`mlx_dequantize`."""

    def __init__(self, cfg: dict, enc: dict, dec: dict, device, act=None):
        self.e, self.d, self.tok = cfg["encoder"], cfg["decoder"], cfg["special_tokens"]
        self.mel_cfg = cfg["mel"]
        serving = cfg["serving"]
        self.int8_kv = serving["kv_dtype"] == "int8"
        bits, group = serving["quant_bits"], serving["group_size"]
        self.device = device
        self.act = act or _identity
        f32 = lambda t: t.float()  # noqa: E731
        self.enc = _map(enc, f32)

        def deq(kernel):            # [in, out] raw → dequantized [out, in]
            return mlx_dequantize(kernel.T, bits, group)

        self.embed = mlx_dequantize(dec["embed_tokens"], bits, group)        # [V, h]
        self.final_norm = dec["norm"]["weight"].float()
        self.layers = []
        for p in dec["layers"]:
            self.layers.append({
                "q": deq(p["q_proj"]["kernel"]), "k": deq(p["k_proj"]["kernel"]),
                "v": deq(p["v_proj"]["kernel"]), "o": deq(p["o_proj"]["kernel"]),
                "gate": deq(p["mlp"]["gate_proj"]["kernel"]),
                "up": deq(p["mlp"]["up_proj"]["kernel"]),
                "down": deq(p["mlp"]["down_proj"]["kernel"]),
                "q_norm": p["q_norm"]["weight"].float(), "k_norm": p["k_norm"]["weight"].float(),
                "ln1": p["input_layernorm"]["weight"].float(),
                "ln2": p["post_attention_layernorm"]["weight"].float()})
        m = self.mel_cfg
        n_freqs = m["padded_fft"] // 2 + 1
        self.fb = torch.tensor(slaney_filterbank(m["n_mels"], n_freqs, m["sample_rate"],
                                                 m["padded_fft"]), dtype=torch.float32,
                               device=device)
        self.window = torch.hann_window(m["n_fft"], periodic=True, dtype=torch.float64,
                                        device=device).float()

    # -- products ---------------------------------------------------------- #

    def _lin(self, x, w_out_in, bias=None):
        y = self.act(x) @ w_out_in.T
        return y if bias is None else y + bias

    def _dense(self, x, p):
        return self._lin(x, p["kernel"].T, p.get("bias"))

    # -- front end --------------------------------------------------------- #

    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """audio fp32 [n] → [n_mels, frames]."""
        m = self.mel_cfg
        pad = m["n_fft"] // 2
        x = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
        frames = x.unfold(0, m["n_fft"], m["hop_length"]) * self.window
        spec = torch.fft.rfft(frames, n=m["padded_fft"], dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mel = power @ self.fb
        log = torch.log10(torch.clamp(mel, min=m["log_clamp_floor"]))[:-1]
        log = torch.maximum(log, log.max() - m["dynamic_range"])
        return ((log + 4.0) / 4.0).T

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio fp32 [n] → audio tokens [n_tokens, output_dim]."""
        e, p = self.e, self.enc
        mel = self.log_mel(audio)
        chunk = 2 * e["n_window"]
        n_frames = mel.shape[1]
        n_chunks = -(-n_frames // chunk)
        mel = F.pad(mel, (0, n_chunks * chunk - n_frames))
        x = mel.reshape(e["n_mels"], n_chunks, chunk).permute(1, 0, 2)[:, None]
        for name in ("conv1", "conv2", "conv3"):
            w = p[name]["kernel"].permute(3, 2, 0, 1)
            x = F.gelu(F.conv2d(self.act(x), w, p[name]["bias"], stride=2, padding=1))
        nc, c, fr, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(nc, t, c * fr)
        x = self._dense(x, p["conv_out"])
        half = e["d_model"] // 2
        inv = torch.exp(-math.log(10000.0) / (half - 1) * torch.arange(half, dtype=torch.float64))
        ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None]
        pos = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float().to(x.device)
        x = x + pos[None]
        counts = [t] * (n_frames // chunk)
        rem = n_frames % chunk
        if rem:
            f = rem
            for _ in range(3):
                f = (f - 1) // 2 + 1
            counts.append(max(f, 1))
        x = torch.cat([x[i, :n] for i, n in enumerate(counts)], dim=0)       # [N, d]
        win = (e["n_window_infer"] // chunk) * t
        heads, hd = e["num_heads"], e["d_model"] // e["num_heads"]
        for lp in p["layers"]:
            h = F.layer_norm(x, (x.shape[-1],), lp["attn_ln"]["weight"], lp["attn_ln"]["bias"],
                             e["layer_norm_eps"])
            q, k, v = (self._dense(h, lp[n]) for n in ("q_proj", "k_proj", "v_proj"))
            out = torch.empty_like(q)
            for s in range(0, x.shape[0], win):
                sl = slice(s, min(s + win, x.shape[0]))
                qh, kh, vh = (y[sl].reshape(-1, heads, hd).transpose(0, 1) for y in (q, k, v))
                a = torch.softmax(qh @ kh.transpose(1, 2) / math.sqrt(hd), dim=-1) @ vh
                out[sl] = a.transpose(0, 1).reshape(-1, e["d_model"])
            x = x + self._dense(out, lp["out_proj"])
            h = F.layer_norm(x, (x.shape[-1],), lp["final_ln"]["weight"], lp["final_ln"]["bias"],
                             e["layer_norm_eps"])
            x = x + self._dense(F.gelu(self._dense(h, lp["fc1"])), lp["fc2"])
        x = F.layer_norm(x, (x.shape[-1],), p["ln_post"]["weight"], p["ln_post"]["bias"],
                         e["layer_norm_eps"])
        return self._dense(F.gelu(self._dense(x, p["proj1"])), p["proj2"])

    # -- decoder ----------------------------------------------------------- #

    def prompt_ids(self):
        t = self.tok
        prefix = [t["im_start_id"], t["system_id"], t["newline_id"], t["eos_id"], t["newline_id"],
                  t["im_start_id"], t["user_id"], t["newline_id"], t["audio_start_id"]]
        suffix = [t["audio_end_id"], t["eos_id"], t["newline_id"], t["im_start_id"],
                  t["assistant_id"], t["newline_id"], t["asr_text_id"]]
        return prefix, suffix

    def _rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.d["rms_norm_eps"]) * w

    @staticmethod
    def _int8_slots(x):
        scale = x.abs().amax(dim=-1, keepdim=True) / torch.tensor(127.0, device=x.device)
        q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-8)), -127, 127)
        return q * scale

    def logits(self, audio: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
        """fp32 logits [len(served), vocab]: row i the model's distribution
        for served token i, given the clip and served tokens before it."""
        d = self.d
        prefix, suffix = self.prompt_ids()
        dev = self.embed.device
        audio_tok = self.encode(audio)
        ids = lambda v: torch.as_tensor(v, dtype=torch.long, device=dev)  # noqa: E731
        x = torch.cat([self.embed[ids(prefix)], audio_tok, self.embed[ids(suffix)],
                       self.embed[served[:-1].to(dev).long()]], dim=0)
        n = x.shape[0]
        n_prompt = n - (len(served) - 1)
        hq, hkv, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
        pos = torch.arange(n, dtype=torch.float64, device=dev)
        inv = 1.0 / (d["rope_theta"] ** (torch.arange(0, hd // 2, dtype=torch.float64,
                                                      device=dev) / (hd // 2)))
        ang = pos[:, None] * inv[None]
        cos, sin = torch.cos(ang).float(), torch.sin(ang).float()

        def rope(t):                                   # [H, n, hd]
            a, b = t[..., :hd // 2], t[..., hd // 2:]
            return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

        causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
        scale = 1.0 / math.sqrt(hd)
        for lp in self.layers:
            h = self._rms(x, lp["ln1"])
            q = self._lin(h, lp["q"]).reshape(n, hq, hd)
            k = self._lin(h, lp["k"]).reshape(n, hkv, hd)
            v = self._lin(h, lp["v"]).reshape(n, hkv, hd)
            q = rope(self._rms(q, lp["q_norm"]).transpose(0, 1))
            k = rope(self._rms(k, lp["k_norm"]).transpose(0, 1))
            v = v.transpose(0, 1)
            g = hq // hkv
            kk, vv = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
            s = (q @ kk.transpose(1, 2)) * scale
            s = s.masked_fill(~causal, float("-inf"))
            att = torch.softmax(s, dim=-1) @ vv                               # [hq, n, hd]
            if self.int8_kv and n > n_prompt:
                kq = self._int8_slots(k).repeat_interleave(g, 0)
                vq = self._int8_slots(v).repeat_interleave(g, 0)
                sq = (q[:, n_prompt:] @ kq.transpose(1, 2)) * scale
                sq = sq.masked_fill(~causal[n_prompt:], float("-inf"))
                att[:, n_prompt:] = torch.softmax(sq, dim=-1) @ vq
            x = x + self._lin(att.transpose(0, 1).reshape(n, hq * hd), lp["o"])
            h = self._rms(x, lp["ln2"])
            x = x + self._lin(F.silu(self._lin(h, lp["gate"])) * self._lin(h, lp["up"]),
                              lp["down"])
        rows = self._rms(x[n_prompt - 1:], self.final_norm)
        return self._lin(rows, self.embed)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The gap by which each token's logit lies below the reference's best."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens.to(ref_logits.device).long()[:, None])[:, 0]
