"""Speech enhancement: DeepFilterNet3 at 48 kHz — port of
``qwen3_asr_swift_tpu/models/enhancement/model.py``.

The reference's DSP, on tensors of one device:

- the Vorbis window folded into explicit DFT and inverse-DFT matrices
  (products with them, not ``torch.stft``, so the port computes what the
  reference computes);
- rectangular ERB bands (min 2 bins, forward 1/width, inverse 1);
- ERB features in dB with the exponential mean-norm and the unit-normed
  complex low band, two recurrences over frames (a loop on the device);
- order-5 deep filtering over the lowest 96 bins with 2-frame lookahead;
  the DF output replaces the low bins, the ERB mask covers the rest;
- the iSTFT's overlap-add (Vorbis COLA: no normalization).

:meth:`SpeechEnhancer.enhance` feeds the whole clip through the same
:class:`StreamingEnhancer` a live stream uses (a ladder of 1000-, 100- and
10-hop pieces, then the tail), so streamed output equals the batch output
up to the rounding of batched products.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SpeechEnhancementModel
from ...core.types import AudioChunk
from ...device import resolve_device
from .dfn3 import DF_ORDER, LOOKAHEAD, NB_DF, NB_ERB, dfn3_step, init_dfn3_params, init_state

SR = 48000
N_FFT = 960
HOP = 480
N_BINS = N_FFT // 2 + 1  # 481
N_ERB = NB_ERB
N_DF_BINS = NB_DF
NORM_TAU = 1.0
NORM_ALPHA = float(np.exp(-HOP / SR / NORM_TAU))  # ≈0.99005


def vorbis_window(n: int = N_FFT) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin(np.pi / 2 * np.sin(np.pi * (i + 0.5) / n) ** 2).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _dft():
    n = np.arange(N_FFT)
    window = vorbis_window().astype(np.float64)
    k = np.arange(N_BINS)
    phase = 2 * np.pi * np.outer(n, k) / N_FFT
    return (
        (window[:, None] * np.cos(phase)).astype(np.float32),
        (window[:, None] * -np.sin(phase)).astype(np.float32),
        window.astype(np.float32),
    )


@functools.lru_cache(maxsize=1)
def _idft():
    n = np.arange(N_FFT)
    k = np.arange(N_BINS)
    phase = 2 * np.pi * np.outer(k, n) / N_FFT
    scale = np.full(N_BINS, 2.0, np.float64)
    scale[0] = scale[-1] = 1.0
    icos = (scale[:, None] * np.cos(phase) / N_FFT).astype(np.float32)
    isin = (scale[:, None] * np.sin(phase) / N_FFT).astype(np.float32)
    return icos, isin


@functools.lru_cache(maxsize=1)
def _erb_fb_widths():
    """Rectangular ERB bands (reference AudioProcessing.swift:27-106)."""
    def freq2erb(f):
        return 9.265 * np.log(1.0 + f / (24.7 * 9.265))

    def erb2freq(e):
        return 24.7 * 9.265 * (np.exp(e / 9.265) - 1.0)

    erb_low, erb_high = freq2erb(0.0), freq2erb(SR / 2)
    step = (erb_high - erb_low) / N_ERB
    widths = np.zeros(N_ERB, np.int64)
    total = 0
    for band in range(N_ERB):
        f_lo = erb2freq(erb_low + band * step)
        f_hi = erb2freq(erb_low + (band + 1) * step)
        b_lo = int(round(f_lo * N_FFT / SR))
        b_hi = int(round(f_hi * N_FFT / SR))
        w = max(2, b_hi - b_lo)
        if band == N_ERB - 1:
            w = N_BINS - total
        widths[band] = w
        total += w
    if total != N_BINS:
        widths[-1] += N_BINS - total

    fwd = np.zeros((N_BINS, N_ERB), np.float32)
    inv = np.zeros((N_ERB, N_BINS), np.float32)
    off = 0
    for band in range(N_ERB):
        w = int(widths[band])
        fwd[off:off + w, band] = 1.0 / w
        inv[band, off:off + w] = 1.0
        off += w
    return fwd, inv, widths


def erb_filterbank() -> np.ndarray:
    """Forward ERB filterbank [N_BINS, N_ERB]."""
    return _erb_fb_widths()[0]


def erb_inverse_filterbank() -> np.ndarray:
    """Inverse ERB filterbank [N_ERB, N_BINS]."""
    return _erb_fb_widths()[1]


# libDF default normalization-state initializers (overridden by the
# checkpoint's auxiliary.npz states when present — the reference loads
# mean_norm_state/unit_norm_state from auxiliary.npz, WeightLoading.swift:43-62).
def default_mean_norm_init() -> np.ndarray:
    return np.linspace(-60.0, -90.0, N_ERB).astype(np.float32)


def default_unit_norm_init() -> np.ndarray:
    return np.linspace(0.001, 0.0001, N_DF_BINS).astype(np.float32)


class _Bases:
    """The DSP matrices on one device."""

    def __init__(self, device):
        cos_m, sin_m, window = _dft()
        icos, isin = _idft()
        self.cos, self.sin = (torch.from_numpy(m).to(device) for m in (cos_m, sin_m))
        self.icos, self.isin = (torch.from_numpy(m).to(device) for m in (icos, isin))
        self.window = torch.from_numpy(window).to(device)
        self.fb = torch.from_numpy(erb_filterbank()).to(device)
        self.inv_fb = torch.from_numpy(erb_inverse_filterbank()).to(device)


# ---------------------------------------------------------------------------
# feature extraction (shared batch/streaming math)
# ---------------------------------------------------------------------------

def _featurize(bases: _Bases, frames, mean_state, unit_state):
    """Windowed DFT + ERB dB mean-norm features + unit-normalized low-band
    complex spectrum. frames: [F, N_FFT] raw signal frames (the Vorbis
    window is folded into the DFT matrices). Returns (erb_n [F,32],
    spec_n [F,96,2], re, im, mean_state, unit_state)."""
    re = frames @ bases.cos
    im = frames @ bases.sin
    power = re * re + im * im
    erb_db = 10.0 * torch.log10(power @ bases.fb + 1e-10)

    erb_n = torch.empty_like(erb_db)
    for t in range(erb_db.shape[0]):
        mean_state = erb_db[t] * (1 - NORM_ALPHA) + mean_state * NORM_ALPHA
        erb_n[t] = (erb_db[t] - mean_state) / 40.0

    lo_re, lo_im = re[:, :N_DF_BINS], im[:, :N_DF_BINS]
    mag = torch.sqrt(lo_re * lo_re + lo_im * lo_im)
    spec_n = torch.empty(lo_re.shape + (2,), dtype=re.dtype, device=re.device)
    for t in range(mag.shape[0]):
        unit_state = mag[t] * (1 - NORM_ALPHA) + unit_state * NORM_ALPHA
        norm = torch.sqrt(torch.clamp(unit_state, min=1e-10))
        spec_n[t, :, 0] = lo_re[t] / norm
        spec_n[t, :, 1] = lo_im[t] / norm
    return erb_n, spec_n, re, im, mean_state, unit_state


def _istft_ola(bases: _Bases, re, im, synthesis_mem):
    """Inverse DFT → synthesis window → overlap-add, hop samples a frame.
    With N_FFT = 2·HOP each hop is a frame's first half plus the previous
    frame's second half (the reference's scan, as one add). Returns
    (samples [F*HOP], new synthesis_mem)."""
    frames = (re @ bases.icos - im @ bases.isin) * bases.window      # [F, N_FFT]
    prev = torch.cat([synthesis_mem[None], frames[:-1, HOP:]])
    hops = frames[:, :HOP] + prev
    return hops.reshape(-1), frames[-1, HOP:]


def _streaming_net_step(bases: _Bases, params, net_erb, net_spec, spec_re, spec_im, dfn_state,
                        synthesis_mem):
    """Emit F frames: net inputs are the lookahead-shifted features, spec_re/
    spec_im are [F+DF_ORDER-1, N_BINS] raw spectra covering taps t-2..t+2 of
    every emitted frame. Returns (samples [F*HOP], new state, new synth mem)."""
    mask, coefs, _lsnr, dfn_state = dfn3_step(params, net_erb, net_spec, dfn_state)
    n_frames = mask.shape[0]
    pad_before = DF_ORDER - 1 - LOOKAHEAD

    cur_re = spec_re[pad_before: pad_before + n_frames]
    cur_im = spec_im[pad_before: pad_before + n_frames]
    full_mask = mask @ bases.inv_fb
    out_re = cur_re * full_mask
    out_im = cur_im * full_mask

    df_re = spec_re.new_zeros((n_frames, N_DF_BINS))
    df_im = spec_re.new_zeros((n_frames, N_DF_BINS))
    for n in range(DF_ORDER):
        xr = spec_re[n: n + n_frames, :N_DF_BINS]
        xi = spec_im[n: n + n_frames, :N_DF_BINS]
        wr, wi = coefs[:, :, n, 0], coefs[:, :, n, 1]
        df_re = df_re + (xr * wr - xi * wi)
        df_im = df_im + (xi * wr + xr * wi)
    out_re = torch.cat([df_re, out_re[:, N_DF_BINS:]], dim=1)
    out_im = torch.cat([df_im, out_im[:, N_DF_BINS:]], dim=1)

    samples, synthesis_mem = _istft_ola(bases, out_re, out_im, synthesis_mem)
    return samples, dfn_state, synthesis_mem


class SpeechEnhancer(SpeechEnhancementModel):
    """DeepFilterNet3 at 48 kHz on one device. ``params`` is a tree in the
    JAX package's layout (numpy arrays or tensors), carried onto ``device``
    in fp32."""

    def __init__(self, params, *, device="cuda", mean_norm_init=None, unit_norm_init=None):
        self.device = resolve_device(device)
        self.params = params_from_jax(params, self.device, torch.float32)
        self.mean_norm_init = np.asarray(
            mean_norm_init if mean_norm_init is not None else default_mean_norm_init(),
            np.float32)
        self.unit_norm_init = np.asarray(
            unit_norm_init if unit_norm_init is not None else default_unit_norm_init(),
            np.float32)
        self.bases = _Bases(self.device)
        self._loaded = True

    @classmethod
    def init_random(cls, seed: int = 0, **kw) -> "SpeechEnhancer":
        """The published widths, weights drawn with numpy from ``seed``."""
        return cls(init_dfn3_params(np.random.default_rng(seed)), **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "aufklarer/DeepFilterNet3-CoreML",
                        cache_dir=None, offline_mode: bool = False, progress_handler=None,
                        **kw) -> "SpeechEnhancer":
        """An upstream DeepFilterNet3 checkpoint from a local directory
        (``convert.py``; ``auxiliary.npz`` for the norm states when
        present); a model id is found in the cache or fetched
        (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        params, aux = convert_checkpoint(model_dir)
        return cls(params, mean_norm_init=aux.get("mean_norm_state"),
                   unit_norm_init=aux.get("unit_norm_state"), **kw)

    def enhance(self, audio: np.ndarray, sample_rate: int) -> AudioChunk:
        if sample_rate != SR:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, SR)
        if len(audio) == 0:
            return AudioChunk(np.zeros(0, np.float32), SR)
        t_in = len(audio)
        # the streaming path, fed through a geometric chunk ladder (as the
        # reference: few large pieces, then the sub-10-hop tail)
        session = StreamingEnhancer(self)
        parts = []
        buf = np.asarray(audio, np.float32)
        for mult in (1000, 100, 10):
            bucket = mult * HOP
            while len(buf) >= bucket:
                parts.append(session.push_exact(buf[:bucket]))
                buf = buf[bucket:]
        session.push_tail(buf)  # tail < 10 hops: flush pads and drains it
        parts.append(session.flush())
        out = np.concatenate(parts)
        out = np.pad(out, (0, max(0, t_in - len(out))))[:t_in]
        return AudioChunk(out.astype(np.float32), SR)

    def warm_up(self) -> None:
        self.enhance(np.zeros(SR, np.float32), SR)

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


class StreamingEnhancer:
    """Chunked 48 kHz enhancement with carried state. Output equals the
    batch path on shared samples; the algorithmic delay is one hop (STFT)
    plus the 2-frame network lookahead = 30 ms.

    The net input for OUTPUT frame ``t`` is FEATURE frame ``t+2``: features
    0 and 1 seed the input-conv histories, and every newly arrived feature
    frame ``f ≥ 2`` drives the emission of frame ``f−2``. ``flush`` feeds
    the two trailing zero net inputs to emit the last two frames, with DF
    taps clamped to the final raw spectrum. The features, spectra and
    network state stay on the model's device; each push returns its
    samples on the host."""

    def __init__(self, model: SpeechEnhancer, chunk_samples: int = 10 * HOP):
        if chunk_samples % HOP:
            raise ValueError("chunk_samples must be a multiple of the 480-sample hop")
        self.model = model
        self.chunk = chunk_samples
        self.reset()

    def reset(self):
        dev = self.model.device
        self._buf = np.zeros(0, np.float32)
        self._analysis_mem = np.zeros(N_FFT - HOP, np.float32)
        self._mean = torch.from_numpy(self.model.mean_norm_init).to(dev)
        self._unit = torch.from_numpy(self.model.unit_norm_init).to(dev)
        self._dfn = init_state(dev)
        self._synth = torch.zeros(N_FFT - HOP, device=dev)
        self._to_skip_feats = LOOKAHEAD   # leading features that are not net inputs
        self._spec_hist_re: Optional[torch.Tensor] = None   # raw spectra the DF taps still need
        self._spec_hist_im: Optional[torch.Tensor] = None
        self._skipped = 0                 # leading hop samples dropped (batch trim)

    def push(self, samples: np.ndarray) -> np.ndarray:
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        out = np.zeros(0, np.float32)
        while len(self._buf) >= self.chunk:
            piece, self._buf = self._buf[: self.chunk], self._buf[self.chunk:]
            out = np.concatenate([out, self._ingest(piece)])
        return out

    def push_exact(self, piece: np.ndarray) -> np.ndarray:
        """Process a hop-multiple piece at once, bypassing push()'s chunk
        re-buffering (batch enhance()'s ladder). Requires an empty buffer
        and ``len(piece) % HOP == 0``."""
        if len(self._buf):
            raise ValueError("push_exact requires an empty stream buffer "
                             f"({len(self._buf)} samples pending)")
        if len(piece) % HOP:
            raise ValueError(f"push_exact piece must be a hop multiple, got {len(piece)}")
        return self._ingest(np.asarray(piece, np.float32))

    def push_tail(self, piece: np.ndarray) -> None:
        """Buffer a final sub-hop tail for flush() (batch enhance())."""
        if len(self._buf):
            raise ValueError("push_tail requires an empty stream buffer")
        self._buf = np.asarray(piece, np.float32)

    def flush(self) -> np.ndarray:
        """Drain: the batch path's trailing hop of zero samples, then the
        2-frame zero-feature lookahead pad (emitting the last 2 frames)."""
        rem = len(self._buf)
        pad = (-rem) % HOP
        piece = np.pad(self._buf, (0, pad + HOP))
        self._buf = np.zeros(0, np.float32)
        out = self._ingest(piece)

        if self._spec_hist_re is None:
            return out
        dev = self.model.device
        n_emit = LOOKAHEAD
        net_erb = torch.zeros((n_emit, N_ERB), device=dev)
        net_spec = torch.zeros((n_emit, N_DF_BINS, 2), device=dev)
        # DF taps past the end clamp to the last raw frame (edge padding)
        need = n_emit + DF_ORDER - 1
        spec_re = torch.cat([self._spec_hist_re,
                             self._spec_hist_re[-1:].expand(LOOKAHEAD, -1)])[-need:]
        spec_im = torch.cat([self._spec_hist_im,
                             self._spec_hist_im[-1:].expand(LOOKAHEAD, -1)])[-need:]
        if len(spec_re) < need:   # degenerate sub-2-frame streams
            lead = need - len(spec_re)
            spec_re = torch.cat([spec_re[:1].expand(lead, -1), spec_re])
            spec_im = torch.cat([spec_im[:1].expand(lead, -1), spec_im])
        samples = self._step(net_erb, net_spec, spec_re, spec_im)
        return np.concatenate([out, self._trim(samples)])

    @torch.inference_mode()
    def _step(self, net_erb, net_spec, spec_re, spec_im) -> np.ndarray:
        samples, self._dfn, self._synth = _streaming_net_step(
            self.model.bases, self.model.params, net_erb, net_spec, spec_re, spec_im,
            self._dfn, self._synth)
        return samples.cpu().numpy()

    def _trim(self, samples: np.ndarray) -> np.ndarray:
        """Drop the leading hop of output (the batch path's latency trim)."""
        if self._skipped < HOP:
            take = min(HOP - self._skipped, len(samples))
            self._skipped += take
            samples = samples[take:]
        return samples

    @torch.inference_mode()
    def _ingest(self, piece: np.ndarray) -> np.ndarray:
        n_new = len(piece) // HOP
        if n_new == 0:
            return np.zeros(0, np.float32)
        signal = np.concatenate([self._analysis_mem, piece])
        idx = np.arange(n_new)[:, None] * HOP + np.arange(N_FFT)[None, :]
        frames = torch.from_numpy(np.ascontiguousarray(signal[idx])).to(self.model.device)
        self._analysis_mem = signal[n_new * HOP:]

        erb_n, spec_n, re, im, self._mean, self._unit = _featurize(
            self.model.bases, frames, self._mean, self._unit)

        if self._spec_hist_re is None:
            # DF taps for the first frames clamp to frame 0 (edge padding)
            pb = DF_ORDER - 1 - LOOKAHEAD
            self._spec_hist_re = re[:1].expand(pb, -1)
            self._spec_hist_im = im[:1].expand(pb, -1)
        self._spec_hist_re = torch.cat([self._spec_hist_re, re])
        self._spec_hist_im = torch.cat([self._spec_hist_im, im])

        # the first LOOKAHEAD features of the stream are trimmed from the
        # net-input sequence, but seed the input-conv histories (the batch
        # path's frame 0 sees features 0..2 — see dfn3_forward)
        skip = min(self._to_skip_feats, n_new)
        if skip:
            pos = LOOKAHEAD - self._to_skip_feats
            eh = self._dfn.erb_conv0_hist.clone()
            sh = self._dfn.df_conv0_hist.clone()
            eh[0, 0, pos: pos + skip, :] = erb_n[:skip]
            sh[0, :, pos: pos + skip, :] = torch.movedim(spec_n[:skip], -1, 0)
            self._dfn = self._dfn._replace(erb_conv0_hist=eh, df_conv0_hist=sh)
            self._to_skip_feats -= skip
        net_erb = erb_n[skip:]
        net_spec = spec_n[skip:]
        n_emit = len(net_erb)
        if n_emit == 0:
            return np.zeros(0, np.float32)

        # emitted frames t..t+n_emit-1 need raw spectra t-2 .. t+n_emit+1,
        # which are exactly the newest (n_emit + DF_ORDER - 1) history rows
        need = n_emit + DF_ORDER - 1
        samples = self._step(net_erb, net_spec, self._spec_hist_re[-need:],
                             self._spec_hist_im[-need:])

        # future frame t+n_emit needs spectra from t+n_emit-2 on → last 4 rows
        keep = DF_ORDER - 1
        self._spec_hist_re = self._spec_hist_re[-keep:]
        self._spec_hist_im = self._spec_hist_im[-keep:]
        return self._trim(samples)
