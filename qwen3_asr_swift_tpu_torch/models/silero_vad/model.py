"""Silero VAD v5 (~309K params) — port of
``qwen3_asr_swift_tpu/models/silero_vad/model.py``.

512-sample chunks + 64 carried context samples → right reflect-pad 64 →
256-point DFT (frames × basis, fp32) → magnitude → 4× Conv1d+ReLU encoder
→ 1-layer LSTM(128) as explicit ``i, f, g, o`` gates with carried h/c →
ReLU → 1×1 conv → sigmoid probability.

The reference runs a whole clip as one ``lax.scan`` over chunks. Here the
part that does not depend on the LSTM state (STFT, magnitude, encoder
convs, the input half of the gates) runs for every chunk of the clip in one
batch, and only the recurrence is a loop of device ops: ``h`` and ``c``
stay on the device and the probabilities are read once, at the end, with
no sync per chunk. The convs are the port's ``ops/nn.py::conv1d`` (tap
matmuls; the STFT one product over its windows), which run in full fp32
on the card as on the host.

``init_params`` draws with numpy from a seed; ``convert_checkpoint`` and
``convert_torchscript`` are copies of the reference's converters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.protocols import StreamingVADProvider, VoiceActivityDetectionModel
from ...core.types import SpeechSegment
from ...device import resolve_device
from ...ops.nn import conv1d

SAMPLE_RATE = 16000
CHUNK = 512
CONTEXT = 64
STFT_LEN = 256
STFT_HOP = 128
N_BINS = 129
HIDDEN = 128


@dataclasses.dataclass(frozen=True)
class VADConfig:
    """Hysteresis thresholds (reference: SpeechVAD/Configuration.swift:84-91
    sileroDefault)."""

    onset: float = 0.5
    offset: float = 0.35
    min_speech_duration: float = 0.25
    min_silence_duration: float = 0.1

    @property
    def chunk_duration(self) -> float:
        return CHUNK / SAMPLE_RATE  # 32 ms


def dft_basis() -> np.ndarray:
    """[258, 256] windowed DFT basis (cos rows then -sin rows) used when no
    checkpoint provides ``stft.weight``. Magnitude is sign-invariant."""
    n = np.arange(STFT_LEN)
    k = np.arange(N_BINS)
    phase = 2.0 * np.pi * np.outer(k, n) / STFT_LEN
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / STFT_LEN))
    return np.concatenate([np.cos(phase) * window, -np.sin(phase) * window]).astype(np.float32)


def init_params(seed: int = 0) -> dict:
    """Random params with the exact Silero v5 topology, drawn with numpy
    from ``seed`` (the reference's layout: conv kernels [width, in, out])."""
    rng = np.random.default_rng(seed)

    def conv(width, cin, cout):
        scale = 1.0 / np.sqrt(width * cin)
        return {"kernel": (rng.standard_normal((width, cin, cout)) * scale).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    return {
        "stft_basis": dft_basis(),  # [258, 256]
        "encoder": [conv(3, N_BINS, 128), conv(3, 128, 64), conv(3, 64, 64), conv(3, 64, 128)],
        "lstm": {
            "wx": (rng.standard_normal((128, 512)) * 0.06).astype(np.float32),
            "wh": (rng.standard_normal((128, 512)) * 0.06).astype(np.float32),
            "bias": np.zeros((512,), np.float32),
        },
        "decoder": conv(1, 128, 1),
    }


def convert_checkpoint(flat: dict) -> dict:
    """Map the published MLX-converted checkpoint (keys: stft.weight
    [258,256,1], encoder.{0-3}.weight/bias, lstm.Wx/Wh/bias,
    decoder.weight/bias — reference SileroModel.swift:27-35) into our tree."""
    def conv_from(prefix, strides=None):
        w = flat[f"{prefix}.weight"]  # MLX conv1d layout [out, width, in]
        return {
            "kernel": np.transpose(w, (1, 2, 0)).astype(np.float32),  # [width, in, out]
            "bias": flat[f"{prefix}.bias"].astype(np.float32),
        }

    stft = flat["stft.weight"]
    if stft.ndim == 3:
        stft = stft[:, :, 0] if stft.shape[1] == STFT_LEN else stft[:, 0, :]
    return {
        "stft_basis": stft.astype(np.float32),  # [258, 256]
        "encoder": [conv_from(f"encoder.{i}") for i in range(4)],
        "lstm": {
            "wx": np.ascontiguousarray(flat["lstm.Wx"].T).astype(np.float32)
            if flat["lstm.Wx"].shape[0] == 512 else flat["lstm.Wx"].astype(np.float32),
            "wh": np.ascontiguousarray(flat["lstm.Wh"].T).astype(np.float32)
            if flat["lstm.Wh"].shape[0] == 512 else flat["lstm.Wh"].astype(np.float32),
            "bias": flat["lstm.bias"].astype(np.float32),
        },
        "decoder": conv_from("decoder"),
    }


def convert_torchscript(path) -> dict:
    """Load the ORIGINAL Silero v5 TorchScript archive (silero_vad.jit —
    the upstream distribution format, reference: SileroVAD.swift loads the
    MLX re-export of the same tensors) and map its state dict into our
    tree. Key layout (v5, 16 kHz branch):

    - ``_model.stft.forward_basis_buffer`` [258, 1, 256] — windowed DFT
      basis (cos ‖ -sin rows)
    - ``_model.encoder.{0-3}.reparam_conv.weight`` [out, in, 3] + bias
    - ``_model.decoder.rnn.weight_ih/weight_hh`` [512, 128] +
      ``bias_ih/bias_hh`` [512] (torch gate order i,f,g,o — ours matches;
      the two biases sum)
    - ``_model.decoder.decoder.2.weight`` [1, 128, 1] + bias

    torch.jit.load parses the archive, so a cached checkpoint converts
    fully offline."""
    import torch

    sd = {k: v.detach().cpu().numpy()
          for k, v in torch.jit.load(str(path), map_location="cpu").state_dict().items()}

    def conv_from(prefix):
        w = sd[f"{prefix}.weight"]              # torch conv1d [out, in, width]
        return {
            "kernel": np.transpose(w, (2, 1, 0)).astype(np.float32),
            "bias": sd[f"{prefix}.bias"].astype(np.float32),
        }

    stft = sd["_model.stft.forward_basis_buffer"]
    if stft.ndim == 3:
        stft = stft[:, 0, :]
    dec = sd["_model.decoder.decoder.2.weight"]  # [1, 128, 1]
    return {
        "stft_basis": stft.astype(np.float32),   # [258, 256]
        "encoder": [conv_from(f"_model.encoder.{i}.reparam_conv")
                    for i in range(4)],
        "lstm": {
            "wx": np.ascontiguousarray(sd["_model.decoder.rnn.weight_ih"].T).astype(np.float32),
            "wh": np.ascontiguousarray(sd["_model.decoder.rnn.weight_hh"].T).astype(np.float32),
            "bias": (sd["_model.decoder.rnn.bias_ih"]
                     + sd["_model.decoder.rnn.bias_hh"]).astype(np.float32),
        },
        "decoder": {
            "kernel": np.transpose(dec, (2, 1, 0)).astype(np.float32),  # [1, 128, 1]
            "bias": sd["_model.decoder.decoder.2.bias"].astype(np.float32),
        },
    }


def encode_frames(params, samples: torch.Tensor) -> torch.Tensor:
    """The stateless front half of a VAD step. samples [B, 576] (64 context
    + 512 new) → the encoder's output [B, 128], the LSTM's input."""
    # right reflect-pad 64: [a..z] → [a..z, y, x, ...]
    pad_idx = torch.arange(samples.shape[-1] - 2, samples.shape[-1] - 2 - CONTEXT, -1,
                           device=samples.device)
    x = torch.cat([samples, samples[:, pad_idx]], dim=-1)          # [B, 640]
    frames = x.unfold(-1, STFT_LEN, STFT_HOP)                       # [B, 4, 256]
    spec = torch.matmul(frames, params["stft_basis"].T)             # [B, 4, 258] fp32
    real, imag = spec[..., :N_BINS], spec[..., N_BINS:]
    y = torch.sqrt(real * real + imag * imag + 1e-12)               # [B, 4, 129]
    for conv_p, s in zip(params["encoder"], (1, 2, 2, 1)):
        y = torch.relu(conv1d(y, conv_p, stride=s, padding=1))
    return y[:, 0, :]                                               # one timestep


def lstm_step(params, xw: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM step from the input half of the gates ``xw = x·Wx + b``:
    explicit ``i, f, g, o`` gates. Returns (h', c')."""
    gates = xw + h @ params["lstm"]["wh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def decode_prob(params, h: torch.Tensor) -> torch.Tensor:
    """ReLU → 1×1 conv → sigmoid: h [B, 128] → probabilities [B]."""
    d = params["decoder"]
    return torch.sigmoid(torch.relu(h) @ d["kernel"][0] + d["bias"])[:, 0]


def forward_chunk(params, samples: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One VAD step. samples [B, 576] (64 context + 512 new); h, c
    [B, 128]. Returns (prob [B], h', c')."""
    xt = encode_frames(params, samples)
    xw = xt @ params["lstm"]["wx"] + params["lstm"]["bias"]
    h_new, c_new = lstm_step(params, xw, h, c)
    return decode_prob(params, h_new), h_new, c_new


def scan_probs(params, chunks: torch.Tensor) -> torch.Tensor:
    """Every chunk's probability. chunks [N, 512] → probs [N], on the
    chunks' device: the front half for all N chunks at once, then the
    recurrence as a loop of device ops (no host sync)."""
    n = chunks.shape[0]
    ctx = torch.cat([chunks.new_zeros((1, CONTEXT)), chunks[:-1, -CONTEXT:]], dim=0)
    xt = encode_frames(params, torch.cat([ctx, chunks], dim=1))                 # [N, 128]
    xw = xt @ params["lstm"]["wx"] + params["lstm"]["bias"]                     # [N, 512]
    h = chunks.new_zeros((1, HIDDEN))
    c = chunks.new_zeros((1, HIDDEN))
    hs = chunks.new_empty((n, HIDDEN))
    for i in range(n):
        h, c = lstm_step(params, xw[i:i + 1], h, c)
        hs[i] = h[0]
    return decode_prob(params, hs)


def binarize(probs: np.ndarray, cfg: VADConfig) -> List[SpeechSegment]:
    """Hysteresis thresholding + duration filtering
    (reference: VADPipeline.binarize/filterDurations)."""
    dt = cfg.chunk_duration
    segments: List[SpeechSegment] = []
    in_speech = False
    start = 0.0
    for i, p in enumerate(probs):
        t = i * dt
        if not in_speech and p >= cfg.onset:
            in_speech = True
            start = t
        elif in_speech and p < cfg.offset:
            in_speech = False
            segments.append(SpeechSegment(start, t))
    if in_speech:
        segments.append(SpeechSegment(start, len(probs) * dt))

    # merge close segments, then drop short ones
    merged: List[SpeechSegment] = []
    for seg in segments:
        if merged and seg.start - merged[-1].end < cfg.min_silence_duration:
            merged[-1] = SpeechSegment(merged[-1].start, seg.end)
        else:
            merged.append(seg)
    return [s for s in merged if s.duration >= cfg.min_speech_duration]


class SileroVAD(VoiceActivityDetectionModel, StreamingVADProvider):
    """Host-facing Silero VAD on one device (the card unless the caller
    asks for the CPU). ``params`` is a tree in the reference's layout
    (numpy arrays or tensors)."""

    def __init__(self, params, *, device="cuda"):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self._loaded = True

    @classmethod
    def init_random(cls, seed: int = 0, *, device="cuda") -> "SileroVAD":
        return cls(init_params(seed), device=device)

    @classmethod
    def from_pretrained(cls, model_id: str = "silero-vad-v5", cache_dir=None,
                        offline_mode: bool = False, progress_handler=None, *, device="cuda",
                        **kw) -> "SileroVAD":
        """A local directory with the MLX-converted safetensors, or the
        upstream TorchScript archive itself (a ``*.jit`` file, or a
        directory holding one and no safetensors). Hub download is not
        ported."""
        from pathlib import Path

        from ...core.hub import download_weights
        from ...core.weights import load_safetensors

        if str(model_id).endswith(".jit") and Path(model_id).exists():
            return cls(convert_torchscript(model_id), device=device)
        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        jits = sorted(Path(model_dir).glob("*.jit"))
        if jits and not any(Path(model_dir).glob("*.safetensors")):
            return cls(convert_torchscript(jits[0]), device=device)
        return cls(convert_checkpoint(load_safetensors(model_dir)), device=device)

    # -- batch ---------------------------------------------------------------

    @torch.inference_mode()
    def speech_probabilities(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        if sample_rate != SAMPLE_RATE:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, SAMPLE_RATE)
        n = len(audio)
        n_chunks = max(1, (n + CHUNK - 1) // CHUNK)
        padded = np.zeros(n_chunks * CHUNK, np.float32)
        padded[:n] = audio
        chunks = torch.from_numpy(padded.reshape(n_chunks, CHUNK)).to(self.device)
        return scan_probs(self.params, chunks).cpu().numpy()

    def detect_speech(self, audio: np.ndarray, sample_rate: int = 16000,
                      config: Optional[VADConfig] = None, **kwargs) -> Sequence[SpeechSegment]:
        probs = self.speech_probabilities(audio, sample_rate)
        return binarize(probs, config or VADConfig())

    # -- streaming -----------------------------------------------------------

    @property
    def chunk_size(self) -> int:
        return CHUNK

    def new_stream(self):
        return (np.zeros(CONTEXT, np.float32),
                torch.zeros((1, HIDDEN), dtype=torch.float32, device=self.device),
                torch.zeros((1, HIDDEN), dtype=torch.float32, device=self.device))

    @torch.inference_mode()
    def process_chunk(self, state, samples: np.ndarray) -> Tuple[object, float]:
        ctx, h, c = state
        if len(samples) < CHUNK:
            samples = np.pad(samples, (0, CHUNK - len(samples)))
        full = np.concatenate([ctx, samples[:CHUNK]]).astype(np.float32)
        prob, h, c = forward_chunk(self.params, torch.from_numpy(full)[None].to(self.device), h, c)
        return (samples[CHUNK - CONTEXT : CHUNK], h, c), float(prob[0])

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


def _to_device(tree, device):
    """A params tree of numpy arrays or tensors → fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device, torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(tree, np.float32)).to(device)
