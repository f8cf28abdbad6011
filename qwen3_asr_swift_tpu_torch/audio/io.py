"""The port's copy of ``qwen3_asr_swift_tpu/audio/io.py``.

WAV read/write with defensive parsing.

TPU-native analog of the reference's audio file layer
(reference: Sources/AudioCommon/AudioFileLoader.swift load/loadWAV,
Sources/AudioCommon/WAVWriter.swift). Pure-stdlib RIFF parser — no
AVFoundation / soundfile dependency — hardened against malformed chunk
sizes the way the reference's WAV security tests demand
(reference: Tests/Qwen3ASRTests/SecurityHardeningTests.swift).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..core.types import to_float32

_MAX_WAV_BYTES = 2 * 1024 * 1024 * 1024  # 2 GiB sanity cap


class WAVError(ValueError):
    pass


def read_wav(source: Union[str, Path, bytes]) -> Tuple[np.ndarray, int]:
    """Parse a WAV file into (float32 mono samples in [-1, 1], sample_rate).

    Multi-channel audio is downmixed by averaging. Supports PCM 8/16/32-bit
    and IEEE float32/64."""
    if isinstance(source, (str, Path)):
        data = Path(source).read_bytes()
    else:
        data = source
    if len(data) < 44:
        raise WAVError("file too small to be a WAV")
    if data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WAVError("not a RIFF/WAVE file")

    fmt = None
    pcm = None
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        if chunk_size > _MAX_WAV_BYTES:
            raise WAVError(f"chunk size {chunk_size} exceeds sanity cap")
        body_start = pos + 8
        body_end = min(body_start + chunk_size, n)  # clamp truncated chunks
        if chunk_id == b"fmt ":
            if chunk_size < 16:
                raise WAVError("fmt chunk too small")
            try:
                audio_format, channels, sample_rate, _, _, bits = struct.unpack_from(
                    "<HHIIHH", data, body_start
                )
                if audio_format == 0xFFFE and chunk_size >= 40:
                    # WAVE_FORMAT_EXTENSIBLE: real format in the GUID's first 2 bytes
                    (audio_format,) = struct.unpack_from("<H", data, body_start + 24)
            except struct.error as e:  # truncated fmt body
                raise WAVError(f"truncated fmt chunk: {e}") from e
            if channels == 0 or channels > 64:
                raise WAVError(f"bad channel count {channels}")
            if sample_rate == 0 or sample_rate > 1_000_000:
                raise WAVError(f"bad sample rate {sample_rate}")
            fmt = (audio_format, channels, sample_rate, bits)
        elif chunk_id == b"data":
            pcm = data[body_start:body_end]
        pos = body_start + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None:
        raise WAVError("missing fmt chunk")
    if pcm is None:
        raise WAVError("missing data chunk")
    audio_format, channels, sample_rate, bits = fmt

    if audio_format == 1:  # PCM
        dtype = {8: np.uint8, 16: np.int16, 32: np.int32}.get(bits)
        if dtype is None:
            raise WAVError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = {32: np.float32, 64: np.float64}.get(bits)
        if dtype is None:
            raise WAVError(f"unsupported float bit depth {bits}")
    else:
        raise WAVError(f"unsupported audio format {audio_format}")

    itemsize = np.dtype(dtype).itemsize
    frame = itemsize * channels
    usable = (len(pcm) // frame) * frame
    samples = np.frombuffer(pcm[:usable], dtype=dtype)
    # scale to [-1, 1] BEFORE downmixing: averaging integer channels first
    # yields float64 in PCM range, which to_float32 would pass through
    # unscaled (±32768-range audio downstream)
    samples = to_float32(np.ascontiguousarray(samples))
    if samples.dtype != np.float32:
        samples = samples.astype(np.float32)
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1).astype(np.float32)
    return samples, sample_rate


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] (or int16) samples as 16-bit PCM WAV."""
    Path(path).write_bytes(wav_bytes(samples, sample_rate))


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """In-memory 16-bit PCM WAV encoding (one header builder for both the
    serving layer and write_wav)."""
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    pcm = samples.tobytes()
    header = (
        b"RIFF"
        + struct.pack("<I", 36 + len(pcm))
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
        + b"data"
        + struct.pack("<I", len(pcm))
    )
    return header + pcm


def load_audio(path: Union[str, Path], target_rate: int | None = None) -> Tuple[np.ndarray, int]:
    """Load an audio file (WAV) and optionally resample."""
    samples, rate = read_wav(path)
    if target_rate is not None and rate != target_rate:
        from .resample import resample

        samples = resample(samples, rate, target_rate)
        rate = target_rate
    return samples, rate
