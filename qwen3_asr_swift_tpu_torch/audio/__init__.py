"""Host audio I/O (WAV, resampling on the host and on the device, ring
buffers, playback) and the wire formats' encoders and on-device decoders."""

from .io import WAVError, load_audio, read_wav, wav_bytes, write_wav
from .player import StreamingAudioPlayer
from .resample import resample, resample_torch
from .ringbuffer import AudioRingBuffer

__all__ = ["AudioRingBuffer", "StreamingAudioPlayer", "WAVError", "load_audio", "read_wav",
           "resample", "resample_torch", "wav_bytes", "write_wav"]
