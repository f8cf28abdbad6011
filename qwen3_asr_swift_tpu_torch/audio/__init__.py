"""Host audio I/O (WAV, resampling, ring buffers, playback) and the wire
formats' encoders and on-device decoders."""

from .io import WAVError, load_audio, read_wav, wav_bytes, write_wav
from .player import StreamingAudioPlayer
from .resample import resample
from .ringbuffer import AudioRingBuffer

__all__ = ["AudioRingBuffer", "StreamingAudioPlayer", "WAVError", "load_audio", "read_wav",
           "resample", "wav_bytes", "write_wav"]
