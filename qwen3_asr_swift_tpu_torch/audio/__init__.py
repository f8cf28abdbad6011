"""Host audio I/O (WAV, resampling) and the wire formats' encoders and
on-device decoders."""

from .io import WAVError, load_audio, read_wav, wav_bytes, write_wav
from .resample import resample

__all__ = ["WAVError", "load_audio", "read_wav", "resample", "wav_bytes", "write_wav"]
