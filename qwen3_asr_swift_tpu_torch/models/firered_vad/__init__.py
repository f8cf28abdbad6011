"""FireRedVAD: lightweight DFSMN VAD over Kaldi fbank, 100+ languages."""

from .model import CONFIG_FIRERED, FireRedVAD, FireRedVADConfig, config_tiny  # noqa: F401
