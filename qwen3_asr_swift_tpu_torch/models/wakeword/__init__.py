"""Keyword spotting: streaming Zipformer transducer + Aho-Corasick context graph."""

from .context_graph import ContextGraph, ContextState, Keyword  # noqa: F401
from .kws_decoder import KeywordDetection, StreamingKwsDecoder  # noqa: F401
from .model import WakeWordDetector, WakeWordSession  # noqa: F401
from .zipformer import ZipformerConfig, init_zipformer_params, param_count  # noqa: F401
