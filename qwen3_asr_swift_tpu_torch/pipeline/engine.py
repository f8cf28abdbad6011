"""ctypes bindings and ``VoicePipeline`` over the C++ voice-agent engine —
port of ``qwen3_asr_swift_tpu/pipeline/engine.py``.

The engine (``runtime/speech_core.cpp``, the JAX package's source copied)
runs VAD → STT → LLM → TTS turns on a thread of its own and calls back into
Python through ctypes; events come out on a thread-safe queue or a user
callback. The library is built with g++ at first use
(``runtime/native.py::speech_core_library``); a failed build raises.

The model adapters call the port's models (``process_chunk``,
``transcribe``, ``chat``, ``synthesize``) from the engine's thread, which
torch has not seen: each call runs under ``torch.cuda.device`` of the
model's own device, so the kernels it launches (K1, K3) go to that card's
current stream. An exception in a model is logged and the engine turns it
into an ERROR event, as in the reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import enum
import queue
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.logging import pipeline as log
from ..runtime import native
from ..runtime.native import build_engine_library as ensure_library  # noqa: F401


def _on_model_device(model):
    """``torch.cuda.device`` of the model's card, or nothing for a model on
    the CPU (or a plain callable)."""
    dev = getattr(model, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# -- C ABI mirrors -----------------------------------------------------------

class _CEvent(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int),
        ("state", ctypes.c_int),
        ("text", ctypes.c_char_p),
        ("aux", ctypes.c_char_p),
        ("pcm", ctypes.POINTER(ctypes.c_int16)),
        ("pcm_len", ctypes.c_size_t),
    ]


_EVENT_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(_CEvent), ctypes.c_void_p)
_VAD_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, ctypes.c_void_p)
_STT_FN = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, ctypes.c_void_p)
_LLM_FN = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p)
_TTS_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p,
)


class _CCallbacks(ctypes.Structure):
    _fields_ = [
        ("vad_process", _VAD_FN),
        ("stt_transcribe", _STT_FN),
        ("llm_respond", _LLM_FN),
        ("tts_synthesize", _TTS_FN),
        ("user", ctypes.c_void_p),
    ]


class _CConfig(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int),
        ("vad_chunk", ctypes.c_int),
        ("vad_onset", ctypes.c_float),
        ("vad_offset", ctypes.c_float),
        ("min_speech_s", ctypes.c_float),
        ("min_silence_s", ctypes.c_float),
        ("pre_speech_s", ctypes.c_float),
        ("max_utterance_s", ctypes.c_float),
        ("eager_stt", ctypes.c_int),
        ("allow_interruption", ctypes.c_int),
        ("tool_cooldown_s", ctypes.c_float),
        ("speak_chunk", ctypes.c_int),
    ]


class PipelineState(enum.Enum):
    IDLE = 0
    LISTENING = 1
    TRANSCRIBING = 2
    THINKING = 3
    SPEAKING = 4


class PipelineEventType(enum.Enum):
    STATE_CHANGED = 0
    SPEECH_STARTED = 1
    SPEECH_ENDED = 2
    PARTIAL_TRANSCRIPT = 3
    FINAL_TRANSCRIPT = 4
    RESPONSE_TEXT = 5
    AUDIO_CHUNK = 6
    TOOL_CALL = 7
    INTERRUPTED = 8
    ERROR = 9


@dataclasses.dataclass(frozen=True)
class PipelineEvent:
    type: PipelineEventType
    state: PipelineState
    text: Optional[str] = None
    aux: Optional[str] = None
    pcm: Optional[np.ndarray] = None  # int16


@dataclasses.dataclass
class PipelineConfig:
    """Mirrors sc_config_t (defaults match sc_config_default)."""

    sample_rate: int = 16000
    vad_chunk: int = 512
    vad_onset: float = 0.5
    vad_offset: float = 0.35
    min_speech_s: float = 0.25
    min_silence_s: float = 0.6
    pre_speech_s: float = 0.5
    max_utterance_s: float = 30.0
    eager_stt: bool = True
    allow_interruption: bool = True
    tool_cooldown_s: float = 5.0
    speak_chunk: int = 4096


TOOL_MARKER = "\x01TOOL\x01"


def tool_call(name: str, args: str = "") -> str:
    """Format an LLM response as a tool call for the engine."""
    return f"{TOOL_MARKER}{name}\x01{args}"


class VoicePipeline:
    """High-level voice agent: VAD + STT + LLM + TTS behind the C++ engine.

    Modes (reference: VoicePipeline.swift:9-71): full voice pipeline (all
    models), transcribe-only (no llm/tts), echo (no llm)."""

    def __init__(
        self,
        stt=None,            # SpeechRecognitionModel or callable audio->str
        tts=None,            # SpeechGenerationModel or callable text->np.int16
        vad=None,            # StreamingVADProvider or callable chunk->float
        llm=None,            # PipelineLLM or callable text->str
        config: Optional[PipelineConfig] = None,
        on_event: Optional[Callable[[PipelineEvent], None]] = None,
    ):
        config = config or PipelineConfig()
        self._lib = native.speech_core_library()
        self._lib.sc_pipeline_create.restype = ctypes.c_void_p
        self._lib.sc_pipeline_create.argtypes = [
            ctypes.POINTER(_CConfig), ctypes.POINTER(_CCallbacks), _EVENT_FN, ctypes.c_void_p,
        ]
        for fn in ("sc_pipeline_start", "sc_pipeline_stop", "sc_pipeline_is_running",
                   "sc_pipeline_state", "sc_pipeline_resume_listening", "sc_pipeline_clear_tools"):
            getattr(self._lib, fn).argtypes = [ctypes.c_void_p]
        self._lib.sc_pipeline_push_audio.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        self._lib.sc_pipeline_push_text.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        self._lib.sc_pipeline_add_tool.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        self._lib.sc_pipeline_destroy.argtypes = [ctypes.c_void_p]

        self.events: "queue.Queue[PipelineEvent]" = queue.Queue()
        self._on_event = on_event
        self._vad_state = vad.new_stream() if hasattr(vad, "new_stream") else None
        self._vad = vad
        self._stt = stt
        self._tts = tts
        self._llm = llm
        self._libc = ctypes.CDLL(None)
        self._libc.malloc.restype = ctypes.c_void_p
        self._libc.malloc.argtypes = [ctypes.c_size_t]

        # keep callback objects alive for the pipeline's lifetime; absent
        # models pass NULL so the engine takes its optional-model paths
        # (a non-null tts callback in transcribe-only mode would emit a
        # spurious "tts failed" ERROR every turn). The llm callback stays
        # non-null even when llm is None: the ENGINE's echo mode is
        # "no llm_respond" but OUR echo adapter handles tools, so only
        # drop it when there is neither an llm nor a tts (pure
        # transcribe-only).
        self._c_event = _EVENT_FN(self._handle_event)
        self._c_vad = _VAD_FN(self._vad_cb)
        self._c_stt = _STT_FN(self._stt_cb)
        self._c_llm = _LLM_FN(self._llm_cb)
        self._c_tts = _TTS_FN(self._tts_cb)
        callbacks = _CCallbacks(
            # vad stays non-null even without a model: our adapter's
            # "no VAD = everything is speech" (1.0) vs the engine's null
            # path "never speech" (0.0) — the former keeps the pipeline
            # usable without a VAD
            vad_process=self._c_vad,
            stt_transcribe=self._c_stt if stt is not None else _STT_FN(0),
            llm_respond=self._c_llm,
            tts_synthesize=self._c_tts if tts is not None else _TTS_FN(0),
            user=None,
        )
        cfg = _CConfig(
            sample_rate=config.sample_rate, vad_chunk=config.vad_chunk,
            vad_onset=config.vad_onset, vad_offset=config.vad_offset,
            min_speech_s=config.min_speech_s, min_silence_s=config.min_silence_s,
            pre_speech_s=config.pre_speech_s, max_utterance_s=config.max_utterance_s,
            eager_stt=int(config.eager_stt), allow_interruption=int(config.allow_interruption),
            tool_cooldown_s=config.tool_cooldown_s, speak_chunk=config.speak_chunk,
        )
        self._cfg = config
        self._handle = self._lib.sc_pipeline_create(
            ctypes.byref(cfg), ctypes.byref(callbacks), self._c_event, None
        )
        if not self._handle:
            raise RuntimeError("sc_pipeline_create failed")

    # -- model adapters (C → Python) ----------------------------------------

    def _malloc_str(self, text: str) -> Optional[int]:
        data = text.encode("utf-8") + b"\x00"
        ptr = self._libc.malloc(len(data))
        if not ptr:
            return None
        ctypes.memmove(ptr, data, len(data))
        return ptr

    def _vad_cb(self, samples, n, _user):
        try:
            if self._vad is None:
                return 1.0  # no VAD: treat everything as speech
            chunk = np.ctypeslib.as_array(samples, shape=(n,)).copy()
            if hasattr(self._vad, "process_chunk"):
                with _on_model_device(self._vad):
                    self._vad_state, prob = self._vad.process_chunk(self._vad_state, chunk)
                return float(prob)
            return float(self._vad(chunk))
        except Exception:  # noqa: BLE001
            log.exception("vad callback failed")
            return 0.0

    def _stt_cb(self, samples, n, _user):
        try:
            if self._stt is None:
                return None
            audio = np.ctypeslib.as_array(samples, shape=(n,)).copy()
            if hasattr(self._stt, "transcribe"):
                with _on_model_device(self._stt):
                    text = self._stt.transcribe(audio, sample_rate=self._cfg.sample_rate).text
            else:
                text = self._stt(audio)
            return self._malloc_str(text or "")
        except Exception:  # noqa: BLE001
            log.exception("stt callback failed")
            return None

    def _llm_cb(self, text, _user):
        try:
            prompt = text.decode("utf-8") if text else ""
            if self._llm is None:
                return self._malloc_str(prompt)  # echo mode
            if hasattr(self._llm, "chat"):
                with _on_model_device(self._llm):
                    response = "".join(self._llm.chat([{"role": "user", "content": prompt}]))
            else:
                response = self._llm(prompt)
            return self._malloc_str(response or "")
        except Exception:  # noqa: BLE001
            log.exception("llm callback failed")
            return None

    def _tts_cb(self, text, out_pcm, out_len, _user):
        try:
            if self._tts is None:
                return 1
            prompt = text.decode("utf-8") if text else ""
            if hasattr(self._tts, "synthesize"):
                with _on_model_device(self._tts):
                    chunk = self._tts.synthesize(prompt)
                pcm = np.clip(chunk.samples, -1, 1)
                pcm = (pcm * 32767.0).astype(np.int16)
            else:
                pcm = np.asarray(self._tts(prompt), dtype=np.int16)
            nbytes = pcm.nbytes
            ptr = self._libc.malloc(nbytes)
            if not ptr:
                return 2
            ctypes.memmove(ptr, pcm.tobytes(), nbytes)
            out_pcm[0] = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int16))
            out_len[0] = len(pcm)
            return 0
        except Exception:  # noqa: BLE001
            log.exception("tts callback failed")
            return 3

    def _handle_event(self, ev_ptr, _user):
        try:
            ev = ev_ptr.contents
            pcm = None
            if ev.pcm and ev.pcm_len:
                pcm = np.ctypeslib.as_array(ev.pcm, shape=(ev.pcm_len,)).copy()
            event = PipelineEvent(
                type=PipelineEventType(ev.type),
                state=PipelineState(ev.state),
                text=ev.text.decode("utf-8", "replace") if ev.text else None,
                aux=ev.aux.decode("utf-8", "replace") if ev.aux else None,
                pcm=pcm,
            )
            if self._on_event:
                # callback consumers own delivery — queuing every event
                # too (incl. AUDIO_CHUNK PCM copies) would grow the queue
                # without bound in sessions that never drain_events()
                self._on_event(event)
            else:
                self.events.put(event)
        except Exception:  # noqa: BLE001
            log.exception("event handler failed")

    # -- public API ----------------------------------------------------------

    def start(self) -> None:
        if self._lib.sc_pipeline_start(self._handle) != 0:
            raise RuntimeError("pipeline already running")

    def stop(self) -> None:
        self._lib.sc_pipeline_stop(self._handle)

    def push_audio(self, samples: np.ndarray) -> None:
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        self._lib.sc_pipeline_push_audio(
            self._handle, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(samples)
        )

    def push_text(self, text: str) -> None:
        self._lib.sc_pipeline_push_text(self._handle, text.encode("utf-8"))

    def resume_listening(self) -> None:
        self._lib.sc_pipeline_resume_listening(self._handle)

    def add_tool(self, name: str, description: str = "") -> None:
        self._lib.sc_pipeline_add_tool(self._handle, name.encode(), description.encode())

    def clear_tools(self) -> None:
        self._lib.sc_pipeline_clear_tools(self._handle)

    @property
    def state(self) -> PipelineState:
        return PipelineState(self._lib.sc_pipeline_state(self._handle))

    @property
    def is_running(self) -> bool:
        return bool(self._lib.sc_pipeline_is_running(self._handle))

    def drain_events(self, timeout: float = 0.0) -> List[PipelineEvent]:
        out = []
        try:
            while True:
                out.append(self.events.get(timeout=timeout if not out else 0))
        except queue.Empty:
            pass
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.sc_pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        self.close()
