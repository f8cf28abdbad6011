"""Speech serving over HTTP, stdlib asyncio — the port's copy of the ASR
and TTS routes of ``qwen3_asr_swift_tpu/serving/server.py``.

``GET /health``, ``POST /transcribe`` and ``POST /speak`` with the
reference's HTTP/1.1 plumbing (keep-alive, chunked bodies, body and header
limits, read timeouts). ASR requests flow through the
:class:`ContinuousBatcher` (``scheduler="group"``) or the port's
:class:`SlotPoolASR` (``scheduler="slotpool"``); TTS requests through the
:class:`TTSBatcher` or the port's :class:`SlotPoolTTS`, by the same switch.
A JSON ``/transcribe`` body may carry ``max_tokens``, the request's decode
budget (the reference's route has none; its ``/respond`` takes
``max_steps`` so). The reference's ``/respond``, ``/enhance`` and
``/v1/realtime`` wait for a model family of the port that serves them;
until then they answer 404 like any unknown route.
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..audio.io import read_wav, wav_bytes
from ..core.logging import serving as log
from ..core.types import to_float32
from .batching import ContinuousBatcher, TTSBatcher
from .slotpool import SlotPoolASR


class _BodyTooLarge(Exception):
    """Chunked body exceeded max_body mid-stream."""


class _BadRequest(Exception):
    """Client-side error in the request body (-> 400, not 500)."""


class ModelRegistry:
    """Lazy, single-instance model store (reference: ModelState)."""

    def __init__(self):
        self._loaders: Dict[str, Callable[[], object]] = {}
        self._instances: Dict[str, object] = {}
        self._locks: Dict[str, asyncio.Lock] = {}

    def register(self, name: str, loader: Callable[[], object]) -> None:
        self._loaders[name] = loader

    def register_instance(self, name: str, instance: object) -> None:
        self._instances[name] = instance

    async def get(self, name: str):
        # fast path: an already-loaded instance never waits on a lock —
        # one model's multi-minute lazy load must not stall unrelated
        # endpoints; the lock is per name, only for the loading race
        inst = self._instances.get(name)
        if inst is not None:
            return inst
        if name not in self._loaders:
            return None
        lock = self._locks.setdefault(name, asyncio.Lock())
        async with lock:
            if name not in self._instances:
                log.info("lazily loading model %r", name)
                loop = asyncio.get_running_loop()
                self._instances[name] = await loop.run_in_executor(None, self._loaders[name])
            return self._instances[name]

    def loaded(self) -> list:
        return sorted(self._instances)


class SpeechServer:
    """REST speech server: ``/health``, ``/transcribe`` and ``/speak``."""

    MAX_HEADERS = 100

    def __init__(self, registry: ModelRegistry, host: str = "127.0.0.1", port: int = 8321,
                 max_batch: int = 16, max_body: int = 256 * 1024 * 1024,
                 keep_alive_timeout_s: float = 75.0,
                 request_read_timeout_s: float = 120.0,
                 scheduler: str = "group",
                 slotpool_max_s: float = 64.0,
                 bulk_nice: Optional[int] = None):
        # scheduler: "group" = ContinuousBatcher (FIFO same-bucket groups,
        # one batched transcribe_batch per group); "slotpool" = token-level
        # continuous batching (serving/slotpool.py — mixed-length requests
        # decode in one shared tick program, admission at tick boundaries).
        if scheduler not in ("group", "slotpool"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.registry = registry
        self.host = host
        self.port = port
        self.max_body = max_body
        self.keep_alive_timeout_s = keep_alive_timeout_s
        # deadline for reading one request's headers + body once the
        # request line has arrived — a slow-loris client trickling header
        # or body bytes cannot hold a handler task open indefinitely
        self.request_read_timeout_s = request_read_timeout_s
        self.scheduler = scheduler
        # slotpool arena budget in seconds of audio: clips needing a longer
        # prompt divert to the pool's serial fallback path instead of
        # erroring (ADVICE r4: the old default silently capped at ~16 s).
        # HBM cost scales with it: arena rows = tokens(max_s) + 96 + 448.
        self.slotpool_max_s = slotpool_max_s
        # bulk_nice: OS nice for batch-worker threads (dispatch.BULK_NICE
        # recommended). On a core-starved host this keeps latency-sensitive
        # handler work (WS realtime frames, request parsing, first-chunk
        # probes) ahead of bulk batch staging in the run queue — the same
        # lever bench.py uses for the loaded first-token number.
        self.bulk_nice = bulk_nice
        self._batchers: Dict[int, object] = {}
        self._tts_batchers: Dict[int, object] = {}
        self._max_batch = max_batch
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = time.time()

    def _batcher_for(self, model):
        key = id(model)
        if key not in self._batchers:
            if self.scheduler == "slotpool":
                self._batchers[key] = SlotPoolASR(
                    model, slots=self._max_batch,
                    max_len=SlotPoolASR.max_len_for(model, self.slotpool_max_s),
                    oversize="fallback")
            else:
                self._batchers[key] = ContinuousBatcher(
                    model, max_batch=self._max_batch, bulk_nice=self.bulk_nice)
        return self._batchers[key]

    def _tts_batcher_for(self, model):
        key = id(model)
        if key not in self._tts_batchers:
            if self.scheduler == "slotpool":
                # frame-level continuous batching: syntheses join the running
                # talker batch at frame boundaries; oversize and clone prompts
                # divert to the serial fallback
                from .ttspool import SlotPoolTTS

                self._tts_batchers[key] = SlotPoolTTS(
                    model, slots=min(self._max_batch, 8), oversize="fallback")
            else:
                self._tts_batchers[key] = TTSBatcher(model, max_batch=self._max_batch)
        return self._tts_batchers[key]

    # ------------------------------------------------------------------ #
    # HTTP plumbing
    # ------------------------------------------------------------------ #

    async def start(self):
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        log.info("speech server on http://%s:%d", self.host, self.port)
        return self._server

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for b in self._batchers.values():
            b.shutdown()
        for b in self._tts_batchers.values():
            b.shutdown()

    async def _read_chunked_body(self, reader) -> bytes:
        """RFC 7230 chunked transfer decoding, capped at max_body."""
        chunks = []
        total = 0
        while True:
            size_line = await reader.readline()
            if not size_line:
                raise asyncio.IncompleteReadError(b"", None)
            size = int(size_line.split(b";")[0].strip(), 16)  # ignore extensions
            if size == 0:
                # drain trailers until blank line
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                return b"".join(chunks)
            total += size
            if total > self.max_body:
                raise _BodyTooLarge()
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # trailing CRLF

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                # idle keep-alive timeout: drop slow/stale connections
                try:
                    request_line = await asyncio.wait_for(
                        reader.readline(), timeout=self.keep_alive_timeout_s)
                except asyncio.TimeoutError:
                    break
                if not request_line:
                    break
                try:
                    method, path, _version = request_line.decode("latin-1").split()
                except ValueError:
                    await self._respond(writer, 400, {"error": "bad request line"})
                    break
                async def _read_headers():
                    headers = {}
                    header_error = None
                    while True:
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                        if len(headers) >= self.MAX_HEADERS:
                            header_error = (431, "too many headers")
                            continue  # keep draining to the blank line
                        k, _, v = line.decode("latin-1").partition(":")
                        headers[k.strip().lower()] = v.strip()
                    return headers, header_error

                try:
                    headers, header_error = await asyncio.wait_for(
                        _read_headers(), timeout=self.request_read_timeout_s)
                except asyncio.TimeoutError:
                    break
                if header_error:
                    await self._respond(writer, header_error[0], {"error": header_error[1]})
                    break

                if headers.get("expect", "").lower() == "100-continue":
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    await writer.drain()

                try:
                    if "chunked" in headers.get("transfer-encoding", "").lower():
                        body = await asyncio.wait_for(
                            self._read_chunked_body(reader),
                            timeout=self.request_read_timeout_s)
                    else:
                        try:
                            length = int(headers.get("content-length", "0"))
                        except ValueError:
                            await self._respond(writer, 400,
                                                {"error": "bad content-length"})
                            break
                        if length < 0:
                            await self._respond(writer, 400,
                                                {"error": "bad content-length"})
                            break
                        if length > self.max_body:
                            await self._respond(writer, 413, {"error": "body too large"})
                            break
                        body = (await asyncio.wait_for(
                            reader.readexactly(length),
                            timeout=self.request_read_timeout_s) if length else b"")
                except asyncio.TimeoutError:
                    break
                except _BodyTooLarge:
                    await self._respond(writer, 413, {"error": "body too large"})
                    break
                except ValueError:
                    await self._respond(writer, 400, {"error": "bad chunked encoding"})
                    break
                keep_alive = headers.get("connection", "keep-alive").lower() != "close"
                await self._route(method, path, headers, body, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except (asyncio.LimitOverrunError, ValueError):
            # header/request line exceeded the stream buffer limit —
            # StreamReader.readline re-raises LimitOverrunError as
            # ValueError, so both spellings land here
            try:
                await self._respond(writer, 431, {"error": "header line too long"})
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001
            log.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _respond(self, writer, status: int, payload, content_type: str = "application/json"):
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found", 413: "Payload Too Large",
                   500: "Internal Server Error", 503: "Service Unavailable"}
        if isinstance(payload, (dict, list)):
            body = json.dumps(payload).encode()
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = payload
        head = (
            f"HTTP/1.1 {status} {reasons.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "\r\n"
        ).encode()
        writer.write(head + body)
        await writer.drain()

    # ------------------------------------------------------------------ #
    # routes (reference: AudioServer.swift:53-177)
    # ------------------------------------------------------------------ #

    async def _route(self, method, path, headers, body, writer):
        try:
            if method == "GET" and path == "/health":
                await self._respond(writer, 200, {
                    "status": "ok",
                    "uptime_s": round(time.time() - self._started, 1),
                    "models_loaded": self.registry.loaded(),
                    "batcher": {str(k): b.stats for k, b in self._batchers.items()},
                })
            elif method == "POST" and path == "/transcribe":
                await self._handle_transcribe(headers, body, writer)
            elif method == "POST" and path == "/speak":
                await self._handle_speak(body, writer)
            else:
                await self._respond(writer, 404, {"error": f"no route {method} {path}"})
        except _BadRequest as e:
            await self._respond(writer, 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            log.exception("route error")
            await self._respond(writer, 500, {"error": str(e)})

    def _decode_audio_body(self, headers, body):
        """Decode a JSON-base64 or raw-WAV audio body; malformed client
        input raises :class:`_BadRequest` (-> 400, not 500)."""
        ctype = headers.get("content-type", "")
        if "json" in ctype:
            try:
                payload = json.loads(body)
            except json.JSONDecodeError as e:
                raise _BadRequest(f"invalid JSON body: {e}") from e
            if "audio_base64" not in payload:
                raise _BadRequest("missing 'audio_base64' field")
            try:
                pcm = base64.b64decode(payload["audio_base64"], validate=True)
            except Exception as e:  # noqa: BLE001
                raise _BadRequest("invalid base64 audio") from e
            rate = int(payload.get("sample_rate", 16000))
            audio = to_float32(np.frombuffer(pcm, dtype=np.int16))
            return audio, rate, payload
        try:
            audio, rate = read_wav(body)
        except Exception as e:  # noqa: BLE001
            raise _BadRequest(f"invalid WAV body: {e}") from e
        return audio, rate, {}

    async def _handle_transcribe(self, headers, body, writer):
        asr = await self.registry.get("asr")
        if asr is None:
            await self._respond(writer, 503, {"error": "no ASR model registered"})
            return
        audio, rate, payload = self._decode_audio_body(headers, body)
        batcher = self._batcher_for(asr)
        loop = asyncio.get_running_loop()
        kwargs = {}
        if payload.get("language"):
            kwargs["language"] = payload["language"]
        if payload.get("max_tokens") is not None:
            # the decode budget of this request (JSON body only), as /respond
            # takes max_steps
            try:
                kwargs["max_tokens"] = int(payload["max_tokens"])
            except (TypeError, ValueError) as e:
                raise _BadRequest(f"invalid max_tokens: {e}") from e
            if kwargs["max_tokens"] < 1:
                raise _BadRequest("max_tokens must be at least 1")
        fut = batcher.submit(audio, sample_rate=rate, **kwargs)
        result = await loop.run_in_executor(None, fut.result)
        await self._respond(writer, 200, {
            "text": result.text,
            "confidence": result.confidence,
            "duration": result.duration,
            "language": result.language,
        })

    async def _handle_speak(self, body, writer):
        """``engine`` selects the TTS model (the registry entry
        ``tts:<engine>``, else the default ``tts``); ``voice`` and
        ``language`` pass through. Answers a 24 kHz WAV."""
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"invalid JSON body: {e}") from e
        if not payload.get("text"):
            await self._respond(writer, 400, {"error": "missing 'text' field"})
            return
        engine = payload.get("engine")
        tts = await self.registry.get(f"tts:{engine}") if engine else None
        if tts is None:
            tts = await self.registry.get("tts")
        if tts is None:
            await self._respond(writer, 503, {"error": "no TTS model registered"})
            return
        loop = asyncio.get_running_loop()
        batcher = self._tts_batcher_for(tts)
        kwargs = {}
        for k in ("voice", "language"):
            if payload.get(k):
                kwargs[k] = payload[k]
        chunk = await loop.run_in_executor(
            None, lambda: batcher.synthesize(payload["text"], **kwargs)
        )
        await self._respond(writer, 200, wav_bytes(chunk.samples, chunk.sample_rate),
                            content_type="audio/wav")
