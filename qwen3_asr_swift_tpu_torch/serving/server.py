"""Speech serving: REST + OpenAI-Realtime WebSocket, stdlib asyncio — the
port's copy of ``qwen3_asr_swift_tpu/serving/server.py``.

``GET /health``, ``POST /transcribe``, ``/speak``, ``/respond`` (the
``s2s`` entry, PersonaPlex) and ``/enhance`` (the ``enhance`` entry,
DeepFilterNet3), and the ``/v1/realtime`` WebSocket
(:class:`RealtimeSession`, the reference's copy: commits transcribe through
the ASR batcher, ``response.create`` streams TTS audio deltas), with the
reference's HTTP/1.1 plumbing (keep-alive, chunked bodies, body and header
limits, read timeouts). ASR requests flow through the
:class:`ContinuousBatcher` (``scheduler="group"``) or the port's
:class:`SlotPoolASR` (``scheduler="slotpool"``); TTS requests through the
:class:`TTSBatcher` or the port's :class:`SlotPoolTTS`, by the same switch.
A JSON ``/transcribe`` body may carry ``max_tokens``, the request's decode
budget (the reference's route has none; its ``/respond`` takes
``max_steps`` so).

:func:`build_default_registry` serves ``Qwen3ASR.from_pretrained()``'s
default model as ``"asr"``, loaded at its first request; ``python -m
qwen3_asr_swift_tpu_torch.serving.server`` (:func:`main`) serves it.
"""

from __future__ import annotations

import asyncio
import base64
import json
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..audio.io import read_wav, wav_bytes
from ..core.logging import serving as log
from ..core.types import to_float32, to_pcm16
from .batching import ContinuousBatcher, TTSBatcher
from .slotpool import SlotPoolASR
from .ws import OP_TEXT, WebSocket, accept_key


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
    """REST + realtime WebSocket speech server."""

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
        self._s2s_lock = threading.Lock()
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
            if (self.scheduler == "slotpool" and hasattr(model, "talker_params")
                    and hasattr(model, "cp_params")):
                # frame-level continuous batching: syntheses join the running
                # talker batch at frame boundaries; oversize and clone prompts
                # divert to the serial fallback. Engines without a talker and
                # a code predictor take the group batcher.
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

                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_websocket(path, headers, reader, writer)
                    return

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
            elif method == "POST" and path == "/respond":
                await self._handle_respond(headers, body, writer)
            elif method == "POST" and path == "/enhance":
                await self._handle_enhance(headers, body, writer)
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

    async def _handle_respond(self, headers, body, writer):
        """JSON-body params mirror the reference's /respond
        (AudioServer.swift:111-150): ``max_steps``, ``system_prompt``,
        ``seed``, and ``format: "json"`` — which returns the duration,
        the agent transcript (when the model carries a tokenizer), and
        base64 WAV instead of raw audio/wav."""
        s2s = await self.registry.get("s2s")
        if s2s is None:
            await self._respond(writer, 503, {"error": "no speech-to-speech model registered"})
            return
        audio, rate, payload = self._decode_audio_body(headers, body)
        kwargs = {}
        if payload.get("system_prompt") is not None:
            kwargs["system_prompt"] = payload["system_prompt"]
        if payload.get("seed") is not None:
            kwargs["seed"] = int(payload["seed"])
        if payload.get("max_steps") is not None:
            from ..models.personaplex import PersonaSampling

            kwargs["sampling"] = PersonaSampling(max_steps=int(payload["max_steps"]))
        loop = asyncio.get_running_loop()

        def job():
            # serialize respond + last_text_tokens/last_transcript reads:
            # they are instance state on the model, so two overlapping
            # requests would otherwise pair one request's audio with the
            # other's transcript (the device serializes compute anyway)
            with self._s2s_lock:
                chunk = s2s.respond(audio, sample_rate=rate, **kwargs)
                return (chunk, getattr(s2s, "last_text_tokens", None),
                        getattr(s2s, "last_transcript", None))

        chunk, toks, transcript = await loop.run_in_executor(None, job)
        if payload.get("format") == "json":
            out = {"duration": round(chunk.duration, 2),
                   "audio_base64": base64.b64encode(
                       wav_bytes(chunk.samples, chunk.sample_rate)).decode()}
            if toks is not None:
                # count under the reference's field name
                # (AudioServer.swift:144), ids alongside
                out["text_tokens"] = len(toks)
                out["text_token_ids"] = [int(t) for t in toks]
            if transcript is not None:
                out["transcript"] = transcript
            await self._respond(writer, 200, out)
            return
        await self._respond(writer, 200, wav_bytes(chunk.samples, chunk.sample_rate),
                            content_type="audio/wav")

    async def _handle_enhance(self, headers, body, writer):
        enh = await self.registry.get("enhance")
        if enh is None:
            await self._respond(writer, 503, {"error": "no enhancement model registered"})
            return
        audio, rate, _ = self._decode_audio_body(headers, body)
        loop = asyncio.get_running_loop()
        chunk = await loop.run_in_executor(None, lambda: enh.enhance(audio, rate))
        await self._respond(writer, 200, wav_bytes(chunk.samples, chunk.sample_rate),
                            content_type="audio/wav")

    # ------------------------------------------------------------------ #
    # /v1/realtime (reference: AudioServer.swift:255-497)
    # ------------------------------------------------------------------ #

    async def _handle_websocket(self, path, headers, reader, writer):
        key = headers.get("sec-websocket-key")
        if not key or not path.startswith("/v1/realtime"):
            await self._respond(writer, 400, {"error": "bad websocket request"})
            return
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        )
        writer.write(resp.encode())
        await writer.drain()
        ws = WebSocket(reader, writer)
        session = RealtimeSession(self, ws)
        await session.run()


class RealtimeSession:
    """OpenAI Realtime protocol subset: audio in → transcription;
    response.create → TTS audio deltas."""

    def __init__(self, server: SpeechServer, ws: WebSocket):
        self.server = server
        self.ws = ws
        self._audio = bytearray()  # pcm16 @ 16 kHz mono (input_audio_format pcm16)
        self._input_rate = 16000
        self._event_counter = 0
        self._last_transcript = ""
        self._pending_text = ""  # queued conversation.item.create text

    def _event_id(self) -> str:
        self._event_counter += 1
        return f"evt_{self._event_counter}"

    async def _send(self, payload: dict):
        await self.ws.send_text(json.dumps(payload))

    async def run(self):
        await self._send({"type": "session.created", "event_id": self._event_id(),
                          "session": {"id": "sess_1", "input_audio_format": "pcm16"}})
        while True:
            msg = await self.ws.recv()
            if msg is None:
                return
            op, payload = msg
            if op != OP_TEXT:
                continue
            try:
                event = json.loads(payload)
            except json.JSONDecodeError:
                await self._send({"type": "error", "error": {"message": "invalid JSON"}})
                continue
            try:
                await self._dispatch(event)
            except Exception as e:  # noqa: BLE001
                log.exception("realtime event failed")
                await self._send({"type": "error", "error": {"message": str(e)}})

    async def _dispatch(self, event: dict):
        etype = event.get("type", "")
        if etype == "session.update":
            rate = event.get("session", {}).get("input_audio_sample_rate")
            if rate:
                self._input_rate = int(rate)
            await self._send({"type": "session.updated", "event_id": self._event_id()})
        elif etype == "input_audio_buffer.append":
            self._audio += base64.b64decode(event.get("audio", ""))
            if len(self._audio) > self.server.max_body:
                self._audio.clear()
                await self._send({"type": "error", "error": {
                    "message": "input audio buffer overflow; buffer cleared"}})
        elif etype == "input_audio_buffer.clear":
            self._audio.clear()
            await self._send({"type": "input_audio_buffer.cleared", "event_id": self._event_id()})
        elif etype == "input_audio_buffer.commit":
            await self._commit()
        elif etype == "response.create":
            await self._response(event)
        elif etype == "conversation.item.create":
            # text items queue for the next response.create's TTS
            # (reference: AudioServer.swift:477-490)
            item = event.get("item") or {}
            for part in item.get("content") or []:
                if part.get("type") in ("input_text", "text") and part.get("text"):
                    self._pending_text = part["text"]
                    await self._send({"type": "conversation.item.created",
                                      "event_id": self._event_id(), "item": item})
        else:
            await self._send({"type": "error", "error": {"message": f"unsupported event {etype!r}"}})

    async def _commit(self):
        asr = await self.server.registry.get("asr")
        if asr is None:
            await self._send({"type": "error", "error": {"message": "no ASR model"}})
            return
        pcm = np.frombuffer(bytes(self._audio), dtype=np.int16)
        self._audio.clear()
        audio = to_float32(pcm)
        await self._send({"type": "input_audio_buffer.committed", "event_id": self._event_id()})
        batcher = self.server._batcher_for(asr)
        loop = asyncio.get_running_loop()
        fut = batcher.submit(audio, sample_rate=self._input_rate)
        result = await loop.run_in_executor(None, fut.result)
        self._last_transcript = result.text
        await self._send({
            "type": "conversation.item.input_audio_transcription.completed",
            "event_id": self._event_id(),
            "transcript": result.text,
        })

    async def _response(self, event: dict):
        tts = await self.server.registry.get("tts")
        text = ((event.get("response", {}) or {}).get("instructions")
                or self._pending_text or self._last_transcript)
        self._pending_text = ""
        if tts is None or not text:
            await self._send({"type": "response.done", "event_id": self._event_id(),
                              "response": {"status": "incomplete"}})
            return
        loop = asyncio.get_running_loop()
        await self._send({"type": "response.created", "event_id": self._event_id()})

        # true streaming: deltas go out as the engine emits chunks
        # (reference: synthesizeStream → response.audio.delta,
        # AudioServer.swift:371-475). Every TTS model has
        # synthesize_stream (the protocol default yields one
        # whole-utterance chunk); each emitted piece is re-sliced into
        # ~200 ms deltas so single-chunk engines still stream. The
        # blocking generator runs on a worker thread; an asyncio queue
        # bridges to the socket, and a producer error reaches the client
        # as an error event + incomplete status instead of being
        # swallowed with truncated audio marked complete.
        q: "asyncio.Queue" = asyncio.Queue()
        stream_fn = getattr(tts, "synthesize_stream", None)
        if stream_fn is None:
            # duck-typed models without the protocol default: one chunk
            def stream_fn(t):
                yield tts.synthesize(t)

        def produce():
            try:
                for piece in stream_fn(text):
                    loop.call_soon_threadsafe(q.put_nowait, piece)
            except Exception as e:  # noqa: BLE001
                log.exception("streaming TTS failed")
                loop.call_soon_threadsafe(q.put_nowait, e)
            finally:
                loop.call_soon_threadsafe(q.put_nowait, None)

        loop.run_in_executor(None, produce)
        failed = None
        while True:
            piece = await q.get()
            if piece is None:
                break
            if isinstance(piece, Exception):
                failed = piece
                continue  # drain to the sentinel
            pcm = to_pcm16(piece.samples).tobytes()
            step = max(2, piece.sample_rate // 5 * 2)  # ~200 ms of PCM16
            for off in range(0, len(pcm), step):
                await self._send({
                    "type": "response.audio.delta",
                    "event_id": self._event_id(),
                    "delta": base64.b64encode(pcm[off : off + step]).decode(),
                })
        if failed is not None:
            await self._send({"type": "error",
                              "error": {"message": f"synthesis failed: {failed}"}})
            await self._send({"type": "response.done", "event_id": self._event_id(),
                              "response": {"status": "incomplete"}})
            return
        await self._send({"type": "response.audio.done", "event_id": self._event_id()})
        await self._send({"type": "response.done", "event_id": self._event_id(),
                          "response": {"status": "completed"}})


def build_default_registry(decode_chunk_tokens: Optional[int] = 15,
                           device="cuda") -> ModelRegistry:
    """Registry wired to the real model loaders (lazy): ``"asr"`` is
    ``Qwen3ASR.from_pretrained()`` on ``device``, its default id found in
    the cache or fetched (``core/hub.py``).

    ``decode_chunk_tokens`` bounds each dispatched ASR decode program so a
    newly arriving request interleaves at chunk boundaries instead of
    waiting out an in-flight batch's full generate (loaded first-token
    latency); None = monolithic decode. Default 15, the reference's."""
    reg = ModelRegistry()

    def load_asr():
        from ..models.qwen3_asr import Qwen3ASR

        return Qwen3ASR.from_pretrained(decode_chunk_tokens=decode_chunk_tokens, device=device)

    reg.register("asr", load_asr)
    return reg


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="speech server on PyTorch/CUDA")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8321)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the current card, the default), 'cuda:N' or 'cpu'")
    args = parser.parse_args(argv)
    server = SpeechServer(build_default_registry(device=args.device), host=args.host,
                          port=args.port)
    asyncio.run(server.serve_forever())


if __name__ == "__main__":
    main()
