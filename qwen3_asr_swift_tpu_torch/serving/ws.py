"""Minimal RFC 6455 WebSocket codec over asyncio streams.

Stdlib-only (the environment ships no websockets package). Server-side:
handshake (Sec-WebSocket-Accept), frame parsing with client masking,
unmasked server frames, ping/pong, close. Fragmentation is supported for
received frames (control frames may interleave between fragments, per
RFC 6455 §5.4); sent frames are single-fragment.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Callable, Optional, Tuple

import numpy as np

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

#: cap on a fully reassembled message, not just one frame
MAX_MESSAGE = 64 * 1024 * 1024


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    header = bytearray()
    header.append((0x80 if fin else 0) | opcode)
    n = len(payload)
    if n < 126:
        header.append(n)
    elif n < 65536:
        header.append(126)
        header += struct.pack(">H", n)
    else:
        header.append(127)
        header += struct.pack(">Q", n)
    return bytes(header) + payload


def _unmask(payload: bytes, mask: bytes) -> bytes:
    # vectorized XOR: the per-byte Python loop costs ~100s of ms per MB on
    # the event loop; numpy does the same in microseconds
    data = np.frombuffer(payload, dtype=np.uint8)
    key = np.frombuffer((mask * (len(data) // 4 + 1))[: len(data)], dtype=np.uint8)
    return (data ^ key).tobytes()


async def read_frame(reader: asyncio.StreamReader, max_size: int = MAX_MESSAGE
                     ) -> Tuple[int, bytes, bool]:
    """Returns (opcode, payload, fin). Raises on EOF / oversized frames."""
    head = await reader.readexactly(2)
    fin = bool(head[0] & 0x80)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    length = head[1] & 0x7F
    if length == 126:
        (length,) = struct.unpack(">H", await reader.readexactly(2))
    elif length == 127:
        (length,) = struct.unpack(">Q", await reader.readexactly(8))
    if length > max_size:
        raise ValueError(f"frame too large: {length}")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(length)
    if mask:
        payload = _unmask(payload, mask)
    return opcode, payload, fin


async def read_message(reader: asyncio.StreamReader,
                       on_control: Optional[Callable] = None,
                       max_size: int = MAX_MESSAGE) -> Optional[Tuple[int, bytes]]:
    """Reassemble one DATA message (handling continuation frames). Returns
    (opcode, payload) or None on clean close.

    Control frames (ping/pong) may arrive BETWEEN the fragments of a data
    message (RFC 6455 §5.4); they are passed to ``on_control`` (an async
    callable) without disturbing the reassembly buffer. The reassembled
    size is capped at ``max_size`` across fragments, not just per frame."""
    opcode = None
    buffer = bytearray()
    while True:
        op, payload, fin = await read_frame(reader, max_size)
        if op == OP_CLOSE:
            return None
        if op in (OP_PING, OP_PONG):
            if on_control is not None:
                await on_control(op, payload)
            continue  # keep reassembling the in-flight data message
        if op != OP_CONT:
            opcode = op
            buffer = bytearray(payload)
        else:
            if opcode is None:
                raise ValueError("continuation frame without a start frame")
            buffer += payload
        if len(buffer) > max_size:
            raise ValueError(f"message too large: {len(buffer)}")
        if fin:
            return opcode if opcode is not None else OP_TEXT, bytes(buffer)


class WebSocket:
    """Server-side websocket wrapper with text/binary send helpers."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def send_text(self, text: str) -> None:
        self.writer.write(encode_frame(OP_TEXT, text.encode()))
        await self.writer.drain()

    async def send_bytes(self, data: bytes) -> None:
        self.writer.write(encode_frame(OP_BINARY, data))
        await self.writer.drain()

    async def _answer_control(self, op: int, payload: bytes) -> None:
        if op == OP_PING:
            self.writer.write(encode_frame(OP_PONG, payload))
            await self.writer.drain()

    async def recv(self) -> Optional[Tuple[int, bytes]]:
        """Returns (opcode, payload) with pings answered transparently
        (including mid-fragmentation), or None once the peer closes."""
        try:
            msg = await read_message(self.reader, on_control=self._answer_control)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        if msg is None:
            await self.close()
            return None
        return msg

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.writer.write(encode_frame(OP_CLOSE, struct.pack(">H", code)))
                await self.writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass


# ---------------------------------------------------------------------------
# client side (demos, CLI tooling, tests) — blocking socket, masked frames
# ---------------------------------------------------------------------------

def encode_client_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    """Client→server frame: RFC 6455 requires client payloads be masked."""
    import os

    header = bytearray()
    header.append((0x80 if fin else 0) | opcode)
    n = len(payload)
    if n < 126:
        header.append(0x80 | n)
    elif n < 65536:
        header.append(0x80 | 126)
        header += struct.pack(">H", n)
    else:
        header.append(0x80 | 127)
        header += struct.pack(">Q", n)
    mask = os.urandom(4)
    return bytes(header) + mask + _unmask(payload, mask)  # XOR is symmetric


class SyncWSClient:
    """Minimal blocking RFC 6455 client for the /v1/realtime endpoint
    (stdlib-only — the environment ships no websockets package). Used by
    examples/dictate_demo.py --ws and the serving tests; NOT a full
    client: single-fragment sends, ping/pong answered, no extensions."""

    def __init__(self, host: str, port: int, path: str = "/v1/realtime",
                 timeout: float = 60.0):
        import socket as _socket

        self.sock = _socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(hashlib.sha1(str(id(self)).encode()).digest()[:16]).decode()
        self.sock.sendall(
            (f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
             f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
             ).encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("websocket handshake failed (connection closed)")
            resp += chunk
        head, _, rest = resp.partition(b"\r\n\r\n")
        if b" 101 " not in head.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"websocket handshake rejected: {head[:200]!r}")
        if accept_key(key).encode() not in head:
            raise ConnectionError("websocket handshake: bad Sec-WebSocket-Accept")
        self._buf = rest

    # -- low level ---------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("websocket closed mid-frame")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_frame(self) -> Tuple[bool, int, bytes]:
        b1, b2 = self._read_exact(2)
        fin, opcode = bool(b1 & 0x80), b1 & 0x0F
        n = b2 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", self._read_exact(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", self._read_exact(8))
        payload = self._read_exact(n)
        return fin, opcode, payload

    # -- messages ----------------------------------------------------------

    def send_json(self, obj) -> None:
        import json

        self.sock.sendall(encode_client_frame(OP_TEXT, json.dumps(obj).encode()))

    def recv_json(self):
        """Next complete text message as a dict (fragments reassembled,
        pings answered, pongs skipped); None once the server closes."""
        import json

        parts, first_op = [], None
        while True:
            fin, op, payload = self._read_frame()
            if op == OP_PING:
                self.sock.sendall(encode_client_frame(OP_PONG, payload))
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                try:
                    self.sock.sendall(encode_client_frame(OP_CLOSE, payload[:2]))
                except OSError:
                    pass
                return None
            if op in (OP_TEXT, OP_BINARY):
                first_op = op
                parts = [payload]
            elif op == OP_CONT:
                parts.append(payload)
            if fin and first_op is not None:
                data = b"".join(parts)
                return json.loads(data.decode()) if first_op == OP_TEXT else data

    def close(self) -> None:
        try:
            self.sock.sendall(encode_client_frame(OP_CLOSE, struct.pack(">H", 1000)))
        except OSError:
            pass
        self.sock.close()
