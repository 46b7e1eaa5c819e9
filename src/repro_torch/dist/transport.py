"""The ``repro_torch.dist`` wire layer: versioned, length-prefixed messages.

Every frame is ``header + payload``:

    header  = <4s magic "GLSP"> <u16 version> <u16 msg_type> <u64 payload_len>
    payload = one TLV-encoded dict of the message dataclass's fields

The TLV value codec covers exactly the types the sampling protocol needs
(None/bool/int/float/str/bytes/tuple/list/dict/ndarray); ints are
arbitrary-precision (request keys are 64-bit-masked and may not fit a
signed i64), ndarrays travel as ``dtype.str + shape + raw buffer`` and
decode to fresh writable copies, so a ``DispatchResult`` round-trips
bit-identically.

Decoding is strict: a bad magic is a :class:`ProtocolError`, a version
other than :data:`PROTOCOL_VERSION` is a :class:`VersionMismatch`, and a
frame shorter than its header promises is a :class:`TruncatedFrame` —
protocol drift between a client and a worker fails loudly at the first
frame instead of corrupting samples silently.

Two pluggable channels carry frames: :class:`PipeChannel` (a
``multiprocessing`` duplex pipe — the same-host fast path) and
:class:`SocketChannel` (any stream socket — the general case).  Both
expose ``send/recv/poll/close`` and raise :class:`ChannelClosed` when the
peer is gone, which is how the pool detects a dead worker mid-request.

The shape follows DGL's distributed ``graph_services`` RPC layer: typed
request/response pairs over one serialized transport, with control frames
(stats/health/reset/shutdown) riding the same channel as data.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import select
import socket
import struct
from dataclasses import dataclass

import numpy as np

__all__ = [
    "PROTOCOL_VERSION",
    "ProtocolError",
    "VersionMismatch",
    "TruncatedFrame",
    "ChannelClosed",
    "SampleDispatch",
    "DispatchResult",
    "StatsRequest",
    "StatsResponse",
    "HealthRequest",
    "HealthResponse",
    "ResetStatsRequest",
    "ResetStatsAck",
    "ShutdownRequest",
    "ShutdownAck",
    "MESSAGE_TYPES",
    "encode_frame",
    "decode_frame",
    "messages_equal",
    "PipeChannel",
    "SocketChannel",
    "channel_pair",
]

MAGIC = b"GLSP"
PROTOCOL_VERSION = 1

_HEADER = struct.Struct("<4sHHQ")  # magic, version, msg_type, payload_len


class ProtocolError(RuntimeError):
    """Malformed or unrecognized frame content (bad magic, unknown type)."""


class VersionMismatch(ProtocolError):
    """Peer speaks a different protocol version; refuse rather than guess."""


class TruncatedFrame(ProtocolError):
    """Frame shorter than its header (or a value) promised."""


class ChannelClosed(ConnectionError):
    """The transport peer is gone (EOF / broken pipe / reset)."""


# ---------------------------------------------------------------------------
# TLV value codec
# ---------------------------------------------------------------------------

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_BYTES = 6
_T_TUPLE = 7
_T_LIST = 8
_T_DICT = 9
_T_NDARRAY = 10

_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")


def _pack_value(out: bytearray, v) -> None:
    # bool before int: bool is an int subclass
    if v is None:
        out.append(_T_NONE)
    elif isinstance(v, (bool, np.bool_)):
        out.append(_T_TRUE if v else _T_FALSE)
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        out.append(_T_INT)
        sign = 1 if v < 0 else 0
        mag = (-v if sign else v).to_bytes((abs(v).bit_length() + 7) // 8 or 1, "little")
        out.append(sign)
        out += _U32.pack(len(mag))
        out += mag
    elif isinstance(v, (float, np.floating)):
        out.append(_T_FLOAT)
        out += _F64.pack(float(v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_T_STR)
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += _U32.pack(len(v))
        out += bytes(v)
    elif isinstance(v, (tuple, list)):
        out.append(_T_TUPLE if isinstance(v, tuple) else _T_LIST)
        out += _U32.pack(len(v))
        for item in v:
            _pack_value(out, item)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        out += _U32.pack(len(v))
        for k, item in v.items():
            _pack_value(out, k)
            _pack_value(out, item)
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        out.append(_T_NDARRAY)
        _pack_value(out, arr.dtype.str)
        _pack_value(out, tuple(int(d) for d in arr.shape))
        raw = arr.tobytes()
        out += _U32.pack(len(raw))
        out += raw
    else:
        raise ProtocolError(f"unencodable value of type {type(v).__name__}: {v!r}")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise TruncatedFrame(
                f"payload ends at byte {len(self.buf)} but a value needs "
                f"bytes up to {end}"
            )
        chunk = self.buf[self.pos : end]
        self.pos = end
        return chunk

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _unpack_value(r: _Reader):
    tag = r.take(1)[0]
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        sign = r.take(1)[0]
        mag = int.from_bytes(r.take(r.u32()), "little")
        return -mag if sign else mag
    if tag == _T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u32()).decode("utf-8")
    if tag == _T_BYTES:
        return bytes(r.take(r.u32()))
    if tag in (_T_TUPLE, _T_LIST):
        n = r.u32()
        items = [_unpack_value(r) for _ in range(n)]
        return tuple(items) if tag == _T_TUPLE else items
    if tag == _T_DICT:
        n = r.u32()
        return {_unpack_value(r): _unpack_value(r) for _ in range(n)}
    if tag == _T_NDARRAY:
        dtype = np.dtype(_unpack_value(r))
        shape = _unpack_value(r)
        raw = r.take(r.u32())
        # copy: frombuffer views are read-only and pin the frame's memory
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    raise ProtocolError(f"unknown TLV tag {tag}")


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

MESSAGE_TYPES: dict[int, type] = {}


def _register_message(type_id: int):
    def deco(cls):
        cls.type_id = type_id
        if type_id in MESSAGE_TYPES:
            raise ValueError(f"duplicate message type id {type_id}")
        MESSAGE_TYPES[type_id] = cls
        return cls

    return deco


def _zeros() -> np.ndarray:
    return np.zeros(0, np.int64)


@_register_message(1)
@dataclass
class SampleDispatch:
    """One chunk of one request-hop, addressed to one partition's worker.

    ``(key, hop, part, chunk)`` is exactly the service's dispatch RNG key
    material — the worker re-derives the same keyed stream, so the answer
    is bit-identical to the in-process dispatch."""

    key: tuple
    hop: int
    part: int
    chunk: int
    seeds: np.ndarray
    fanout: int
    direction: str
    weighted: bool
    replace: bool


@_register_message(2)
@dataclass
class DispatchResult:
    """A worker's answer to one :class:`SampleDispatch`.

    ``lost=True`` is a degraded dispatch (every replica exhausted its
    retries or sat quarantined) — the arrays are empty and the client
    marks the request's hop partial, exactly like the in-process path.
    ``state`` is the worker's crash-consistency snapshot (fault-injector
    counters, breaker states, per-replica stats): the pool keeps the
    latest one per worker and hands it to a respawned process, so the
    replayed fault/breaker streams continue where the dead worker left
    off instead of restarting from zero."""

    part: int
    chunk: int
    lost: bool = False
    src: np.ndarray = dataclasses.field(default_factory=_zeros)
    dst: np.ndarray = dataclasses.field(default_factory=_zeros)
    eid: np.ndarray = dataclasses.field(default_factory=_zeros)
    scores: np.ndarray | None = None  # weighted gathers only
    retries: int = 0
    failovers: int = 0
    wall_ms: float = 0.0
    state: dict = dataclasses.field(default_factory=dict)


@_register_message(3)
@dataclass
class StatsRequest:
    pass


@_register_message(4)
@dataclass
class StatsResponse:
    part: int
    # site ("server.<part>.<replica>") -> ServerStats field dict
    replicas: dict = dataclasses.field(default_factory=dict)


@_register_message(5)
@dataclass
class HealthRequest:
    pass


@_register_message(6)
@dataclass
class HealthResponse:
    part: int
    health: dict = dataclasses.field(default_factory=dict)


@_register_message(7)
@dataclass
class ResetStatsRequest:
    pass


@_register_message(8)
@dataclass
class ResetStatsAck:
    part: int


@_register_message(9)
@dataclass
class ShutdownRequest:
    pass


@_register_message(10)
@dataclass
class ShutdownAck:
    part: int


def encode_frame(msg) -> bytes:
    """Serialize one message dataclass into a self-describing frame."""
    type_id = getattr(type(msg), "type_id", None)
    if type_id is None or MESSAGE_TYPES.get(type_id) is not type(msg):
        raise ProtocolError(f"not a registered message: {msg!r}")
    payload = bytearray()
    _pack_value(
        payload,
        {f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)},
    )
    return _HEADER.pack(MAGIC, PROTOCOL_VERSION, type_id, len(payload)) + bytes(
        payload
    )


def decode_frame(buf: bytes):
    """Parse one frame back into its message dataclass (strictly)."""
    if len(buf) < _HEADER.size:
        raise TruncatedFrame(
            f"frame of {len(buf)} bytes is shorter than the "
            f"{_HEADER.size}-byte header"
        )
    magic, version, type_id, plen = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != PROTOCOL_VERSION:
        raise VersionMismatch(
            f"peer speaks protocol v{version}, this build speaks "
            f"v{PROTOCOL_VERSION}"
        )
    if len(buf) < _HEADER.size + plen:
        raise TruncatedFrame(
            f"header promises a {plen}-byte payload but only "
            f"{len(buf) - _HEADER.size} bytes follow"
        )
    cls = MESSAGE_TYPES.get(type_id)
    if cls is None:
        raise ProtocolError(f"unknown message type {type_id}")
    fields = _unpack_value(_Reader(buf, _HEADER.size))
    return cls(**fields)


def messages_equal(a, b) -> bool:
    """Field-wise equality that treats ndarrays bitwise (tests/debugging)."""
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if (
                not isinstance(va, np.ndarray)
                or not isinstance(vb, np.ndarray)
                or va.dtype != vb.dtype
                or va.shape != vb.shape
                or not np.array_equal(va, vb)
            ):
                return False
        elif va != vb:
            return False
    return True


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


class PipeChannel:
    """Frames over a ``multiprocessing`` duplex pipe (same-host fast path).

    ``Connection.send_bytes`` already length-prefixes at the OS level, so
    a frame arrives whole or not at all; the frame header still carries
    its own length so the two transports share one decoder."""

    kind = "mp"

    def __init__(self, conn):
        self.conn = conn

    def send(self, msg) -> None:
        try:
            self.conn.send_bytes(encode_frame(msg))
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise ChannelClosed(f"pipe peer is gone: {exc}") from exc

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            return self.conn.poll(timeout)
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise ChannelClosed(f"pipe peer is gone: {exc}") from exc

    def recv(self):
        try:
            buf = self.conn.recv_bytes()
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise ChannelClosed(f"pipe peer is gone: {exc}") from exc
        return decode_frame(buf)

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class SocketChannel:
    """Frames over any stream socket (the general, cross-host case)."""

    kind = "socket"

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.setblocking(True)

    def send(self, msg) -> None:
        try:
            self.sock.sendall(encode_frame(msg))
        except OSError as exc:
            raise ChannelClosed(f"socket peer is gone: {exc}") from exc

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            ready, _, _ = select.select([self.sock], [], [], timeout)
        except OSError as exc:
            raise ChannelClosed(f"socket peer is gone: {exc}") from exc
        return bool(ready)

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            try:
                chunk = self.sock.recv(min(n, 1 << 20))
            except OSError as exc:
                raise ChannelClosed(f"socket peer is gone: {exc}") from exc
            if not chunk:
                # mid-frame EOF is a dead peer, not a protocol bug
                raise ChannelClosed("socket closed by peer")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def recv(self):
        header = self._read_exact(_HEADER.size)
        _, _, _, plen = _HEADER.unpack(header)
        return decode_frame(header + self._read_exact(plen))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def channel_pair(kind: str):
    """A connected ``(parent_end, child_end)`` channel pair, pre-fork."""
    if kind == "mp":
        a, b = mp.Pipe(duplex=True)
        return PipeChannel(a), PipeChannel(b)
    if kind == "socket":
        s1, s2 = socket.socketpair()
        return SocketChannel(s1), SocketChannel(s2)
    raise ValueError(f"channel kind must be 'mp' or 'socket', got {kind!r}")
