"""Minimal Kafka wire-protocol client + in-repo stub broker.

The reference ships a Sarama-based kafka notification queue
(weed/notification/kafka/kafka_queue.go:1-100).  The kafka
sink/consumer here
speak a small, self-contained subset of the real Kafka protocol
(api v0: Produce, Fetch, OffsetCommit, OffsetFetch, message format v0)
— enough to prove serialization, topic routing, and ack/offset
durability end to end.  `StubBroker` implements the same subset as an
in-process TCP server with an in-memory log and committed-offset table,
so tests exercise the kafka classes over a REAL socket with REAL wire
bytes, no external infrastructure.

Wire layout (Kafka protocol guide, v0 APIs):
  frame   := int32 size, payload
  request := int16 api_key, int16 api_version, int32 correlation_id,
             string client_id, body
  string  := int16 len, bytes     (len -1 = null)
  bytes   := int32 len, bytes     (len -1 = null)
  message := int64 offset, int32 size, int32 crc32(ieee, of the rest),
             int8 magic=0, int8 attrs=0, bytes key, bytes value

The port's own copy of seaweedfs_tpu/notification/kafka_wire.py.
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib
from typing import Optional

API_PRODUCE = 0
API_FETCH = 1
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9


# -- primitive codecs --------------------------------------------------------

def _s16(v: int) -> bytes:
    return struct.pack(">h", v)


def _s32(v: int) -> bytes:
    return struct.pack(">i", v)


def _s64(v: int) -> bytes:
    return struct.pack(">q", v)


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return _s16(-1)
    b = s.encode()
    return _s16(len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return _s32(-1)
    return _s32(len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def i8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def i16(self) -> int:
        v = struct.unpack_from(">h", self.data, self.pos)[0]
        self.pos += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        v = self.data[self.pos:self.pos + n].decode()
        self.pos += n
        return v

    def bytes(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v


def encode_message(key: Optional[bytes], value: Optional[bytes],
                   offset: int = 0) -> bytes:
    """One v0 message with its CRC, wrapped with offset+size."""
    body = b"\x00\x00" + _bytes(key) + _bytes(value)  # magic0, attrs0
    msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
    return _s64(offset) + _s32(len(msg)) + msg


def decode_message_set(data: bytes) -> list[tuple[int, bytes, bytes]]:
    """[(offset, key, value)] — tolerates a truncated trailing message
    (Kafka fetch semantics: partial messages at the end are normal)."""
    out = []
    r = _Reader(data)
    while r.pos + 12 <= len(data):
        offset = r.i64()
        size = r.i32()
        if r.pos + size > len(data):
            break
        m = _Reader(r.raw(size))
        crc = m.i32() & 0xFFFFFFFF
        body = m.data[4:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("kafka message CRC mismatch")
        m.i8()  # magic
        m.i8()  # attributes
        key = m.bytes() or b""
        value = m.bytes() or b""
        out.append((offset, key, value))
    return out


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kafka connection closed")
        buf += chunk
    return buf


def _roundtrip(sock: socket.socket, api: int, corr: int,
               body: bytes, client_id: str = "seaweedfs") -> _Reader:
    req = _s16(api) + _s16(0) + _s32(corr) + _string(client_id) + body
    sock.sendall(_s32(len(req)) + req)
    size = struct.unpack(">i", _recv_exact(sock, 4))[0]
    resp = _Reader(_recv_exact(sock, size))
    got_corr = resp.i32()
    if got_corr != corr:
        raise ValueError(f"correlation id mismatch {got_corr} != {corr}")
    return resp


# -- client ------------------------------------------------------------------

class MinimalKafkaClient:
    """One connection to one broker; partition 0 of one topic (the
    notification sink's usage — kafka_queue.go publishes to a single
    configured topic and lets the broker partition by key; this minimal
    client pins partition 0)."""

    def __init__(self, host: str, port: int, topic: str):
        self.topic = topic
        self._sock = socket.create_connection((host, port), timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._corr = 0
        self._lock = threading.Lock()

    def _next_corr(self) -> int:
        self._corr += 1
        return self._corr

    def produce(self, key: bytes, value: bytes) -> int:
        """Send one message (acks=1); returns the assigned offset."""
        msg_set = encode_message(key, value)
        body = (_s16(1) + _s32(10000) +      # required_acks, timeout_ms
                _s32(1) + _string(self.topic) +
                _s32(1) + _s32(0) +          # one partition: 0
                _s32(len(msg_set)) + msg_set)
        with self._lock:
            r = _roundtrip(self._sock, API_PRODUCE, self._next_corr(), body)
        n_topics = r.i32()
        assert n_topics == 1
        r.string()
        n_parts = r.i32()
        assert n_parts == 1
        r.i32()                              # partition
        err = r.i16()
        if err:
            raise IOError(f"kafka produce error {err}")
        return r.i64()

    def fetch(self, offset: int, max_bytes: int = 1 << 20
              ) -> list[tuple[int, bytes, bytes]]:
        """[(offset, key, value)] from `offset` on partition 0."""
        body = (_s32(-1) + _s32(100) + _s32(1) +  # replica, max_wait, min
                _s32(1) + _string(self.topic) +
                _s32(1) + _s32(0) + _s64(offset) + _s32(max_bytes))
        with self._lock:
            r = _roundtrip(self._sock, API_FETCH, self._next_corr(), body)
        n_topics = r.i32()
        assert n_topics == 1
        r.string()
        n_parts = r.i32()
        assert n_parts == 1
        r.i32()                              # partition
        err = r.i16()
        if err:
            raise IOError(f"kafka fetch error {err}")
        r.i64()                              # high watermark
        set_len = r.i32()
        return decode_message_set(r.raw(set_len))

    def commit_offset(self, group: str, offset: int):
        body = (_string(group) + _s32(1) + _string(self.topic) +
                _s32(1) + _s32(0) + _s64(offset) + _string(""))
        with self._lock:
            r = _roundtrip(self._sock, API_OFFSET_COMMIT,
                           self._next_corr(), body)
        r.i32()
        r.string()
        r.i32()
        r.i32()
        err = r.i16()
        if err:
            raise IOError(f"kafka offset commit error {err}")

    def fetch_offset(self, group: str) -> int:
        """Last committed offset for the group (-1 = none)."""
        body = (_string(group) + _s32(1) + _string(self.topic) +
                _s32(1) + _s32(0))
        with self._lock:
            r = _roundtrip(self._sock, API_OFFSET_FETCH,
                           self._next_corr(), body)
        r.i32()
        r.string()
        r.i32()
        r.i32()                              # partition
        off = r.i64()
        r.string()                           # metadata
        err = r.i16()
        if err:
            raise IOError(f"kafka offset fetch error {err}")
        return off

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# -- stub broker -------------------------------------------------------------

class StubBroker:
    """In-process broker speaking the same v0 subset: per-topic
    append-only logs (partition 0) + a committed-offset table per
    consumer group.  Concurrent connections each get a thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._logs: dict[str, list[bytes]] = {}   # topic -> raw messages
        self._offsets: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                size = struct.unpack(">i", _recv_exact(conn, 4))[0]
                req = _Reader(_recv_exact(conn, size))
                api = req.i16()
                req.i16()                      # api_version (v0 only)
                corr = req.i32()
                req.string()                   # client_id
                resp = _s32(corr) + self._handle(api, req)
                conn.sendall(_s32(len(resp)) + resp)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            conn.close()

    def _handle(self, api: int, r: _Reader) -> bytes:
        if api == API_PRODUCE:
            r.i16()                            # acks
            r.i32()                            # timeout
            n_topics = r.i32()
            out = _s32(n_topics)
            for _ in range(n_topics):
                topic = r.string() or ""
                n_parts = r.i32()
                out += _string(topic) + _s32(n_parts)
                for _ in range(n_parts):
                    r.i32()                    # partition (0)
                    set_len = r.i32()
                    msgs = decode_message_set(r.raw(set_len))
                    with self._lock:
                        log = self._logs.setdefault(topic, [])
                        base = len(log)
                        for _, key, value in msgs:
                            log.append(encode_message(
                                key, value, offset=len(log)))
                    out += _s32(0) + _s16(0) + _s64(base)
            return out
        if api == API_FETCH:
            r.i32(), r.i32(), r.i32()          # replica, wait, min_bytes
            n_topics = r.i32()
            out = _s32(n_topics)
            for _ in range(n_topics):
                topic = r.string() or ""
                n_parts = r.i32()
                out += _string(topic) + _s32(n_parts)
                for _ in range(n_parts):
                    r.i32()                    # partition
                    offset = r.i64()
                    max_bytes = r.i32()
                    with self._lock:
                        log = list(self._logs.get(topic, []))
                    chunk = b""
                    for raw in log[max(0, offset):]:
                        if len(chunk) + len(raw) > max_bytes and chunk:
                            break
                        chunk += raw
                    out += (_s32(0) + _s16(0) + _s64(len(log)) +
                            _s32(len(chunk)) + chunk)
            return out
        if api == API_OFFSET_COMMIT:
            group = r.string() or ""
            n_topics = r.i32()
            out = _s32(n_topics)
            for _ in range(n_topics):
                topic = r.string() or ""
                n_parts = r.i32()
                out += _string(topic) + _s32(n_parts)
                for _ in range(n_parts):
                    r.i32()                    # partition
                    offset = r.i64()
                    r.string()                 # metadata
                    with self._lock:
                        self._offsets[(group, topic)] = offset
                    out += _s32(0) + _s16(0)
            return out
        if api == API_OFFSET_FETCH:
            group = r.string() or ""
            n_topics = r.i32()
            out = _s32(n_topics)
            for _ in range(n_topics):
                topic = r.string() or ""
                n_parts = r.i32()
                out += _string(topic) + _s32(n_parts)
                for _ in range(n_parts):
                    r.i32()
                    with self._lock:
                        off = self._offsets.get((group, topic), -1)
                    out += _s32(0) + _s64(off) + _string("") + _s16(0)
            return out
        raise ValueError(f"stub broker: unsupported api {api}")

    def message_count(self, topic: str) -> int:
        with self._lock:
            return len(self._logs.get(topic, []))

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
