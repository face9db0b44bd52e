"""The port's notification sinks and its Kafka wire client against the JAX
package's, on the CPU.

- `encode_message` / `decode_message_set`: equal bytes and records on
  seeded keys and values; a corrupt CRC raises in both.
- `MinimalKafkaClient`: the same produce, fetch, offset-commit and
  offset-fetch script sends byte-identical request frames and receives
  byte-identical replies from either package's `StubBroker`, with each
  package's client against each package's broker.
- `load_notification_queue` / `load_notification_input` pick the same
  sinks from the same notification.toml; a filer's change events reach
  the file sink as equal JSON lines (clocks pinned), which the file
  input reads back with a durable offset; the kafka queue and input
  carry a filer's events through a stub broker with manual-commit acks.
Tolerance: equality throughout.
"""

import json
import socket

import numpy as np
import pytest

from test_torch_filer import PKG, pin_clocks

from seaweedfs_tpu import notification as j_notify
from seaweedfs_tpu.notification import kafka_wire as j_wire
from seaweedfs_tpu.util import config as j_config
from seaweedfs_tpu_torch import notification as t_notify
from seaweedfs_tpu_torch.notification import kafka_wire as t_wire
from seaweedfs_tpu_torch.util import config as t_config

WIRE = {"jax": j_wire, "port": t_wire}
NOTIFY = {"jax": j_notify, "port": t_notify}
CONFIG = {"jax": j_config, "port": t_config}


def _records(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = rng.bytes(int(rng.integers(0, 40))) if i % 3 else None
        value = rng.bytes(int(rng.integers(0, 3000))) if i % 5 else b""
        out.append((key, value, int(rng.integers(0, 1 << 40))))
    return out


def test_message_encoding_like_jax():
    records = _records(3, 40)
    frames = {pkg: b"".join(w.encode_message(k, v, offset=o)
                            for k, v, o in records)
              for pkg, w in WIRE.items()}
    assert frames["port"] == frames["jax"]
    decoded = {pkg: w.decode_message_set(frames["jax"] + b"\x00" * 7)
               for pkg, w in WIRE.items()}
    assert decoded["port"] == decoded["jax"]
    assert [(o, k or b"", v) for k, v, o in records] == decoded["port"]
    bad = bytearray(frames["jax"])
    bad[13] ^= 0xFF
    for w in WIRE.values():
        with pytest.raises(ValueError, match="CRC"):
            w.decode_message_set(bytes(bad))


class _Recording:
    """A socket that keeps every byte it sends and receives."""

    def __init__(self, sock, log):
        self._sock, self._log = sock, log

    def sendall(self, data):
        self._log.append(("out", bytes(data)))
        return self._sock.sendall(data)

    def recv(self, n):
        data = self._sock.recv(n)
        self._log.append(("in", data))
        return data

    def __getattr__(self, name):
        return getattr(self._sock, name)


class _RecordingSocketModule:
    def __init__(self, log):
        self._log = log

    def create_connection(self, *a, **kw):
        return _Recording(socket.create_connection(*a, **kw), self._log)

    def __getattr__(self, name):
        return getattr(socket, name)


def _kafka_script(client_wire, broker, monkeypatch):
    log = []
    monkeypatch.setattr(client_wire, "socket", _RecordingSocketModule(log))
    c = client_wire.MinimalKafkaClient("127.0.0.1", broker.port, "events")
    try:
        offs = [c.produce(b"k%d" % i, b"v%d" % i * (i + 1))
                for i in range(6)]
        got = [c.fetch(0), c.fetch(4), c.fetch_offset("g1")]
        c.commit_offset("g1", 3)
        got += [c.fetch_offset("g1"), c.fetch(3, max_bytes=40)]
        other = client_wire.MinimalKafkaClient("127.0.0.1", broker.port,
                                               "other")
        got.append(other.fetch(0))
        other.close()
    finally:
        c.close()
        monkeypatch.undo()
    sent = b"".join(d for way, d in log if way == "out")
    received = b"".join(d for way, d in log if way == "in")
    return offs, got, sent, received


@pytest.mark.parametrize("pair", ["jax-jax", "port-port", "port-jax",
                                  "jax-port"])
def test_kafka_frames_equal_jax(pair, monkeypatch):
    client_pkg, broker_pkg = pair.split("-")
    out = {}
    for name, (cw, bw) in (("ref", (j_wire, j_wire)),
                           ("run", (WIRE[client_pkg], WIRE[broker_pkg]))):
        broker = bw.StubBroker()
        try:
            out[name] = _kafka_script(cw, broker, monkeypatch)
        finally:
            broker.close()
    assert out["run"] == out["ref"]
    offs, got, sent, _ = out["run"]
    assert offs == list(range(6))
    assert got[2] == -1 and got[3] == 3
    assert [o for o, _, _ in got[1]] == [4, 5] and got[5] == []
    assert sent.count(b"events") == 12  # one frame per request


_TOMLS = {
    "none": "",
    "log": "[notification.log]\nenabled = true\n",
    "file": '[notification.file]\nenabled = true\npath = "{dir}/ev.jsonl"\n',
    "kafka": ('[notification.kafka]\nenabled = true\n'
              'hosts = "127.0.0.1:{port}"\ntopic = "seaweed-events"\n'),
}


@pytest.mark.parametrize("kind", list(_TOMLS))
def test_config_selects_the_same_sink(kind, tmp_path):
    if t_config.tomllib is None:
        pytest.skip("no tomllib on this interpreter")
    broker = t_wire.StubBroker()
    try:
        text = _TOMLS[kind].format(dir=tmp_path, port=broker.port)
        out = {}
        for pkg in NOTIFY:
            conf = CONFIG[pkg].Configuration(CONFIG[pkg].tomllib.loads(text))
            q = NOTIFY[pkg].load_notification_queue(conf)
            qin = NOTIFY[pkg].load_notification_input(conf)
            out[pkg] = (q and q.name, qin and qin.name)
            if q is not None:
                q.send("/a/b.txt", {"ts_ns": 1, "new_entry": {"n": pkg}})
                q.close()
            if qin is not None:
                qin.close()
        assert out["port"] == out["jax"]
        if kind == "kafka":
            assert broker.message_count("seaweed-events") == 2
    finally:
        broker.close()
    assert out["port"] == {"none": (None, None), "log": ("log", None),
                           "file": ("file", "file"),
                           "kafka": ("kafka", "kafka")}[kind]


def _filer_events(pkg, queue):
    ns = PKG[pkg]
    f = ns.filer.Filer()
    f.notification_queue = queue
    E, A = ns.entry.Entry, ns.entry.Attr
    f.create_entry(E(full_path="/n/a.txt", attr=A(file_size=1),
                     content=b"a"))
    f.create_entry(E(full_path="/n/b.txt", attr=A(file_size=1),
                     content=b"b"))
    f.rename("/n/a.txt", "/n/c.txt")
    f.delete_entry("/n/b.txt")
    return f.subscribe_metadata(0)


def test_file_sink_and_input_like_jax(tmp_path, monkeypatch):
    lines, consumed = {}, {}
    for pkg in PKG:
        pin_clocks(monkeypatch, pkg)
        path = str(tmp_path / f"{pkg}.jsonl")
        q = NOTIFY[pkg].FileQueue(path)
        events = _filer_events(pkg, q)
        with open(path) as f:
            lines[pkg] = f.read()
        qin = NOTIFY[pkg].FileQueueInput(path)
        got = []
        while (msg := qin.receive_message()) is not None:
            got.append(msg)
            if len(got) == 2:
                break  # two read, only the first acked
            qin.ack()
        again = NOTIFY[pkg].FileQueueInput(path).receive_message()
        consumed[pkg] = (got, again, len(events))
    assert lines["port"] == lines["jax"]
    assert consumed["port"] == consumed["jax"]
    got, again, n = consumed["port"]
    assert len(lines["port"].splitlines()) == n == 5
    assert again == got[1]  # the unacked message is read again


def test_kafka_queue_and_input_carry_filer_events(monkeypatch):
    """A port filer's events through the port's kafka queue to a JAX
    broker, read back by the port's input with manual commits, equal to
    the JAX queue's on its own broker."""
    out = {}
    for pkg, broker_wire in (("jax", j_wire), ("port", j_wire)):
        pin_clocks(monkeypatch, pkg)
        broker = broker_wire.StubBroker()
        try:
            hosts = [f"127.0.0.1:{broker.port}"]
            q = NOTIFY[pkg].KafkaQueue(hosts, "fevents")
            events = _filer_events(pkg, q)
            q.close()
            qin = NOTIFY[pkg].KafkaQueueInput(hosts, "fevents")
            first = [qin.receive_message() for _ in range(3)]
            qin.ack()
            qin.close()
            resumed = NOTIFY[pkg].KafkaQueueInput(hosts, "fevents")
            rest = []
            while (msg := resumed.receive_message()) is not None:
                rest.append(msg)
            resumed.close()
            out[pkg] = (first, rest, events)
        finally:
            broker.close()
    assert json.dumps(out["port"]) == json.dumps(out["jax"])
    first, rest, events = out["port"]
    assert [k for k, _ in first + rest] == [
        "/n", "/n/a.txt", "/n/b.txt", "/n/c.txt", "/n/b.txt"]
    assert [e for _, e in first + rest] == events
