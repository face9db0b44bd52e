"""External metadata-event notification (weed/notification).

The reference publishes every filer EventNotification to an optional
message queue configured in notification.toml (kafka or log
sinks; notification/configuration.go:9-40).  Same surface here: a
NotificationQueue receives (key, event-dict) pairs from the filer's
change log; implementations are a glog sink, a JSON-lines file sink, and
a kafka sink.

The port's own copy of seaweedfs_tpu/notification/__init__.py.  Its
kafka sink and input always speak through the repo's own v0-protocol
client (kafka_wire.py), the reference's path when no kafka client
library is installed: the port depends on no client library.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ..util import glog


class NotificationQueue:
    name = "none"

    def send(self, key: str, event: dict):
        raise NotImplementedError

    def close(self):
        pass


class LogQueue(NotificationQueue):
    """notification.log sink: events to the process log."""

    name = "log"

    def send(self, key: str, event: dict):
        glog.v(1).infof("notify %s: %s", key, json.dumps(event))


class FileQueue(NotificationQueue):
    """JSON-lines events appended to a file (useful stand-in for an
    external queue in air-gapped deployments)."""

    name = "file"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def send(self, key: str, event: dict):
        line = json.dumps({"key": key, **event})
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")


class KafkaQueue(NotificationQueue):
    """notification.kafka sink (kafka_queue.go:1-100) over the in-repo
    minimal v0-protocol client (notification/kafka_wire.py): single
    broker, partition 0."""

    name = "kafka"

    def __init__(self, hosts: list[str], topic: str):
        from .kafka_wire import MinimalKafkaClient

        self.topic = topic
        host, _, port = hosts[0].partition(":")
        self._minimal = MinimalKafkaClient(host, int(port or 9092), topic)

    def send(self, key: str, event: dict):
        self._minimal.produce(key.encode(), json.dumps(event).encode())

    def close(self):
        self._minimal.close()


def load_notification_queue(conf) -> Optional[NotificationQueue]:
    """Build the configured sink from notification.toml
    (configuration.go LoadConfiguration)."""
    if conf is None:
        return None
    if conf.get_bool("notification.log.enabled"):
        return LogQueue()
    if conf.get_bool("notification.file.enabled"):
        return FileQueue(str(conf.get("notification.file.path",
                                      "filer_events.jsonl")))
    if conf.get_bool("notification.kafka.enabled"):
        hosts = str(conf.get("notification.kafka.hosts",
                             "localhost:9092")).split(",")
        topic = str(conf.get("notification.kafka.topic", "seaweedfs"))
        return KafkaQueue(hosts, topic)
    return None


# -- notification INPUTS (weed/replication/sub): the consumer half ----------
# `weed filer.replicate` reads events back OUT of the queue and applies
# them through replication/replicator.py — the MQ-driven replication mode
# (command/filer_replication.go:24-100), vs filer.sync's direct
# subscribe-driven mode.


class NotificationInput:
    """Consumer interface (sub.NotificationInput): receive_message
    returns (key, event) or None when the queue is drained; ack()
    persists consumption so restarts resume where they left off."""

    name = "none"

    def receive_message(self) -> Optional[tuple[str, dict]]:
        raise NotImplementedError

    def ack(self):
        pass

    def close(self):
        pass


class FileQueueInput(NotificationInput):
    """Tail the FileQueue's JSON-lines file with a durable byte offset —
    the consumer half of the air-gapped queue stand-in."""

    name = "file"

    def __init__(self, path: str, offset_path: Optional[str] = None):
        self.path = path
        self.offset_path = offset_path or path + ".offset"
        self._offset = 0
        try:
            with open(self.offset_path) as f:
                self._offset = int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            pass
        self._pending: Optional[int] = None  # offset after unacked msg

    def receive_message(self) -> Optional[tuple[str, dict]]:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                line = f.readline()
        except FileNotFoundError:
            return None
        if not line or not line.endswith(b"\n"):
            return None  # nothing new / torn tail write — retry later
        self._pending = self._offset + len(line)
        record = json.loads(line)
        key = record.pop("key", "")
        return key, record

    def ack(self):
        if self._pending is None:
            return
        self._offset = self._pending
        self._pending = None
        with open(self.offset_path, "w") as f:
            f.write(str(self._offset))


class KafkaQueueInput(NotificationInput):
    """Kafka consumer input over the in-repo minimal v0-protocol client
    with manual-commit semantics (ack() persists the consumed offset to
    the broker's group-offset table; a restarted consumer resumes after
    the last acked message, replaying unacked ones)."""

    name = "kafka"

    def __init__(self, hosts: list[str], topic: str,
                 group: str = "seaweedfs-replicate"):
        from .kafka_wire import MinimalKafkaClient

        self.group = group
        host, _, port = hosts[0].partition(":")
        self._minimal = MinimalKafkaClient(host, int(port or 9092), topic)
        committed = self._minimal.fetch_offset(group)
        self._next = committed if committed >= 0 else 0
        self._pending: Optional[int] = None

    def receive_message(self) -> Optional[tuple[str, dict]]:
        msgs = self._minimal.fetch(self._next)
        if not msgs:
            return None
        offset, key, value = msgs[0]
        self._pending = offset + 1
        self._next = offset + 1
        return key.decode(), json.loads(value)

    def ack(self):
        if self._pending is not None:
            self._minimal.commit_offset(self.group, self._pending)
            self._pending = None

    def close(self):
        self._minimal.close()


def load_notification_input(conf) -> Optional[NotificationInput]:
    """Consumer counterpart of load_notification_queue."""
    if conf is None:
        return None
    if conf.get_bool("notification.file.enabled"):
        path = str(conf.get("notification.file.path",
                            "filer_events.jsonl"))
        return FileQueueInput(path)
    if conf.get_bool("notification.kafka.enabled"):
        hosts = str(conf.get("notification.kafka.hosts",
                             "localhost:9092")).split(",")
        topic = str(conf.get("notification.kafka.topic", "seaweedfs"))
        return KafkaQueueInput(hosts, topic)
    return None
