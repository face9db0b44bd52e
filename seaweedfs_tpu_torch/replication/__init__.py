"""Cross-cluster async replication: metadata-log shipping to sinks.

Parity with weed/replication: a Replicator consumes the source filer's
metadata change feed and applies each event to a ReplicationSink
(filer / local / s3), fetching file bytes from the source cluster as
needed (replication/replicator.go:19-70, replication/sink/,
replication/source/filer_source.go).

The port's own copy of seaweedfs_tpu/replication/__init__.py.
"""

from .replicator import Replicator
from .sink import FilerSink, LocalSink, ReplicationSink, S3Sink, make_sink
from .source import FilerSource

__all__ = ["Replicator", "FilerSource", "ReplicationSink", "FilerSink",
           "LocalSink", "S3Sink", "make_sink"]
