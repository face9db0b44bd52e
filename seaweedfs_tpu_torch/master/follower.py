"""Master follower: a read-optimized lookup/assign cache node.

Parity with weed/command/master_follower.go: a process that keeps a
vid→locations cache warm from the true masters' update stream, answers
/dir/lookup locally, and forwards /dir/assign to the leader.  Useful to
fan out read lookups in large clusters without raft participation.

The port's own copy of seaweedfs_tpu/master/follower.py.
"""

from __future__ import annotations

import urllib.parse
from typing import Optional

from ..rpc.http_rpc import RpcError, RpcServer, call
from ..wdclient import MasterClient


class MasterFollower:
    def __init__(self, masters: list[str], host: str = "127.0.0.1",
                 port: int = 0):
        self.client = MasterClient(masters, name="master_follower")
        self.server = RpcServer(host, port)
        s = self.server
        s.add("GET", "/dir/lookup", self._handle_lookup)
        s.add("GET", "/dir/assign", self._handle_assign)
        s.add("POST", "/dir/assign", self._handle_assign)
        s.add("GET", "/cluster/status", self._handle_status)

    @property
    def address(self) -> str:
        return self.server.address

    def start(self):
        self.client.start()
        self.server.start()

    def stop(self):
        self.client.stop()
        self.server.stop()

    def _handle_lookup(self, req):
        vid_s = req.param("volumeId")
        if vid_s is None:
            file_id = req.param("fileId")
            if not file_id:
                raise RpcError("volumeId or fileId required", 400)
            vid_s = file_id.split(",")[0]
        vid = int(vid_s.split(",")[0])
        locations = self.client.lookup(vid)
        if not locations:
            raise RpcError(f"volume id {vid} not found", 404)
        return {"volumeId": str(vid), "locations": locations}

    def _handle_assign(self, req):
        query = urllib.parse.urlencode(req.query)
        return call(self.client.current_master,
                    "/dir/assign" + ("?" + query if query else ""),
                    timeout=30)

    def _handle_status(self, req):
        return {"IsLeader": False, "Follower": True,
                "Masters": self.client.masters,
                "CachedVolumes": len(self.client.vid_map)}
