"""One load process: replays the requests its spec file lists.

    python3 ecbench/loader.py SPEC.json

Standard library only: it imports neither torch nor the system under
test, and it is started as a fresh interpreter (never forked from a
process that holds a CUDA context).  It prints "ready" once its
connections' threads are up, reads "go T0" from stdin, where T0 is a
time.monotonic() reading (one clock for every process of the host), and
from then on hands every request of `requests` ([index, due offset,
method, path]) to a free one of its `conns` connections at T0 + due.  The
dispatcher never waits for a reply, so a stall shows as queueing: latency
runs from the due time, and `sent` says how late the generator ran (the
open loop).

Each reply is hashed (BLAKE2b-128 of the body); the harness compares the
hashes with the payloads it made.  The records go to the spec's `out` as
JSON: [index, due, sent, done, status, bytes, digest, etag], times in
seconds after T0.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import queue
import sys
import threading
import time


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    host, port = spec["endpoint"].split(":")
    records, lock = [], threading.Lock()
    local = threading.local()

    def fetch(method: str, path: str) -> tuple:
        for attempt in (0, 1):  # a kept-alive connection the server closed
            if getattr(local, "conn", None) is None:
                local.conn = http.client.HTTPConnection(
                    host, int(port), timeout=spec.get("timeout", 120))
            try:
                local.conn.request(method, path)
                resp = local.conn.getresponse()
                body = resp.read()
                etag = (resp.getheader("ETag") or "").strip('"')
                return resp.status, body, etag
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                local.conn.close()
                local.conn = None
                if attempt:
                    raise

    def one(index: int, due: float, method: str, path: str, t0: float):
        sent = time.monotonic() - t0
        try:
            status, body, etag = fetch(method, path)
            digest = hashlib.blake2b(body, digest_size=16).hexdigest()
            nbytes = len(body)
        except OSError as e:  # recorded; the harness counts it as failed
            status, digest, nbytes, etag = 0, repr(e)[:200], 0, ""
        done = time.monotonic() - t0
        with lock:
            records.append([index, due, sent, done, status, nbytes, digest,
                            etag])

    conns = spec["conns"]
    go = threading.Event()
    t0_box = []
    work: queue.Queue = queue.Queue()

    def worker():
        go.wait()
        while True:
            item = work.get()
            if item is None:
                return
            one(*item, t0_box[0])

    threads = [threading.Thread(target=worker) for _ in range(conns)]
    for t in threads:
        t.start()
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        go.set()
        for _ in threads:
            work.put(None)
        return 2
    t0_box.append(float(line[1]))
    go.set()
    t0 = t0_box[0]
    for index, due, method, path in spec["requests"]:
        wait = t0 + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        work.put((index, due, method, path))
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join()
    with open(spec["out"], "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
