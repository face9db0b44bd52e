"""The schedule is a function of the seed, every seed does the same work
in another order, and a load process times each request from its due
time."""

from __future__ import annotations

import http.server
import json
import os
import subprocess
import sys
import threading
import time

from ecbench import schedule, spec


def test_open_loop_is_deterministic_per_seed():
    a = schedule.open_loop(200, 2.0, 500, 0.99, 2 ** 31 + 11, "window", 3.0)
    b = schedule.open_loop(200, 2.0, 500, 0.99, 2 ** 31 + 11, "window", 3.0)
    assert a == b and len(a) == 400
    assert all(3.0 < due < 5.0 for due, _ in a)
    assert [d for d, _ in a] == sorted(d for d, _ in a)


def test_seeds_permute_the_same_work():
    a = schedule.open_loop(100, 1.0, 300, 0.99, 1, "window")
    b = schedule.open_loop(100, 1.0, 300, 0.99, 2, "window")
    assert a != b
    assert sorted(r for _, r in a) == sorted(r for _, r in b)
    gaps = [sorted(round(y - x, 12) for x, y in zip(
        [0.0] + [d for d, _ in s][:-1], [d for d, _ in s])) for s in (a, b)]
    assert gaps[0] == gaps[1]


def test_zipf_copy_is_deterministic_and_skewed():
    z = schedule.ZipfPopularity(1000, 0.99, seed=5)
    draws = [z.sample(i) for i in range(2000)]
    assert draws == [z.sample(i) for i in range(2000)]
    assert draws.count(0) > draws.count(500) + 20


class _Slow(http.server.BaseHTTPRequestHandler):
    first = threading.Event()
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        if not _Slow.first.is_set():
            _Slow.first.set()
            time.sleep(0.4)
        body = self.path.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("ETag", '"x"')
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_loader_times_from_the_due_time(tmp_path):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        out = tmp_path / "out.json"
        sp = {"endpoint": "127.0.0.1:%d" % srv.server_port,
              "conns": 1, "out": str(out),
              "requests": [[0, 0.0, "GET", "/a"], [1, 0.05, "GET", "/b"],
                           [2, 0.1, "GET", "/c"]]}
        (tmp_path / "spec.json").write_text(json.dumps(sp))
        p = subprocess.Popen([sys.executable,
                              os.path.join(spec.HERE, "loader.py"),
                              str(tmp_path / "spec.json")],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
        assert p.stdout.readline().strip() == "ready"
        p.stdin.write("go %r\n" % (time.monotonic() + 0.1))
        p.stdin.flush()
        assert p.wait(timeout=30) == 0
    finally:
        srv.shutdown()
    recs = {r[0]: r for r in json.loads(out.read_text())}
    assert sorted(recs) == [0, 1, 2]
    # one connection: /b and /c queue behind the stalled /a, and their
    # latency (done - due) carries that wait; `sent` shows the lateness
    for k in (1, 2):
        index, due, sent, done, status, nbytes, digest, etag = recs[k]
        assert status == 200 and etag == "x"
        assert sent - due > 0.25
        assert done - due > 0.25
