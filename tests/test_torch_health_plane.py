"""The port's health plane against the JAX package's.

- TSDB: the same seeded expositions go into both packages' `Tsdb` on one
  fake clock; `latest`, `avg`, `delta` (across a counter reset),
  retention laps, the cardinality cap with priority families, the
  self-family refusal, `histogram_window` and `quantile` agree.
- SLO: both `SloEngine`s over the same liveness and latency series on
  one fake clock give equal `evaluate()` dicts, fire and clear
  transitions and journal kinds; `parse_rules` gives equal rules.
- Lint: both lints find no problem in the repo's dashboard and the same
  problems in a broken one.
- Node death: a master and two volume servers of each package; each
  master's `HealthPlane.scrape_round()` is driven by hand with its clock
  pinned (its thread is stopped), while one volume server is stopped and
  then restarted on its port.  The journal orders NODE_DOWN <
  ALERT_FIRE < ALERT_CLEAR, and `/cluster/health`, `/cluster/alerts`,
  `/cluster/usage` and `/cluster/events` answer alike at every round
  (addresses named by role; the TSDB's series count, the duty, event
  sequence numbers and times, and the tail of the process-wide journal
  that `/cluster/health` carries are each process's own).
- Mixed clusters: a JAX master's plane scraping port volume servers and a
  port master's plane scraping JAX ones see every target up.
Tolerance: equality throughout (quantiles to 1e-12).
"""

import json

import numpy as np
import pytest

from seaweedfs_tpu.master import server as j_server
from seaweedfs_tpu.rpc.http_rpc import call as j_call
from seaweedfs_tpu.stats import events as j_events
from seaweedfs_tpu.stats import lint as j_lint
from seaweedfs_tpu.stats import slo as j_slo
from seaweedfs_tpu.stats import tsdb as j_tsdb
from seaweedfs_tpu.volume_server import server as j_vs
from seaweedfs_tpu_torch.master import server as t_server
from seaweedfs_tpu_torch.rpc.http_rpc import call as t_call
from seaweedfs_tpu_torch.stats import events as t_events
from seaweedfs_tpu_torch.stats import lint as t_lint
from seaweedfs_tpu_torch.stats import slo as t_slo
from seaweedfs_tpu_torch.stats import tsdb as t_tsdb
from seaweedfs_tpu_torch.volume_server import server as t_vs

PKGS = {"jax": (j_tsdb, j_slo, j_events), "port": (t_tsdb, t_slo, t_events)}


def _expositions(seed: int, rounds: int) -> list:
    """`rounds` seeded expositions per target: gauges, counters (one of
    them reset halfway), a histogram, and the leader's own families."""
    rng = np.random.default_rng(seed)
    out = []
    counters = {t: 0 for t in range(3)}
    hist = {t: [0, 0, 0] for t in range(3)}
    for r in range(rounds):
        for t in range(3):
            if r == rounds // 2 and t == 1:
                counters[t] = 0  # the daemon restarted
            counters[t] += int(rng.integers(0, 50))
            inc = rng.integers(0, 20, 3)
            hist[t] = [hist[t][0] + int(inc[0]),
                       hist[t][0] + int(inc[0]) + hist[t][1] + int(inc[1]),
                       0]
            hist[t][2] = hist[t][1] + int(inc[2])
            lines = [
                "# TYPE SeaweedFS_demo_up gauge",
                f'SeaweedFS_demo_up{{kind="volume"}} {int(rng.integers(0, 2))}',
                "# TYPE SeaweedFS_demo_load gauge",
                f'SeaweedFS_demo_load{{disk="a"}} {rng.random():.6f}',
                f'SeaweedFS_demo_load{{disk="b"}} {rng.random():.6f}',
                "# TYPE SeaweedFS_demo_total counter",
                f'SeaweedFS_demo_total{{op="get"}} {counters[t]}',
                "# TYPE SeaweedFS_demo_seconds histogram",
                f'SeaweedFS_demo_seconds_bucket{{le="0.1"}} {hist[t][0]}',
                f'SeaweedFS_demo_seconds_bucket{{le="0.5"}} {hist[t][1]}',
                f'SeaweedFS_demo_seconds_bucket{{le="+Inf"}} {hist[t][2]}',
                f"SeaweedFS_demo_seconds_count {hist[t][2]}",
                "# TYPE SeaweedFS_cluster_target_up gauge",
                'SeaweedFS_cluster_target_up{target="dead:1"} 0',
            ]
            out.append((r, f"10.0.0.{t}:8080", "\n".join(lines) + "\n"))
    return out


def _tsdb_answers(tsdb, interval=1.0, priority=None, seed=3, rounds=30):
    clock = [5000.0]
    db = tsdb.Tsdb(interval=interval, now=lambda: clock[0])
    answers = []
    last = -1
    for r, target, text in _expositions(seed, rounds):
        if r != last:
            clock[0] += interval
            last = r
        db.ingest(target, text, priority=priority)
        if r % 5 == 4:
            answers.append((
                {json.dumps(sorted(k)): v for k, v in
                 db.latest("SeaweedFS_demo_load").items()},
                db.avg("SeaweedFS_demo_up", 10.0),
                db.avg("SeaweedFS_demo_load", 60.0, match={"disk": "b"}),
                db.avg("SeaweedFS_demo_up", 10.0, match={"kind": "x"}),
                db.delta("SeaweedFS_demo_total", 60.0),
                db.delta("SeaweedFS_demo_total", 7.0,
                         match={"target": "10.0.0.1:8080"}),
                db.histogram_window("SeaweedFS_demo_seconds", 8.0),
                sorted(db.families()), db.dropped, db.stats()))
    buckets, count = db.histogram_window("SeaweedFS_demo_seconds", 60.0)
    answers.append([tsdb.quantile(buckets, count, q)
                    for q in (0.1, 0.5, 0.9, 0.99, 1.0)])
    return answers


def test_tsdb_queries_like_jax():
    """Seeded expositions of three targets over 30 rounds, one counter
    reset: every query and the families equal."""
    jax, port = _tsdb_answers(j_tsdb), _tsdb_answers(t_tsdb)
    assert port[:-1] == jax[:-1]
    assert port[-1] == pytest.approx(jax[-1], rel=1e-12)


def test_counter_delta_across_a_reset_like_jax():
    for tsdb in (j_tsdb, t_tsdb):
        clock = [0.0]
        db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
        for v in (100.0, 110.0, 5.0, 20.0):
            db.put("SeaweedFS_demo_total", {}, v, tsdb.COUNTER)
            clock[0] += 1
        assert db.delta("SeaweedFS_demo_total", 60.0) == 25.0


def test_retention_laps_like_jax(monkeypatch):
    monkeypatch.setenv("WEED_TSDB_RETENTION", "10")
    windows = []
    for tsdb in (j_tsdb, t_tsdb):
        clock = [0.0]
        db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
        got = []
        for step in (0.0, 3.0, 9.0, 100.0, 101.5, 250.0):
            clock[0] = step
            db.put("SeaweedFS_demo", {}, step)
            (ring,) = db.series.values()
            got.append(ring.window(clock[0], 1000.0))
        windows.append(got)
    assert windows[1] == windows[0]
    assert windows[0][3] == [(100.0, 100.0)]


def test_cardinality_cap_with_priority_families_like_jax(monkeypatch):
    monkeypatch.setenv("WEED_TSDB_MAX_SERIES", "16")
    out = []
    for tsdb in (j_tsdb, t_tsdb):
        db = tsdb.Tsdb(interval=1.0, now=lambda: 0.0)
        lines = ["# TYPE SeaweedFS_filler gauge"]
        lines += [f'SeaweedFS_filler{{i="{i}"}} 1' for i in range(40)]
        lines += ["# TYPE SeaweedFS_vip_seconds histogram",
                  'SeaweedFS_vip_seconds_bucket{le="+Inf"} 3',
                  "SeaweedFS_vip_seconds_count 3"]
        db.ingest("t", "\n".join(lines) + "\n",
                  priority={"SeaweedFS_vip_seconds"})
        out.append((sorted(db.families()), db.dropped, len(db.series),
                    sorted(json.dumps(sorted(k[1])) for k in db.series)))
    assert out[1] == out[0]
    assert "SeaweedFS_vip_seconds_count" in out[0][0] and out[0][1] > 0


def test_self_family_refusal_like_jax():
    text = ("# TYPE SeaweedFS_cluster_target_up gauge\n"
            'SeaweedFS_cluster_target_up{target="dead:1"} 0\n'
            "# TYPE SeaweedFS_cluster_slo_burn_rate gauge\n"
            'SeaweedFS_cluster_slo_burn_rate{rule="a"} 300\n'
            "# TYPE SeaweedFS_demo_up gauge\n"
            "SeaweedFS_demo_up 1\n")
    fams = []
    for tsdb in (j_tsdb, t_tsdb):
        db = tsdb.Tsdb(interval=1.0, now=lambda: 0.0)
        db.ingest("127.0.0.1:9333", text)
        fams.append(db.families())
    assert fams[1] == fams[0] == {"SeaweedFS_demo_up"}


def test_histogram_window_and_quantile_like_jax():
    rng = np.random.default_rng(11)
    counts = np.cumsum(rng.integers(0, 40, (12, 4)), axis=0)
    out = []
    for tsdb in (j_tsdb, t_tsdb):
        clock = [0.0]
        db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
        fam = "SeaweedFS_demo_seconds"
        got = []
        for t, row in enumerate(counts):
            clock[0] = float(t)
            cum = np.cumsum(row)
            for le, v in zip(("0.01", "0.1", "0.5", "+Inf"), cum):
                db.put(fam + "_bucket", {"le": le}, float(v), tsdb.COUNTER)
            db.put(fam + "_count", {}, float(cum[-1]), tsdb.COUNTER)
            buckets, count = db.histogram_window(fam, 5.0)
            got.append((buckets, count,
                        [tsdb.quantile(buckets, count, q)
                         for q in (0.25, 0.5, 0.99)]))
        out.append(got)
    for j, t in zip(*out):
        assert t[:2] == j[:2]
        assert t[2] == pytest.approx(j[2], rel=1e-12)


# -- SLO engines on one fake clock -------------------------------------------


def _slo_run(pkg, monkeypatch, downs):
    """Feed liveness of targets a..c, `downs[i]` the set down in second
    i, and evaluate every second."""
    tsdb, slo, events = PKGS[pkg]
    monkeypatch.setenv("WEED_SLO_FAST_S", "10")
    monkeypatch.setenv("WEED_SLO_SLOW_S", "60")
    clock = [10000.0]
    db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
    transitions = []
    eng = slo.SloEngine(
        db, rules=[slo.Rule("availability", "availability",
                            slo.LIVENESS_FAMILY, objective=0.999)],
        now=lambda: clock[0],
        on_transition=lambda r, a, f: transitions.append((r.name, f)),
        journal=events.EventJournal(now=lambda: clock[0]))
    evals = []
    for down in downs:
        for target in "abc":
            db.put(slo.LIVENESS_FAMILY, {"target": target, "kind": "volume"},
                   0.0 if target in down else 1.0)
        clock[0] += 1.0
        evals.append(eng.evaluate())
    kinds = [(e["kind"], e["node"]) for e in eng.journal.since(0)]
    return evals, transitions, kinds, eng.firing()


def test_availability_fire_and_clear_like_jax(monkeypatch):
    rng = np.random.default_rng(5)
    downs = [set() for _ in range(60)] + [{"b"}] * 3 + [set()] * 15
    downs += [set(rng.choice(list("abc"), int(rng.integers(0, 2))))
              for _ in range(40)]
    jax = _slo_run("jax", monkeypatch, downs)
    port = _slo_run("port", monkeypatch, downs)
    assert port == jax
    evals, transitions, kinds, _ = jax
    assert transitions[:2] == [("availability", True),
                               ("availability", False)]
    assert kinds[:2] == [("alert.fire", "availability"),
                         ("alert.clear", "availability")]


def test_a_blip_is_suppressed_like_jax(monkeypatch):
    downs = [set()] * 60 + [{"a"}] + [set()] * 3
    out = {}
    for pkg in PKGS:
        tsdb, slo, events = PKGS[pkg]
        monkeypatch.setenv("WEED_SLO_FAST_S", "10")
        monkeypatch.setenv("WEED_SLO_SLOW_S", "60")
        clock = [100.0]
        db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
        rule = slo.Rule("availability", "availability",
                        slo.LIVENESS_FAMILY, objective=0.999,
                        burn_fast=2.0, burn_slow=50.0)
        eng = slo.SloEngine(db, rules=[rule], now=lambda: clock[0],
                            journal=events.EventJournal(
                                now=lambda: clock[0]))
        got = []
        for down in downs:
            for target in "ab":
                db.put(slo.LIVENESS_FAMILY, {"target": target},
                       0.0 if target in down else 1.0)
            clock[0] += 1.0
            got.append(eng.evaluate())
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert not any(e["availability"]["firing"] for e in out["jax"])


def test_latency_rule_like_jax(monkeypatch):
    rng = np.random.default_rng(9)
    steps = rng.integers(0, 200, (40, 2))
    out = {}
    for pkg in PKGS:
        tsdb, slo, events = PKGS[pkg]
        monkeypatch.setenv("WEED_SLO_FAST_S", "10")
        monkeypatch.setenv("WEED_SLO_SLOW_S", "60")
        clock = [5000.0]
        db = tsdb.Tsdb(interval=1.0, now=lambda: clock[0])
        fam = "SeaweedFS_qos_queue_wait_seconds"
        rule = slo.Rule("p99-int", "latency", fam,
                        match={"class": "interactive"}, objective=0.99,
                        le=0.1, burn_fast=1.5, burn_slow=1.0)
        transitions = []
        eng = slo.SloEngine(
            db, rules=[rule], now=lambda: clock[0],
            on_transition=lambda r, a, f: transitions.append(f),
            journal=events.EventJournal(now=lambda: clock[0]))
        total = fast = 0
        got = []
        for i, (n, slow) in enumerate(steps):
            slow = int(slow) // (8 if i < 20 else 1) % (int(n) + 1)
            total += int(n)
            fast += int(n) - slow
            for le, v in (("0.1", fast), ("+Inf", total)):
                db.put(fam + "_bucket", {"class": "interactive", "le": le},
                       float(v), tsdb.COUNTER)
            db.put(fam + "_count", {"class": "interactive"}, float(total),
                   tsdb.COUNTER)
            clock[0] += 1.0
            got.append(eng.evaluate())
        out[pkg] = (got, transitions)
    assert out["port"] == out["jax"]
    assert True in out["jax"][1]


def _fields(rules):
    return [{k: getattr(r, k) for k in r.__slots__} for r in rules]


def test_parse_rules_round_trips_like_jax(monkeypatch):
    spec = ("p99-get,kind=latency,family=SeaweedFS_demo_seconds,"
            "match.type=get,le=0.1,objective=0.99,burn_fast=2,burn_slow=1"
            "; avail,kind=availability,objective=0.9995"
            "; ,kind=latency; bad,kind=latency,le=oops; worse,kind=nonsense")
    jr, tr = j_slo.parse_rules(spec), t_slo.parse_rules(spec)
    assert _fields(tr) == _fields(jr)
    assert [r.name for r in tr] == ["p99-get", "avail"]
    assert [r.thresholds() for r in tr] == [r.thresholds() for r in jr]
    assert _fields(t_slo.default_rules()) == _fields(j_slo.default_rules())
    monkeypatch.setenv("WEED_SLO_RULES", "only,kind=availability,"
                       "objective=0.99")
    assert _fields(t_slo.active_rules()) == _fields(j_slo.active_rules())
    # a rule's dict form re-parses to the same rule
    spec2 = ";".join(
        f"{r.name},kind={r.kind},family={r.family},objective={r.objective}"
        + (f",le={r.le}" if r.kind == "latency" else "")
        + "".join(f",match.{k}={v}" for k, v in r.match.items())
        for r in tr)
    assert _fields(t_slo.parse_rules(spec2)) == _fields(
        j_slo.parse_rules(spec2))
    assert [r.to_dict() for r in t_slo.parse_rules(spec2)] == \
        [r.to_dict() for r in tr]


# -- lint -------------------------------------------------------------------


def test_lint_of_the_repos_dashboard_like_jax():
    assert t_lint.run() == j_lint.run() == []
    assert t_lint.default_dashboard_path() == j_lint.default_dashboard_path()
    assert t_lint.PINNED_ROWS == j_lint.PINNED_ROWS


def test_lint_of_a_broken_dashboard_like_jax(tmp_path):
    path = tmp_path / "d.json"
    path.write_text(json.dumps({"panels": [
        {"title": "a", "targets": [
            {"expr": "rate(SeaweedFS_nope_total[5m])"},
            {"expr": "SeaweedFS_volumeServer_request_seconds_bucket"}]},
        {"title": "Workload analytics", "type": "row"}]}))
    rules = t_slo.parse_rules("x,kind=latency,family=SeaweedFS_nope;"
                              "y,kind=latency,family=SeaweedFS_build_info")
    jrules = j_slo.parse_rules("x,kind=latency,family=SeaweedFS_nope;"
                               "y,kind=latency,family=SeaweedFS_build_info")
    assert t_lint.lint_dashboard(str(path)) == \
        j_lint.lint_dashboard(str(path))
    assert t_lint.lint_dashboard(str(path))
    assert t_lint.lint_slo_rules(rules) == j_lint.lint_slo_rules(jrules)
    assert len(t_lint.lint_slo_rules(rules)) == 2
    assert t_lint.lint_dashboard(str(tmp_path / "none.json"))[0].endswith(
        "No such file or directory: '%s'" % (tmp_path / "none.json"))


# -- the node death, driven round by round -----------------------------------


_CLUSTER = {"jax": (j_server, j_vs, j_events, j_call, {}),
            "port": (t_server, t_vs, t_events, t_call, {"device": "cpu"})}


def _named(value, names):
    """`value` with every address replaced by its role's name."""
    if isinstance(value, dict):
        return {_named(k, names): _named(v, names) for k, v in value.items()}
    if isinstance(value, list):
        return [_named(v, names) for v in value]
    if isinstance(value, str):
        for addr, name in names.items():
            value = value.replace(addr, name)
    return value


def _answers(call, master, seq0, names):
    health = call(master, "/cluster/health")
    # the process-wide journal's tail holds earlier tests' events too:
    # the scenario's own come from /cluster/events below
    for key in ("now", "tsdb", "events"):
        health.pop(key)
    health["scrape"].pop("duty")
    events = [[e["kind"], e["service"], e["node"], e.get("detail")]
              for e in call(master, f"/cluster/events?since={seq0}")[
                  "events"]]
    out = _named({"health": health,
                  "alerts": call(master, "/cluster/alerts"),
                  "usage": call(master, "/cluster/usage"),
                  "events": events}, names)
    # the usage view lists its daemons in address order
    out["usage"]["nodes"].sort()
    return out


def _node_death(pkg, tmp_path, monkeypatch):
    server, vs_mod, events, call, kw = _CLUSTER[pkg]
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.setenv("WEED_HEALTH_SCRAPE_MS", "1000")
    monkeypatch.setenv("WEED_SLO_FAST_S", "2")
    monkeypatch.setenv("WEED_SLO_SLOW_S", "6")
    # each target's /metrics is its process-wide registry, which grows
    # with every earlier test in the worker; past the default cap of
    # 4,096 series one plane dropped series the other kept, and the two
    # no longer saw the same input.  A cap no registry reaches holds
    # both on it (the dropped count is asserted 0 below).
    monkeypatch.setenv("WEED_TSDB_MAX_SERIES", "1000000")
    root = tmp_path / pkg
    dirs = [root / n for n in ("m", "v0", "v1")]
    for d in dirs:
        d.mkdir(parents=True)
    master = server.MasterServer(port=0, pulse_seconds=60.0,
                                 raft_dir=str(dirs[0]))
    vss = []
    rounds = []
    try:
        master.start()
        plane = master.health
        plane.stop()  # its thread never scrapes: the test drives rounds
        clock = [1.0e6]

        def now():
            return clock[0]

        plane.now = plane.tsdb.now = plane.slo.now = plane.usage.now = now
        for d in dirs[1:]:
            vs = vs_mod.VolumeServer([str(d)], master.address, port=0,
                                     pulse_seconds=60.0, **kw)
            vs.start()
            vs.heartbeat_once()
            vss.append(vs)
        names = {master.address: "<master>", vss[0].address: "<v0>",
                 vss[1].address: "<v1>"}
        seq0 = events.JOURNAL.seq

        def scrape(label, n):
            for _ in range(n):
                plane.scrape_round()
                clock[0] += 1.0
                rounds.append((label, _answers(call, master.address, seq0,
                                               names)))

        scrape("up", 3)
        port_of_v1 = vss[1].server.port
        vss[1].stop()
        scrape("down", 4)
        vss[1] = vs_mod.VolumeServer([str(dirs[2])], master.address,
                                     port=port_of_v1, pulse_seconds=60.0,
                                     **kw)
        vss[1].start()
        vss[1].heartbeat_once()
        scrape("back", 5)
        journal = [e for e in events.JOURNAL.since(seq0)]
        stats = (plane.rounds, plane.tsdb.stats()["series"] > 0,
                 plane.busy_seconds > 0, plane.tsdb.dropped)
    finally:
        for vs in vss:
            vs.stop()
        master.stop()
    return rounds, journal, stats


def test_node_death_journal_and_routes_like_jax(tmp_path, monkeypatch):
    jax, jj, jstats = _node_death("jax", tmp_path, monkeypatch)
    port, tj, tstats = _node_death("port", tmp_path, monkeypatch)
    assert [label for label, _ in port] == [label for label, _ in jax]
    for (label, t), (_, j) in zip(port, jax):
        assert t == j, label
    assert tstats == jstats == (12, True, True, 0)
    # the journal's order: the victim's death, the alert, its clearing
    seqs = {}
    for e in tj:
        if e["kind"] in ("node.down", "alert.fire", "alert.clear"):
            seqs.setdefault(e["kind"], e)
    assert seqs["node.down"]["seq"] < seqs["alert.fire"]["seq"] < \
        seqs["alert.clear"]["seq"]
    assert seqs["alert.fire"]["ts"] - seqs["node.down"]["ts"] <= 10.0
    down = port[3][1]
    assert down["health"]["status"] == "critical"
    assert down["alerts"]["firing"] == ["availability"]
    assert down["health"]["nodes"]["<v1>"]["up"] is False
    last = port[-1][1]
    assert last["health"]["status"] == "ok"
    assert last["alerts"]["firing"] == []
    kinds = [k for k, *_ in last["events"]]
    assert kinds.index("node.down") < kinds.index("alert.fire") < \
        kinds.index("alert.clear")


def test_liveness_claims_a_slot_in_a_full_tsdb(tmp_path, monkeypatch):
    """R7: with the TSDB filled to its cap by ordinary series, a stopped
    target still fires `availability` (the reference's plane drops its
    liveness series at the cap and never sees the death)."""
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.setenv("WEED_HEALTH_SCRAPE_MS", "1000")
    monkeypatch.setenv("WEED_SLO_FAST_S", "2")
    monkeypatch.setenv("WEED_SLO_SLOW_S", "6")
    monkeypatch.setenv("WEED_TSDB_MAX_SERIES", "64")
    dirs = [tmp_path / n for n in ("m", "v0", "v1")]
    for d in dirs:
        d.mkdir()
    master = t_server.MasterServer(port=0, pulse_seconds=60.0,
                                   raft_dir=str(dirs[0]))
    vss = []
    try:
        master.start()
        plane = master.health
        plane.stop()
        clock = [1.0e6]
        plane.now = plane.tsdb.now = plane.slo.now = plane.usage.now = \
            lambda: clock[0]
        for d in dirs[1:]:
            vs = t_vs.VolumeServer([str(d)], master.address, port=0,
                                   pulse_seconds=60.0, device="cpu")
            vs.start()
            vs.heartbeat_once()
            vss.append(vs)
        for i in range(64):
            plane.tsdb.put("SeaweedFS_filler", {"i": str(i)}, 1.0)
        assert len(plane.tsdb.series) == 64
        firing = []
        for step in range(7):
            if step == 2:
                vss[1].stop()
            out = plane.scrape_round()
            clock[0] += 1.0
            firing.append(out["availability"]["firing"])
            assert len(plane.tsdb.series) <= 64
        assert firing[:2] == [False, False] and any(firing[2:])
        live = plane.tsdb.latest(t_slo.LIVENESS_FAMILY)
        assert {dict(k)["target"]: v for k, v in live.items()}[
            vss[1].address] == 0.0
        assert plane.tsdb.dropped > 0
    finally:
        for vs in vss:
            vs.stop()
        master.stop()


@pytest.mark.parametrize("mix", ["jax-master-port-servers",
                                 "port-master-jax-servers"])
def test_mixed_cluster_planes_see_every_target(tmp_path, monkeypatch, mix):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.setenv("WEED_HEALTH_SCRAPE_MS", "1000")
    m_pkg, v_pkg = ("jax", "port") if mix.startswith("jax") else \
        ("port", "jax")
    server, _, _, call, _ = _CLUSTER[m_pkg]
    _, vs_mod, _, _, kw = _CLUSTER[v_pkg]
    (tmp_path / "m").mkdir()
    master = server.MasterServer(port=0, pulse_seconds=60.0,
                                 raft_dir=str(tmp_path / "m"))
    vss = []
    try:
        master.start()
        master.health.stop()
        for i in range(2):
            (tmp_path / f"v{i}").mkdir()
            vs = vs_mod.VolumeServer([str(tmp_path / f"v{i}")],
                                     master.address, port=0,
                                     pulse_seconds=60.0, **kw)
            vs.start()
            vs.heartbeat_once()
            vss.append(vs)
        out = master.health.scrape_round()
        assert out["availability"]["firing"] is False
        health = call(master.address, "/cluster/health")
        assert health["status"] == "ok"
        assert {a: n["up"] for a, n in health["nodes"].items()} == {
            master.address: True, vss[0].address: True,
            vss[1].address: True}
        # each volume server's exposition fed the TSDB
        scraped = {dict(labels).get("target")
                   for fam, labels in master.health.tsdb.series
                   if fam != "SeaweedFS_cluster_target_up"}
        assert {vs.address for vs in vss} <= scraped
        assert call(master.address, "/cluster/usage")["nodes"]
    finally:
        for vs in vss:
            vs.stop()
        master.stop()
