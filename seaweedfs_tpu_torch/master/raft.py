"""Raft consensus for the master control plane.

The reference runs hashicorp/raft with a deliberately tiny FSM: the only
replicated state is MaxVolumeId (weed/server/raft_server.go:52-100 — the
FSM's Apply handles one command type, MaxVolumeIdCommand), persisted in
boltdb with snapshots.

This implementation runs the full raft machinery — a persisted replicated
LOG with prev-index/term consistency checks, per-follower next/match
tracking, majority commit, and log-compaction snapshots shipped to
stragglers — over a COMMAND-TYPED FSM (master/fsm.py): volume-id
allocation, topology epochs, every curator queue mutation, and the filer
shard map all commit through quorum before they are acknowledged.  A
failed-over leader on a different node resumes with the exact
pending/leased curator set and never double-allocates an id: propose()
returns only after the entry COMMITS, so a failed quorum leaves the
entry uncommitted and the result unreturned (at-most-once).

Membership is itself replicated state: single-server changes
(add-one/remove-one, the raft dissertation §4.1 simple form) commit as
`raft.config` log entries.  A joining master starts as a non-voting
LEARNER that catches up via snapshot + log replay before being promoted
to voter; removals keep replicating to the departing server until the
entry commits, then the server self-demotes to a single-node observer.
Configurations take effect when APPENDED (not committed), quorums are
counted over voters only, and at most one change may be in flight.

Seams for deterministic testing: `clock` (monotonic source), `rpc`
(peer transport) and `rand` (election jitter) are instance attributes,
so the fuzz suite drives whole clusters in-process on a fake clock with
partitionable transports and zero threads.

The port's own copy of seaweedfs_tpu/master/raft.py.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Optional

from ..rpc.http_rpc import RpcError, call
from ..util import glog
from .fsm import ControlFSM

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

SNAPSHOT_THRESHOLD = 64  # applied entries kept before compaction

# propose() results retained past the commit point, so a proposer that
# lost the race to _advance_commit can still collect its return value
_RESULT_WINDOW = 512


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _upgrade_entry(e: dict) -> dict:
    """Accept pre-command-log persisted entries ({"max_volume_id": N})
    by rewriting them as volume.assign commands."""
    if "cmd" in e:
        return e
    return {"index": int(e["index"]), "term": int(e["term"]),
            "cmd": {"type": "volume.assign",
                    "value": int(e.get("max_volume_id", 0))}}


class RaftNode:
    def __init__(self, self_address: str, peers: list[str],
                 state_dir: str = "",
                 election_timeout: float = 0.8,
                 heartbeat_interval: float = 0.25,
                 clock: Optional[Callable[[], float]] = None,
                 transport: Optional[Callable] = None,
                 fsm: Optional[ControlFSM] = None,
                 learner: bool = False):
        """peers includes self_address (unless `learner`, where peers is
        the existing cluster this node intends to join as a non-voter)."""
        self.address = self_address
        if learner:
            self.voters = sorted(set(peers) - {self_address})
            self.learners = [self_address]
        else:
            self.voters = sorted(set(peers) | {self_address})
            self.learners = []
        # the configuration before any raft.config entry / set_peers
        self._bootstrap_config = {"voters": list(self.voters),
                                  "learners": list(self.learners)}
        self.snapshot_config: Optional[dict] = None
        self.observer = False        # removed from the cluster: passive
        self._expelled: set[str] = set()  # committed-removed addresses
        self._config_index = 0       # log index of the config in force
        # departing peers still owed replication (§4.2.2): address ->
        # remaining post-commit grace rounds before we give up on
        # delivering the committed removal (the campaign-probe +
        # expelled-reply path covers a peer that never hears it)
        self._grace: dict[str, int] = {}
        self._learner_since: dict[str, float] = {}
        self.learner_timeout = _env_float("WEED_RAFT_LEARNER_TIMEOUT", 30.0)
        self.state_dir = state_dir
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.clock = clock or time.monotonic
        self.rpc = transport or call
        self.rand = random.random

        self.lock = threading.RLock()
        self.state = FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader: Optional[str] = None
        self.on_become_leader: Optional[Callable[[], None]] = None
        self.on_step_down: Optional[Callable[[], None]] = None
        # committed membership changes (leader-side event seam)
        self.on_membership: Optional[Callable[[dict], None]] = None

        # -- replicated log + snapshot (boltdb store analogue) ---------------
        # entry: {"index": i, "term": t, "cmd": {...}}; the entry at
        # global index i lives at log[i - snapshot_index - 1]
        self.fsm = fsm or ControlFSM()
        self.log: list[dict] = []
        self.snapshot_index = 0
        self.snapshot_term = 0
        self.snapshot_fsm: dict = {}  # FSM snapshot at the compaction point
        self.commit_index = 0
        self.applied_index = 0
        self._apply_results: dict[int, object] = {}
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        # leader lease: the last instant a quorum acknowledged this
        # leader; clients treat the hinted leader as fresh within it
        self._lease_until = 0.0

        self._last_heard = self.clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._peers_persisted = False
        self._load_state()
        self._sync_metrics()
        if len(self.peers) > 1 and not self.state_dir:
            # raft safety requires durable term/vote: a restarted node with
            # amnesia can double-vote in one term and elect two leaders
            glog.warningf(
                "raft: %d-peer cluster without -mdir: term/vote/log state "
                "is NOT persisted; a master restart can elect split leaders",
                len(self.peers))

    # -- membership views -----------------------------------------------------
    @property
    def peers(self) -> list[str]:
        """Every cluster member, voting or not (the operator/health view;
        quorum math uses `voters` only)."""
        return sorted(set(self.voters) | set(self.learners))

    def _known(self) -> set:
        return set(self.voters) | set(self.learners)

    # -- FSM views -----------------------------------------------------------
    @property
    def max_volume_id(self) -> int:
        return self.fsm.max_volume_id

    # -- log helpers (lock held) ----------------------------------------------
    def _last_index(self) -> int:
        return self.snapshot_index + len(self.log)

    def _last_term(self) -> int:
        return self.log[-1]["term"] if self.log else self.snapshot_term

    def _entry(self, index: int) -> Optional[dict]:
        k = index - self.snapshot_index - 1
        if 0 <= k < len(self.log):
            return self.log[k]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == self.snapshot_index:
            return self.snapshot_term
        e = self._entry(index)
        return e["term"] if e else None

    def _pending_value(self) -> int:
        """Highest MaxVolumeId anywhere in the log (committed or not) —
        the allocation floor, so concurrent/unacked entries never collide."""
        value = self.fsm.max_volume_id
        for e in self.log:
            cmd = e["cmd"]
            if cmd.get("type") == "volume.assign" \
                    and int(cmd.get("value", 0)) > value:
                value = int(cmd["value"])
        return value

    # -- configuration from the log (lock held) --------------------------------
    def _config_at(self, index: int) -> tuple[dict, int]:
        """The configuration in force at `index`: the last raft.config
        entry at or below it, else the snapshot's, else bootstrap."""
        for e in reversed(self.log):
            if e["index"] > index:
                continue
            if e["cmd"].get("type") == "raft.config":
                return e["cmd"], e["index"]
        if self.snapshot_config is not None:
            return self.snapshot_config, self.snapshot_index
        return self._bootstrap_config, 0

    def _refresh_config(self):
        """Adopt the latest configuration in the log.  Config entries
        take effect when APPENDED (raft §4.1) — truncating one reverts
        just as mechanically."""
        cfg, cfg_index = self._config_at(self._last_index())
        voters = sorted(set(cfg.get("voters") or []))
        learners = sorted(set(cfg.get("learners") or []))
        known = set(voters) | set(learners)
        if self.address in known:
            self.observer = False
            self._expelled.discard(self.address)
        elif self.observer:
            # a demoted observer keeps its standalone view until some
            # future configuration re-admits it
            voters, learners = [self.address], []
        self._expelled -= known
        for a in known:
            self._grace.pop(a, None)
        self.voters = voters
        self.learners = learners
        self._config_index = cfg_index
        now = self.clock()
        for a in learners:
            self._learner_since.setdefault(a, now)
        for a in [a for a in self._learner_since if a not in learners]:
            del self._learner_since[a]

    def _on_config_committed(self, e: dict):
        """Commit-time effects of a raft.config entry (lock held): mark
        explicit removals expelled (so a stale campaigner gets told),
        self-demote when the committed config excludes us, and surface
        the change to the membership event seam on the leader."""
        cmd = e["cmd"]
        known = set(cmd.get("voters") or []) | set(cmd.get("learners") or [])
        addr = cmd.get("address", "")
        if addr and addr not in known:
            if addr == self.address:
                self._demote()
            else:
                self._expelled.add(addr)
                if self.state == LEADER:
                    # keep replicating to the departing server for a few
                    # more rounds so it learns its removal committed
                    self._grace.setdefault(addr, 8)
        self._expelled -= known
        if self.state == LEADER and self.on_membership is not None:
            try:
                self.on_membership(dict(cmd, index=e["index"]))
            except Exception:
                pass  # event plumbing must never wedge consensus

    def _demote(self):
        """Become a single-node observer: the cluster removed us.  We
        stop campaigning entirely (no stale-term disruption) but keep
        answering reads; a future config re-admitting us reverses it."""
        with self.lock:
            if self.observer:
                return
            was_leader = self.state == LEADER
            self.observer = True
            self.state = FOLLOWER
            self.leader = None
            self.voters = [self.address]
            self.learners = []
            self._peers_persisted = True
            self._last_heard = self.clock()
            self._save_state()
        glog.infof("raft: %s removed from the cluster; now an observer",
                   self.address)
        self._sync_metrics()
        if was_leader and self.on_step_down:
            self.on_step_down()

    def _advance_commit(self, new_commit: int):
        """Apply newly-committed entries to the FSM, then maybe compact."""
        new_commit = min(new_commit, self._last_index())
        if new_commit <= self.commit_index:
            return
        old_commit = self.commit_index
        self.commit_index = new_commit
        for i in range(old_commit + 1, new_commit + 1):
            e = self._entry(i)
            if e is None:
                continue
            self._apply_results[i] = self.fsm.apply(e["cmd"])
            if e["cmd"].get("type") == "raft.config":
                # commit-time membership effects (expel / self-demote /
                # surface the change on the leader's event seam)
                self._on_config_committed(e)
        self.applied_index = new_commit
        if len(self._apply_results) > _RESULT_WINDOW:
            floor = new_commit - _RESULT_WINDOW
            for i in [i for i in self._apply_results if i <= floor]:
                del self._apply_results[i]
        self._maybe_snapshot()
        self._save_state()
        self._sync_metrics()

    def _maybe_snapshot(self):
        """Compact the applied prefix once it outgrows the threshold
        (raft_server.go:91-100 snapshot persistence)."""
        applied = self.commit_index - self.snapshot_index
        if applied < SNAPSHOT_THRESHOLD:
            return
        cut = self.commit_index - self.snapshot_index  # entries to drop
        # capture the committed config BEFORE the entries carrying it
        # are dropped — InstallSnapshot must ship membership too
        cfg, _ = self._config_at(self.commit_index)
        self.snapshot_config = {"voters": list(cfg.get("voters") or []),
                                "learners": list(cfg.get("learners") or [])}
        self.snapshot_term = self._term_at(self.commit_index) or \
            self.snapshot_term
        self.snapshot_index = self.commit_index
        self.snapshot_fsm = self.fsm.snapshot()
        self.log = self.log[cut:]

    def _sync_metrics(self):
        try:
            from ..stats import metrics as _m

            _m.RaftTermGauge.labels(self.address).set(self.term)
            _m.RaftCommitIndexGauge.labels(self.address) \
                .set(self.commit_index)
            _m.RaftAppliedLagGauge.labels(self.address) \
                .set(self._last_index() - self.applied_index)
        except Exception:
            pass  # metrics must never wedge consensus

    # -- persistence -----------------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.state_dir, "raft_state.json")

    def _load_state(self):
        if not self.state_dir:
            return
        try:
            with open(self._state_path()) as f:
                d = json.load(f)
            self.term = int(d.get("term", 0))
            self.voted_for = d.get("voted_for")
            snap = d.get("snapshot", {})
            self.snapshot_index = int(snap.get("index", 0))
            self.snapshot_term = int(snap.get("term", 0))
            self.snapshot_config = snap.get("config")
            fsm_snap = snap.get("fsm")
            if fsm_snap is None:
                # legacy MaxVolumeId-only snapshot
                fsm_snap = {"max_volume_id":
                            int(snap.get("max_volume_id",
                                         d.get("max_volume_id", 0)))}
            self.snapshot_fsm = fsm_snap
            self.log = [_upgrade_entry(e) for e in d.get("log", [])]
            self.commit_index = max(int(d.get("commit_index", 0)),
                                    self.snapshot_index)
            # replay: restore the snapshot FSM, apply the committed suffix
            self.fsm.restore(self.snapshot_fsm)
            for e in self.log:
                if e["index"] <= self.commit_index:
                    self.fsm.apply(e["cmd"])
            self.applied_index = self.commit_index
            self._refresh_config()
            # peers are persisted only once membership was changed via
            # cluster.raft.add/remove — a plain restart keeps the
            # configured list (addresses are identity here, so saving the
            # bootstrap list would resurrect stale self-addresses)
            persisted = d.get("peers")
            self.observer = bool(d.get("observer", False))
            self._expelled = set(d.get("expelled") or [])
            if self.observer:
                self.voters, self.learners = [self.address], []
                self._peers_persisted = True
            elif persisted is not None and self._config_index == 0 \
                    and self.snapshot_config is None:
                # legacy broadcast-driven membership (no config entries
                # anywhere in the log): adopt the persisted list
                self.voters = sorted(set(persisted) | {self.address})
                self.learners = sorted(set(d.get("learners") or []))
                self._peers_persisted = True
            elif persisted is not None:
                self._peers_persisted = True
        except (OSError, ValueError):
            pass

    def _save_state(self):
        if not self.state_dir:
            return
        state = {
            "term": self.term, "voted_for": self.voted_for,
            "commit_index": self.commit_index,
            "snapshot": {"index": self.snapshot_index,
                         "term": self.snapshot_term,
                         "fsm": self.snapshot_fsm},
            "log": self.log,
        }
        if self.snapshot_config is not None:
            state["snapshot"]["config"] = self.snapshot_config
        if self._peers_persisted:
            state["peers"] = self.voters
            state["learners"] = self.learners
            state["observer"] = self.observer
            state["expelled"] = sorted(self._expelled)
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._state_path())

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self.voters == [self.address] and not self.observer:
            # single-node cluster: immediately leader (no quorum needed)
            with self.lock:
                self.state = LEADER
                self.leader = self.address
                self._lease_until = self.clock() + self.election_timeout
            if self.on_become_leader:
                self.on_become_leader()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def quorum(self) -> int:
        return len(self.voters) // 2 + 1

    def _leader_hint(self) -> Optional[dict]:
        """Response headers pointing a rejected caller at the leader."""
        leader = self.leader
        if leader and leader != self.address:
            return {"X-Raft-Leader": leader}
        return None

    # -- membership changes (shell cluster.raft.add/remove) ------------------
    # Single-server changes committed through the replicated log, per the
    # raft dissertation §4.1: the new configuration is one raft.config
    # entry, effective when appended; at most one change is in flight.
    # Joins go learner-first: a non-voter catches up via snapshot + log
    # replay, then the leader auto-promotes it to voter.

    def _config_slot_free(self) -> bool:
        """lock held: may another config entry enter the log now?"""
        limit = max(1, int(_env_float("WEED_RAFT_MAX_CONFIG_CHANGES", 1)))
        pending = sum(1 for e in self.log
                      if e["index"] > self.commit_index
                      and e["cmd"].get("type") == "raft.config")
        return pending < limit

    def _propose_config(self, op: str, address: str,
                        build_membership: Callable[[], tuple]) -> dict:
        """Commit one raft.config entry; membership is computed under
        the raft lock (atomic with the append) by build_membership,
        which may raise RpcError to veto."""
        def build():
            if not self._config_slot_free():
                raise RpcError("raft config change already in flight", 409)
            voters, learners = build_membership()
            return {"type": "raft.config", "op": op, "address": address,
                    "voters": sorted(set(voters)),
                    "learners": sorted(set(learners)),
                    "now": time.time()}
        self.propose(build=build)
        with self.lock:
            departed = address in self._grace or address in self._expelled
            result = {"op": op, "address": address,
                      "voters": list(self.voters),
                      "learners": list(self.learners)}
        if departed:
            # one synchronous post-commit round so the removed server
            # hears the sealed removal (and demotes) before we return
            self._broadcast_round()
        return result

    def add_server(self, address: str) -> dict:
        """Add `address` as a non-voting learner (committed through the
        log).  Promotion to voter happens automatically once the learner
        has caught up (see _maybe_promote_learner)."""
        with self.lock:
            if address in self._known():
                return {"op": "noop", "address": address, "already": True,
                        "voters": list(self.voters),
                        "learners": list(self.learners)}

        def membership():
            if address in self._known():
                raise RpcError(f"{address} already a raft member", 409)
            return list(self.voters), list(self.learners) + [address]
        return self._propose_config("add_learner", address, membership)

    def remove_server(self, address: str, reason: str = "") -> dict:
        """Remove a voter or learner through the log.  Removing self is
        legal: we keep leading (without counting our own vote) until the
        entry commits, then step down and demote to observer."""
        def membership():
            if address not in self._known():
                raise RpcError(f"{address} not a raft member", 404)
            voters = [v for v in self.voters if v != address]
            if not voters:
                raise RpcError("cannot remove the last raft voter", 400)
            return voters, [l for l in self.learners if l != address]
        op = "remove" if not reason else f"remove:{reason}"
        return self._propose_config(op, address, membership)

    def _maybe_promote_learner(self):
        """Leader-side learner lifecycle, one change at a time: promote
        a caught-up learner to voter; abandon one that has not caught up
        within WEED_RAFT_LEARNER_TIMEOUT (a dead joiner must not squat
        in the config forever)."""
        action = None
        with self.lock:
            if self.state != LEADER or not self.learners \
                    or not self._config_slot_free():
                return
            last = self._last_index()
            now = self.clock()
            for addr in self.learners:
                match = self._match_index.get(addr, 0)
                if match >= self.commit_index and last - match <= 1:
                    action = ("promote", addr)
                    break
                since = self._learner_since.get(addr, now)
                if self.learner_timeout > 0 \
                        and now - since > self.learner_timeout:
                    action = ("abandon", addr)
                    break
        if action is None:
            return
        op, addr = action
        try:
            if op == "promote":
                def membership():
                    if addr not in self.learners:
                        raise RpcError(f"{addr} no longer a learner", 409)
                    return (list(self.voters) + [addr],
                            [l for l in self.learners if l != addr])
                self._propose_config("promote", addr, membership)
            else:
                self.remove_server(addr, reason="learner_timeout")
        except RpcError:
            pass  # lost leadership / lost the slot: next tick retries

    # -- legacy administrative broadcast (kept for mixed-version peers) -------
    def set_peers(self, peers: list[str]):
        """Adopt a broadcast membership list (internal /raft/update_peers).
        A node absent from the list has been expelled: it demotes to a
        single-node OBSERVER — it neither campaigns against its former
        peers nor keeps heartbeating a stale term."""
        was_leader = False
        with self.lock:
            if self.address in peers:
                gone = self._known() - set(peers) - {self.address}
                self._expelled |= gone
                self._expelled -= set(peers)
                self.voters = sorted(set(peers))
                self.learners = [l for l in self.learners if l in peers
                                 and l not in self.voters]
                self.observer = False
            else:
                was_leader = self.state == LEADER
                self.voters = [self.address]
                self.learners = []
                self.state = FOLLOWER
                self.leader = None
                self.observer = True
            self._peers_persisted = True
            self._save_state()
        if was_leader and self.on_step_down:
            self.on_step_down()

    def add_peer(self, address: str):
        return self.add_server(address)

    def remove_peer(self, address: str):
        return self.remove_server(address)

    # -- main loop -----------------------------------------------------------
    def tick(self) -> float:
        """One scheduler step (factored out of _run so tests can drive
        a node on a fake clock without its thread).  Returns how long
        the loop should sleep before the next step."""
        if self.state == LEADER:
            self._broadcast_round()
            self._maybe_promote_learner()
            return self.heartbeat_interval
        if self.observer or self.address in self.learners:
            # non-voters never campaign: they replicate passively and
            # wait to be promoted (or re-admitted)
            self._last_heard = self.clock()
            return self.heartbeat_interval
        timeout = self.election_timeout * (1 + self.rand())
        if self.clock() - self._last_heard > timeout:
            self._campaign()
        return 0.05

    def _run(self):
        while not self._stop.is_set():
            try:
                delay = self.tick()
            except Exception as e:  # consensus loop must never die
                glog.warningf("raft: tick failed on %s: %s",
                              self.address, e)
                delay = 0.05
            self._stop.wait(delay)

    def _campaign(self):
        with self.lock:
            if self.observer or self.address in self.learners:
                return
            self.state = CANDIDATE
            self.term += 1
            self.voted_for = self.address
            self.leader = None
            term = self.term
            last_index = self._last_index()
            last_term = self._last_term()
            voters = list(self.voters)
            self._save_state()
        # a server excluded by a not-yet-committed config still campaigns
        # (§4.2.2: the change may yet be truncated) — but its own vote
        # only counts if it is a voter
        votes = 1 if self.address in voters else 0
        removed = False
        for peer in voters:
            if peer == self.address:
                continue
            try:
                r = self.rpc(peer, "/raft/request_vote",
                             {"term": term, "candidate": self.address,
                              "last_log_index": last_index,
                              "last_log_term": last_term},
                             timeout=1)
                if r.get("removed"):
                    removed = True
                    break
                if r.get("granted"):
                    votes += 1
                elif r.get("term", 0) > term:
                    self._step_down(r["term"])
                    return
            except RpcError:
                continue
        if removed:
            # the cluster committed our removal while we were away
            self._demote()
            return
        with self.lock:
            if self.state != CANDIDATE or self.term != term:
                return
            if votes >= self.quorum():
                glog.infof("raft: %s elected leader for term %d (%d votes)",
                           self.address, term, votes)
                self.state = LEADER
                self.leader = self.address
                # no-op entry of OUR term: prior-term entries cannot
                # commit by counting (§5.4.2), so without this the new
                # leader's FSM would lag until the next real proposal
                self.log.append({"index": self._last_index() + 1,
                                 "term": self.term,
                                 "cmd": {"type": "raft.noop"}})
                self._grace = {}
                for peer in self._known() | {self.address}:
                    self._next_index[peer] = self._last_index()
                    self._match_index[peer] = 0
                self._save_state()
            else:
                self.state = FOLLOWER
                self._last_heard = self.clock()
                return
        self._sync_metrics()
        if self.on_become_leader:
            self.on_become_leader()
        self._broadcast_round()

    def _step_down(self, term: int):
        with self.lock:
            if term > self.term:
                self.term = term
                self.voted_for = None
                self._save_state()
            was_leader = self.state == LEADER
            if self.state != FOLLOWER:
                glog.infof("raft: %s stepping down at term %d",
                           self.address, term)
            self.state = FOLLOWER
            self._last_heard = self.clock()
        self._sync_metrics()
        if was_leader and self.on_step_down:
            self.on_step_down()

    # -- leader-side replication ----------------------------------------------
    def _replicate_to(self, peer: str) -> bool:
        """One AppendEntries (or snapshot-install) round to a follower."""
        with self.lock:
            if self.state != LEADER:
                return False
            term = self.term
            ni = self._next_index.get(peer, self._last_index() + 1)
            payload = {"term": term, "leader": self.address,
                       "commit_index": self.commit_index}
            if ni <= self.snapshot_index:
                # follower is behind the compaction horizon: ship the
                # snapshot (InstallSnapshot), then the remaining log
                payload["snapshot"] = {
                    "index": self.snapshot_index,
                    "term": self.snapshot_term,
                    "fsm": self.snapshot_fsm,
                    "config": self.snapshot_config}
                payload["prev_index"] = self.snapshot_index
                payload["prev_term"] = self.snapshot_term
                payload["entries"] = list(self.log)
            else:
                payload["prev_index"] = ni - 1
                payload["prev_term"] = self._term_at(ni - 1) or 0
                payload["entries"] = [
                    e for e in self.log if e["index"] >= ni]
            sent_last = self._last_index()
        try:
            r = self.rpc(peer, "/raft/append_entries", payload, timeout=1)
        except RpcError:
            return False
        if r.get("removed"):
            # the peer knows a committed config expelled US
            self._demote()
            return False
        with self.lock:
            if r.get("term", 0) > self.term:
                pass  # handled below, outside the lock
            elif r.get("ok"):
                self._match_index[peer] = sent_last
                self._next_index[peer] = sent_last + 1
                return True
            else:
                # consistency miss: back off to the follower's tail
                follower_last = int(r.get("last_index", 0))
                self._next_index[peer] = max(
                    min(ni - 1, follower_last + 1), 1)
        if r.get("term", 0) > term:
            self._step_down(r["term"])
        return False

    def _broadcast_round(self) -> int:
        """Replicate to every member; advance commit on majority match
        among VOTERS.  Returns the number of voters (incl. self when
        voting) matching our last index.  A server being removed by an
        in-flight config keeps receiving entries until it has seen the
        committed removal (§4.2.2), so it demotes instead of lingering."""
        with self.lock:
            voters = set(self.voters)
            targets = self._known()
            cfg_idx = self._config_index
            in_flight = cfg_idx > self.commit_index
            if cfg_idx > 0:
                old_cfg, _ = self._config_at(cfg_idx - 1)
                old = (set(old_cfg.get("voters") or [])
                       | set(old_cfg.get("learners") or []))
                for a in old - self._known():
                    if in_flight:
                        targets.add(a)
                    elif self._grace.get(a, 0) > 0:
                        self._grace[a] -= 1
                        targets.add(a)
            targets.discard(self.address)
            pre_commit = self.commit_index
        acked = 1 if self.address in voters else 0
        for peer in sorted(targets):
            ok = self._replicate_to(peer)
            if not ok:
                continue
            if peer in voters:
                acked += 1
            elif pre_commit >= cfg_idx:
                # departing server has now seen the committed removal
                with self.lock:
                    self._grace.pop(peer, None)
        with self.lock:
            if self.state != LEADER:
                return acked
            if acked >= self.quorum():
                # a quorum just heard from us: refresh the leader lease
                self._lease_until = self.clock() + self.election_timeout
            # majority-match commit rule (only entries of the current term
            # commit by counting, per the raft paper's §5.4.2 restriction)
            voters = set(self.voters)
            for n in range(self._last_index(), self.commit_index, -1):
                matches = (1 if self.address in voters else 0) + sum(
                    1 for p in voters if p != self.address
                    and self._match_index.get(p, 0) >= n)
                if matches >= self.quorum() \
                        and self._term_at(n) == self.term:
                    self._advance_commit(n)
                    break
        return acked

    # -- RPC handlers --------------------------------------------------------
    def handle_request_vote(self, req: dict) -> dict:
        term = int(req["term"])
        candidate = req["candidate"]
        c_last_term = int(req.get("last_log_term", 0))
        c_last_index = int(req.get("last_log_index", 0))
        with self.lock:
            if candidate in self._expelled \
                    and candidate not in self._known():
                # a committed config removed the candidate: tell it so
                # WITHOUT adopting its term — a removed server must not
                # be able to disrupt the cluster it no longer belongs to
                return {"granted": False, "term": self.term,
                        "removed": True}
            if self.observer:
                return {"granted": False, "term": self.term}
            if term < self.term:
                return {"granted": False, "term": self.term}
            if term > self.term and self.state == FOLLOWER \
                    and self.leader and self.leader != candidate \
                    and self.clock() - self._last_heard \
                    < self.election_timeout:
                # leader stickiness (§4.2.3): we heard from a live leader
                # within the election timeout, so a fresher-term vote
                # request — typically a server that does not yet know it
                # was removed — is ignored without a term bump
                return {"granted": False, "term": self.term}
            if term > self.term:
                self.term = term
                self.voted_for = None
                if self.state != FOLLOWER:
                    self.state = FOLLOWER
            # up-to-date check on the LOG (raft §5.4.1), not the FSM
            up_to_date = (c_last_term > self._last_term()
                          or (c_last_term == self._last_term()
                              and c_last_index >= self._last_index()))
            if self.voted_for in (None, candidate) and up_to_date:
                self.voted_for = candidate
                self._last_heard = self.clock()
                self._save_state()
                return {"granted": True, "term": self.term}
            self._save_state()
            return {"granted": False, "term": self.term}

    def handle_append_entries(self, req: dict) -> dict:
        term = int(req["term"])
        leader_addr = req.get("leader", "")
        with self.lock:
            if leader_addr in self._expelled \
                    and leader_addr not in self._known():
                # stale heartbeat from a removed ex-leader: reject
                # without adopting its term or leadership
                return {"ok": False, "term": self.term, "removed": True}
            if term < self.term:
                return {"ok": False, "term": self.term,
                        "last_index": self._last_index()}
            if term > self.term:
                self.term = term
                self.voted_for = None
            self.state = FOLLOWER
            self.leader = leader_addr
            self._last_heard = self.clock()

            snap = req.get("snapshot")
            if snap and snap["index"] > self.snapshot_index \
                    and snap["index"] > self.commit_index:
                # InstallSnapshot: replace everything up to the snapshot
                self.snapshot_index = int(snap["index"])
                self.snapshot_term = int(snap["term"])
                self.snapshot_fsm = snap.get("fsm") or {
                    "max_volume_id": int(snap.get("max_volume_id", 0))}
                if snap.get("config") is not None:
                    self.snapshot_config = snap["config"]
                self.log = []
                self.commit_index = self.snapshot_index
                self.applied_index = self.snapshot_index
                self.fsm.restore(self.snapshot_fsm)
                self._refresh_config()

            prev_index = int(req.get("prev_index", 0))
            prev_term = int(req.get("prev_term", 0))
            if prev_index > self._last_index():
                self._save_state()
                return {"ok": False, "term": self.term,
                        "last_index": self._last_index()}
            if prev_index > self.snapshot_index:
                local = self._term_at(prev_index)
                if local != prev_term:
                    # conflicting suffix: drop it and report our new tail
                    self.log = self.log[:prev_index - self.snapshot_index
                                        - 1]
                    self._refresh_config()
                    self._save_state()
                    return {"ok": False, "term": self.term,
                            "last_index": self._last_index()}
            for e in req.get("entries", []):
                idx = int(e["index"])
                if idx <= self.snapshot_index:
                    continue  # already compacted (thus committed)
                existing = self._entry(idx)
                if existing is not None:
                    if existing["term"] == e["term"]:
                        continue
                    self.log = self.log[:idx - self.snapshot_index - 1]
                self.log.append({"index": idx, "term": int(e["term"]),
                                 "cmd": _upgrade_entry(e)["cmd"]})
            self._refresh_config()
            self._advance_commit(int(req.get("commit_index", 0)))
            # a snapshot-installed config that excludes us is committed
            # by definition: demote now rather than linger voiceless
            if not self.observer and self._config_index > 0 \
                    and self._config_index <= self.commit_index \
                    and self.address not in self._known():
                self._demote()
            self._save_state()
            self._sync_metrics()
            return {"ok": True, "term": self.term,
                    "last_index": self._last_index()}

    # -- proposing commands (the generalized FSM write path) ------------------
    def propose(self, cmd: Optional[dict] = None, *,
                build: Optional[Callable[[], dict]] = None):
        """Append a command, replicate it, and return its FSM apply
        result only after the entry COMMITS (majority-replicated).  A
        failed quorum leaves the entry uncommitted and nothing is
        returned — at-most-once, so a competing leader can never have
        acknowledged the same mutation.

        `build` constructs the command under the raft lock — required
        when the command reads log-dependent state (the volume-id
        allocation floor or the membership roster) that must be computed
        atomically with the append."""
        with self.lock:
            if self.state != LEADER:
                raise RpcError("not raft leader", 409,
                               headers=self._leader_hint())
            if build is not None:
                cmd = build()
            entry = {"index": self._last_index() + 1, "term": self.term,
                     "cmd": cmd}
            self.log.append(entry)
            if cmd.get("type") == "raft.config":
                self._refresh_config()
            self._save_state()
            if self.voters == [self.address]:
                self._advance_commit(entry["index"])
                self._lease_until = self.clock() + self.election_timeout
                return self._apply_results.pop(entry["index"], None)
        # two rounds: the second lets a consistency-miss follower that
        # backed off in round one catch up and count toward the quorum
        for _ in range(2):
            self._broadcast_round()
            with self.lock:
                if self.commit_index >= entry["index"]:
                    if self._term_at(entry["index"]) == entry["term"]:
                        return self._apply_results.pop(
                            entry["index"], None)
                    # compacted below the snapshot horizon: the entry is
                    # committed provided WE are still the leader of its
                    # term (no competing leader could have replaced it
                    # without first bumping our term and demoting us)
                    if (entry["index"] <= self.snapshot_index
                            and self.state == LEADER
                            and self.term == entry["term"]):
                        return self._apply_results.pop(
                            entry["index"], None)
                    # a competing leader's entry committed at our index:
                    # our command was dropped from the log, never applied
                    raise RpcError(
                        "leadership lost before commit", 409,
                        headers=self._leader_hint())
        raise RpcError(
            f"entry {entry['index']} not replicated to quorum", 503,
            headers=self._leader_hint())

    # -- the MaxVolumeId surface (raft_server.go:78) ---------------------------
    def next_volume_id(self) -> int:
        """Allocate the next volume id; returns only after the allocation's
        log entry is COMMITTED.  The floor is computed under the same lock
        as the append, so concurrent proposers never collide."""
        value = self.propose(build=lambda: {
            "type": "volume.assign",
            "value": self._pending_value() + 1,
            "now": time.time()})
        return int(value)

    def observe_volume_id(self, vid: int):
        """Fold in a volume id seen in a heartbeat (SetMax semantics): the
        leader appends a log entry so the observation replicates; followers
        ignore it (their leader will replicate its own observation)."""
        with self.lock:
            if self.state != LEADER or vid <= self._pending_value():
                return
            self.log.append({"index": self._last_index() + 1,
                             "term": self.term,
                             "cmd": {"type": "volume.assign",
                                     "value": int(vid),
                                     "now": time.time()}})
            if self.voters == [self.address]:
                self._advance_commit(self._last_index())
            self._save_state()

    # -- operator surface ------------------------------------------------------
    def status(self) -> dict:
        """cluster.check / raft.status view: term, commit/applied index,
        leader lease freshness, voters/learners and any in-flight config
        change, plus per-follower replication lag so a straggler (or a
        learner mid-catch-up) is visible before it matters."""
        with self.lock:
            followers = {}
            if self.state == LEADER:
                last = self._last_index()
                for p in self._known():
                    if p == self.address:
                        continue
                    match = self._match_index.get(p, 0)
                    followers[p] = {
                        "match_index": match,
                        "next_index": self._next_index.get(p, last + 1),
                        "lag": last - match,
                        "voting": p in self.voters,
                    }
            lease = 0.0
            if self.state == LEADER:
                lease = max(0.0, self._lease_until - self.clock())
            return {
                "id": self.address,
                "state": self.state,
                "term": self.term,
                "leader": self.leader or "",
                "peers": self.peers,
                "voters": list(self.voters),
                "learners": list(self.learners),
                "observer": self.observer,
                "config_index": self._config_index,
                "config_change_in_flight":
                    self._config_index > self.commit_index,
                "commit_index": self.commit_index,
                "applied_index": self.applied_index,
                "last_index": self._last_index(),
                "snapshot_index": self.snapshot_index,
                "lease_remaining": round(lease, 3),
                "max_volume_id": self.fsm.max_volume_id,
                "topology_epoch": self.fsm.topology_epoch,
                "followers": followers,
            }
