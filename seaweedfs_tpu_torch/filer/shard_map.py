"""Replicated directory-prefix shard map for filer metadata.

The filer's ShardedSqliteStore hashes each directory into one of N
slots (md5(dir)[0] % N).  To scale that across machines, the master FSM
holds this map: slot -> lease holder, with per-holder fair-share
acquisition and lease expiry.  Store servers renew through the raft log
(`filer.lease` commands), so a failed-over master serves the exact same
assignment and two holders can never both believe they own a slot
beyond one lease TTL.

The slot COUNT itself can change online (`filer.resize` commands): a
two-phase split/merge where holders first re-shard their local data
into the target layout while dual-writing (prepare), then the map flips
atomically to the new count (commit).  The constraint that the new
count divides — or is divided by — the old one keeps re-sharding local:
on a split every entry of old slot s lands in a new slot s' with
s' % old == s, so each holder derives its new shards from data it
already owns; on a merge the new owner pulls the other sources'
handover dumps through the ordinary `prev` mechanism.

Deterministic by construction: every input (holder, now, ttl) rides in
the replicated command; no wall-clock or RNG reads happen here.

The port's own copy of seaweedfs_tpu/filer/shard_map.py.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional


def default_slots() -> int:
    try:
        return int(os.environ.get("WEED_FILER_SHARDS", "") or 8)
    except ValueError:
        return 8


def slot_of(dir_path: str, slots: int) -> int:
    """Same hash the ShardedSqliteStore uses for its local files, so
    slot i of the map is exactly the holder's local meta_{i:02x}.db."""
    return hashlib.md5(dir_path.encode()).digest()[0] % slots


class ShardMap:
    def __init__(self, slots: Optional[int] = None):
        self.slots = int(slots) if slots else default_slots()
        # slot -> {"holder": addr, "expires": epoch-seconds}
        self.holders: dict[int, dict] = {}
        # slot -> holders that last gave it up (handover sources); a
        # merge can fold several old slots into one, hence list-valued
        self.prev: dict[int, list] = {}
        # holder -> lease expiry; the membership that fair shares are
        # computed over (a newly-joined holder must count toward the
        # divisor BEFORE it owns any slot, or incumbents never shed)
        self.members: dict[str, float] = {}
        self.epoch = 0
        # in-flight split/merge:
        # {"to": N, "phase": "prepare", "started": now, "acks": [...]}
        self.resize: Optional[dict] = None

    # -- lease protocol (applied under the master FSM) ------------------------
    def _drop(self, slot: int):
        entry = self.holders.pop(slot, None)
        if entry is not None:
            self.prev[slot] = [entry["holder"]]

    def _expire(self, now: float) -> bool:
        changed = False
        for slot in [s for s, h in self.holders.items()
                     if h["expires"] <= now]:
            self._drop(slot)
            changed = True
        for m in [m for m, exp in self.members.items() if exp <= now]:
            del self.members[m]
        return changed

    def lease(self, holder: str, now: float, ttl: float) -> dict:
        """Renew the holder's fair share and grant free slots up to it.
        Slots over the fair share are shed at renewal (recorded in
        `prev` for handover) — the response tells the holder exactly
        what it still owns, so there is never a moment with two live
        owners; membership churn converges within ~one lease TTL."""
        changed = self._expire(now)
        self.members[holder] = now + ttl
        active = ({h["holder"] for h in self.holders.values()}
                  | set(self.members))
        fair = -(-self.slots // max(1, len(active)))  # ceil
        held = sorted(s for s, h in self.holders.items()
                      if h["holder"] == holder)
        keep, shed = held[:fair], held[fair:]
        for slot in keep:
            self.holders[slot]["expires"] = now + ttl
        for slot in shed:
            self._drop(slot)
            changed = True
        for slot in range(self.slots):
            if len(keep) >= fair:
                break
            if slot not in self.holders:
                self.holders[slot] = {"holder": holder,
                                      "expires": now + ttl}
                keep.append(slot)
                changed = True
        if changed:
            self.epoch += 1
        return {"epoch": self.epoch, "slots": sorted(keep), "ttl": ttl,
                "slots_total": self.slots,
                "resize": dict(self.resize) if self.resize else None,
                "prev": {str(s): list(self.prev.get(s, []))
                         for s in keep},
                "map": self.assignments()}

    def release(self, holder: str, now: float) -> dict:
        """Graceful departure: free every slot immediately (the holder
        stays up long enough for successors to pull a handover dump)."""
        freed = [s for s, h in self.holders.items()
                 if h["holder"] == holder]
        for slot in freed:
            self._drop(slot)
        self.members.pop(holder, None)
        if self.resize is not None and holder in self.resize["acks"]:
            self.resize["acks"].remove(holder)
        if freed:
            self.epoch += 1
        return {"epoch": self.epoch, "released": sorted(freed),
                "map": self.assignments()}

    # -- online split / merge -------------------------------------------------
    def resize_start(self, to: int, now: float) -> dict:
        """Open a split (to > slots) or merge (to < slots).  Errors are
        returned, not raised — this runs inside the FSM apply path,
        which must stay total."""
        to = int(to)
        if self.resize is not None:
            return {"error": "resize already in flight",
                    "resize": dict(self.resize)}
        if to < 1:
            return {"error": "shard count must be >= 1"}
        if to == self.slots:
            return {"error": f"already at {to} slots"}
        if to % self.slots != 0 and self.slots % to != 0:
            return {"error": "new shard count must divide or be a "
                             f"multiple of {self.slots}"}
        self.resize = {"to": to, "phase": "prepare",
                       "started": float(now), "acks": []}
        self.epoch += 1
        return {"epoch": self.epoch, "resize": dict(self.resize)}

    def resize_ack(self, holder: str, now: float) -> dict:
        """A holder reports its local re-shard to the target layout is
        durable (idempotent; re-acks are no-ops)."""
        if self.resize is None:
            return {"error": "no resize in flight"}
        if holder and holder not in self.resize["acks"]:
            self.resize["acks"].append(holder)
            self.epoch += 1
        return {"epoch": self.epoch, "resize": dict(self.resize)}

    def resize_pending(self, now: float) -> list:
        """Holders/members whose ack the commit still waits on.  Pure
        read — expired holders are filtered, not dropped (mutation only
        happens inside replicated commands)."""
        if self.resize is None:
            return []
        need = {h["holder"] for h in self.holders.values()
                if h["expires"] > now}
        need |= {m for m, exp in self.members.items() if exp > now}
        return sorted(need - set(self.resize["acks"]))

    def resize_commit(self, now: float) -> dict:
        """Atomically flip the slot map to the target count.  Ownership
        carries over so the flip never orphans a slot: on a split each
        new slot inherits the holder of its source (s % old); on a merge
        the surviving owner is preferred and every other source becomes
        a `prev` handover the new owner pulls."""
        if self.resize is None:
            return {"error": "no resize in flight"}
        old, new = self.slots, int(self.resize["to"])
        holders: dict[int, dict] = {}
        prev: dict[int, list] = {}
        if new > old:  # split: new slot s sources old slot s % old
            for s in range(new):
                src = s % old
                entry = self.holders.get(src)
                if entry is not None:
                    holders[s] = {"holder": entry["holder"],
                                  "expires": entry["expires"]}
                elif self.prev.get(src):
                    prev[s] = list(self.prev[src])
        else:  # merge: new slot s sources {s + j*new for j}
            k = old // new
            for s in range(new):
                sources = [s + j * new for j in range(k)]
                own = self.holders.get(s)
                if own is None:
                    for src in sources:
                        if src in self.holders:
                            own = self.holders[src]
                            break
                if own is not None:
                    holders[s] = {"holder": own["holder"],
                                  "expires": own["expires"]}
                sources_prev: list = []
                for src in sources:
                    e = self.holders.get(src)
                    if e is not None and (own is None
                                          or e["holder"] != own["holder"]):
                        if e["holder"] not in sources_prev:
                            sources_prev.append(e["holder"])
                    elif e is None:
                        for p in self.prev.get(src, []):
                            if p not in sources_prev \
                                    and (own is None
                                         or p != own["holder"]):
                                sources_prev.append(p)
                if sources_prev:
                    prev[s] = sources_prev
        self.slots = new
        self.holders = holders
        self.prev = prev
        self.resize = None
        self.epoch += 1
        return {"epoch": self.epoch, "slots": new, "from": old}

    def resize_abort(self, now: float) -> dict:
        if self.resize is None:
            return {"error": "no resize in flight"}
        aborted = dict(self.resize)
        self.resize = None
        self.epoch += 1
        return {"epoch": self.epoch, "aborted": aborted}

    # -- views ----------------------------------------------------------------
    def assignments(self) -> dict:
        return {str(s): h["holder"]
                for s, h in sorted(self.holders.items())}

    def holder_of(self, dir_path: str) -> str:
        entry = self.holders.get(slot_of(dir_path, self.slots))
        return entry["holder"] if entry else ""

    def to_dict(self) -> dict:
        return {"slots": self.slots, "epoch": self.epoch,
                "holders": {str(s): dict(h)
                            for s, h in sorted(self.holders.items())},
                "prev": {str(s): list(p)
                         for s, p in sorted(self.prev.items())},
                "members": {m: exp
                            for m, exp in sorted(self.members.items())},
                "resize": dict(self.resize) if self.resize else None}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        d = d or {}
        m = cls(slots=d.get("slots") or None)
        m.epoch = int(d.get("epoch", 0))
        m.holders = {int(s): {"holder": h["holder"],
                              "expires": float(h["expires"])}
                     for s, h in d.get("holders", {}).items()}
        # pre-resize snapshots persisted prev as slot -> single holder
        m.prev = {int(s): ([p] if isinstance(p, str) else list(p))
                  for s, p in d.get("prev", {}).items()}
        m.members = {k: float(v)
                     for k, v in d.get("members", {}).items()}
        m.resize = dict(d["resize"]) if d.get("resize") else None
        return m
