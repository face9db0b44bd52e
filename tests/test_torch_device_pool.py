"""The port's slab pool (seaweedfs_tpu_torch/ops/device_pool.py) against the
JAX package's (seaweedfs_tpu/ops/device_pool.py): every case of
tests/test_device_pool.py drives the same sequence of leases, releases,
residents and evictions through a fresh pool of each package, with
WEED_EC_DEVICE_POOL_MB pinned (the packages' default caps differ), and
holds the two records equal: snapshots, and which slab each call handed
back.  The port's pool takes torch devices where the JAX package's takes
labels; both must file them under the same label.  The recover path's
resident slab reuse through reconstruct_span(slab_key=...) is held against
the JAX package's decode and its pool counters; on the CPU the port's
device route runs K1's plain version (WEED_EC_RECOVER_DEVICE=1)."""

import numpy as np
import torch

from seaweedfs_tpu.ops import codec as j_codec
from seaweedfs_tpu.ops import device_pool as j_pool
from seaweedfs_tpu_torch.ops import device_pool as t_pool
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.codec import reconstruct_span
from seaweedfs_tpu_torch.ops.rs_numpy import gf_apply_matrix

# each package's pool module, and how its callers name device i
PACKAGES = ((j_pool, lambda i: f"cuda:{i}"),
            (t_pool, lambda i: torch.device("cuda", i)))
POOL_MB = "256"


class _Slabs:
    """Payload factories that number the slabs in the order they are
    built, so two pools' records say which slab came back, not merely
    that one did."""

    def __init__(self):
        self.built = 0

    def __call__(self, tag: str = "slab"):
        def build():
            self.built += 1
            return f"{tag}#{self.built}"
        return build


def _view(snap: dict) -> dict:
    """The snapshot without its wall-clock key and the process lanes."""
    return {k: v for k, v in snap.items()
            if k not in ("hwm_seconds", "lanes")}


def _both(scenario, monkeypatch, cap_mb: str = POOL_MB):
    """Run `scenario(pool, slabs, dev)` on a fresh pool of each package
    and return the port's record after holding it equal to the JAX
    package's."""
    monkeypatch.setenv("WEED_EC_DEVICE_POOL_MB", cap_mb)
    records = [scenario(mod.DevicePool(), _Slabs(), dev)
               for mod, dev in PACKAGES]
    assert records[1] == records[0]
    return records[1]


class TestLeases:
    def test_release_then_lease_reuses_slab(self, monkeypatch):
        def run(pool, slabs, dev):
            ls = pool.lease("k", slabs(), 8)
            pool.release(ls)
            ls2 = pool.lease("k", slabs(), 8)
            return ls.payload, ls2.payload, _view(pool.snapshot())

        first, again, snap = _both(run, monkeypatch)
        assert again == first
        assert snap["allocs"] == 1 and snap["lease_hits"] == 1

    def test_distinct_keys_do_not_cross(self, monkeypatch):
        def run(pool, slabs, dev):
            a = pool.lease(("shape", 1), slabs("a"), 1)
            pool.release(a)
            b = pool.lease(("shape", 2), slabs("b"), 1)
            return b.payload, _view(pool.snapshot())

        payload, snap = _both(run, monkeypatch)
        assert payload == "b#2" and snap["allocs"] == 2

    def test_payload_swap_travels_through_release(self, monkeypatch):
        def run(pool, slabs, dev):
            ls = pool.lease("k", slabs("old"), 4)
            ls.payload = "new"
            pool.release(ls)
            return pool.lease("k", slabs("x"), 4).payload

        assert _both(run, monkeypatch) == "new"

    def test_discard_retains_nothing(self, monkeypatch):
        def run(pool, slabs, dev):
            pool.discard(pool.lease("k", slabs(), 64))
            return _view(pool.snapshot())

        snap = _both(run, monkeypatch)
        assert snap["free_slots"] == 0 and snap["bytes"] == 0

    def test_per_device_free_lists_never_alias(self, monkeypatch):
        """A slab released for one device is never handed to a lease
        against another: same key, different device, different slab."""
        def run(pool, slabs, dev):
            key = ("ec-out", (4, 8, 256))
            a = pool.lease(key, slabs("dev0"), 1 << 10, device=dev(0))
            pool.release(a)
            b = pool.lease(key, slabs("dev1"), 1 << 10, device=dev(1))
            allocs = pool.snapshot()["allocs"]
            c = pool.lease(key, slabs("fresh"), 1 << 10, device=dev(0))
            return (a.payload, b.payload, c.payload, allocs,
                    _view(pool.snapshot()))

        a, b, c, allocs, snap = _both(run, monkeypatch)
        assert b == "dev1#2" and allocs == 2
        assert c == a and snap["lease_hits"] == 1

    def test_per_device_accounting_in_snapshot(self, monkeypatch):
        def run(pool, slabs, dev):
            a = pool.lease("k", slabs("a"), 512, device=dev(0))
            pool.lease("k", slabs("b"), 256, device=dev(1))
            pool.note_h2d(100, device=dev(0))
            pool.note_d2h(40, device=dev(1))
            before = pool.snapshot()["devices"]
            pool.discard(a)
            return before, _view(pool.snapshot())

        devs, after = _both(run, monkeypatch)
        assert devs["cuda:0"]["bytes"] == 512
        assert devs["cuda:0"]["h2d_bytes"] == 100
        assert devs["cuda:1"]["bytes"] == 256
        assert devs["cuda:1"]["d2h_bytes"] == 40
        assert "cuda:0" not in after["devices"] or \
            after["devices"]["cuda:0"]["bytes"] == 0

    def test_lru_eviction_under_cap(self, monkeypatch):
        def run(pool, slabs, dev):
            leases = [pool.lease("k", slabs(), 1 << 10) for _ in range(3)]
            for ls in leases:   # 3 KiB idle against a 2 KiB cap
                pool.release(ls)
            snap = _view(pool.snapshot())
            survivors = [pool.lease("k", slabs("late"), 1 << 10).payload
                         for _ in range(2)]
            return [ls.payload for ls in leases], snap, survivors

        leased, snap, survivors = _both(run, monkeypatch, cap_mb="0.002")
        assert snap["evictions"] == 1 and snap["free_slots"] == 2
        assert leased[0] not in survivors   # the oldest went first

    def test_leased_slabs_never_evicted(self, monkeypatch):
        def run(pool, slabs, dev):
            leases = [pool.lease("k", slabs(), 1 << 20) for _ in range(2)]
            held = _view(pool.snapshot())
            for ls in leases:
                pool.release(ls)
            return held, _view(pool.snapshot())

        held, snap = _both(run, monkeypatch, cap_mb="0")
        assert held["evictions"] == 0
        assert snap["evictions"] == 2 and snap["free_slots"] == 0


class TestResidents:
    def test_hit_returns_same_payload(self, monkeypatch):
        def run(pool, slabs, dev):
            build = slabs("res")
            p1 = pool.acquire_resident("slab", build, 256)
            p2 = pool.acquire_resident("slab", build, 256)
            return p1, p2, slabs.built, _view(pool.snapshot())

        p1, p2, built, snap = _both(run, monkeypatch)
        assert p1 == p2 and built == 1
        assert snap["resident_misses"] == 1 and snap["resident_hits"] == 1

    def test_refcount_blocks_eviction(self, monkeypatch):
        def run(pool, slabs, dev):
            pool.acquire_resident("hot", slabs("hot"), 1 << 20)
            pool.release(pool.lease("k", slabs(), 1))
            referenced = _view(pool.snapshot())
            pool.release_resident("hot")
            pool.release(pool.lease("k", slabs(), 1))
            return referenced, _view(pool.snapshot())

        referenced, snap = _both(run, monkeypatch, cap_mb="0")
        assert referenced["resident_slabs"] == 1
        assert snap["resident_slabs"] == 0 and snap["evictions"] >= 1

    def test_zero_ref_resident_survives_under_cap(self, monkeypatch):
        def run(pool, slabs, dev):
            first = pool.acquire_resident("warm", slabs("warm"), 1 << 10)
            pool.release_resident("warm")
            idle = _view(pool.snapshot())
            again = pool.acquire_resident("warm", slabs("new"), 1 << 10)
            return first, again, idle, _view(pool.snapshot())

        first, again, idle, snap = _both(run, monkeypatch)
        assert idle["resident_slabs"] == 1
        assert again == first and snap["resident_hits"] == 1

    def test_transfer_counters(self, monkeypatch):
        def run(pool, slabs, dev):
            pool.note_h2d(100)
            pool.note_h2d(50)
            pool.note_d2h(30)
            return _view(pool.snapshot())

        snap = _both(run, monkeypatch)
        assert snap["h2d_bytes"] == 150 and snap["d2h_bytes"] == 30
        assert snap["devices"]["host"]["h2d_bytes"] == 150


    def test_idle_residents_do_not_evict_a_released_lease(self,
                                                           monkeypatch):
        """R2 (ROADMAP §3): two idle 1 KiB residents fill a 2 KiB cap,
        then a 1 KiB lease is released and leased again.  The JAX pool
        evicts every free lease before any idle resident, so it drops
        the released slab at once and builds another (the thrash a pool
        full of degraded-read residents puts on every encode batch); the
        port evicts the least recently used idle slab, the first
        resident, and hands the released slab back."""
        monkeypatch.setenv("WEED_EC_DEVICE_POOL_MB", "0.002")
        records = []
        for mod, _ in PACKAGES:
            pool, slabs = mod.DevicePool(), _Slabs()
            for key in ("r1", "r2"):
                pool.acquire_resident(key, slabs(key), 1 << 10)
                pool.release_resident(key)
            first = pool.lease("k", slabs(), 1 << 10)
            pool.release(first)
            again = pool.lease("k", slabs(), 1 << 10)
            snap = _view(pool.snapshot())
            records.append((again.payload == first.payload,
                            {k: snap[k] for k in ("allocs", "lease_hits",
                                                  "resident_slabs",
                                                  "evictions")}))
        (j_same, j_snap), (t_same, t_snap) = records
        assert not j_same and j_snap == {"allocs": 4, "lease_hits": 0,
                                         "resident_slabs": 2,
                                         "evictions": 1}
        assert t_same and t_snap == {"allocs": 3, "lease_hits": 1,
                                     "resident_slabs": 1, "evictions": 1}


class TestProcessPool:
    def test_singleton_and_reset(self):
        for mod, _ in PACKAGES:
            mod.reset_pool()
            p = mod.get_pool()
            assert mod.get_pool() is p
            mod.reset_pool()
            assert mod.get_pool() is not p
        assert type(t_pool.get_pool()).__module__ == t_pool.__name__


RESIDENT_KEYS = ("resident_slabs", "resident_hits", "resident_misses",
                 "h2d_bytes")


def _residents(snap: dict) -> dict:
    return {k: snap[k] for k in RESIDENT_KEYS}


class TestRecoverSlabReuse:
    def _codeword(self, length=4096, seed=3):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, (10, length), dtype=np.uint8)
        parity = gf_apply_matrix(gf256.parity_matrix(10, 14), data)
        return np.concatenate([data, parity], axis=0)

    def test_consecutive_decodes_hit_resident_slab(self, monkeypatch):
        """Two decodes over the same survivor spans (different missing
        targets) upload once in both packages: the second hits the
        resident slab, and the pools' resident counters agree."""
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "1")
        monkeypatch.setenv("WEED_EC_DEVICE_POOL_MB", POOL_MB)
        shards = self._codeword()
        survivors = list(range(1, 11))
        inputs = np.ascontiguousarray(shards[1:11])
        key = b"content-identity"
        records = []
        for mod, decode in (
                (j_pool, lambda t: j_codec.reconstruct_span(
                    survivors, inputs, t, slab_key=key)),
                (t_pool, lambda t: reconstruct_span(
                    survivors, inputs, t, slab_key=key, device="cpu"))):
            mod.reset_pool()
            got0 = decode(0)
            first = _residents(mod.get_pool().snapshot())
            got11 = decode(11)
            records.append((got0.tolist(), got11.tolist(), first,
                            _residents(mod.get_pool().snapshot())))
            mod.reset_pool()
        assert records[1] == records[0]
        got0, got11, first, snap = records[1]
        assert first["resident_misses"] == 1 and first["resident_slabs"] == 1
        assert snap["resident_hits"] >= 1 and snap["resident_misses"] == 1
        assert snap["h2d_bytes"] == inputs.nbytes  # one upload
        assert got0 == shards[0].tolist() and got11 == shards[11].tolist()

    def test_device_matches_host_decode(self, monkeypatch):
        shards = self._codeword(seed=17)
        survivors = [0, 2, 3, 4, 5, 6, 7, 8, 9, 13]
        inputs = np.ascontiguousarray(shards[survivors])
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "0")
        want = reconstruct_span(survivors, inputs, 1, device="cpu")
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "1")
        t_pool.reset_pool()
        got = reconstruct_span(survivors, inputs, 1, slab_key=b"k2",
                               device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(got, shards[1])
        assert np.array_equal(
            got, j_codec.reconstruct_span(survivors, inputs, 1,
                                          slab_key=b"k2"))
        # without a key the device route leases its slabs: a second decode
        # of the same size re-leases them all
        reconstruct_span(survivors, inputs, 1, device="cpu")
        allocs = t_pool.get_pool().snapshot()["allocs"]
        got2 = reconstruct_span(survivors, inputs, 1, device="cpu")
        snap = t_pool.get_pool().snapshot()
        assert snap["allocs"] == allocs and snap["lease_hits"] > 0
        assert np.array_equal(got2, shards[1])
        t_pool.reset_pool()
        j_pool.reset_pool()

    def test_survivor_stack_leases_only_for_a_card(self, monkeypatch):
        """On the CPU the read ladder's stack is an ordinary array: the
        codec leases a pinned slab only for a stack its route sends to a
        card."""
        from seaweedfs_tpu_torch.ops import codec

        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
        t_pool.reset_pool()
        with codec.survivor_stack((10, 4096), torch.device("cpu")) as slab:
            assert slab is None
        assert t_pool.get_pool().snapshot()["allocs"] == 0
        t_pool.reset_pool()
