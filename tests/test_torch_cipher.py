"""The port's chunk encryption (`util/cipher.py`) and the filer's
encrypt-at-rest against the JAX package's, on the CPU.

- Primitives: with the same seeded key and nonce source, both packages'
  ciphertexts are equal byte for byte and each decrypts the other's;
  fresh nonces per call, and a bad tag, a wrong key or a truncated blob
  raise `ValueError` in both.
- A filer with `cipher=True` of each package: multi-chunk and Range reads
  decrypt, volume servers hold only ciphertext (nonce + tag overhead),
  manifest chunks are encrypted too, overwrite and delete work; a
  single-chunk upload under seeded randomness stores the same ciphertext
  and the same chunk record in both packages.
Tolerance: equality throughout.
"""

import contextlib
import os
import random

import pytest

from test_torch_filer import PKG, canon, cluster, pin_clocks

CIPHER = {pkg: PKG[pkg].cipher for pkg in PKG}


class _SeededOs:
    """`os` with a seeded urandom (keys and nonces)."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def urandom(self, n):
        return self._rng.randbytes(n)

    def __getattr__(self, name):
        return getattr(os, name)


def _primitive(c, case):
    if case == "roundtrip":
        key = c.gen_cipher_key()
        ct = c.encrypt(b"secret payload", key)
        return key, ct, c.decrypt(ct, key)
    if case == "unique_nonce_per_call":
        key = c.gen_cipher_key()
        return c.encrypt(b"x", key), c.encrypt(b"x", key)
    key = c.gen_cipher_key()
    if case == "bad_tag_rejected":
        ct = bytearray(c.encrypt(b"payload", key))
        ct[-1] ^= 0xFF
        bad, use = bytes(ct), key
    elif case == "wrong_key_rejected":
        bad, use = c.encrypt(b"payload", key), c.gen_cipher_key()
    else:  # truncated_rejected
        bad, use = b"short", key
    with pytest.raises(ValueError) as e:
        c.decrypt(bad, use)
    return str(e.value).split(":")[0]


@pytest.mark.parametrize("case", ["roundtrip", "unique_nonce_per_call",
                                  "bad_tag_rejected", "wrong_key_rejected",
                                  "truncated_rejected"])
def test_cipher_primitives_like_jax(monkeypatch, case):
    out = {}
    for pkg, c in CIPHER.items():
        monkeypatch.setattr(c, "os", _SeededOs(7))
        out[pkg] = _primitive(c, case)
    assert out["port"] == out["jax"]
    if case == "roundtrip":
        key, ct, plain = out["port"]
        assert len(key) == 32 and plain == b"secret payload"
        assert b"secret payload" not in ct
        assert len(ct) == len(plain) + 12 + 16
    elif case == "unique_nonce_per_call":
        assert out["port"][0] != out["port"][1]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_each_package_decrypts_the_other(direction):
    enc, dec = ((CIPHER["jax"], CIPHER["port"])
                if direction == "jax-to-port"
                else (CIPHER["port"], CIPHER["jax"]))
    key = enc.gen_cipher_key()
    payload = bytes(range(256)) * 9
    assert dec.decrypt(enc.encrypt(payload, key), key) == payload


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = tmp_path_factory.mktemp("cipher")
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as es:
        mp.setenv("WEED_MAINT", "0")
        mp.setenv("WEED_MAINT_WORKER", "0")
        out = {}
        for pkg in PKG:
            pin_clocks(mp, pkg)
            out[pkg] = es.enter_context(cluster(pkg, root / pkg,
                                                chunk_size=1024,
                                                cipher=True))
        yield out


def _both(stacks, script):
    out = {pkg: script(*stacks[pkg], PKG[pkg]) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


def _stored(filer, entry, ns):
    return [bytes(ns.rpc.call(filer._lookup_url(c.fid), f"/{c.fid}",
                              timeout=10)) for c in entry.chunks]


def test_multi_chunk_and_range_reads_decrypt_like_jax(stacks):
    payload = bytes(range(256)) * 20

    def script(master, vss, filer, ns):
        entry = filer.save_bytes("/enc/file.bin", payload)
        found = filer.filer.find_entry("/enc/file.bin")
        return ([bool(c.cipher_key) for c in entry.chunks],
                [(c.offset, c.size) for c in entry.chunks],
                filer.read_bytes(found) == payload,
                filer.read_bytes(found, 1500, 100) == payload[1500:1600],
                ns.rpc.call(filer.address, "/enc/file.bin") == payload)

    assert _both(stacks, script) == ([True] * 5,
                                     [(i * 1024, 1024) for i in range(5)],
                                     True, True, True)


def test_volume_stores_only_ciphertext_like_jax(stacks):
    payload = b"VERY-RECOGNIZABLE-PLAINTEXT-" * 100

    def script(master, vss, filer, ns):
        entry = filer.save_bytes("/enc/ct.bin", payload)
        out = []
        for chunk, blob in zip(entry.chunks, _stored(filer, entry, ns)):
            out.append((b"VERY-RECOGNIZABLE" in blob,
                        len(blob) - chunk.size,
                        ns.cipher.decrypt(blob, chunk.cipher_key) ==
                        payload[chunk.offset:chunk.offset + chunk.size]))
        return out

    assert _both(stacks, script) == [(False, 28, True)] * 3


def test_overwrite_and_delete_like_jax(stacks):
    def script(master, vss, filer, ns):
        filer.save_bytes("/enc/ow.bin", b"A" * 3000)
        filer.save_bytes("/enc/ow.bin", b"B" * 2500)
        got = filer.read_bytes(filer.filer.find_entry("/enc/ow.bin"))
        filer.filer.delete_entry("/enc/ow.bin")
        with pytest.raises(ns.store.NotFoundError):
            filer.filer.find_entry("/enc/ow.bin")
        return got

    assert _both(stacks, script) == b"B" * 2500


def test_manifest_chunks_encrypted_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    payload = bytes((i * 31) % 256 for i in range(8 * 512))
    out = {}
    for pkg in PKG:
        with cluster(pkg, tmp_path / pkg, chunk_size=512, cipher=True,
                     manifest_batch=4) as (_, _, filer):
            entry = filer.save_bytes("/enc/manifested.bin", payload)
            out[pkg] = ([c.is_chunk_manifest for c in entry.chunks],
                        all(c.cipher_key for c in entry.chunks),
                        filer.read_bytes(filer.filer.find_entry(
                            "/enc/manifested.bin")) == payload)
    assert out["port"] == out["jax"]
    assert any(out["port"][0]) and out["port"][1:] == (True, True)


def test_single_chunk_ciphertext_equals_jax(tmp_path, monkeypatch):
    """One chunk per file: keys and nonces are drawn on the request
    thread, so seeded randomness gives both filers the same key, nonce
    and stored ciphertext."""
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    bodies = [bytes([i]) * (2100 + 300 * i) for i in range(4)]
    out = {}
    for pkg in PKG:
        ns = PKG[pkg]
        pin_clocks(monkeypatch, pkg)
        with cluster(pkg, tmp_path / pkg, chunk_size=4096,
                     cipher=True) as (_, _, filer):
            monkeypatch.setattr(CIPHER[pkg], "os", _SeededOs(11))
            got = []
            for i, body in enumerate(bodies):
                entry = filer.save_bytes(f"/one/{i}.bin", body)
                got.append((canon(entry.to_dict()),
                            _stored(filer, entry, ns),
                            filer.read_bytes(entry) == body))
            out[pkg] = got
    assert out["port"] == out["jax"]
    for (entry, blobs, ok), body in zip(out["port"], bodies):
        (chunk,) = entry["chunks"]
        assert ok and chunk["cipher_key"] and len(blobs[0]) == len(body) + 28
