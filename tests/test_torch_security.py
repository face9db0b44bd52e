"""The port's JWT tokens and IP guard (seaweedfs_tpu_torch/security)
against the JAX package: tokens byte-equal across packages, each package
decoding the other's, and `Guard` decisions equal on the same white lists
and keys."""

import random
import time

import pytest

from test_torch_metrics import _Delta

from seaweedfs_tpu import security as j_sec
from seaweedfs_tpu.security import jwt_auth as j_jwt
from seaweedfs_tpu_torch import security as t_sec
from seaweedfs_tpu_torch.security import jwt_auth as t_jwt

FIDS = ["3,01637037d6", "3,01637037d6_1", "3,01637037d6_12", "4,ab12cd34ef",
        "3,", "30,01637037d6", "3,01637037d7"]


@pytest.fixture(autouse=True)
def _fresh_caches():
    j_jwt._jwt_cache_clear()
    t_jwt._jwt_cache_clear()
    yield
    j_jwt._jwt_cache_clear()
    t_jwt._jwt_cache_clear()


@pytest.fixture
def frozen_time(monkeypatch):
    now = [1_700_000_000.25]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


@pytest.mark.parametrize("claims", [
    {"fid": "3,01637037d6"},
    {"fid": "3,", "exp": 1_700_000_100},
    {"fid": "9,ff", "exp": 1_700_000_100, "extra": [1, "ü", None]},
    {},
])
@pytest.mark.parametrize("key", [b"k", b"secret key \x00\xff", "strkey"])
def test_encode_byte_equal_and_cross_decode(claims, key, frozen_time):
    kb = key.encode() if isinstance(key, str) else key
    tok = t_sec.encode_jwt(kb, claims)
    assert tok == j_sec.encode_jwt(kb, claims)
    assert j_sec.decode_jwt(kb, tok) == claims
    assert t_sec.decode_jwt(kb, j_sec.encode_jwt(kb, claims)) == claims


def test_write_and_read_tokens_equal(frozen_time):
    for exp in (0, 10, 60):
        for fid in FIDS:
            ts = t_sec.SigningKey("wkey", exp)
            js = j_sec.SigningKey("wkey", exp)
            assert t_sec.gen_write_jwt(ts, fid) == j_sec.gen_write_jwt(js, fid)
            assert t_sec.gen_read_jwt(ts, fid) == j_sec.gen_read_jwt(js, fid)
    assert t_sec.gen_write_jwt(t_sec.SigningKey(""), "3,01") == ""


def test_decode_failures_equal(frozen_time):
    good = t_sec.encode_jwt(b"k", {"fid": "1,", "exp": 1_700_000_001})
    header, payload, sig = good.split(".")
    bad = [good + "x", "a.b", "", header + "." + payload + ".AAAA",
           j_jwt._b64url(b'{"alg":"none","typ":"JWT"}') + "." + payload +
           "." + sig]
    for tok in bad:
        errs = []
        for mod in (t_sec, j_sec):
            with pytest.raises(Exception) as e:
                mod.decode_jwt(b"k", tok)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1], tok
    frozen_time[0] += 5  # past exp
    for mod in (t_sec, j_sec):
        with pytest.raises(ValueError, match="token expired"):
            mod.decode_jwt(b"k", good)


def _guard_decisions(sec, seed: int):
    rng = random.Random(seed)
    white = ["127.0.0.1", "10.0.0.0/8", "::1", "bogus", "192.168.1.7"]
    g = sec.Guard(white_list=white, signing_key="wk",
                  expires_after_seconds=10, read_signing_key="rk",
                  read_expires_after_seconds=60)
    ws, rs = sec.SigningKey("wk", 10), sec.SigningKey("rk", 60)
    out = [g.is_active]
    for ip in ["127.0.0.1", "10.9.8.7", "11.0.0.1", "::1", "::2",
               "192.168.1.7", "not-an-ip", ""]:
        out.append(g.check_white_list(ip))
    for _ in range(200):
        fid = rng.choice(FIDS)
        other = rng.choice(FIDS)
        kind = rng.choice(["write", "read"])
        key = rng.choice([ws, rs, sec.SigningKey("zz", 10)])
        tok = rng.choice([sec.gen_write_jwt(key, other), "", "x.y.z"])
        try:
            getattr(g, f"verify_{kind}")(tok, fid)
            out.append("ok")
        except PermissionError as e:
            out.append(str(e))
    for headers, query in [({"Authorization": "BEARER abc"}, {}),
                           ({"Authorization": "bearer  abc "}, {}),
                           ({}, {"jwt": "q"}), (None, {}),
                           ({"Authorization": "Basic x"}, {"jwt": "z"})]:
        out.append(sec.token_from_request(headers, query))
    open_guard = sec.Guard()
    out += [open_guard.is_active, open_guard.check_white_list("1.2.3.4")]
    open_guard.verify_write("", "3,01")
    open_guard.verify_read("", "3,01")
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_guard_decisions_equal(seed, frozen_time):
    with _Delta(("SeaweedFS_security_",)) as d:
        got = _guard_decisions(t_sec, seed)
        want = _guard_decisions(j_sec, seed)
    assert got == want
    assert "ok" in got and "jwt fid mismatch" in got
    assert d.jax == d.port and d.port


def test_expired_token_refused_by_both_guards(frozen_time):
    tok = t_sec.gen_write_jwt(t_sec.SigningKey("wk", 10), "3,01")
    frozen_time[0] += 11
    for sec in (t_sec, j_sec):
        with pytest.raises(PermissionError, match="expired"):
            sec.Guard(signing_key="wk").verify_write(tok, "3,01")
