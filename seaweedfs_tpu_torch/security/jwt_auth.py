"""JWT write/read tokens + IP allow-list guard.

The reference mints an HS256 JWT on /dir/assign scoped to one fid and
verifies it on volume-server writes (weed/security/jwt.go: SeaweedFileIdClaims
with "fid"; guard.go:18-50: Guard{whiteList, signingKey, expires}).  Keys and
allow-lists come from security.toml ([jwt.signing] signing_key,
expires_after_seconds; white_list).  Same model here: HS256 via stdlib hmac,
no external jwt dependency.

Counterpart of seaweedfs_tpu/security/jwt_auth.py.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import ipaddress
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

_DEFAULT_JWT_CACHE = 4096


def jwt_cache_size() -> int:
    """Entries in the signature-verification LRU; 0 disables caching."""
    raw = os.environ.get("WEED_JWT_CACHE_SIZE", "")
    if not raw:
        return _DEFAULT_JWT_CACHE
    try:
        return max(0, int(raw))
    except ValueError:
        return _DEFAULT_JWT_CACHE


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(text: str) -> bytes:
    return base64.urlsafe_b64decode(text + "=" * (-len(text) % 4))


# HMAC-SHA256 key schedules, precomputed once per key and copied per
# call: hashing the padded key blocks dominates HMAC cost for the short
# signing inputs JWTs use, and the key set is tiny (one or two per
# daemon)
_mac_lock = threading.Lock()
_mac_templates: dict[bytes, "hmac.HMAC"] = {}


def _sign(key: bytes, msg: bytes) -> bytes:
    with _mac_lock:
        tmpl = _mac_templates.get(key)
        if tmpl is None:
            if len(_mac_templates) >= 64:
                _mac_templates.clear()
            tmpl = _mac_templates[key] = hmac.new(
                key, digestmod=hashlib.sha256)
        mac = tmpl.copy()
    mac.update(msg)
    return mac.digest()


def encode_jwt(key: bytes, claims: dict) -> str:
    header = _b64url(json.dumps(
        {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = ("%s.%s" % (header, payload)).encode()
    return "%s.%s.%s" % (header, payload, _b64url(_sign(key, signing_input)))


# signature-keyed verification LRU: a count>N assign shares one token
# across N chunk writes, so the volume/filer side re-verifies the same
# (key, token) pair over and over.  Only SUCCESSFUL signature checks are
# cached, and `exp` is re-evaluated on every call, so a cache hit can
# never outlive the token itself.
_verify_lock = threading.Lock()
_verified: "OrderedDict[tuple[bytes, str], dict]" = OrderedDict()


def _jwt_cache_clear():
    with _verify_lock:
        _verified.clear()


def decode_jwt(key: bytes, token: str) -> dict:
    """Verify signature + exp; returns claims. Raises ValueError on failure."""
    size = jwt_cache_size()
    claims = None
    ck = (key, token)
    if size > 0:
        with _verify_lock:
            claims = _verified.get(ck)
            if claims is not None:
                _verified.move_to_end(ck)
        from ..stats.metrics import JwtCacheCounter

        JwtCacheCounter.labels("hit" if claims is not None else "miss").inc()
    if claims is None:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
        except ValueError:
            raise ValueError("malformed token")
        header = json.loads(_unb64url(header_b64))
        if header.get("alg") != "HS256":
            raise ValueError("unexpected algorithm %r" % header.get("alg"))
        signing_input = ("%s.%s" % (header_b64, payload_b64)).encode()
        if not hmac.compare_digest(_sign(key, signing_input),
                                   _unb64url(sig_b64)):
            raise ValueError("bad signature")
        claims = json.loads(_unb64url(payload_b64))
        if size > 0:
            with _verify_lock:
                _verified[ck] = claims
                while len(_verified) > size:
                    _verified.popitem(last=False)
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise ValueError("token expired")
    return claims


class SigningKey:
    def __init__(self, key: str | bytes, expires_after_seconds: int = 10):
        self.key = key.encode() if isinstance(key, str) else bytes(key)
        self.expires_after_seconds = expires_after_seconds

    def __bool__(self) -> bool:
        return len(self.key) > 0


def gen_write_jwt(signing: SigningKey, fid: str) -> str:
    """Token scoped to one file id, as minted on assign
    (weed/security/jwt.go GenJwtForVolumeServer)."""
    if not signing:
        return ""
    claims = {"fid": fid}
    if signing.expires_after_seconds > 0:
        claims["exp"] = int(time.time()) + signing.expires_after_seconds
    return encode_jwt(signing.key, claims)


def gen_read_jwt(signing: SigningKey, fid: str) -> str:
    if not signing:
        return ""
    claims = {"fid": fid}
    if signing.expires_after_seconds > 0:
        claims["exp"] = int(time.time()) + signing.expires_after_seconds
    return encode_jwt(signing.key, claims)


class Guard:
    """Combines an IP allow-list with JWT verification
    (weed/security/guard.go:18-50)."""

    def __init__(self, white_list: Optional[list[str]] = None,
                 signing_key: str | bytes = b"",
                 expires_after_seconds: int = 10,
                 read_signing_key: str | bytes = b"",
                 read_expires_after_seconds: int = 60):
        self.white_list = [w for w in (white_list or []) if w]
        self.signing = SigningKey(signing_key, expires_after_seconds)
        self.read_signing = SigningKey(read_signing_key,
                                       read_expires_after_seconds)

    @property
    def is_active(self) -> bool:
        return bool(self.white_list) or bool(self.signing)

    def check_white_list(self, peer_ip: str) -> bool:
        if not self.white_list:
            return True
        try:
            peer = ipaddress.ip_address(peer_ip)
        except ValueError:
            return False
        for entry in self.white_list:
            try:
                if "/" in entry:
                    if peer in ipaddress.ip_network(entry, strict=False):
                        return True
                elif peer == ipaddress.ip_address(entry):
                    return True
            except ValueError:
                continue
        return False

    def verify_write(self, token: str, fid: str) -> None:
        """Raises PermissionError unless the token authorizes writing fid."""
        if not self.signing:
            return
        if not token:
            raise PermissionError("missing jwt")
        try:
            claims = decode_jwt(self.signing.key, token)
        except ValueError as e:
            raise PermissionError("jwt: %s" % e)
        claimed = claims.get("fid", "")
        # a count>1 assign returns one token for fid plus fid_1..fid_N
        # (the reference's file-id delta convention), so compare the base;
        # volume-level tokens ("3,") authorize any fid in the volume
        if claimed != fid.split("_")[0] and not (
                claimed.endswith(",") and fid.startswith(claimed)):
            raise PermissionError("jwt fid mismatch")

    def verify_read(self, token: str, fid: str) -> None:
        if not self.read_signing:
            return
        if not token:
            raise PermissionError("missing read jwt")
        try:
            claims = decode_jwt(self.read_signing.key, token)
        except ValueError as e:
            raise PermissionError("jwt: %s" % e)
        if claims.get("fid", "") != fid:
            raise PermissionError("jwt fid mismatch")


def token_from_request(headers, query: dict) -> str:
    """Authorization: BEARER <t> header, else ?jwt= query param
    (weed/security/jwt.go GetJwt)."""
    auth = headers.get("Authorization", "") if headers is not None else ""
    if auth.upper().startswith("BEARER "):
        return auth[7:].strip()
    return query.get("jwt", "")
