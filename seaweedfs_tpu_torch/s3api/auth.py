"""AWS Signature V2/V4 verification for the S3 gateway.

Parity with weed/s3api/auth_signature_v4.go (header-based signing and
presigned query auth), auth_signature_v2.go (legacy HMAC-SHA1 scheme),
policy/post-policy validation (s3api_object_handlers_postpolicy.go), and
auth_credentials.go's identity model: identities with access/secret keys
and allowed actions.  Anonymous access is allowed when no identities are
configured, mirroring the reference's behaviour without a config.

The port's own copy of seaweedfs_tpu/s3api/auth.py.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

ALGORITHM = "AWS4-HMAC-SHA256"
CHUNK_ALGORITHM = "AWS4-HMAC-SHA256-PAYLOAD"
TRAILER_ALGORITHM = "AWS4-HMAC-SHA256-TRAILER"
# payload sentinels for sigv4 streaming uploads (auth_signature_v4.go:50-53;
# the -TRAILER forms are sent by SDKs with flexible checksums enabled)
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_PAYLOAD_TRAILER = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
SIGNED_STREAMING = (STREAMING_PAYLOAD, STREAMING_PAYLOAD_TRAILER)
ALL_STREAMING = SIGNED_STREAMING + (STREAMING_UNSIGNED_TRAILER,)
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
MAX_CLOCK_SKEW_SECONDS = 15 * 60  # AWS allows +/-15 minutes

# sub-resources included in the V2 canonicalized resource
# (auth_signature_v2.go resourceList)
V2_SUBRESOURCES = {
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "tagging", "torrent", "uploadId", "uploads", "versionId", "versioning",
    "versions", "website",
}


def _parse_amz_date(amz_date: str) -> float:
    try:
        return time.mktime(time.strptime(amz_date, "%Y%m%dT%H%M%SZ")) \
            - time.timezone
    except ValueError:
        raise AuthError("AccessDenied", f"malformed date {amz_date!r}", 403)

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_ADMIN = "Admin"


class AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code = code
        self.status = status


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=lambda: [ACTION_ADMIN])

    def can(self, action: str, bucket: str = "") -> bool:
        for a in self.actions:
            if a == ACTION_ADMIN:
                return True
            base, _, target = a.partition(":")
            if base != action:
                continue
            if not target or target == bucket:
                return True
        return False


class IdentityAccessManagement:
    def __init__(self, identities: Optional[list[Identity]] = None):
        self.identities = {i.access_key: i for i in (identities or [])}

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    # -- sigv4 ---------------------------------------------------------------
    def verify(self, method: str, path: str, query: dict, headers,
               body: bytes) -> Optional[Identity]:
        """Verify the request; returns the Identity (None when auth is
        disabled).  Raises AuthError on failure."""
        if not self.enabled:
            return None
        auth_header = headers.get("Authorization", "")
        if auth_header.startswith(ALGORITHM):
            return self._verify_header(method, path, query, headers, body,
                                       auth_header)[0]
        if query.get("X-Amz-Algorithm") == ALGORITHM:
            return self._verify_presigned(method, path, query, headers)
        if auth_header.startswith("AWS "):
            return self._verify_v2_header(method, path, query, headers,
                                          auth_header)
        if "Signature" in query and "AWSAccessKeyId" in query:
            return self._verify_v2_presigned(method, path, query, headers)
        raise AuthError("AccessDenied", "no valid authentication", 403)

    def verify_and_decode(self, method: str, path: str, query: dict,
                          headers, body: bytes):
        """verify() plus streaming-upload handling: when the request is a
        sigv4 streaming upload (x-amz-content-sha256 ==
        STREAMING-AWS4-HMAC-SHA256-PAYLOAD, chunked_reader_v4.go), each
        aws-chunked frame's signature is verified against the seed
        signature chain and the decoded payload is returned.

        Returns (identity, body) where body is the decoded payload for
        streaming requests and the original bytes otherwise."""
        sentinel = headers.get("X-Amz-Content-Sha256", "")
        if not self.enabled:
            # no identities configured: SDKs still send aws-chunked framed
            # bodies — strip the framing (unverifiable without a secret);
            # a declared-but-missing trailer is still a truncation
            if sentinel in ALL_STREAMING:
                body = self._check_decoded_length(
                    headers, self._decode_streaming_body(
                        body,
                        declared_trailer=headers.get("X-Amz-Trailer", "")))
            return None, body
        auth_header = headers.get("Authorization", "")
        if not auth_header.startswith(ALGORITHM):
            # signed streaming requires header auth (AWS rejects it on
            # presigned/sigv2 requests): without the seed-signature chain
            # the chunk signatures are unverifiable, and silently
            # stripping them would advertise integrity we never checked
            if sentinel in SIGNED_STREAMING:
                raise AuthError(
                    "AccessDenied",
                    "signed streaming uploads require AWS4-HMAC-SHA256 "
                    "header authentication", 403)
            # presigned-v4 / sigv2 auth with the UNSIGNED trailer form:
            # SDK flexible-checksum mode frames the body — strip it
            identity = self.verify(method, path, query, headers, body)
            if sentinel in ALL_STREAMING:
                body = self._check_decoded_length(
                    headers, self._decode_streaming_body(
                        body,
                        declared_trailer=headers.get("X-Amz-Trailer", "")))
            return identity, body
        identity, seed, fields = self._verify_header(
            method, path, query, headers, body, auth_header)
        if sentinel not in ALL_STREAMING:
            return identity, body
        if sentinel in SIGNED_STREAMING:
            _, datestamp, region, service, _ = \
                fields["Credential"].split("/")
            scope = f"{datestamp}/{region}/{service}/aws4_request"
            key = self._signing_key(identity.secret_key, datestamp, region,
                                    service)
            decoded = self._decode_streaming_body(
                body, key, seed, headers.get("X-Amz-Date", ""), scope,
                allow_unsigned_final=(sentinel == STREAMING_PAYLOAD_TRAILER),
                declared_trailer=headers.get("X-Amz-Trailer", ""))
        else:  # STREAMING-UNSIGNED-PAYLOAD-TRAILER: frames carry no sigs
            decoded = self._decode_streaming_body(
                body, declared_trailer=headers.get("X-Amz-Trailer", ""))
        return identity, self._check_decoded_length(headers, decoded)

    @staticmethod
    def _check_decoded_length(headers, decoded: bytes) -> bytes:
        declared = headers.get("X-Amz-Decoded-Content-Length")
        if declared is None:
            # AWS mandates the header for aws-chunked uploads; without it
            # a truncation at a chunk boundary would be undetectable
            raise AuthError("MissingContentLength",
                            "streaming upload requires "
                            "x-amz-decoded-content-length", 411)
        try:
            expect = int(declared)
        except ValueError:
            raise AuthError("InvalidRequest",
                            "malformed x-amz-decoded-content-length", 400)
        if expect != len(decoded):
            raise AuthError("IncompleteBody",
                            "decoded length does not match "
                            "x-amz-decoded-content-length", 400)
        return decoded

    @staticmethod
    def _decode_streaming_body(body: bytes, signing_key: bytes = None,
                               seed_signature: str = "", amz_date: str = "",
                               scope: str = "",
                               allow_unsigned_final: bool = False,
                               declared_trailer: str = "") -> bytes:
        """Decode `<hex-size>[;chunk-signature=<sig>]\\r\\n<data>\\r\\n`
        frames.  With a signing_key, each chunk signature is verified
        against the running chain (sigv4-streaming spec;
        chunked_reader_v4.go getChunkSignature).  Trailer headers after
        the final zero-length frame are parsed: every name announced in
        x-amz-trailer must be present, and for the signed -TRAILER form
        the x-amz-trailer-signature is verified over the canonical
        trailer block (AWS4-HMAC-SHA256-TRAILER string-to-sign)."""
        verify_sigs = signing_key is not None
        out = bytearray()
        prev_sig = seed_signature
        pos = 0
        saw_final = False
        trailer_raw = b""
        while pos < len(body):
            eol = body.find(b"\r\n", pos)
            if eol < 0:
                raise AuthError("IncompleteBody",
                                "malformed chunk header", 400)
            header = body[pos:eol].decode("ascii", "replace")
            size_hex, _, ext = header.partition(";")
            try:
                size = int(size_hex, 16)
            except ValueError:
                raise AuthError("IncompleteBody",
                                f"bad chunk size {size_hex!r}", 400)
            chunk_sig = ""
            for token in ext.split(";"):
                k, _, v = token.partition("=")
                if k.strip() == "chunk-signature":
                    chunk_sig = v.strip()
            data = body[eol + 2:eol + 2 + size]
            if len(data) != size:
                raise AuthError("IncompleteBody", "truncated chunk", 400)
            pos = eol + 2 + size
            if body[pos:pos + 2] == b"\r\n":
                pos += 2
            elif size > 0:
                raise AuthError("IncompleteBody",
                                "missing chunk trailer", 400)
            if verify_sigs and not (size == 0 and not chunk_sig
                                    and allow_unsigned_final):
                string_to_sign = "\n".join([
                    CHUNK_ALGORITHM, amz_date, scope, prev_sig,
                    EMPTY_SHA256, hashlib.sha256(data).hexdigest()])
                expected = hmac.new(signing_key, string_to_sign.encode(),
                                    hashlib.sha256).hexdigest()
                if not hmac.compare_digest(expected, chunk_sig):
                    raise AuthError("SignatureDoesNotMatch",
                                    "chunk signature mismatch", 403)
                prev_sig = expected
            if size == 0:
                saw_final = True
                trailer_raw = body[pos:]
                break
            out += data
        if not saw_final:
            raise AuthError("IncompleteBody", "missing final chunk", 400)
        IdentityAccessManagement._check_trailer(
            trailer_raw, declared_trailer,
            signing_key if (verify_sigs and allow_unsigned_final) else None,
            prev_sig, amz_date, scope)
        return bytes(out)

    @staticmethod
    def _check_trailer(trailer_raw: bytes, declared: str,
                       signing_key, prev_sig: str, amz_date: str,
                       scope: str) -> None:
        """Validate the trailing-header block of an aws-chunked body.

        Every name announced in x-amz-trailer must appear (a dropped
        trailer checksum is a truncation, not a no-op), and when
        `signing_key` is set (the STREAMING-...-PAYLOAD-TRAILER form) the
        x-amz-trailer-signature must verify over the canonical
        `name:value\\n` block chained onto the last chunk signature."""
        entries: dict[str, str] = {}
        trailer_sig = ""
        canonical = []
        for line in trailer_raw.split(b"\r\n"):
            if not line:
                continue
            name, sep, value = line.decode("utf8", "replace").partition(":")
            if not sep:
                raise AuthError("IncompleteBody",
                                "malformed trailer header", 400)
            name = name.strip().lower()
            value = value.strip()
            if name == "x-amz-trailer-signature":
                trailer_sig = value
                continue
            entries[name] = value
            canonical.append(f"{name}:{value}\n")
        for want in declared.split(","):
            want = want.strip().lower()
            if want and want not in entries:
                raise AuthError("IncompleteBody",
                                f"missing declared trailer {want}", 400)
        if signing_key is not None:
            if not trailer_sig:
                raise AuthError("SignatureDoesNotMatch",
                                "missing x-amz-trailer-signature", 403)
            string_to_sign = "\n".join([
                TRAILER_ALGORITHM, amz_date, scope, prev_sig,
                hashlib.sha256("".join(canonical).encode()).hexdigest()])
            expected = hmac.new(signing_key, string_to_sign.encode(),
                                hashlib.sha256).hexdigest()
            if not hmac.compare_digest(expected, trailer_sig):
                raise AuthError("SignatureDoesNotMatch",
                                "trailer signature mismatch", 403)

    def _parse_auth_header(self, auth_header: str) -> dict:
        # AWS4-HMAC-SHA256 Credential=AK/date/region/s3/aws4_request,
        #   SignedHeaders=a;b;c, Signature=hex
        parts = auth_header[len(ALGORITHM):].strip().split(",")
        fields = {}
        for part in parts:
            k, _, v = part.strip().partition("=")
            fields[k] = v
        missing = {"Credential", "SignedHeaders", "Signature"} - set(fields)
        if missing:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"missing {missing}", 400)
        return fields

    def _verify_header(self, method, path, query, headers, body,
                       auth_header) -> tuple[Identity, str, dict]:
        fields = self._parse_auth_header(auth_header)
        cred_parts = fields["Credential"].split("/")
        if len(cred_parts) != 5:
            raise AuthError("AuthorizationHeaderMalformed",
                            "bad credential scope", 400)
        access_key, datestamp, region, service, terminal = cred_parts
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}", 403)
        signed_headers = fields["SignedHeaders"].split(";")
        amz_date = headers.get("X-Amz-Date", "")
        if abs(time.time() - _parse_amz_date(amz_date)) \
                > MAX_CLOCK_SKEW_SECONDS:
            raise AuthError("RequestTimeTooSkewed",
                            "request time too skewed", 403)
        payload_hash = headers.get("X-Amz-Content-Sha256", "")
        if payload_hash in ("", "UNSIGNED-PAYLOAD"):
            payload_hash = payload_hash or hashlib.sha256(body).hexdigest()
        elif payload_hash.startswith("STREAMING-"):
            pass  # chunked uploads sign the seed; body chunks carry their own
        else:
            # an explicit hex digest must bind the actual body, or the
            # signature doesn't cover the payload at all
            if not hmac.compare_digest(payload_hash,
                                       hashlib.sha256(body).hexdigest()):
                raise AuthError("XAmzContentSHA256Mismatch",
                                "x-amz-content-sha256 does not match the "
                                "request payload", 400)
        canonical = self._canonical_request(
            method, path, query, headers, signed_headers, payload_hash)
        scope = f"{datestamp}/{region}/{service}/{terminal}"
        string_to_sign = "\n".join([
            ALGORITHM, amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])
        signature = self._signature(identity.secret_key, datestamp, region,
                                    service, string_to_sign)
        if not hmac.compare_digest(signature, fields["Signature"]):
            raise AuthError("SignatureDoesNotMatch",
                            "signature mismatch", 403)
        return identity, signature, fields

    def _verify_presigned(self, method, path, query, headers) -> Identity:
        cred = query.get("X-Amz-Credential", "")
        cred_parts = cred.split("/")
        if len(cred_parts) != 5:
            raise AuthError("AuthorizationQueryParametersError",
                            "bad credential", 400)
        access_key, datestamp, region, service, terminal = cred_parts
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}", 403)
        amz_date = query.get("X-Amz-Date", "")
        request_time = _parse_amz_date(amz_date)
        expires = int(query.get("X-Amz-Expires", "604800"))
        if time.time() > request_time + expires:
            raise AuthError("AccessDenied", "request has expired", 403)
        if time.time() + MAX_CLOCK_SKEW_SECONDS < request_time:
            raise AuthError("RequestTimeTooSkewed",
                            "request time too skewed", 403)
        signed_headers = query.get("X-Amz-SignedHeaders", "host").split(";")
        provided = query.get("X-Amz-Signature", "")
        q = {k: v for k, v in query.items() if k != "X-Amz-Signature"}
        canonical = self._canonical_request(
            method, path, q, headers, signed_headers, "UNSIGNED-PAYLOAD")
        scope = f"{datestamp}/{region}/{service}/{terminal}"
        string_to_sign = "\n".join([
            ALGORITHM, amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])
        signature = self._signature(identity.secret_key, datestamp, region,
                                    service, string_to_sign)
        if not hmac.compare_digest(signature, provided):
            raise AuthError("SignatureDoesNotMatch",
                            "signature mismatch", 403)
        return identity

    # -- sigv2 (auth_signature_v2.go) ----------------------------------------
    def _v2_string_to_sign(self, method, path, query, headers,
                           date_value: str) -> str:
        amz_headers = sorted(
            (k.lower(), " ".join(str(v).split()))
            for k, v in headers.items()
            if k.lower().startswith("x-amz-"))
        canonical_amz = "".join(f"{k}:{v}\n" for k, v in amz_headers)
        resource = urllib.parse.quote(path, safe="/~")
        subs = sorted(k for k in query if k in V2_SUBRESOURCES)
        if subs:
            pairs = []
            for k in subs:
                v = query[k]
                pairs.append(f"{k}={v}" if v not in ("", None) else k)
            resource += "?" + "&".join(pairs)
        return "\n".join([
            method,
            headers.get("Content-Md5", "") or headers.get("Content-MD5", ""),
            headers.get("Content-Type", "") or "",
            date_value,
            canonical_amz + resource])

    @staticmethod
    def _v2_signature(secret: str, string_to_sign: str) -> str:
        return base64.b64encode(
            hmac.new(secret.encode(), string_to_sign.encode(),
                     hashlib.sha1).digest()).decode()

    def _verify_v2_header(self, method, path, query, headers,
                          auth_header) -> Identity:
        try:
            access_key, provided = auth_header[4:].strip().split(":", 1)
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed",
                            "bad v2 authorization header", 400)
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}", 403)
        # x-amz-date supersedes Date in the string-to-sign (v2 spec)
        date_value = "" if headers.get("X-Amz-Date") \
            else (headers.get("Date", "") or "")
        string_to_sign = self._v2_string_to_sign(method, path, query,
                                                 headers, date_value)
        expected = self._v2_signature(identity.secret_key, string_to_sign)
        if not hmac.compare_digest(expected, provided):
            raise AuthError("SignatureDoesNotMatch",
                            "v2 signature mismatch", 403)
        return identity

    def _verify_v2_presigned(self, method, path, query, headers) -> Identity:
        access_key = query.get("AWSAccessKeyId", "")
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}", 403)
        expires = query.get("Expires", "0")
        try:
            if time.time() > int(expires):
                raise AuthError("AccessDenied", "request has expired", 403)
        except ValueError:
            raise AuthError("AccessDenied", "malformed Expires", 403)
        string_to_sign = self._v2_string_to_sign(method, path, query,
                                                 headers, expires)
        expected = self._v2_signature(identity.secret_key, string_to_sign)
        if not hmac.compare_digest(expected, query.get("Signature", "")):
            raise AuthError("SignatureDoesNotMatch",
                            "v2 signature mismatch", 403)
        return identity

    # -- POST policy (policy/post-policy, s3api postpolicy handlers) ---------
    def verify_post_policy(self, form: dict[str, str]) -> Identity:
        """Validate a browser-POST upload: signature over the base64 policy
        document, policy expiration, and its conditions against the form
        fields.  Returns the signing identity."""
        policy_b64 = form.get("policy", "")
        if not policy_b64:
            if not self.enabled:
                return None  # anonymous post without a policy
            raise AuthError("AccessDenied", "missing policy", 403)
        if "x-amz-signature" in form:  # v4-signed policy
            cred_parts = form.get("x-amz-credential", "").split("/")
            if len(cred_parts) != 5:
                raise AuthError("AuthorizationQueryParametersError",
                                "bad credential", 400)
            access_key, datestamp, region, service, _ = cred_parts
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError("InvalidAccessKeyId",
                                f"unknown access key {access_key}", 403)
            expected = self._signature(identity.secret_key, datestamp,
                                       region, service, policy_b64)
            if not hmac.compare_digest(expected,
                                       form.get("x-amz-signature", "")):
                raise AuthError("SignatureDoesNotMatch",
                                "policy signature mismatch", 403)
        elif "signature" in form:  # v2-signed policy
            access_key = form.get("awsaccesskeyid", "")  # form keys lowered
            identity = self.identities.get(access_key)
            if identity is None:
                raise AuthError("InvalidAccessKeyId",
                                f"unknown access key {access_key}", 403)
            expected = self._v2_signature(identity.secret_key, policy_b64)
            if not hmac.compare_digest(expected, form.get("signature", "")):
                raise AuthError("SignatureDoesNotMatch",
                                "policy signature mismatch", 403)
        else:
            raise AuthError("AccessDenied", "unsigned policy", 403)
        self._check_policy_conditions(policy_b64, form)
        return identity

    @staticmethod
    def _check_policy_conditions(policy_b64: str, form: dict[str, str]):
        try:
            policy = json.loads(base64.b64decode(policy_b64))
        except (ValueError, TypeError):
            raise AuthError("InvalidPolicyDocument", "unparsable policy",
                            400)
        expiration = policy.get("expiration", "")
        try:
            exp_ts = time.mktime(time.strptime(
                expiration.split(".")[0].rstrip("Z"),
                "%Y-%m-%dT%H:%M:%S")) - time.timezone
        except ValueError:
            raise AuthError("InvalidPolicyDocument", "bad expiration", 400)
        if time.time() > exp_ts:
            raise AuthError("AccessDenied", "policy expired", 403)
        size = len(form.get("__file_bytes__", b""))
        for cond in policy.get("conditions", []):
            if isinstance(cond, dict):
                for k, v in cond.items():
                    if k.lower().startswith("x-ignore-"):
                        continue
                    have = form.get(k.lower(), form.get(k, ""))
                    if str(have) != str(v):
                        raise AuthError(
                            "AccessDenied",
                            f"policy condition failed: {k}", 403)
            elif isinstance(cond, list) and len(cond) == 3:
                op, name, value = cond[0], cond[1], cond[2]
                if op == "content-length-range":
                    try:
                        lo, hi = int(name), int(value)
                    except (TypeError, ValueError):
                        raise AuthError("InvalidPolicyDocument",
                                        "bad content-length-range", 400)
                    if not (lo <= size <= hi):
                        raise AuthError("EntityTooLarge" if size > hi
                                        else "EntityTooSmall",
                                        "content length out of range", 400)
                    continue
                name = str(name).lstrip("$").lower()
                if op == "eq":
                    if str(form.get(name, "")) != str(value):
                        raise AuthError("AccessDenied",
                                        f"eq condition failed: {name}", 403)
                elif op == "starts-with":
                    if not str(form.get(name, "")).startswith(str(value)):
                        raise AuthError(
                            "AccessDenied",
                            f"starts-with condition failed: {name}", 403)
                # unknown operators are ignored, like the reference

    @staticmethod
    def _canonical_request(method, path, query, headers, signed_headers,
                           payload_hash) -> str:
        canonical_uri = urllib.parse.quote(path, safe="/~")
        q_pairs = sorted(
            (urllib.parse.quote(k, safe="~"),
             urllib.parse.quote(str(v), safe="~"))
            for k, v in query.items())
        canonical_query = "&".join(f"{k}={v}" for k, v in q_pairs)
        header_lines = []
        for name in signed_headers:
            value = headers.get(name) or ""
            header_lines.append(f"{name}:{' '.join(value.split())}")
        return "\n".join([
            method, canonical_uri, canonical_query,
            "\n".join(header_lines) + "\n",
            ";".join(signed_headers), payload_hash])

    # derived-key memo: the 4-chained-HMAC key derivation depends only
    # on (secret, datestamp, region, service) — constant for a client
    # all day — so every request after the first skips it.  Keyed by the
    # full tuple, an evicted/rotated secret simply misses.
    _key_cache_lock = threading.Lock()
    _key_cache: "OrderedDict[tuple, bytes]" = OrderedDict()
    _KEY_CACHE_MAX = 512

    @classmethod
    def _signing_key(cls, secret, datestamp, region, service) -> bytes:
        from ..stats.metrics import S3SigV4KeyCacheCounter

        ck = (secret, datestamp, region, service)
        with cls._key_cache_lock:
            cached = cls._key_cache.get(ck)
            if cached is not None:
                cls._key_cache.move_to_end(ck)
        S3SigV4KeyCacheCounter.labels(
            "hit" if cached is not None else "miss").inc()
        if cached is not None:
            return cached

        def h(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k_date = h(("AWS4" + secret).encode(), datestamp)
        k_region = h(k_date, region)
        k_service = h(k_region, service)
        k_signing = h(k_service, "aws4_request")
        with cls._key_cache_lock:
            cls._key_cache[ck] = k_signing
            while len(cls._key_cache) > cls._KEY_CACHE_MAX:
                cls._key_cache.popitem(last=False)
        return k_signing

    @classmethod
    def _signature(cls, secret, datestamp, region, service,
                   string_to_sign) -> str:
        k_signing = cls._signing_key(secret, datestamp, region, service)
        return hmac.new(k_signing, string_to_sign.encode(),
                        hashlib.sha256).hexdigest()
