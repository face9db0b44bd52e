"""Minimal SigV4-signing S3 client (path-style).

The reference links the AWS Go SDK for its s3 sink and remote-storage
provider (replication/sink/s3sink, remote_storage/s3); this environment
has no SDK and no egress, so replication/remote-storage speak to any
S3-compatible endpoint — including this framework's own s3api gateway —
through this hand-rolled client.

The port's own copy of seaweedfs_tpu/wdclient/s3_client.py.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
from typing import Optional

from ..rpc.http_rpc import RpcError, call

ALGORITHM = "AWS4-HMAC-SHA256"


class S3Client:
    def __init__(self, endpoint: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1"):
        self.endpoint = endpoint  # host:port
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    # -- signing -------------------------------------------------------------
    def _sign(self, method: str, path: str, query: dict,
              body: bytes, payload_hash: str = "",
              extra_headers: Optional[dict] = None) -> dict:
        """SigV4 header auth.  payload_hash overrides the body digest
        (for the streaming sentinel); extra_headers join the SIGNED
        header set.  Also returns the computed signature and scope under
        private "_sig"/"_scope"/"_datestamp" keys (popped before
        sending) so the streaming path can chain chunk signatures."""
        if not self.access_key:
            return {}
        now = time.gmtime()
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
        datestamp = time.strftime("%Y%m%d", now)
        payload_hash = payload_hash or hashlib.sha256(body).hexdigest()
        headers = {
            "Host": self.endpoint,
            "X-Amz-Date": amz_date,
            "X-Amz-Content-Sha256": payload_hash,
            **(extra_headers or {}),
        }
        signed = sorted(k.lower() for k in headers)
        canonical_uri = urllib.parse.quote(path, safe="/~")
        canonical_query = self._canonical_query(query)
        lower = {k.lower(): v for k, v in headers.items()}
        header_lines = [f"{name}:{' '.join(str(lower[name]).split())}"
                        for name in signed]
        canonical = "\n".join([
            method, canonical_uri, canonical_query,
            "\n".join(header_lines) + "\n", ";".join(signed), payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            ALGORITHM, amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        signature = hmac.new(self._signing_key(datestamp),
                             string_to_sign.encode(),
                             hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"{ALGORITHM} Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={signature}")
        headers["_sig"] = signature
        headers["_scope"] = scope
        headers["_amz_date"] = amz_date
        headers["_datestamp"] = datestamp
        return headers

    def _signing_key(self, datestamp: str) -> bytes:
        def h(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(("AWS4" + self.secret_key).encode(), datestamp)
        for part in (self.region, "s3", "aws4_request"):
            k = h(k, part)
        return k

    @staticmethod
    def _canonical_query(query: dict) -> str:
        """AWS canonical query: sorted pairs, %20 percent-encoding (never
        urlencode's '+', which decodes as a space but signs as a literal
        plus).  The SAME string is signed and sent, by construction."""
        return "&".join(
            f"{k}={v}" for k, v in sorted(
                (urllib.parse.quote(k, safe="~"),
                 urllib.parse.quote(str(v), safe="~"))
                for k, v in query.items()))

    @staticmethod
    def _strip_private(headers: dict) -> dict:
        return {k: v for k, v in headers.items()
                if not k.startswith("_")}

    def _request(self, method: str, path: str,
                 query: Optional[dict] = None, body: bytes = b"",
                 content_type: str = "", parse: bool = True):
        query = query or {}
        headers = self._strip_private(self._sign(method, path, query, body))
        if content_type:
            headers["Content-Type"] = content_type
        qs = self._canonical_query(query)
        full = urllib.parse.quote(path, safe="/~") + ("?" + qs if qs else "")
        return call(self.endpoint, full, raw=body if body else None,
                    method=method, headers=headers, timeout=120,
                    parse=parse)

    # -- object ops ----------------------------------------------------------
    def create_bucket(self, bucket: str):
        try:
            self._request("PUT", f"/{bucket}")
        except RpcError as e:
            if e.status != 409:  # BucketAlreadyExists is fine
                raise

    def delete_bucket(self, bucket: str):
        self._request("DELETE", f"/{bucket}")

    def put_object(self, bucket: str, key: str, data: bytes,
                   content_type: str = "application/octet-stream"):
        self._request("PUT", f"/{bucket}/{key.lstrip('/')}", body=data,
                      content_type=content_type)

    def put_object_streaming(self, bucket: str, key: str, data,
                             chunk_size: int = 64 << 10,
                             content_type: str =
                             "application/octet-stream"):
        """Upload with sigv4 streaming chunk signatures (aws-chunked,
        STREAMING-AWS4-HMAC-SHA256-PAYLOAD): each frame is individually
        signed against the seed chain.  `data` is bytes-like or an
        iterable of byte chunks (empty chunks are skipped — a zero
        frame terminates the stream)."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
            pieces = [data[i:i + chunk_size]
                      for i in range(0, len(data), chunk_size)]
        else:
            pieces = [bytes(p) for p in data if len(p)]
        if not self.access_key:
            # unsigned gateways take a plain PUT
            return self.put_object(bucket, key, b"".join(pieces),
                                   content_type)
        total = sum(len(p) for p in pieces)
        path = f"/{bucket}/{key.lstrip('/')}"
        headers = self._sign(
            "PUT", path, {}, b"",
            payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
            extra_headers={
                "Content-Encoding": "aws-chunked",
                "X-Amz-Decoded-Content-Length": str(total),
                "Content-Type": content_type,
            })
        k = self._signing_key(headers["_datestamp"])
        amz_date, scope = headers["_amz_date"], headers["_scope"]
        prev = headers["_sig"]
        headers = self._strip_private(headers)
        empty = hashlib.sha256(b"").hexdigest()
        frames = bytearray()
        pieces.append(b"")  # terminator frame
        while pieces:  # consume as we frame: one resident copy, not two
            piece = pieces.pop(0)
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev, empty,
                hashlib.sha256(piece).hexdigest()])
            sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
            frames += f"{len(piece):x};chunk-signature={sig}\r\n".encode()
            frames += piece + b"\r\n"
            prev = sig
        call(self.endpoint, urllib.parse.quote(path, safe="/~"),
             raw=bytes(frames), method="PUT", headers=headers,
             timeout=300)

    def get_object(self, bucket: str, key: str) -> bytes:
        body = self._request("GET", f"/{bucket}/{key.lstrip('/')}",
                             parse=False)
        return body if isinstance(body, bytes) else b""

    def get_object_range(self, bucket: str, key: str, offset: int,
                         size: int) -> bytes:
        """Ranged GET (unsigned Range header rides alongside SigV4)."""
        path = f"/{bucket}/{key.lstrip('/')}"
        headers = self._sign("GET", path, {}, b"")
        headers["Range"] = f"bytes={offset}-{offset + size - 1}"
        body = call(self.endpoint,
                    urllib.parse.quote(path, safe="/~"), method="GET",
                    headers=headers, timeout=120, parse=False)
        return body if isinstance(body, bytes) else b""

    def delete_object(self, bucket: str, key: str):
        try:
            self._request("DELETE", f"/{bucket}/{key.lstrip('/')}")
        except RpcError as e:
            if e.status != 404:
                raise

    def list_objects(self, bucket: str,
                     prefix: str = "") -> list[dict]:
        """ListObjectsV2 with pagination; returns
        [{key, size, etag, last_modified}]."""
        import xml.etree.ElementTree as ET

        def text(node, tag):
            child = node.find(f"{{*}}{tag}")
            return child.text or "" if child is not None else ""

        objects: list[dict] = []
        start_after = ""
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if start_after:
                query["start-after"] = start_after
            body = self._request("GET", f"/{bucket}", query=query)
            if not isinstance(body, bytes):
                break
            root = ET.fromstring(body)
            page = root.findall("{*}Contents")
            for node in page:
                objects.append({
                    "key": text(node, "Key"),
                    "size": int(text(node, "Size") or 0),
                    "etag": text(node, "ETag").strip('"'),
                    "last_modified": text(node, "LastModified"),
                })
            if not page or text(root, "IsTruncated") != "true":
                break
            start_after = objects[-1]["key"]
        return objects

    def list_keys(self, bucket: str, prefix: str = "") -> list[str]:
        return [o["key"] for o in self.list_objects(bucket, prefix)]
