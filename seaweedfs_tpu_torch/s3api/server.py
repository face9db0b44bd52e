"""S3-compatible gateway over the filer.

Parity with weed/s3api/s3api_server.go's route table: bucket CRUD +
listing (v1/v2), object CRUD with Range/metadata/tagging, CopyObject,
multi-delete, and multipart uploads, with AWS SigV4 auth (auth.py) and
XML wire format.  Buckets live under /buckets/<name> in the filer
namespace, like the reference's filer integration (filer_multipart.go,
s3api_objects_*.go); multipart parts are staged under
/buckets/<b>/.uploads/<uploadId>/ and composed by chunk-list rebasing.

The port's own copy of seaweedfs_tpu/s3api/server.py.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

from ..filer.entry import Entry, FileChunk, new_directory_entry
from ..filer.filechunk_manifest import (has_chunk_manifest,
                                        resolve_chunk_manifest)
from ..filer.filer_store import NotFoundError
from ..filer.server import FilerServer
from .. import profiling, qos, tracing
from ..rpc.http_rpc import Request, Response, RpcError, RpcServer
from ..stats import access
from ..stats import events as events_mod
from ..stats import healthz
from ..stats import metrics as stats
from ..util import faults
from .auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ, ACTION_WRITE,
                   AuthError, Identity, IdentityAccessManagement)
from .circuit_breaker import CircuitBreaker, SlowDown
from .circuit_breaker import read_config as cb_read_config

BUCKETS_ROOT = "/buckets"
UPLOADS_DIR = ".uploads"


def parse_multipart_form(content_type: str, body: bytes) -> dict:
    """Minimal multipart/form-data parser for browser POST uploads.
    Returns field name -> str value, plus '__file_bytes__' (bytes) and
    '__file_name__' for the file part."""
    if "boundary=" not in content_type:
        raise RpcError("missing multipart boundary", 400)
    boundary = content_type.split("boundary=", 1)[1].split(";")[0].strip()
    boundary = boundary.strip('"')
    form: dict = {}
    delim = b"--" + boundary.encode()
    for part in body.split(delim):
        # each part is wrapped in exactly one CRLF on each side; strip only
        # those delimiters — trailing \r\n bytes may belong to the payload
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part in (b"--", b"--\r\n"):
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        disposition = ""
        for line in head.decode("utf-8", "replace").splitlines():
            if line.lower().startswith("content-disposition:"):
                disposition = line
        name = ""
        filename = None
        for item in disposition.split(";"):
            item = item.strip()
            if item.startswith("name="):
                name = item[5:].strip('"')
            elif item.startswith("filename="):
                filename = item[9:].strip('"')
        if not name:
            continue
        if name == "file" or filename is not None:
            form["__file_bytes__"] = payload
            form["__file_name__"] = filename or ""
        else:
            form[name.lower()] = payload.decode("utf-8", "replace")
    return form


def _xml(tag: str, children) -> bytes:
    root = ET.Element(tag,
                      xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
    _build(root, children)
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))


def _build(parent, children):
    if isinstance(children, dict):
        for k, v in children.items():
            if isinstance(v, list):
                for item in v:
                    node = ET.SubElement(parent, k)
                    _build(node, item)
            else:
                node = ET.SubElement(parent, k)
                _build(node, v)
    else:
        parent.text = "" if children is None else str(children)


def _error_xml(code: str, message: str, status: int,
               headers: Optional[dict] = None) -> Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message
    resp = Response(ET.tostring(root), status, "application/xml")
    if headers:
        resp.headers.update(headers)
    return resp


class S3ApiServer:
    def __init__(self, filer: FilerServer, host: str = "127.0.0.1",
                 port: int = 0,
                 identities: Optional[list[Identity]] = None,
                 circuit_breaker: Optional[CircuitBreaker] = None):
        self.filer_server = filer
        self.filer = filer.filer
        self.iam = IdentityAccessManagement(identities)
        # filer-backed circuit breaker hot-reloads (the reference
        # subscribes to /etc/s3/circuit_breaker.json metadata changes;
        # here a 1 s TTL re-read, like the filer-conf cache)
        self._cb_from_filer = circuit_breaker is None
        self.circuit_breaker = circuit_breaker \
            or CircuitBreaker.load_from_filer(self.filer_server)
        self._cb_checked = time.time()
        self.server = RpcServer(host, port, service_name="s3")
        # shadow two reserved names in the bucket namespace, like the
        # filer's /metadata//remote//kv mounts shadow user paths
        self.server.add("GET", "/metrics", stats.metrics_handler)
        self.server.add("GET", "/debug/traces", tracing.traces_handler)
        faults.mount(self.server)
        profiling.mount(self.server)
        # weighted-fair front-end admission; the S3 access key is the
        # tenant key (WEED_QOS_S3_LIMIT; 0 = classify/count only)
        self.qos_gate = qos.AdmissionGate("s3",
                                          limit_env="WEED_QOS_S3_LIMIT")
        # workload analytics sketches for this gateway's object traffic
        self.access_recorder = access.AccessRecorder(node="s3")
        qos.mount(self.server, gate=self.qos_gate)
        events_mod.mount(self.server)
        access.mount(self.server, self.access_recorder)
        healthz.mount_health(self.server, ready=self._ready_checks)
        self.server.default_route = self._handle
        self._stop_event = threading.Event()
        self._register_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return self.server.address

    def _ready_checks(self):
        return [("filer", self.filer_server is not None,
                 getattr(self.filer_server, "address", "unknown")
                 if self.filer_server is not None else "no filer"),
                ("master", bool(getattr(self.filer_server,
                                        "master_address", "")),
                 getattr(self.filer_server, "master_address", "")
                 or "unknown"),
                healthz.gate_check(self.qos_gate)]

    def start(self):
        self.server.start()
        # announce in the master's cluster registry as type "s3" (the
        # filer does the same as type "filer") so cluster-wide tooling
        # — weed.py profile, /cluster/nodes?type=s3 — can discover
        # gateways; previously s3 daemons were invisible to discovery
        self._register_thread = threading.Thread(
            target=self._register_loop, daemon=True,
            name="s3-cluster-register")
        self._register_thread.start()

    def stop(self):
        self._stop_event.set()
        self.server.stop()

    def _register_loop(self):
        from ..rpc.http_rpc import RpcError, call

        interval = 5.0
        while not self._stop_event.is_set():
            try:
                r = call(self.filer_server.master_address,
                         "/cluster/register",
                         {"type": "s3", "address": self.address},
                         timeout=10)
                interval = min(5.0, float(r.get("pulse_seconds", 5.0)))
            except (RpcError, OSError):
                pass
            self._stop_event.wait(interval)

    def _maybe_reload_circuit_breaker(self):
        if not self._cb_from_filer or \
                time.time() - self._cb_checked < 1.0:
            return
        self._cb_checked = time.time()
        config = cb_read_config(self.filer_server)
        if config is None:
            return  # transient read failure: keep the current limits
        # load() swaps limits atomically; in-flight gauges survive
        self.circuit_breaker.load(config)

    # -- routing -------------------------------------------------------------
    def _handle(self, method: str, req: Request):
        parts = req.path.lstrip("/").split("/", 1)
        # bounded action label: bucket ops vs object ops by method
        action = ("%s_%s" % (method, "object" if len(parts) > 1 and
                             parts[1] else "bucket")).lower()
        with stats.S3RequestHistogram.labels(action).time():
            try:
                self._maybe_reload_circuit_breaker()
                resp = self._route(method, req)
            except AuthError as e:
                resp = _error_xml(e.code, str(e), e.status)
            except SlowDown as e:
                # retryable shed: tell SDK retry layers when to come
                # back — jittered so shed clients don't re-arrive in
                # one synchronized wave
                resp = _error_xml(
                    "SlowDown", str(e), 503,
                    headers={"Retry-After": qos.retry_after(1, 3)})
            except NotFoundError as e:
                resp = _error_xml("NoSuchKey", str(e), 404)
        code = resp.status if isinstance(resp, Response) else 200
        stats.S3RequestCounter.labels(action, code).inc()
        return resp

    def _route(self, method: str, req: Request):
        path = urllib.parse.unquote(req.path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""

        content_type = req.headers.get("Content-Type") or ""
        if method == "POST" and bucket and not key \
                and content_type.startswith("multipart/form-data"):
            # browser-based POST policy upload: auth comes from the signed
            # policy document, not the Authorization header
            release = self.circuit_breaker.acquire(
                bucket, "Write", len(req.body or b""))
            try:
                return self._post_policy_upload(bucket, req)
            finally:
                release()

        action = ACTION_READ if method in ("GET", "HEAD") else ACTION_WRITE
        if method == "GET" and not key:
            action = ACTION_LIST
        identity, req.body = self.iam.verify_and_decode(
            method, path, req.query, req.headers, req.body)
        if identity is not None and not identity.can(action, bucket):
            raise AuthError("AccessDenied",
                            f"{action} not allowed on {bucket}", 403)

        qos_release = None
        prev_qos = None
        if qos.enabled():
            # tenant = S3 access key (fall back to the bucket); reads
            # classify interactive, writes standard, both overridable
            # per tenant via WEED_QOS_CLASS_MAP
            tenant = (identity.access_key if identity is not None
                      else bucket)
            cls = qos.INTERACTIVE \
                if action in (ACTION_READ, ACTION_LIST) else qos.STANDARD
            cls = qos.class_for_tenant(tenant, cls)
            try:
                qos_release = self.qos_gate.admit(cls, tenant)
            except RpcError as e:
                raise SlowDown(str(e)) from None
            prev_qos = qos.set_qos(cls, tenant)
        try:
            if prev_qos is not None and method == "PUT" and key \
                    and not qos.QUOTAS.allow(
                        bucket, ops=1, nbytes=len(req.body or b"")):
                raise SlowDown(
                    f"collection {bucket!r} over its byte/ops quota")
            release = self.circuit_breaker.acquire(
                bucket, "Read" if action in (ACTION_READ, ACTION_LIST)
                else "Write", len(req.body or b""))
            try:
                if not bucket:
                    if method == "GET":
                        return self._list_buckets()
                    raise RpcError("bad request", 400)
                if not key:
                    return self._bucket_op(method, bucket, req)
                return self._object_op(method, bucket, key, req)
            finally:
                release()
        finally:
            if prev_qos is not None:
                qos.set_qos(*prev_qos)
            if qos_release is not None:
                qos_release()

    # -- buckets -------------------------------------------------------------
    def _bucket_path(self, bucket: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}"

    def _list_buckets(self):
        try:
            entries = self.filer.list_directory(BUCKETS_ROOT, limit=10000)
        except NotFoundError:
            entries = []
        return Response(_xml("ListAllMyBucketsResult", {
            "Owner": {"ID": "seaweedfs_tpu"},
            "Buckets": {"Bucket": [
                {"Name": e.name,
                 "CreationDate": _iso(e.attr.crtime)}
                for e in entries if e.is_directory
            ]},
        }), 200, "application/xml")

    @staticmethod
    def _ttl_days(ttl: str) -> int:
        from ..storage.ttl import TTL

        try:
            minutes = TTL.parse(ttl).minutes()
        except ValueError:
            return 0
        # round sub-day TTLs UP: reporting "no lifecycle" for a 12h TTL
        # would claim nothing expires while the store deletes data
        return -(-minutes // (60 * 24)) if minutes else 0

    # -- bucket subresources with canned/conf-backed answers -----------------
    # (s3api_bucket_skip_handlers.go + the acl/location/lifecycle/
    # request-payment handlers in s3api_bucket_handlers.go): SDKs probe
    # these on startup, so graceful answers matter even where the feature
    # doesn't exist
    SUBRESOURCES = ("acl", "cors", "policy", "lifecycle", "location",
                    "versioning", "requestPayment", "object-lock")

    def _bucket_subresource(self, method: str, bucket: str, req: Request):
        q = req.query
        if any(k in q for k in self.SUBRESOURCES):
            self.filer.find_entry(self._bucket_path(bucket))  # NoSuchBucket
        if "object-lock" in q and method == "GET":
            return _error_xml("ObjectLockConfigurationNotFoundError",
                              "no object lock configuration", 404)
        if "acl" in q:
            if method == "GET":
                return self._get_bucket_acl(bucket)
            if method == "PUT":
                # persist the canned ACL (PutBucketAclHandler accepts
                # x-amz-acl canned values; grant XML bodies are not
                # supported, as in the reference — and must NOT be
                # silently swallowed as a reset to private)
                canned = req.headers.get("X-Amz-Acl", "")
                if not canned and req.body:
                    return _error_xml("NotImplemented",
                                      "grant-based ACL bodies are not "
                                      "supported; use x-amz-acl", 501)
                canned = canned or "private"
                if canned not in ("private", "public-read",
                                  "public-read-write",
                                  "authenticated-read"):
                    return _error_xml("InvalidArgument",
                                      f"unsupported ACL {canned}", 400)
                self._set_bucket_config(bucket, "s3-acl", canned)
                return Response(b"", 200)
            return _error_xml("NotImplemented", "acl", 501)
        if "cors" in q:
            if method == "GET":
                stored = self._get_bucket_config(bucket, "s3-cors")
                if not stored:
                    return _error_xml("NoSuchCORSConfiguration",
                                      "no CORS configuration", 404)
                return Response(stored.encode(), 200, "application/xml")
            if method == "DELETE":
                self._set_bucket_config(bucket, "s3-cors", None)
                return Response(b"", 204)
            if method == "PUT":
                try:  # reject malformed XML up front
                    ET.fromstring(req.body)
                except ET.ParseError:
                    return _error_xml("MalformedXML", "bad CORS XML", 400)
                self._set_bucket_config(bucket, "s3-cors",
                                        req.body.decode("utf8", "replace"))
                return Response(b"", 200)
            return _error_xml("NotImplemented", "cors", 501)
        if "policy" in q:
            if method == "GET":
                stored = self._get_bucket_config(bucket, "s3-policy")
                if not stored:
                    return _error_xml("NoSuchBucketPolicy",
                                      "no bucket policy", 404)
                return Response(stored.encode(), 200, "application/json")
            if method == "DELETE":
                self._set_bucket_config(bucket, "s3-policy", None)
                return Response(b"", 204)
            if method == "PUT":
                try:
                    if not req.body:
                        raise ValueError("empty policy")
                    json.loads(req.body)
                except ValueError:
                    return _error_xml("MalformedPolicy",
                                      "policy is not valid JSON", 400)
                self._set_bucket_config(bucket, "s3-policy",
                                        req.body.decode("utf8", "replace"))
                return Response(b"", 204)
            return _error_xml("NotImplemented", "policy", 501)
        if "lifecycle" in q:
            if method == "GET":
                return self._get_bucket_lifecycle(bucket)
            if method == "DELETE":
                return Response(b"", 204)
            return _error_xml("NotImplemented", "lifecycle", 501)
        if "location" in q and method == "GET":
            return Response(_xml("LocationConstraint", ""), 200,
                            "application/xml")
        if "versioning" in q and method == "GET":
            return Response(_xml("VersioningConfiguration", ""), 200,
                            "application/xml")
        if "requestPayment" in q and method == "GET":
            return Response(_xml("RequestPaymentConfiguration",
                                 {"Payer": "BucketOwner"}), 200,
                            "application/xml")
        if any(k in q for k in self.SUBRESOURCES):
            # unhandled method+subresource combo (e.g. PUT ?versioning):
            # never fall through to the plain bucket handlers, which would
            # create/delete the bucket itself under a config request
            return _error_xml("NotImplemented",
                              "subresource not implemented", 501)
        return None

    # -- persisted bucket configs (extended attrs on the bucket entry) -------
    def _set_bucket_config(self, bucket: str, key: str,
                           value: Optional[str]):
        # the read-modify-write of extended must be atomic: concurrent
        # config PUTs (cors vs policy) would otherwise lose updates
        with self.filer.lock:
            entry = self.filer.find_entry(self._bucket_path(bucket))
            entry.extended = dict(entry.extended or {})
            if value is None:
                entry.extended.pop(key, None)
            else:
                entry.extended[key] = value
            self.filer.update_entry(entry)

    def _get_bucket_config(self, bucket: str, key: str) -> Optional[str]:
        entry = self.filer.find_entry(self._bucket_path(bucket))
        value = (entry.extended or {}).get(key)
        return value if isinstance(value, str) else None

    def _get_bucket_acl(self, bucket: str):
        """Canned ACL from the identity table plus the persisted canned
        grant, if any (GetBucketAclHandler)."""
        canned = self._get_bucket_config(bucket, "s3-acl")
        owner = {"ID": "seaweedfs_tpu", "DisplayName": "seaweedfs_tpu"}
        grants = []
        for ident in self.iam.identities.values():
            if ident.can(ACTION_ADMIN, bucket):
                perms = ["FULL_CONTROL"]
                if owner["ID"] == "seaweedfs_tpu":  # first admin is owner
                    owner = {"ID": ident.access_key,
                             "DisplayName": ident.name}
            else:
                perms = []
                if ident.can(ACTION_READ, bucket):
                    perms.append("READ")
                if ident.can(ACTION_WRITE, bucket):
                    perms.append("WRITE")
            for perm in perms:
                grants.append({
                    "Grantee": {"ID": ident.access_key,
                                "DisplayName": ident.name},
                    "Permission": perm})
        if canned and canned.startswith("public-read"):
            grants.append({
                "Grantee": {"URI": "http://acs.amazonaws.com/groups/"
                                   "global/AllUsers"},
                "Permission": "READ"})
            if canned == "public-read-write":
                grants.append({
                    "Grantee": {"URI": "http://acs.amazonaws.com/groups/"
                                       "global/AllUsers"},
                    "Permission": "WRITE"})
        elif canned == "authenticated-read":
            grants.append({
                "Grantee": {"URI": "http://acs.amazonaws.com/groups/"
                                   "global/AuthenticatedUsers"},
                "Permission": "READ"})
        return Response(_xml("AccessControlPolicy", {
            "Owner": owner,
            "AccessControlList": {"Grant": grants},
        }), 200, "application/xml")

    def _get_bucket_lifecycle(self, bucket: str):
        """Expiration rules derived from filer-conf TTLs for the bucket
        (GetBucketLifecycleConfigurationHandler)."""
        conf = self.filer_server.filer_conf()
        bucket_root = f"{BUCKETS_ROOT}/{bucket}"
        rules = []
        for rule in conf.rules:
            # exact bucket path or below it — "/buckets/sr" must not
            # match bucket "s"; and report the BUCKET-RELATIVE key prefix
            if rule.location_prefix != bucket_root and \
                    not rule.location_prefix.startswith(bucket_root + "/"):
                continue
            if not rule.ttl:
                continue
            days = self._ttl_days(rule.ttl)
            if days:
                key_prefix = rule.location_prefix[len(bucket_root):] \
                    .lstrip("/")
                rules.append({
                    "Status": "Enabled",
                    "Filter": {"Prefix": key_prefix},
                    "Expiration": {"Days": days}})
        if not rules:
            return _error_xml("NoSuchLifecycleConfiguration",
                              "no lifecycle configuration", 404)
        return Response(_xml("LifecycleConfiguration", {"Rule": rules}),
                        200, "application/xml")

    def _bucket_op(self, method: str, bucket: str, req: Request):
        path = self._bucket_path(bucket)
        sub = self._bucket_subresource(method, bucket, req)
        if sub is not None:
            return sub
        if method == "PUT":
            self.filer.create_entry(new_directory_entry(path))
            return Response(b"", 200)
        if method == "HEAD":
            entry = self.filer.find_entry(path)  # raises NotFound
            return Response(b"", 200)
        if method == "DELETE":
            try:
                children = [e for e in
                            self.filer.list_directory(path, limit=2)
                            if e.name != UPLOADS_DIR]
                if children:
                    return _error_xml("BucketNotEmpty",
                                      f"{bucket} is not empty", 409)
                self.filer.delete_entry(path, recursive=True)
            except NotFoundError:
                return _error_xml("NoSuchBucket", bucket, 404)
            return Response(b"", 204)
        if method == "GET":
            self.filer.find_entry(path)  # 404 when missing
            if "uploads" in req.query:
                return self._list_multipart_uploads(bucket, req)
            return self._list_objects(bucket, req)
        if method == "POST" and "delete" in req.query:
            return self._multi_delete(bucket, req)
        raise RpcError(f"unsupported bucket op {method}", 405)

    def _post_policy_upload(self, bucket: str, req: Request):
        """Browser POST upload (s3api_object_handlers_postpolicy.go): the
        form carries the key, a signed policy document, and the file."""
        self.filer.find_entry(self._bucket_path(bucket))  # NoSuchBucket
        form = parse_multipart_form(
            req.headers.get("Content-Type") or "", req.body)
        form.setdefault("bucket", bucket)
        identity = self.iam.verify_post_policy(form)
        if identity is not None and not identity.can(ACTION_WRITE, bucket):
            raise AuthError("AccessDenied",
                            f"Write not allowed on {bucket}", 403)
        key = form.get("key", "")
        if not key:
            return _error_xml("InvalidArgument", "missing key field", 400)
        key = key.replace("${filename}", form.get("__file_name__", ""))
        body = form.get("__file_bytes__", b"")
        entry = self.filer_server.save_bytes(
            self._object_path(bucket, key), body,
            mime=form.get("content-type", ""))
        try:
            status = int(form.get("success_action_status", "204"))
        except ValueError:
            status = 204
        if status not in (200, 201, 204):
            status = 204
        if status == 201:
            return Response(_xml("PostResponse", {
                "Bucket": bucket, "Key": key,
                "ETag": f'"{entry.attr.md5}"',
            }), 201, "application/xml")
        return Response(b"", status,
                        headers={"ETag": f'"{entry.attr.md5}"'})

    def _list_multipart_uploads(self, bucket: str, req: Request):
        """GET /bucket?uploads (ListMultipartUploads)."""
        uploads_root = f"{self._bucket_path(bucket)}/{UPLOADS_DIR}"
        try:
            pending = self.filer.list_directory(uploads_root, limit=10000)
        except NotFoundError:
            pending = []
        return Response(_xml("ListMultipartUploadsResult", {
            "Bucket": bucket,
            "Upload": [
                {"Key": u.extended.get("key", ""),
                 "UploadId": u.name,
                 "Initiated": _iso(u.attr.crtime)}
                for u in pending if u.is_directory
            ],
        }), 200, "application/xml")

    # -- object listing ------------------------------------------------------
    def _walk(self, dir_path: str, rel_prefix: str = ""):
        """Yield (key, entry) for all files under dir_path, sorted."""
        for e in self.filer.list_directory(dir_path, limit=100000):
            if e.name == UPLOADS_DIR:
                continue
            rel = rel_prefix + e.name
            if e.is_directory:
                yield from self._walk(e.full_path, rel + "/")
            else:
                yield rel, e

    def _list_objects(self, bucket: str, req: Request):
        prefix = req.param("prefix", "") or ""
        delimiter = req.param("delimiter", "") or ""
        max_keys = int(req.param("max-keys", "1000"))
        v2 = req.param("list-type") == "2"
        marker = (req.param("continuation-token")
                  or req.param("start-after")
                  or req.param("marker") or "")

        contents, common = [], []
        seen_prefixes = set()
        truncated = False
        last_emitted = ""
        for key, entry in self._walk(self._bucket_path(bucket)):
            if prefix and not key.startswith(prefix):
                continue
            if marker and key <= marker:
                continue
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp in seen_prefixes:
                        continue
                    if len(contents) + len(common) >= max_keys:
                        truncated = True
                        break
                    seen_prefixes.add(cp)
                    common.append(cp)
                    last_emitted = cp
                    continue
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            contents.append((key, entry))
            last_emitted = key

        result = {
            "Name": bucket,
            "Prefix": prefix,
            "MaxKeys": max_keys,
            "IsTruncated": str(truncated).lower(),
            "Contents": [
                {"Key": k,
                 "LastModified": _iso(e.attr.mtime),
                 "ETag": f'"{e.attr.md5}"',
                 "Size": e.size(),
                 "StorageClass": "STANDARD"} for k, e in contents
            ],
            "CommonPrefixes": [{"Prefix": p} for p in common],
        }
        if v2:
            # KeyCount counts keys + common prefixes (AWS semantics)
            result["KeyCount"] = len(contents) + len(common)
            if truncated and last_emitted:
                result["NextContinuationToken"] = last_emitted
        else:
            result["Marker"] = marker
        return Response(_xml("ListBucketResult", result), 200,
                        "application/xml")

    # -- objects -------------------------------------------------------------
    def _object_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}/{key}"

    def _object_op(self, method: str, bucket: str, key: str, req: Request):
        self.filer.find_entry(self._bucket_path(bucket))  # NoSuchBucket
        # object ACL / retention / legal-hold probes
        # (s3api_object_skip_handlers.go) — but only for keys that exist
        if method in ("GET", "PUT") and any(
                k in req.query for k in ("acl", "retention",
                                         "legal-hold")):
            entry = self.filer.find_entry(self._object_path(bucket, key))
            if entry.is_directory:
                raise NotFoundError(key)
            if method == "GET" and "acl" in req.query:
                return self._get_bucket_acl(bucket)  # same canned policy
            return Response(b"", 204)
        if method == "PUT":
            if "partNumber" in req.query and "uploadId" in req.query:
                return self._upload_part(bucket, key, req)
            if req.headers.get("X-Amz-Copy-Source"):
                return self._copy_object(bucket, key, req)
            if "tagging" in req.query:
                return self._put_tagging(bucket, key, req)
            return self._put_object(bucket, key, req)
        if method == "POST":
            if "uploads" in req.query:
                return self._create_multipart(bucket, key, req)
            if "uploadId" in req.query:
                return self._complete_multipart(bucket, key, req)
            raise RpcError("bad POST", 400)
        if method in ("GET", "HEAD"):
            if "uploadId" in req.query:
                return self._list_parts(bucket, key, req)
            if "tagging" in req.query:
                return self._get_tagging(bucket, key)
            return self._get_object(bucket, key, req, method)
        if method == "DELETE":
            if "uploadId" in req.query:
                return self._abort_multipart(bucket, key, req)
            if "tagging" in req.query:
                return self._delete_tagging(bucket, key)
            return self._delete_object(bucket, key)
        raise RpcError(f"unsupported object op {method}", 405)

    def _record_access(self, op: str, bucket: str, key: str, nbytes: int,
                       t0: float):
        """Workload analytics at the S3 door: objects are keyed
        bucket/key here (the volume layer tracks the same access by
        fid); the tenant is whatever sigv4 identity _route attributed
        to the QoS context."""
        self.access_recorder.record(
            op, collection=bucket, tenant=qos.current_tenant(),
            fid=f"{bucket}/{key}", nbytes=nbytes,
            latency_s=time.monotonic() - t0,
            qos_class=qos.current_class())

    def _put_object(self, bucket: str, key: str, req: Request):
        t0 = time.monotonic()
        extended = {f"x-amz-meta-{k[11:].lower()}": v
                    for k, v in req.headers.items()
                    if k.lower().startswith("x-amz-meta-")}
        entry = self.filer_server.save_bytes(
            self._object_path(bucket, key), req.body,
            mime=req.headers.get("Content-Type") or "",
            extended=extended)
        self._record_access("write", bucket, key, len(req.body or b""), t0)
        return Response(b"", 200, headers={"ETag": f'"{entry.attr.md5}"'})

    def _get_object(self, bucket: str, key: str, req: Request, method: str):
        t0 = time.monotonic()
        entry = self.filer.find_entry(self._object_path(bucket, key))
        if entry.is_directory:
            raise NotFoundError(key)
        size = entry.size()
        start, length, status = 0, size, 200
        headers = {"ETag": f'"{entry.attr.md5}"',
                   "Last-Modified": _http_date(entry.attr.mtime),
                   "Accept-Ranges": "bytes"}
        for k, v in entry.extended.items():
            if k.startswith("x-amz-meta-"):
                headers[k] = v
        range_header = req.headers.get("Range")
        if range_header and range_header.startswith("bytes="):
            lo_s, _, hi_s = range_header[6:].split(",")[0].partition("-")
            lo = int(lo_s) if lo_s else None
            hi = int(hi_s) if hi_s else None
            if lo is None:
                start = max(0, size - (hi or 0))
                length = size - start
            else:
                start = lo
                length = (min(hi, size - 1) - lo + 1) if hi is not None \
                    else size - lo
            if start >= size or length <= 0:
                return _error_xml("InvalidRange", "range not satisfiable",
                                  416)
            status = 206
            headers["Content-Range"] = \
                f"bytes {start}-{start + length - 1}/{size}"
        content_type = entry.attr.mime or "application/octet-stream"
        if method == "HEAD":
            headers["Content-Length"] = str(length)
            return Response(b"", status, content_type, headers)
        # record at first-byte time: every reply path below serves
        # exactly `length` payload bytes
        self._record_access("read", bucket, key, length, t0)
        # single-chunk objects resident in the disk cache tier go out
        # zero-copy via sendfile, same as the filer read path
        zero = self.filer_server._sendfile_read(
            entry, start, length, status, content_type, headers)
        if zero is not None:
            return zero
        # multi-chunk objects stream through the filer's bounded-window
        # prefetch pipeline: first byte goes out after one chunk fetch
        # regardless of object size
        streamed = self.filer_server.read_stream(entry, start, length)
        if streamed is not None:
            body_iter, n = streamed
            headers["Content-Length"] = str(n)
            return Response(body_iter, status, content_type, headers)
        # buffered path: zero-copy memoryview parts over cached chunk
        # bytes, written straight into the socket send
        parts, n = self.filer_server.read_view(entry, start, length)
        headers["Content-Length"] = str(n)
        body = parts[0] if len(parts) == 1 else iter(parts)
        return Response(body, status, content_type, headers)

    def _delete_object(self, bucket: str, key: str):
        t0 = time.monotonic()
        try:
            self.filer.delete_entry(self._object_path(bucket, key))
        except NotFoundError:
            pass  # S3 delete is idempotent
        except ValueError as e:
            return _error_xml("InvalidRequest", str(e), 400)
        self._record_access("delete", bucket, key, 0, t0)
        return Response(b"", 204)

    def _copy_object(self, bucket: str, key: str, req: Request):
        source = urllib.parse.unquote(
            req.headers.get("X-Amz-Copy-Source", "")).lstrip("/")
        src_bucket, _, src_key = source.partition("/")
        src = self.filer.find_entry(self._object_path(src_bucket, src_key))
        body = self.filer_server.read_bytes(src)
        entry = self.filer_server.save_bytes(
            self._object_path(bucket, key), body,
            mime=src.attr.mime, extended=dict(src.extended))
        return Response(_xml("CopyObjectResult", {
            "ETag": f'"{entry.attr.md5}"',
            "LastModified": _iso(entry.attr.mtime),
        }), 200, "application/xml")

    def _multi_delete(self, bucket: str, req: Request):
        root = ET.fromstring(req.body)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[:root.tag.index("}") + 1]
        deleted, errors = [], []
        for obj in root.findall(f"{ns}Object"):
            key_el = obj.find(f"{ns}Key")
            if key_el is None or not key_el.text:
                continue
            try:
                self.filer.delete_entry(
                    self._object_path(bucket, key_el.text))
                deleted.append(key_el.text)
            except NotFoundError:
                deleted.append(key_el.text)  # S3: missing counts as deleted
            except ValueError as e:
                errors.append((key_el.text, str(e)))
        return Response(_xml("DeleteResult", {
            "Deleted": [{"Key": k} for k in deleted],
            "Error": [{"Key": k, "Code": "InvalidRequest", "Message": m}
                      for k, m in errors],
        }), 200, "application/xml")

    # -- tagging -------------------------------------------------------------
    def _put_tagging(self, bucket: str, key: str, req: Request):
        entry = self.filer.find_entry(self._object_path(bucket, key))
        root = ET.fromstring(req.body)
        ns = root.tag[:root.tag.index("}") + 1] if \
            root.tag.startswith("{") else ""
        tags = {}
        for tag_el in root.iter(f"{ns}Tag"):
            k = tag_el.find(f"{ns}Key")
            v = tag_el.find(f"{ns}Value")
            if k is not None and v is not None:
                tags[k.text] = v.text or ""
        entry.extended = {k: v for k, v in entry.extended.items()
                          if not k.startswith("x-amz-tag-")}
        for k, v in tags.items():
            entry.extended[f"x-amz-tag-{k}"] = v
        self.filer.update_entry(entry)
        return Response(b"", 200)

    def _get_tagging(self, bucket: str, key: str):
        entry = self.filer.find_entry(self._object_path(bucket, key))
        tags = [(k[len("x-amz-tag-"):], v)
                for k, v in entry.extended.items()
                if k.startswith("x-amz-tag-")]
        return Response(_xml("Tagging", {
            "TagSet": {"Tag": [{"Key": k, "Value": v} for k, v in tags]},
        }), 200, "application/xml")

    def _delete_tagging(self, bucket: str, key: str):
        entry = self.filer.find_entry(self._object_path(bucket, key))
        entry.extended = {k: v for k, v in entry.extended.items()
                          if not k.startswith("x-amz-tag-")}
        self.filer.update_entry(entry)
        return Response(b"", 204)

    # -- multipart (filer_multipart.go) --------------------------------------
    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}/{UPLOADS_DIR}/{upload_id}"

    def _create_multipart(self, bucket: str, key: str, req: Request):
        upload_id = uuid.uuid4().hex
        marker = new_directory_entry(self._upload_dir(bucket, upload_id))
        marker.extended["key"] = key
        marker.extended["mime"] = req.headers.get("Content-Type") or ""
        self.filer.create_entry(marker)
        return Response(_xml("InitiateMultipartUploadResult", {
            "Bucket": bucket, "Key": key, "UploadId": upload_id,
        }), 200, "application/xml")

    def _upload_part(self, bucket: str, key: str, req: Request):
        upload_id = req.param("uploadId")
        part = int(req.param("partNumber"))
        self.filer.find_entry(self._upload_dir(bucket, upload_id))
        entry = self.filer_server.save_bytes(
            f"{self._upload_dir(bucket, upload_id)}/{part:05d}.part",
            req.body)
        return Response(b"", 200,
                        headers={"ETag": f'"{entry.attr.md5}"'})

    def _complete_multipart(self, bucket: str, key: str, req: Request):
        upload_id = req.param("uploadId")
        upload_dir = self._upload_dir(bucket, upload_id)
        marker = self.filer.find_entry(upload_dir)
        staged = {int(e.name.split(".")[0]): e
                  for e in self.filer.list_directory(upload_dir,
                                                     limit=10001)
                  if e.name.endswith(".part")}
        requested = self._requested_part_numbers(req.body)
        if requested is not None:
            missing = [n for n in requested if n not in staged]
            if missing:
                return _error_xml("InvalidPart",
                                  f"parts {missing} not uploaded", 400)
            part_numbers = requested  # the client's list is authoritative
        else:
            part_numbers = sorted(staged)
        parts = [staged[n] for n in part_numbers]
        if not parts:
            return _error_xml("InvalidPart", "no parts uploaded", 400)
        final = Entry(full_path=self._object_path(bucket, key))
        final.attr.mtime = final.attr.crtime = time.time()
        final.attr.mime = marker.extended.get("mime", "")
        offset = 0
        md5s = b""
        for p in parts:
            md5s += bytes.fromhex(p.attr.md5)
            if p.content:
                # inlined small part: push it to a volume chunk so
                # composition stays a pure chunk-list operation
                source_chunks = self._force_chunk(p.content)
            else:
                source_chunks = p.chunks
            if has_chunk_manifest(source_chunks):
                # manifest blobs serialize part-RELATIVE offsets; shifting
                # the outer chunk would leave the nested ones unshifted,
                # so compose from the flattened plain chunks instead
                source_chunks = resolve_chunk_manifest(
                    self.filer_server._fetch_chunk, source_chunks)
            for c in sorted(source_chunks, key=lambda c: c.offset):
                final.chunks.append(FileChunk(
                    fid=c.fid, offset=offset + c.offset, size=c.size,
                    etag=c.etag, modified_ts_ns=time.time_ns(),
                    is_chunk_manifest=c.is_chunk_manifest,
                    cipher_key=c.cipher_key))
            offset += p.size()
        final.attr.file_size = offset
        etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        final.attr.md5 = etag
        self.filer.create_entry(final)
        # drop the staging dir without reclaiming chunks now owned by the
        # final entry; exclusion happens inside _delete_chunks AFTER
        # manifest expansion, so a part's manifest blob is reclaimed while
        # the data chunks it lists (now the final entry's) survive
        saved_hook = self.filer.on_delete_chunks
        final_fids = {c.fid for c in final.chunks}
        self.filer.on_delete_chunks = lambda chunks: \
            self.filer_server._delete_chunks(chunks,
                                             exclude_fids=final_fids)
        try:
            self.filer.delete_entry(upload_dir, recursive=True)
        finally:
            self.filer.on_delete_chunks = saved_hook
        return Response(_xml("CompleteMultipartUploadResult", {
            "Bucket": bucket, "Key": key, "ETag": f'"{etag}"',
        }), 200, "application/xml")

    @staticmethod
    def _requested_part_numbers(body: bytes):
        """Parse CompleteMultipartUpload XML -> ordered part numbers, or
        None when the client sent no body (lenient mode)."""
        if not body:
            return None
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            return None
        ns = root.tag[:root.tag.index("}") + 1] if \
            root.tag.startswith("{") else ""
        numbers = [int(el.text) for el in root.iter(f"{ns}PartNumber")
                   if el.text]
        return numbers or None

    def _force_chunk(self, content: bytes) -> list[FileChunk]:
        # the filer's uploader so encrypt-at-rest and JWT forwarding apply
        # to inlined small parts too
        return [self.filer_server._upload_blob(content)]

    def _abort_multipart(self, bucket: str, key: str, req: Request):
        upload_id = req.param("uploadId")
        try:
            self.filer.delete_entry(self._upload_dir(bucket, upload_id),
                                    recursive=True)
        except NotFoundError:
            return _error_xml("NoSuchUpload", upload_id, 404)
        return Response(b"", 204)

    def _list_parts(self, bucket: str, key: str, req: Request):
        upload_id = req.param("uploadId")
        upload_dir = self._upload_dir(bucket, upload_id)
        self.filer.find_entry(upload_dir)
        parts = [e for e in self.filer.list_directory(upload_dir,
                                                      limit=10001)
                 if e.name.endswith(".part")]
        parts.sort(key=lambda e: int(e.name.split(".")[0]))
        return Response(_xml("ListPartsResult", {
            "Bucket": bucket, "Key": key, "UploadId": upload_id,
            "Part": [
                {"PartNumber": int(p.name.split(".")[0]),
                 "ETag": f'"{p.attr.md5}"',
                 "Size": p.size()} for p in parts
            ],
        }), 200, "application/xml")


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))
