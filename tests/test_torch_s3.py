"""The port's S3 gateway against the JAX package's, on the CPU.

One JAX and one port stack (a master, two volume servers, a filer with
1 KiB chunks and an `S3ApiServer` over it, as `tests/test_s3.py` builds
them) answer the same scripted requests: buckets, objects with Range,
user metadata, copy and multi-delete, ListObjects v1 and v2 (prefix,
delimiter, markers, truncation and continuation), multipart uploads,
tagging and the bucket and object subresources.  A second pair of stacks
with identities answers SigV4 header auth, presigned queries, streaming
`aws-chunked` bodies (tampered, truncated) and the action scopes; the
`S3Client` of each package drives its own gateway (a space in a listing
prefix, streaming uploads).  Unit-level, both packages' `verify` and
`verify_and_decode` take the same signed requests (AWS's documented key
derivation, decoded-length mismatches, unsigned and signed trailers,
streaming sentinels on presigned requests) and give the same identity,
bytes or `AuthError` code and status.

Replies compare as (status, the S3 headers, body) with timestamps and
HTTP dates replaced by placeholders; upload ids come from a seeded
`uuid4` in each package's gateway module.  Tolerance: equality
throughout.  Every server binds port 0 and is stopped in a `finally`.
"""

import contextlib
import hashlib
import hmac
import re
import time
import types
import urllib.parse

import pytest

from test_s3 import _streaming_frames, sigv4_request, streaming_sigv4_put
from test_torch_filer import _Uuids

from seaweedfs_tpu.filer import filer_conf as j_conf
from seaweedfs_tpu.filer import server as j_fserver
from seaweedfs_tpu.master import server as j_master
from seaweedfs_tpu.rpc import http_rpc as j_rpc
from seaweedfs_tpu.s3api import auth as j_auth
from seaweedfs_tpu.s3api import server as j_s3
from seaweedfs_tpu.volume_server import server as j_vs
from seaweedfs_tpu.wdclient import s3_client as j_client
from seaweedfs_tpu_torch.filer import filer_conf as t_conf
from seaweedfs_tpu_torch.filer import server as t_fserver
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.rpc import http_rpc as t_rpc
from seaweedfs_tpu_torch.s3api import auth as t_auth
from seaweedfs_tpu_torch.s3api import server as t_s3
from seaweedfs_tpu_torch.volume_server import server as t_vs
from seaweedfs_tpu_torch.wdclient import s3_client as t_client

PKG = {
    "jax": types.SimpleNamespace(
        master=j_master, vs=j_vs, fserver=j_fserver, s3=j_s3, auth=j_auth,
        client=j_client, conf=j_conf, rpc=j_rpc, kw={}),
    "port": types.SimpleNamespace(
        master=t_master, vs=t_vs, fserver=t_fserver, s3=t_s3, auth=t_auth,
        client=t_client, conf=t_conf, rpc=t_rpc, kw={"device": "cpu"}),
}

IDENTITIES = [("admin", "AKID", "SK", None), ("reader", "AKR", "SKR",
                                             ["Read"])]
_HEADERS = ("etag", "content-type", "content-length", "content-range",
            "accept-ranges", "last-modified")
_ISO = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z")
_HTTP_DATE = re.compile(r"[A-Z][a-z]{2}, \d\d [A-Z][a-z]{2} \d{4} "
                        r"\d\d:\d\d:\d\d GMT")


def norm(reply):
    """(status, the S3 headers, body) with clocks replaced."""
    status, headers, body = reply
    kept = {}
    for k, v in headers.items():
        k = k.lower()
        if k in _HEADERS or (k.startswith("x-amz-")
                             and k not in ("x-amz-request-id",
                                           "x-amz-id-2")):
            kept[k] = _HTTP_DATE.sub("DATE", v)
    return status, kept, _ISO.sub(b"TIMESTAMP", body)


@contextlib.contextmanager
def stack(pkg, root, identities=None, chunk_size=1024):
    """A master, two volume servers, a filer and the gateway of one
    package; everything stopped on exit."""
    ns = PKG[pkg]
    started = []
    try:
        master = ns.master.MasterServer(port=0, pulse_seconds=0.2)
        master.start()
        started.append(master)
        for i in range(2):
            d = root / f"v{i}"
            d.mkdir(parents=True)
            vs = ns.vs.VolumeServer([str(d)], master.address, port=0,
                                    pulse_seconds=0.2, **ns.kw)
            vs.start()
            started.append(vs)
            vs.heartbeat_once()
        filer = ns.fserver.FilerServer(master.address, port=0,
                                       chunk_size=chunk_size, **ns.kw)
        filer.start()
        started.append(filer)
        idents = None if identities is None else [
            ns.auth.Identity(name=n, access_key=a, secret_key=s,
                             **({"actions": acts} if acts else {}))
            for n, a, s, acts in identities]
        s3 = ns.s3.S3ApiServer(filer, port=0, identities=idents)
        s3.start()
        started.append(s3)
        yield s3
    finally:
        for s in reversed(started):
            s.stop()


def _stacks(tmp_path_factory, name, **kw):
    root = tmp_path_factory.mktemp(name)
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as es:
        mp.setenv("WEED_MAINT", "0")
        mp.setenv("WEED_MAINT_WORKER", "0")
        out = {}
        for pkg, ns in PKG.items():
            mp.setattr(ns.s3, "uuid", _Uuids())
            out[pkg] = es.enter_context(stack(pkg, root / pkg, **kw))
        yield out


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    yield from _stacks(tmp_path_factory, "s3")


@pytest.fixture(scope="module")
def auth_stacks(tmp_path_factory):
    yield from _stacks(tmp_path_factory, "s3auth", identities=IDENTITIES)


def _both(stacks, script):
    out = {pkg: script(stacks[pkg], PKG[pkg]) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


def req(s3, method, path, query="", body=b"", headers=None, **keys):
    return norm(sigv4_request(s3.address, method, path, query, body,
                              headers=headers, **keys))


# -- buckets and objects ------------------------------------------------------


def test_buckets_create_list_delete_like_jax(stacks):
    def script(s3, ns):
        return [req(s3, "PUT", "/lb1"), req(s3, "PUT", "/lb2"),
                req(s3, "PUT", "/lb2"), req(s3, "GET", "/"),
                req(s3, "HEAD", "/lb1"), req(s3, "DELETE", "/lb2"),
                req(s3, "HEAD", "/lb2"), req(s3, "HEAD", "/ghost"),
                req(s3, "PUT", "/lbf"), req(s3, "PUT", "/lbf/k", body=b"x"),
                req(s3, "DELETE", "/lbf"), req(s3, "DELETE", "/nobucket")]

    out = _both(stacks, script)
    assert [r[0] for r in out] == [200, 200, 200, 200, 200, 204, 404, 404,
                                   200, 200, 409, 404]
    assert b"BucketNotEmpty" in out[10][2]


PAYLOAD = bytes(range(256)) * 30  # 7680 bytes: eight 1 KiB chunks


def test_put_get_head_roundtrip_like_jax(stacks):
    def script(s3, ns):
        return [req(s3, "PUT", "/ob"),
                req(s3, "PUT", "/ob/dir/obj.bin", body=PAYLOAD,
                    headers={"Content-Type": "application/foo"}),
                req(s3, "GET", "/ob/dir/obj.bin"),
                req(s3, "HEAD", "/ob/dir/obj.bin"),
                req(s3, "PUT", "/ob/small", body=b"tiny"),
                req(s3, "GET", "/ob/small"), req(s3, "GET", "/ob/ghost"),
                req(s3, "PUT", "/ghostbucket/k", body=b"x")]

    out = _both(stacks, script)
    etag = f'"{hashlib.md5(PAYLOAD).hexdigest()}"'
    assert out[1][1]["etag"] == etag and out[2][2] == PAYLOAD
    assert out[2][1]["content-type"] == "application/foo"
    assert out[3][1]["content-length"] == str(len(PAYLOAD))
    assert out[6][0] == 404 and b"NoSuchKey" in out[6][2]


@pytest.mark.parametrize("spec", ["bytes=10-19", "bytes=-100",
                                  "bytes=4990-", "bytes=1000-99999",
                                  "bytes=6000-7000", "bytes=0-0"])
def test_range_read_like_jax(stacks, spec):
    payload = b"0123456789" * 500

    def script(s3, ns):
        req(s3, "PUT", "/rb")
        req(s3, "PUT", "/rb/r", body=payload)
        return req(s3, "GET", "/rb/r", headers={"Range": spec})

    status, headers, body = _both(stacks, script)
    if status == 206:
        lo, _, hi = headers["content-range"][6:].partition("/")[0] \
            .partition("-")
        assert body == payload[int(lo):int(hi) + 1]
    else:
        assert status == 416


def test_delete_copy_metadata_multi_delete_like_jax(stacks):
    delete_xml = (b"<Delete><Object><Key>a</Key></Object>"
                  b"<Object><Key>c</Key></Object>"
                  b"<Object><Key>missing</Key></Object></Delete>")

    def script(s3, ns):
        out = [req(s3, "PUT", "/cb")]
        for k in ("a", "b", "c"):
            out.append(req(s3, "PUT", f"/cb/{k}", body=k.encode() * 9))
        out += [req(s3, "DELETE", "/cb/b"), req(s3, "GET", "/cb/b"),
                req(s3, "DELETE", "/cb/b"),
                req(s3, "PUT", "/cb/src", body=b"copy payload" * 200,
                    headers={"Content-Type": "text/x-src",
                             "X-Amz-Meta-Color": "green"}),
                req(s3, "PUT", "/cb/dst",
                    headers={"X-Amz-Copy-Source": "/cb/src"}),
                req(s3, "GET", "/cb/dst"), req(s3, "HEAD", "/cb/src"),
                req(s3, "PUT", "/cb/dst2",
                    headers={"X-Amz-Copy-Source": "/cb/ghost"}),
                req(s3, "POST", "/cb", query="delete=", body=delete_xml),
                req(s3, "GET", "/cb/a"), req(s3, "GET", "/cb/c")]
        return out

    out = _both(stacks, script)
    assert [r[0] for r in out[4:7]] == [204, 404, 204]
    assert out[9][2] == b"copy payload" * 200
    assert out[9][1]["content-type"] == "text/x-src"
    assert out[10][1]["x-amz-meta-color"] == "green"
    assert out[12][0] == 200 and out[13][0] == out[14][0] == 404


# -- listings -----------------------------------------------------------------


@pytest.fixture(scope="module")
def filled(stacks):
    keys = ("a.txt", "dir/one.txt", "dir/two.txt", "dir/sub/deep.txt",
            "z.txt", "my folder/x.txt", "dir/sub/more/m.txt")

    def script(s3, ns):
        out = [req(s3, "PUT", "/lst")]
        for key in keys:
            out.append(req(s3, "PUT", f"/lst/{key}", body=key.encode()))
        return out

    _both(stacks, script)
    return stacks


@pytest.mark.parametrize("query", [
    "list-type=2", "list-type=2&prefix=dir/", "list-type=2&delimiter=/",
    "list-type=2&prefix=dir/&delimiter=/", "list-type=2&max-keys=2",
    "list-type=2&start-after=dir/one.txt", "list-type=2&prefix=my%20folder/",
    "list-type=2&max-keys=0", "", "prefix=dir/&delimiter=/",
    "marker=dir/sub/deep.txt", "max-keys=3", "list-type=2&prefix=nothing"])
def test_listing_like_jax(filled, query):
    out = _both(filled, lambda s3, ns: req(s3, "GET", "/lst", query=query))
    assert out[0] == 200 and b"ListBucketResult" in out[2]


def test_listing_pages_with_continuation_like_jax(filled):
    ns_ = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    import xml.etree.ElementTree as ET

    def script(s3, ns):
        pages, token = [], ""
        for _ in range(10):
            q = "list-type=2&max-keys=2" + (
                f"&continuation-token={urllib.parse.quote(token)}"
                if token else "")
            page = req(s3, "GET", "/lst", query=q)
            pages.append(page)
            token = ET.fromstring(page[2]).findtext(
                f"{ns_}NextContinuationToken") or ""
            if not token:
                return pages
        raise AssertionError("no last page")

    pages = _both(filled, script)
    keys = [k.text for p in pages
            for k in ET.fromstring(p[2]).iter(f"{ns_}Key")]
    assert len(keys) == 7 and keys == sorted(keys)


# -- multipart uploads and tagging --------------------------------------------


def test_multipart_full_flow_like_jax(stacks):
    import xml.etree.ElementTree as ET

    ns_ = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    part1, part2, part3 = b"A" * 5000, b"B" * 3000, b"C" * 10

    def script(s3, ns):
        out = [req(s3, "PUT", "/mpb"),
               req(s3, "POST", "/mpb/big.bin", query="uploads=",
                   headers={"Content-Type": "application/x-big"})]
        uid = ET.fromstring(out[-1][2]).find(f"{ns_}UploadId").text
        for num, part in ((1, part1), (2, part2), (3, part3)):
            out.append(req(s3, "PUT", "/mpb/big.bin",
                           query=f"partNumber={num}&uploadId={uid}",
                           body=part))
        out += [req(s3, "GET", "/mpb/big.bin", query=f"uploadId={uid}"),
                req(s3, "GET", "/mpb", query="uploads="),
                req(s3, "POST", "/mpb/big.bin", query=f"uploadId={uid}"),
                req(s3, "GET", "/mpb/big.bin"),
                req(s3, "GET", "/mpb/big.bin",
                    headers={"Range": "bytes=4990-5009"}),
                req(s3, "GET", "/mpb", query="list-type=2"),
                req(s3, "POST", "/mpb/big.bin", query=f"uploadId={uid}")]
        # a completion that names its parts, and an abort
        out.append(req(s3, "POST", "/mpb/two.bin", query="uploads="))
        uid2 = ET.fromstring(out[-1][2]).find(f"{ns_}UploadId").text
        for num in (1, 2):
            out.append(req(s3, "PUT", "/mpb/two.bin",
                           query=f"partNumber={num}&uploadId={uid2}",
                           body=bytes([num]) * 1500))
        out.append(req(s3, "POST", "/mpb/two.bin", query=f"uploadId={uid2}",
                       body=b"<CompleteMultipartUpload><Part><PartNumber>2"
                            b"</PartNumber></Part><Part><PartNumber>5"
                            b"</PartNumber></Part></CompleteMultipartUpload>"))
        out.append(req(s3, "DELETE", "/mpb/two.bin", query=f"uploadId={uid2}"))
        out.append(req(s3, "GET", "/mpb/two.bin", query=f"uploadId={uid2}"))
        return out

    out = _both(stacks, script)
    assert out[8][0] == 200 and out[8][2] == part1 + part2 + part3
    assert out[7][0] == 200 and b'-3"</ETag>' in out[7][2]
    assert out[9][0] == 206 and out[9][2] == b"A" * 10 + b"B" * 10
    assert out[15][0] == 400 and b"InvalidPart" in out[15][2]
    assert out[16][0] == 204 and out[17][0] == 404


def test_tagging_like_jax(stacks):
    tag_xml = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value>"
               b"</Tag><Tag><Key>team</Key><Value>s3</Value></Tag>"
               b"</TagSet></Tagging>")

    def script(s3, ns):
        return [req(s3, "PUT", "/tg"), req(s3, "PUT", "/tg/t", body=b"x"),
                req(s3, "PUT", "/tg/t", query="tagging=", body=tag_xml),
                req(s3, "GET", "/tg/t", query="tagging="),
                req(s3, "GET", "/tg/t"),
                req(s3, "DELETE", "/tg/t", query="tagging="),
                req(s3, "GET", "/tg/t", query="tagging="),
                req(s3, "PUT", "/tg/t", query="tagging=", body=b"<bad"),
                req(s3, "GET", "/tg/ghost", query="tagging=")]

    out = _both(stacks, script)
    assert out[2][0] == 200 and b"<Value>prod</Value>" in out[3][2]
    assert out[5][0] == 204 and b"<Tag>" not in out[6][2]


# -- bucket and object subresources -------------------------------------------


def test_bucket_subresources_like_jax(stacks):
    cors = (b"<CORSConfiguration><CORSRule><AllowedOrigin>*</AllowedOrigin>"
            b"<AllowedMethod>GET</AllowedMethod></CORSRule>"
            b"</CORSConfiguration>")
    policy = (b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
              b'"Action":"s3:GetObject","Resource":"arn:aws:s3:::sr/*"}]}')

    def script(s3, ns):
        out = [req(s3, "PUT", "/sr")]
        for sub in ("location", "versioning", "requestPayment", "cors",
                    "policy", "lifecycle", "acl", "object-lock"):
            out.append(req(s3, "GET", "/sr", query=f"{sub}="))
            out.append(req(s3, "GET", "/ghostsr", query=f"{sub}="))
        out += [req(s3, "PUT", "/sr", query="cors=", body=cors),
                req(s3, "GET", "/sr", query="cors="),
                req(s3, "PUT", "/sr", query="cors=", body=b"not xml <"),
                req(s3, "DELETE", "/sr", query="cors="),
                req(s3, "PUT", "/sr", query="policy=", body=policy),
                req(s3, "GET", "/sr", query="policy="),
                req(s3, "PUT", "/sr", query="policy=", body=b"{not json"),
                req(s3, "PUT", "/sr", query="policy=", body=b""),
                req(s3, "DELETE", "/sr", query="policy="),
                req(s3, "PUT", "/sr", query="lifecycle=", body=b"<x/>"),
                req(s3, "DELETE", "/sr", query="lifecycle=")]
        for acl in ("public-read", "no-such-acl", "authenticated-read"):
            out.append(req(s3, "PUT", "/sr", query="acl=",
                           headers={"X-Amz-Acl": acl}))
            out.append(req(s3, "GET", "/sr", query="acl="))
        out += [req(s3, "PUT", "/sr", query="acl=",
                    body=b"<AccessControlPolicy/>"),
                req(s3, "PUT", "/sr/keep", body=b"x"),
                req(s3, "DELETE", "/sr", query="versioning="),
                req(s3, "PUT", "/sr", query="versioning=", body=b"<x/>"),
                req(s3, "PUT", "/missing-sr", query="object-lock=",
                    body=b"<x/>"),
                req(s3, "GET", "/sr/keep")]
        return out

    out = _both(stacks, script)
    assert out[-1][2] == b"x" and b"AuthenticatedUsers" in out[-7][2]


def test_object_subresources_like_jax(stacks):
    def script(s3, ns):
        out = [req(s3, "PUT", "/osr"), req(s3, "PUT", "/osr/k", body=b"x")]
        for sub in ("retention", "legal-hold", "acl"):
            out += [req(s3, "GET", "/osr/k", query=f"{sub}="),
                    req(s3, "PUT", "/osr/k", query=f"{sub}=", body=b"<x/>"),
                    req(s3, "GET", "/osr/ghost", query=f"{sub}=")]
        return out

    out = _both(stacks, script)
    assert [r[0] for r in out[2:8]] == [204, 204, 404, 204, 204, 404]


def test_lifecycle_from_filer_conf_ttl_like_jax(stacks):
    def script(s3, ns):
        req(s3, "PUT", "/lc")
        conf = s3.filer_server.filer_conf()
        conf.add(ns.conf.PathConf(location_prefix="/buckets/lc/logs",
                                  ttl="3d"))
        conf.save(s3.filer_server.filer)
        s3.filer_server._conf_cache = (0.0, conf)  # bust the 1 s cache
        return req(s3, "GET", "/lc", query="lifecycle=")

    status, _, body = _both(stacks, script)
    assert status == 200 and b"<Days>3</Days>" in body


# -- SigV4 over HTTP ----------------------------------------------------------


def test_sigv4_header_auth_and_scopes_like_jax(auth_stacks):
    admin = {"access_key": "AKID", "secret_key": "SK"}
    reader = {"access_key": "AKR", "secret_key": "SKR"}

    def script(s3, ns):
        return [req(s3, "PUT", "/ab", **admin),
                req(s3, "PUT", "/ab/k", body=b"payload", **admin),
                req(s3, "GET", "/ab/k", **admin), req(s3, "GET", "/ab/k"),
                req(s3, "GET", "/ab/k", access_key="AKID",
                    secret_key="WRONG"),
                req(s3, "GET", "/ab/k", access_key="NOBODY", secret_key="X"),
                req(s3, "PUT", "/ab/nope", body=b"x", **reader),
                req(s3, "GET", "/ab/k", **reader),
                req(s3, "GET", "/ab", query="list-type=2", **reader),
                req(s3, "DELETE", "/ab/k", **reader),
                req(s3, "GET", "/", **admin)]

    out = _both(auth_stacks, script)
    assert [r[0] for r in out] == [200, 200, 200, 403, 403, 403, 403, 200,
                                   403, 403, 200]
    assert b"SignatureDoesNotMatch" in out[4][2]
    assert b"InvalidAccessKeyId" in out[5][2]


def presign(address, method, path, access_key, secret_key, expires=60,
            offset_s=0, region="us-east-1"):
    """A SigV4 presigned query string (UNSIGNED-PAYLOAD, host signed)."""
    now = time.gmtime(time.time() + offset_s)
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    datestamp = time.strftime("%Y%m%d", now)
    scope = f"{datestamp}/{region}/s3/aws4_request"
    q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
         "X-Amz-Credential": f"{access_key}/{scope}",
         "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
         "X-Amz-SignedHeaders": "host"}
    cq = "&".join(f"{urllib.parse.quote(k, safe='~')}="
                  f"{urllib.parse.quote(v, safe='~')}"
                  for k, v in sorted(q.items()))
    canonical = "\n".join([method, urllib.parse.quote(path, safe="/~"), cq,
                           f"host:{address}\n", "host", "UNSIGNED-PAYLOAD"])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    k = ("AWS4" + secret_key).encode()
    for part in (datestamp, region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    return cq + f"&X-Amz-Signature={sig}"


def test_sigv4_presigned_queries_like_jax(auth_stacks):
    def script(s3, ns):
        req(s3, "PUT", "/pre", access_key="AKID", secret_key="SK")
        req(s3, "PUT", "/pre/obj", body=b"presigned body",
            access_key="AKID", secret_key="SK")
        a = s3.address
        return [req(s3, "GET", "/pre/obj",
                    query=presign(a, "GET", "/pre/obj", "AKID", "SK")),
                req(s3, "GET", "/pre/obj",
                    query=presign(a, "GET", "/pre/obj", "AKID", "BAD")),
                req(s3, "GET", "/pre/obj",
                    query=presign(a, "GET", "/pre/obj", "AKID", "SK",
                                  expires=5, offset_s=-60)),
                req(s3, "GET", "/pre/obj",
                    query=presign(a, "GET", "/pre/obj", "AKID", "SK",
                                  offset_s=3600)),
                req(s3, "PUT", "/pre/obj2", body=b"x",
                    query=presign(a, "PUT", "/pre/obj2", "AKR", "SKR"))]

    out = _both(auth_stacks, script)
    assert out[0][0] == 200 and out[0][2] == b"presigned body"
    assert [r[0] for r in out[1:]] == [403, 403, 403, 403]


@pytest.mark.parametrize("case", ["roundtrip", "tampered", "truncated"])
def test_streaming_sigv4_over_http_like_jax(auth_stacks, case):
    def flip(frames):
        idx = frames.find(b"\r\n") + 2
        return frames[:idx] + bytes([frames[idx] ^ 0xFF]) + frames[idx + 1:]

    def drop_final(frames):
        return frames[:frames.rfind(b"0;chunk-signature=")]

    tamper = {"roundtrip": None, "tampered": flip,
              "truncated": drop_final}[case]

    def script(s3, ns):
        req(s3, "PUT", "/sb", access_key="AKID", secret_key="SK")
        status, body = streaming_sigv4_put(
            s3.address, f"/sb/{case}", bytes(range(256)) * 37, "AKID", "SK",
            tamper=tamper)
        return (status, _ISO.sub(b"TIMESTAMP", body),
                req(s3, "GET", f"/sb/{case}", access_key="AKID",
                    secret_key="SK"))

    status, body, got = _both(auth_stacks, script)
    if case == "roundtrip":
        assert status == 200 and got[2] == bytes(range(256)) * 37
    else:
        assert status in (400, 403) and got[0] == 404


# -- each package's S3Client against its own gateway --------------------------


def test_client_query_encoding_and_streaming_like_jax(auth_stacks):
    payload = bytes((i * 13) % 256 for i in range(300 << 10))

    def script(s3, ns):
        c = ns.client.S3Client(s3.address, access_key="AKID",
                               secret_key="SK")
        c.create_bucket("docs")
        for key, body in (("my folder/a.txt", b"one"),
                          ("my folder/b.txt", b"two"),
                          ("other/c.txt", b"three")):
            c.put_object("docs", key, body)
        listed = sorted(o["key"] for o in c.list_objects(
            "docs", prefix="my folder/"))
        c.put_object_streaming("docs", "big.bin", payload,
                               chunk_size=64 << 10)
        c.put_object_streaming("docs", "iter.bin",
                               iter([b"alpha" * 100, b"", b"beta" * 200]))
        c.put_object_streaming("docs", "ba.bin", bytearray(b"abc"))
        bad = ns.client.S3Client(s3.address, access_key="AKID",
                                 secret_key="WRONG")
        with pytest.raises(ns.rpc.RpcError) as e:
            bad.put_object_streaming("docs", "x.bin", b"data")
        return (listed, c.get_object("docs", "big.bin") == payload,
                c.get_object("docs", "iter.bin"),
                c.get_object("docs", "ba.bin"),
                c.get_object_range("docs", "big.bin", 1000, 24),
                sorted(c.list_keys("docs")), e.value.status)

    out = _both(auth_stacks, script)
    assert out[0] == ["my folder/a.txt", "my folder/b.txt"] and out[1]
    assert out[2] == b"alpha" * 100 + b"beta" * 200 and out[3] == b"abc"
    assert out[4] == payload[1000:1024] and out[6] == 403


def test_client_send_returns_refusals_port(auth_stacks):
    """The port's `S3Client.send`: one signed request whose status,
    headers and body come back whatever the status, where the client's
    other calls raise.  Checked against what the same requests through
    `req` (an independent SigV4 signer) get from the port's gateway."""
    s3 = auth_stacks["port"]
    c = PKG["port"].client.S3Client(s3.address, access_key="AKID",
                                    secret_key="SK")
    c.create_bucket("sendb")
    status, headers, body = c.send("PUT", "/sendb/a b.txt", body=b"abc")
    assert status == 200 and headers["ETag"].strip('"') == \
        hashlib.md5(b"abc").hexdigest()
    assert c.send("GET", "/sendb/a b.txt")[::2] == (200, b"abc")
    listed = c.send("GET", "/sendb", {"list-type": "2", "prefix": "a "})
    assert listed[0] == 200 and b"<Key>a b.txt</Key>" in listed[2]
    for client in (PKG["port"].client.S3Client(s3.address, "AKID", "NO"),
                   PKG["port"].client.S3Client(s3.address, "AKNOBODY",
                                               "SK")):
        status, _, body = client.send("GET", "/sendb/a b.txt")
        assert status == 403 and b"<Error>" in body
    assert c.send("GET", "/sendb/none")[0] == \
        req(s3, "GET", "/sendb/none", access_key="AKID",
            secret_key="SK")[0] == 404


# -- verify() and verify_and_decode() on the same signed requests -------------


def _sign_key(secret, datestamp, region="us-east-1"):
    k = ("AWS4" + secret).encode()
    for part in (datestamp, region, "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _verdict(ns, fn):
    """What one package's IAM answers: the identity and bytes, or the
    AuthError's code and status."""
    try:
        got = fn(ns)
    except ns.auth.AuthError as e:
        return ("error", e.code, e.status)
    if isinstance(got, tuple):
        ident, body = got
        return ("ok", ident.name if ident else None, body)
    return ("ok", got.name if got else None)


def _both_iam(fn):
    out = {pkg: _verdict(ns, fn) for pkg, ns in PKG.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _iam(ns, identities=(("a", "AK", "SK"),)):
    return ns.auth.IdentityAccessManagement([
        ns.auth.Identity(name=n, access_key=a, secret_key=s)
        for n, a, s in identities])


def test_signature_derivation_known_vector_like_jax():
    """AWS's documented example of the signing key's derivation."""
    sigs = {pkg: ns.auth.IdentityAccessManagement()._signature(
        "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "20150830", "us-east-1",
        "iam", "AWS4-HMAC-SHA256\n20150830T123600Z\n"
        "20150830/us-east-1/iam/aws4_request\n"
        "f536975d06c0309214f805bb90ccff089219ecd68b2577efef23edd43b7e1a59")
        for pkg, ns in PKG.items()}
    assert sigs["port"] == sigs["jax"] == (
        "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


def _streaming_request(payload, sentinel, declared=None, trailer=None,
                       signed=True):
    """Headers and body of a streaming PUT /b/k signed with AK/SK."""
    now = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    datestamp = time.strftime("%Y%m%d", now)
    scope = f"{datestamp}/us-east-1/s3/aws4_request"
    headers = {"host": "h", "x-amz-date": amz_date,
               "x-amz-content-sha256": sentinel,
               "x-amz-decoded-content-length": str(
                   len(payload) if declared is None else declared)}
    if trailer:
        headers["x-amz-trailer"] = "x-amz-checksum-crc32c"
    names = sorted(headers)
    canonical = "\n".join(["PUT", "/b/k", "",
                           "".join(f"{h}:{headers[h]}\n" for h in names),
                           ";".join(names), sentinel])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    key = _sign_key("SK", datestamp)
    seed = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if signed:
        frames = _streaming_frames(payload, 1024, "SK", seed, amz_date,
                                   scope)
    else:
        frames = (f"{len(payload):x}\r\n".encode() + payload + b"\r\n"
                  + b"0\r\n\r\n")
    if trailer:
        idx = frames.rfind(b"0;chunk-signature=")
        didx = frames.rfind(b"chunk-signature=", 0, idx)
        prev = frames[didx + 16:frames.find(b"\r\n", didx)].decode()
        line = "x-amz-checksum-crc32c:AAAAAA=="
        tsts = "\n".join(["AWS4-HMAC-SHA256-TRAILER", amz_date, scope, prev,
                          hashlib.sha256((line + "\n").encode()).hexdigest()])
        tsig = hmac.new(key, tsts.encode(), hashlib.sha256).hexdigest()
        tsig = trailer(tsig)
        block = b"" if tsig is None else (
            line.encode() + b"\r\n"
            + f"x-amz-trailer-signature:{tsig}\r\n\r\n".encode())
        frames = frames[:idx] + b"0\r\n" + block
    send = dict(headers)
    send.update({"X-Amz-Date": amz_date, "X-Amz-Content-Sha256": sentinel,
                 "X-Amz-Decoded-Content-Length":
                 headers["x-amz-decoded-content-length"],
                 "Authorization":
                 f"AWS4-HMAC-SHA256 Credential=AK/{scope}, "
                 f"SignedHeaders={';'.join(names)}, Signature={seed}"})
    if trailer:
        send["X-Amz-Trailer"] = headers["x-amz-trailer"]
    return send, frames


@pytest.mark.parametrize("case", [
    "signed", "declared_length_mismatch", "unsigned_trailer_with_auth",
    "signed_trailer", "tampered_trailer", "missing_trailer"])
def test_streaming_decode_like_jax(case):
    payload = b"signed trailer payload" * 50
    sentinel = {"unsigned_trailer_with_auth":
                "STREAMING-UNSIGNED-PAYLOAD-TRAILER",
                "signed_trailer": "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER",
                "tampered_trailer":
                "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER",
                "missing_trailer":
                "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"}.get(
        case, "STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
    trailer = {"signed_trailer": lambda s: s,
               "tampered_trailer": lambda s: s[:-1] + (
                   "0" if s[-1] != "0" else "1"),
               "missing_trailer": lambda s: None}.get(case)
    headers, frames = _streaming_request(
        payload, sentinel,
        declared=9999 if case == "declared_length_mismatch" else None,
        trailer=trailer, signed=case != "unsigned_trailer_with_auth")
    out = _both_iam(lambda ns: _iam(ns).verify_and_decode(
        "PUT", "/b/k", {}, headers, frames))
    if case in ("signed", "unsigned_trailer_with_auth", "signed_trailer"):
        assert out == ("ok", "a", payload)
    else:
        assert out[0] == "error" and out[2] in (400, 403)


def test_unsigned_trailer_without_auth_like_jax():
    payload = b"0123456789" * 100
    frames = (f"{len(payload):x}\r\n".encode() + payload + b"\r\n0\r\n"
              + b"x-amz-checksum-crc32:AAAAAA==\r\n\r\n")
    headers = {"X-Amz-Content-Sha256": "STREAMING-UNSIGNED-PAYLOAD-TRAILER",
               "X-Amz-Decoded-Content-Length": str(len(payload))}
    assert _both_iam(lambda ns: ns.auth.IdentityAccessManagement()
                     .verify_and_decode("PUT", "/b/k", {}, headers,
                                        frames)) == ("ok", None, payload)


@pytest.mark.parametrize("sentinel", [
    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"])
def test_signed_streaming_requires_header_auth_like_jax(sentinel):
    headers = {"X-Amz-Content-Sha256": sentinel,
               "X-Amz-Decoded-Content-Length": "4"}
    out = _both_iam(lambda ns: _iam(ns).verify_and_decode(
        "PUT", "/b/k", {"X-Amz-Algorithm": "AWS4-HMAC-SHA256"}, headers,
        b"4\r\nabcd\r\n0\r\n\r\n"))
    assert out[0] == "error" and out[2] == 403


def test_sigv4_key_cache_counts_like_jax(auth_stacks):
    """The signing-key cache (S3SigV4KeyCacheCounter) counts the same
    misses and hits in both packages for the same requests."""
    def counts(ns):
        fam = ns.s3.stats.S3SigV4KeyCacheCounter
        return {r: fam._values.get((r,), 0.0) for r in ("hit", "miss")}

    def script(s3, ns):
        before = counts(ns)
        for _ in range(3):
            req(s3, "GET", "/", access_key="AKID", secret_key="SK")
        req(s3, "GET", "/", access_key="AKR", secret_key="SKR")
        after = counts(ns)
        return {r: after[r] - before[r] for r in after}

    delta = _both(auth_stacks, script)
    assert delta["hit"] + delta["miss"] == 4
