"""The port's command line (`python -m seaweedfs_tpu_torch`) against the
repo's `weed.py`.

- Every subcommand of the reference's parser is ported, and its parser
  accepts the reference parser's flags, with the same defaults; the port
  adds only `-device`.
- `master` and `volume -device cpu` as subprocesses answer `/dir/status`
  and `/cluster/health`; `shell -c "ec.encode ..."` over them writes shard
  files and an `.ecx` byte-identical to the JAX package's encode of the
  same volume; `top -once` and `maintenance status` read them; SIGTERM
  ends every process.
- `filer.store`, `filer -store remote`, `filer.copy`, `filer.cat` and the
  shell's fs.* commands over them; `server -filer -s3 -iam` serves a
  filer, the S3 API and the IAM API; `scaffold` prints the JAX tool's
  templates.
- `s3 -config` answers SigV4-signed requests and refuses unsigned ones;
  `iam` creates a key that its gateway accepts at once; `filer.backup
  -once`, `filer.meta.backup -once`/`-restore`, `filer.meta.tail -once`
  and `filer.sync -once` copy a filer's tree; `benchmark` prints its
  report; `upload` then `download` return the same bytes.
- `lint-dashboards` exits 0; `scrub` on a damaged EC directory prints
  the JAX tool's report; `fix`, `compact` and `export` print what the JAX
  tools print and leave the same files.
Each subprocess has its own timeout and is killed in a `finally`.
Tolerance: equality throughout.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch import weed as t_weed
from seaweedfs_tpu_torch.rpc.http_rpc import call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORTED = ("master", "master.follower", "volume", "server", "shell",
          "profile", "maintenance", "top", "lint-dashboards", "backup",
          "compact", "fix", "scrub", "export", "version", "autocomplete",
          "filer", "filer.store", "filer.copy", "filer.cat", "scaffold",
          "s3", "iam", "benchmark", "upload", "download", "filer.sync",
          "filer.backup", "filer.replicate", "filer.meta.backup",
          "filer.meta.tail", "filer.remote.sync", "filer.remote.gateway")


class _Parsed(Exception):
    pass


def _reference_parser():
    """The top-level parser that `weed.py`'s main() builds, caught at its
    parse_args call."""
    import weed as j_weed

    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        j_weed.main([])
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("weed.main built no parser")


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(p):
    return {s: a.default for a in p._actions for s in a.option_strings
            if s not in ("-h", "--help")}


@pytest.mark.parametrize("cmd", PORTED)
def test_ported_subcommand_takes_the_reference_flags(cmd):
    ref = _subparsers(_reference_parser())[cmd]
    port = _subparsers(t_weed.build_parser())[cmd]
    got = _options(port)
    got.pop("-device", None)
    assert got == _options(ref)
    assert [a.dest for a in port._actions if not a.option_strings] == \
        [a.dest for a in ref._actions if not a.option_strings]


def test_top_level_flags_match():
    assert _options(t_weed.build_parser()) == _options(_reference_parser())


def test_not_ported_commands_are_the_reference_rest():
    """No command is left unported: the reference's subcommands are
    `PORTED`, and the port's parser has exactly them."""
    ref = set(_subparsers(_reference_parser()))
    assert ref - set(PORTED) == set()
    assert set(_subparsers(t_weed.build_parser())) == ref == set(PORTED)
    assert not hasattr(t_weed, "NOT_PORTED_COMMANDS")


def test_version_and_autocomplete(capsys):
    t_weed.main(["version"])
    assert capsys.readouterr().out.startswith("seaweedfs_tpu_torch ")
    t_weed.main(["autocomplete"])
    script = capsys.readouterr().out
    for cmd in PORTED:
        assert f" {cmd}" in script or f'"{cmd}' in script


def test_lint_dashboards_exits_zero():
    res = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "lint-dashboards"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "reference only registered families" in res.stdout


# -- the offline tools, in process against the reference's ---------------------


def _needle_volume(directory, vid=7, n=30, seed=5):
    from seaweedfs_tpu_torch.storage import needle as t_needle
    from seaweedfs_tpu_torch.storage import volume as t_volume

    rng = np.random.default_rng(seed)
    v = t_volume.Volume(str(directory), "", vid)
    for i in range(1, n):
        nd = t_needle.Needle.create(rng.bytes(int(rng.integers(100, 30000))))
        nd.id, nd.cookie = i, i
        v.write_needle(nd)
    for i in (3, 11):
        v.delete_needle(t_needle.Needle(id=i, cookie=i))
    v.close()


def _run_main(main, argv, capsys):
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_scrub_prints_the_jax_tools_report(tmp_path, capsys):
    import weed as j_weed
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc

    src = tmp_path / "src"
    src.mkdir()
    _needle_volume(src)
    base = str(src / "7")
    crcs = t_enc.write_ec_files(base, 10000, 100, device="cpu",
                                batched=True)
    t_enc.save_volume_info(base, version=3,
                           extra={"shard_crc32c": list(crcs)})
    out = {}
    for name, main, extra in (("jax", j_weed.main, []),
                              ("port", t_weed.main, ["-device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(src, d)
        with open(d / "7.ec03", "r+b") as f:
            f.seek(17)
            f.write(b"\xff")
        (d / "7.ec12").unlink()
        args = ["scrub", "-dir", str(d), "-volumeId", "7"] + extra
        damaged = _run_main(main, args, capsys)
        repaired = _run_main(main, args + ["-repair"], capsys)
        clean = _run_main(main, args, capsys)
        out[name] = (damaged, repaired, clean,
                     [(d / f"7.ec{i:02d}").read_bytes() for i in range(14)])
    assert out["port"] == out["jax"]
    (code, text), _, (code3, text3), shards = out["port"]
    assert code == 1 and json.loads(text)["corrupt"] == [3]
    assert json.loads(text)["missing"] == [12]
    assert code3 == 0 and json.loads(text3)["corrupt"] == []
    assert shards == [(src / f"7.ec{i:02d}").read_bytes() for i in range(14)]


@pytest.mark.parametrize("tool", ["fix", "compact", "export"])
def test_offline_tool_prints_what_jax_prints(tmp_path, capsys, tool):
    import weed as j_weed

    src = tmp_path / "src"
    src.mkdir()
    _needle_volume(src, seed=11)
    out = {}
    for name, main in (("jax", j_weed.main), ("port", t_weed.main)):
        d = tmp_path / name
        shutil.copytree(src, d)
        args = [tool, "-dir", str(d), "-volumeId", "7"]
        if tool == "export":
            args += ["-o", str(d / "x.tar")]
        code, text = _run_main(main, args, capsys)
        files = {f: (d / f).read_bytes() for f in ("7.dat", "7.idx")}
        out[name] = (code, text.replace(str(d), "<dir>"), files)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and out["port"][1]


# -- live daemons through the port's command line ---------------------------------


def _start(args, env, log):
    """A daemon of the port's CLI; returns (process, address) once it
    printed its listening line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch"] + args, cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=open(log, "w"), text=True)
    line = proc.stdout.readline()
    if "listening on" not in line:
        proc.kill()
        raise AssertionError(f"{args[0]} did not start: {line!r} "
                             f"{open(log).read()[-2000:]}")
    return proc, line.split("listening on ")[1].split(",")[0].split()[0]


def _cli(args, env, timeout=120):
    res = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch"]
                         + args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def test_daemons_through_the_cli_encode_like_jax(tmp_path):
    from seaweedfs_tpu.storage.store import Store as JStore

    env = dict(os.environ, WEED_MAINT_WORKER="0",
               WEED_MAINT_INTERVAL="3600", WEED_HEALTH_SCRAPE_MS="200")
    (tmp_path / "m").mkdir()
    (tmp_path / "v").mkdir()
    procs = []
    try:
        master, maddr = _start(
            ["master", "-port", "0", "-mdir", str(tmp_path / "m"),
             "-pulseSeconds", "0.3"], env, tmp_path / "m.log")
        procs.append(master)
        vol, vaddr = _start(
            ["volume", "-port", "0", "-dir", str(tmp_path / "v"),
             "-mserver", maddr, "-pulseSeconds", "0.3", "-device", "cpu",
             "-rack", "r1"], env, tmp_path / "v.log")
        procs.append(vol)

        def nodes():
            st = call(maddr, "/dir/status")
            return [n["url"] for dc in st["datacenters"]
                    for r in dc["racks"] for n in r["nodes"]]

        assert _wait(lambda: nodes() == [vaddr])
        assert _wait(lambda: call(maddr, "/cluster/health")["nodes"].get(
            vaddr, {}).get("up") is True)
        assert _wait(lambda: call(maddr, "/cluster/health")["scrape"][
            "rounds"] >= 2)
        health = call(maddr, "/cluster/health")
        assert health["status"] == "ok" and health["leader"] == maddr
        assert call(maddr, "/cluster/alerts")["alerts"] == []

        rng = np.random.default_rng(3)
        vids = set()
        for _ in range(40):
            a = call(maddr, "/dir/assign")
            call(a["url"], f"/{a['fid']}",
                 raw=rng.bytes(int(rng.integers(100, 20000))),
                 method="POST")
            vids.add(int(a["fid"].split(",")[0]))
        vid = min(vids)
        copy = tmp_path / "jax"
        copy.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(tmp_path / "v" / f"{vid}{ext}", copy)

        text = _cli(["shell", "-master", maddr, "-c",
                     f"ec.encode {vid}; volume.list; fs.ls /"], env)
        assert f'"volume": {vid}' in text
        assert "error: no filer registered with the master" in text

        JStore([str(copy)]).ec_generate(vid)
        for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx"]:
            assert (tmp_path / "v" / f"{vid}{ext}").read_bytes() == \
                (copy / f"{vid}{ext}").read_bytes(), ext
        assert not (tmp_path / "v" / f"{vid}.dat").exists()

        top = _cli(["top", "-master", maddr, "-once"], env)
        assert top.startswith("cluster OK") and vaddr in top
        status = json.loads(_cli(["maintenance", "status", "-master",
                                  maddr], env))
        assert "queue" in status
        qos = json.loads(_cli(["shell", "-master", maddr, "-c",
                               "qos.status"], env))
        assert f"volume {vaddr}" in qos["daemons"]
        scale = json.loads(_cli(["shell", "-master", maddr, "-c",
                                 "cluster.scale"], env))
        assert [n["url"] for n in scale["nodes"]] == [vaddr]
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0]


# -- the filer through the command line ---------------------------------------------


@pytest.mark.parametrize("config", ["security", "master", "filer",
                                    "replication", "notification"])
def test_scaffold_prints_what_jax_prints(tmp_path, capsys, config):
    import weed as j_weed

    out = {}
    for name, main in (("jax", j_weed.main), ("port", t_weed.main)):
        d = tmp_path / name
        d.mkdir()
        printed = _run_main(main, ["scaffold", "-config", config], capsys)
        written = _run_main(main, ["scaffold", "-config", config, "-output",
                                   str(d)], capsys)
        out[name] = (printed, written[0], written[1].replace(str(d), "<d>"),
                     (d / f"{config}.toml").read_text())
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 0 and out["port"][3] == out["port"][0][1]


def _files(root, seed=9):
    rng = np.random.default_rng(seed)
    out = {}
    for rel in ("a.txt", "b/c.bin", "b/d/e.json", "big.bin"):
        size = 9000 if rel == "big.bin" else int(rng.integers(10, 3000))
        body = (b"plain text %d\n" % size) * 40 if rel == "a.txt" \
            else rng.bytes(size)
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(body)
        out[rel] = body
    return out


def test_filer_commands_through_the_cli(tmp_path):
    """master, volume, filer.store and a stateless `filer -store remote`
    as processes of the port's CLI; `filer.copy` of a directory,
    `filer.cat` of each file, the shell's fs.* over them."""
    env = dict(os.environ, WEED_MAINT_WORKER="0",
               WEED_MAINT_INTERVAL="3600")
    for d in ("m", "v", "src"):
        (tmp_path / d).mkdir()
    files = _files(tmp_path / "src")
    procs = []
    try:
        master, maddr = _start(
            ["master", "-port", "0", "-mdir", str(tmp_path / "m"),
             "-pulseSeconds", "0.3"], env, tmp_path / "m.log")
        procs.append(master)
        vol, vaddr = _start(
            ["volume", "-port", "0", "-dir", str(tmp_path / "v"),
             "-mserver", maddr, "-pulseSeconds", "0.3", "-device", "cpu"],
            env, tmp_path / "v.log")
        procs.append(vol)
        store, saddr = _start(["filer.store", "-port", "0"], env,
                              tmp_path / "s.log")
        procs.append(store)
        filer, faddr = _start(
            ["filer", "-port", "0", "-master", maddr, "-store", "remote",
             "-storeAddress", saddr, "-maxMB", "1", "-device", "cpu"],
            env, tmp_path / "f.log")
        procs.append(filer)
        assert _wait(lambda: call(maddr, "/cluster/nodes?type=filer")[
            "cluster_nodes"]) and _wait(lambda: call(maddr, "/dir/status")[
                "datacenters"])
        copied = _cli(["filer.copy", str(tmp_path / "src"), "-filer", faddr,
                       "-path", "/in"], env)
        assert copied.strip() == f"copied 4 files to {faddr}/in"
        for rel, body in files.items():
            res = subprocess.run(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.cat",
                 f"/in/src/{rel}", "-filer", faddr], cwd=REPO, env=env,
                capture_output=True, timeout=120)
            assert res.returncode == 0 and res.stdout == body, rel
        res = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.cat",
             "/in/src/b", "-filer", faddr], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 1 and "is a directory" in res.stderr
        text = _cli(["shell", "-master", maddr, "-c",
                     "fs.du /in; fs.ls -l /in/src/b; "
                     "fs.configure -locationPrefix=/warm/ -collection=warm "
                     "-ecCode=cauchy; fs.cat /in/src/a.txt"], env)
        du = json.loads(text[:text.index("}") + 1])
        assert du["files"] == 4 and du["bytes"] == sum(map(len,
                                                           files.values()))
        assert '"ec_code": "cauchy"' in text
        assert text.endswith(files["a.txt"].decode())
        assert call(faddr, "/in/src/big.bin", parse=False) == \
            files["big.bin"]
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0, 0, 0]


def test_server_starts_a_filer(tmp_path):
    """`server -filer` serves master, volume server and filer from one
    process; a file written through its filer reads back."""
    env = dict(os.environ, WEED_MAINT_WORKER="0",
               WEED_MAINT_INTERVAL="3600")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-filer",
         "-dir", str(tmp_path), "-masterPort", "0", "-volumePort", "0",
         "-filerPort", "0", "-device", "cpu", "-pulseSeconds", "0.3"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=open(tmp_path / "server.log", "w"), text=True)
    try:
        lines = [proc.stdout.readline() for _ in range(3)]
        assert [ln.split(" on ")[0] for ln in lines] == [
            "master", "volume server", "filer"], lines
        faddr = lines[2].split(" on ")[1].strip()
        body = bytes(range(256)) * 40
        call(faddr, "/s/f.bin", raw=body, method="POST")
        assert call(faddr, "/s/f.bin", parse=False) == body
        assert call(faddr, "/s/")["Entries"][0]["FileSize"] == len(body)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0


def _stop(procs):
    """SIGTERM every process, kill what outlives 20 s; the exit codes."""
    for p in reversed(procs):
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def _start_line(args, env, log, marker):
    """A daemon of the port's CLI whose first line starts with `marker`;
    returns (process, that line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch"] + args, cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=open(log, "w"), text=True)
    line = proc.stdout.readline()
    if not line.startswith(marker):
        proc.kill()
        raise AssertionError(f"{args[0]} did not start: {line!r} "
                             f"{open(log).read()[-2000:]}")
    return proc, line


def _addr_after(line, word):
    return line.split(word, 1)[1].split()[0].strip("()")


def _iam(addr, action, **params):
    from test_s3_extras import iam_call

    return iam_call(addr, action, **params)


def _iam_key(body):
    import xml.etree.ElementTree as ET

    ns = "{https://iam.amazonaws.com/doc/2010-05-08/}"
    root = ET.fromstring(body)
    return (root.find(f".//{ns}AccessKeyId").text,
            root.find(f".//{ns}SecretAccessKey").text)


def _master_and_volume(tmp_path, env, procs):
    for d in ("m", "v"):
        (tmp_path / d).mkdir()
    master, maddr = _start(
        ["master", "-port", "0", "-mdir", str(tmp_path / "m"),
         "-pulseSeconds", "0.3"], env, tmp_path / "m.log")
    procs.append(master)
    vol, vaddr = _start(
        ["volume", "-port", "0", "-dir", str(tmp_path / "v"),
         "-mserver", maddr, "-pulseSeconds", "0.3", "-device", "cpu"],
        env, tmp_path / "v.log")
    procs.append(vol)
    assert _wait(lambda: call(maddr, "/dir/status")["datacenters"])
    return maddr, vaddr


def _cli_env():
    return dict(os.environ, WEED_MAINT_WORKER="0",
                WEED_MAINT_INTERVAL="3600")


def test_server_serves_s3_and_iam(tmp_path):
    """`server -filer -s3 -iam` serves master, volume server, filer, the
    S3 API and the IAM API from one process; a key made through the IAM
    API turns the gateway's auth on at once."""
    from test_s3 import sigv4_request

    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-filer",
         "-s3", "-iam", "-dir", str(tmp_path), "-masterPort", "0",
         "-volumePort", "0", "-filerPort", "0", "-s3Port", "0",
         "-iamPort", "0", "-device", "cpu", "-pulseSeconds", "0.3"],
        cwd=REPO, env=_cli_env(), stdout=subprocess.PIPE,
        stderr=open(tmp_path / "server.log", "w"), text=True)
    try:
        lines = [proc.stdout.readline() for _ in range(5)]
        assert [ln.split(" on ")[0] for ln in lines] == [
            "master", "volume server", "filer", "s3 gateway",
            "iam api"], lines
        s3, iam = (ln.split(" on ")[1].strip() for ln in lines[3:])
        body = bytes(range(256)) * 40
        assert sigv4_request(s3, "PUT", "/sb")[0] == 200
        status, headers, _ = sigv4_request(s3, "PUT", "/sb/k", body=body)
        assert status == 200
        assert sigv4_request(s3, "GET", "/sb/k")[2] == body
        assert _iam(iam, "CreateUser", UserName="ann")[0] == 200
        status, _, reply = _iam(iam, "CreateAccessKey", UserName="ann")
        assert status == 200
        ak, sk = _iam_key(reply)
        policy = json.dumps({"Statement": [{
            "Effect": "Allow", "Action": ["s3:GetObject"],
            "Resource": "arn:aws:s3:::sb/*"}]})
        assert _iam(iam, "PutUserPolicy", UserName="ann",
                    PolicyDocument=policy)[0] == 200
        assert sigv4_request(s3, "GET", "/sb/k")[0] == 403
        got = sigv4_request(s3, "GET", "/sb/k", access_key=ak, secret_key=sk)
        assert got[0] == 200 and got[2] == body
        assert sigv4_request(s3, "PUT", "/sb/x", body=b"x", access_key=ak,
                             secret_key=sk)[0] == 403
    finally:
        codes = _stop([proc])
    assert codes == [0]


def test_s3_command_answers_signed_requests(tmp_path):
    """`s3 -config` with an identities file: SigV4-signed requests pass,
    unsigned and badly signed ones get 403."""
    from test_s3 import sigv4_request

    env = _cli_env()
    (tmp_path / "ids.json").write_text(json.dumps({"identities": [
        {"name": "admin", "access_key": "AKID", "secret_key": "SK"}]}))
    procs = []
    try:
        maddr, _ = _master_and_volume(tmp_path, env, procs)
        gw, line = _start_line(
            ["s3", "-port", "0", "-master", maddr, "-config",
             str(tmp_path / "ids.json"), "-device", "cpu"], env,
            tmp_path / "s3.log", "s3 gateway on ")
        procs.append(gw)
        s3 = _addr_after(line, "s3 gateway on ")
        assert _addr_after(line, "(filer ") in [
            n["address"] for n in call(
                maddr, "/cluster/nodes?type=filer")["cluster_nodes"]]
        body = np.random.default_rng(5).bytes(5000)
        keys = {"access_key": "AKID", "secret_key": "SK"}
        assert sigv4_request(s3, "PUT", "/cb", **keys)[0] == 200
        status, headers, _ = sigv4_request(s3, "PUT", "/cb/o.bin",
                                           body=body, **keys)
        assert status == 200
        import hashlib

        assert headers["ETag"] == f'"{hashlib.md5(body).hexdigest()}"'
        assert sigv4_request(s3, "GET", "/cb/o.bin", **keys)[2] == body
        status, _, reply = sigv4_request(s3, "GET", "/cb/o.bin")
        assert status == 403 and b"AccessDenied" in reply
        status, _, reply = sigv4_request(s3, "GET", "/cb/o.bin",
                                         access_key="AKID",
                                         secret_key="WRONG")
        assert status == 403 and b"SignatureDoesNotMatch" in reply
    finally:
        codes = _stop(procs)
    assert codes == [0, 0, 0]


def test_iam_command_creates_a_key_the_gateway_accepts(tmp_path):
    """`iam` serves the IAM API with its own gateway and embedded filer:
    a user with a key and a bucket policy reads and writes that bucket at
    once, is refused elsewhere, and loses access with DeleteAccessKey."""
    from test_s3 import sigv4_request

    env = _cli_env()
    (tmp_path / "ids.json").write_text(json.dumps({"identities": [
        {"name": "admin", "access_key": "AKID", "secret_key": "SK"}]}))
    procs = []
    try:
        maddr, _ = _master_and_volume(tmp_path, env, procs)
        proc, line = _start_line(
            ["iam", "-port", "0", "-s3Port", "0", "-master", maddr,
             "-config", str(tmp_path / "ids.json"), "-device", "cpu"], env,
            tmp_path / "iam.log", "iam api on ")
        procs.append(proc)
        iam, s3 = _addr_after(line, "iam api on "), _addr_after(line, "(s3 ")
        admin = {"access_key": "AKID", "secret_key": "SK"}
        for bucket in ("warm", "other"):
            assert sigv4_request(s3, "PUT", f"/{bucket}", **admin)[0] == 200
        assert _iam(iam, "CreateUser", UserName="app")[0] == 200
        ak, sk = _iam_key(_iam(iam, "CreateAccessKey", UserName="app")[2])
        policy = json.dumps({"Statement": [{
            "Effect": "Allow",
            "Action": ["s3:GetObject", "s3:PutObject", "s3:ListBucket"],
            "Resource": ["arn:aws:s3:::warm", "arn:aws:s3:::warm/*"]}]})
        assert _iam(iam, "PutUserPolicy", UserName="app",
                    PolicyDocument=policy)[0] == 200
        app = {"access_key": ak, "secret_key": sk}
        assert sigv4_request(s3, "PUT", "/warm/a", body=b"abc",
                             **app)[0] == 200
        assert sigv4_request(s3, "GET", "/warm/a", **app)[2] == b"abc"
        assert sigv4_request(s3, "PUT", "/other/a", body=b"abc",
                             **app)[0] == 403
        assert _iam(iam, "DeleteAccessKey", UserName="app",
                    AccessKeyId=ak)[0] == 200
        status, _, reply = sigv4_request(s3, "GET", "/warm/a", **app)
        assert status == 403 and b"InvalidAccessKeyId" in reply
    finally:
        codes = _stop(procs)
    assert codes == [0, 0, 0]


def test_replication_commands_copy_a_filer(tmp_path):
    """`filer.backup -once` into a local directory, `filer.meta.backup
    -once` and `-restore`, `filer.meta.tail -once` and `filer.sync
    -isActivePassive -once` into a second filer: every file arrives with
    its bytes.  Each `-state` lies under the test's own directory."""
    env = _cli_env()
    (tmp_path / "src").mkdir()
    files = _files(tmp_path / "src")
    procs = []
    try:
        maddr, _ = _master_and_volume(tmp_path, env, procs)
        fa = fb = None
        for tag in ("a", "b"):
            proc, addr = _start(
                ["filer", "-port", "0", "-master", maddr, "-maxMB", "1",
                 "-device", "cpu"], env, tmp_path / f"f{tag}.log")
            procs.append(proc)
            fa, fb = (addr, fb) if tag == "a" else (fa, addr)
        _cli(["filer.copy", str(tmp_path / "src"), "-filer", fa, "-path",
              "/in"], env)
        _cli(["filer.backup", "-filer", fa, "-filerPath", "/in",
              "-sink", f"local://{tmp_path / 'bk'}", "-once",
              "-state", str(tmp_path / "bk.state")], env)
        for rel, body in files.items():
            assert (tmp_path / "bk" / "src" / rel).read_bytes() \
                == body, rel
        assert json.loads((tmp_path / "bk.state").read_text())["backup"] > 0
        _cli(["filer.meta.backup", "-filer", fa, "-filerPath", "/",
              "-store", str(tmp_path / "meta.db"), "-once"], env)
        listed = [json.loads(ln) for ln in _cli(
            ["filer.meta.backup", "-filerPath", "/in", "-store",
             str(tmp_path / "meta.db"), "-restore"], env).splitlines()]
        sizes = {e["full_path"]: e["attr"]["file_size"] for e in listed
                 if not e["attr"]["mode"] & 0o40000}
        assert sizes == {f"/in/src/{rel}": len(body)
                         for rel, body in files.items()}
        events = [json.loads(ln) for ln in _cli(
            ["filer.meta.tail", "-filer", fa, "-pathPrefix", "/in/src/b",
             "-once"], env).splitlines()]
        assert {e["new_entry"]["full_path"] for e in events} >= {
            "/in/src/b/c.bin", "/in/src/b/d/e.json"}
        _cli(["filer.sync", "-a", fa, "-b", fb, "-a.path", "/in/",
              "-b.path", "/mirror/", "-isActivePassive", "-once",
              "-state", str(tmp_path / "sync.state")], env)
        for rel, body in files.items():
            assert call(fb, f"/mirror/src/{rel}", parse=False) == body, rel
        res = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch",
             "filer.remote.sync", "-filer", fa, "-dir", "/in", "-once",
             "-state", str(tmp_path / "remote.state")], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 1 and "is not a remote mount" in res.stdout
    finally:
        codes = _stop(procs)
    assert codes == [0, 0, 0, 0]


def test_benchmark_upload_and_download_commands(tmp_path):
    """`benchmark` prints its write and read reports; `upload` of a file
    then `download` of its fid give the same bytes."""
    env = _cli_env()
    procs = []
    try:
        maddr, _ = _master_and_volume(tmp_path, env, procs)
        out = _cli(["benchmark", "-master", maddr, "-n", "60", "-size",
                    "512", "-c", "4"], env)
        for phase in ("write", "read"):
            assert f"--- {phase} ---\nrequests: 60, errors: 0\n" in out, out
        assert out.count(" req/s, ") == 2 and out.count("  p99: ") == 2
        body = np.random.default_rng(8).bytes(7000)
        (tmp_path / "up.bin").write_bytes(body)
        up = json.loads(_cli(["upload", str(tmp_path / "up.bin"),
                              "-master", maddr], env))
        assert up["size"] > len(body)  # the needle, with its name
        got = _cli(["download", up["fid"], "-master", maddr, "-output",
                    str(tmp_path / "down.bin")], env)
        assert got.strip() == f"wrote {len(body)} bytes to " \
                              f"{tmp_path / 'down.bin'}"
        assert (tmp_path / "down.bin").read_bytes() == body
    finally:
        codes = _stop(procs)
    assert codes == [0, 0]
