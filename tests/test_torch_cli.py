"""The port's command line (`python -m seaweedfs_tpu_torch`) against the
repo's `weed.py`.

- Every ported subcommand's parser accepts the reference parser's flags,
  with the same defaults; the port adds only `-device`.
- `NOT_PORTED_COMMANDS` is the reference's subcommands less the ported
  ones, and each of them exits 2 naming ROADMAP item 9.
- `master` and `volume -device cpu` as subprocesses answer `/dir/status`
  and `/cluster/health`; `shell -c "ec.encode ..."` over them writes shard
  files and an `.ecx` byte-identical to the JAX package's encode of the
  same volume; `top -once` and `maintenance status` read them; SIGTERM
  ends every process.
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
          "compact", "fix", "scrub", "export", "version", "autocomplete")


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
    ref = set(_subparsers(_reference_parser()))
    assert t_weed.NOT_PORTED_COMMANDS == ref - set(PORTED)
    assert set(_subparsers(t_weed.build_parser())) == ref


@pytest.mark.parametrize("cmd", sorted(t_weed.NOT_PORTED_COMMANDS))
def test_not_ported_command_exits_naming_item_9(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        t_weed.main([cmd, "-master", "127.0.0.1:1"])
    assert e.value.code == 2
    assert "ROADMAP item 9" in capsys.readouterr().err


def test_server_with_a_filer_exits_naming_item_9(capsys):
    for flag in ("-filer", "-s3", "-iam"):
        with pytest.raises(SystemExit) as e:
            t_weed.main(["server", flag, "-dir", "/nonexistent"])
        assert e.value.code == 2
        assert "ROADMAP item 9" in capsys.readouterr().err


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
        assert "error: fs.ls needs the filer" in text

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
