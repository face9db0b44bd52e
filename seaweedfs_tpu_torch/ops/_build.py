"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded with ctypes.  The build
happens at first use, from the checkout's sources only, into
`seaweedfs_tpu_torch/_build/` (git-ignored); a library is named by a hash
of its sources and flags, so an edited kernel rebuilds and an unchanged
one loads at once.  `build_all()` starts one nvcc per source at the same
time.

Nothing here runs at import: the CPU tests import every module, and this
host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("gf_apply", "fused_apply_crc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc output (registers, spills) per build


def nvcc_path() -> str:
    """nvcc on PATH, else under CUDA_HOME / the toolkit torch was built
    against; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn == name + ".cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, path: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named kernel library."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        paths = {n: _lib_path(n) for n in todo}
        procs = {n: _start(n, paths[n]) for n in todo
                 if not os.path.exists(paths[n])}
        logs = {n: proc.communicate()[0] for n, proc in procs.items()}
        failed = [n for n, proc in procs.items() if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}.cu\n{logs[n]}" for n in failed))
        for n in procs:
            os.replace(f"{paths[n]}.{os.getpid()}.tmp", paths[n])
        build_logs.update(logs)
        for n in todo:
            _libs[n] = ctypes.CDLL(paths[n])
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]
