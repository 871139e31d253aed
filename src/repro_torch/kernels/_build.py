"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C launch function and is compiled on
first use into ``kernels/build/lib<name>-<hash>.so`` (``build/`` is git
ignored); the hash covers the source and every ``csrc/*.cuh`` it includes,
so a stale library is never loaded after an edit to either.
``build(names)`` starts one ``nvcc`` per missing source, all at once, and
waits for them together.  Nothing is built or imported when this module
is imported: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOADED: dict = {}        # name -> ctypes.CDLL, loaded once per process
BUILD_LOG: dict = {}      # name -> {"seconds": s, "ptxas": text}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/*.cuh`` it includes, directly or
    through another header, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes())]
    return seen


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, the headers it
    includes and the target flags: an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict:
    """Compile every missing library of ``names`` in parallel; returns
    ``{name: seconds}`` (0.0 for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ""})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)         # atomic: a reader never sees half a file
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return {name: BUILD_LOG[name]["seconds"] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LOADED[name] = lib
    return lib
