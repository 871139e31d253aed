"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C launch function and is compiled on
first use into ``kernels/build/lib<name>-<hash>.so`` (``build/`` is git
ignored); the hash covers the source and every ``csrc/*.cuh`` it includes,
so a stale library is never loaded after an edit to either.
``build(names)`` starts one ``nvcc`` per missing source, all at once, and
waits for them together.  Nothing is built or imported when this module
is imported: the CPU tests import every module of the port.

The wrappers of every kernel module share the checks and the launch
below: ``check`` (dtype, shape, device, contiguity), ``on_card`` (CUDA
launches the kernel, a CPU tensor runs the plain version, any other device
raises), ``refuse_grad`` (a kernel without a backward raises on the card
under grad mode when an input requires grad) and ``launch`` (the C
function on PyTorch's current stream, raising on a nonzero code, with the
library's ``launch_why()`` text where it has one).
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

from repro_torch import kernels

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
L = ctypes.c_longlong     # element strides

_LOADED: dict = {}        # name -> ctypes.CDLL, loaded once per process
BUILD_LOG: dict = {}      # name -> {"seconds": s, "ptxas": text}


def all_sources() -> tuple:
    """The stem of every ``csrc/*.cu``: one library each."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


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


def check(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_card(name, device) -> bool:
    """True on the card (``kernels.on_card``), False for the CPU (plain
    version); raises for any other device."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    return kernels.on_card(device)


def refuse_grad(name, tensors, error=ValueError,
                what="it has no backward kernel"):
    """Raise ``error`` when grad mode is on and one of ``tensors`` (nested
    tuples and lists allowed) requires grad: a kernel without a backward
    would return an output cut off from the graph, and the gradient would
    be lost without a word.  Called on the card before the launch."""
    import torch

    if not torch.is_grad_enabled():
        return
    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise error(f"{name}: an input requires grad, and {what}; call "
                        f"it under torch.no_grad() or on detached inputs")


def launch(name, source, argtypes, device, *args):
    """Call ``<name>_launch`` of ``csrc/<source>.cu`` on the current stream
    (tensors pass as device pointers); raise on a CUDA error."""
    import torch

    lib = load(source)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [P]      # + the stream
        fn.restype = ctypes.c_int
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}"
                           f"{_why(lib)}")


def _why(lib) -> str:
    """``": <text>"`` of a library's ``launch_why()`` (``csrc/
    launch_status.cuh``: which check refused the call), or ``""`` for a
    library without one."""
    why = getattr(lib, "launch_why", None)
    if why is None:
        return ""
    why.restype = ctypes.c_char_p
    text = why().decode(errors="replace")
    return f": {text}" if text else ""
