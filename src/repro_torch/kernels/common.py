"""Shared kernel utilities: grid helpers, the CUDA build/load path and
the per-kernel launch counters.

Each ``kernels/csrc/<name>.cu`` is compiled at first use, on the machine
with the card, into its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so <name>.cu

The file name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a cached one is reused. :func:`build_all` starts
one ``nvcc`` per source, all at once. Libraries are loaded with
``ctypes``; every pointer and the stream cross as ``c_void_p``. Every C
entry returns ``cudaGetLastError()`` and :func:`check` raises on a
nonzero code. Nothing here falls back to the plain versions: a build or
launch that fails raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

#: kernel name → launches since the last :func:`reset_launches`. Each
#: wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (popen, tmp, out) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job):
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)              # atomic: concurrent builds agree


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all():
    """Build every kernel source in parallel (one nvcc each)."""
    with _lock:
        jobs = {n: _start_build(n) for n in sources()}
        for n, job in jobs.items():
            _finish_build(n, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, fn: str, argtypes: str):
    """C entry ``fn`` of ``csrc/<name>.cu`` with its argument types set
    (``"p"`` pointer or stream, ``"i"`` int, ``"f"`` float)."""
    f = getattr(library(name), fn)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    f.argtypes = [kinds[a] for a in argtypes]
    f.restype = ctypes.c_int
    return f


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (→ the plain version);
    False when every tensor lies on one CUDA device (→ the kernel).
    Anything else raises: a wrapper never picks a path by itself."""
    devs = {t.device for t in tensors}
    require(len(devs) == 1, f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    require(dev.type == "cuda", f"no kernel for device {dev}")
    return False


def check_contiguous(**tensors):
    for name, t in tensors.items():
        require(t.is_contiguous(), f"{name} must be contiguous")


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    require(name in DTYPE_CODES,
            f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]
