"""Shared kernel utilities: grid helpers, the CUDA build/load path and
the per-kernel launch counters.

Each ``kernels/csrc/<name>.cu`` is compiled at first use, on the machine
with the card, into its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so <name>.cu

The file name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a cached one is reused. Each build also passes
``-Xptxas -v`` and keeps nvcc's output beside the library, so a run can
print every kernel's registers and spills (:func:`resource_report`). :func:`build_all` starts
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
import re
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
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
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)              # atomic: concurrent builds agree


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` (with ptxas's ``-v`` report of
    each kernel's registers, shared memory and spills); empty when the
    library was built without it."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _toolkit(tool: str) -> str:
    return os.path.join(os.path.dirname(_nvcc()), tool)


def resource_report(name: str):
    """(entry, registers, spill store bytes, spill load bytes) of each
    kernel of ``csrc/<name>.cu`` as built, entries demangled with the
    toolkit's ``cu++filt`` where it has one."""
    rows = ptxas_usage(build_log(name))
    filt = _toolkit("cu++filt")
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout
        names = out.splitlines()
        if len(names) == len(rows):
            rows = [(n, *r[1:]) for n, r in zip(names, rows)]
    return rows


def sass_counts(name: str, opcodes) -> Dict[str, int]:
    """How often each SASS opcode occurs in the built library of
    ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    sass = subprocess.run([_toolkit("cuobjdump"), "-sass",
                           str(_lib_path(name))], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def ptxas_usage(log: str):
    """Per kernel of a ``-Xptxas -v`` log: (mangled entry name,
    registers, spill store bytes, spill load bytes), in log order."""
    rows, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            rows.append((entry, int(m.group(1)), *spills))
            entry = None
    return rows


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
    (``"p"`` pointer or stream, ``"i"`` int, ``"l"`` 64-bit int, ``"f"``
    float)."""
    f = getattr(library(name), fn)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "f": ctypes.c_float}
    f.argtypes = [kinds[a] for a in argtypes]
    f.restype = ctypes.c_int
    return f


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA device (the launch plans' one input that is
    not a shape)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


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
