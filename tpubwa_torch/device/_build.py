"""Build-at-first-use for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C entry point.  It is compiled
with nvcc for Hopper (sm_90a) into a shared library keyed by a hash of
its source, the headers of ``csrc/`` it includes and the flags, the way tpubwa/native builds its C++, and loaded
with ctypes.  Nothing here runs at import time: the CPU-only test
environment imports every module and has no nvcc.

The build directory is ``build/cuda`` at the root of the checkout
(git-ignored), or ``$TPUBWA_TORCH_BUILD``.  Beside each library the
assembler's register/spill report is kept (``<name>-<hash>.ptxas.txt``),
so a cached load reports it too.  Different kernels build concurrently
from separate threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(os.environ.get(
    "TPUBWA_TORCH_BUILD",
    Path(__file__).resolve().parents[2] / "build" / "cuda"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_locks: dict = {}            # one lock per kernel source
_locks_guard = threading.Lock()
# per kernel source: {"so": path, "seconds": build wall (0.0 when the
# hash-keyed library already existed), "ptxas": the assembler's
# register/spill report}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources(src: Path) -> list:
    """``src`` and every file of its directory that it includes with
    ``#include "..."``, directly or through another, in the order
    first reached."""
    found, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in found or not path.exists():
            continue
        found.append(path)
        todo += [path.parent / m for m in re.findall(
            r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M)]
    return found


def _key(name: str) -> bytes:
    """What a library of ``csrc/<name>.cu`` is keyed by: its source, the
    headers it includes (an edit to one builds anew) and the flags."""
    return (b"".join(p.read_bytes() for p in _sources(CSRC / f"{name}.cu"))
            + " ".join(NVCC_FLAGS).encode())


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = _key(name)
    so = BUILD / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.txt")
    info = {"so": str(so), "seconds": 0.0, "ptxas": ""}
    if so.exists():
        if report.exists():
            info["ptxas"] = report.read_text()
    else:
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(src)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        # the report lands before the library, so a library that exists
        # has its report
        tmp_report = report.with_suffix(f".{os.getpid()}.tmp")
        tmp_report.write_text(res.stderr)
        os.replace(tmp_report, report)
        os.replace(tmp, so)
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = res.stderr
    build_info[name] = info
    return so


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each exported function to (restype, argtypes);
    pointers and the stream are c_void_p, so ctypes never narrows
    them to 32 bits.  Raises if the build fails."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def build_edited(name: str, edits, out: Path, signatures: dict):
    """(the ctypes handle, the assembler's register lines) of
    ``csrc/<name>.cu`` built with ``NVCC_FLAGS`` into ``out`` from a copy
    of its sources (it and the headers it includes) with ``edits``
    applied: (file name, old text, new text), each of which must find its
    text exactly once.  For experiments that time a kernel's forms side
    by side; the package's own build is ``load``.  ``build_info[str(out)]``
    keeps the library's path, build wall and whole ptxas report."""
    out.mkdir(parents=True, exist_ok=True)
    for src in _sources(CSRC / f"{name}.cu"):
        shutil.copy(src, out / src.name)
    for fname, old, new in edits:
        text = (out / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {fname} once")
        (out / fname).write_text(text.replace(old, new))
    so = out / f"{name}.so"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so),
                          str(out / f"{name}.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {out / name}.cu:\n{res.stderr}")
    build_info[str(out)] = {"so": str(so), "ptxas": res.stderr,
                            "seconds": time.perf_counter() - t0}
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, [line.strip() for line in res.stderr.splitlines()
                 if "registers" in line]
