"""Build-at-first-use for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C entry point.  It is compiled
with nvcc for Hopper (sm_90a) into a shared library keyed by a hash of
its source and flags, the way tpubwa/native builds its C++, and loaded
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


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode()
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
