"""Build the CUDA sources in ``ops/csrc/`` into one shared library and load it
with ctypes.

``nvcc`` compiles the ``*.cu`` files into a ``.so`` with a plain ``extern "C"``
interface (no PyTorch headers, so a build takes seconds, not minutes). The
library goes into ``gaussianprocessnode_tpu_torch/_build/``, named by a hash
of the sources and flags, at first use. It is written under a temporary name
and renamed into place, so concurrent builds never see a half-written file
and no lock file exists to wait on.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import tracing

__all__ = ["NVCC_FLAGS", "load_library", "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_log = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet. ``build_log()`` then says how it was obtained."""
    global _lib
    if _lib is not None:
        return _lib
    with tracing.span("ops.load_library"):
        sources = _sources()
        so = _BUILD_DIR / f"gpn_kernels-{_digest(sources)}.so"
        log = so.with_suffix(".log")
        t0 = time.perf_counter()
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            log_tmp = log.with_name(f".{log.name}.{os.getpid()}.tmp")
            log_tmp.write_text(proc.stdout + proc.stderr)
            os.replace(log_tmp, log)
            os.replace(tmp, so)
            _log["built"] = True
        else:
            _log["built"] = False
        _log["seconds"] = time.perf_counter() - t0
        _log["path"] = str(so)
        _log["ptxas"] = log.read_text() if log.exists() else ""
        _lib = ctypes.CDLL(str(so))
        tracing.attrs(built=_log["built"])
    return _lib


def build_log() -> dict:
    """``{"built", "seconds", "path", "ptxas"}`` of the last ``load_library``:
    whether this process compiled the library, how long loading took, where
    it lives, and nvcc's ``-Xptxas -v`` report (registers, shared memory,
    spills) from the build that made it."""
    return dict(_log)
