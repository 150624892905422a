"""Build the CUDA sources in ``ops/csrc/`` into one shared library, load it
with ctypes, launch its kernels, and hold a call as a CUDA graph.

``nvcc`` compiles the ``*.cu`` files into a ``.so`` with a plain ``extern "C"``
interface (no PyTorch headers, so a build takes seconds, not minutes). The
library goes into ``gaussianprocessnode_tpu_torch/_build/``, named by a hash
of the sources and flags, at first use. It is written under a temporary name
and renamed into place, so concurrent builds never see a half-written file
and no lock file exists to wait on.

A kernel's wrapper (``se_gram_cuda``, ``svgp_var_cuda``) launches through
an :class:`EntryPoint`, which counts in the wrapper's ``launches`` the
launches the device ran: one per eager launch, none for a
:class:`CallGraph` capture, and per replay what the capture queued.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils import tracing

__all__ = ["NVCC_FLAGS", "load_library", "build_log", "EntryPoint", "CallGraph"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_log = {}
_counted = {}  # name → each wrapper whose launches an EntryPoint counts


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


class EntryPoint:
    """The library's ``{name}_f32`` launched for ``wrapper``, whose
    ``launches`` it counts from 0. Bound at its first launch (``argtypes``,
    then the stream), once ``{name}_{limit[0]}()`` has returned
    ``limit[1]``, the wrapper's limit."""

    def __init__(self, name, argtypes, wrapper, limit):
        self.name, self.argtypes, self.wrapper, self.limit = name, argtypes, wrapper, limit
        self.fn = self.error = None
        wrapper.launches = 0
        _counted[wrapper.__name__] = wrapper

    def _bind(self):
        lib = load_library()
        fn = getattr(lib, f"{self.name}_f32")
        fn.argtypes, fn.restype = [*self.argtypes, ctypes.c_void_p], ctypes.c_int
        error = getattr(lib, f"{self.name}_error_string")
        error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
        symbol, value = self.limit
        cap = getattr(lib, f"{self.name}_{symbol}")
        cap.argtypes, cap.restype = [], ctypes.c_int
        if cap() != value:
            raise RuntimeError(f"{self.name}.cu's {symbol} {cap()} and the wrapper's {value} "
                               "disagree")
        self.fn, self.error = fn, error

    def __call__(self, device, *args):
        """One launch on ``device``'s current stream with ``args``."""
        if self.fn is None:
            self._bind()
        # the library launches on the calling thread's current device: make it
        # the tensors' (entering the context only when needed keeps the
        # per-launch host cost down)
        with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
              else torch.cuda.device(device)):
            rc = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.wrapper.__name__}: launch failed ({rc}): "
                               f"{self.error(rc).decode()}")
        self.wrapper.launches += 1


class CallGraph:
    """``call(x)`` held as one CUDA graph, x a private copy of ``X``,
    captured on a side stream as ``torch.cuda.graph`` does, without its
    device synchronisation, garbage collection and cache release; with
    ``warmup``, after one eager ``call`` there (which creates the
    libraries' handles and workspaces). A call copies its input into x,
    replays, and returns clones of the outputs, which share memory with
    nothing else. ``launches``: {wrapper name: launches} the capture
    queued, which each replay adds to the wrappers' counts."""

    def __init__(self, call, X, warmup=False):
        self.x = X.clone(memory_format=torch.contiguous_format)
        with self._side_stream(X.device):
            if warmup:
                call(self.x)
            before = {name: w.launches for name, w in _counted.items()}
            try:
                self.out = self._capture(call)
            finally:
                queued = {name: _counted[name].launches - n for name, n in before.items()}
                for name, n in before.items():
                    _counted[name].launches = n
        self.launches = {name: n for name, n in queued.items() if n}

    @staticmethod
    @contextlib.contextmanager
    def _side_stream(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            yield
        torch.cuda.current_stream(device).wait_stream(side)

    def _capture(self, call):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin()
        try:
            return call(self.x)
        finally:
            self.graph.capture_end()

    def __call__(self, X):
        self.x.copy_(X)
        self.graph.replay()
        for name, n in self.launches.items():
            _counted[name].launches += n
        if isinstance(self.out, tuple):
            return tuple(o.clone() for o in self.out)
        return self.out.clone()
