#!/usr/bin/env python3
"""Time SE Gram kernel sources against each other on one card, in turns.

Run from the root of the repository on a machine with one NVIDIA card:

    python3 scripts/se_gram_ab.py [--other NAME=PATH ...] [--variants NAME,...] [--json OUT]

It builds ``gaussianprocessnode_tpu_torch/ops/csrc/se_gram.cu`` (named
``current``) and each ``--other`` source, a kernel file with the same C entry
point ``se_gram_f32`` (an earlier version, for example:
``git show 6f40e7f:gaussianprocessnode_tpu_torch/ops/csrc/se_gram.cu``), each
with nvcc into its own library. For each source named in ``--variants``
whose epilogue it recognises it also builds a store-only variant (the exp
and σ² product replaced by d², the same stores) and a compute-only variant
(all the arithmetic, the stores kept behind a condition that never holds).

At the Gram shapes the port runs (600×30000×8 serving, 600×10000×8 and
600×600×8 training) it holds each full kernel against the plain version,
then times every build and ``fill_`` of an output of the same size by device
time (``cuda_graph_time_ms``, 200 launches), in turns: forward, then
backward. It prints one line per build and shape with both readings, the
share of the bound and of ``fill_``, and the card's name and power limit.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gaussianprocessnode_tpu_torch.ops import _build  # noqa: E402
from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_reference  # noqa: E402
from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms  # noqa: E402

SOURCE = ROOT / "gaussianprocessnode_tpu_torch" / "ops" / "csrc" / "se_gram.cu"
BUILD = ROOT / "gaussianprocessnode_tpu_torch" / "_build" / "ab"
SHAPES = ((600, 30000, 8), (600, 10000, 8), (600, 600, 8))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# Epilogues this tool knows: (the statement that computes an output, its
# store-only form, the statement that stores it, its never-taken form).
# The first version of the kernel computes and stores in one statement.
EPILOGUES = (
    ("out[n] = s2 * expf(-0.5f * fmaxf(d2, 0.f));",
     "out[n] = d2;",
     "out[n] = s2 * expf(-0.5f * fmaxf(d2, 0.f));",
     "{ const float q = s2 * expf(-0.5f * fmaxf(d2, 0.f)); if (q < 0.f) out[n] = q; }"),
    ("v[j] = s2 * ex2_approx(fmaxf(d2, 0.f) * kNegHalfLog2e);",
     "v[j] = d2;",
     "if (n < N)\n            *reinterpret_cast<float4*>(orow + n) =",
     "if (n < N && v[4 * g] < 0.f)\n            *reinterpret_cast<float4*>(orow + n) ="),
)


def variants(name: str, src: str) -> dict:
    """``{name: src}`` and, when the epilogue is one this tool knows (each
    statement once), the store-only and compute-only variants."""
    out = {name: src}
    for value, store_only, store, never in EPILOGUES:
        if src.count(value) == 1 and src.count(store) == 1:
            out[f"{name}:store-only"] = src.replace(value, store_only)
            out[f"{name}:compute-only"] = src.replace(store, never)
            break
    return out


def build_all(sources: dict) -> dict:
    """Build every source with the port's nvcc flags, in parallel; return
    ``{name: (ctypes function, ptxas summary)}``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu, so = BUILD / f"k{i}.cu", BUILD / f"k{i}.so"
        cu.write_text(re.sub(r"\bint se_gram_f32\(", f"int se_gram_f32_k{i}(", src))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (i, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (i, so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        f = getattr(ctypes.CDLL(str(so)), f"se_gram_f32_k{i}")
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        ptxas = " | ".join(line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line)
        built[name] = (f, ptxas)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another kernel source with the entry point se_gram_f32")
    ap.add_argument("--variants", default="", metavar="NAME,...",
                    help="sources to time also as store-only and compute-only variants")
    ap.add_argument("--json", type=Path, help="write the readings here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    named = {"current": SOURCE.read_text()}
    for item in args.other:
        name, _, path = item.partition("=")
        named[name] = Path(path).read_text()
    wanted = set(filter(None, args.variants.split(",")))
    sources = {}
    for name, src in named.items():
        sources.update(variants(name, src) if name in wanted else {name: src})
    built = build_all(sources)
    for name, (_, ptxas) in built.items():
        print(f"build {name}: {ptxas}", flush=True)

    rng = np.random.default_rng(0)
    ls = torch.as_tensor(rng.uniform(0.7, 2.5, 8), dtype=torch.float32).cuda()
    var = torch.tensor(0.176, dtype=torch.float32).cuda()
    Z = torch.as_tensor(rng.standard_normal((600, 8)), dtype=torch.float32).cuda()
    readings = {"card": card, "shapes": {}}
    for M, N, D in SHAPES:
        X = Z if N == M else torch.as_tensor(rng.standard_normal((N, D)),
                                             dtype=torch.float32).cuda()
        stream = torch.cuda.current_stream

        def launch(f):
            K = torch.empty((M, N), dtype=torch.float32, device="cuda")
            rc = f(Z.data_ptr(), X.data_ptr(), ls.data_ptr(), D, var.data_ptr(),
                   K.data_ptr(), M, N, D, stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")
            return K

        K_ref = se_gram_reference(Z, X, var, ls)
        max_abs = {}
        for name, (f, _) in built.items():
            if ":" not in name:  # variants compute something else
                K = launch(f)
                torch.cuda.synchronize()
                max_abs[name] = float((K - K_ref).abs().max())
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        order = ["fill_", *built, *reversed(built), "fill_"]
        times = {}
        for name in order:
            fn = (lambda: out.fill_(1.0)) if name == "fill_" else \
                (lambda f=built[name][0]: launch(f))
            times.setdefault(name, []).append(cuda_graph_time_ms(fn, iters=200, warmup=5))
        bound = 4.0 * (M * D + N * D + D + 1 + M * N) / PEAK_BYTES_PER_S * 1e3
        fill = min(times["fill_"])
        print(f"{M}x{N}x{D}: bound {bound:.5f} ms (bytes) [{card}]", flush=True)
        for name, ts in times.items():
            best = min(ts)
            err = f"  max_abs {max_abs[name]:.3e}" if name in max_abs else ""
            print(f"  {name:28s} {' '.join(f'{t:.5f}' for t in ts)} ms  share of bound "
                  f"{bound / best:.3f}  of fill_ {fill / best:.3f}{err}", flush=True)
        readings["shapes"][f"{M}x{N}x{D}"] = dict(bound_ms=bound, times_ms=times,
                                                  max_abs=max_abs)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(readings, indent=1))
    print(f"nvidia-smi: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
