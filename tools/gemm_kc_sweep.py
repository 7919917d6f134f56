#!/usr/bin/env python3
"""Time the DAISM GEMM kernel at several K chunks (Kc) on one CUDA card.

    PYTHONPATH=src python3 tools/gemm_kc_sweep.py [--kc 64 128 256]

Kc, the K chunk of the kernel's summation order, is part of the GEMM's
function (it fixes every output's f32 bits) and of its speed: it sets the
split-K path's grid (one block a chunk), its workspace (chunks x M x N
floats) and its second pass, and how often the tile path folds a chunk into
its total. This script builds ``csrc/daism_matmul.cu`` once for each Kc
(``-DDAISM_KC``, all builds started together), then times the tile path and
the split-K path (CUDA events, PC3_TR, the plan ``kernels/daism_matmul.py``
picks for that Kc) at every decode shape of TinyLlama-1.1B (M = 1 and 4),
M = 16 to 128 and one M = 2048 prefill shape. Within each Kc the two paths
must agree bit for bit, and the build at the package's own Kc must equal
``daism_matmul_kernel``. Prints one row per (shape, Kc), the ``free``-tier
decode step's GEMM total per Kc, the card's name and power limit, and a
JSON object of every time as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

KN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000)]
SHAPES = ([(m, k, n) for m in (1, 4) for k, n in KN_SHAPES]
          + [(16, 2048, 5632), (64, 2048, 5632), (128, 2048, 5632),
             (128, 5632, 2048), (128, 2048, 256), (2048, 2048, 5632)])
# launches of each (K, N) site in one free-tier decode step (22 layers)
FREE_STEP = {(2048, 2048): 44, (2048, 256): 44, (2048, 5632): 44,
             (5632, 2048): 22, (2048, 32000): 1}


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bind(kc: int):
    """Build the kernel library with chunk ``kc`` and bind its entry."""
    from repro_torch.kernels.build import compile_library

    lib = ctypes.CDLL(str(compile_library(
        "daism_matmul", defines=(f"-DDAISM_KC={kc}",))))
    if lib.daism_matmul_chunk() != kc:
        raise SystemExit(f"the -DDAISM_KC={kc} build reports chunk "
                         f"{lib.daism_matmul_chunk()}")
    fn = lib.daism_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, kc: int, a, w, path: str):
    """One PC3_TR GEMM through the library ``fn`` (chunk ``kc``) on
    ``path``, allocating what the package's wrapper would."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    m, k = a.shape
    n = w.shape[1]
    plan = dm._plan(m, k, n, Variant.PC3_TR, path, kc=kc)
    chunks = -(-k // kc)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = (torch.empty((chunks, m, n), dtype=torch.float32, device=a.device)
          if plan is not None and chunks > 1 else None)
    rows, cols = plan or (0, 0)
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, m, k, n,
             dm.VARIANT_IDS[Variant.PC3_TR], rows, cols,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kc", type=int, nargs="+", default=[64, 128, 256],
                   help="K chunks to time (multiples of 16)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gemm_kc_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with ThreadPoolExecutor(len(args.kc)) as pool:
        fns = dict(zip(args.kc, pool.map(bind, args.kc)))
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        default = "tile" if dm._plan(m, k, n, Variant.PC3_TR) is None \
            else "splitk"
        for kc, fn in fns.items():
            tile, split = (launch(fn, kc, a, w, path)
                           for path in ("tile", "splitk"))
            if not torch.equal(tile.view(torch.int32),
                               split.view(torch.int32)):
                raise SystemExit(f"Kc {kc} ({m},{k},{n}): paths differ")
            if kc == dm.KC and not torch.equal(
                    tile.view(torch.int32),
                    dm.daism_matmul_kernel(a, w, Variant.PC3_TR).view(
                        torch.int32)):
                raise SystemExit(f"Kc {kc} ({m},{k},{n}): the build differs "
                                 "from daism_matmul_kernel")
            del tile, split
            reps = 3 if m >= 2048 else 10
            row = {path: cuda_ms(lambda: launch(fn, kc, a, w, path), reps)
                   for path in ("tile", "splitk")}
            plan = dm._plan(m, k, n, Variant.PC3_TR, "splitk", kc=kc)
            times[f"{m},{k},{n},{kc}"] = row
            print(f"M={m:5d} K={k:5d} N={n:6d} Kc={kc:4d}  tile "
                  f"{row['tile']:9.4f} ms  split-K {row['splitk']:9.4f} ms "
                  f"(rows, cols {plan})  default {default} "
                  f"{row[default]:9.4f} ms", flush=True)
        del a, w
        torch.cuda.empty_cache()
    for kc in fns:
        for m in (1, 4):
            total = 0.0
            for (k, n), count in FREE_STEP.items():
                path = "tile" if dm._plan(m, k, n, Variant.PC3_TR) is None \
                    else "splitk"
                total += count * times[f"{m},{k},{n},{kc}"][path]
            print(f"free decode step GEMM total, M={m}, Kc={kc}: "
                  f"{total:.3f} ms")
    print(smi.strip())
    print(json.dumps({"device": smi.strip(), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
