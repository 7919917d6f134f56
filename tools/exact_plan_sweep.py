#!/usr/bin/env python3
"""Sweep B1 EXACT's launch configurations on the card: the evidence for
``kernels/daism_matmul.py::_plan``'s EXACT rule.

    PYTHONPATH=src python3 tools/exact_plan_sweep.py     # one H100

At every GEMM shape of TinyLlama-1.1B's main paths (``chip_smoke.py``'s
decode, prefill-chunk, prefill and train shapes) it times the TMA kernel
(``csrc/exact_gemm.cuh``) for both tile sizes (64 x 128 and 128 x 256) and
K slice counts 1 to 32, by CUDA-graph replay over input copies that
exceed the L2 (``chip_smoke.cuda_graph_ms``), holds every output against
the plain version, and prints each configuration's time beside the one
``_plan`` picks, the fastest, and ``torch.mm(a, w, out_dtype=f32)``.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402

SLICES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def launch(a, w, rows, slices):
    """The EXACT kernel on its TMA loads with ``rows``-row tiles and
    ``slices`` K slices (the C entry point, bypassing ``_plan``)."""
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = (torch.empty((slices, m, n), dtype=torch.float32, device=a.device)
          if slices > 1 else None)
    fn = dm._launch_c or dm._bind()
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, m, k, n,
             dm.VARIANT_IDS[Variant.EXACT], rows, slices,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("exact_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = [(m, k, n) for k, n in cs.KN_SHAPES for m in cs.M_SHAPES]
    shapes += cs.PREFILL_GEMM_SHAPES + cs.TRAIN_GEMM_SHAPES
    ratios = []
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        ref = dm.daism_matmul_plain(a, w, Variant.EXACT)
        copies = cs.cold_copies(a, w)
        lib, _ = cs.cuda_graph_ms(cs.mm_f32_out, copies)
        stages = -(-k // dm.EXACT_BK)
        times = {}
        for rows in (64, 128):
            for s in SLICES:
                s = -(-stages // -(-stages // min(s, stages)))
                if (rows, s) in times:
                    continue
                times[(rows, s)], out = cs.cuda_graph_ms(
                    lambda x, y: launch(x, y, rows, s), copies)
                cs.gemm_held(out, ref, a, w, f"({m},{k},{n}) {rows}/{s}")
        best = min(times, key=times.get)
        _, rows, s = dm._plan(m, k, n, Variant.EXACT)
        ratios.append(times[(rows, s)] / times[best])
        print(f"({m},{k},{n}) plan {rows}/{s} {times[(rows, s)]:.4f} ms  "
              f"best {best[0]}/{best[1]} {times[best]:.4f} ms "
              f"({ratios[-1]:.2f}x)  torch.mm {lib:.4f} ms  all: "
              + " ".join(f"{r}/{c} {t:.4f}" for (r, c), t in times.items()),
              flush=True)
        del a, w, ref, copies
    print(f"plan / best: max {max(ratios):.2f}x; within 1.07x at "
          f"{sum(r <= 1.07 for r in ratios)} of {len(ratios)} shapes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
