"""The plain reference: its frozen DAISM product bit for bit against the
program's plain one, its GEMM against the program's oracle, and the
checks that decide ``correct`` against the control and planted faults."""
import pytest

import tiny
import torch
from perfbench.reference import daism

VARIANTS = list(daism.VARIANTS)


def bf16_pairs(n, seed):
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(-32768, 32768, (2, n), generator=g,
                         dtype=torch.int32).to(torch.int16)
    x, w = bits.view(torch.bfloat16)
    ok = torch.isfinite(x.float()) & torch.isfinite(w.float())
    return x[ok], w[ok]


@pytest.mark.parametrize("variant", VARIANTS)
def test_frozen_product_is_the_programs_bit_for_bit(variant):
    from repro_torch.core.config import Variant
    from repro_torch.core.floatmul import approx_mul_to_f32

    x, w = bf16_pairs(100_000, 7)
    got = daism.approx_mul_to_f32(x, w, variant)
    want = approx_mul_to_f32(x, w, Variant(variant))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [5, 90])  # both sides of the split
def test_frozen_gemm_matches_the_oracle(variant, m):
    from repro_torch.core.config import Variant
    from repro_torch.kernels.ref import daism_matmul_ref

    g = torch.Generator().manual_seed(m)
    a = torch.randn(m, 70, generator=g).bfloat16()
    w = torch.randn(70, 33, generator=g).bfloat16()
    want = daism_matmul_ref(a, w, Variant(variant))
    got = daism.matmul(a, w, variant)
    scale = (a.float().abs() @ w.float().abs())
    assert ((got - want).abs() <= 1e-6 * scale + 1e-30).all()


def test_lower_precision_is_float8():
    x = torch.linspace(-3, 3, 101).bfloat16()
    low = daism.to_lower(x)
    assert not torch.equal(low, x)
    assert ((low.float() - x.float()).abs() <= 2 ** -4 * 3 + 1e-6).all()


CELLS = ["sc2-score", "sc2-serve", "whisper-decode", "sc2-train"]
FAULTS = [("sc2-score", "alter_answer"), ("sc2-serve", "alter_token"),
          ("whisper-decode", "alter_answer"), ("sc2-train", "unchanged"),
          ("sc2-train", "half_batch")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_program_passes_and_a_planted_fault_fails(name, fault):
    """At tiny widths on the CPU the run is correct, and with a fault
    planted in the timed path (an answer or a token altered where it is
    produced; a train step that leaves its state unchanged, or that takes
    its mean over half the batch) ``correct`` comes out false."""
    ok = tiny.run(tiny.cell(name, seed=11))
    assert ok["checks"].correct, ok["checks"].record()
    bad = tiny.run(tiny.cell(name, seed=11), fault=fault)
    assert not bad["checks"].correct, bad["checks"].record()


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_above_the_program(name):
    """The control (the reference in float8 in the program's place) reads
    at least three times what the program does on every number it can
    move, at tiny widths on the CPU."""
    prog = tiny.run(tiny.cell(name, seed=12))["checks"].values
    ctrl = tiny.run(tiny.cell(name, seed=12), control=True)["checks"].values
    assert any(ctrl[k] >= 3 * max(prog[k], 1e-6) for k in prog), (prog, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    """On the card, at the cell's own size, the control fails ``correct``
    on three seeds (``calibrate.py``'s readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the program's kernels have no CPU "
                    "mode at these sizes)")
    from perfbench import calibrate

    for rec in calibrate.readings(name, [301, 302, 303], seconds=2.0,
                                  control=True):
        assert not rec["correct"], rec
