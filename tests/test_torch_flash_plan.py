"""The integer flash kernel's launch shape and the premise it rests on.

``csrc/flash_attention.cu``'s ``flash_fwd_int`` (the approximate variants
and f32 exact) gives each warp 4 query rows and takes blocks of 8, 4 or 2
warps; ``kernels/flash_attention.py::int_plan`` is the one rule that picks
the block size from the heads and query rows, ``kernel_tiles`` reports the
tiles it implies (daism-lint's TIL004 reads them). Held here at every shape
the main paths time, without a card.

The rule may pick any query tile only because every query row's arithmetic
is independent of the others: the reference's interpreted Pallas kernel
gives the same bits for query tiles of 32, 64 and 128 rows (the key tile
stays 128, part of the approximate function).
"""
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.config import Variant as JVariant  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

jfa = importlib.import_module("repro.kernels.flash_attention")

# (label, (B, Sq, Skv, H, KH, D), warps the rule picks)
TIMED = [
    ("tinyllama", (1, 2048, 2048, 32, 4, 64), 8),
    ("gemma_2b", (1, 2048, 2048, 8, 1, 256), 8),
    ("nemotron_4_340b", (1, 2048, 2048, 96, 8, 192), 8),
    ("whisper encoder self", (1, 1500, 1500, 20, 20, 64), 4),
    ("whisper decoder cross", (1, 448, 1500, 20, 20, 64), 4),
    ("whisper decoder self", (1, 448, 448, 20, 20, 64), 4),
]


def _cost(bh, sq, warps):
    """The rule's measure: an SM's share of the grid, in blocks, times a
    block's cost per KV tile in query rows."""
    rows = tfa.INT_ROWS_PER_WARP * warps
    blocks = bh * math.ceil(sq / rows)
    return math.ceil(blocks / tfa.H100_SMS) * (rows + tfa.INT_TILE_OVERHEAD_ROWS)


@pytest.mark.parametrize("label,shape,warps", TIMED,
                         ids=[t[0] for t in TIMED])
def test_launch_shape_at_timed_shapes(label, shape, warps):
    b, sq, skv, h, kh, d = shape
    got = tfa.int_plan(b * h, sq)
    assert got == warps
    tile = tfa.INT_ROWS_PER_WARP * warps
    # the least cost, the larger block on a tie
    costs = {w: _cost(b * h, sq, w) for w in tfa.INT_WARPS}
    assert costs[got] == min(costs.values())
    assert got == max(w for w, c in costs.items() if c == costs[got])
    # the grid: one block a (query tile, head), every block size 16 warps
    # an SM
    blocks = b * h * math.ceil(sq / tile)
    assert blocks == {"tinyllama": 2048, "gemma_2b": 512,
                      "nemotron_4_340b": 6144, "whisper encoder self": 1880,
                      "whisper decoder cross": 560,
                      "whisper decoder self": 560}[label]
    assert tfa.INT_RESIDENT_WARPS % warps == 0
    for dtype, var in (("bfloat16", Variant.PC3_TR), ("bfloat16", Variant.FLA),
                       ("float32", None)):
        assert tfa.kernel_tiles(d, dtype, var, bh=b * h, sq=sq) == (
            tile, tfa.KERNEL_BLOCK_K, d)
    # bf16 exact keeps the tensor-core kernel's tiles
    assert tfa.kernel_tiles(d, "bfloat16", bh=b * h, sq=sq)[0] == \
        tfa.KERNEL_BLOCK_Q


def test_short_grids_take_smaller_tiles():
    # few heads and rows: the smallest tile fills the 132 SMs best
    assert tfa.int_plan(1, 8) == 2
    assert tfa.kernel_tiles(64, "bfloat16", Variant.PC3_TR) == (8, 128, 64)
    # a long grid takes the largest
    assert tfa.int_plan(64, 4096) == 8


@pytest.mark.parametrize("d,dp", [(1, 16), (16, 16), (17, 32), (40, 64),
                                  (64, 64), (96, 128), (128, 128),
                                  (160, 192), (192, 192), (200, 256),
                                  (256, 256)])
def test_integer_kernel_head_dims(d, dp):
    assert tfa.int_head_dim(d) == dp
    assert tfa.kernel_tiles(d, "bfloat16", Variant.PC3_TR, bh=32,
                            sq=2048)[2] == dp


def test_forced_block_size_is_checked():
    # the measurement knob takes only the kernel's block sizes
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="warps 3"):
        tfa._launch_kernel(q, q, q, b=1, h=2, kh=2, sq=8, skv=8, d=16,
                           kv_len=8, causal=True, variant=Variant.PC3_TR,
                           q_st=(0, 0, 0), k_st=(0, 0, 0), v_st=(0, 0, 0),
                           out=q, o_st=(0, 0, 0), warps=3)


@pytest.mark.parametrize("variant", ["pc3_tr", "fla"])
@pytest.mark.parametrize("causal", [True, False])
def test_query_tile_is_free_in_the_reference(variant, causal):
    """The reference's Pallas kernel, interpreted as its own suite runs it,
    gives the same bits for query tiles of 32, 64 and 128 rows over two
    128-key tiles: a query row's arithmetic does not depend on its tile."""
    rng = np.random.default_rng(23)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 256, 64)), jnp.bfloat16)
               for _ in range(3))
    outs = [np.asarray(jfa.flash_attention(
        q, k, v, causal=causal, variant=JVariant(variant), block_q=bq,
        block_k=128, interpret=True)).view(np.int16) for bq in (32, 64, 128)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
