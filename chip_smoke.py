#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA H100

Builds the CUDA kernels from the sources in ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the port's main
paths at TinyLlama-1.1B's published width (random bf16 weights from a seed)
then the rest of the decoder-only zoo (phase 12) and Whisper, xLSTM and
Zamba (phase 13):
the paged server through two policy tiers, the full-sequence
``prefill_step`` with and without the flash-attention kernel, the
``train_step`` with straight-through and approximate backward, slot-cache
generation, the training launcher with a checkpoint, a preemption and a
resume, and the paper's CNNs (VGG-16, LeNet-5) through the im2col GEMM,
and prints the kernels' times beside their bounds. Phases:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc of every kernel source, all started together, timed,
              with the -Xptxas -v lines; where cuobjdump exists, the HGMMA
              (wgmma), HMMA and UTMALDG (TMA) instructions of the EXACT
              kernels' SASS, which must hold HGMMA;
3. kernels  — daism_matmul: (a) K = 1 outer products over every pair of
              normalized bf16 mantissas with mixed signs and exponents
              (underflow and overflow included): bit-identical to the plain
              version for the six approximate variants, EXACT within
              2**-126 on every path (zero-padded to K = 8 for the TMA
              paths; subnormal inputs must survive the tensor cores); (b)
              the serving path's GEMM shapes (M = 1 to 128) and ragged
              edges past one M tile, for all seven variants within
              gemm_rtol(K) * (|a| @ |w|) + 1e-6, EXACT forced onto each of
              its paths (tile, split-K, edge), its largest error over
              |a| @ |w| printed by path; (c) an f32 operand raises
              ValueError. flash_attention: (d) exact and the six approximate
              variants, D in {16, 32, 64, 128}, causal and not, GQA (H=32,
              KH=4), MHA and MQA, a ragged (B=2, Sq=100, Skv=72, H=4, KH=2)
              and f32 exact inputs, against the plain version (same KV tiles
              in the same order): exact within 2e-3 + 2e-2 |plain| (the JAX
              suite's) and, for bf16, also within one bf16 rounding
              (2**-7 |plain| + 2**-16 max|v|, FLASH_EXACT_ULP),
              approximate within 2**-6 |plain| + 1e-3 (see
              FLASH_APPROX_TOL); bf16 exact runs the tensor-core kernel,
              D = 40 covers its zero-padded head dim; (e) causally masked
              KV tiles are skipped (poisoned keys past them change nothing);
              (f) one KV tile against the reference's semantics oracle
              (DAISM products of kernels/ref.py and a plain softmax), 2e-2
              (the JAX suite's). daism_matmul again: (g) bit-identical to
              daism_matmul_ordered (the kernel's own summation order) for
              the six approximate variants on the tile path, the split-K
              path and the default choice, at every decode shape (M in
              {1, 4} x KN_SHAPES), M = 16 and 64 at (2048, 5632), the ragged
              shapes and (128, 2048, 5632); (h) rows 0-3 of an M = 128
              launch equal an M = 4 launch on the same rows, bit for bit;
4. serve    — the engine serves 8 requests through the ``free`` and
              ``paid`` tiers; every request completes at its length, both
              groups run, the prefix cache hits, the kernel's launch count
              equals the count the steps imply, and a small input's logits
              through the kernel agree with the plain (jnp-backend) path;
5. prefill  — ``prefill_step`` at 22 layers, B=1, S=2048 under three
              policies (approximate flash, exact flash, jnp attention, all
              with approximate GEMMs on the kernel) and an exact-GEMM pair
              (timed twice: its first forward is the library GEMMs' first
              use); flash launches 22 and the GEMM kernel its sites per
              forward;
              exact flash agrees with jnp attention (bounds printed);
6. train    — ``train_step`` at 22 layers, B=2, S=256: 3 steps with the
              straight-through backward, 1 with the approximate backward on
              the kernel; finite loss and grad norm, the kernel's launches
              per step as the sites imply; a ``:flash`` policy raises;
7. numbers  — kernel / plain / library times (CUDA events) and the bound
              at each shape, both GEMM paths timed at M = 1 to 128 (the
              split-K threshold's evidence) with the decode step's GEMM
              total, the serve report, prefill and step times. EXACT is
              timed on every path by CUDA graph replay over input copies
              that exceed the L2 (device time; the wrapper's host cost is
              printed apart), beside torch.mm(a, w,
              out_dtype=torch.float32), the library call that computes the
              same function on the tensor cores, and the f32-upcast
              torch.matmul, the earlier yardstick. The
              outputs of the timed calls are held against each other at the
              main paths' own shapes: daism_matmul at the prefill GEMMs
              (M = 2048) and every train-step GEMM (forward and approximate
              backward, K up to 32000) within the (b) bound; flash at
              TinyLlama's heads, S = 2048, for all seven variants within the
              (d) bounds, with controls that must break them: the exact and
              FLA kernels against the PC3_TR plain break the approximate
              bound, and exact attention with one bf16 p (no p_lo) breaks
              the one-ulp bound. The CNNs' im2col GEMMs (IM2COL_SHAPES:
              VGG-16 at B = 32, K = 27 to 4608, N = 10 to 512; LeNet-5 at
              B = 64, K = 25 to 784, N = 6 to 120) are timed and held the
              same way;
8. generate — slot caches at full width and depth: ``prefill`` of 4
              prompts of 32 tokens and 16 greedy ``decode_step``s on a
              scalar-``pos`` cache of 64, then a per-slot run (``(B,)``
              ``pos``, prompt lengths 32/20/26/12); the kernel launches
              its 155 sites x 17 calls in each; every decode step's
              logits against a full-sequence forward over the same tokens
              (PREFILL_APPROX_REL; greedy tokens agree on every row whose
              top-2 gap exceeds the deviation); ms per decode step;
9. train driver — ``repro_torch.launch.train.main`` at full width and 2
              layers (B = 2, S = 256, 6 steps, a checkpoint every 3 into
              ``build/``, removed afterwards): its loss lines, 6 x 15
              kernel launches; then ``fault_tolerance.run`` preempted
              (SimulatedPreemption) before step 5 and run again from a
              fresh init: it resumes at step 3 with params and optimizer
              state equal, bit for bit, to an in-memory copy of the step-3
              state, and reaches step 6 with a finite loss; checkpoint
              bytes and save / restore times;
10. cnn     — VGG-16 at its published widths (B = 32, 32x32x3) and LeNet-5
              (B = 64) in bf16 under PC3_TR: a forward through the kernel
              (15 and 5 launches) against the jnp backend's forward on the
              card (tests/test_torch_cnn.py's bound; labels agree where
              the top-2 gap exceeds the deviation), 3 straight-through and
              1 approximate-backward train steps with finite loss and the
              launches the sites imply; ms per forward and per step.
11. serve+  — the engine with preemption against reservation (tokens
              equal), speculation against plain decode (tokens by the
              top-2-gap rule), both together, and the energy report.
12. zoo     — the decoder-only zoo at published widths, random bf16
              weights, the card freed between models, peak memory
              printed: (a) Qwen3-MoE (2 of 94 layers) served by the paged
              engine (4 requests of ~32 prompt tokens, 16 generated each;
              decode tok/s, TTFT and step p50), every emitted token equal
              to a slot-cache decode_step replay wherever that replay's
              top-2 gap exceeds the paged-vs-slot deviation, and the
              router's rows against an M = 2048 call (the library GEMM's
              and router_logits', which must not move); (b) DBRX (2 of 40)
              forward, S = 256; (c) the expert GEMM at Qwen3-MoE's and
              DBRX's shapes, C = 4 and 128, w_in and w_out: one launch for
              all experts bit for bit against per-expert launches, experts
              0 and E-1 against daism_matmul_ordered and within gemm_rtol
              of the plain version, timed against the operations bound;
              (d) Gemma-2B (18 layers, D = 256, MQA, tied embeddings)
              forward at S = 512 under phase 5's policies, held against
              each other as there, and a short paged serve, with what one
              copy of the tied lm_head's transpose would cost a step; (e)
              StarCoder2-15B (40 layers) and Nemotron-4-340B (2 of 96)
              forwards, S = 128, attention on the PC3_TR flash kernel
              (D = 128 and 192); (f) Llama-3.2-Vision (5 of 40 layers, one
              cross block, 1601 image tokens) forward at S = 256 and 8
              decode_steps with the image embeddings against it (phase
              8's rule); (g) flash at D = 192 and 256: all seven variants,
              causal and not, ragged, within the phase-3 bounds, the
              controls breaking them at both dims, and timings at Gemma's
              and Nemotron's heads (S = 2048) beside the bound and SDPA,
              with the large-D kernels' ptxas registers and spills.
              Every model's GEMM launches equal its sites, flash's its
              layers.
13. zoo rest — Whisper-large-v3, xLSTM-1.3B and Zamba2-1.2B at published
              widths and full depth, random bf16 weights: (a) Whisper (B =
              1, 1500 seeded frames, S = 448) forward under phase 5's
              policies with flash on every attention site (96 launches:
              encoder self, decoder self and cross), exact flash against
              jnp attention as there, encode + 8 decode_steps against the
              forward, flash alone at (1500, 1500) and (448, 1500)
              non-causal against the plain version with the controls,
              beside the bound and SDPA; the GEMM kernel at every new
              shape of the three models (Whisper's M = 1500 and S = 448
              with the ragged N = 51866 head, xLSTM's N = 12, Zamba's
              Mamba and shared-block GEMMs) against the plain version; (b)
              xLSTM (42 mLSTM + 6 sLSTM) and (c) Zamba (38 Mamba-2 blocks,
              6 shared sites) forwards at S = 128 with PC3_TR and exact
              GEMMs, 16 decode_steps from an empty cache against the
              forward (241 and 195 GEMM launches a step), Zamba's ring
              cache (window 8) card vs CPU; (d) each model cut in depth,
              on the card (kernels) against the CPU (plain versions), f32
              exact and bf16 PC3_TR over 16 tokens, each with a greedy
              token clear of the deviation; PC3_TR's bound is below the
              deviation of the card's exact products, which must break it.
              GEMM launches equal the sites of every forward and step.
14. lint    — daism-lint and the launchers' preflight: (a) ``python -m
              repro_torch.launch.lint --all --device cuda`` in a process of
              its own exits 0 with no error and no TIL003 finding over the
              13 ids (wall time, and each id's error/warning/info counts);
              (b) the GEMM's shared memory a block as the checker counts it
              (kernels/daism_matmul.py::smem_bytes) equals the compiled
              tile kernel's (ptxas's ``bytes smem`` from phase 2, and the
              CUDA attribute) and, for every split-K plan, the bytes the
              launcher requests (the library's daism_matmul_smem); (c)
              ``launch.serve.main`` at TinyLlama's full width with a rule
              that matches nothing (POL001), a pool smaller than one
              request (SRV002), ``--shards 4`` over 2 decode rows (SRV007)
              and ``--shards 2`` on one card (more shards than cards), and
              ``launch.train.main`` with the first, each raise SystemExit
              naming the code, with no new CUDA byte and no kernel launch;
              (d) a clean serve (PC3_TR on the kernel, 4 requests, full
              depth) and train (2 layers, 2 steps) run through the
              preflight, whose own wall time is printed beside the
              launcher's; TIL003 fires for a cpu target and not the card.
15. mesh    — multi-device serving's code at world size 1: (a) a 1-rank
              NCCL process group on cuda:0 (launch/mesh.py) and a 1-way
              ``model`` mesh; (b) TinyLlama as in phase 4 (22 layers, 8
              requests, both tiers) through ``ServeEngine(..., mesh=)``:
              tokens equal phase 4's, GEMM launches equal, the NCCL
              collectives the sharded layers issue counted, tok/s and TTFT
              beside phase 4's; (c) Qwen3-MoE (2 of 94 layers) served
              under the mesh, so its MoE layers take the expert-parallel
              path: the capacity of each step kind, the expert kernel at
              (128, C, 4096, 1536) and (128, C, 1536, 4096) against its
              plain version and timed beside its bound, a forward whose
              capacity drops nothing against the dense path (phase 5's
              PREFILL_APPROX_REL), TTFT, tok/s and step p50 beside phase
              12 (a)'s dense serve; (d) the GEMMs one rank of a 4-way
              tensor-parallel TinyLlama runs (MESH_GEMMS, M = 4 and 128)
              against the plain version, timed beside the bound; (e)
              ``compressed_psum`` in each mode and a one-stage
              ``pipeline_apply`` on CUDA tensors over the NCCL group:
              int8 and none equal the CPU's bit for bit, bf16 within one
              bf16 rounding, the pipeline equal to the sequential loop.
              The process group is destroyed at the end.
16. train mesh — multi-device training's code at world size 1: a new
              1-rank NCCL group and a 1x1 ``data`` x ``model`` mesh; (a)
              TinyLlama at 22 layers, phase 6's four steps (3 STE, 1
              approximate backward, B = 2, S = 256) through
              ``build_artifacts(cfg, mesh)`` against the same steps without
              a mesh on the same weights and batches: losses, grad norms
              and every parameter bit for bit (any gap fails), ms a step
              beside phase 6's, the collectives a step, peak memory; (b)
              Qwen3-MoE, 1 of 94 layers at published width, one train
              step through EP (the train state reckoned first: past 75 GB
              it times forward and backward alone) with the approximate
              backward, beside the dense MoE's step from the same freshly
              drawn initial state; the no-drop EP loss against the dense
              loss (PREFILL_APPROX_REL on the logits); the expert kernel
              at the step's forward, dx and dw shapes (K = C for dw)
              against the plain version, timed beside its bound; (c) a
              one-stage ``pipeline_apply``'s gradient on CUDA tensors
              against sequential autograd over the same microbatches, bit
              for bit;
              (d) ``checkpoint.save`` under the mesh and ``restore(...,
              shardings=)`` of (a)'s tree, bit for bit, timed; then
              ``python -m repro_torch.launch.train --devices 1 --mesh
              1x1 --layers 2`` on the card, run again to resume.

17. roofline — (a) phase 6's STE train step at 22 layers, B = 2,
              S = 256, under remat none / dots / dots_nb / full, 2 steps
              each: losses, grad norms and every parameter bit for bit
              across the modes; ms, peak memory and GEMM launches a mode
              (the kernel is recomputed under every mode but none: each
              layer's 7 GEMMs, not the lm_head); (b)
              TinyLlama's prefill (B = 1, S = 2048) and train step (B = 2,
              S = 256) under *=exact: the dry-run's record on a 1x1 mesh
              (terms, bottleneck, memory estimate) beside the step's
              measured ms and allocator peak; (c) xLSTM-1.3B (8 layers)
              and Zamba2-1.2B (7 layers) at published width over a 1x1
              mesh at world size 1 (NCCL): a forward and 2 STE train
              steps bit for bit the same steps without a mesh; (d) one
              dry-run cell a family on the single-pod mesh (16 x 16, on
              meta): tinyllama_1_1b train_4k, qwen3_moe_235b decode_32k,
              xlstm_1_3b long_500k, zamba2_1_2b prefill_32k, each ok.

Every check raises on failure and nothing is caught (checks 3c, 6, 9 and
14c expect their errors), so any failure exits non-zero before the final
line. TF32 is
off for every f32 matmul here.
The last two lines are the JSON kernel record and the result line.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, as tabulated in the repo's measurement
# notes): HBM 3.35 TB/s; bf16 tensor cores 989 TFLOP/s (the least time an
# exact bf16 GEMM could take). The INT32 rate is derived from the same
# sheet's FP32 rate (67 TFLOP/s = 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz):
# each SM has 64 INT32 lanes, so 132 x 64 x 1.98e9 integer ops/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Integer operations per approximate MAC, counted from the chain in
# src/repro_torch/csrc/approx_product.cuh with operand-only terms hoisted:
# the line selects (one AND/OR each: 8 for FLA and HLA, 6 for PC2, 5 for
# PC3), HLA's add, the head line's multiply (PC2/PC3), the truncation mask
# (_TR), and 13 for normalization, exponent add, sign and f32 composition.
OPS_PER_MAC = {"fla": 8 + 13, "hla": 8 + 1 + 13, "pc2": 1 + 6 + 13,
               "pc3": 1 + 5 + 13, "pc2_tr": 1 + 6 + 1 + 13,
               "pc3_tr": 1 + 5 + 1 + 13}

KN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000)]
# M rows of one GEMM: 1 and 4 at decode (one active request, num_slots=4),
# 128 at a prefill step (num_slots x prefill_chunk = 4 x 32), 64 between
M_SHAPES = [1, 4, 64, 128]
RAGGED_SHAPES = [(5, 70, 33), (130, 300, 130)]
# the train step's GEMMs at B x S = 512 tokens, (M, K, N): the wi/wg
# forward, its two approximate-backward GEMMs (da = g @ w^T, dw = a^T @ g),
# and the lm_head's
TRAIN_GEMM_SHAPES = [(512, 2048, 5632), (512, 5632, 2048), (2048, 512, 5632),
                     (512, 2048, 32000), (512, 32000, 2048),
                     (2048, 512, 32000)]
# the prefill step's GEMMs at B x S = 2048 tokens
PREFILL_GEMM_SHAPES = [(2048, k, n) for k, n in KN_SHAPES]
REPRESENTATIVE = ("pc3_tr", 4, 2048, 5632)  # decode-time wi/wg GEMM
# (M, K, N) sites of one decode step and their launches a step by tier
# (22 layers: q, o, k, v, wi and wg twice a layer, ffn/wo once, lm_head once;
# the paid tier runs attention's q/k/v/o exact, outside the kernel)
DECODE_SITES = {(2048, 2048): (44, 0), (2048, 256): (44, 0),
                (2048, 5632): (44, 44), (5632, 2048): (22, 22),
                (2048, 32000): (1, 1)}
# both GEMM paths timed here: every decode shape, and the M = 16 to 128
# rows of the path threshold (csrc/daism_matmul.cu, kernels/daism_matmul.py)
PATH_SHAPES = ([(m, k, n) for m in (1, 4) for k, n in KN_SHAPES]
               + [(m, 2048, 5632) for m in (16, 64, 128)]
               + [(64, 2048, 32000), (128, 2048, 32000), (128, 5632, 2048),
                  (128, 2048, 256)])
TIERS = (("free", "*=pc3_tr:pallas"),
         ("paid", "*/attn/*=exact,*=pc3_tr:pallas"))

# flash attention checks on the card, (B, Sq, Skv, H, KH, D), each causal
# and not: small enough for the plain version (B*H <= 32, S <= 512)
FLASH_CHECK_SHAPES = [
    (1, 256, 256, 32, 4, 64),   # GQA at TinyLlama's heads; two KV tiles
    (2, 512, 512, 4, 4, 128),   # MHA, D = 128, four KV tiles
    (2, 384, 384, 4, 1, 32),    # MQA, three KV tiles
    (1, 200, 200, 8, 2, 16),    # D = 16, ragged
    (1, 256, 256, 4, 2, 40),    # D = 40: padded to 48 with zeros
]
FLASH_RAGGED = (2, 100, 72, 4, 2, 64)      # non-causal, both lengths ragged
FLASH_TIMED = (1, 2048, 2048, 32, 4, 64)   # TinyLlama's heads at S = 2048
FLASH_EXACT_TOL = (2e-3, 2e-2)             # atol, rtol (the JAX suite's)
# bf16 exact kernel vs plain: the plain version multiplies an f32 p, the
# tensor-core kernel p_hi + p_lo, which is p to 2**-16 of itself (each bf16
# rounding is within 2**-8), with exact bf16 products summed in f32. So an
# output's f32 value moves by at most ~2**-16 sum(p |v|) / l <= 2**-16
# max|v|, and the bf16 outputs stay one rounding apart: 2**-7 |plain| +
# 2**-16 max|v|. The absolute term matters only where the output cancels
# to near 0 (the card showed 1.4e-6 there, over a 1e-6 floor). One bf16 p
# (2**-8 of p) breaks the bound: phase 7's control.
FLASH_EXACT_ULP = (2.0**-16, 2.0**-7)      # atol per max|v|, rtol
# kernel vs plain, approximate, any number of KV tiles: (atol, rtol). Both
# run the same KV tiles in the same order with the same rounding points
# (RNE bf16 p, expf); only the f32 summation order inside the QK dot
# products, the row sums and the PV sums differs. That leaves the outputs
# one bf16 rounding apart (2**-7 |plain| at most; two ulps allowed), except
# where a score's last f32 bit rounds a p to the neighbouring bf16: the
# approximate PV product of that p can then jump by up to 2**-3 of itself,
# which moves the output by 2**-3 p |v| / l. 1e-3 absolute covers that;
# phases 3 (d) and 7 print the largest excess over the two ulps. A wrong
# product or p rounding breaks the bound: phase 7's controls (the exact and
# FLA kernels against the PC3_TR plain version) must exceed it.
FLASH_APPROX_TOL = (1e-3, 2.0**-6)
# one KV tile against the semantics oracle (another arithmetic for the
# softmax and the divide): the JAX suite's single-tile bound
FLASH_ORACLE_ATOL = 2e-2

PREFILL_SEQ = 2048   # TinyLlama's published context
PREFILL_POLICIES = (
    ("flash pc3_tr", "*/attn/kernel=pc3_tr:flash,*=pc3_tr:pallas"),
    ("flash exact", "*/attn/kernel=exact:flash,*=pc3_tr:pallas"),
    ("jnp attention", "*=pc3_tr:pallas"),
    ("flash exact, exact GEMMs", "*/attn/kernel=exact:flash,*=exact"),
    ("jnp attention, exact GEMMs", "*=exact"),
)
# bounds on max |exact flash - jnp attention| / max |logit| at S = 2048,
# 22 layers, bf16. Both attentions are exact in f32 and differ only in
# summation order, which rounds some bf16 attention outputs one ulp apart.
# With exact GEMMs that stays a rounding difference: the serve phase's
# bf16 bound 3e-2 (measured 0.0184). With approximate GEMMs the products
# jump at carry boundaries, so such 1-ulp inputs move a product by up to
# ~2**-3 of itself, and 22 layers compound it (the JAX model's own response
# to a 1-ulp change is ~7% of max|logit| at 2 layers): ~1.5x the measured
# 0.1225.
# Greedy tokens must agree on every row whose top-2 gap exceeds the
# deviation.
PREFILL_EXACT_REL = 3e-2
PREFILL_APPROX_REL = 0.2
TRAIN_BATCH, TRAIN_SEQ = 2, 256
# the GEMM kernel against its plain version: |kernel - plain| <=
# gemm_rtol(K) * (|a| @ |w|) + 1e-6. Both add the same f32 products in
# another order; the error of an f32 sum of K terms is at most K * 2**-24
# times the sum of their magnitudes (3.4e-4 at K = 5632, hence 4e-4 there),
# and it grows linearly in K: 2.27e-3 at the lm_head backward's K = 32000.
GEMM_RTOL_K, GEMM_RTOL = 5632, 4e-4


# phase 8: slot-cache generation at full width. The decode logits are
# held against a full-sequence forward over the same tokens: the GEMM
# kernel's rows do not depend on M, so the GEMMs agree bit for bit, but
# attention over the 64-cell cache (masked cells, another chunking) sums
# in another order than the forward's, which rounds some bf16 attention
# outputs one ulp apart, and the approximate GEMMs amplify that over 22
# layers as in phase 5: PREFILL_APPROX_REL bounds it, and greedy tokens
# must agree on every row whose top-2 gap exceeds the deviation.
GEN_POLICY = "*=pc3_tr:pallas"
GEN_BATCH, GEN_PROMPT, GEN_STEPS, GEN_MAX_SEQ = 4, 32, 16, 64
GEN_LENS = (32, 20, 26, 12)   # the per-slot run's staggered prompt lengths
# phase 9: the training driver, at full width and 2 layers (each
# checkpoint ~3 GB: bf16 params plus f32 master, m and v)
DRIVER_LAYERS, DRIVER_STEPS, DRIVER_EVERY = 2, 6, 3
DRIVER_PREEMPT = 4            # fault_hook raises before this step
# phase 10: the paper's CNNs in bf16 (as benchmarks/accuracy.py casts its
# bf16 rows), (net, batch, image shape, noise, seed of image_batches); the
# kernel's forward is held against the jnp backend's on the card within
# tests/test_torch_cnn.py's BF16_PALLAS_REL (measured there on the CPU)
CNN_RUNS = (("vgg16", 32, (32, 32, 3), 0.9, 1),
            ("lenet5", 64, (28, 28, 1), 0.5, 0))
CNN_BF16_REL = {"lenet5": 2e-2, "vgg16": 0.15}
# VGG-16's im2col GEMMs at B = 32 (M = 32 * Ho * Wo, K = 9 * cin, N = cout)
# and its two FCs, then LeNet-5's at B = 64 (K = 25 * cin), timed in phase 7
IM2COL_SHAPES = [(32768, 27, 64), (32768, 576, 64), (8192, 576, 128),
                 (8192, 1152, 128), (2048, 1152, 256), (2048, 2304, 256),
                 (512, 2304, 512), (512, 4608, 512), (128, 4608, 512),
                 (32, 512, 512), (32, 512, 10),
                 (50176, 25, 6), (12544, 150, 16), (64, 784, 120),
                 (64, 120, 84), (64, 84, 10)]

# phase 7: the speculative verify step's GEMMs, S = SPEC_K + 1 positions of
# num_slots = 4 rows (M = 16), timed under PC3_TR at every (K, N) site
SPEC_K = 3
VERIFY_M = 4 * (SPEC_K + 1)
# phase 7: exact `x @ w` sites (bf16, cuBLAS) at the main paths' M, with
# torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction on
# (PyTorch's default) and off, each against f32 accumulation
BF16_REDUCTION_M = (1, 4, 16, 128, 2048)
# phase 10: an f32 exact conv on the card (cuDNN) against the CPU's while
# torch.backends.cudnn.allow_tf32 is True, PyTorch's default: (B, side,
# cin, cout, k), within rtol 1e-5 and 1e-5 of the largest output
C1_CONV = (8, 32, 64, 128, 3)
C1_RTOL = 1e-5
# phase 11: preemption against reservation at full width and depth: 4
# prompts of 12-15 tokens (one 16-token page) growing to 40 tokens (three
# pages) against a pool of 6 pages, so concurrent decode exhausts it
PREEMPT_ENGINE = dict(num_slots=4, block_size=16, max_seq=64,
                      prefill_chunk=32, num_blocks=6)
PREEMPT_LENS, PREEMPT_TOTAL = (14, 13, 15, 12), 40
# phase 12: the decoder-only zoo at published widths, random bf16 weights.
# (a) Qwen3-MoE at 2 of 94 layers in the paged engine: 4 requests of
# ~32 prompt tokens and 16 generated, 4 slots, prefill chunks of 32
ZOO_ENGINE = dict(num_slots=4, block_size=16, prefill_chunk=32, max_seq=64)
ZOO_PROMPTS, ZOO_GEN = (32, 30, 28, 31), 16
ZOO_ROUTER_M = (1, 4, 32, 128, 512)  # router rows vs an M = 2048 call
# (c) the expert GEMM at the MoE FFNs' shapes: (label, E, K, N, x shared
# by every expert); w_in's (w_gate's) and w_out's, at C = 4 (decode) and
# 128 (a prefill chunk of 4 x 32 tokens) tokens an expert
ZOO_EXPERT_GEMMS = (("qwen3 w_in", 128, 4096, 1536, True),
                    ("qwen3 w_out", 128, 1536, 4096, False),
                    ("dbrx w_in", 16, 6144, 10752, True),
                    ("dbrx w_out", 16, 10752, 6144, False))
ZOO_EXPERT_C = (4, 128)
# (d) Gemma-2B's forward, (e) StarCoder2-15B's and Nemotron-4-340B's;
# Gemma's serve with the tied lm_head's transpose kept and copied at
# every call, in alternating pairs
ZOO_GEMMA_SEQ, ZOO_DENSE_SEQ = 512, 128
ZOO_LM_HEAD_PAIRS = 3
# (f) Llama-3.2-Vision: 5 of 40 layers hold one cross block
ZOO_VLM_LAYERS, ZOO_VLM_BATCH, ZOO_VLM_SEQ, ZOO_VLM_STEPS = 5, 2, 256, 8
# (g) flash at the zoo's head dims (B, Sq, Skv, H, KH, D) against the plain
# version, each causal (Sq == Skv) and not; the controls at a D = 192 case
ZOO_FLASH_CHECKS = [(1, 256, 256, 8, 1, 256), (2, 100, 300, 4, 2, 256),
                    (1, 256, 256, 8, 2, 192), (1, 300, 300, 4, 1, 192)]
ZOO_FLASH_CONTROL = (1, 256, 256, 8, 2, 192)
# timed at S = 2048 causal: (arch, shape, query heads held against the
# plain version, which is too slow for all of Nemotron's 96)
ZOO_FLASH_TIMED = (("gemma_2b", (1, 2048, 2048, 8, 1, 256), 8),
                   ("nemotron_4_340b", (1, 2048, 2048, 96, 8, 192), 12))

# phase 13: the rest of the zoo at published widths and full depth, random
# bf16 weights. (a) Whisper-large-v3, B = 1: 1500 frames from a seeded
# generator, the decoder at its 448-token limit; phase 5's policies with
# the flash rule on every ATTN_QK site (encoder self, decoder self and
# cross attention: 3 launches a layer pair), then encode + 8 decode_steps
# against the forward's first 8 positions
WHISPER_SEQ, WHISPER_STEPS = 448, 8
WHISPER_POLICIES = tuple(
    (label, spec.replace("*/attn/kernel=", "*/kernel="))
    for label, spec in PREFILL_POLICIES)
# flash alone at Whisper's two shapes (B, Sq, Skv, H, KH, D), non-causal
WHISPER_FLASH = (("encoder self", (1, 1500, 1500, 20, 20, 64)),
                 ("decoder cross", (1, 448, 1500, 20, 20, 64)))
# the GEMM kernel at phase 13's new shapes (label, M, K, N), PC3_TR: the
# Whisper encoder's and the cross K/V's M = 1500, its decoder's at S = 448
# (the head's N = 51866 ends in a ragged tile), xLSTM's projections and gate
# (N = 12), Zamba's in/out projections, B/C (N = 128) and dt (N = 64), and
# its shared block's, at a forward's S = 128 and a decode step's M = 1
ZOO_REST_GEMMS = (("whisper q/k/v/o, cross k/v", 1500, 1280, 1280),
                  ("whisper wi", 1500, 1280, 5120),
                  ("whisper ffn/wo", 1500, 5120, 1280),
                  ("whisper decoder q/k/v/o", 448, 1280, 1280),
                  ("whisper decoder wi", 448, 1280, 5120),
                  ("whisper decoder ffn/wo", 448, 5120, 1280),
                  ("whisper lm_head", 448, 1280, 51866),
                  ("xlstm q/k/v/o, zamba shared", 128, 2048, 2048),
                  ("xlstm wgate", 128, 2048, 12),
                  ("xlstm wgate, decode", 1, 2048, 12),
                  ("zamba bc_proj", 128, 4096, 128),
                  ("zamba bc_proj, decode", 1, 4096, 128),
                  ("zamba dt_proj", 128, 4096, 64),
                  ("zamba dt_proj, decode", 1, 4096, 64),
                  ("zamba in_proj, shared wi", 128, 2048, 8192),
                  ("zamba out_proj", 128, 4096, 2048),
                  ("zamba shared ffn/wo", 128, 8192, 2048))
# (b) xLSTM-1.3B and (c) Zamba2-1.2B, B = 1: a forward at S = 128 (the
# recurrences are a loop a token, paced by the host) and 16 decode_steps
# from an empty cache over the same tokens; Zamba's ring cache at window
# 8 (2 layers, the shared block after both), 16 steps in f32, card vs CPU
RNN_SEQ, RNN_STEPS = 128, 16
ZAMBA_RING, ZAMBA_RING_STEPS = dict(n_layers=2, shared_attn_every=2,
                                    window=8), 16
# (d) card (kernels) vs CPU (plain versions) at full width: depth cut so
# each block kind runs once (Whisper 2 + 2 layers; xLSTM 8: 7 mLSTM and
# one sLSTM; Zamba 7: one shared site and a tail block), Whisper's frames
# cut to 4, since the CPU's plain DAISM GEMM takes ~1 s per 3e7 products;
# f32 under *=exact and bf16 under *=pc3_tr:pallas (the kernel is
# bfloat16-only), over 16 tokens each, at least one of whose greedy tokens
# has a top-2 gap above the deviation (the CPU's time is mostly per GEMM,
# not per row: S = 16 costs ~1.3x S = 4)
ZOO_REST_CPU = {"whisper_large_v3": dict(enc_layers=2, n_layers=2,
                                         enc_frames=4),
                "xlstm_1_3b": dict(n_layers=8),
                "zamba2_1_2b": dict(n_layers=7)}
ZOO_REST_CPU_RUNS = (("*=exact", "float32", 16),
                     ("*=pc3_tr:pallas", "bfloat16", 16))
# (d)'s bf16 bound on max |card - CPU| / max |CPU| by model, set from
# readings on an H100 (kernel / control: Whisper 0.0411 / 0.1694, xLSTM
# 0.0493 / 0.2934, Zamba 0.0053 / 0.1277; PERF.md): about 2x the kernel's
# deviation and below that of the control, the card under *=exact (exact
# products) against the same CPU run, which must exceed the bound, so a
# kernel that dropped the approximation would fail it. The kernel's own
# deviation is the CPU's other summation order, rounded to bf16 at each
# op and carried through approximate products in the next layers
ZOO_REST_CPU_APPROX_REL = {"whisper_large_v3": 0.08, "xlstm_1_3b": 0.1,
                           "zamba2_1_2b": 0.03}
# phase 14: daism-lint and the launchers' preflight on the card. (c): the
# launches at TinyLlama's full width that the preflight must stop before a
# weight exists, each with the code it must name (serve, and train for the
# first); (d): a clean serve and a short train run through it
LINT_BOGUS = "*/bogus/*=exact,*=pc3_tr:pallas"
LINT_ABORTS = ((["--policy", LINT_BOGUS], "POL001"),
               (["--blocks", "1", "--max-seq", "2048"], "SRV002"),
               (["--shards", "4"], "SRV007"),
               (["--shards", "2"], "does not divide the 1 available"))
LINT_POLICY = "*=pc3_tr:pallas"
LINT_SERVE = ["--policy", LINT_POLICY, "--requests", "4"]
LINT_TRAIN = ["--layers", "2", "--steps", "2", "--batch", "2", "--seq",
              "64", "--policy", LINT_POLICY, "--log-every", "1"]


# phase 15: multi-device serving's code at world size 1 (one card). (d)
# the GEMMs of one rank of a 4-way tensor-parallel TinyLlama (label, K,
# N): q, k/v, o, wi/wg, ffn/wo and the vocab-parallel lm_head, at a decode
# step's M = 4 and a prefill chunk's M = 128
MESH_GEMMS = (("q", 2048, 512), ("k/v", 2048, 64), ("o", 512, 2048),
              ("wi/wg", 2048, 1408), ("ffn/wo", 1408, 2048),
              ("lm_head", 2048, 8000))
MESH_M = (4, 128)
# (c) the no-drop forward's tokens (B, S) against the dense MoE
MESH_MOE_TOKENS = (1, 128)

# phase 16: multi-device training's code at world size 1 (one card). (b)
# Qwen3-MoE, 1 of 94 layers, one train step of B x S tokens through EP;
# the state a parameter costs (bf16 weight, f32 master, m, v, bf16 grad)
# and the card bytes above which (b) times forward and backward alone
TRAIN_MESH_MOE_LAYERS, TRAIN_MESH_MOE_TOKENS = 1, (1, 128)
TRAIN_STATE_BYTES_PER_PARAM = 2 + 4 + 4 + 4 + 2
TRAIN_MESH_MAX_STATE = 75e9
# (c) the one-stage pipeline: L layers of (D, D), B rows, M microbatches
TRAIN_MESH_PIPE = (4, 256, 32, 4)
# (d) the launcher over a 1x1 mesh: 2 steps with a checkpoint, then 3
TRAIN_MESH_LAUNCH = ["--arch", "tinyllama_1_1b", "--devices", "1", "--mesh",
                     "1x1", "--layers", "2", "--batch", "2", "--seq", "256",
                     "--ckpt-every", "2", "--log-every", "1", "--policy",
                     "*=pc3_tr:pallas"]


# phase 17: the roofline, the dry-run and activation checkpointing. (a)
# phase 6's STE step (22 layers, B = 2, S = 256) under each remat mode,
# REMAT_STEPS steps each from seed 0 (step 1 has lr 0, step 2 moves the
# parameters); (c) xLSTM-1.3B and Zamba2-1.2B at published width, cut to
# FAMILY_LAYERS (xLSTM: 7 mLSTM blocks and its first sLSTM; Zamba: 6
# Mamba blocks, the shared attention site, one tail block), a forward and
# FAMILY_STEPS STE train steps of B x S = FAMILY_TOKENS over a 1x1 mesh at
# world size 1; (d) one dry-run cell a family on the single-pod mesh
REMAT_STEPS = 2
FAMILY_LAYERS = {"xlstm_1_3b": 8, "zamba2_1_2b": 7}
FAMILY_TOKENS, FAMILY_STEPS = (1, 64), 2
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k"),
                ("qwen3_moe_235b", "decode_32k"),
                ("xlstm_1_3b", "long_500k"),
                ("zamba2_1_2b", "prefill_32k"))


def gemm_rtol(k: int) -> float:
    return GEMM_RTOL * max(1.0, k / GEMM_RTOL_K)

KERNELS = ("daism_matmul", "flash_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1):
    """(mean time of ``fn`` over ``reps`` calls by CUDA events, the last
    call's result)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_graph_ms(fn, operands, reps: int = 20):
    """(mean device time of ``fn(*operands[i % len(operands)])`` over
    ``max(reps, len(operands))`` calls captured in one CUDA graph and
    replayed, a copy of the last call's result). A call through a Python
    wrapper costs tens of microseconds on the host, more than a small GEMM
    takes on the card; replaying a graph times the card's work (and one
    launch a kernel) alone. ``operands`` rotates through copies of the
    inputs (``cold_copies``) so that each call finds them in device memory,
    not in the 50 MB L2, as the bytes bound assumes. ``fn`` runs once
    before the capture, so a first call's build and set-up stay outside
    it."""
    import torch

    fn(*operands[0])
    torch.cuda.synchronize()
    calls = max(reps, len(operands))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            out = fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    out = out.clone()
    del graph
    return start.elapsed_time(end) / calls, out


def cold_copies(*tensors, total_bytes: float = 128e6):
    """``[tensors, copy, copy, ...]``: enough copies that one pass through
    them moves ``total_bytes`` (2.5x the H100's L2)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(total_bytes / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def bound(variant: str, m: int, k: int, n: int):
    """(bound_ms, bound_by, ops) for one (M,K) @ (K,N) GEMM: each input read
    once, the f32 output written once, against the operations it does."""
    nbytes = 2 * m * k + 2 * k * n + 4 * m * n
    if variant == "exact":
        ops = 2 * m * k * n
        op_s = ops / BF16_TENSOR_FLOPS
    else:
        ops = OPS_PER_MAC[variant] * m * k * n
        op_s = ops / INT32_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations", ops
    return byte_s * 1e3, "bytes", ops


def flash_bound(variant: str, b: int, s: int, h: int, kh: int, d: int,
                skv: int = 0, causal: bool = True):
    """(bound_ms, bound_by, ops) for flash attention over B x H heads, S
    queries and ``skv`` keys (default S): q, k, v and o read or written
    once (bf16), against the work the inputs need, S (S + 1) / 2 score
    pairs a head causal (S x skv not) with 2 D products each (4 D flops
    exact, on the bf16 tensor cores)."""
    skv = skv or s
    pairs = b * h * (s * (s + 1) // 2 if causal else s * skv)
    nbytes = 2 * (2 * b * s * h * d + 2 * b * skv * kh * d)
    if variant == "exact":
        ops = 4 * pairs * d
        op_s = ops / BF16_TENSOR_FLOPS
    else:
        ops = OPS_PER_MAC[variant] * 2 * pairs * d
        op_s = ops / INT32_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations", ops
    return byte_s * 1e3, "bytes", ops


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def outer_product_operands(gen, device):
    """(M, 1) and (1, N) bf16 operands covering all 128 normalized mantissas
    at several exponents each (their sums underflow and overflow), random
    signs, plus zeros and subnormals."""
    import torch

    exps = torch.tensor([1, 40, 100, 127, 160, 220, 254], device=device)
    frac = torch.arange(128, device=device)
    bits = ((exps[:, None] << 7) | frac[None, :]).reshape(-1)
    bits = torch.cat([bits, torch.tensor([0, 1, 0x7F, 0x40], device=device)])
    sign = torch.randint(0, 2, bits.shape, generator=gen, device=device)
    bits = bits | (sign << 15)
    b16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    x = b16.view(torch.bfloat16)
    perm = torch.randperm(x.numel(), generator=gen, device=device)
    return x[:, None].contiguous(), x[perm][None, :].contiguous()


def check_kernel(device):
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(0)
    a1, w1 = outer_product_operands(gen, device)
    for v in Variant:
        got = dm.daism_matmul_kernel(a1, w1, v)
        ref = dm.daism_matmul_plain(a1, w1, v)
        torch.cuda.synchronize()
        if v is Variant.EXACT:
            ok = exact_products_held(got, ref)
        else:
            ok = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        if not ok:
            bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            raise SystemExit(f"K=1 products of {v.value}: {bad} of "
                             f"{got.numel()} differ from the plain version")
    # EXACT on every path: the TMA paths need K and N multiples of 8, so
    # they take the same products zero-padded to K = 8 (zeros add nothing)
    ref = dm.daism_matmul_plain(a1, w1, Variant.EXACT)
    n1 = w1.shape[1]
    a8 = torch.zeros((a1.shape[0], 8), dtype=torch.bfloat16, device=device)
    w8 = torch.zeros((8, -(-n1 // 8) * 8), dtype=torch.bfloat16, device=device)
    a8[:, :1], w8[:1, :n1] = a1, w1
    for x, y, path in ((a1, w1, "edge"), (a8, w8, "edge"), (a8, w8, "tile"),
                       (a8, w8, "splitk")):
        got = dm._launch(x, y, Variant.EXACT, path)[:, :n1]
        torch.cuda.synchronize()
        if not exact_products_held(got, ref):
            raise SystemExit(f"K={x.shape[1]} EXACT products on the {path} "
                             "path differ from the plain version by more "
                             "than 2**-126")
    log(f"  (a) K=1 products: {a1.shape[0]} x {w1.shape[1]} pairs; the six "
        "approximate variants bit-identical to the plain version, EXACT "
        "within 2**-126 (subnormal inputs kept, overflow to inf) on the "
        "edge path, and zero-padded to K=8 on the tile, split-K and edge "
        "paths")

    max_err = 0.0
    exact_rel = {}  # EXACT path -> largest |kernel - plain| / (|a| @ |w|)
    shapes = [(m, k, n) for m in M_SHAPES for k, n in KN_SHAPES]
    shapes += RAGGED_SHAPES
    for m, k, n in shapes:
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        for v in Variant:
            ref = dm.daism_matmul_plain(a, w, v)
            paths = exact_paths(k, n) if v is Variant.EXACT else [None]
            for path in paths:
                got = dm._launch(a, w, v, path)
                torch.cuda.synchronize()
                err, rel = gemm_held(got, ref, a, w,
                                     f"{v.value} ({m},{k},{n}) {path}")
                max_err = max(max_err, err)
                if v is Variant.EXACT:
                    key = path or "default"
                    exact_rel[key] = max(exact_rel.get(key, 0.0), rel)
    log(f"  (b) {len(shapes)} shapes x {len(Variant)} variants within "
        f"gemm_rtol(K)*(|a|@|w|)+1e-6 (EXACT forced on each of its paths); "
        f"max |kernel - plain| = {max_err:.6g}; EXACT's largest error over "
        "|a|@|w| by path: " + ", ".join(f"{p} {r:.3g}"
                                        for p, r in exact_rel.items()))

    f32 = torch.zeros((4, 8), device=device)
    try:
        dm.daism_matmul_kernel(f32, f32.t().contiguous(), Variant.PC3_TR)
    except ValueError:
        log("  (c) f32 operands raise ValueError")
    else:
        raise SystemExit("f32 operands were accepted by the kernel wrapper")
    return max_err


def exact_products_held(got, ref) -> bool:
    """EXACT's products against the plain version: equal (infs included)
    or within 2**-126 (a product that underflows)."""
    return bool(((got == ref) | ((got - ref).abs() <= 2.0**-126)).all())


def exact_paths(k: int, n: int):
    """EXACT's paths at a (., K) @ (K, N) shape of aligned operands, the
    default (None) last: the TMA paths where ``_plan`` takes them."""
    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    tma = dm._plan(1, k, n, Variant.EXACT)[0] != "edge"
    return [p for p in dm.EXACT_PATHS if tma or p == "edge"] + [None]


def gemm_held(got, ref, a, w, what):
    """Hold a GEMM kernel output against its plain version within
    gemm_rtol(K) * (|a| @ |w|) + 1e-6; returns (max |kernel - plain|, max
    of that error over |a| @ |w|)."""
    import torch

    k = a.shape[1]
    scale = a.double().abs() @ w.double().abs()
    err = (got.double() - ref.double()).abs()
    excess = (err - (gemm_rtol(k) * scale + 1e-6)).max().item()
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise SystemExit(f"{what}: |kernel - plain| exceeds "
                         f"{gemm_rtol(k):.3g}*(|a|@|w|)+1e-6 by {excess:.3g}")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


def _bhsd_inputs(gen, device, b, sq, skv, h, kh, d, dtype=None):
    import torch

    shapes = ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d))
    return [torch.randn(sh, generator=gen, device=device).to(
        dtype or torch.bfloat16) for sh in shapes]


def flash_excess(got, ref, variant, oracle=False):
    """(max |got - ref|, its largest excess over the bound, the bound's
    text): the exact bound, the approximate kernel-vs-plain bound, or the
    single-tile oracle bound."""
    err = (got.float() - ref.float()).abs()
    if oracle:
        atol, rtol = FLASH_ORACLE_ATOL, 0.0
    else:
        atol, rtol = FLASH_EXACT_TOL if variant is None else FLASH_APPROX_TOL
    excess = (err - (atol + rtol * ref.float().abs())).max().item()
    return err.max().item(), excess, f"{atol:g} + {rtol:.4g} |ref|"


def ulp_excess(got, ref, v):
    """The largest excess of |got - ref| over FLASH_EXACT_ULP's bound for
    attention over values ``v``."""
    atol, rtol = FLASH_EXACT_ULP
    atol *= v.float().abs().max().item()
    return ((got.float() - ref.float()).abs()
            - (atol + rtol * ref.float().abs())).max().item()


def _flash_held(got, ref, variant, what, errs, oracle=False, v=None):
    """Hold a kernel output against its reference; record the largest
    error under ``errs['exact' | 'approx']``; for bf16 exact, hold it also
    to FLASH_EXACT_ULP over the values ``v`` and record the largest excess
    over that under ``errs['exact_over_1ulp']``; for approximate variants,
    record the largest excess over two bf16 ulps (2**-6 |ref|) under
    ``errs['approx_over_2ulp']``."""
    import torch

    err, excess, bound = flash_excess(got, ref, variant, oracle)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise SystemExit(f"flash {what}: |kernel - reference| exceeds {bound} "
                         f"by {excess:.3g} (or is not finite)")
    key = "oracle" if oracle else "exact" if variant is None else "approx"
    errs[key] = max(errs[key], err)
    if variant is None and not oracle and got.dtype == torch.bfloat16:
        over = ulp_excess(got, ref, v)
        if over > 0:
            raise SystemExit(f"flash {what}: bf16 exact |kernel - plain| "
                             f"exceeds 2**-16 max|v| + 2**-7 |plain| by "
                             f"{over:.3g}")
        errs["exact_over_1ulp"] = max(errs["exact_over_1ulp"], over)
    if variant is not None and not oracle:
        over = ((got.float() - ref.float()).abs()
                - 2.0**-6 * ref.float().abs()).max().item()
        errs["approx_over_2ulp"] = max(errs["approx_over_2ulp"], over)


def flash_semantics_oracle(q, k, v, variant, causal):
    """One KV tile of the reference kernel's arithmetic, rebuilt in torch
    (tests/test_flash_attention.py's ``_flash_semantics_oracle``): DAISM QK
    products of kernels/ref.py, scale, mask, the unnormalized exp weights
    cast to bf16, DAISM PV products, an exact divide by the row sum."""
    import numpy as np
    import torch

    from repro_torch.kernels.ref import daism_matmul_ref

    bh, s, d = q.shape
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(bh):
        sm = daism_matmul_ref(q[i], k[i].t(), variant) * float(1.0 / np.sqrt(d))
        if causal:
            sm = torch.where(mask, sm, -1e30)
        p = torch.exp(sm - sm.amax(-1, keepdim=True))
        if causal:
            p = torch.where(mask, p, 0.0)
        pv = daism_matmul_ref(p.to(torch.bfloat16), v[i], variant)
        outs.append(pv / p.sum(-1, keepdim=True))
    return torch.stack(outs)


def check_flash(device):
    """Phase 3 (d)-(f); returns the largest |kernel - plain| seen for exact
    and approximate variants, the largest approximate excess over two bf16
    ulps, and the largest |kernel - oracle|."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(3)
    variants = [None] + [v for v in Variant if v is not Variant.EXACT]
    errs = {"exact": 0.0, "exact_over_1ulp": -1.0, "approx": 0.0,
            "approx_over_2ulp": -1.0, "oracle": 0.0}
    n = 0
    for shape in FLASH_CHECK_SHAPES:
        q, k, v = _bhsd_inputs(gen, device, *shape)
        for causal in (True, False):
            for var in variants:
                got = fa.flash_attention_bhsd_kernel(q, k, v, causal=causal,
                                                     variant=var)
                ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                                    variant=var)
                torch.cuda.synchronize()
                _flash_held(got, ref, var, f"{shape} causal={causal} "
                            f"{var or 'exact'}", errs, v=v)
                n += 1
    q, k, v = _bhsd_inputs(gen, device, *FLASH_RAGGED)
    for var in variants:  # the dispatching entry point, as the model calls it
        got = fa.flash_attention_bhsd(q, k, v, causal=False, variant=var)
        ref = fa.flash_attention_bhsd_plain(q, k, v, causal=False, variant=var)
        torch.cuda.synchronize()
        if got.shape != q.shape:
            raise SystemExit(f"ragged flash output shaped {tuple(got.shape)}")
        _flash_held(got, ref, var, f"ragged {FLASH_RAGGED} {var or 'exact'}",
                    errs, v=v)
        n += 1
    q, k, v = _bhsd_inputs(gen, device, 1, 256, 256, 4, 2, 64, torch.float32)
    for causal in (True, False):
        got = fa.flash_attention_bhsd_kernel(q, k, v, causal=causal)
        ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _flash_held(got, ref, None, f"f32 causal={causal}", errs)
        n += 1
    log(f"  (d) flash_attention: {n} cases (7 variants x D in 16..128 and "
        f"40, causal and not, GQA / MHA / MQA, ragged, f32) within the "
        f"bounds; max "
        f"|kernel - plain| exact {errs['exact']:.4g} (bound "
        f"{FLASH_EXACT_TOL[0]:g} + {FLASH_EXACT_TOL[1]:g} |plain|; bf16 "
        f"largest excess over 2**-16 max|v| + 2**-7 |plain| "
        f"{errs['exact_over_1ulp']:.4g}), "
        f"approximate {errs['approx']:.4g} (bound {FLASH_APPROX_TOL[0]:g} + "
        f"2**-6 |plain|; largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g})")

    # (e) causal S = 256: query rows 0..127 never see keys 128..255, whose
    # KV tile the kernel skips for them; poisoning those keys with NaN must
    # leave those rows bit-identical (and the plain version, which runs the
    # masked tile, agrees on them: checked in (d))
    q, k, v = _bhsd_inputs(gen, device, 1, 256, 256, 4, 2, 64)
    for var in (None, Variant.PC3_TR):
        clean = fa.flash_attention_bhsd_kernel(q, k, v, variant=var)
        kp, vp = k.clone(), v.clone()
        kp[:, 128:] = float("nan")
        vp[:, 128:] = float("nan")
        poisoned = fa.flash_attention_bhsd_kernel(q, kp, vp, variant=var)
        torch.cuda.synchronize()
        if not torch.equal(clean[:, :128], poisoned[:, :128]):
            raise SystemExit("flash: a causally masked KV tile changed rows "
                             "that never see it")
    log("  (e) causally masked KV tiles: keys poisoned with NaN past row 127 "
        "leave rows 0..127 bit-identical (exact and pc3_tr)")

    # (f) one KV tile against the reference's semantics oracle
    for var in (Variant.PC3_TR, Variant.FLA):
        for causal in (True, False):
            q, k, v = (t[0].transpose(0, 1).contiguous() for t in
                       _bhsd_inputs(gen, device, 1, 128, 128, 2, 2, 64))
            got = fa.flash_attention_kernel(q, k, v, causal=causal, variant=var)
            ref = flash_semantics_oracle(q, k, v, var, causal)
            torch.cuda.synchronize()
            _flash_held(got, ref, var, f"oracle {var.value} causal={causal}",
                        errs, oracle=True)
    log(f"  (f) one KV tile vs the semantics oracle (pc3_tr, fla; causal and "
        f"not): max |kernel - oracle| {errs['oracle']:.4g} <= "
        f"{FLASH_ORACLE_ATOL:g}")
    return errs


def check_order(device):
    """Phase 3 (g)-(h): the GEMM kernel against daism_matmul_ordered, bit
    for bit, on both paths; rows independent of M."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(5)
    approx = [v for v in Variant if v is not Variant.EXACT]
    shapes = [(m, k, n) for m in (1, 4) for k, n in KN_SHAPES]
    shapes += [(16, 2048, 5632), (64, 2048, 5632)] + RAGGED_SHAPES
    shapes += [(128, 2048, 5632)]
    n = 0
    for m, k, nn in shapes:
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((k, nn), generator=gen, device=device).to(torch.bfloat16)
        for v in approx:
            ref = dm.daism_matmul_ordered(a, w, v).view(torch.int32)
            for path in ("tile", "splitk", None):
                got = dm._launch(a, w, v, path)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), ref):
                    bad = int((got.view(torch.int32) != ref).sum())
                    raise SystemExit(
                        f"daism_matmul {v.value} ({m},{k},{nn}) path "
                        f"{path or 'default'}: {bad} of {ref.numel()} outputs "
                        "differ from daism_matmul_ordered")
            n += 1
    log(f"  (g) {n} cases ({len(shapes)} shapes x {len(approx)} variants): "
        "tile, split-K and default paths bit-identical to "
        "daism_matmul_ordered")

    for k, nn in ((2048, 5632), (2048, 32000)):
        a = torch.randn((128, k), generator=gen, device=device).to(
            torch.bfloat16)
        w = torch.randn((k, nn), generator=gen, device=device).to(
            torch.bfloat16)
        for v in approx:
            big = dm.daism_matmul_kernel(a, w, v)
            small = dm.daism_matmul_kernel(a[:4].contiguous(), w, v)
            torch.cuda.synchronize()
            if not torch.equal(big[:4].view(torch.int32),
                               small.view(torch.int32)):
                raise SystemExit(f"daism_matmul {v.value} ({k},{nn}): rows "
                                 "0-3 of M = 128 differ from M = 4")
    log("  (h) rows 0-3 of M = 128 launches equal M = 4 launches bit for bit "
        "at (2048, 5632) and (2048, 32000), six variants")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve_requests(vocab: int):
    """8 requests over the two tiers, Poisson arrivals, ~32-token prompts
    and ~16 generated tokens; requests 5 and 6 repeat the prompts (and
    tiers) of requests 1 and 2, so the prefix cache must hit."""
    from repro_torch.serve import poisson_requests

    reqs = poisson_requests(8, vocab, rate=0.5, base_prompt=32, base_gen=16,
                            seed=0, tiers=[name for name, _ in TIERS])
    for dst, src in ((5, 1), (6, 2)):
        reqs[dst].prompt = list(reqs[src].prompt)
        reqs[dst].policy = reqs[src].policy
    return reqs


def approx_launches_per_step(model, skip: str = "") -> int:
    """GEMM launches of one forward of ``model`` that reach the kernel: the
    sites of its site graph (``trace_site_graph`` on the meta device) whose
    config is approximate on the ``pallas`` backend, each times the layers
    its segment covers. Sites under the path prefix ``skip`` are left out
    (``"encoder/"`` for a Whisper decode step, which runs the decoder
    alone)."""
    from repro_torch.analyze import trace_site_graph
    from repro_torch.core.config import Backend
    from repro_torch.policy import OpKind

    return sum(s.repeat for s in trace_site_graph(model.cfg).sites
               if s.kind is not OpKind.ATTN_QK and not s.config.exact
               and s.config.backend is Backend.PALLAS
               and not (skip and s.path.startswith(skip)))


def serve(device, cfg):
    """Serve ``serve_requests`` with ``cfg`` through the two tiers and check
    the run; returns (report, kernel launches during the run)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.models.module import flatten
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    with torch.inference_mode():
        params = model.init(seed=0)
    _sync(device)
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"  tinyllama_1_1b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f}e9 bf16 "
        f"params drawn on the card in {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(num_slots=4, block_size=16, prefill_chunk=32,
                        max_seq=128, tiers=TIERS)
    engine = ServeEngine(model, params, ecfg, device=device)
    reqs = serve_requests(cfg.vocab)

    dm.launches = 0
    report = engine.run(reqs)
    _sync(device)
    launches = dm.launches

    for st in report.completed:
        if len(st.output) != st.request.max_new_tokens:
            raise SystemExit(f"request {st.request_id} produced "
                             f"{len(st.output)} of {st.request.max_new_tokens}")
    if len(report.completed) != len(reqs):
        raise SystemExit(f"{len(report.completed)} of {len(reqs)} completed")
    if report.policy_groups != 2:
        raise SystemExit(f"{report.policy_groups} policy groups ran, not 2")
    if report.prefix_hits < 1:
        raise SystemExit("the prefix cache never hit")
    per_step = {g.label: approx_launches_per_step(g.model)
                for g in engine.groups.values()}
    expected = sum(report.group_steps[label] * n
                   for label, n in per_step.items())
    log(f"  kernel sites per step {per_step}; steps {report.group_steps}")
    if launches != expected or launches == 0:
        raise SystemExit(f"daism_matmul launched {launches} times; the steps "
                         f"imply {expected}")
    log(f"  {len(report.completed)} requests completed at their lengths; "
        f"{report.policy_groups} groups; {report.prefix_hits} prefix-cache "
        f"hit(s); daism_matmul launches {launches} == {expected} implied")

    # logits of a small input: finite, and the kernel path agrees with the
    # plain jnp-backend path (same weights, first two layers, both on the
    # card); bf16 rounds at op boundaries, hence 3e-2 * max|ref|
    small = dataclasses.replace(cfg, n_layers=2)
    sparams = dict(params, blocks={
        s: {k: v[:2] for k, v in sub.items()}
        for s, sub in params["blocks"].items()})
    toks = torch.randint(0, cfg.vocab, (1, 8), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    with torch.inference_mode():
        got, _ = build_model(small.with_policy("*=pc3_tr:pallas"),
                             device=device).forward(sparams, {"tokens": toks})
        ref, _ = build_model(small.with_policy("*=pc3_tr"),
                             device=device).forward(sparams, {"tokens": toks})
    _sync(device)
    if not torch.isfinite(got).all() or got.shape != (1, 8, cfg.vocab):
        raise SystemExit(f"logits not finite or shaped {tuple(got.shape)}")
    dev = (got.float() - ref.float()).abs().max().item()
    lim = 3e-2 * ref.float().abs().max().item()
    if dev > lim:
        raise SystemExit(f"kernel-path logits differ from the plain path by "
                         f"{dev:.4g} > {lim:.4g}")
    log(f"  small input (2 layers, 8 tokens): logits finite, kernel path vs "
        f"plain path max |diff| {dev:.4g} <= {lim:.4g}")
    return report, launches


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _logit_agreement(got, ref):
    """(max |got - ref| / max |ref|, greedy-token agreement on every row,
    and on the rows whose top-2 gap exceeds the deviation)."""
    got, ref = got.float(), ref.float()
    dev = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > dev
    same = got.argmax(-1) == ref.argmax(-1)
    return (dev / ref.abs().max().item(), same.float().mean().item(),
            bool(same[clear].all()), int(clear.sum()))


# ---------------------------------------------------------------------------
# phase 5: prefill
# ---------------------------------------------------------------------------

def prefill(device, cfg):
    """``prefill_step`` at full width and ``cfg``'s depth, B=1, S=2048,
    under PREFILL_POLICIES; returns (results, flash launches, GEMM kernel
    launches) of the run."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_artifacts

    params = build_artifacts(cfg, device=device).init_params(0)
    tokens = next(lm_batches(cfg.vocab, 1, PREFILL_SEQ, seed=0))["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    arts = {label: build_artifacts(cfg.with_policy(spec), device=device)
            for label, spec in PREFILL_POLICIES}

    logits, results = {}, {}
    fa.launches = dm.launches = 0
    for label, spec in PREFILL_POLICIES:
        art = arts[label]
        f0, d0 = fa.launches, dm.launches
        t0 = time.perf_counter()
        out = art.prefill_step(params, batch)
        _sync(device)
        sec = time.perf_counter() - t0
        flash_n, gemm_n = fa.launches - f0, dm.launches - d0
        want_flash = cfg.n_layers if ":flash" in spec else 0
        want_gemm = approx_launches_per_step(art.model)
        if (flash_n, gemm_n) != (want_flash, want_gemm):
            raise SystemExit(f"prefill {label!r}: flash launched {flash_n} "
                             f"(expected {want_flash}), daism_matmul {gemm_n} "
                             f"(expected {want_gemm})")
        if out.shape != (1, PREFILL_SEQ, cfg.vocab) or \
                not bool(torch.isfinite(out).all()):
            raise SystemExit(f"prefill {label!r}: logits not finite or "
                             f"shaped {tuple(out.shape)}")
        logits[label] = out
        results[label] = dict(ms=sec * 1e3, tok_s=PREFILL_SEQ / sec,
                              flash=flash_n, gemm=gemm_n)
        log(f"  {label:27s} {sec * 1e3:9.1f} ms  {PREFILL_SEQ / sec:8.1f} "
            f"tok/s  launches: flash {flash_n}, daism_matmul {gemm_n}")
    flash_launches, gemm_launches = fa.launches, dm.launches
    # the exact-GEMM pair again: its first forward carries the first use of
    # the bf16 library GEMMs at these shapes
    for label, spec in PREFILL_POLICIES:
        if "*=exact" not in spec:
            continue
        t0 = time.perf_counter()
        arts[label].prefill_step(params, batch)
        _sync(device)
        sec = time.perf_counter() - t0
        results[label].update(warm_ms=sec * 1e3)
        log(f"  {label:27s} {sec * 1e3:9.1f} ms  (second forward)")

    for (a, b), lim in ((("flash exact, exact GEMMs",
                          "jnp attention, exact GEMMs"), PREFILL_EXACT_REL),
                        (("flash exact", "jnp attention"), PREFILL_APPROX_REL)):
        rel, agree, clear_ok, n_clear = _logit_agreement(logits[a], logits[b])
        results[f"{a} vs {b}"] = dict(rel=rel, agree=agree, n_clear=n_clear)
        log(f"  {a!r} vs {b!r}: max |diff| / max |ref| {rel:.4g} (bound "
            f"{lim:g}); greedy tokens agree on {agree * 100:.2f}% of rows, "
            f"on all {n_clear} rows whose top-2 gap exceeds the deviation: "
            f"{clear_ok}")
        if rel > lim or not clear_ok:
            raise SystemExit(f"prefill: {a!r} and {b!r} disagree beyond the "
                             "bound")
    del logits, params, arts
    _free(device)
    return results, flash_launches, gemm_launches


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

def train(device, cfg):
    """3 ``train_step``s (STE backward) and 1 with the approximate backward
    at full width, B=2, S=256; returns (step records, GEMM kernel
    launches of the run)."""
    import torch

    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.policy import ApproxPolicy

    def arts(policy):
        return build_artifacts(cfg.with_policy(policy), device=device,
                               warmup=1, total_steps=100)

    ste = arts("*=pc3_tr:pallas")
    approx = arts(ApproxPolicy.uniform(DaismConfig(
        variant=Variant.PC3_TR, backend=Backend.PALLAS, backward="approx")))
    params = ste.init_params(0)
    opt = ste.init_opt(params)
    batches = lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)

    # the flash kernel has no backward (nor has the reference's): a train
    # step under a ':flash' policy raises and leaves params and state alone
    try:
        arts("*/attn/kernel=exact:flash,*=pc3_tr:pallas").train_step(
            params, opt, next(batches))
    except NotImplementedError as e:
        log(f"  a ':flash' train step raises NotImplementedError: {e}")
    else:
        raise SystemExit("a train step under a ':flash' policy did not raise")
    if int(opt.step) != 0:
        raise SystemExit("the refused step moved the optimizer")

    per_fwd = approx_launches_per_step(ste.model)
    plan = [("ste", ste, per_fwd)] * 3 + [("approx", approx, 3 * per_fwd)]
    steps = []
    torch.cuda.reset_peak_memory_stats(device)
    fa.launches = dm.launches = 0
    for i, (label, art, want) in enumerate(plan):
        d0 = dm.launches
        t0 = time.perf_counter()
        params, opt, m = art.train_step(params, opt, next(batches))
        _sync(device)
        sec = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        n = dm.launches - d0
        steps.append(dict(backward=label, ms=sec * 1e3, loss=loss,
                          grad_norm=gnorm, launches=n, lr=float(m["lr"])))
        log(f"  step {i + 1} ({label:6s} backward) {sec * 1e3:9.1f} ms  loss "
            f"{loss:.4f}  grad_norm {gnorm:.4f}  lr {float(m['lr']):.3g}  "
            f"daism_matmul launches {n} (sites imply {want})")
        if not (math.isfinite(loss) and math.isfinite(gnorm)) or n != want:
            raise SystemExit(f"train step {i + 1}: loss {loss}, grad_norm "
                             f"{gnorm}, {n} launches where {want} are implied")
    if fa.launches:
        raise SystemExit("the train steps launched the flash kernel")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"  peak device memory {peak:.1f} GiB (bf16 params, f32 master/m/v)")
    launches = dm.launches
    del params, opt, ste, approx
    _free(device)
    return steps, launches, peak


# ---------------------------------------------------------------------------
# phase 5: numbers
# ---------------------------------------------------------------------------

def measure(device, variants):
    """GEMM kernel / plain / library times and bounds; every timed kernel
    output is held against the timed plain output (phase 3's bound).
    Returns (rows, max |kernel - plain|)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    # (M, K, N, variants): the plain version's time is one call (it is a
    # yardstick of the arithmetic, not of speed)
    cases = [(m, k, n, variants) for k, n in KN_SHAPES for m in M_SHAPES]
    cases += [(m, k, n, ["pc3_tr", "exact"])
              for m, k, n in PREFILL_GEMM_SHAPES + TRAIN_GEMM_SHAPES]
    cases += [(m, k, n, ["pc3_tr"]) for m, k, n in IM2COL_SHAPES]
    cases += [(VERIFY_M, k, n, ["pc3_tr"]) for k, n in KN_SHAPES]
    max_err = 0.0
    for m, k, n, case_variants in cases:
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        for v in case_variants:
            if v == "exact":
                row = measure_exact(a, w)
                rows.append(row)
                max_err = max(max_err, row["max_abs_err"])
                continue
            ms, got = cuda_time_ms(lambda: dm.daism_matmul_kernel(a, w, v), 10)
            plain_ms, ref = cuda_time_ms(
                lambda: dm.daism_matmul_plain(a, w, v), 1, warmup=0)
            err, rel = gemm_held(got, ref, a, w, f"{v} ({m},{k},{n})")
            max_err = max(max_err, err)
            del got, ref
            b_ms, b_by, ops = bound(v, m, k, n)
            rows.append(dict(variant=v, m=m, k=k, n=n, ms=ms,
                             plain_ms=plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by, ops=ops,
                             max_abs_err=err, max_rel_err=rel))
            log(f"  {v:7s} M={m:4d} K={k:5d} N={n:6d}  kernel "
                f"{ms:9.4f} ms  plain {plain_ms:10.3f} ms  library "
                f"{'-':>8s} ms  bound {b_ms:.4f} ms ({b_by}, "
                f"{ops:.3e} ops)  {b_ms / ms * 100:5.1f}% of bound  "
                f"|kernel - plain| {err:.3g} = {rel:.3g} (|a|@|w|) "
                f"<= {gemm_rtol(k):.3g}")
        del a, w
        _free(device)
    return rows, max_err


def mm_f32_out(a, w):
    """The yardstick for EXACT: one PyTorch call computing the same
    function on the tensor cores, a bf16 x bf16 product with f32
    accumulation and f32 output."""
    import torch

    return torch.mm(a, w, out_dtype=torch.float32)


def measure_exact(a, w):
    """EXACT at one shape: every path's device time (CUDA graph replay
    over copies of the inputs that do not fit the L2), each output held
    against the plain version; the default path's time through the wrapper
    (host clock included, inputs warm); the yardstick
    ``torch.mm(a, w, out_dtype=torch.float32)`` and the earlier yardstick,
    the f32-upcast ``torch.matmul(a.float(), w.float())``, both timed as
    the kernel is. Returns the row for the kernels record."""
    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    m, k = a.shape
    n = w.shape[1]
    plain_ms, ref = cuda_time_ms(
        lambda: dm.daism_matmul_plain(a, w, Variant.EXACT), 1, warmup=0)
    copies = cold_copies(a, w)
    paths, err, rel = {}, 0.0, 0.0
    for path in exact_paths(k, n)[:-1]:
        paths[path], got = cuda_graph_ms(
            lambda x, y: dm._launch(x, y, Variant.EXACT, path), copies)
        e, r = gemm_held(got, ref, a, w, f"exact ({m},{k},{n}) {path}")
        err, rel = max(err, e), max(rel, r)
        del got
    default = dm._plan(m, k, n, Variant.EXACT)[0]
    wrapper_ms, _ = cuda_time_ms(
        lambda: dm.daism_matmul_kernel(a, w, Variant.EXACT), 10)
    lib_ms, lib_out = cuda_graph_ms(mm_f32_out, copies)
    f32_ms, _ = cuda_graph_ms(lambda x, y: x.float() @ y.float(), copies)
    gemm_held(lib_out, ref, a, w, f"torch.mm out_dtype=f32 ({m},{k},{n})")
    del lib_out, ref, copies
    ms = paths[default]
    b_ms, b_by, ops = bound("exact", m, k, n)
    log(f"  exact   M={m:4d} K={k:5d} N={n:6d}  kernel {ms:9.4f} ms "
        f"({default}; " + ", ".join(f"{p} {t:.4f}" for p, t in paths.items())
        + f"; through the wrapper {wrapper_ms:.4f})  plain {plain_ms:.3f} ms"
        f"  torch.mm out f32 {lib_ms:.4f} ms  f32 matmul {f32_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})  {b_ms / ms * 100:5.1f}% of bound  "
        f"{ms / lib_ms:.2f}x torch.mm  |kernel - plain| <= {rel:.3g} "
        f"(|a|@|w|)")
    return dict(variant="exact", m=m, k=k, n=n, ms=ms, path=default,
                paths=paths, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=lib_ms, f32_library_ms=f32_ms, bound_ms=b_ms,
                bound_by=b_by, ops=ops, max_abs_err=err, max_rel_err=rel)


def default_path(m, k, n):
    """The path a PC3_TR (M, K) @ (K, N) call takes by default."""
    from repro_torch.kernels import daism_matmul as dm

    return "tile" if dm._plan(m, k, n, "pc3_tr") is None else "splitk"


def measure_paths(device):
    """Both GEMM paths timed at PATH_SHAPES (PC3_TR), each output held
    against the other bit for bit; returns {(m, k, n): {path: ms}}."""
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(6)
    times = {}
    for m, k, n in PATH_SHAPES:
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        row, outs = {}, {}
        for path in ("tile", "splitk"):
            row[path], outs[path] = cuda_time_ms(
                lambda: dm._launch(a, w, "pc3_tr", path), 10)
        if not torch.equal(outs["tile"].view(torch.int32),
                           outs["splitk"].view(torch.int32)):
            raise SystemExit(f"({m},{k},{n}): the two paths differ")
        default = default_path(m, k, n)
        b_ms = bound("pc3_tr", m, k, n)[0]
        times[(m, k, n)] = row
        log(f"  pc3_tr M={m:4d} K={k:5d} N={n:6d}  tile {row['tile']:9.4f} ms"
            f"  split-K {row['splitk']:9.4f} ms  bound {b_ms:.4f} ms  "
            f"default {default} ({b_ms / row[default] * 100:.1f}% of bound)")
        del a, w, outs
    for tier, col in (("free", 0), ("paid", 1)):
        for m in (1, 4):
            new = sum(DECODE_SITES[kn][col]
                      * times[(m, *kn)][default_path(m, *kn)]
                      for kn in DECODE_SITES)
            old = sum(DECODE_SITES[kn][col] * times[(m, *kn)]["tile"]
                      for kn in DECODE_SITES)
            b = sum(DECODE_SITES[kn][col] * bound("pc3_tr", m, *kn)[0]
                    for kn in DECODE_SITES)
            log(f"  decode-step GEMM total, {tier} tier, M={m}: "
                f"{new:.3f} ms on the default paths (tile path alone "
                f"{old:.3f} ms; bound {b:.3f} ms)")
    _free(device)
    return times


def bf16_reduction(device):
    """Does ``allow_bf16_reduced_precision_reduction`` (PyTorch's default:
    on) move the exact ``x @ w`` sites (bf16 in, bf16 out, cuBLAS) away
    from f32 accumulation? At every (K, N) site and BF16_REDUCTION_M, the
    bf16 outputs with the flag on and off are compared element by element
    with ``torch.mm(a, w, out_dtype=torch.float32)`` rounded to bf16.
    Returns {(m, k, n): (differing with the flag on, with it off)}."""
    import torch

    flags = torch.backends.cuda.matmul
    gen = torch.Generator(device=device).manual_seed(9)
    default = flags.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for m in BF16_REDUCTION_M:
            for k, n in KN_SHAPES:
                a = torch.randn((m, k), generator=gen,
                                device=device).to(torch.bfloat16)
                w = (torch.randn((k, n), generator=gen, device=device)
                     / math.sqrt(k)).to(torch.bfloat16)
                ref = torch.mm(a, w, out_dtype=torch.float32).to(
                    torch.bfloat16)
                diff = []
                for flag in (True, False):
                    flags.allow_bf16_reduced_precision_reduction = flag
                    diff.append(int((a @ w != ref).sum()))
                out[(m, k, n)] = tuple(diff)
                del a, w, ref
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    moved = {key: d for key, d in out.items() if any(d)}
    log(f"  exact bf16 x @ w at M {BF16_REDUCTION_M} x {len(KN_SHAPES)} "
        f"(K, N) sites: elements differing from f32 accumulation with "
        f"allow_bf16_reduced_precision_reduction on / off: "
        + (", ".join(f"{key} {d[0]} / {d[1]}" for key, d in moved.items())
           if moved else f"0 / 0 at all {len(out)} shapes"))
    _free(device)
    return out


def flash_one_bf16_p(q, k, v):
    """The control of the one-ulp bound: causal exact attention on (B, S,
    H, D) bf16 in f32, but with p rounded once to bf16 before PV (the design
    flash_fwd_tc's split p avoids); bf16 out."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    s, h, d = q.shape[1:]
    qf, kf, vf = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(
        1, 2).float() for t in (q, k, v))
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = torch.where(mask, (qf @ kf.transpose(-1, -2)) * fa._scale(d), -1e30)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    del sc
    o = (p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True)
    return o.to(torch.bfloat16).transpose(1, 2)


def measure_flash(device):
    """Kernel / plain / SDPA times at TinyLlama's heads, S = 2048, causal;
    each timed kernel output is held against the timed plain output (phase
    3's bounds), and the exact and FLA kernels against the PC3_TR plain
    output must break the approximate bound, and exact attention with one
    bf16 p the one-rounding bound (controls: each bound tells another
    function apart). Returns (rows, max |kernel - plain|)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kh, d = (FLASH_TIMED[i] for i in (0, 1, 3, 4, 5))
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v = _bhsd_inputs(gen, device, *FLASH_TIMED)
    # SDPA's inputs: (B, H, S, D) with the kv heads expanded beforehand
    qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))
    rows, outs, plains = [], {}, {}
    errs = {"exact": 0.0, "exact_over_1ulp": -1.0, "approx": 0.0,
            "approx_over_2ulp": -1.0}
    for var in [None] + [x for x in Variant if x is not Variant.EXACT]:
        name = var.value if var else "exact"
        ms, outs[name] = cuda_time_ms(lambda: fa.flash_attention_bhsd_kernel(
            q, k, v, variant=var), 5)
        plain_ms, plains[name] = cuda_time_ms(
            lambda: fa.flash_attention_bhsd_plain(q, k, v, variant=var), 1,
            warmup=0)
        _flash_held(outs[name], plains[name], var,
                    f"{FLASH_TIMED} causal {name}", errs, v=v)
        err = (outs[name].float() - plains[name].float()).abs().max().item()
        lib_ms = None
        if var is None:
            lib_ms, _ = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 10)
        b_ms, b_by, ops = flash_bound(name, b, s, h, kh, d)
        rows.append(dict(variant=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, max_abs_err=err))
        lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
        log(f"  flash {name:7s} B={b} S={s} H={h} KH={kh} D={d} causal  "
            f"kernel {ms:9.4f} ms  plain {plain_ms:10.3f} ms  SDPA "
            f"{lib:>8s} ms  bound {b_ms:.4f} ms ({b_by}, {ops:.3e} ops)  "
            f"{b_ms / ms * 100:5.1f}% of bound  |kernel - plain| {err:.4g}")
    log(f"  flash at {FLASH_TIMED}: all 7 variants within the bounds; max "
        f"|kernel - plain| exact {errs['exact']:.4g} (largest excess over "
        f"2**-16 max|v| + 2**-7 |plain| {errs['exact_over_1ulp']:.4g}), "
        f"approximate "
        f"{errs['approx']:.4g} (largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g}, allowed {FLASH_APPROX_TOL[0]:g})")
    for other in ("exact", "fla"):
        err, excess, bnd = flash_excess(outs[other], plains["pc3_tr"],
                                        Variant.PC3_TR)
        log(f"  control: {other} kernel vs pc3_tr plain: max |diff| "
            f"{err:.4g}, exceeds {bnd} by {excess:.4g}")
        if excess <= 0:
            raise SystemExit(f"flash control: the {other} kernel's output "
                             "passes the approximate bound against the "
                             "pc3_tr plain version; the bound cannot tell "
                             "the two functions apart")
    one_p = flash_one_bf16_p(q, k, v)
    over = ulp_excess(one_p, plains["exact"], v)
    log(f"  control: exact attention with one bf16 p vs the exact plain: "
        f"exceeds 2**-16 max|v| + 2**-7 |plain| by {over:.4g}")
    if over <= 0:
        raise SystemExit("flash control: one bf16 p passes the one-ulp bound "
                         "against the exact plain version; the bound cannot "
                         "tell it from the kernel's split p")
    return rows, max(errs["exact"], errs["approx"])


# ---------------------------------------------------------------------------
# phase 8: generate (slot caches)
# ---------------------------------------------------------------------------

def generate(device, cfg):
    """``prefill`` and greedy ``decode_step`` on slot caches at full width:
    a scalar-``pos`` cache, then a per-slot ``(B,)`` ``pos`` with staggered
    prompt lengths; each run's logits against a full-sequence forward.
    Returns (records, GEMM kernel launches, ms per decode step)."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.launch.steps import build_artifacts

    art = build_artifacts(cfg.with_policy(GEN_POLICY), device=device)
    params = art.init_params(0)
    prompts = torch.from_numpy(next(lm_batches(
        cfg.vocab, GEN_BATCH, GEN_PROMPT, seed=3))["tokens"]).to(device).long()
    per_fwd = approx_launches_per_step(art.model)
    rows = torch.arange(GEN_BATCH, device=device)
    records, launches, decode_ms = {}, 0, []
    for label, lens in (("scalar pos", (GEN_PROMPT,) * GEN_BATCH),
                        ("per-slot pos", GEN_LENS)):
        lens_t = torch.tensor(lens, device=device)
        dm.launches = 0
        cache = art.init_cache(GEN_BATCH, GEN_MAX_SEQ)
        with torch.no_grad():
            logits, cache = art.model.prefill(params, prompts, cache)
        if label == "per-slot pos":
            cache = dict(cache, pos=lens_t.to(torch.int32))
        nxt = logits[rows, lens_t - 1].argmax(-1)[:, None]
        outs, gen = [], []
        for _ in range(GEN_STEPS):
            gen.append(nxt)
            t0 = time.perf_counter()
            logits, cache = art.decode_step(params, nxt, cache)
            _sync(device)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits[:, 0])
            nxt = logits[:, 0].argmax(-1)[:, None]
        n = dm.launches
        launches += n
        want = per_fwd * (1 + GEN_STEPS)
        if n != want:
            raise SystemExit(f"generate ({label}): daism_matmul launched {n} "
                             f"times; prefill + {GEN_STEPS} decode steps "
                             f"imply {want}")
        got = torch.stack(outs, 1)                     # (B, steps, V)
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"generate ({label}): decode logits not finite")
        if label == "scalar pos" and int(cache["pos"]) != \
                GEN_PROMPT + GEN_STEPS:
            raise SystemExit(f"generate: pos {int(cache['pos'])} after "
                             f"{GEN_STEPS} steps")
        # the same tokens through one causal forward: row i's prompt (its
        # true length) and its generated tokens, right-padded
        seq = torch.zeros((GEN_BATCH, GEN_PROMPT + GEN_STEPS),
                          dtype=torch.long, device=device)
        at = lens_t[:, None] + torch.arange(GEN_STEPS, device=device)
        for i, length in enumerate(lens):
            seq[i, :length] = prompts[i, :length]
        seq[rows[:, None], at] = torch.cat(gen, 1)
        with torch.no_grad():
            full, _ = art.model.forward(params, {"tokens": seq})
        ref = full[rows[:, None], at]                  # (B, steps, V)
        rel, agree, clear_ok, n_clear = _logit_agreement(got, ref)
        records[label] = dict(rel=rel, agree=agree, n_clear=n_clear,
                              launches=n)
        log(f"  {label}: prefill of {GEN_BATCH} prompts (lengths {lens}) + "
            f"{GEN_STEPS} greedy decode steps; daism_matmul launches {n} == "
            f"{per_fwd} sites x {1 + GEN_STEPS} calls; decode vs forward max "
            f"|diff| / max |ref| {rel:.4g} (bound {PREFILL_APPROX_REL:g}); "
            f"greedy tokens agree on {agree * 100:.2f}% of rows, on all "
            f"{n_clear} rows whose top-2 gap exceeds the deviation: "
            f"{clear_ok}")
        if rel > PREFILL_APPROX_REL or not clear_ok:
            raise SystemExit(f"generate ({label}): decode and forward "
                             "disagree beyond the bound")
        del full, ref, got, cache
    ms = sorted(decode_ms)
    records["decode_ms_p50"] = ms[len(ms) // 2]
    records["decode_ms_mean"] = sum(ms) / len(ms)
    log(f"  decode_step at B = {GEN_BATCH}: p50 {records['decode_ms_p50']:.2f}"
        f" ms, mean {records['decode_ms_mean']:.2f} ms over {len(ms)} steps "
        f"(host clock, synchronized)")
    del params, art
    _free(device)
    return records, launches


# ---------------------------------------------------------------------------
# phase 9: the training driver (launch/train.py, fault tolerance)
# ---------------------------------------------------------------------------

def _same_bits(a, b) -> bool:
    """Leaves equal bit for bit (bf16 and f32 compared as integers)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[a.dtype])
    return bool(torch.equal(a, b))


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def train_driver(device, cfg):
    """``launch.train.main`` at full width and DRIVER_LAYERS layers, then
    ``fault_tolerance.run`` preempted before step DRIVER_PREEMPT and
    resumed from a fresh init: the restored state must equal, bit for bit,
    a copy of the step-DRIVER_EVERY state taken in memory. Returns
    (records, GEMM kernel launches)."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.launch import train as launcher
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.module import flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault_tolerance import (SimulatedPreemption,
                                                     TrainLoopConfig, run)

    small = dataclasses.replace(cfg, n_layers=DRIVER_LAYERS).with_policy(
        GEN_POLICY)
    art = build_artifacts(small, device=device, total_steps=DRIVER_STEPS,
                          warmup=1, opt_cfg=AdamWConfig(lr=1e-3))
    per_step = approx_launches_per_step(art.model)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    records = {}
    log(f"  depth cut: {DRIVER_LAYERS} of {cfg.n_layers} layers at full "
        "width, so that a checkpoint holds ~3 GB (bf16 params, f32 master, "
        "m and v)")
    try:
        argv = ["--arch", "tinyllama_1_1b", "--layers", str(DRIVER_LAYERS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(DRIVER_STEPS), "--ckpt-every",
                str(DRIVER_EVERY), "--policy", GEN_POLICY, "--ckpt",
                str(root / "launcher"), "--log-every", "1", "--device",
                str(device)]
        log("  python -m repro_torch.launch.train " + " ".join(
            repr(a) if "*" in a else a for a in argv))
        dm.launches = 0
        t0 = time.perf_counter()
        _, opt, state = launcher.main(argv)
        _sync(device)
        sec = time.perf_counter() - t0
        n = dm.launches
        launches = n
        if state.step != DRIVER_STEPS or int(opt.step) != DRIVER_STEPS or \
                n != DRIVER_STEPS * per_step:
            raise SystemExit(f"launch.train: step {state.step}, optimizer "
                             f"step {int(opt.step)}, daism_matmul launched "
                             f"{n} times where {DRIVER_STEPS} x {per_step} "
                             "are implied")
        if ckpt.latest_step(str(root / "launcher")) != DRIVER_STEPS:
            raise SystemExit("launch.train left no complete final checkpoint")
        one = _dir_bytes(root / "launcher" / f"step_{DRIVER_STEPS:08d}")
        records.update(launcher_s=sec, checkpoint_bytes=one)
        log(f"  launch.train: {DRIVER_STEPS} steps in {sec:.1f} s (2 "
            f"checkpoints included); daism_matmul launches {n} == "
            f"{DRIVER_STEPS} x {per_step} sites; a checkpoint holds "
            f"{one / 1e9:.3f} GB")
        del opt, state
        shutil.rmtree(root / "launcher")
        _free(device)

        # preempted before step DRIVER_PREEMPT, resumed from a fresh init
        loop = TrainLoopConfig(total_steps=DRIVER_STEPS,
                               ckpt_dir=str(root / "resume"),
                               ckpt_every=DRIVER_EVERY, log_every=1)
        marks, saved, losses, step_ms = {}, {}, {}, []

        def put(b):
            return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

        def metrics(step, m):
            losses[step] = m["loss"]
            marks[step] = time.perf_counter()
            log(f"  run: step {step} loss {m['loss']:.4f} gnorm "
                f"{m['grad_norm']:.3f} lr {m['lr']:.2e}")

        def first_run_step(params, opt, batch):
            if int(opt.step) == DRIVER_EVERY:  # after the save at step 3
                marks["saved"] = time.perf_counter()
            t0 = time.perf_counter()
            out = art.train_step(params, opt, batch)
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if int(out[1].step) == DRIVER_EVERY:
                _sync(device)
                saved["tree"] = {k: v.clone() for k, v in ckpt._flatten(
                    {"params": out[0], "opt": out[1]}).items()}
            return out

        def bomb(step):
            if step == DRIVER_PREEMPT:
                raise SimulatedPreemption(f"preempted before step {step + 1}")

        dm.launches = 0
        params = art.init_params(0)
        try:
            run(loop, first_run_step, params, art.init_opt(params),
                lm_batches(small.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0), put,
                fault_hook=bomb, metrics_hook=metrics)
        except SimulatedPreemption as e:
            log(f"  run: SimulatedPreemption ({e}) after step "
                f"{DRIVER_PREEMPT}; newest checkpoint: step "
                f"{ckpt.latest_step(loop.ckpt_dir)}")
        else:
            raise SystemExit("the fault hook did not preempt the run")
        n_first = dm.launches
        save_s = marks["saved"] - marks[DRIVER_EVERY]
        del params
        _free(device)

        checked = {}

        def resumed_step(params, opt, batch):
            if not checked:  # the first step sees the restored state
                marks["restored"] = time.perf_counter()
                now = ckpt._flatten({"params": params, "opt": opt})
                bad = [k for k, v in saved["tree"].items()
                       if not _same_bits(v, now[k])]
                checked.update(step=int(opt.step), leaves=len(now), bad=bad)
                if bad or int(opt.step) != DRIVER_EVERY or \
                        set(now) != set(saved["tree"]):
                    raise SystemExit(f"resume: optimizer step "
                                     f"{int(opt.step)}, {len(bad)} leaves "
                                     f"differ from the step-{DRIVER_EVERY} "
                                     f"state, e.g. {bad[:3]}")
            t0 = time.perf_counter()
            out = art.train_step(params, opt, batch)
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        fresh = art.init_params(1)
        t0 = time.perf_counter()
        _, opt, state = run(loop, resumed_step, fresh, art.init_opt(fresh),
                            lm_batches(small.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                       seed=0), put, metrics_hook=metrics)
        _sync(device)
        end = time.perf_counter()
        n_resumed = dm.launches - n_first
        launches += dm.launches
        restore_s = marks["restored"] - t0
        final_s = end - marks[DRIVER_STEPS]
        n_params = sum(t.numel() for t in flatten(fresh).values())
        if state.step != DRIVER_STEPS or not math.isfinite(
                losses[DRIVER_STEPS]):
            raise SystemExit(f"resume: ended at step {state.step}, loss "
                             f"{losses.get(DRIVER_STEPS)}")
        want = (DRIVER_PREEMPT + DRIVER_STEPS - DRIVER_EVERY) * per_step
        if n_first + n_resumed != want:
            raise SystemExit(f"run: daism_matmul launched "
                             f"{n_first + n_resumed} times; the steps imply "
                             f"{want}")
        steady = sorted(step_ms[1:])
        records.update(step_ms_p50=steady[len(steady) // 2])
        log("  train_step ms (host clock, synchronized; both runs): " +
            ", ".join(f"{t:.1f}" for t in step_ms))
        records.update(restore_s=restore_s, save_s=save_s,
                       final_save_s=final_s, n_params=n_params,
                       leaves=checked["leaves"],
                       final_loss=losses[DRIVER_STEPS])
        log(f"  resume from a fresh init at step {checked['step']}: all "
            f"{checked['leaves']} leaves of params and optimizer state equal "
            f"the in-memory step-{DRIVER_EVERY} copy bit for bit; step "
            f"{DRIVER_STEPS} loss {losses[DRIVER_STEPS]:.4f}; daism_matmul "
            f"launches {n_first} + {n_resumed} == {want} implied")
        log(f"  {n_params / 1e6:.1f}e6 parameters; checkpoint save (host "
            f"copy + np.savez + rename) {save_s:.2f} s at step "
            f"{DRIVER_EVERY}, {final_s:.2f} s at step {DRIVER_STEPS}; restore "
            f"(np.load + copy to the card) {restore_s:.2f} s; 4 checkpoints "
            f"written in this phase, {4 * records['checkpoint_bytes'] / 1e9:.2f}"
            " GB")
        del opt, state, fresh, saved["tree"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del art
    _free(device)
    return records, launches


# ---------------------------------------------------------------------------
# phase 10: cnn
# ---------------------------------------------------------------------------

def cnn_kernel_sites(model) -> int:
    """GEMM sites of one CNN forward that resolve to the kernel: every
    conv (OpKind.CONV), FC and the head (LM_HEAD) under ``model``'s
    policy."""
    from repro_torch.core.config import Backend
    from repro_torch.policy import OpKind

    pol = model.cfg.approx_policy
    n = 0
    for name, (shape, _, _) in model.param_specs().items():
        if name.endswith("_b"):
            continue
        kind = (OpKind.CONV if len(shape) == 4 else
                OpKind.LM_HEAD if name == "out" else OpKind.DENSE)
        c = pol.resolve(f"cnn/{name}", kind)
        n += not c.exact and c.backend is Backend.PALLAS
    return n


def cnn_step(model, params, opt, images, labels):
    """One AdamW step of a CNN (the reference example's recipe)."""
    import torch

    from repro_torch.models.module import flatten, unflatten
    from repro_torch.models.registry import classifier_loss
    from repro_torch.optim import AdamWConfig, apply_updates

    leaves = list(flatten(params).values())
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits, _ = model.forward(params, {"images": images})
            loss = classifier_loss(logits, labels)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    grads = unflatten(dict(zip(flatten(params), grads)))
    params, opt, m = apply_updates(params, grads, opt,
                                   AdamWConfig(lr=1e-3, weight_decay=0.01))
    return params, opt, loss.detach(), m["grad_norm"]


def cnn(device):
    """VGG-16 (published widths) and LeNet-5 in bf16 under PC3_TR on the
    kernel: one forward against the jnp backend's forward on the card,
    3 straight-through and 1 approximate-backward train steps. Returns
    (records, GEMM kernel launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.data import image_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.models.cnn import CNNModel
    from repro_torch.optim import init_state
    from repro_torch.policy import ApproxPolicy

    records, launches = {}, 0
    for net, batch, shape, noise, seed in CNN_RUNS:
        base = dataclasses.replace(get_config(net), param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        kern = CNNModel(base.with_policy(GEN_POLICY), device=device)
        approx = CNNModel(base.with_policy(ApproxPolicy.uniform(DaismConfig(
            variant=Variant.PC3_TR, backend=Backend.PALLAS,
            backward="approx"))), device=device)
        plain = CNNModel(base.with_policy("*=pc3_tr"), device=device)
        params = kern.init(0)
        b = next(image_batches(10, batch, shape=shape, noise=noise,
                               seed=seed))
        images = torch.from_numpy(b["images"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        per_fwd = cnn_kernel_sites(kern)
        opt = init_state(params)

        dm.launches = 0
        with torch.no_grad():
            kern.forward(params, {"images": images})  # first use (warm-up)
            _sync(device)
            t0 = time.perf_counter()
            got, _ = kern.forward(params, {"images": images})
            _sync(device)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        n_fwd = dm.launches
        if n_fwd != 2 * per_fwd:
            raise SystemExit(f"{net}: a forward launched {n_fwd / 2:g} "
                             f"GEMMs, the sites imply {per_fwd}")
        # the plain version: the jnp backend on the card, same weights and
        # images (it launches no kernel)
        with torch.no_grad():
            ref, _ = plain.forward(params, {"images": images})
            _sync(device)
        if dm.launches != n_fwd:
            raise SystemExit(f"{net}: the jnp backend launched the kernel")
        if got.shape != (batch, 10) or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"{net}: logits not finite or shaped "
                             f"{tuple(got.shape)}")
        rel, agree, clear_ok, n_clear = _logit_agreement(got, ref)
        log(f"  {net} B={batch} bf16: forward {fwd_ms:.2f} ms, daism_matmul "
            f"launches {per_fwd} a forward ({per_fwd} sites); kernel vs jnp "
            f"backend max |diff| / max |ref| {rel:.4g} (bound "
            f"{CNN_BF16_REL[net]:g}); labels agree on {agree * 100:.1f}% of "
            f"rows, on all {n_clear} rows whose top-2 gap exceeds the "
            f"deviation: {clear_ok}")
        if rel > CNN_BF16_REL[net] or not clear_ok:
            raise SystemExit(f"{net}: the kernel's forward and the jnp "
                             "backend's disagree beyond the bound")
        del got, ref
        steps = []
        plan = [("ste", kern, per_fwd)] * 3 + [("approx", approx,
                                                  3 * per_fwd)]
        for label, model, want in plan:
            d0 = dm.launches
            t0 = time.perf_counter()
            params, opt, loss, gnorm = cnn_step(model, params, opt, images,
                                                labels)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            n = dm.launches - d0
            steps.append(dict(backward=label, ms=ms, loss=float(loss),
                              launches=n))
            log(f"  {net} train step ({label:6s} backward) {ms:9.2f} ms  "
                f"loss {float(loss):.4f}  grad_norm {float(gnorm):.4f}  "
                f"daism_matmul launches {n} (sites imply {want})")
            if not (math.isfinite(float(loss)) and math.isfinite(
                    float(gnorm))) or n != want:
                raise SystemExit(f"{net} train step: loss {float(loss)}, "
                                 f"{n} launches where {want} are implied")
        n_all = dm.launches
        launches += n_all
        records[net] = dict(batch=batch, fwd_ms=fwd_ms, per_fwd=per_fwd,
                            rel=rel, steps=steps, launches=n_all)
        del params, opt
        _free(device)
    return records, launches


def c1_conv(device):
    """An f32 exact ``conv2d_im2col`` on the card against the CPU's while
    ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default; the
    script keeps it off elsewhere): within C1_RTOL (and C1_RTOL of the
    largest output). A control, the same convolution by ``F.conv2d`` with
    TF32 allowed, must break that bound (cuDNN then rounds to TF32).
    Returns (deviation, control's deviation), each / max |CPU output|."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.core.gemm import conv2d_im2col

    b, side, cin, cout, k = C1_CONV
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, side, side, cin), generator=g)
    w = torch.randn((k, k, cin, cout), generator=g) / math.sqrt(k * k * cin)
    exact = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)
    ref = conv2d_im2col(x, w, exact)
    xd, wd = x.to(device), w.to(device)
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        got = conv2d_im2col(xd, wd, exact).cpu()
        if not cudnn.allow_tf32:
            raise SystemExit("conv2d_im2col left cudnn.allow_tf32 changed")
        ctl = F.conv2d(xd.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1),
                       padding=k // 2).permute(0, 2, 3, 1).cpu()
    finally:
        cudnn.allow_tf32 = prev
    top = ref.abs().max().item()
    dev = (got - ref).abs().max().item() / top
    ctl_dev = (ctl - ref).abs().max().item() / top
    held = bool(((got - ref).abs() <= C1_RTOL * top
                 + C1_RTOL * ref.abs()).all())
    broke = not bool(((ctl - ref).abs() <= C1_RTOL * top
                      + C1_RTOL * ref.abs()).all())
    log(f"  C1: f32 exact conv {C1_CONV} with cudnn.allow_tf32=True: card vs "
        f"CPU max |diff| / max |ref| {dev:.3g} (bound {C1_RTOL:g} + "
        f"{C1_RTOL:g} |ref|): {held}; control F.conv2d in TF32 "
        f"{ctl_dev:.3g}, breaks it: {broke}")
    if not (held and broke):
        raise SystemExit("C1: the f32 exact conv on the card is not full f32 "
                         "(or the control did not run in TF32)")
    return dev, ctl_dev


# ---------------------------------------------------------------------------
# phase 11: serve with preemption and speculation; the energy report
# ---------------------------------------------------------------------------

def engine_run(model, params, ecfg, reqs, device):
    """Serve ``reqs`` on a fresh engine and check each request completes
    at its length and the GEMM kernel launched what the steps imply
    (prefill, decode and verify steps by each group's sites, draft steps
    by the draft model's). Returns (engine, report, launches)."""
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, params, ecfg, device=device)
    dm.launches = 0
    report = engine.run(reqs)
    _sync(device)
    launches = dm.launches
    for st in report.completed:
        if len(st.output) != st.request.max_new_tokens:
            raise SystemExit(f"request {st.request_id} produced "
                             f"{len(st.output)} of {st.request.max_new_tokens}")
    if len(report.completed) != len(reqs):
        raise SystemExit(f"{len(report.completed)} of {len(reqs)} completed")
    expected = sum(report.group_steps[g.label] * approx_launches_per_step(
        g.model) for g in engine.groups.values())
    if engine._draft_model is not None:
        expected += sum(report.group_draft_steps.values()) * \
            approx_launches_per_step(engine._draft_model)
    if launches != expected or launches == 0:
        raise SystemExit(f"daism_matmul launched {launches} times; the steps "
                         f"imply {expected} ({report.group_steps}, drafts "
                         f"{report.group_draft_steps})")
    return engine, report, launches


def replay_logits(model, params, ecfg, prompt, feed, device, window=(),
                  cached_len=0):
    """One request's plain path through ``model``, alone in row 0 of a
    fresh pool at the engine's shapes (num_slots rows, zero-padded
    prefill chunks): its prompt, then one S=1 step per token of ``feed``.
    A request that adopted ``cached_len`` prompt positions from the prefix
    cache is prefilled as the engine did it: the chunks from 0 that wrote
    the cached pages (another request with the same prompt), then chunks
    from ``cached_len``.
    Returns (logits (1 + len(feed), V) in f32 — row 0 from the prefill's
    last prompt position, row j from the step that fed feed[j - 1] — and,
    with ``window``, the S = len(window) verify step's logits over the
    prefilled prompt; ms per S=1 step and of the verify step)."""
    import torch

    r, bs, chunk = ecfg.num_slots, ecfg.block_size, ecfg.prefill_chunk
    table = torch.full((r, ecfg.max_blocks_per_seq), -1, dtype=torch.int32,
                       device=device)
    table[0] = torch.arange(ecfg.max_blocks_per_seq, device=device)

    def step(kv, toks, pos, width):
        t = torch.zeros((r, width), dtype=torch.long, device=device)
        t[0, :len(toks)] = torch.tensor(toks, device=device)
        p = torch.zeros((r,), dtype=torch.int32, device=device)
        p[0] = pos
        logits, _ = model.paged_step(params, t, dict(kv, block_tables=table,
                                                     pos=p), block_size=bs)
        return logits[0].float()

    rows, step_ms, verify = [], [], None
    with torch.inference_mode():
        kv = model.init_paged_cache(ecfg.blocks, bs)
        for lo in (list(range(0, cached_len, chunk))
                   + list(range(cached_len, len(prompt), chunk))):
            piece = prompt[lo:lo + chunk]
            last = step(kv, piece, lo, chunk)[len(piece) - 1]
        rows.append(last)
        if window:
            kv2 = {n: t.clone() for n, t in kv.items()}
            _sync(device)
            t0 = time.perf_counter()
            verify = step(kv2, list(window), len(prompt), len(window))
            _sync(device)
            verify_ms = (time.perf_counter() - t0) * 1e3
            del kv2
        for j, tok in enumerate(feed):
            _sync(device)
            t0 = time.perf_counter()
            rows.append(step(kv, [tok], len(prompt) + j, 1)[0])
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return (torch.stack(rows), verify, step_ms,
            verify_ms if window else None)


def serve_more(device, cfg):
    """Phase 11 at full width: (a) preemption against reservation, (b)
    speculation against plain decode through phase 4's tiers, (c) both
    together on (a)'s pool, (d) the energy report. Returns (records,
    GEMM kernel launches of the engine runs)."""
    import numpy as np
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.policy import estimated_energy_uj
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    records, launches = {}, 0
    model = build_model(cfg.with_policy(GEN_POLICY), device=device)
    with torch.inference_mode():
        params = model.init(seed=0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in PREEMPT_LENS]

    def burst():
        return [Request(prompt=p, max_new_tokens=PREEMPT_TOTAL - len(p))
                for p in prompts]

    # (a) preemption against whole-lifetime reservation
    outs = {}
    for preempt in (True, False):
        ecfg = EngineConfig(**PREEMPT_ENGINE, preempt=preempt)
        engine, rep, n = engine_run(model, params, ecfg, burst(), device)
        launches += n
        outs[preempt] = [st.output for st in rep.completed]
        label = "preempt" if preempt else "reserve"
        records[label] = dict(tok_s=rep.tokens_per_s,
                              preemptions=rep.preemptions,
                              peak_active=rep.peak_active_requests)
        log(f"  (a) {label}: {len(rep.completed)} requests at their lengths "
            f"in {rep.wall_s:.2f} s, {rep.tokens_per_s:.1f} decode tok/s, "
            f"step p50 {rep.step_p50_ms:.2f} ms, peak concurrency "
            f"{rep.peak_active_requests}, {rep.preemptions} preemption(s) / "
            f"{rep.resumes} resume(s), daism_matmul launches {n} as implied")
        if preempt and not (rep.preemptions >= 1
                            and rep.resumes == rep.preemptions):
            raise SystemExit(f"(a): {rep.preemptions} preemptions, "
                             f"{rep.resumes} resumes")
        del engine
    same = sum(a == b for a, b in zip(outs[True], outs[False]))
    log(f"  (a) preempt vs reserve: {same} of {len(prompts)} requests "
        "token-identical")
    if same != len(prompts):
        raise SystemExit("(a): preemption changed the tokens")

    # (b) speculation against plain decode, phase 4's tiers and requests
    base = build_model(cfg, device=device)
    tiered = dict(num_slots=4, block_size=16, prefill_chunk=32, max_seq=128,
                  tiers=TIERS)
    runs = {}
    for spec in (False, True):
        ecfg = EngineConfig(**tiered, **(dict(spec_draft="free", spec_k=SPEC_K)
                                         if spec else {}))
        runs[spec] = engine_run(base, params, ecfg, serve_requests(cfg.vocab),
                                device)
        launches += runs[spec][2]
    (_, plain, _), (spec_engine, spec, spec_n) = runs[False], runs[True]
    groups = {g.label: g for g in spec_engine.groups.values()}
    log(f"  (b) plain: {plain.tokens_per_s:.1f} decode tok/s, step p50 "
        f"{plain.step_p50_ms:.2f} ms, wall {plain.wall_s:.2f} s; speculative "
        f"(k = {SPEC_K}): {spec.tokens_per_s:.1f} decode tok/s, tick p50 "
        f"{spec.step_p50_ms:.2f} ms, wall {spec.wall_s:.2f} s, "
        f"{spec.spec_steps} verify steps, accept rate "
        f"{spec.spec_accept_rate:.3f}, {spec.spec_tokens_per_step:.3f} tokens "
        f"a row-verify, draft steps {spec.group_draft_steps}, launches "
        f"{spec_n} as implied")
    if not (spec.spec_steps >= 1 and groups["free"].spec_on is False
            and spec.group_draft_steps["free"] == 0
            and spec.spec_tokens_per_step >= 1.0
            and 0.0 <= spec.spec_accept_rate <= 1.0):
        raise SystemExit("(b): speculation did not run as specified")
    paid = groups["paid"].model
    dev, verify_ms, step_ms = 0.0, [], []
    for st in plain.completed:
        if st.group != "paid" or len(st.output) <= SPEC_K + 1:
            continue
        window = st.output[:SPEC_K + 1]
        seq, ver, ms, vms = replay_logits(paid, params, spec_engine.cfg,
                                          st.request.prompt, window, device,
                                          window=window,
                                          cached_len=st.cached_len)
        dev = max(dev, (ver - seq[1:]).abs().max().item())
        verify_ms.append(vms)
        step_ms += ms
    equal = total = 0
    firsts = []
    for p_st, s_st in zip(plain.completed, spec.completed):
        a, b = p_st.output, s_st.output
        total += len(a)
        equal += sum(x == y for x, y in zip(a, b))
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        model_i = groups[p_st.group].model
        seq, _, _, _ = replay_logits(model_i, params, spec_engine.cfg,
                                     p_st.request.prompt, a[:i], device,
                                     cached_len=p_st.cached_len)
        top2 = seq[i].topk(2).values
        gap = (top2[0] - top2[1]).item()
        firsts.append((p_st.request_id, p_st.group, i, gap))
        if gap > dev:
            raise SystemExit(f"(b): request {p_st.request_id} diverges at "
                             f"token {i}, where the plain step's top-2 gap "
                             f"{gap:.4g} exceeds the verify-vs-step "
                             f"deviation {dev:.4g}")
    verify_p50 = sorted(verify_ms)[len(verify_ms) // 2]
    step_p50 = sorted(step_ms)[len(step_ms) // 2]
    log(f"  (b) paged_verify_step (S = {SPEC_K + 1}) vs {SPEC_K + 1} S=1 "
        f"paged_steps on the same prefix (paid tier): max |logit diff| "
        f"{dev:.4g}; verify step {verify_p50:.2f} ms, S=1 step {step_p50:.2f}"
        f" ms (p50, {spec_engine.cfg.num_slots} rows, host clock after a "
        f"sync); tokens equal {equal} of {total} "
        f"({100 * equal / total:.1f}%); first divergences (request, tier, "
        f"token, top-2 gap <= deviation): {firsts}")
    records["spec"] = dict(
        plain_tok_s=plain.tokens_per_s, spec_tok_s=spec.tokens_per_s,
        accept_rate=spec.spec_accept_rate, verify_ms=verify_p50,
        step_ms=step_p50)

    # (c) speculation and preemption together on (a)'s pool
    both = build_model(cfg.with_policy(TIERS[1][1]), device=device)
    ecfg = EngineConfig(**PREEMPT_ENGINE, preempt=True,
                        spec_draft=TIERS[0][1], spec_k=SPEC_K)
    engine, rep, n = engine_run(both, params, ecfg, burst(), device)
    launches += n
    in_use = engine.pool.stats()["blocks_in_use"]
    log(f"  (c) speculation + preemption: {rep.preemptions} preemption(s) / "
        f"{rep.resumes} resume(s), {rep.spec_steps} verify steps, accept rate "
        f"{rep.spec_accept_rate:.3f}; blocks in use after the run {in_use}; "
        f"launches {n} as implied")
    if in_use != 0 or rep.resumes != rep.preemptions:
        raise SystemExit("(c): the pool did not drain")
    del engine

    # (d) the per-site energy report of (b)'s speculative run
    log("  (d) estimated multiply energy: the paper's analytical 45 nm model "
        "(core/energy.py) over the sites served, not a reading of the card")
    log("  " + spec_engine.resolution_report().replace("\n", "\n  "))
    saves = {}
    for label, g in groups.items():
        tot, exact = estimated_energy_uj(g.model.cfg.approx_policy)
        saves[label] = 1 - tot / exact
    # an all-exact run (no kernel launches): its estimate saves nothing
    exact_model = build_model(cfg.with_policy("*=exact"), device=device)
    ServeEngine(exact_model, params, EngineConfig(
        num_slots=4, block_size=16, max_seq=64, prefill_chunk=32),
        device=device).run([Request(prompt=prompts[0], max_new_tokens=4)])
    tot, exact = estimated_energy_uj(exact_model.cfg.approx_policy)
    saves["all-exact"] = 1 - tot / exact
    log("  (d) estimated multiply energy saved vs all-exact: "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in saves.items()))
    if not (saves["free"] > saves["paid"] > 0 and saves["all-exact"] == 0.0):
        raise SystemExit(f"(d): savings {saves} out of order")
    records["energy_saves"] = saves
    del spec_engine, runs, params, model, base, both, exact_model
    _free(device)
    return records, launches


# ---------------------------------------------------------------------------
# phase 12: the decoder-only zoo at published widths
# ---------------------------------------------------------------------------

def _zoo_model(device, arch, layers, policy):
    """(model, params) of ``arch`` at its published width, ``layers`` deep
    (None: all), random bf16 weights from seed 0, drawn on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.module import flatten
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    full = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = cfg.with_policy(policy)
    torch.zeros((), device=device)  # the allocator keeps no stats before
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    with torch.inference_mode():
        params = model.init(seed=0)
    _sync(device)
    n = sum(t.numel() for t in flatten(params).values())
    log(f"  {arch}: {cfg.n_layers} of {full} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.kv_heads} x {cfg.head_dim}, "
        + (f"{cfg.n_experts} experts top-{cfg.topk} x {cfg.expert_ff}, "
           if cfg.n_experts else f"d_ff {cfg.d_ff}, ")
        + f"vocab {cfg.vocab}: {n / 1e9:.3f}e9 params drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def _peak_gib(device) -> float:
    import torch

    return torch.cuda.max_memory_allocated(device) / 2**30


def _checked_forward(model, params, batch, label, device, flash=0):
    """One forward through ``prefill_step``'s path (no grad): finite logits
    of the expected shape, the GEMM kernel launched once a site and flash
    ``flash`` times. Returns (logits, aux, seconds, GEMM launches)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa

    b, s = batch["tokens"].shape
    dm.launches = fa.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    _sync(device)
    sec = time.perf_counter() - t0
    gemm_n, flash_n = dm.launches, fa.launches
    want = approx_launches_per_step(model)
    if (gemm_n, flash_n) != (want, flash):
        raise SystemExit(f"{label}: daism_matmul launched {gemm_n} (sites "
                         f"imply {want}), flash {flash_n} (expected {flash})")
    if logits.shape != (b, s, model.cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            not bool(torch.isfinite(aux)):
        raise SystemExit(f"{label}: logits not finite or shaped "
                         f"{tuple(logits.shape)}")
    return logits, aux, sec, gemm_n


def slot_logits(model, params, prompt, feed, max_seq, device):
    """One request through a fresh B = 1 slot cache: ``prefill`` of its
    prompt, then one ``decode_step`` per token of ``feed``. Returns (1 +
    len(feed), V) f32 logits, row j predicting the token after feed[j - 1]
    (row 0: after the prompt)."""
    import torch

    with torch.inference_mode():
        cache = model.init_cache(1, max_seq)
        logits, cache = model.prefill(
            params, torch.tensor([prompt], device=device), cache)
        rows = [logits[0, -1].float()]
        for tok in feed:
            logits, cache = model.decode_step(
                params, torch.tensor([[tok]], device=device), cache)
            rows.append(logits[0, 0].float())
    return torch.stack(rows)


def router_rows(device, w):
    """The MoE router's rows at M = 1 to 2048 against the same rows inside
    an M = 2048 call: the library f32 GEMM (``x @ w``) and the port's
    ``router_logits`` (one GEMM shape whatever M). Returns {M: (elements of
    rows 0..M-1 that differ from the M = 2048 call, max |diff|)} for each."""
    import torch

    from repro_torch.models.moe import router_logits

    gen = torch.Generator(device=device).manual_seed(13)
    x = torch.randn((2048, w.shape[0]), generator=gen, device=device).to(
        torch.bfloat16)
    found = {}
    for label, fn in (("x @ w", lambda t: t.float() @ w),
                      ("router_logits", lambda t: router_logits(t, w))):
        big = fn(x)
        for m in ZOO_ROUTER_M:
            d = (fn(x[:m]) - big[:m]).abs()
            found[(label, m)] = (int((d != 0).sum()), d.max().item())
    return found


def zoo_moe_serve(device):
    """(a): Qwen3-MoE at 2 layers through the paged engine; tokens against
    a slot-cache decode_step replay; the router's M-invariance."""
    import torch

    from repro_torch.serve import EngineConfig, Request

    model, params = _zoo_model(device, "qwen3_moe_235b", 2, GEN_POLICY)
    cfg = model.cfg
    rng = __import__("numpy").random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in ZOO_PROMPTS]
    ecfg = EngineConfig(**ZOO_ENGINE)
    engine, rep, launches = engine_run(
        model, params, ecfg,
        [Request(prompt=p, max_new_tokens=ZOO_GEN) for p in prompts], device)
    log(f"  (a) served {len(rep.completed)} requests (prompts {ZOO_PROMPTS}, "
        f"{ZOO_GEN} tokens each) in {rep.wall_s:.2f} s: "
        f"{rep.tokens_per_s:.1f} decode tok/s, TTFT p50 "
        f"{rep.ttft_p50_ms:.1f} ms, step p50 {rep.step_p50_ms:.2f} ms; "
        f"daism_matmul launches {launches} as the steps imply "
        f"({approx_launches_per_step(model)} a step: 3 expert GEMMs a layer, "
        f"one launch each for all {cfg.n_experts} experts)")
    # the engine's tokens against a slot-cache decode_step run of each
    # request, wherever that run's top-2 gap exceeds the measured deviation
    # of the paged path (alone in row 0 at the engine's shapes) from it
    dev, slots = 0.0, []
    for st in rep.completed:
        feed = st.output[:-1]
        paged, _, _, _ = replay_logits(model, params, ecfg, st.request.prompt,
                                       feed, device, cached_len=st.cached_len)
        slot = slot_logits(model, params, st.request.prompt, feed,
                           ecfg.max_seq, device)
        dev = max(dev, (paged - slot).abs().max().item())
        slots.append(slot)
    equal = total = clear = 0
    for st, slot in zip(rep.completed, slots):
        top2 = slot.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        want = slot.argmax(-1).tolist()
        for tok, ref, g in zip(st.output, want, gap.tolist()):
            total += 1
            equal += tok == ref
            if g > dev:
                clear += 1
                if tok != ref:
                    raise SystemExit(
                        f"(a): request {st.request_id} emits {tok} where the "
                        f"slot-cache run's greedy token {ref} leads by "
                        f"{g:.4g} > the paged-vs-slot deviation {dev:.4g}")
    log(f"  (a) engine vs slot-cache decode_step: paged-vs-slot max |logit "
        f"diff| {dev:.4g}; tokens equal {equal} of {total}, all {clear} whose "
        f"top-2 gap exceeds the deviation")
    found = router_rows(device, params["blocks"]["ffn"]["router"][0])
    for label in ("x @ w", "router_logits"):
        log(f"  (a) router rows vs an M = 2048 call, {label}: " + ", ".join(
            f"M={m}: {found[(label, m)][0]} differ (max "
            f"{found[(label, m)][1]:.3g})" for m in ZOO_ROUTER_M))
    if any(found[("router_logits", m)][0] for m in ZOO_ROUTER_M):
        raise SystemExit("(a): router_logits rows depend on M")
    peak = _peak_gib(device)
    log(f"  (a) peak device memory {peak:.2f} GiB")
    rec = dict(tok_s=rep.tokens_per_s, ttft_p50_ms=rep.ttft_p50_ms,
               step_p50_ms=rep.step_p50_ms, dev=dev, equal=equal,
               total=total, router=found, peak_gib=peak)
    del engine, params, model, slots
    _free(device)
    return rec, launches


def zoo_experts(device):
    """(c): the expert GEMM at Qwen3-MoE's and DBRX's shapes: one launch
    for all experts, bit for bit against E 2-D launches and (first and
    last expert) against daism_matmul_ordered, within gemm_rtol(K) of the
    plain version on those two, timed against its bound."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(14)
    rows = []
    for label, e, k, n, shared in ZOO_EXPERT_GEMMS:
        w = torch.randn((e, k, n), generator=gen, device=device).to(
            torch.bfloat16)
        for c in ZOO_EXPERT_C:
            rows.append(expert_row(device, gen, "(c)", label, w, c, shared))
        del w
    _free(device)
    return rows


def expert_row(device, gen, tag, label, w, c, shared):
    """The expert GEMM (E, C, K) @ (E, K, N) in PC3_TR on random tokens
    (broadcast over the experts when ``shared``): one launch for all
    experts, bit for bit against E 2-D launches and (first and last
    expert) against daism_matmul_ordered, within gemm_rtol(K) of the plain
    version on those two, timed against its bound; the row."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    var = Variant.PC3_TR
    e, k, n = w.shape
    if shared:  # the dense MoE's broadcast tokens: expert stride 0
        x = torch.randn((c, k), generator=gen, device=device).to(
            torch.bfloat16)[None].expand(e, c, k)
    else:
        x = torch.randn((e, c, k), generator=gen, device=device).to(
            torch.bfloat16)
    ms, got = cuda_time_ms(
        lambda: dm.daism_matmul_experts_kernel(x, w, var), 3)
    per = torch.stack([dm.daism_matmul_kernel(x[i].contiguous(), w[i],
                                              var) for i in range(e)])
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), per.view(torch.int32)):
        raise SystemExit(f"{tag} {label} C={c}: the expert launch "
                         "differs from per-expert 2-D launches")
    plain_ms, err = [], 0.0
    for i in (0, e - 1):
        a = x[i].contiguous()
        ordered = dm.daism_matmul_ordered(a, w[i], var)
        t, ref = cuda_time_ms(lambda: dm.daism_matmul_plain(
            a, w[i], var), 1, warmup=0)
        plain_ms.append(t)
        if not torch.equal(got[i].view(torch.int32),
                           ordered.view(torch.int32)):
            raise SystemExit(f"{tag} {label} C={c}: expert {i} differs "
                             "from daism_matmul_ordered")
        err = max(err, gemm_held(got[i], ref, a, w[i],
                                 f"{tag} {label} C={c} e={i}")[0])
    nbytes = (2 * (c * k if shared else e * c * k) + 2 * e * k * n
              + 4 * e * c * n)
    ops = OPS_PER_MAC["pc3_tr"] * e * c * k * n
    b_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    b_by = ("operations" if ops / INT32_OPS_PER_S
            >= nbytes / HBM_BYTES_PER_S else "bytes")
    plan = dm._plan(c, k, n, var, experts=e)
    path = "tile" if plan is None else f"splitk {plan}"
    log(f"  {tag} {label:12s} (E={e}, C={c}, {k}, {n}) pc3_tr, {path}: "
        f"kernel {ms:9.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms * 100:5.1f}% of bound; all {e} experts equal "
        f"their 2-D launches bit for bit, experts 0 and {e - 1} equal "
        f"daism_matmul_ordered and the plain version "
        f"({sum(plain_ms) / 2:.1f} ms an expert) within gemm_rtol")
    return dict(label=label, e=e, c=c, k=k, n=n, ms=ms,
                plain_ms_per_expert=sum(plain_ms) / 2, bound_ms=b_ms,
                bound_by=b_by, path=path, max_abs_err=err)


def zoo_dense(device):
    """(b) DBRX's forward, (d) Gemma-2B: forward under phase 5's policies,
    the tied lm_head's transpose, a short paged serve; (e) StarCoder2-15B
    and Nemotron-4-340B forwards; (f) Llama-3.2-Vision: forward and
    decode_steps with image embeddings against it. Returns (records, GEMM
    launches, flash launches)."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.serve import EngineConfig, Request

    recs, gemm_n, flash_n = {}, 0, 0

    def tokens(vocab, s, b=1, seed=0):
        return torch.from_numpy(next(lm_batches(vocab, b, s, seed=seed))[
            "tokens"]).to(device).long()

    # (b) DBRX at 2 of 40 layers: one forward, B = 1, S = 256
    model, params = _zoo_model(device, "dbrx_132b", 2, GEN_POLICY)
    _, aux, sec, n = _checked_forward(
        model, params, {"tokens": tokens(model.cfg.vocab, 256)}, "(b) dbrx",
        device)
    gemm_n += n
    recs["dbrx"] = dict(ms=sec * 1e3, aux=aux.item(), peak_gib=_peak_gib(device))
    log(f"  (b) dbrx_132b forward B=1 S=256 pc3_tr: {sec * 1e3:.1f} ms, aux "
        f"{aux.item():.4f}, {n} launches as the sites imply, peak "
        f"{recs['dbrx']['peak_gib']:.2f} GiB")
    del model, params
    _free(device)

    # (d) Gemma-2B, all 18 layers (head dim 256, MQA, tied embeddings)
    model, params = _zoo_model(device, "gemma_2b", None, GEN_POLICY)
    cfg = model.cfg
    batch = {"tokens": tokens(cfg.vocab, ZOO_GEMMA_SEQ)}
    logits, res = {}, {}
    for label, spec in PREFILL_POLICIES:
        art = build_artifacts(cfg.with_policy(spec), device=device)
        out, _, sec, n = _checked_forward(
            art.model, params, batch, f"(d) gemma {label}", device,
            flash=cfg.n_layers if ":flash" in spec else 0)
        gemm_n += n
        flash_n += cfg.n_layers if ":flash" in spec else 0
        logits[label] = out
        res[label] = sec * 1e3
        log(f"  (d) gemma_2b {label:27s} B=1 S={ZOO_GEMMA_SEQ}: "
            f"{sec * 1e3:9.1f} ms")
    for (a, b), lim in ((("flash exact, exact GEMMs",
                          "jnp attention, exact GEMMs"), PREFILL_EXACT_REL),
                        (("flash exact", "jnp attention"), PREFILL_APPROX_REL)):
        rel, agree, clear_ok, n_clear = _logit_agreement(logits[a], logits[b])
        res[f"{a} vs {b}"] = rel
        log(f"  (d) {a!r} vs {b!r}: max |diff| / max |ref| {rel:.4g} (bound "
            f"{lim:g}); greedy tokens agree on {agree * 100:.2f}% of rows, on "
            f"all {n_clear} rows whose top-2 gap exceeds the deviation: "
            f"{clear_ok}")
        if rel > lim or not clear_ok:
            raise SystemExit(f"(d): {a!r} and {b!r} disagree beyond the bound")
    del logits
    # the tied lm_head: unembed keeps embedding.T (layers.tied_lm_head).
    # What a copy costs, and the serve with it kept against a copy at every
    # call (the unembed before it), alternating; the tokens must not move
    from repro_torch.models import layers

    emb = params["embedding"]
    t_ms, _ = cuda_time_ms(lambda: emb.t().contiguous(), 5)
    ecfg = EngineConfig(**ZOO_ENGINE)
    rng = __import__("numpy").random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, size=16).tolist() for _ in range(4)]
    kept = layers.tied_lm_head
    step_ms, outs = {"kept": [], "per call": []}, {}
    for label in ("kept", "per call") * ZOO_LM_HEAD_PAIRS:
        layers.tied_lm_head = kept if label == "kept" else (
            lambda e: e.t().contiguous())
        try:
            engine, rep, n = engine_run(
                model, params, ecfg, [Request(prompt=p, max_new_tokens=16)
                                      for p in prompts], device)
        finally:
            layers.tied_lm_head = kept
        gemm_n += n
        step_ms[label].append(rep.step_p50_ms)
        outs.setdefault(label, [st.output for st in rep.completed])
        del engine
    if outs["kept"] != outs["per call"]:
        raise SystemExit("(d): the kept lm_head transpose changed the tokens")
    res.update(transpose_ms=t_ms, serve_tok_s=rep.tokens_per_s,
               step_ms=step_ms, peak_gib=_peak_gib(device))
    log(f"  (d) gemma_2b serve: 4 requests x 16 tokens, {n} launches as "
        f"implied a run; a copy of the tied lm_head's transpose "
        f"({tuple(emb.shape)} bf16) takes {t_ms:.3f} ms; decode step p50 "
        f"with embedding.T kept " + " / ".join(
            f"{x:.2f}" for x in step_ms["kept"]) + " ms, copied at every "
        "call " + " / ".join(f"{x:.2f}" for x in step_ms["per call"])
        + f" ms (alternating runs), tokens equal; peak "
        f"{res['peak_gib']:.2f} GiB")
    recs["gemma"] = res
    del model, params, emb
    _free(device)

    # (e) StarCoder2-15B at all 40 layers, Nemotron-4-340B at 2 of 96,
    # attention on the PC3_TR flash kernel (D = 128 and 192)
    label, spec = PREFILL_POLICIES[0]
    for arch, layers in (("starcoder2_15b", None), ("nemotron_4_340b", 2)):
        model, params = _zoo_model(device, arch, layers, spec)
        _, _, sec, n = _checked_forward(
            model, params, {"tokens": tokens(model.cfg.vocab, ZOO_DENSE_SEQ)},
            f"(e) {arch}", device, flash=model.cfg.n_layers)
        gemm_n += n
        flash_n += model.cfg.n_layers
        recs[arch] = dict(ms=sec * 1e3, peak_gib=_peak_gib(device))
        log(f"  (e) {arch} forward B=1 S={ZOO_DENSE_SEQ} {label}: "
            f"{sec * 1e3:.1f} ms, {n} GEMM and {model.cfg.n_layers} flash "
            f"launches as implied, peak {recs[arch]['peak_gib']:.2f} GiB")
        del model, params
        _free(device)

    # (f) Llama-3.2-Vision at 5 of 40 layers (one cross block)
    model, params = _zoo_model(device, "llama_3_2_vision_11b",
                               ZOO_VLM_LAYERS, GEN_POLICY)
    cfg = model.cfg
    art = build_artifacts(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(16)
    img = torch.randn((ZOO_VLM_BATCH, cfg.n_image_tokens, cfg.d_model),
                      generator=gen, device=device).to(torch.bfloat16)
    seq = tokens(cfg.vocab, ZOO_VLM_SEQ, b=ZOO_VLM_BATCH, seed=1)
    full, _, sec, n = _checked_forward(
        model, params, {"tokens": seq, "image_embeds": img}, "(f) vlm", device)
    gemm_n += n
    from repro_torch.kernels import daism_matmul as dm
    dm.launches = 0
    lo = ZOO_VLM_SEQ - ZOO_VLM_STEPS
    cache = art.init_cache(ZOO_VLM_BATCH, ZOO_VLM_SEQ)
    with torch.no_grad():
        _, cache = art.model.prefill(params, seq[:, :lo], cache,
                                     image_embeds=img)
    outs, step_ms = [], []
    for j in range(ZOO_VLM_STEPS):
        t0 = time.perf_counter()
        lg, cache = art.decode_step(params, seq[:, lo + j:lo + j + 1], cache,
                                    img)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg[:, 0])
    n = dm.launches
    gemm_n += n
    want = approx_launches_per_step(model) * (1 + ZOO_VLM_STEPS)
    if n != want:
        raise SystemExit(f"(f): daism_matmul launched {n}; prefill + "
                         f"{ZOO_VLM_STEPS} decode steps imply {want}")
    got = torch.stack(outs, 1)
    if not bool(torch.isfinite(got).all()):
        raise SystemExit("(f): decode logits not finite")
    rel, agree, clear_ok, n_clear = _logit_agreement(got, full[:, lo:])
    recs["vlm"] = dict(ms=sec * 1e3, rel=rel, agree=agree,
                       step_ms_p50=sorted(step_ms)[len(step_ms) // 2],
                       peak_gib=_peak_gib(device))
    log(f"  (f) llama_3_2_vision_11b ({cfg.n_layers} layers, "
        f"{model.n_cross} cross block, {cfg.n_image_tokens} image tokens) "
        f"forward B={ZOO_VLM_BATCH} S={ZOO_VLM_SEQ}: {sec * 1e3:.1f} ms; "
        f"prefill + {ZOO_VLM_STEPS} decode_steps with image_embeds: "
        f"{n} launches as implied, step p50 {recs['vlm']['step_ms_p50']:.2f}"
        f" ms; decode vs forward max |diff| / max |ref| {rel:.4g} (bound "
        f"{PREFILL_APPROX_REL:g}); greedy tokens agree on "
        f"{agree * 100:.2f}% of rows, on all {n_clear} rows whose top-2 gap "
        f"exceeds the deviation: {clear_ok}; peak "
        f"{recs['vlm']['peak_gib']:.2f} GiB")
    if rel > PREFILL_APPROX_REL or not clear_ok:
        raise SystemExit("(f): decode and forward disagree beyond the bound")
    del model, params, art, cache, full, got, img
    _free(device)
    return recs, gemm_n, flash_n


def zoo_flash(device, ptxas):
    """(g): flash at head dims 192 and 256 against the plain version (all
    seven variants, causal and not, ragged), the controls at both dims,
    timings at Gemma-2B's and Nemotron-4's heads; the large-D kernels'
    ptxas registers and spills."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    marks = {"flash_fwd NC=12": "EtLi12EE", "flash_fwd NC=16": "EtLi16EE",
             "flash_fwd f32 NC=12": "EfLi12EE",
             "flash_fwd f32 NC=16": "EfLi16EE",
             "flash_fwd_tc KD=12": "flash_fwd_tcILi12EE",
             "flash_fwd_tc KD=16": "flash_fwd_tcILi16EE"}
    spills = ptxas_summary(ptxas, marks)
    log("  (g) ptxas, largest over variants: " + "; ".join(
        f"{k} {r} registers, {sp} bytes spilled"
        for k, (r, sp, _) in spills.items()))
    gen = torch.Generator(device=device).manual_seed(17)
    variants = [None] + [v for v in Variant if v is not Variant.EXACT]
    errs = {"exact": 0.0, "exact_over_1ulp": -1.0, "approx": 0.0,
            "approx_over_2ulp": -1.0, "oracle": 0.0}
    n, ctrl = 0, {}
    for shape in ZOO_FLASH_CHECKS:
        q, k, v = _bhsd_inputs(gen, device, *shape)
        for causal in (True, False):
            if causal and shape[1] != shape[2]:
                continue
            for var in variants:
                got = fa.flash_attention_bhsd_kernel(q, k, v, causal=causal,
                                                     variant=var)
                ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                                    variant=var)
                torch.cuda.synchronize()
                _flash_held(got, ref, var, f"{shape} causal={causal} "
                            f"{var or 'exact'}", errs, v=v)
                n += 1
                if shape == ZOO_FLASH_CONTROL and causal:
                    ctrl[var.value if var else "exact"] = (got, ref)
    _flash_controls({name: ctrl[name][0] for name in ("exact", "fla")},
                    ctrl["pc3_tr"][1], f"{ZOO_FLASH_CONTROL}")
    del ctrl
    log(f"  (g) {n} cases at D = 192 / 256 within the bounds; max |kernel - "
        f"plain| exact {errs['exact']:.4g} (largest excess over one bf16 "
        f"rounding {errs['exact_over_1ulp']:.4g}), approximate "
        f"{errs['approx']:.4g} (largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g})")
    rows = []
    for arch, shape, heads in ZOO_FLASH_TIMED:
        b, s, _, h, kh, d = shape
        q, k, v = _bhsd_inputs(gen, device, *shape)
        # the plain version on the first `heads` query heads (their kv heads)
        kv_heads = heads // (h // kh)
        qp, kp, vp = q[:, :, :heads], k[:, :, :kv_heads], v[:, :, :kv_heads]
        qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(
            1, 2) for t in (q, k, v))
        outs, plains = {}, {}
        for name, var in (("exact", None), ("pc3_tr", Variant.PC3_TR),
                          ("fla", Variant.FLA)):
            ms, outs[name] = cuda_time_ms(lambda: fa.flash_attention_bhsd_kernel(
                q, k, v, variant=var), 3)
            if name == "fla":
                continue
            plain_ms, plains[name] = cuda_time_ms(
                lambda: fa.flash_attention_bhsd_plain(qp, kp, vp, variant=var),
                1, warmup=0)
            _flash_held(outs[name][:, :, :heads], plains[name], var,
                        f"{arch} {shape} {name}", errs, v=vp)
            lib_ms = None
            if var is None:
                lib_ms, _ = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True), 5)
            b_ms, b_by, ops = flash_bound(name, b, s, h, kh, d)
            rows.append(dict(arch=arch, variant=name, shape=list(shape),
                             ms=ms, plain_ms=plain_ms, plain_heads=heads,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
            log(f"  (g) flash {name:6s} {arch} B={b} S={s} H={h} KH={kh} "
                f"D={d} causal: kernel {ms:9.4f} ms, plain {plain_ms:9.1f} ms "
                f"({heads} of {h} heads), SDPA {lib} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms * 100:5.1f}% of bound")
        if arch == "gemma_2b":
            _flash_controls({"exact": outs["exact"], "fla": outs["fla"]},
                            plains["pc3_tr"], f"{arch} {shape}")
        del q, k, v, qs, ks, vs, outs, plains
    _free(device)
    return rows, max(errs["exact"], errs["approx"])


def _flash_controls(outs, pc3_plain, what, tag="(g)"):
    """The exact and FLA kernels' outputs against the PC3_TR plain output
    must break the approximate bound (phase 7's controls)."""
    from repro_torch.core.config import Variant

    for other, got in outs.items():
        err, excess, bnd = flash_excess(got, pc3_plain, Variant.PC3_TR)
        log(f"  {tag} control at {what}: {other} kernel vs pc3_tr plain: max "
            f"|diff| {err:.4g}, exceeds {bnd} by {excess:.4g}")
        if excess <= 0:
            raise SystemExit(f"flash control at {what}: the {other} kernel "
                             "passes the approximate bound against the pc3_tr "
                             "plain version")


def zoo(device, ptxas):
    """Phase 12; returns (records, GEMM launches, flash launches)."""
    recs = {}
    log("  (a) qwen3_moe_235b: the paged engine")
    recs["moe"], gemm_n = zoo_moe_serve(device)
    recs["dense"], n, flash_n = zoo_dense(device)
    gemm_n += n
    recs["experts"] = zoo_experts(device)
    recs["flash"], recs["flash_err"] = zoo_flash(device, ptxas)
    return recs, gemm_n, flash_n


# ---------------------------------------------------------------------------
# phase 13: the rest of the zoo (Whisper, xLSTM, Zamba) at published widths
# ---------------------------------------------------------------------------

def _counted(fn, label, device, gemm, flash=0):
    """Run ``fn`` with the kernels' counts set to 0 just before; they must
    read ``gemm`` and ``flash`` just after. Returns (fn's result, its
    seconds on the host clock after a sync)."""
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa

    dm.launches = fa.launches = 0
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    sec = time.perf_counter() - t0
    if (dm.launches, fa.launches) != (gemm, flash):
        raise SystemExit(f"{label}: daism_matmul launched {dm.launches} (the "
                         f"sites imply {gemm}), flash {fa.launches} "
                         f"(expected {flash})")
    return out, sec


def _finite_logits(logits, shape, label):
    import torch

    if tuple(logits.shape) != tuple(shape) or \
            not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{label}: logits not finite or shaped "
                         f"{tuple(logits.shape)} (expected {tuple(shape)})")


def _held(got, ref, lim, label, tag, min_clear=0):
    """Hold logits against a reference: max |diff| / max |ref| within
    ``lim`` and greedy tokens equal on every row whose top-2 gap exceeds
    the deviation, of which there must be ``min_clear``. Returns the
    relative deviation."""
    rel, agree, clear_ok, n_clear = _logit_agreement(got, ref)
    log(f"  {tag} {label}: max |diff| / max |ref| {rel:.4g} (bound {lim:g}); "
        f"greedy tokens agree on {agree * 100:.2f}% of rows, on all "
        f"{n_clear} rows whose top-2 gap exceeds the deviation: {clear_ok}")
    if rel > lim or not clear_ok:
        raise SystemExit(f"{tag} {label}: disagree beyond the bound")
    if n_clear < min_clear:
        raise SystemExit(f"{tag} {label}: {n_clear} rows have a top-2 gap "
                         f"above the deviation (at least {min_clear} needed)")
    return rel


def zoo_whisper(device):
    """(a): Whisper-large-v3 at full depth. Returns (records, GEMM
    launches, flash launches)."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts

    model, params = _zoo_model(device, "whisper_large_v3", None, GEN_POLICY)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(18)
    frames = torch.randn((1, cfg.enc_frames, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    tokens = torch.from_numpy(next(lm_batches(cfg.vocab, 1, WHISPER_SEQ,
                                              seed=3))["tokens"]).to(device)
    batch = {"tokens": tokens, "frames": frames}
    shape = (1, WHISPER_SEQ, cfg.vocab)
    flash_sites = cfg.enc_layers + 2 * cfg.n_layers
    recs, logits, gemm_n, flash_n = {}, {}, 0, 0
    for label, spec in WHISPER_POLICIES:
        art = build_artifacts(cfg.with_policy(spec), device=device)
        flash = flash_sites if ":flash" in spec else 0
        want = approx_launches_per_step(art.model)
        out, sec = _counted(lambda: art.prefill_step(params, batch),
                            f"(a) whisper {label}", device, want, flash)
        _finite_logits(out, shape, f"(a) whisper {label}")
        gemm_n += want
        flash_n += flash
        logits[label] = out
        recs[label] = sec * 1e3
        log(f"  (a) whisper {label:27s} B=1, {cfg.enc_frames} frames, "
            f"S={WHISPER_SEQ}: "
            f"{sec * 1e3:9.1f} ms, {want} GEMM and {flash} flash launches "
            "as the sites imply")
    for (a, b), lim in ((("flash exact, exact GEMMs",
                          "jnp attention, exact GEMMs"), PREFILL_EXACT_REL),
                        (("flash exact", "jnp attention"), PREFILL_APPROX_REL)):
        recs[f"{a} vs {b}"] = _held(logits[a], logits[b], lim,
                                    f"{a!r} vs {b!r}", "(a)")
    full = logits["jnp attention"]  # GEN_POLICY, as the decode below
    del logits
    # encode, then decode_steps from an empty cache over the same tokens
    art = build_artifacts(cfg, device=device)
    per_step = approx_launches_per_step(model, skip="encoder/")
    with torch.no_grad():
        enc, sec = _counted(lambda: model.encode(params, frames),
                            "(a) whisper encode", device,
                            approx_launches_per_step(model) - per_step)
    gemm_n += approx_launches_per_step(model) - per_step
    cache = art.init_cache(1, WHISPER_SEQ)
    cache["enc"] = enc
    outs, step_ms = [], []
    for j in range(WHISPER_STEPS):
        (lg, cache), st = _counted(
            lambda: art.decode_step(params, tokens[:, j:j + 1], cache),
            f"(a) whisper decode step {j}", device, per_step)
        gemm_n += per_step
        step_ms.append(st * 1e3)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    _finite_logits(got, (1, WHISPER_STEPS, cfg.vocab), "(a) whisper decode")
    recs.update(encode_ms=sec * 1e3, step_ms_p50=sorted(step_ms)[
        len(step_ms) // 2], step_launches=per_step, peak_gib=_peak_gib(device))
    log(f"  (a) whisper encode {sec * 1e3:.1f} ms; {WHISPER_STEPS} "
        f"decode_steps: {per_step} GEMM launches each as the sites imply "
        f"({2 * cfg.n_layers} of them the cross K/V at M = "
        f"{cfg.enc_frames}), step p50 {recs['step_ms_p50']:.2f} ms; peak "
        f"{recs['peak_gib']:.2f} GiB")
    recs["decode vs forward"] = _held(got, full[:, :WHISPER_STEPS],
                                      PREFILL_APPROX_REL,
                                      "decode_steps vs forward", "(a)")
    del model, params, art, cache, full, got, enc, frames
    _free(device)
    return recs, gemm_n, flash_n


def whisper_flash(device):
    """(a): flash alone at Whisper's two shapes, exact and PC3_TR against
    the plain version, the controls, times beside the bound and SDPA.
    Returns (rows, max |kernel - plain|)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(19)
    errs = {"exact": 0.0, "exact_over_1ulp": -1.0, "approx": 0.0,
            "approx_over_2ulp": -1.0}
    rows = []
    for label, shape in WHISPER_FLASH:
        b, sq, skv, h, kh, d = shape
        q, k, v = _bhsd_inputs(gen, device, *shape)
        qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(
            1, 2) for t in (q, k, v))
        outs, plains = {}, {}
        for name, var in (("exact", None), ("pc3_tr", Variant.PC3_TR),
                          ("fla", Variant.FLA)):
            ms, outs[name] = cuda_time_ms(lambda: fa.flash_attention_bhsd_kernel(
                q, k, v, causal=False, variant=var), 3)
            if name == "fla":
                continue
            plain_ms, plains[name] = cuda_time_ms(
                lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=False,
                                                      variant=var),
                1, warmup=0)
            _flash_held(outs[name], plains[name], var,
                        f"whisper {label} {shape} {name}", errs, v=v)
            lib_ms = None
            if var is None:
                lib_ms, _ = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs), 5)
            b_ms, b_by, ops = flash_bound(name, b, sq, h, kh, d, skv=skv,
                                          causal=False)
            rows.append(dict(site=label, variant=name, shape=list(shape),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by))
            lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
            log(f"  (a) flash {name:6s} whisper {label} B={b} Sq={sq} "
                f"Skv={skv} H={h} D={d} non-causal: kernel {ms:9.4f} ms, "
                f"plain {plain_ms:9.1f} ms, SDPA {lib} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), {b_ms / ms * 100:5.1f}% of bound")
        _flash_controls({"exact": outs["exact"], "fla": outs["fla"]},
                        plains["pc3_tr"], f"whisper {label} {shape}", "(a)")
        del q, k, v, qs, ks, vs, outs, plains
    log(f"  (a) flash at Whisper's shapes within the phase-3 bounds: max "
        f"|kernel - plain| exact {errs['exact']:.4g} (largest excess over "
        f"one bf16 rounding {errs['exact_over_1ulp']:.4g}), approximate "
        f"{errs['approx']:.4g} (largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g})")
    _free(device)
    return rows, max(errs["exact"], errs["approx"])


def rest_gemms(device):
    """The GEMM kernel at ZOO_REST_GEMMS, PC3_TR: held against the plain
    version (phase 3's bound) and timed beside its bound. Returns (rows,
    max |kernel - plain|)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(20)
    rows, max_err = [], 0.0
    for label, m, k, n in ZOO_REST_GEMMS:
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        ms, got = cuda_time_ms(lambda: dm.daism_matmul_kernel(a, w, "pc3_tr"),
                               10)
        plain_ms, ref = cuda_time_ms(lambda: dm.daism_matmul_plain(
            a, w, "pc3_tr"), 1, warmup=0)
        err, rel = gemm_held(got, ref, a, w, f"{label} ({m},{k},{n})")
        max_err = max(max_err, err)
        b_ms, b_by, _ = bound("pc3_tr", m, k, n)
        rows.append(dict(site=label, m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"  pc3_tr {label:27s} ({m:4d}, {k:4d}, {n:5d}): kernel "
            f"{ms:8.4f} ms, plain {plain_ms:9.2f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / ms * 100:5.1f}% of bound, |kernel - plain| "
            f"{rel:.3g} (|a|@|w|)")
        del a, w, got, ref
    _free(device)
    return rows, max_err


def zoo_recurrent(device, arch):
    """(b) / (c): xLSTM-1.3B or Zamba2-1.2B at full depth: forwards under
    PC3_TR and exact GEMMs, decode_steps from an empty cache against the
    forward. Returns (records, GEMM launches)."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts

    tag = "(b)" if arch == "xlstm_1_3b" else "(c)"
    model, params = _zoo_model(device, arch, None, GEN_POLICY)
    cfg = model.cfg
    tokens = torch.from_numpy(next(lm_batches(cfg.vocab, 1, RNN_SEQ, seed=4))[
        "tokens"]).to(device)
    recs, logits, gemm_n = {}, {}, 0
    for label, spec in (("pc3_tr", GEN_POLICY), ("exact", "*=exact")):
        art = build_artifacts(cfg.with_policy(spec), device=device)
        want = approx_launches_per_step(art.model)
        out, sec = _counted(lambda: art.prefill_step(params,
                                                     {"tokens": tokens}),
                            f"{tag} {arch} {label}", device, want)
        _finite_logits(out, (1, RNN_SEQ, cfg.vocab), f"{tag} {arch}")
        gemm_n += want
        logits[label] = out
        recs[f"{label}_ms"] = sec * 1e3
        log(f"  {tag} {arch} forward B=1 S={RNN_SEQ} {label} GEMMs: "
            f"{sec * 1e3:9.1f} ms, {want} GEMM launches as the sites imply")
    rel, _, _, _ = _logit_agreement(logits["pc3_tr"], logits["exact"])
    recs["pc3_tr_vs_exact"] = rel
    log(f"  {tag} {arch} PC3_TR vs exact GEMMs: max |diff| / max |ref| "
        f"{rel:.4g} (no bound: what the approximate products move)")
    art = build_artifacts(cfg, device=device)
    per_step = approx_launches_per_step(model)
    cache = art.init_cache(1, RNN_STEPS)
    outs, step_ms = [], []
    for j in range(RNN_STEPS):
        (lg, cache), st = _counted(
            lambda: art.decode_step(params, tokens[:, j:j + 1], cache),
            f"{tag} {arch} decode step {j}", device, per_step)
        gemm_n += per_step
        step_ms.append(st * 1e3)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    _finite_logits(got, (1, RNN_STEPS, cfg.vocab), f"{tag} {arch} decode")
    recs.update(step_ms_p50=sorted(step_ms)[len(step_ms) // 2],
                step_launches=per_step, peak_gib=_peak_gib(device))
    log(f"  {tag} {arch} {RNN_STEPS} decode_steps: {per_step} GEMM launches "
        f"each as the sites imply, step p50 {recs['step_ms_p50']:.2f} ms; "
        f"peak {recs['peak_gib']:.2f} GiB")
    recs["decode vs forward"] = _held(got, logits["pc3_tr"][:, :RNN_STEPS],
                                      PREFILL_APPROX_REL,
                                      f"{arch} decode_steps vs forward", tag)
    del model, params, art, cache, logits, got
    _free(device)
    return recs, gemm_n


def _to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu() if torch.is_tensor(tree) else tree


def zamba_ring(device):
    """(c): the shared block's ring cache on the card against the same
    steps on the CPU, f32 exact, 16 steps past a window of 8. Returns the
    largest relative deviation of the logits."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(
        get_config("zamba2_1_2b"), param_dtype="float32",
        compute_dtype="float32", **ZAMBA_RING).with_policy("*=exact")
    card, cpu = build_model(cfg, device=device), build_model(cfg, device="cpu")
    with torch.inference_mode():
        params = card.init(seed=0)
    params_cpu = _to_cpu(params)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab, size=(1, ZAMBA_RING_STEPS)))
    caches = {"card": card.init_cache(1, 4 * cfg.window),
              "cpu": cpu.init_cache(1, 4 * cfg.window)}
    outs = {"card": [], "cpu": []}
    with torch.inference_mode():
        for j in range(ZAMBA_RING_STEPS):
            for where, model, p in (("card", card, params),
                                    ("cpu", cpu, params_cpu)):
                t = toks[:, j:j + 1].to(model.device)
                lg, caches[where] = model.decode_step(p, t, caches[where])
                outs[where].append(lg[:, 0].cpu())
    ap_card = caches["card"]["attn_0"]["abs_pos"].cpu()
    ap_cpu = caches["cpu"]["attn_0"]["abs_pos"]
    want = list(range(ZAMBA_RING_STEPS - cfg.window, ZAMBA_RING_STEPS))
    if ap_card.tolist() != ap_cpu.tolist() or sorted(ap_card.tolist()) != want:
        raise SystemExit(f"(c) ring: abs_pos card {ap_card.tolist()}, CPU "
                         f"{ap_cpu.tolist()} (expected the positions {want})")
    rel = _held(torch.stack(outs["card"], 1), torch.stack(outs["cpu"], 1),
                PREFILL_EXACT_REL, f"zamba ring (window {cfg.window}, "
                f"{cfg.n_layers} layers, f32 exact) {ZAMBA_RING_STEPS} "
                "decode_steps card vs CPU", "(c)")
    del card, cpu, params, params_cpu, caches
    _free(device)
    return rel


def rest_card_vs_cpu(device):
    """(d): each model at full width, cut in depth (ZOO_REST_CPU), on the
    card (its kernels) and on the CPU (their plain versions), under
    ZOO_REST_CPU_RUNS; under PC3_TR the card's exact products too, which
    must break the bound. Returns ({arch/spec: relative deviation}, GEMM
    launches)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_artifacts

    recs, gemm_n = {}, 0
    for arch, cut in ZOO_REST_CPU.items():
        for spec, dtype, seq in ZOO_REST_CPU_RUNS:
            cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                                      compute_dtype=dtype,
                                      **cut).with_policy(spec)
            card = build_artifacts(cfg, device=device)
            cpu = build_artifacts(cfg, device="cpu")
            params = card.init_params(0)
            rng = np.random.default_rng(22)
            batch = {"tokens": rng.integers(0, cfg.vocab, size=(1, seq))}
            if cfg.family == "audio":  # encode casts them to the dtype
                batch["frames"] = rng.normal(size=(1, cfg.enc_frames,
                                                   cfg.d_model)).astype(
                    np.float32)
            want = approx_launches_per_step(card.model)
            got, sec = _counted(lambda: card.prefill_step(params, batch),
                                f"(d) {arch} {spec} card", device, want)
            gemm_n += want
            t0 = time.perf_counter()
            ref = cpu.prefill_step(_to_cpu(params), batch)
            cpu_s = time.perf_counter() - t0
            exact = spec == "*=exact"
            lim = PREFILL_EXACT_REL if exact else ZOO_REST_CPU_APPROX_REL[arch]
            where = ", ".join(f"{k} {v}" for k, v in cut.items())
            recs[f"{arch} {spec}"] = _held(
                got.cpu(), ref, lim, f"{arch} ({where}) {dtype} {spec} "
                f"S={seq}: card {sec * 1e3:.1f} ms ({want} GEMM launches), "
                f"CPU {cpu_s:.1f} s", "(d)", min_clear=1)
            if not exact:
                ctrl = build_artifacts(cfg.with_policy("*=exact"),
                                       device=device)
                got, _ = _counted(lambda: ctrl.prefill_step(params, batch),
                                  f"(d) {arch} control", device, 0)
                rel = _logit_agreement(got.cpu(), ref)[0]
                recs[f"{arch} control"] = rel
                log(f"  (d) control {arch} {dtype}: the card's exact products "
                    f"vs the CPU's {spec}: max |diff| / max |ref| {rel:.4g}, "
                    f"must exceed the bound {lim:g}")
                if not rel > lim:
                    raise SystemExit(f"(d) {arch}: exact products stay within "
                                     f"the bound {lim:g}; it cannot tell "
                                     "them from the approximate ones")
                del ctrl
            del card, cpu, params, got, ref
            _free(device)
    return recs, gemm_n


def zoo_rest(device):
    """Phase 13; returns (records, GEMM launches, flash launches)."""
    recs = {}
    recs["whisper"], gemm_n, flash_n = zoo_whisper(device)
    recs["whisper_flash"], recs["flash_err"] = whisper_flash(device)
    recs["gemms"], recs["gemm_err"] = rest_gemms(device)
    for arch in ("xlstm_1_3b", "zamba2_1_2b"):
        recs[arch], n = zoo_recurrent(device, arch)
        gemm_n += n
    recs["zamba_ring"] = zamba_ring(device)
    recs["card_vs_cpu"], n = rest_card_vs_cpu(device)
    gemm_n += n
    return recs, gemm_n, flash_n


# ---------------------------------------------------------------------------
# phase 14: daism-lint and the launchers' preflight
# ---------------------------------------------------------------------------

def _json_objects(text: str):
    """The JSON objects printed one after another in ``text``."""
    dec, pos, objs = json.JSONDecoder(), 0, []
    while (pos := text.find("{", pos)) >= 0:
        obj, pos = dec.raw_decode(text, pos)
        objs.append(obj)
    return objs


def lint_all():
    """(a): ``python -m repro_torch.launch.lint --all --device cuda`` in a
    process of its own; exit 0, no error and no TIL003 finding over every
    id. Returns (wall seconds, {id: (errors, warnings, infos)})."""
    import os

    from repro_torch.configs import ARCH_IDS, PAPER_IDS

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.lint", "--all",
           "--device", "cuda", "--format", "json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"lint --all exited {proc.returncode}:\n"
                         f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    reports = _json_objects(proc.stdout)
    ids = ARCH_IDS + PAPER_IDS
    if len(reports) != len(ids):
        raise SystemExit(f"lint --all printed {len(reports)} reports for "
                         f"{len(ids)} ids")
    counts = {}
    for name, r in zip(ids, reports):
        sev = [f["severity"] for f in r["findings"]]
        counts[name] = tuple(sev.count(s) for s in ("error", "warning",
                                                      "info"))
        if counts[name][0] or any(f["code"] == "TIL003"
                                  for f in r["findings"]):
            raise SystemExit(f"lint --all: {name} has an error or TIL003: "
                             f"{r['findings']}")
    log(f"  (a) lint --all --device cuda: {len(ids)} ids, exit 0, no error, "
        f"no TIL003; {sec:.2f} s wall (a process of its own, imports "
        "included); errors/warnings/infos: " + ", ".join(
            f"{k} {e}/{w}/{i}" for k, (e, w, i) in counts.items()))
    return sec, counts


def lint_smem(ptxas: str):
    """(b): the checker's shared-memory bytes of each GEMM path against
    the compiled kernel: the tile path's against ptxas's ``bytes smem``
    (from phase 2's build) and the library's query, every split-K plan's
    against the bytes the launcher requests. Returns {path: bytes}."""
    from repro_torch.kernels import daism_matmul as dm

    tile = dm.smem_bytes(None)
    compiled = ptxas_summary(ptxas, {"tile": "daism_matmul_approx"})
    if "Compiling entry function" in ptxas:
        if compiled.get("tile", (0, 0, 0))[2] != tile:
            raise SystemExit(f"the tile kernel's ptxas shared memory "
                             f"{compiled.get('tile')} != the checker's "
                             f"{tile} bytes")
        seen = f"ptxas {compiled['tile'][2]}"
    else:  # phase 2 found the libraries built by an earlier run
        seen = "ptxas not printed (libraries already built)"
    queried = dm.smem_query(None)
    if queried != tile:
        raise SystemExit(f"the tile kernel's shared memory {queried} (CUDA "
                         f"attribute) != the checker's {tile} bytes")
    out = {"tile": tile}
    for plan in dm.SPLIT_K_PLANS:
        want, got = dm.smem_bytes(plan), dm.smem_query(plan)
        if got != want:
            raise SystemExit(f"split-K {plan}: the launcher requests {got} "
                             f"bytes, the checker counts {want}")
        out[f"splitk {plan[0]}x{plan[1]}"] = got
    log(f"  (b) GEMM shared memory a block, checker = compiled: tile path "
        f"{tile} B ({seen}, CUDA attribute {queried}); split-K (rows, "
        "columns a thread) " + ", ".join(
            f"{p} {dm.smem_query(p)} B" for p in dm.SPLIT_K_PLANS))
    return out


def _aborts(device, main, argv, code):
    """(c): ``main(argv)`` must raise SystemExit naming ``code`` with no new
    CUDA bytes and no kernel launch; returns its wall seconds."""
    import torch

    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa

    _sync(device)
    before = (torch.cuda.memory_allocated(device), dm.launches, fa.launches)
    t0 = time.perf_counter()
    try:
        main(argv)
    except SystemExit as e:
        msg = str(e.code)
    else:
        raise SystemExit(f"{argv} ran past its preflight")
    sec = time.perf_counter() - t0
    _sync(device)
    after = (torch.cuda.memory_allocated(device), dm.launches, fa.launches)
    if code not in msg or after != before:
        raise SystemExit(f"{argv}: aborted with {msg!r} (want {code}); CUDA "
                         f"bytes and launches {before} -> {after}")
    return sec


def lint(device, ptxas: str):
    """Phase 14; returns (records, GEMM kernel launches of (d))."""
    import contextlib
    import io
    import re
    import shutil

    import torch

    import repro_torch.analyze as lint_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    log(f"  {nvidia_smi_line()}")
    rec = {}
    rec["all_s"], rec["counts"] = lint_all()
    rec["smem"] = lint_smem(ptxas)

    ckdir = ROOT / "build" / "chip_smoke_lint"
    shutil.rmtree(ckdir, ignore_errors=True)
    base = ["--arch", "tinyllama_1_1b", "--device", str(device)]
    rec["abort_s"] = {}
    for extra, code in LINT_ABORTS:
        rec["abort_s"][f"serve {code}"] = _aborts(
            device, serve_launcher.main, base + extra, code)
    extra, code = LINT_ABORTS[0]
    rec["abort_s"][f"train {code}"] = _aborts(
        device, train_launcher.main, base + extra + ["--ckpt", str(ckdir)],
        code)
    log("  (c) aborted by the preflight at full width, no CUDA byte and no "
        "launch: " + ", ".join(f"{k} {v:.2f} s"
                               for k, v in rec["abort_s"].items()))

    # (d) the target decides TIL003, not the host
    cfg = get_config("tinyllama_1_1b")
    til3 = {t: any(f.code == "TIL003" for f in lint_mod.analyze(
        cfg, LINT_POLICY, device=t).findings) for t in ("cuda", "cpu")}
    if til3 != {"cuda": False, "cpu": True}:
        raise SystemExit(f"TIL003 by target: {til3}")
    real, timed = lint_mod.preflight, {}

    def timed_preflight(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            timed[k["label"].split()[0]] = time.perf_counter() - t0

    lint_mod.preflight = timed_preflight
    try:
        buf = io.StringIO()
        dm.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            report = serve_launcher.main(base + LINT_SERVE)
        _sync(device)
        rec["serve_s"], serve_gemm = time.perf_counter() - t0, dm.launches
        out = buf.getvalue()
        for line in out.splitlines():
            if "daism-lint" in line or re.match(r"  [A-Z]{3}\d{3} ", line):
                log(f"  (d) {line.strip()}")
        if "TIL003" in out or "serve" not in timed:
            raise SystemExit("the serve preflight did not run for the card")
        if len(report.completed) != 4 or serve_gemm == 0:
            raise SystemExit(f"launch.serve: {len(report.completed)} of 4 "
                             f"requests, {serve_gemm} GEMM launches")
        del report
        _free(device)
        dm.launches = 0
        t0 = time.perf_counter()
        _, _, state = train_launcher.main(
            base + LINT_TRAIN + ["--ckpt", str(ckdir)])
        _sync(device)
        rec["train_s"], train_gemm = time.perf_counter() - t0, dm.launches
        if state.step != 2 or train_gemm == 0 or "train" not in timed:
            raise SystemExit(f"launch.train: step {state.step}, "
                             f"{train_gemm} GEMM launches, preflight "
                             f"{timed}")
    finally:
        lint_mod.preflight = real
        shutil.rmtree(ckdir, ignore_errors=True)
    _free(device)
    rec["preflight_s"] = timed
    log(f"  (d) launch.serve ({LINT_POLICY}, 4 requests, 22 layers): "
        f"{rec['serve_s']:.2f} s, preflight {timed['serve']:.2f} s, "
        f"{serve_gemm} GEMM launches; launch.train (2 layers, 2 steps): "
        f"{rec['train_s']:.2f} s, preflight {timed['train']:.2f} s, "
        f"{train_gemm} GEMM launches; TIL003 only for a cpu target")
    return rec, serve_gemm + train_gemm


# ---------------------------------------------------------------------------
# phase 15: multi-device serving at world size 1
# ---------------------------------------------------------------------------

def mesh_serve_tinyllama(device, cfg, mesh, base):
    """(b): phase 4's serve through the engine under ``mesh``; returns
    (record, GEMM launches)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.serve import EngineConfig, ServeEngine

    model = build_model(cfg, device=device)
    with torch.inference_mode():
        params = model.init(seed=0)
    ecfg = EngineConfig(num_slots=4, block_size=16, prefill_chunk=32,
                        max_seq=128, tiers=TIERS, shards=1)
    engine = ServeEngine(model, params, ecfg, mesh=mesh, device=device)
    before = dict(sharding.COLLECTIVES)
    dm.launches = 0
    rep = engine.run(serve_requests(cfg.vocab))
    _sync(device)
    launches = dm.launches
    coll = {k: v - before[k] for k, v in sharding.COLLECTIVES.items()}
    got = {s.request_id: s.output for s in rep.completed}
    want = {s.request_id: s.output for s in base["report"].completed}
    if got != want:
        raise SystemExit(f"(b) tokens differ from phase 4's: "
                         f"{[k for k in want if got.get(k) != want[k]]}")
    if launches != base["launches"]:
        raise SystemExit(f"(b) {launches} GEMM launches; phase 4 made "
                         f"{base['launches']}")
    steps = sum(rep.group_steps.values())
    b = base["report"]
    log(f"  (b) tinyllama_1_1b ({cfg.n_layers} layers) under the mesh: "
        f"{len(got)} requests' tokens equal phase 4's; daism_matmul "
        f"launches {launches} == phase 4's; NCCL collectives {coll} over "
        f"{steps} steps; {rep.tokens_per_s:.1f} decode tok/s, TTFT p50 "
        f"{rep.ttft_p50_ms:.1f} ms, step p50 {rep.step_p50_ms:.2f} ms (phase "
        f"4: {b.tokens_per_s:.1f} tok/s, TTFT p50 {b.ttft_p50_ms:.1f} ms, "
        f"step p50 {b.step_p50_ms:.2f} ms)")
    rec = dict(tok_s=rep.tokens_per_s, ttft_p50_ms=rep.ttft_p50_ms,
               step_p50_ms=rep.step_p50_ms, collectives=coll, steps=steps,
               base_tok_s=b.tokens_per_s, base_ttft_p50_ms=b.ttft_p50_ms,
               base_step_p50_ms=b.step_p50_ms)
    del engine, params, model
    _free(device)
    return rec, launches


def mesh_moe(device, mesh, dense):
    """(c): Qwen3-MoE through the expert-parallel path under ``mesh``;
    returns (record, GEMM launches of the serve)."""
    import torch

    from repro_torch.models.moe import _capacity
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import Sharder, base_rules, use_sharder
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    from repro_torch.kernels import daism_matmul as dm

    model, params = _zoo_model(device, "qwen3_moe_235b", 2, GEN_POLICY)
    cfg = model.cfg
    caps = {"prefill": _capacity(ZOO_ENGINE["num_slots"]
                                 * ZOO_ENGINE["prefill_chunk"], cfg),
            "decode": _capacity(ZOO_ENGINE["num_slots"], cfg)}
    log(f"  (c) EP capacity C (capacity_factor {cfg.capacity_factor}, top-"
        f"{cfg.topk} of {cfg.n_experts}): " + ", ".join(
            f"{k} ({ZOO_ENGINE['num_slots']} rows x "
            f"{ZOO_ENGINE['prefill_chunk'] if k == 'prefill' else 1} tokens)"
            f" C = {c}" for k, c in caps.items()))
    gen = torch.Generator(device=device).manual_seed(15)
    rows, err = [], 0.0
    for label, e, k, n, _ in ZOO_EXPERT_GEMMS[:2]:
        w = torch.randn((e, k, n), generator=gen, device=device).to(
            torch.bfloat16)
        for kind, c in caps.items():
            row = expert_row(device, gen, "(c)", f"{label} {kind}", w, c,
                             False)
            err = max(err, row["max_abs_err"])
            rows.append(row)
        del w
    _free(device)

    # a forward whose capacity drops nothing (C = tokens) against the dense
    # MoE (no sharder) on the same weights and tokens
    nodrop = build_model(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.topk), device=device)
    toks = torch.randint(0, cfg.vocab, MESH_MOE_TOKENS, device=device,
                         generator=torch.Generator(device=device).manual_seed(
                             16))
    sharder = Sharder(mesh, base_rules(False, serve=True))
    with torch.inference_mode():
        with use_sharder(sharder):
            ep, _ = nodrop.forward(params, {"tokens": toks})
        ref, _ = model.forward(params, {"tokens": toks})
    _sync(device)
    rel, agree, clear_ok, n_clear = _logit_agreement(ep, ref)
    log(f"  (c) no-drop EP forward (C = {_capacity(toks.numel(), nodrop.cfg)}"
        f" for {toks.numel()} tokens) vs the dense MoE: max |diff| / max "
        f"|ref| {rel:.4g} (bound {PREFILL_APPROX_REL:g}); greedy tokens agree "
        f"on {agree * 100:.1f}%, on all {n_clear} clear of the deviation: "
        f"{clear_ok}")
    if rel > PREFILL_APPROX_REL or not clear_ok \
            or not torch.isfinite(ep).all():
        raise SystemExit("(c) the EP forward departs from the dense MoE")
    del ep, ref, nodrop

    rng = __import__("numpy").random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in ZOO_PROMPTS]
    engine = ServeEngine(model, params, EngineConfig(**ZOO_ENGINE),
                         mesh=mesh, device=device)
    dm.launches = 0
    rep = engine.run([Request(prompt=p, max_new_tokens=ZOO_GEN)
                      for p in prompts])
    _sync(device)
    launches = dm.launches
    expected = sum(rep.group_steps[g.label] * approx_launches_per_step(
        g.model) for g in engine.groups.values())
    if launches != expected or len(rep.completed) != len(prompts) or any(
            len(st.output) != ZOO_GEN for st in rep.completed):
        raise SystemExit(f"(c) EP serve: {len(rep.completed)} requests, "
                         f"{launches} GEMM launches ({expected} implied)")
    log(f"  (c) EP serve of phase 12 (a)'s requests: {rep.tokens_per_s:.1f} "
        f"decode tok/s, TTFT p50 {rep.ttft_p50_ms:.1f} ms, step p50 "
        f"{rep.step_p50_ms:.2f} ms (phase 12 (a), dense: "
        f"{dense['tok_s']:.1f} tok/s, TTFT p50 {dense['ttft_p50_ms']:.1f} "
        f"ms, step p50 {dense['step_p50_ms']:.2f} ms); daism_matmul "
        f"launches {launches} as the steps imply; peak "
        f"{_peak_gib(device):.2f} GiB")
    rec = dict(caps=caps, experts=rows, nodrop_rel=rel,
               tok_s=rep.tokens_per_s, ttft_p50_ms=rep.ttft_p50_ms,
               step_p50_ms=rep.step_p50_ms, dense=dense, gemm_err=err)
    del engine, params, model
    _free(device)
    return rec, launches


def mesh_gemms(device):
    """(d): one rank's GEMMs of a 4-way tensor-parallel TinyLlama, PC3_TR,
    held against the plain version and timed beside the bound; (rows,
    max |kernel - plain|)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(17)
    rows, max_err = [], 0.0
    for label, k, n in MESH_GEMMS:
        for m in MESH_M:
            a = torch.randn((m, k), generator=gen, device=device).to(
                torch.bfloat16)
            w = torch.randn((k, n), generator=gen, device=device).to(
                torch.bfloat16)
            ms, got = cuda_time_ms(
                lambda: dm.daism_matmul_kernel(a, w, "pc3_tr"), 10)
            plain_ms, ref = cuda_time_ms(lambda: dm.daism_matmul_plain(
                a, w, "pc3_tr"), 1, warmup=0)
            err, rel = gemm_held(got, ref, a, w, f"(d) {label} ({m},{k},{n})")
            max_err = max(max_err, err)
            b_ms, b_by, _ = bound("pc3_tr", m, k, n)
            rows.append(dict(site=label, m=m, k=k, n=n, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
            log(f"  (d) pc3_tr {label:8s} ({m:4d}, {k:4d}, {n:4d}): kernel "
                f"{ms:8.4f} ms, plain {plain_ms:8.2f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms * 100:5.1f}% of bound, |kernel - "
                f"plain| {rel:.3g} (|a|@|w|)")
    _free(device)
    return rows, max_err


def mesh_collectives(device):
    """(e): compressed_psum and a one-stage pipeline_apply on CUDA tensors
    over the NCCL group, against the CPU."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_apply

    gen = torch.Generator().manual_seed(18)
    grads = {"w": torch.randn((2048, 512), generator=gen),
             "b": torch.randn((512,), generator=gen) * 1e-3}
    data = make_mesh((1,), ("data",))
    out = {}
    for mode in ("none", "bf16", "int8"):
        card = compressed_psum({k: v.to(device) for k, v in grads.items()},
                               "data", mode, mesh=data)
        cpu = compressed_psum(grads, "data", mode, mesh={"data": 1})
        for k in grads:
            got, want = card[k].cpu(), cpu[k]
            if mode == "bf16":
                bad = ((got - want).abs() > 2.0**-7 * want.abs()).any()
            else:
                bad = not torch.equal(got, want)
            if bad or got.dtype != want.dtype:
                raise SystemExit(f"(e) compressed_psum {mode} {k}: the card "
                                 "differs from the CPU")
        out[mode] = float(max((card[k].cpu() - grads[k]).abs().max()
                              for k in grads))
    layers = {"w": torch.randn((4, 256, 256), generator=gen) / 16,
              "b": torch.randn((4, 256), generator=gen) / 10}
    x = torch.randn((32, 256), generator=gen)

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    on_card = {k: v.to(device) for k, v in layers.items()}
    piped = pipeline_apply(layer, on_card, x.to(device),
                           make_mesh((1,), ("stage",)), n_microbatches=4)
    # the sequential loop microbatch by microbatch (the library GEMM picks
    # its algorithm by M, so the whole batch at once is another rounding)
    seq = []
    for mb in x.to(device).chunk(4):
        for i in range(4):
            mb = layer({k: v[i] for k, v in on_card.items()}, mb)
        seq.append(mb)
    seq = torch.cat(seq)
    _sync(device)
    if not torch.equal(piped, seq):
        raise SystemExit("(e) the one-stage pipeline differs from the "
                         "sequential loop")
    log("  (e) compressed_psum on CUDA tensors over the NCCL group: int8 and "
        "none equal the CPU bit for bit, bf16 within one bf16 rounding; "
        "|mean - grad| per mode " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in out.items())
        + "; a one-stage pipeline_apply (4 layers, 4 microbatches) equals "
        "the sequential loop over the same microbatches bit for bit")
    return out


def mesh_phase(device, cfg, base, dense_moe):
    """Phase 15; returns (record, GEMM launches of the serves)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (backend_for, init_distributed,
                                         make_mesh)

    log(f"  {nvidia_smi_line()}")
    t0 = time.perf_counter()
    dev = init_distributed(device)
    mesh = make_mesh((1,), ("model",))
    log(f"  (a) {dist.get_backend()} process group, world size "
        f"{dist.get_world_size()}, rank {dist.get_rank()} on {dev}; mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} in "
        f"{time.perf_counter() - t0:.2f} s")
    if dist.get_backend() != backend_for(device) or dev != device:
        raise SystemExit(f"(a) {dist.get_backend()} on {dev}")
    try:
        rec = {}
        rec["tinyllama"], tl_gemm = mesh_serve_tinyllama(device, cfg, mesh,
                                                         base)
        rec["moe"], moe_gemm = mesh_moe(device, mesh, dense_moe)
        rec["gemms"], rec["gemm_err"] = mesh_gemms(device)
        rec["compressed_psum"] = mesh_collectives(device)
    finally:
        dist.destroy_process_group()
    return rec, tl_gemm + moe_gemm


# ---------------------------------------------------------------------------
# phase 16: multi-device training's code at world size 1
# ---------------------------------------------------------------------------

def _train_plan(cfg, mesh, device):
    """Phase 6's plan under ``mesh`` (None: no mesh): artifacts for the STE
    and the approximate backward, and the four (label, artifacts) steps."""
    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.policy import ApproxPolicy

    ste = build_artifacts(cfg.with_policy(GEN_POLICY), mesh, device=device,
                          warmup=1, total_steps=100)
    approx = build_artifacts(cfg.with_policy(ApproxPolicy.uniform(
        DaismConfig(variant=Variant.PC3_TR, backend=Backend.PALLAS,
                    backward="approx"))), mesh, device=device, warmup=1,
        total_steps=100)
    return ste, [("ste", ste)] * 3 + [("approx", approx)]


def _train_run(cfg, mesh, device):
    """Phase 6's four steps from seed 0 on phase 6's batch shape; (params,
    per-step records with the loss and grad norm tensors, GEMM launches,
    collectives, peak GiB)."""
    import torch

    from repro_torch.data import lm_batches, shard_batch
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.parallel import sharding

    ste, plan = _train_plan(cfg, mesh, device)
    params = ste.init_params(0)
    opt = ste.init_opt(params)
    batches = lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    dm.launches = 0
    before = dict(sharding.COLLECTIVES)
    steps = []
    for label, art in plan:
        batch = next(batches)
        if mesh is not None:
            batch = shard_batch(batch, art.batch_sharding(batch),
                                device=device)
        t0 = time.perf_counter()
        params, opt, m = art.train_step(params, opt, batch)
        _sync(device)
        steps.append(dict(backward=label, ms=(time.perf_counter() - t0) * 1e3,
                          loss=m["loss"].clone(),
                          grad_norm=m["grad_norm"].clone()))
    coll = {k: v - before[k] for k, v in sharding.COLLECTIVES.items()}
    del opt
    return params, steps, dm.launches, coll, _peak_gib(device), ste


def train_mesh_tinyllama(device, cfg, mesh, base_steps):
    """(a): phase 6's steps through build_artifacts(cfg, mesh) over the 1x1
    mesh against the same steps without a mesh, on the same weights and
    batches: losses, grad norms and every parameter, bit for bit; then
    (d)'s checkpoint of the trained tree under the mesh and its restore
    with param_shardings. Returns (record, GEMM launches)."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.models.module import flatten

    ref_params, ref_steps, ref_n, _, _, _ = _train_run(cfg, None, device)
    ref_params = {k: v for k, v in flatten(ref_params).items()}
    _free(device)
    params, steps, n, coll, peak, art = _train_run(cfg, mesh, device)
    per_fwd = approx_launches_per_step(art.model)
    if n != ref_n or n != 6 * per_fwd:
        raise SystemExit(f"(a) {n} GEMM launches under the mesh, {ref_n} "
                         f"without, {6 * per_fwd} implied")
    gaps = {}
    for i, (a, b) in enumerate(zip(steps, ref_steps)):
        for key in ("loss", "grad_norm"):
            if not torch.equal(a[key], b[key]):
                gaps[f"step {i + 1} {key}"] = abs(
                    float(a[key]) - float(b[key])) / abs(float(b[key]))
    for k, t in flatten(params).items():
        if not torch.equal(t, ref_params[k]):
            gaps[k] = float((t.float() - ref_params[k].float()).abs().max())
    for i, (a, b, c) in enumerate(zip(steps, ref_steps, base_steps)):
        log(f"  (a) step {i + 1} ({a['backward']:6s}): 1x1 mesh "
            f"{a['ms']:8.1f} ms, no mesh {b['ms']:8.1f} ms (phase 6: "
            f"{c['ms']:8.1f} ms); loss {float(a['loss']):.6f}, grad_norm "
            f"{float(a['grad_norm']):.6f}")
    log(f"  (a) collectives a step under the 1x1 mesh: " + ", ".join(
        f"{k} {v / len(steps):.1f}" for k, v in coll.items())
        + f"; peak {peak:.2f} GiB; daism_matmul launches {n} "
        f"(= no mesh, = 6 x {per_fwd})")
    if gaps:
        worst = max(gaps.items(), key=lambda kv: kv[1])
        raise SystemExit(f"(a) NOT bit for bit: {len(gaps)} differ, the "
                         f"largest {worst[0]} by {worst[1]:.3g}")
    log(f"  (a) losses, grad norms and all {len(ref_params)} parameters "
        "after 4 steps equal the run without a mesh, bit for bit")
    del ref_params
    _free(device)

    root = ROOT / "build" / "chip_smoke_ckpt16"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ckpt.save(str(root), 4, {"params": params},
                  {"params": art.param_shardings})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore(str(root), 4, {"params": params},
                            {"params": art.param_shardings})["params"]
        _sync(device)
        restore_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in root.rglob("*")
                     if f.is_file())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, t in flatten(params).items():
        if not torch.equal(flatten(back)[k], t):
            raise SystemExit(f"(d) restore(shardings=) changed {k}")
    log(f"  (d) save under the 1x1 mesh ({nbytes / 1e9:.3f} GB, gathered, "
        f"rank 0 writes) {save_s:.2f} s; restore(shardings=) {restore_s:.2f}"
        " s: every parameter bit for bit")
    rec = dict(steps=[{k: (float(v) if torch.is_tensor(v) else v)
                       for k, v in st.items()} for st in steps],
               ref_ms=[st["ms"] for st in ref_steps], collectives=coll,
               peak_gib=peak, gaps=gaps, save_s=save_s, restore_s=restore_s,
               ckpt_bytes=nbytes)
    del params, back, art
    _free(device)
    return rec, n + ref_n


def train_mesh_moe(device, mesh):
    """(b): one Qwen3-MoE train step at published width, 1 layer, through
    EP under the 1x1 mesh (the approximate backward, so the expert
    kernel runs forward and backward), beside the dense MoE's step on the
    same layer; the no-drop loss against the dense loss; the expert
    kernel at the step's forward and backward shapes against the plain
    version. Returns (record, GEMM launches)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.data import lm_batches, shard_batch
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.moe import _capacity
    from repro_torch.models.registry import lm_loss
    from repro_torch.policy import ApproxPolicy

    cfg = dataclasses.replace(get_config("qwen3_moe_235b"),
                              n_layers=TRAIN_MESH_MOE_LAYERS).with_policy(
        ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                         backend=Backend.PALLAS,
                                         backward="approx")))
    b, s = TRAIN_MESH_MOE_TOKENS
    art = build_artifacts(cfg, mesh, device=device, warmup=1,
                          total_steps=100)
    n_params = sum(math.prod(sp[0]) for sp in art.model.param_specs().values())
    state = n_params * TRAIN_STATE_BYTES_PER_PARAM
    full = state <= TRAIN_MESH_MAX_STATE
    cap = _capacity(b * s, cfg)
    log(f"  (b) qwen3_moe_235b, {cfg.n_layers} of 94 layers at published "
        f"width: {n_params / 1e9:.3f}e9 params x "
        f"{TRAIN_STATE_BYTES_PER_PARAM} B = {state / 1e9:.1f} GB of train "
        f"state ({'<=' if full else '>'} {TRAIN_MESH_MAX_STATE / 1e9:.0f} "
        f"GB: {'the whole train_step' if full else 'forward and backward, no AdamW'}"
        f"); B={b}, S={s}: capacity C = {cap} (top-{cfg.topk} of "
        f"{cfg.n_experts}, capacity_factor {cfg.capacity_factor})")
    torch.zeros((), device=device)
    torch.cuda.reset_peak_memory_stats(device)
    params = art.init_params(0)
    gen = lm_batches(cfg.vocab, b, s, seed=0)
    batch = next(gen)
    batch = shard_batch(batch, art.batch_sharding(batch), device=device)
    per_fwd = approx_launches_per_step(art.model)
    rec = dict(params=n_params, state_bytes=state, full_step=full, c=cap)

    def one_step(a, opt):
        dm.launches = 0
        t0 = time.perf_counter()
        if opt is not None:
            p, o, m = a.train_step(params, opt, batch)
            loss = float(m["loss"])
        else:  # forward and backward alone (no AdamW)
            from repro_torch.models.module import flatten
            from repro_torch.parallel.sharding import use_sharder

            leaves = list(flatten(params).values())
            with use_sharder(a.sharder), torch.enable_grad():
                for t in leaves:
                    t.requires_grad_(True)
                logits, aux = a.model.forward(params, batch)
                lv = lm_loss(logits, batch["labels"], aux)
                torch.autograd.grad(lv, leaves, allow_unused=True)
                for t in leaves:
                    t.requires_grad_(False)
            loss = float(lv)
        _sync(device)
        return (time.perf_counter() - t0) * 1e3, loss, dm.launches

    opt = art.init_opt(params) if full else None
    ep_ms, ep_loss, ep_n = one_step(art, opt)
    if ep_n != 3 * per_fwd or not math.isfinite(ep_loss):
        raise SystemExit(f"(b) EP step: loss {ep_loss}, {ep_n} GEMM "
                         f"launches ({3 * per_fwd} implied)")
    dense = build_artifacts(dataclasses.replace(cfg, moe_impl="dense"), mesh,
                            device=device, warmup=1, total_steps=100)
    # the dense step from the EP step's initial state: the EP step updated
    # the parameters and the optimizer state in place, so draw both anew
    del opt
    _free(device)
    params = art.init_params(0)
    opt = art.init_opt(params) if full else None
    d_ms, d_loss, d_n = one_step(dense, opt)
    peak = _peak_gib(device)
    log(f"  (b) EP train step {ep_ms:.1f} ms (loss {ep_loss:.4f}, "
        f"{ep_n} GEMM launches = 3 x {per_fwd}); the dense MoE's step on "
        f"the same layer from the same initial state {d_ms:.1f} ms (loss "
        f"{d_loss:.4f}); peak {peak:.2f} GiB")
    del opt
    _free(device)

    # the loss under a capacity that drops nothing, against the dense loss
    nodrop = build_artifacts(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.topk), mesh, device=device)
    ep = nodrop.prefill_step(params, batch)
    ref = dense.prefill_step(params, batch)
    l_ep = float(lm_loss(ep, batch["labels"]))
    l_ref = float(lm_loss(ref, batch["labels"]))
    rel, agree, clear_ok, n_clear = _logit_agreement(ep, ref)
    log(f"  (b) no-drop EP (C = {_capacity(b * s, nodrop.cfg)}) loss "
        f"{l_ep:.5f} vs the dense MoE's {l_ref:.5f} (|diff| / loss "
        f"{abs(l_ep - l_ref) / l_ref:.3g}); logits max |diff| / max |ref| "
        f"{rel:.4g} (bound {PREFILL_APPROX_REL:g}); greedy agree on "
        f"{agree * 100:.1f}%, all {n_clear} clear rows: {clear_ok}")
    if rel > PREFILL_APPROX_REL or not clear_ok \
            or not torch.isfinite(ep).all():
        raise SystemExit("(b) the no-drop EP step departs from the dense MoE")
    del ep, ref, params, art, dense, nodrop
    _free(device)

    # the expert kernel at the step's shapes: forward w_in/w_gate (and
    # w_out's dx), w_out (and w_in/w_gate's dx), and the two dw, K = C
    gen = torch.Generator(device=device).manual_seed(21)
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    rows, err = [], 0.0
    for label, c, k, n, launches in (
            ("w_in/w_gate fwd, w_out dx", cap, d, f, 3),
            ("w_out fwd, w_in/w_gate dx", cap, f, d, 3),
            ("w_in/w_gate dw", d, cap, f, 2), ("w_out dw", f, cap, d, 1)):
        w = torch.randn((e, k, n), generator=gen, device=device).to(
            torch.bfloat16)
        row = expert_row(device, gen, "(b)", label, w, c, False)
        row["launches"] = launches
        err = max(err, row["max_abs_err"])
        rows.append(row)
        del w
        _free(device)
    rec.update(ep_ms=ep_ms, ep_loss=ep_loss, dense_ms=d_ms, dense_loss=d_loss,
               peak_gib=peak, nodrop_loss=l_ep, dense_prefill_loss=l_ref,
               nodrop_rel=rel, experts=rows, gemm_err=err)
    return rec, ep_n + d_n


def train_mesh_pipeline(device):
    """(c): a one-stage pipeline_apply on CUDA tensors over the NCCL group,
    M microbatches: its gradients of the stacked tree and of x against
    sequential autograd over the same microbatches."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    n_layers, dim, rows, m = TRAIN_MESH_PIPE

    def leaves():
        g = torch.Generator(device=device).manual_seed(22)
        w = torch.randn((n_layers, dim, dim), generator=g, device=device) / 16
        b = torch.randn((n_layers, dim), generator=g, device=device) / 10
        x = torch.randn((rows, dim), generator=g, device=device)
        return [t.requires_grad_() for t in (w, b, x)]

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    w, b, x = leaves()
    y = pipeline_apply(layer, {"w": w, "b": b}, x,
                       make_mesh((1,), ("stage",)), n_microbatches=m)
    got = torch.autograd.grad((y ** 2).sum(), [w, b, x])
    w, b, x = leaves()
    mine = [{"w": w[i], "b": b[i]} for i in range(n_layers)]
    outs = []
    for mb in x.chunk(m):
        for p in mine:
            mb = layer(p, mb)
        outs.append(mb)
    want = torch.autograd.grad((torch.cat(outs) ** 2).sum(), [w, b, x])
    _sync(device)
    gap = max(float((a - r).abs().max()) for a, r in zip(got, want))
    same = all(torch.equal(a, r) for a, r in zip(got, want))
    log(f"  (c) one-stage pipeline_apply (L={n_layers}, D={dim}, B={rows}, "
        f"M={m}) gradient vs sequential autograd over the same "
        f"microbatches: " + ("bit for bit" if same else
                             f"NOT bit for bit, max |diff| {gap:.3g}"))
    if not same:
        raise SystemExit("(c) the pipeline's gradient departs")
    return dict(bitwise=same, max_abs_diff=gap)


def train_mesh_launcher(device):
    """(d): python -m repro_torch.launch.train over a 1x1 mesh on the card,
    2 steps with a checkpoint, then again to step 3: it resumes."""
    import shutil

    root = ROOT / "build" / "chip_smoke_launch16"
    shutil.rmtree(root, ignore_errors=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    out, secs = [], []
    try:
        for steps in (2, 3):
            argv = TRAIN_MESH_LAUNCH + ["--steps", str(steps), "--ckpt",
                                        str(root)]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train"] + argv,
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            secs.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise SystemExit(f"(d) launch.train --steps {steps}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
            out.append(proc.stdout + proc.stderr)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, second = out
    ok = ("mesh: {'data': 1, 'model': 1}" in first
          and "step     2 loss" in first
          and "resuming from checkpoint step 2" in second
          and "step     2 loss" not in second
          and "step     3 loss" in second and "done at step 3" in second)
    if not ok:
        raise SystemExit("(d) the launcher did not train, save and resume "
                         "over the mesh:\n" + first[-2000:] + second[-2000:])
    log(f"  (d) python -m repro_torch.launch.train {' '.join(TRAIN_MESH_LAUNCH)}"
        f": 2 steps and a checkpoint in {secs[0]:.1f} s, resumed at step 2 "
        f"to step 3 in {secs[1]:.1f} s (each a new process with its own "
        "NCCL group)")
    return dict(launch_s=secs)


def train_mesh(device, cfg, base_steps):
    """Phase 16; returns (record, GEMM launches)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh

    log(f"  {nvidia_smi_line()}")
    dev = init_distributed(device)
    mesh = make_mesh((1, 1), ("data", "model"))
    if dev != device:
        raise SystemExit(f"phase 16: the group put the rank on {dev}")
    try:
        rec = {}
        rec["tinyllama"], n_a = train_mesh_tinyllama(device, cfg, mesh,
                                                     base_steps)
        rec["moe"], n_b = train_mesh_moe(device, mesh)
        rec["pipeline"] = train_mesh_pipeline(device)
    finally:
        dist.destroy_process_group()
    rec["launcher"] = train_mesh_launcher(device)
    return rec, n_a + n_b


# ---------------------------------------------------------------------------
# phase 17: the roofline, the dry-run and activation checkpointing
# ---------------------------------------------------------------------------

def _steps_from_seed(art, device, n, batch, seq, vocab, params=None):
    """``n`` train steps from ``init_params(0)`` (or a copy of ``params``)
    on ``lm_batches(seed=0)``: (per-step ms, the metrics' tensors, the
    final parameters flattened, GEMM launches, peak GiB)."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.models.module import flatten, unflatten

    if params is None:
        params = art.init_params(0)
    else:
        params = unflatten({k: v.clone() for k, v in flatten(params).items()})
    opt = art.init_opt(params)
    batches = lm_batches(vocab, batch, seq, seed=0)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    n0 = dm.launches
    ms, metrics = [], []
    for _ in range(n):
        b = next(batches)
        t0 = time.perf_counter()
        params, opt, m = art.train_step(params, opt, b)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
    launches = dm.launches - n0
    del opt
    return ms, metrics, flatten(params), launches, _peak_gib(device)


def _bit_gaps(a_metrics, a_params, b_metrics, b_params):
    """{what: gap} where two runs differ (empty: bit for bit)."""
    import torch

    gaps = {}
    for i, ((al, ag), (bl, bg)) in enumerate(zip(a_metrics, b_metrics)):
        for key, x, y in (("loss", al, bl), ("grad_norm", ag, bg)):
            if not torch.equal(x, y):
                gaps[f"step {i + 1} {key}"] = abs(float(x) - float(y))
    for k, t in a_params.items():
        if not torch.equal(t, b_params[k]):
            gaps[k] = float((t.float() - b_params[k].float()).abs().max())
    return gaps


def remat_card(device, cfg):
    """(a): phase 6's STE step under each remat mode; every mode bit for
    bit the plain step. Returns (record, GEMM launches)."""
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.transformer import REMAT_MODES

    runs, rec, total = {}, {}, 0
    per_fwd = None
    for mode in REMAT_MODES:
        art = build_artifacts(
            dataclasses.replace(cfg, remat=mode).with_policy(GEN_POLICY),
            device=device, warmup=1, total_steps=100)
        per_fwd = per_fwd or approx_launches_per_step(art.model)
        ms, metrics, params, n, peak = _steps_from_seed(
            art, device, REMAT_STEPS, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
        total += n
        # kept on the host: the next mode's peak must not hold them
        runs[mode] = ([(a.cpu(), b.cpu()) for a, b in metrics],
                      {k: v.cpu() for k, v in params.items()})
        del metrics, params
        rec[mode] = dict(ms=ms, peak_gib=peak, launches=n,
                         loss=float(runs[mode][0][-1][0]),
                         grad_norm=float(runs[mode][0][-1][1]))
        log(f"  (a) remat {mode:7s}: steps " + ", ".join(
            f"{t:.1f}" for t in ms) + f" ms, peak {peak:.2f} GiB, "
            f"daism_matmul launches {n} ({n / REMAT_STEPS:.0f} a step; a "
            f"forward is {per_fwd}); loss {rec[mode]['loss']:.6f}")
        del art
        _free(device)
    for mode in REMAT_MODES[1:]:
        gaps = _bit_gaps(*runs[mode], *runs["none"])
        if gaps:
            worst = max(gaps.items(), key=lambda kv: kv[1])
            raise SystemExit(f"(a) remat {mode} is not the plain step bit "
                             f"for bit: {len(gaps)} differ, the largest "
                             f"{worst[0]} by {worst[1]:.3g}")
    n = {m: rec[m]["launches"] for m in REMAT_MODES}
    recompute = n["full"] - n["none"]
    if (n["none"] != REMAT_STEPS * per_fwd or n["dots"] != n["full"]
            or n["dots_nb"] != n["full"]
            or not 0 < recompute <= REMAT_STEPS * per_fwd):
        raise SystemExit(f"(a) GEMM launches by mode {n}: none must be "
                         f"{REMAT_STEPS} x {per_fwd}, every other mode the "
                         "same, with at most one forward's recompute a step")
    log(f"  (a) losses, grad norms and all {len(runs['none'][1])} parameters"
        f" after {REMAT_STEPS} steps equal under every mode, bit for bit; "
        f"the kernel is recomputed under every mode: {recompute // REMAT_STEPS}"
        f" launches a step ({per_fwd} a forward; the lm_head's, outside the "
        "checkpointed layers, is not)")
    del runs
    _free(device)
    return rec, total


def roofline_card(device, cfg):
    """(b): TinyLlama's prefill (B = 1, S = 2048) and train step (B = 2,
    S = 256) under *=exact: the dry-run's record on a 1x1 mesh beside the
    step measured on the card. Returns the record."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_artifacts

    exact = cfg.with_policy("*=exact")
    rules = dryrun.rules_for("base", False)
    out = {}
    for label, shape in (("prefill", (PREFILL_SEQ, 1, "prefill")),
                         ("train", (TRAIN_SEQ, TRAIN_BATCH, "train"))):
        t0 = time.perf_counter()
        rec = dryrun.roofline_record(exact, shape, {"data": 1, "model": 1},
                                     rules, cfg.name, label, "1x1")
        rec["trace_s"] = time.perf_counter() - t0
        seq, b, kind = shape
        art = build_artifacts(exact, device=device, warmup=1,
                              total_steps=100)
        params = art.init_params(0)
        batches = lm_batches(cfg.vocab, b, seq, seed=0)
        if kind == "prefill":
            batch = {"tokens": next(batches)["tokens"]}

            def run():
                return art.prefill_step(params, batch)
        else:
            state = {"opt": art.init_opt(params), "p": params}

            def run():
                state["p"], state["opt"], _ = art.train_step(
                    state["p"], state["opt"], next(batches))
        run()                              # warm
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            run()
            _sync(device)
            ms.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated(device)
        ms = sorted(ms)[1]
        bound_ms = 1e3 * max(rec["compute_s"], rec["memory_s"],
                             rec["collective_s"])
        # the arguments and the trace's peak of live storages (its new
        # outputs among them; the train step's update the arguments in
        # place, so out_bytes, the reference's, would count them twice)
        est = rec["arg_bytes"] + rec["temp_bytes"]
        rec.update(ms=ms, bound_ms=bound_ms, peak_bytes=peak,
                   ms_over_bound=ms / bound_ms, est_over_peak=est / peak)
        out[label] = rec
        log(f"  (b) {label} B={b} S={seq} exact: terms compute "
            f"{rec['compute_s'] * 1e3:.3f} ms, memory "
            f"{rec['memory_s'] * 1e3:.3f} ms, collective "
            f"{rec['collective_s'] * 1e3:.3f} ms -> {rec['bottleneck']}; "
            f"{rec['flops_per_device']:.4g} FLOPs, "
            f"{rec['bytes_per_device']:.4g} bytes; measured {ms:.2f} ms = "
            f"{ms / bound_ms:.2f} x the bound; memory estimate "
            f"{est / 2**30:.2f} GiB (args {rec['arg_bytes'] / 2**30:.2f}, "
            f"temps {rec['temp_bytes'] / 2**30:.2f}) vs allocator peak "
            f"{peak / 2**30:.2f} GiB = {est / peak:.2f}; trace "
            f"{rec['trace_s']:.1f} s")
        del art, params, run
        _free(device)
    return out


def families_mesh(device):
    """(c): xLSTM-1.3B and Zamba2-1.2B at published width over a 1x1 mesh
    at world size 1 (NCCL): a forward and STE train steps, bit for bit the
    same steps without a mesh. Returns (record, GEMM launches)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import build_artifacts

    dev = init_distributed(device)
    if dev != device:
        raise SystemExit(f"phase 17: the group put the rank on {dev}")
    b, seq = FAMILY_TOKENS
    rec, total = {}, 0
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for arch, layers in FAMILY_LAYERS.items():
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=layers).with_policy(GEN_POLICY)
            plain = build_artifacts(cfg, device=device, warmup=1,
                                    total_steps=100)
            sharded = build_artifacts(cfg, mesh, device=device, warmup=1,
                                      total_steps=100)
            params = plain.init_params(0)
            batch = {"tokens": next(lm_batches(cfg.vocab, b, seq,
                                               seed=0))["tokens"]}
            n0 = dm.launches
            t0 = time.perf_counter()
            want = plain.prefill_step(params, batch)
            _sync(device)
            fwd_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got = sharded.prefill_step(params, batch)
            _sync(device)
            mesh_ms = (time.perf_counter() - t0) * 1e3
            _finite_logits(got, (b, seq, cfg.vocab), f"(c) {arch}")
            if not torch.equal(got, want):
                raise SystemExit(f"(c) {arch}: the forward under the 1x1 "
                                 "mesh is not the plain one bit for bit")
            ref = _steps_from_seed(plain, device, FAMILY_STEPS, b, seq,
                                   cfg.vocab, params)
            run = _steps_from_seed(sharded, device, FAMILY_STEPS, b, seq,
                                   cfg.vocab, params)
            gaps = _bit_gaps(run[1], run[2], ref[1], ref[2])
            if gaps:
                worst = max(gaps.items(), key=lambda kv: kv[1])
                raise SystemExit(f"(c) {arch}: the train steps under the "
                                 f"mesh differ in {len(gaps)}, the largest "
                                 f"{worst[0]} by {worst[1]:.3g}")
            n = dm.launches - n0
            total += n
            rec[arch] = dict(layers=layers, fwd_ms=fwd_ms, mesh_fwd_ms=mesh_ms,
                             step_ms=run[0], ref_step_ms=ref[0],
                             peak_gib=run[4], launches=n)
            log(f"  (c) {arch} ({layers} of {get_config(arch).n_layers} "
                f"layers) B={b} S={seq}: forward {mesh_ms:.1f} ms under "
                f"the 1x1 mesh ({fwd_ms:.1f} ms without), train steps "
                + ", ".join(f"{t:.1f}" for t in run[0]) + " ms (without: "
                + ", ".join(f"{t:.1f}" for t in ref[0]) + f"); logits, "
                f"losses, grad norms and all {len(ref[2])} parameters bit "
                f"for bit; peak {run[4]:.2f} GiB; {n} GEMM launches")
            del plain, sharded, params, ref, run, got, want
            _free(device)
    finally:
        dist.destroy_process_group()
    return rec, total


def dryrun_cells():
    """(d): one dry-run cell a family on the single-pod mesh (16 x 16, on
    meta): each must end ok. Returns the records."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "single", verbose=False)
        wall = time.perf_counter() - t0
        if rec["status"] != "ok":
            raise SystemExit(f"(d) {arch} x {shape}: {rec}")
        rec["wall_s"] = wall
        out[f"{arch}|{shape}"] = rec
        log(f"  (d) {arch} x {shape} x single: compute "
            f"{rec['compute_s']:.4f} s, memory {rec['memory_s']:.4f} s, "
            f"collective {rec['collective_s']:.4f} s -> {rec['bottleneck']};"
            f" {rec['mem_per_device_gb']:.2f} GB a device, useful "
            f"{rec['useful_ratio']:.2f}; {wall:.1f} s wall")
    return out


def roofline_phase(device, cfg):
    """Phase 17; returns (record, GEMM launches)."""
    log(f"  {nvidia_smi_line()}")
    rec = {}
    rec["remat"], n_a = remat_card(device, cfg)
    rec["roofline"] = roofline_card(device, cfg)
    rec["families"], n_c = families_mesh(device)
    rec["dryrun"] = dryrun_cells()
    return rec, n_a + n_c


def build_all():
    """nvcc of every kernel source, all started together; prints the
    -Xptxas -v lines and returns ({name: (path, seconds)}, those lines)."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import compile_library

    def one(name):
        t0 = time.perf_counter()
        path = compile_library(name, verbose=True)
        return name, (path, time.perf_counter() - t0)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), ThreadPoolExecutor(
            len(KERNELS)) as pool:
        built = dict(pool.map(one, KERNELS))
    print(buf.getvalue(), end="", flush=True)
    return built, buf.getvalue()


def ptxas_summary(text: str, marks):
    """{label: (registers, spill store bytes, static shared memory bytes)}
    over the ptxas entries whose mangled name holds ``marks[label]`` (the
    largest over the variants)."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((label for label, mk in marks.items()
                         if mk in m.group(1)), None)
            continue
        if name is None:
            continue
        regs, spill, smem = out.get(name, (0, 0, 0))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            smem = max(smem, int(m.group(1)))
        out[name] = (regs, spill, smem)
    return out


def sass_counts(lib: Path, kernel: str):
    """{function: {op: count}} of the wgmma (HGMMA), mma.sync (HMMA) and
    TMA load (UTMALDG) instructions in the library's functions whose name
    holds ``kernel``, by ``cuobjdump``; None where the toolkit has no
    cuobjdump."""
    import os
    import shutil

    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "cuobjdump")
    tool = str(cuobjdump) if cuobjdump.is_file() else shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if kernel in fn:
                counts[fn] = dict.fromkeys(("HGMMA", "HMMA", "UTMALDG"), 0)
        elif fn in counts and "*/" in line:  # /*addr*/ [@pred] OP.mods ...
            words = [t for t in line.split("*/", 1)[1].split()
                     if not t.startswith("@")]
            opcode = words[0].split(".")[0] if words else ""
            if opcode in counts[fn]:
                counts[fn][opcode] += 1
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=22,
                   help="depth of the served, prefilled and trained model "
                        "(TinyLlama has 22; width is never cut)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.core.config import Variant

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    log("== 1. device ==")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{name}, count {torch.cuda.device_count()}; TF32 off")

    log("== 2. build ==")
    t0 = time.perf_counter()
    built, ptxas = build_all()
    for lib, (path, sec) in built.items():
        log(f"  built {path.relative_to(ROOT)} in {sec:.1f} s")
    log(f"  build wall {time.perf_counter() - t0:.1f} s")
    counts = sass_counts(built["daism_matmul"][0], "exact_gemm")
    if counts is None:
        log("  no cuobjdump: SASS of the EXACT kernels not counted")
    else:
        for fn, c in counts.items():
            log(f"  SASS of {fn}: " + ", ".join(f"{op} {n}"
                                                for op, n in c.items()))
        if not counts or not all(c["HGMMA"] for c in counts.values()):
            raise SystemExit("the EXACT kernels hold no HGMMA (wgmma)")

    log("== 3. kernels vs plain versions ==")
    max_err = check_kernel(device)
    flash_errs = check_flash(device)
    check_order(device)

    cfg = get_config("tinyllama_1_1b")
    if args.layers != cfg.n_layers:
        log(f"  depth cut: {args.layers} of {cfg.n_layers} layers "
            "(width kept)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    log("== 4. serve ==")
    report, serve_launches = serve(device, cfg)
    _free(device)

    log("== 5. prefill ==")
    pre, pre_flash, pre_gemm = prefill(device, cfg)

    log("== 6. train ==")
    steps, train_gemm, peak_gib = train(device, cfg)

    log("== 7. numbers ==")
    rows, gemm_err = measure(device, [v.value for v in Variant])
    path_ms = measure_paths(device)
    frows, flash_err = measure_flash(device)
    reduction = bf16_reduction(device)
    _free(device)

    log("== 8. generate ==")
    gen, gen_gemm = generate(device, cfg)

    log("== 9. train driver ==")
    drv, drv_gemm = train_driver(device, cfg)

    log("== 10. cnn ==")
    cnns, cnn_gemm = cnn(device)
    c1 = c1_conv(device)

    log("== 11. serve: preemption, speculation, energy ==")
    more, more_gemm = serve_more(device, cfg)

    log("== 12. the decoder-only zoo at published widths ==")
    zrec, zoo_gemm, zoo_flash_n = zoo(device, ptxas)

    log("== 13. the rest of the zoo: Whisper, xLSTM, Zamba ==")
    t13 = time.perf_counter()
    rrec, rest_gemm, rest_flash_n = zoo_rest(device)
    rrec["seconds"] = time.perf_counter() - t13

    log("== 14. daism-lint and the launchers' preflight ==")
    t14 = time.perf_counter()
    lrec, lint_gemm = lint(device, ptxas)
    lrec["seconds"] = time.perf_counter() - t14

    log("== 15. mesh: multi-device serving's code on one card ==")
    t15 = time.perf_counter()
    mrec, mesh_gemm = mesh_phase(
        device, cfg, {"report": report, "launches": serve_launches},
        zrec["moe"])
    mrec["seconds"] = time.perf_counter() - t15

    log("== 16. train mesh: multi-device training's code on one card ==")
    t16 = time.perf_counter()
    trec, train_mesh_gemm = train_mesh(device, cfg, steps)
    trec["seconds"] = time.perf_counter() - t16

    log("== 17. roofline: remat, the roofline against the card, xLSTM and "
        "Zamba over a mesh, the dry-run ==")
    t17 = time.perf_counter()
    rfrec, roof_gemm = roofline_phase(device, cfg)
    rfrec["seconds"] = time.perf_counter() - t17

    log("== summary ==")
    log("  serve: " + report.summary().replace("\n", "\n  serve: "))
    for label, r in pre.items():
        if "ms" in r:
            warm = (f" (second forward {r['warm_ms']:.1f} ms)"
                    if "warm_ms" in r else "")
            log(f"  prefill {label}: {r['ms']:.1f} ms per forward, "
                f"{r['tok_s']:.1f} tok/s{warm}")
    for i, st in enumerate(steps):
        log(f"  train step {i + 1} ({st['backward']}): {st['ms']:.1f} ms")
    log(f"  decode_step (B = {GEN_BATCH}, {cfg.n_layers} layers): p50 "
        f"{gen['decode_ms_p50']:.2f} ms, mean {gen['decode_ms_mean']:.2f} ms")
    log(f"  train driver ({DRIVER_LAYERS} layers): train_step p50 "
        f"{drv['step_ms_p50']:.1f} ms; launch.train "
        f"{drv['launcher_s']:.1f} s for {DRIVER_STEPS} steps; checkpoint "
        f"{drv['checkpoint_bytes'] / 1e9:.3f} GB, save {drv['save_s']:.2f} / "
        f"{drv['final_save_s']:.2f} s, restore {drv['restore_s']:.2f} s")
    for net, r in cnns.items():
        log(f"  {net} (B = {r['batch']}, bf16): forward {r['fwd_ms']:.2f} ms;"
            " train steps " + ", ".join(f"{st['backward']} {st['ms']:.1f} ms"
                                        for st in r["steps"]))
    log(f"  C1: f32 exact conv card vs CPU {c1[0]:.3g} of max |ref| (TF32 "
        f"control {c1[1]:.3g}); bf16 x @ w shapes moved by the reduced-"
        "precision reduction flag: "
        f"{sum(any(d) for d in reduction.values())} of {len(reduction)}")
    sp = more["spec"]
    log(f"  serve (a): preempt {more['preempt']['tok_s']:.1f} decode tok/s "
        f"({more['preempt']['preemptions']} preemptions, peak concurrency "
        f"{more['preempt']['peak_active']}), reserve "
        f"{more['reserve']['tok_s']:.1f} (peak "
        f"{more['reserve']['peak_active']}); (b) plain "
        f"{sp['plain_tok_s']:.1f} vs speculative {sp['spec_tok_s']:.1f} "
        f"decode tok/s, accept rate {sp['accept_rate']:.3f}, verify step "
        f"{sp['verify_ms']:.2f} ms vs S=1 step {sp['step_ms']:.2f} ms; "
        f"(d) estimated multiply energy saved: "
        + ", ".join(f"{k} {100 * v:.1f}%"
                    for k, v in more["energy_saves"].items()))
    zm, zd = zrec["moe"], zrec["dense"]
    log(f"  zoo (a) qwen3_moe_235b (2 layers) serve {zm['tok_s']:.1f} decode "
        f"tok/s, TTFT p50 {zm['ttft_p50_ms']:.1f} ms, step p50 "
        f"{zm['step_p50_ms']:.2f} ms; (b) dbrx_132b (2 layers) forward S=256 "
        f"{zd['dbrx']['ms']:.1f} ms; (d) gemma_2b forward S={ZOO_GEMMA_SEQ} "
        + ", ".join(f"{k} {zd['gemma'][k]:.1f} ms"
                    for k, _ in PREFILL_POLICIES)
        + f"; (e) starcoder2_15b {zd['starcoder2_15b']['ms']:.1f} ms, "
        f"nemotron_4_340b (2 layers) {zd['nemotron_4_340b']['ms']:.1f} ms at "
        f"S={ZOO_DENSE_SEQ}; (f) llama_3_2_vision_11b forward "
        f"{zd['vlm']['ms']:.1f} ms, decode step p50 "
        f"{zd['vlm']['step_ms_p50']:.2f} ms")
    rw, rx, rz = rrec["whisper"], rrec["xlstm_1_3b"], rrec["zamba2_1_2b"]
    log(f"  zoo rest ({rrec['seconds']:.1f} s): (a) whisper_large_v3 "
        f"forward (1500 frames, S={WHISPER_SEQ}) "
        + ", ".join(f"{k} {rw[k]:.1f} ms" for k, _ in WHISPER_POLICIES)
        + f"; encode {rw['encode_ms']:.1f} ms, decode step p50 "
        f"{rw['step_ms_p50']:.2f} ms; (b) xlstm_1_3b forward S={RNN_SEQ} "
        f"{rx['pc3_tr_ms']:.1f} ms (exact GEMMs {rx['exact_ms']:.1f}), "
        f"decode step p50 {rx['step_ms_p50']:.2f} ms; (c) zamba2_1_2b "
        f"{rz['pc3_tr_ms']:.1f} ms (exact GEMMs {rz['exact_ms']:.1f}), "
        f"decode step p50 {rz['step_ms_p50']:.2f} ms; ring card vs CPU "
        f"{rrec['zamba_ring']:.3g}; (d) card vs CPU "
        + ", ".join(f"{k} {v:.3g}" for k, v in rrec["card_vs_cpu"].items()))
    log(f"  lint ({lrec['seconds']:.1f} s): --all {lrec['all_s']:.2f} s; "
        "aborts " + ", ".join(f"{k} {v:.2f} s"
                              for k, v in lrec["abort_s"].items())
        + f"; serve {lrec['serve_s']:.2f} s (preflight "
        f"{lrec['preflight_s']['serve']:.2f} s), train "
        f"{lrec['train_s']:.2f} s (preflight "
        f"{lrec['preflight_s']['train']:.2f} s); GEMM shared memory "
        + ", ".join(f"{k} {v} B" for k, v in lrec["smem"].items()))
    mt, mm = mrec["tinyllama"], mrec["moe"]
    log(f"  mesh ({mrec['seconds']:.1f} s): (b) TinyLlama under a 1-way mesh "
        f"{mt['tok_s']:.1f} decode tok/s, TTFT p50 {mt['ttft_p50_ms']:.1f} "
        f"ms (phase 4: {mt['base_tok_s']:.1f}, {mt['base_ttft_p50_ms']:.1f} "
        f"ms), NCCL collectives {mt['collectives']}; (c) Qwen3-MoE EP "
        f"{mm['tok_s']:.1f} tok/s, TTFT p50 {mm['ttft_p50_ms']:.1f} ms, step "
        f"p50 {mm['step_p50_ms']:.2f} ms (dense {mm['dense']['tok_s']:.1f} "
        f"tok/s, {mm['dense']['ttft_p50_ms']:.1f} ms, "
        f"{mm['dense']['step_p50_ms']:.2f} ms), capacity {mm['caps']}")
    ta, tb = trec["tinyllama"], trec["moe"]
    log(f"  train mesh ({trec['seconds']:.1f} s): (a) TinyLlama under the 1x1"
        f" mesh " + ", ".join(f"{st['ms']:.1f}" for st in ta["steps"])
        + " ms a step (no mesh " + ", ".join(f"{v:.1f}" for v in ta["ref_ms"])
        + f"), {'bit for bit' if not ta['gaps'] else 'gaps printed above'}"
        f", peak {ta['peak_gib']:.2f} GiB; (b) Qwen3-MoE (1 layer) EP step "
        f"{tb['ep_ms']:.1f} ms, dense MoE {tb['dense_ms']:.1f} ms, C = "
        f"{tb['c']}; (c) pipeline gradient "
        f"{'bit for bit' if trec['pipeline']['bitwise'] else 'within 1e-4'}"
        f"; (d) save {ta['save_s']:.2f} s, restore {ta['restore_s']:.2f} s, "
        f"launcher {trec['launcher']['launch_s'][0]:.1f} + "
        f"{trec['launcher']['launch_s'][1]:.1f} s")
    ra_, rb_ = rfrec["remat"], rfrec["roofline"]
    log(f"  roofline ({rfrec['seconds']:.1f} s): (a) remat step ms "
        + ", ".join(f"{m} {r['ms'][-1]:.1f} ({r['peak_gib']:.2f} GiB)"
                    for m, r in ra_.items())
        + "; (b) " + ", ".join(
            f"{k} {r['ms']:.2f} ms = {r['ms_over_bound']:.2f} x bound "
            f"{r['bound_ms']:.3f} ms ({r['bottleneck']}), memory estimate "
            f"{r['est_over_peak']:.2f} x peak" for k, r in rb_.items())
        + "; (c) " + ", ".join(f"{k} forward {r['mesh_fwd_ms']:.1f} ms"
                               for k, r in rfrec["families"].items())
        + "; (d) " + ", ".join(f"{k} {r['wall_s']:.1f} s"
                               for k, r in rfrec["dryrun"].items()))
    rep = next(r for r in rows if (r["variant"], r["m"], r["k"], r["n"])
               == REPRESENTATIVE)
    xrep = next(r for r in rows if (r["variant"], r["m"], r["k"], r["n"])
                == ("exact", *REPRESENTATIVE[1:]))
    frep = {r["variant"]: r for r in frows}
    record = {"kernels": [{
        "name": "daism_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/daism_matmul.cu",
        "replaces": "src/repro/kernels/daism_matmul.py:43",
        "launches": (serve_launches + pre_gemm + train_gemm + gen_gemm
                     + drv_gemm + cnn_gemm + more_gemm + zoo_gemm
                     + rest_gemm + lint_gemm + mesh_gemm
                     + train_mesh_gemm + roof_gemm),
        "max_abs_err": max(max_err, gemm_err, rrec["gemm_err"],
                           mrec["gemm_err"], mrec["moe"]["gemm_err"],
                           tb["gemm_err"]),
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "variant": rep["variant"],
        "shape": [rep["m"], rep["k"], rep["n"]],
        "tile_path_ms": path_ms[REPRESENTATIVE[1:]]["tile"],
        "im2col": [{k: r[k] for k in ("m", "k", "n", "ms", "plain_ms",
                                      "bound_ms", "bound_by")}
                   for r in rows if (r["m"], r["k"], r["n"]) in IM2COL_SHAPES],
        "verify": [{k: r[k] for k in ("m", "k", "n", "ms", "plain_ms",
                                      "bound_ms", "bound_by")}
                   for r in rows if r["variant"] == "pc3_tr"
                   and r["m"] == VERIFY_M],
        "exact": {k: xrep[k] for k in
                  ("ms", "path", "paths", "wrapper_ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms", "f32_library_ms")}
        | {"shape": [xrep["m"], xrep["k"], xrep["n"]]},
        "experts": zrec["experts"],
        "zoo_rest": rrec["gemms"],
        "mesh": mrec["gemms"],
        "mesh_experts": mrec["moe"]["experts"],
        "train_mesh_experts": tb["experts"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:54",
        "launches": pre_flash + zoo_flash_n + rest_flash_n,
        "max_abs_err": max(flash_errs["exact"], flash_errs["approx"],
                           flash_err, zrec["flash_err"], rrec["flash_err"]),
        "ms": frep["exact"]["ms"],
        "plain_ms": frep["exact"]["plain_ms"],
        "bound_ms": frep["exact"]["bound_ms"],
        "bound_by": frep["exact"]["bound_by"],
        "library_ms": frep["exact"]["library_ms"],
        "variant": "exact",
        "shape": list(FLASH_TIMED),
        "approx": {k: frep["pc3_tr"][k] for k in
                   ("variant", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
        "large_d": zrec["flash"],
        "whisper": rrec["whisper_flash"],
    }]}
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
