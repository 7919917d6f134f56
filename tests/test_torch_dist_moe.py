"""Port parity: expert-parallel MoE training over meshes, the gradient of
every kind of sharded call site, and the VLM and Whisper over a mesh.

* Qwen3-MoE and DBRX (f32 smoke, 2 layers, vocab 128; B = 8, S = 16, 3
  steps, warmup 1) train through EP on 1 x 1, 2 x 2 and 4 x 2 ``data`` x
  ``model`` meshes under ``*=exact`` and under PC3_TR with the STE
  backward. Capacity is counted per data shard, so the loss depends on
  the mesh; the oracle is the reference's step on the same mesh
  (``tests/jax_dist_train.py``, 8 fake host devices, directly built
  ``Mesh``es). The step-1 gradient of every leaf within ``GRAD_TOL``
  (exact 1e-5, STE 2e-2; ``tests/test_torch_dist_train.py``): this is
  what holds the STE backward and its sums over the ranks. Under
  ``*=exact`` losses and grad norms within
  ``tests/test_torch_moe_train.py``'s ``TRAIN_TOL``; under STE within
  ``tests/test_torch_train.py``'s STE bounds, not the MoE file's: those
  are 1.5-2x the gap of one B = 2 draw, and the computation is less well
  conditioned than that. The PC3_TR product is a step function of its
  operands (a one-ulp change of an f32 operand changes 0.35% of the
  products, by up to 2^-10 of the product), so moving the port's own
  initial weights by one ulp moves its STE loss by up to 2.4e-4 at step 1
  and its grad norm by up to 2.6e-3 by step 3. Against the reference the
  step-1 loss differs by 2.8e-5 to 1.3e-4 on the three meshes, with every
  token routed to the same experts and nothing dropped in steps 1-2 (1 x
  1); after the first update one or two of 128 tokens in layer 1 choose
  another expert (the gaps of every mesh: ``PERF.md`` §7). The final
  parameters as one update vector within ``tests/test_torch_train.py``'s
  bound for the kind. The port's 1 x 1 is ``build_artifacts`` without a
  mesh (its sizes-only sharder); 2 x 2 and 4 x 2 run on 4 and 8 ``gloo``
  ranks (``tests/torch_ranks.py``).
* Prefill and decode over 2 x 2: TinyLlama, Qwen3-MoE, the VLM and
  Whisper, ``prefill_step`` and 8 ``decode_step``s from a sharded
  ``init_cache``, against the reference on the same mesh.
* The gradient of ``sum(out * G)`` through each call site kind (column-
  and row-parallel with FSDP gathers: ``mlp``; a row-parallel K sliced
  from a whole ``x``; vocab-parallel ``embed`` + ``unembed``; EP at a
  capacity that drops nothing) on 2 and 4 ranks, against the same function
  run whole in this process, f32, within 1e-6 of the largest gradient.
* the other families: Llama-3.2-Vision and Whisper (``EncDecLM``) train
  over 2 x 2 against the reference on the same mesh (xLSTM and Zamba:
  ``tests/test_torch_dist_families.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.layers import (FFN_AXES, embed, mlp,  # noqa: E402
                                       sharded_dot, unembed)
from repro_torch.models.module import Ctx  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402
from repro_torch.parallel.sharding import (Sharder, base_rules,  # noqa: E402
                                           use_sharder)
from repro_torch.policy import OpKind  # noqa: E402

import torch_ranks  # noqa: E402
from test_torch_dist_train import check_run, reference_runs  # noqa: E402
from test_torch_moe_train import TRAIN_TOL as MOE_TOL  # noqa: E402
from test_torch_train import TRAIN_TOL  # noqa: E402

MOE = ("qwen3_moe_235b", "dbrx_132b")
CFG = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
CASES = [(arch, kind, mesh) for arch in MOE
         for kind, mesh in (("exact", (1, 1)), ("exact", (2, 2)),
                            ("exact", (4, 2)), ("ste", (4, 2)))]
CASES += [(arch, "ste", mesh) for arch in MOE for mesh in ((1, 1), (2, 2))]


def _run(arch, kind, mesh):
    return dict(name=f"{arch}_{kind}_{mesh[0]}x{mesh[1]}", arch=arch,
                cfg=CFG, kind=kind, mesh=list(mesh), warmup=1, total=100,
                batch=8, seq=16, steps=3)


RUNS = {c: _run(*c) for c in CASES}
# the other families over 2 x 2: two steps (warmup 1: the second moves the
# parameters), f32 smoke configs, *=exact
FAMILIES = ("llama_3_2_vision_11b", "whisper_large_v3")
RUNS.update({(arch, "exact", (2, 2)): dict(
    _run(arch, "exact", (2, 2)), cfg=dict(CFG, vocab=64), steps=2)
    for arch in FAMILIES})
# prefill and decode over 2 x 2 (the train rules: rows over data, heads
# and experts over model), B = 4, S = 8, *=exact; each id on its train
# runs' config (one initial draw an id)
SERVED = ("tinyllama_1_1b", "qwen3_moe_235b") + FAMILIES
RUNS.update({(arch, "decode", (2, 2)): dict(
    _run(arch, "exact", (2, 2)), name=f"{arch}_decode_2x2", batch=4, seq=8,
    decode=True, cfg=CFG if arch in MOE else dict(CFG, vocab=64))
    for arch in SERVED})

# ---------------------------------------------------------------------------
# the call sites' gradients: inputs and cases
# ---------------------------------------------------------------------------


def _grad_arrays():
    rng = np.random.default_rng(3)
    d, ff, v, e, eff = 64, 128, 64, 4, 64

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    return {"wi": w(d, ff), "wg": w(d, ff), "wo": w(ff, d),
            "w_row": w(ff, d), "embedding": w(v, d), "lm_head": w(d, v),
            "router": w(d, e), "w_in": w(e, d, eff), "w_gate": w(e, d, eff),
            "w_out": w(e, eff, d),
            "x": rng.normal(size=(4, 8, d)).astype(np.float32),
            "h": rng.normal(size=(4, 8, ff)).astype(np.float32),
            "tokens": rng.integers(0, v, size=(4, 8)),
            "g_mlp": rng.normal(size=(4, 8, d)).astype(np.float32),
            "g_row_whole_x": rng.normal(size=(4, 8, d)).astype(np.float32),
            "g_lm": rng.normal(size=(4, 8, v)).astype(np.float32),
            "g_ep": rng.normal(size=(4, 8, d)).astype(np.float32)}


GRAD = _grad_arrays()
# name -> (kind, mesh, serve rules); n ranks each
GRAD_CASES = {
    n: {f"{kind} {shape[0]}x{shape[1]}": (kind, shape, kind == "row_whole_x")
        for kind in ("mlp", "lm", "ep", "row_whole_x")
        for shape in ([(1, n), (n, 1)] + ([(2, 2)] if n == 4 else []))
        if kind != "row_whole_x" or shape[0] == 1}
    for n in (2, 4)}


def _whole_grads(kind):
    """The same function whole in this process: no sharder, or (EP) the
    sizes-only 1 x 1 one, whose capacity takes every token here too."""
    cfg = tget("dbrx_132b" if kind == "ep" else "tinyllama_1_1b").smoke(
        param_dtype="float32", compute_dtype="float32", vocab=64,
        capacity_factor=2.0)
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in GRAD.items()
         if v.dtype == np.float32 and not k.startswith("g_")
         and k not in ("x", "h")}
    g = torch.from_numpy(GRAD["g_" + kind])
    sharder = (Sharder({"data": 1, "model": 1}, base_rules(False))
               if kind == "ep" else None)
    with use_sharder(sharder), torch.enable_grad():
        ins = []
        if kind == "lm":
            y = unembed(Ctx(w), embed(Ctx(w), torch.from_numpy(
                GRAD["tokens"]), cfg), cfg)
            used = ("embedding", "lm_head")
        else:
            x = torch.from_numpy(GRAD["h" if kind == "row_whole_x"
                                      else "x"]).requires_grad_()
            ins = [x]
            if kind == "mlp":
                y, used = mlp(Ctx(w), x, cfg), ("wi", "wg", "wo")
            elif kind == "row_whole_x":
                y, _ = sharded_dot(cfg, x, w["w_row"], name="w_row",
                                   kind=OpKind.DENSE, axes=FFN_AXES["wo"],
                                   shape=GRAD["w_row"].shape)
                used = ("w_row",)
            else:
                (y, _), used = moe_ffn(Ctx(w), x, cfg), ("router", "w_in",
                                                          "w_gate", "w_out")
        got = torch.autograd.grad((y * g).sum(), ins + [w[k] for k in used])
    out = {k: t.numpy() for k, t in zip(used, got[len(ins):])}
    if ins:
        out["x"] = got[0].numpy()
    return out


# ---------------------------------------------------------------------------
# fixtures: the reference, then 8, 4 and 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, the port's on 8 ranks (4 x 2), on 4 (2 x 2,
    with the 4-rank call sites) and in this process (1 x 1), and the
    call sites on 2 ranks."""
    d = tmp_path_factory.mktemp("dist_moe")
    ref = reference_runs(d, list(RUNS.values()))
    by_mesh = {}
    for c, run in RUNS.items():
        by_mesh.setdefault(c[2], []).append(run)
    port = dict(run_ranks(torch_ranks.train_runs, 8, by_mesh[(4, 2)],
                          str(d), (4, 2), timeout_s=400)[0])
    four = run_ranks(torch_ranks.four_ranks, 4, None, None,
                     (GRAD, GRAD_CASES[4]),
                     (by_mesh[(2, 2)], str(d), (2, 2)), timeout_s=400)[0]
    port.update(four["moe"])
    for run in by_mesh[(1, 1)]:
        port[run["name"]] = torch_ranks.train_run(run, str(d), None)
    two = run_ranks(torch_ranks.grad_sites, 2, GRAD, GRAD_CASES[2],
                    timeout_s=300)[0]
    inits = {}
    for arch in {c[0] for c in RUNS}:
        with np.load(d / f"init_{arch}.npz") as f:
            inits[arch] = {k: f[k] for k in f.files}
    for c, run in RUNS.items():
        port[run["name"]]["init"] = inits[c[0]]
    return ref, port, {2: two, 4: four["grads"]}


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_moe_ep_train_matches_the_reference_on_the_same_mesh(runs, arch,
                                                             kind, mesh):
    ref, port, _ = runs
    name = RUNS[(arch, kind, mesh)]["name"]
    tol = (MOE_TOL[(arch, kind)] + TRAIN_TOL[kind][2:]
           if kind == "exact" else None)
    check_run(port[name], ref[name], kind, name, tol=tol)


@pytest.mark.parametrize("n,name", [(n, name) for n in (2, 4)
                                    for name in GRAD_CASES[n]])
def test_call_site_gradients_match_the_whole_function(runs, n, name):
    """Weights' gradients gathered over their specs, the input's over its
    rows, against the whole function's, within 1e-6 of the largest."""
    got = runs[2][n][name]
    want = _whole_grads(GRAD_CASES[n][name][0])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-6 * np.abs(w).max(), (name, k, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_2x2_matches_the_reference(runs, arch):
    """Llama-3.2-Vision (its cross blocks head-local like the self
    attention) and Whisper (``EncDecLM``: biases and ``enc_pos`` gathered
    over ``data``) train over 2 x 2 as the reference does on the same
    mesh, within ``TRAIN_TOL["exact"]``. Whisper's key biases (``wk_b``)
    are left out of the parameter comparison: a bias added to every key
    shifts a query's scores by one constant, so their gradient is 0 but
    for rounding, and AdamW turns that noise into updates of ~lr either
    way (the port's run without a mesh differs from the reference's 1 x 1
    run there by 1.1-1.6x their move too)."""
    ref, port, _ = runs
    name = RUNS[(arch, "exact", (2, 2))]["name"]
    skip = [k for k in port[name]["params"] if k.endswith("/wk_b")]
    check_run(port[name], ref[name], "exact", name, skip=skip)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_2x2_match_the_reference(runs, arch):
    """``prefill_step`` on this rank's rows and 8 ``decode_step``s from a
    sharded ``init_cache`` (rows over data, kv heads over model) give the
    reference's logits on the same mesh, rows gathered whole, within 1e-5
    of the largest logit (f32, ``*=exact``)."""
    ref, port, _ = runs
    name = RUNS[(arch, "decode", (2, 2))]["name"]
    for key in ("prefill", "decode"):
        got, want = port[name][key], ref[name][key]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (key, err)
