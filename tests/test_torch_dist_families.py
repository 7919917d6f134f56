"""Port parity: xLSTM, Zamba and heads that a ``model`` axis cuts inside,
laid out over meshes, against the reference on the same mesh; and the
collective tally of a process-group run against a ``meta`` trace.

* xLSTM-1.3B and Zamba2-1.2B (f32 smoke configs, vocab 64: xLSTM's two
  layers hold an mLSTM and an sLSTM block, Zamba's three a shared
  attention site and a tail block) on 2 x 2 and 4 x 2 ``data`` x
  ``model`` meshes: ``prefill_step``'s logits (the forward) and 4
  ``decode_step``s from a sharded ``init_cache`` (xLSTM's states split by
  rows, Zamba's ``conv`` over ``act_mlp`` and ``ssm`` over ``act_heads``)
  within 1e-5 of the largest logit, and 3 train steps under ``*=exact``
  and PC3_TR with the STE backward within ``tests/test_torch_train.py``'s
  ``TRAIN_TOL`` (the step-1 gradient leaf by leaf within
  ``tests/test_torch_dist_train.py``'s ``GRAD_TOL``). A 2-way ``model``
  axis cuts xLSTM's ``wgate`` (``[i | f | o]``, 12 columns) inside its
  ``f`` block and Zamba's ``in_proj`` at ``[xs | z]``: the port gathers
  them whole (``models/xlstm.py``, ``models/zamba.py``).
* TinyLlama with 4 q and 2 kv heads on 2 x 4: the 4-way ``model`` axis
  gives each rank one q head and half a kv head, so q, k and v are
  gathered and every rank attends on every head (``models/layers.py``);
  the same checks.
* The group calls of one 2 x 2 ``gloo`` train step of a TinyLlama smoke
  config (``parallel.sharding.record_collectives``) equal those of the
  same step traced on ``meta`` under a sizes-only ``{data: 2, model: 2}``
  sharder: the same ops, in the same order, with the same bytes, group
  sizes and wire bytes.

The reference runs in a subprocess on 8 fake host devices with directly
built ``Mesh``es (``tests/jax_dist_train.py``); the port on ``gloo``
ranks (``tests/torch_ranks.py``: one torch thread a rank, a deadline, a
60 s group timeout). These tests replace
``test_torch_dist_moe.py::test_families_without_sharded_layers_are_refused_over_a_mesh``:
the refusal is gone.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.roofline.flops import count  # noqa: E402

import torch_ranks  # noqa: E402
from test_torch_dist_train import check_run, reference_runs  # noqa: E402

CFG = dict(n_layers=2, vocab=64, param_dtype="float32",
           compute_dtype="float32")
FAMILIES = ("xlstm_1_3b", "zamba2_1_2b")
MESHES = ((2, 2), (4, 2))
SPLIT = dict(CFG, n_heads=4, kv_heads=2)   # TinyLlama on 2 x 4


def _run(arch, kind, mesh, cfg):
    return dict(name=f"{arch}_{kind}_{mesh[0]}x{mesh[1]}", arch=arch,
                cfg=cfg, kind=kind, mesh=list(mesh), warmup=1, total=100,
                batch=8, seq=16, steps=3)


def _cfg(arch):
    # Zamba's smoke config keeps its 3 layers: a shared site and a tail
    return dict(CFG, n_layers=3) if arch == "zamba2_1_2b" else CFG


RUNS = {}
for arch in FAMILIES:
    for mesh in MESHES:
        for kind in ("exact", "ste"):
            RUNS[(arch, kind, mesh)] = _run(arch, kind, mesh, _cfg(arch))
        RUNS[(arch, "decode", mesh)] = dict(
            _run(arch, "exact", mesh, _cfg(arch)),
            name=f"{arch}_decode_{mesh[0]}x{mesh[1]}", batch=4, seq=4,
            decode=True)
for kind in ("exact", "ste"):
    RUNS[("tinyllama_1_1b", kind, (2, 4))] = _run("tinyllama_1_1b", kind,
                                                  (2, 4), SPLIT)
RUNS[("tinyllama_1_1b", "decode", (2, 4))] = dict(
    _run("tinyllama_1_1b", "exact", (2, 4), SPLIT),
    name="tinyllama_1_1b_decode_2x4", batch=4, seq=4, decode=True)
TRAIN = [c for c in RUNS if c[1] != "decode"]
DECODE = [c for c in RUNS if c[1] == "decode"]
# the noted step: TinyLlama's smoke config (4 q, 2 kv heads) over 2 x 2
TALLY = ("tinyllama_1_1b", dict(CFG), (2, 2))


def _tally_batch():
    return next(lm_batches(CFG["vocab"], 4, 8, seed=0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_families")
    ref = reference_runs(d, list(RUNS.values()))
    by_mesh = {}
    for c, run in RUNS.items():
        by_mesh.setdefault(c[2], []).append(run)
    port, calls = run_ranks(torch_ranks.families, 4, by_mesh[(2, 2)],
                            str(d), (2, 2),
                            TALLY[:2] + (_tally_batch(), TALLY[2]),
                            timeout_s=300)[0]
    for mesh in ((4, 2), (2, 4)):
        port.update(run_ranks(torch_ranks.families, 8, by_mesh[mesh],
                              str(d), mesh, timeout_s=300)[0][0])
    for c, run in RUNS.items():
        with np.load(d / f"init_{c[0]}.npz") as f:
            port[run["name"]]["init"] = {k: f[k] for k in f.files}
    return ref, port, calls


@pytest.mark.parametrize("arch,kind,mesh", TRAIN)
def test_train_over_a_mesh_matches_the_reference(runs, arch, kind, mesh):
    ref, port, _ = runs
    name = RUNS[(arch, kind, mesh)]["name"]
    check_run(port[name], ref[name], kind, name)


@pytest.mark.parametrize("arch,kind,mesh", DECODE)
def test_forward_and_decode_over_a_mesh_match_the_reference(runs, arch,
                                                            kind, mesh):
    """The forward (``prefill_step``) and 4 ``decode_step``s from a sharded
    ``init_cache``, rows gathered whole, within 1e-5 of the largest
    logit (f32, ``*=exact``)."""
    ref, port, _ = runs
    name = RUNS[(arch, kind, mesh)]["name"]
    for key in ("prefill", "decode"):
        got, want = port[name][key], ref[name][key]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, key, err)


def test_meta_trace_notes_the_group_calls_of_a_gloo_step(runs):
    _, _, calls = runs
    arch, cfg_kw, mesh = TALLY
    art = build_artifacts(get_config(arch).smoke(**cfg_kw),
                          dict(zip(("data", "model"), mesh)), device="meta")
    params = art.init_params()
    batch = _tally_batch()
    shard = art.batch_sharding(batch)
    rows = {k: torch.empty(art.sharder.local_shape(v.shape, shard[k].spec),
                           dtype=torch.as_tensor(v).dtype, device="meta")
            for k, v in batch.items()}
    _, _, meta_calls = count(art.train_step, params, art.init_opt(params),
                             rows)
    got = [dataclasses.astuple(c) for c in meta_calls]
    assert len(calls) > 20 and {c[0] for c in calls} == {"all-reduce",
                                                         "all-gather"}
    assert got == calls
