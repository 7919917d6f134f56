"""Port parity: multi-device training (FSDP + tensor parallel) on ``gloo``
ranks against the reference on fake host devices.

The scenario is ``tests/test_system.py::test_distributed_train_and_elastic_restore``
on the f32 TinyLlama smoke config (2 layers, vocab 64): a 4 x 2 ``data`` x
``model`` mesh, B = 8, S = 16, warmup 2 of 40, 15 ``train_step``s, a
checkpoint, and a restore onto 2 x 2. The reference runs it in a
subprocess on 8 fake host devices with directly built ``Mesh``es
(``tests/jax_dist_train.py``; ``jax.make_mesh`` makes Explicit axes, which
its sharding constraints refuse, ROADMAP C2); the port on 8 ranks
(``tests/torch_ranks.py`` under ``run_ranks``: one torch thread a rank, a
deadline, a 60 s group timeout) from the reference's initial weights.

Claims: per-step losses and grad norms, and the final parameters as one
update vector (its L2 error over the 15 steps' L2 move), within
``tests/test_torch_train.py``'s ``TRAIN_TOL`` for ``*=exact`` and for
PC3_TR with the STE backward, and the step-1 gradient leaf by leaf within
``GRAD_TOL``; the port's checkpoint restored onto 2 x 2
equals the saved tree bit for bit on every rank, and the reference's
checkpoint restored by the port equals the reference's own 2 x 2 restore.
``pipeline_apply``'s gradient on 4 stages matches sequential autograd
within 1e-4 (the reference's ``tests/test_pipeline.py`` bound) for M in 2,
4 and 8; ``launch.train --devices 8 --mesh 4x2`` runs, checkpoints and
resumes under ``--mesh auto``, which picks the reference's 4 x 2.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.launch.mesh import run_ranks  # noqa: E402

import torch_ranks  # noqa: E402
from test_torch_train import TRAIN_TOL  # noqa: E402

HERE = os.path.dirname(__file__)
CFG = dict(n_layers=2, vocab=64, param_dtype="float32",
           compute_dtype="float32")
RUNS = [dict(name=f"tl_{kind}", arch="tinyllama_1_1b", cfg=CFG, kind=kind,
             mesh=[4, 2], warmup=2, total=40, batch=8, seq=16, steps=15,
             ckpt=f"ck_{kind}")
        for kind in ("exact", "ste")]
MICRO = (2, 4, 8)


def _pipe():
    rng = np.random.default_rng(0)
    L, B, D = 8, 16, 32
    return {"params": {"w": (rng.normal(size=(L, D, D)) / np.sqrt(D)
                             ).astype(np.float32),
                       "b": (rng.normal(size=(L, D)) * 0.1
                             ).astype(np.float32)},
            "x": rng.normal(size=(B, D)).astype(np.float32),
            "microbatches": MICRO}


PIPE = _pipe()


def reference_runs(out_dir, runs, timeout=400):
    """``tests/jax_dist_train.py`` on 8 fake host devices; its npz files
    by run name, and the directory (initial weights, checkpoints)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "jax_dist_train.py"),
         str(out_dir), json.dumps({"runs": runs})],
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=timeout)
    assert "REFERENCE-OK" in proc.stdout, proc.stderr[-3000:]
    out = {}
    for run in runs:
        with np.load(os.path.join(out_dir, run["name"] + ".npz")) as f:
            out[run["name"]] = {k: f[k] for k in f.files}
    return out


# the step-1 gradient of every leaf (AdamW's first moment after step 1, at
# the initial weights): L2 error over the reference's L2 norm, leaf by leaf.
# exact: the largest measured gap is 7.3e-7 (MoE ids, every mesh). STE: the
# reference's gap is up to 4.5e-3 (the router), and moving the port's own
# initial weights by one f32 ulp moves its step-1 gradient by up to 8.2e-3
# in a leaf (the PC3_TR product is a step function of its operands);
# either bound is far below the 0.3-1 that a missing sum over ranks or a
# wrong scale gives a leaf.
GRAD_TOL = {"exact": 1e-5, "ste": 2e-2}


def check_run(got, want, kind, what, tol=None, skip=()):
    """Losses and grad norms step by step within ``TRAIN_TOL[kind]`` (or
    ``tol``); the step-1 gradient leaf by leaf within ``GRAD_TOL[kind]``;
    the final parameters as one update vector: L2 error over the L2 move
    from the initial weights ``init`` (leaves named in ``skip`` left
    out)."""
    loss_rel, gn_rel, p_rel = tol or TRAIN_TOL[kind]
    for key, rel in (("loss", loss_rel), ("grad_norm", gn_rel)):
        g, w = np.asarray(got[key]), want[key]
        assert np.isfinite(g).all() and (np.abs(g - w) <= rel * np.abs(w)
                                         ).all(), (what, key, g, w)
    init = got["init"]
    p = {k: v for k, v in got["params"].items() if k not in skip}
    for k in p:
        g, w = got["m1"][k], want["m1/" + k]
        err = np.linalg.norm(g - w)
        assert err <= GRAD_TOL[kind] * np.linalg.norm(w), (
            what, "step-1 gradient", k, err, np.linalg.norm(w))
    err = np.sqrt(sum(np.sum((p[k] - want["p/" + k]) ** 2) for k in p))
    moved = np.sqrt(sum(np.sum((want["p/" + k] - init[k]) ** 2) for k in p))
    assert moved > 0 and err <= p_rel * moved, (what, err, moved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    ref = reference_runs(d, RUNS)
    port = run_ranks(torch_ranks.train_runs, 8, RUNS, str(d), (4, 2),
                     str(d / "port"), timeout_s=400)[0]
    with np.load(d / "init_tinyllama_1_1b.npz") as f:
        init = {k: f[k] for k in f.files}
    for r in port.values():
        r["init"] = init
    return d, ref, port


@pytest.mark.parametrize("kind", ["exact", "ste"])
def test_train_4x2_matches_the_reference(runs, kind):
    _, ref, port = runs
    check_run(port[f"tl_{kind}"], ref[f"tl_{kind}"], kind, kind)


@pytest.fixture(scope="module")
def four(runs):
    """The 4-rank jobs: both checkpoints onto 2 x 2, and the pipeline."""
    d, _, _ = runs
    dirs = {"port": str(d / "port" / "ck_exact"), "ref": str(d / "ck_exact")}
    return run_ranks(torch_ranks.four_ranks, 4, (CFG, dirs, 15), PIPE, None,
                     None, timeout_s=300)


def test_restore_onto_2x2_is_bit_for_bit(runs, four):
    """Every rank's shards equal the stored arrays (checked on the ranks);
    gathered, the port's restore of its own checkpoint is the tree it
    trained, and of the reference's checkpoint the reference's own 2 x 2
    restore, bit for bit."""
    _, ref, port = runs
    restored = four[0]["restore"]
    for k, v in port["tl_exact"]["params"].items():
        np.testing.assert_array_equal(restored["port"][k], v, err_msg=k)
    for k, v in restored["ref"].items():
        np.testing.assert_array_equal(v, ref["tl_exact"]["r/" + k],
                                      err_msg=k)
        np.testing.assert_array_equal(v, ref["tl_exact"]["p/" + k],
                                      err_msg=k)


def _sequential_grads(pipe):
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in pipe["params"].items()}
    x = torch.from_numpy(pipe["x"]).requires_grad_()
    h = x
    for i in range(pipe["params"]["w"].shape[0]):
        h = torch.tanh(h @ p["w"][i] + p["b"][i])
    return [t.numpy() for t in torch.autograd.grad((h ** 2).sum(),
                                                   [p["w"], p["b"], x])]


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_gradient_on_4_stages_matches_sequential(four, m):
    """The reverse schedule's gradients of the whole tree and of ``x``,
    whole on every rank, against sequential autograd (1e-4)."""
    want = _sequential_grads(PIPE)
    for job in four:
        for got, ref in zip(job["pipe"][m], want):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_pipeline_gradient_on_one_stage_is_autograd_through_the_loop():
    """One stage: plain autograd through the microbatch loop (no process
    group), equal to the sequential loop's gradient up to the microbatch
    sums (f32 order)."""
    from repro_torch.parallel.pipeline import pipeline_apply

    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in PIPE["params"].items()}
    x = torch.from_numpy(PIPE["x"]).requires_grad_()
    y = pipeline_apply(lambda q, h: torch.tanh(h @ q["w"] + q["b"]), p, x,
                       {"stage": 1}, n_microbatches=4)
    got = torch.autograd.grad((y ** 2).sum(), [p["w"], p["b"], x])
    for g, ref in zip(got, _sequential_grads(PIPE)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5)


def _launch(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_launcher_on_8_ranks_checkpoints_and_resumes(tmp_path):
    """``--devices 8 --mesh 4x2``: rank 0 prints the mesh and the steps;
    run again to step 6 under ``--mesh auto`` (the reference's
    ``best_effort_mesh(model_parallel=2)``: 4 x 2), it resumes at step 4."""
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
            "--devices", "8", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1", "--no-preflight"]
    out = _launch(argv + ["--mesh", "4x2", "--steps", "4"])
    assert "mesh: {'data': 4, 'model': 2}" in out
    assert "step     4 loss" in out and "done at step 4" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    out = _launch(argv + ["--steps", "6"])
    assert "mesh: {'data': 4, 'model': 2}" in out
    assert "step     4 loss" not in out and "step     5 loss" in out
    assert "done at step 6" in out
