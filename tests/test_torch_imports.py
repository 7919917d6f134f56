"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports jax or the JAX package; chip_smoke.py refuses to run without a card
or outside a checkout."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest


torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + str(ROOT))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 25
    assert {"repro_torch.models.moe", "repro_torch.configs.gemma_2b",
            "repro_torch.configs.qwen3_moe_235b",
            "repro_torch.configs.llama_3_2_vision_11b",
            "repro_torch.models.xlstm", "repro_torch.models.zamba",
            "repro_torch.configs.whisper_large_v3",
            "repro_torch.configs.xlstm_1_3b",
            "repro_torch.configs.zamba2_1_2b",
            *MULTI_DEVICE, *ROOFLINE} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


MULTI_DEVICE = ("repro_torch.parallel", "repro_torch.parallel.sharding",
                "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
                "repro_torch.optim.grad_compress",
                # multi-device training: the steps, the data's shards, the
                # optimizer's global norm, checkpoints, the loop, launcher
                "repro_torch.launch.steps", "repro_torch.data.synthetic",
                "repro_torch.optim.adamw",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.runtime.fault_tolerance",
                "repro_torch.launch.train")


# the roofline and the dry-run (counting on meta, the H100's terms, the
# tables, the CLI; unroll is the reference's copy for the API)
ROOFLINE = ("repro_torch.roofline", "repro_torch.roofline.flops",
            "repro_torch.roofline.analysis", "repro_torch.roofline.report",
            "repro_torch.launch.dryrun", "repro_torch.parallel.unroll")


@pytest.mark.parametrize("mod", MULTI_DEVICE + ROOFLINE)
def test_multi_device_module_imports_without_jax(mod):
    """Each multi-device module alone, in a fresh process: no jax, no JAX
    package, and no process group brought up by importing it."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kc_sweep_tool_imports_without_jax_and_needs_a_card():
    """tools/gemm_kc_sweep.py (the K chunk's measurement) stands alone too,
    and refuses to run without a card."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('tools/gemm_kc_sweep.py', run_name='kc_sweep')\n"
        "from repro_torch.kernels import build, daism_matmul\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run("import runpy; runpy.run_path('tools/gemm_kc_sweep.py', "
                "run_name='__main__')")
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr


@pytest.mark.parametrize("tool", ["tools/exact_plan_sweep.py",
                                  "tools/ab_trees.py"])
def test_exact_and_ab_tools_import_without_jax(tool):
    """The EXACT plan's sweep and the parent-vs-change comparison stand
    alone too; the sweep refuses to run without a card."""
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({tool!r}, run_name='tool')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if tool.endswith("ab_trees.py") or torch.cuda.is_available():
        return
    proc = _run(f"import runpy; runpy.run_path({tool!r}, run_name='__main__')")
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr


def test_lenet_example_imports_without_jax():
    """examples/train_lenet_daism_torch.py (the port's Table-2 example)
    stands alone too; importing it runs nothing."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('examples/train_lenet_daism_torch.py', "
        "run_name='example')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""


def test_distributed_example_imports_without_jax():
    """examples/train_lm_distributed_torch.py stands alone too; importing
    it spawns no rank and brings up no process group."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('examples/train_lm_distributed_torch.py', "
        "run_name='example')\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""


# the port's examples beside the reference's, and a line each prints
NEW_EXAMPLES = {"quickstart_torch.py": "grad ok",
                "approx_lm_inference_torch.py": "per-site resolution",
                "serve_continuous_batching_torch.py": "== group approx =="}


@pytest.mark.parametrize("name", sorted(NEW_EXAMPLES))
def test_new_example_runs_on_the_cpu_without_jax(name):
    """Each example runs with --device cpu and imports neither jax nor
    the JAX package."""
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = [{name!r}, '--device', 'cpu']\n"
        f"runpy.run_path('examples/{name}', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert NEW_EXAMPLES[name] in proc.stdout


@pytest.mark.parametrize("name", sorted(NEW_EXAMPLES))
def test_new_example_defaults_to_the_card(name):
    """Without --device an example runs on the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    code = ("import runpy, sys\n"
            f"sys.argv = [{name!r}]\n"
            f"runpy.run_path('examples/{name}', run_name='__main__')\n")
    proc = _run(code)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
