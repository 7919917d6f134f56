"""Port parity: the dry-run on ``meta`` (``repro_torch/launch/dryrun.py``)
and its tables (``repro_torch/roofline/report.py``) against the reference.

* ``arg_bytes`` of ``tinyllama_1_1b`` and ``xlstm_1_3b`` at ``train_4k`` on
  the single-pod mesh (16 x 16): the port's ``meta`` arguments (this rank's
  parameter, optimizer and batch shards) equal the reference's local shard
  bytes, ``NamedSharding.shard_shape`` of every leaf on a directly built
  16 x 16 ``Mesh`` of fake host devices (a subprocess; nothing compiled).
* The mandated skips equal the reference's ``cell_enabled``.
* The CLI traces one cell end to end (xLSTM-1.3B at ``long_500k``, the
  single-pod mesh) into ``results/dryrun_torch_{tag}.json`` (here a
  temporary directory), and ``report.py`` renders it; the port's
  ``dryrun_table`` and ``roofline_table`` give the reference's strings for
  the same records.
* The ``serve`` rules trace; ``seqcache`` and ``sp`` raise, naming ROADMAP.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, SHAPES, cell_enabled  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

HERE = os.path.dirname(__file__)

_REFERENCE_ARGS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import dataclasses, jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config, input_specs
from repro.launch.steps import build_artifacts
mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
out = {}
for arch in sys.argv[1:]:
    cfg = dataclasses.replace(get_config(arch), remat="full")
    art = build_artifacts(cfg, mesh)
    specs, _ = input_specs(cfg, "train_4k")
    trees = [(art.param_shapes, art.param_shardings),
             (art.opt_shapes, art.opt_shardings),
             (specs, art.batch_sharding(specs))]
    total = 0
    for shapes, shardings in trees:
        for s, sh in zip(jax.tree.leaves(shapes), jax.tree.leaves(shardings)):
            total += int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
    out[arch] = total
print("ARGS", json.dumps(out))
"""


def test_arg_bytes_equal_the_reference_shards():
    archs = ["tinyllama_1_1b", "xlstm_1_3b"]
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_ARGS] + archs,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    line = [l for l in proc.stdout.splitlines() if l.startswith("ARGS ")]
    assert line, proc.stderr[-3000:]
    want = json.loads(line[0][5:])
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), remat="full")
        _, args, kind = dryrun.cell_args(
            cfg, dryrun.mesh_sizes("single"),
            dryrun.rules_for("base", False), "train_4k")
        assert kind == "train"
        assert dryrun._leaf_bytes(args) == want[arch], arch


def test_mandated_skips_equal_the_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_enabled as jcell_enabled
    from repro.configs import get_config as jget

    assert SHAPES == JSHAPES
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_enabled(get_config(arch), shape) == jcell_enabled(
                jget(arch), shape), (arch, shape)


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", str(tmp_path))
    monkeypatch.setattr(report, "RESULTS", str(tmp_path))
    return tmp_path


def test_cli_traces_a_cell_and_the_report_renders_it(results_dir, capsys):
    from repro.roofline import report as jreport

    dryrun.main(["--arch", "xlstm_1_3b", "--shape", "long_500k", "--mesh",
                 "single", "--tag", "t"])
    dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                 "--mesh", "single", "--tag", "t"])
    out = capsys.readouterr().out
    assert "dry-run: 1 ok, 1 mandated skips, 0 errors" in out
    with open(results_dir / "dryrun_torch_t.json") as f:
        recs = json.load(f)
    rec = recs["xlstm_1_3b|long_500k|single|base|auto|"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["kind"] == "decode" and rec["remat"] == "none"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["collective_by_op"]) <= {"all-reduce", "all-gather"}
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    report.main(["--tag", "t"])
    text = capsys.readouterr().out
    assert jreport.dryrun_table(recs) in text
    assert jreport.roofline_table(recs) in text
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)


def test_serve_rules_trace_and_sequence_layouts_raise():
    rec = dryrun.run_cell("xlstm_1_3b", "long_500k", "single",
                          rules_name="serve", verbose=False)
    assert rec["status"] == "ok" and rec["rules"] == "serve"
    for name in ("seqcache", "sp"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dryrun.run_cell("xlstm_1_3b", "long_500k", "single",
                            rules_name=name, verbose=False)
