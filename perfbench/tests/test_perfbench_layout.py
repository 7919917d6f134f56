"""The benchmark's files are found by name from ``BENCHMARK.json``, and a
cell added as files alone runs with no edit to a file that is there."""
import json
import shutil

import pytest

import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench import harness, port, weights

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_every_entry_has_its_files_and_every_file_an_entry():
    b = harness.BENCH
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"].startswith(c["source"])
        for key in c["reduced"]:
            assert key in cfg and key in cfg.get("published", {})
    for w in BENCH["workloads"]:
        entry, wl, cfg = harness.find_cell(BENCH, w["name"])
        assert wl["config"] == w["config"] == entry["config"]
        assert w["traffic"] == w["name"]
        assert (b / "drivers" / f"{wl['driver']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    names = {p.stem for p in (b / "configs").glob("*.json")}
    assert names == {c["name"] for c in BENCH["configs"]}
    names = {p.stem for p in (b / "workloads").glob("*.json")}
    assert names == {w["name"] for w in BENCH["workloads"]}
    kinds = {harness.load_json(b / "workloads" / f"{n}.json")["driver"]
             for n in names}
    assert {p.stem for p in (b / "drivers").glob("*.py")} == kinds
    metrics = {p.name[:-3] for p in (b / "metrics").glob("*.py")}
    assert metrics == {m["name"] for m in BENCH["per_layer"]}


def test_metric_lists_name_cells_that_report_the_metric_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in cells
            assert "workloads" not in moved or c in moved["workloads"]
    for c in cells:
        assert harness.cell_metrics(BENCH, c, "per_layer")
        assert len(harness.cell_metrics(BENCH, c, "end_to_end")) >= 2


@pytest.mark.parametrize("family", ["dense", "encdec"])
def test_weights_tree_is_the_programs(family):
    """The tree the benchmark draws has the program's paths, shapes and
    dtypes."""
    from repro_torch.models.registry import build_model

    name = {"dense": "starcoder2-15b", "encdec": "whisper-large-v3"}[family]
    cfg = dict(harness.load_json(harness.BENCH / "configs" / f"{name}.json"),
               **tiny.CONFIGS[family])
    model = build_model(port.arch(cfg, "*=exact"), device="meta")
    want = {p: (tuple(s), d) for p, (s, d, _) in model.param_specs().items()}
    got = {p: (tuple(s), d)
           for p, (s, d, _) in weights.param_shapes(port.widths(cfg)).items()}
    assert got == want


@pytest.mark.parametrize("name", ["starcoder2-15b", "whisper-large-v3"])
def test_config_widths_are_the_registrys(name):
    """The configuration files keep the program's published widths; only
    ``reduced`` keys differ from it."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    ours = port.arch(cfg, "*=exact")
    base = get_config(cfg["program_id"])
    diff = {f.name for f in dataclasses.fields(base)
            if getattr(base, f.name) != getattr(ours, f.name)} - {"policy"}
    assert diff <= {"n_layers"}
    assert (diff == {"n_layers"}) == ("num_hidden_layers" in cfg["reduced"])


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    """Copy the benchmark, add a configuration and a workload as new files
    and entries, and run the new cell through the harness."""
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    base = harness.load_json(harness.BENCH / "configs" / "starcoder2-15b.json")
    new_cfg = dict(base, **tiny.CONFIGS["dense"], reduced=[])
    (tmp_path / "perfbench" / "configs" / "tiny-dense.json").write_text(
        json.dumps(new_cfg))
    wl = harness.load_json(harness.BENCH / "workloads" / "sc2-score.json")
    wl = dict(wl, config="tiny-dense", seq=16, distinct_batches=2,
              limits={"stage_rel_rms": 0.05, "head_row_err": 0.05})
    (tmp_path / "perfbench" / "workloads" / "tiny-score.json").write_text(
        json.dumps(wl))
    bench["configs"].append({"name": "tiny-dense", "source": base["source"],
                             "file": "perfbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-score", "config": "tiny-dense",
                               "traffic": "tiny-score", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bdir = tmp_path / "perfbench"
    entry, wl2, cfg2 = harness.find_cell(
        harness.load_json(tmp_path / "BENCHMARK.json"), "tiny-score", bdir)
    import torch

    c = harness.Cell(name="tiny-score", entry=entry, workload=wl2,
                     config=cfg2, seed=5, seconds=0.1, trace=False,
                     device=torch.device("cpu"))
    out = tiny.run(c, bdir)
    assert out["checks"].correct
    assert out["metrics"]["score_tok_s"] > 0


def test_transcription_has_its_own_rate_and_readers():
    """``whisper-decode`` reports the device's rate, ``transcribe_device_tok_s``
    (its tokens over the traced steps' busy seconds), as its end-to-end rate;
    the host's rate of the window, the whole step's share of the peak, the
    GEMM's roofline and the idle share are its per-layer readings, and each
    moves that rate."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = {m["name"]: m for m in BENCH["per_layer"]}
    dev = e2e["transcribe_device_tok_s"]
    assert dev["workloads"] == ["whisper-decode"]
    assert (dev["source"], dev["better"]) == ("device_trace", "higher")
    assert "transcribe_tok_s" not in e2e
    assert e2e["gen_tok_s"]["workloads"] == ["sc2-serve"]
    assert [m["name"] for m in harness.cell_metrics(
        BENCH, "whisper-decode", "end_to_end")] == ["transcribe_device_tok_s",
                                                    "setup_s"]
    tr = harness.TraceSummary(window_s=1.0, busy_s=0.25,
                              kernels={"daism_matmul_splitk_x": 0.1}, gaps={})
    layer = {"window": {"seconds": 2.0, "tokens": 96, "flops": 1e12},
             "trace": tr, "traced": {"gemm_bound_s": 0.004, "flops": 5e11}}
    for base in ("gemm_roofline", "idle_share"):
        m = per[f"{base}.decode"]
        assert per[f"{base}.gen"]["workloads"] == ["sc2-serve"]
        for key in ("unit", "better", "source", "layer"):
            assert m[key] == per[f"{base}.gen"][key]
        read = harness.metric_reader(f"{base}.decode")
        assert read(layer) == harness.metric_reader(f"{base}.gen")(layer)
    assert per["mfu.decode"]["source"] == "device_trace"
    reads = {"mfu.decode": 100.0 * 5e11 / (989e12 * 0.25),
             "gemm_roofline.decode": 4.0, "idle_share.decode": 75.0,
             "decode.window_tok_s": 48.0}
    for name, want in reads.items():
        assert per[name]["moves"] == "transcribe_device_tok_s"
        assert per[name]["workloads"] == ["whisper-decode"]
        assert harness.metric_reader(name)(layer) == pytest.approx(want)
    assert harness.metric_reader("mfu.decode")({"window": layer["window"]}) \
        is None
    assert harness.metric_reader("decode.window_tok_s")(
        {"window": {"seconds": 2.0, "flops": 1e12}}) is None
    assert per["xattn.kv_kept_share"]["moves"] == "transcribe_device_tok_s"
    assert {m["name"] for m in harness.cell_metrics(
        BENCH, "whisper-decode", "per_layer")} == {
        "mfu.decode", "gemm_roofline.decode", "idle_share.decode",
        "xattn.kv_kept_share", "decode.window_tok_s"}
