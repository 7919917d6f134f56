"""The port's daism-lint CLI (``python -m repro_torch.launch.lint``) and the
train/serve launchers' preflight, on the CPU.

The CLI against the JAX package's (``repro.launch.lint``): exit codes, text
and JSON output, SRV000 for an ``EngineConfig`` the flags cannot build, and
``--all`` with the reference's findings outside the TIL family. The
launchers: an error finding stops ``launch.serve`` / ``launch.train``
before any weight is built, and ``--no-preflight`` skips the preflight.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import repro.launch.lint as jlint  # noqa: E402
import repro_torch.analyze as T  # noqa: E402
import repro_torch.launch.lint as tlint  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
import repro_torch.launch.steps as tsteps  # noqa: E402
import repro_torch.launch.train as ttrain  # noqa: E402
import repro_torch.models.registry as tregistry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BOGUS = "*/bogus/*=exact,*=pc3_tr"


def _run(main, argv, capsys):
    """(exit code, stdout) of a CLI ``main``."""
    try:
        rc = main(argv) or 0
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def _json_reports(out):
    """The JSON objects ``--format json`` prints, one per linted config."""
    dec, pos, reports = json.JSONDecoder(), 0, []
    while True:
        pos = out.find("{", pos)
        if pos < 0:
            return reports
        obj, pos = dec.raw_decode(out, pos)
        reports.append(obj)


def _non_til(report):
    return sorted((f["code"], f["severity"], f["category"], f["site"])
                  for f in report["findings"] if not f["code"].startswith("TIL"))


@pytest.mark.parametrize("policy, rc", [
    (BOGUS, 1),
    ("*/attn/*=exact,*=pc3_tr", 0),
])
def test_lint_exit_codes_and_text_match_the_reference(policy, rc, capsys):
    argv = ["--model", "tinyllama_1_1b", "--policy", policy]
    trc, tout = _run(tlint.main, argv + ["--device", "cpu"], capsys)
    jrc, jout = _run(jlint.main, argv, capsys)
    assert trc == jrc == rc
    assert "== daism-lint: tinyllama-1.1b" in tout
    assert ("E POL001" in tout) == (rc == 1) == ("E POL001" in jout)
    # the site table and the checker line
    assert "decoder/lm_head" in tout and "6 checkers" in tout
    trc, tout = _run(tlint.main, argv + ["--no-sites"], capsys)
    assert trc == rc and "decoder/lm_head " not in tout


def test_lint_json_matches_the_reference(capsys):
    argv = ["--model", "tinyllama_1_1b", "--format", "json",
            "--policy", "*/layer_0/*=exact,*=pc3_tr", "--tiers",
            "free=*=pc3_tr;paid=*=pc3_tr", "--spec-draft", "*=exact",
            "--spec-k", "2"]
    trc, tout = _run(tlint.main, argv, capsys)
    jrc, jout = _run(jlint.main, argv, capsys)
    (t,), (j,) = _json_reports(tout), _json_reports(jout)
    assert trc == jrc == t["exit_code"] == j["exit_code"] == 1
    for k in ("model", "policy", "categories", "energy_uj", "segments",
              "sites"):
        assert t[k] == j[k], k
    assert _non_til(t) == _non_til(j)
    assert {"SRV004", "SRV009"} <= {f["code"] for f in t["findings"]}


def test_lint_broken_engine_config_is_srv000(capsys):
    # max_seq 100 is not a multiple of the 16-token page
    argv = ["--model", "tinyllama_1_1b", "--max-seq", "100",
            "--format", "json"]
    trc, tout = _run(tlint.main, argv, capsys)
    jrc, jout = _run(jlint.main, argv, capsys)
    (t,), (j,) = _json_reports(tout), _json_reports(jout)
    assert trc == jrc == 1
    assert t["findings"][0]["code"] == "SRV000"
    assert "multiple of block_size" in t["findings"][0]["message"]
    assert _non_til(t) == _non_til(j)
    assert "serving" in t["categories"]


def test_lint_shards_is_srv000_in_the_port(capsys):
    argv = ["--model", "tinyllama_1_1b", "--shards", "2", "--no-sites"]
    trc, tout = _run(tlint.main, argv, capsys)
    jrc, _ = _run(jlint.main, argv, capsys)
    assert (trc, jrc) == (1, 0)  # the difference by design
    assert "E SRV000" in tout and "shards" in tout


def test_lint_needs_exactly_one_of_model_and_all(capsys):
    assert _run(tlint.main, [], capsys)[0] == 2
    assert _run(tlint.main, ["--all", "--model", "lenet5"], capsys)[0] == 2


def test_lint_all_on_cpu_matches_the_reference(capsys):
    trc, tout = _run(tlint.main, ["--all", "--device", "cpu", "--format",
                                  "json"], capsys)
    jrc, jout = _run(jlint.main, ["--all", "--format", "json"], capsys)
    assert trc == jrc == 0
    treps, jreps = _json_reports(tout), _json_reports(jout)
    assert len(treps) == len(jreps) == 13
    for t, j in zip(treps, jreps):
        assert t["model"] == j["model"]
        assert not [f for f in t["findings"] if f["severity"] == "error"]
        assert _non_til(t) == _non_til(j), t["model"]
    assert "daism-lint: 13 configs linted, ok" in tout


# ---------------------------------------------------------------------------
# The launchers' preflight
# ---------------------------------------------------------------------------

class _Built(Exception):
    """Raised in place of building the model: the launcher got that far."""


@pytest.fixture
def no_build(monkeypatch):
    """A model's ``init`` (its weights) and ``build_artifacts`` raise, so a
    launcher that gets past its preflight stops there, with no weight
    built. (``build_model`` itself allocates nothing: the preflight's
    meta-device trace builds the model object too.)"""
    real = tregistry.build_model

    def refuse(*a, **k):
        raise _Built

    def build_model(*a, **k):
        model = real(*a, **k)
        model.init = refuse
        return model

    monkeypatch.setattr(tregistry, "build_model", build_model)
    monkeypatch.setattr(tsteps, "build_artifacts", refuse)


SERVE = ["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu"]
TRAIN = ["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
         "--steps", "1"]


@pytest.mark.parametrize("extra, code", [
    (["--policy", BOGUS], "POL001"),
    (["--blocks", "1", "--max-seq", "2048"], "SRV002"),
    (["--shards", "2"], "SRV000"),
    (["--max-seq", "100"], "SRV000"),  # EngineConfig does not construct
    (["--policy", "*=pc3_tr"], None),
])
def test_serve_preflight_aborts_before_the_weights(extra, code, no_build,
                                                   capsys):
    if code is None:  # a clean triple gets past it
        with pytest.raises(_Built):
            tserve.main(SERVE + extra)
        return
    with pytest.raises(SystemExit, match=code):
        tserve.main(SERVE + extra)
    out = capsys.readouterr().out
    assert "-- serve tinyllama_1_1b: daism-lint --" in out and code in out


def test_train_preflight_aborts_before_build_artifacts(no_build, capsys):
    with pytest.raises(SystemExit, match="POL001"):
        ttrain.main(TRAIN + ["--policy", BOGUS])
    assert "-- train tinyllama_1_1b: daism-lint --" in capsys.readouterr().out
    with pytest.raises(_Built):  # a clean policy gets past it
        ttrain.main(TRAIN + ["--policy", "*=pc3_tr"])


@pytest.mark.parametrize("main, argv", [
    (tserve.main, SERVE), (ttrain.main, TRAIN)])
def test_no_preflight_skips_it(main, argv, no_build, monkeypatch):
    calls = []
    monkeypatch.setattr(T, "preflight", lambda *a, **k: calls.append(k))
    with pytest.raises(_Built):
        main(argv + ["--policy", BOGUS, "--no-preflight"])
    assert calls == []
    with pytest.raises(_Built):
        main(argv + ["--policy", BOGUS])
    assert len(calls) == 1 and calls[0]["device"] == "cpu"
