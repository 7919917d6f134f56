"""Port parity: daism-lint (repro_torch.analyze) against the JAX package's
(repro.analyze).

One counterpart for every test of ``tests/test_analyze.py``, each a case of
its own. Every (model, policy, engine) triple goes through both
``analyze``s: the findings outside the TIL family must be equal as
(code, severity, category, site) tuples, the ENE001 energies within 1e-9
relative, and ``format_json``'s sites, segments, energy and exit code
equal. The TIL family describes each package's own kernels, so its cases
are the port's: the CUDA GEMM's tile and split-K paths, a block's shared
memory, kernel sites on a ``cpu`` target, the flash kernels' tiles. The
serving findings are the reference's, ``shards > 1`` included.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import repro.analyze as J  # noqa: E402
import repro.policy as jpolicy  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.analyze as T  # noqa: E402
import repro_torch.policy as tpolicy  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import Backend as JBackend  # noqa: E402
from repro.core import DaismConfig as JConfig  # noqa: E402
from repro.core import Variant as JVariant  # noqa: E402
from repro_torch.configs import ARCH_IDS, PAPER_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import Backend, DaismConfig, Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = {
    "jax": dict(A=J, get=jget, policy=jpolicy, serve=jserve,
                Config=JConfig, Variant=JVariant, Backend=JBackend),
    "torch": dict(A=T, get=tget, policy=tpolicy, serve=tserve,
                  Config=DaismConfig, Variant=Variant, Backend=Backend),
}


def codes(findings):
    return {f.code for f in findings}


def smoke_lm(side="torch", **over):
    cfg = SIDES[side]["get"]("tinyllama_1_1b").smoke(n_layers=2, vocab=64)
    return dataclasses.replace(cfg, **over) if over else cfg


def pc3_tr(side):
    s = SIDES[side]
    return s["Config"](variant=s["Variant"].PC3_TR, backend=s["Backend"].JNP)


def _key(f):
    return (f.code, f.severity, f.category, f.site)


def _non_til(report, drop=()):
    return sorted(_key(f) for f in report.findings
                  if not f.code.startswith("TIL") and f.code not in drop)


def both(cfg, policy=None, engine=None, *, drop=(), **kw):
    """``cfg(side)``, ``policy(side)`` (or a spec string / None) and
    ``engine`` (EngineConfig kwargs, made into each package's
    EngineConfig) through both analyzers; asserts parity and returns
    (reference report, port report)."""
    reports = {}
    for side, s in SIDES.items():
        pol = policy(side) if callable(policy) else policy
        ecfg = s["serve"].EngineConfig(**engine) if engine else None
        extra = dict(kw, device="cuda") if side == "torch" else kw
        reports[side] = s["A"].analyze(cfg(side), pol, engine_cfg=ecfg,
                                       **extra)
    j, t = reports["jax"], reports["torch"]
    assert _non_til(t, drop) == _non_til(j, drop)
    assert t.graph.energy_uj() == pytest.approx(j.graph.energy_uj(),
                                                rel=1e-9)
    assert [f.message for f in t.findings if f.code == "ENE001"] == [
        f.message for f in j.findings if f.code == "ENE001"]
    jj, tj = json.loads(J.format_json(j)), json.loads(T.format_json(t))
    for k in ("sites", "segments", "energy_uj", "model", "policy",
              "categories"):
        assert tj[k] == jj[k], k
    if not drop:
        assert tj["exit_code"] == jj["exit_code"]
    return j, t


# ---------------------------------------------------------------------------
# Site-graph tracing (meta device only — no weights, no kernels)
# ---------------------------------------------------------------------------

def test_trace_site_graph_covers_all_sites_without_weights():
    before = (dm.launches, fa.launches)
    _, report = both(smoke_lm, "*/attn/*=exact,*=pc3_tr")
    graph = report.graph
    paths = graph.paths()
    assert any("attn" in p for p in paths)
    assert any("ffn" in p for p in paths)
    assert any("lm_head" in p for p in paths)
    assert all(s.macs > 0 for s in graph.sites)
    used, exact = graph.energy_uj()
    assert 0 < used < exact
    assert (dm.launches, fa.launches) == before


def test_trace_site_graph_matches_runtime_segmentation():
    _, report = both(smoke_lm, "*/layer_0/*=exact,*=pc3_tr")
    assert any(len(spans) == 2 for spans in report.graph.segments.values())
    assert any("layer_0" in p for p in report.graph.paths())


def test_trace_handles_illegal_candidate_policy():
    j, t = both(lambda side: SIDES[side]["get"]("lenet5"), "*=pc3_tr:lut")
    assert t.graph.sites
    bck = T.check_backend(t.graph)
    assert bck and all(f.code == "BCK001" and f.severity == "error"
                       for f in bck)
    assert [str(f) for f in bck] == [str(f) for f in J.check_backend(j.graph)]


# ---------------------------------------------------------------------------
# Policy checkers
# ---------------------------------------------------------------------------

def test_zero_match_rule_is_an_error():
    j, t = both(smoke_lm, "*/bogus/*=exact,*=pc3_tr")
    assert "POL001" in codes(t.errors)
    assert t.exit_code == j.exit_code == 1


def test_shadowed_and_catch_all_ordering_warn():
    _, t = both(smoke_lm, "*=pc3_tr,*/attn/*=exact")
    assert {"POL002", "POL003"} <= codes(T.check_policy(t.graph))


def test_deprecated_daism_shim_warns():
    _, t = both(lambda side: smoke_lm(side, daism=pc3_tr(side), policy=None))
    assert "POL004" in codes(T.check_policy(t.graph))


# ---------------------------------------------------------------------------
# Tiling (the port's: the CUDA kernels' tiles) / recompile checkers
# ---------------------------------------------------------------------------

def _graph(spec, *, seq=8, **over):
    return T.trace_site_graph(smoke_lm(**over), spec, seq=seq)


def _til(findings, code):
    return {f.site: f for f in findings if f.code == code}


@pytest.mark.parametrize("seq, vocab, path, ragged", [
    # M = 8: the split-K path, here one row and 128 columns a block. vocab
    # 100: n off its 128 columns
    (8, 100, "split-K", "n: 100 -> 128"),
    # rows past M are skipped there, K = 64 (d_model) is one chunk and the
    # vocab a multiple of 128: clean
    (8, 256, "split-K", None),
    # M = 200 (a 200-token forward): the tile path, M off its 64 rows
    (200, 256, "tile", "m: 200 -> 256"),
    # the tile path with N off its 64 columns
    (256, 100, "tile", "n: 100 -> 128"),
])
def test_tiling_padding_on_each_kernel_path(seq, vocab, path, ragged):
    cfg = dataclasses.replace(smoke_lm(), vocab=vocab)
    graph = T.trace_site_graph(cfg, "@lm_head=pc3_tr:pallas,*=exact",
                               seq=seq)
    (head,) = [s for s in graph.sites if s.path.endswith("lm_head")]
    m, k, n = head.dims
    plan = dm._plan(m, k, n, Variant.PC3_TR)
    assert (plan is None) == (path == "tile")
    til = _til(T.check_tiling(graph), "TIL001")
    if ragged is None:
        assert head.path not in til
    else:
        assert ragged in til[head.path].message
        assert path in til[head.path].message
        assert til[head.path].severity == "warning"


def test_tiling_ragged_k_zero_fills_the_last_chunk():
    # d_ff 200: wo's K = 200 is off the 64-column K chunk on the split-K
    # path (and off the tile path's 16-column K step at M = 256)
    graph = _graph("*/ffn/wo=pc3_tr:pallas,*=exact", d_ff=200)
    (wo,) = [f for f in T.check_tiling(graph) if f.code == "TIL001"]
    assert "k: 200 -> 256" in wo.message and "split-K" in wo.message
    graph = _graph("*/ffn/wo=pc3_tr:pallas,*=exact", seq=256, d_ff=200)
    (wo,) = [f for f in T.check_tiling(graph) if f.code == "TIL001"]
    assert "k: 200 -> 208" in wo.message and "tile path" in wo.message


def test_tiling_smem_budget_and_the_kernels_bytes():
    # the tile path's static arrays and the split-K path's int4 fields per
    # (row, K column of a chunk), the numbers phase 14 (b) of chip_smoke.py
    # holds against ptxas and the library
    assert dm.smem_bytes(None) == 45312
    assert [dm.smem_bytes(p) for p in dm.SPLIT_K_PLANS] == [
        16 * r * dm.KC for r, _ in dm.SPLIT_K_PLANS]
    with pytest.raises(ValueError):
        dm.smem_bytes((2, 4))
    # _plan picks only the instantiated split-K pairs
    picked = {dm._plan(m, k, n, Variant.PC3_TR, experts=e)
              for m in (1, 3, 4, 8, 16, 64, 128, 200)
              for k, n in ((64, 128), (2048, 256), (2048, 5632), (4096, 12))
              for e in (1, 128)}
    assert picked - {None} <= set(dm.SPLIT_K_PLANS)
    graph = _graph("*/ffn/*=pc3_tr:pallas,*=exact")
    assert not _til(T.check_tiling(graph), "TIL002")
    # M = 8: split-K blocks of one row, 1 KiB each
    til = _til(T.check_tiling(graph, smem_budget_kib=0.5), "TIL002")
    assert til and all("1.0 KiB" in f.message and "over the 0.5 KiB budget"
                       in f.message for f in til.values())
    til = _til(T.check_tiling(_graph("*/ffn/*=pc3_tr:pallas,*=exact",
                                     seq=256), smem_budget_kib=40.0),
               "TIL002")
    assert til and all("44.2 KiB" in f.message for f in til.values())


def test_tiling_plain_version_info_only_on_a_cpu_target():
    graph = _graph("*=pc3_tr:pallas")
    til = T.check_tiling(graph, device="cpu")
    assert "TIL003" in codes(til)
    assert all(f.severity in ("info", "warning") for f in til)
    # the target is an argument, not this (CPU-only) host
    assert "TIL003" not in codes(T.check_tiling(graph, device="cuda"))
    assert "TIL003" not in codes(T.check_tiling(graph))
    # jnp sites never launch a kernel
    assert "TIL003" not in codes(T.check_tiling(_graph("*=pc3_tr"),
                                                device="cpu"))
    with pytest.raises(ValueError, match="lint target"):
        T.check_tiling(graph, device="meta")


def test_attention_checker_flags_ragged_flash_tiles():
    # Sq = Skv = 8: off the 64-query and 128-key tiles; D = 64 is whole
    graph = _graph("*/attn/kernel=exact:flash,*=exact")
    found = T.check_attention(graph)
    (f,) = [f for f in found if f.code == "TIL004"]
    assert f.severity == "warning" and f.site.endswith("attn/kernel")
    assert "sq: 8 -> 64" in f.message and "skv: 8 -> 128" in f.message
    assert "head_dim" not in f.message
    # on whole tiles the site is clean
    assert not T.check_attention(_graph("*/attn/kernel=exact:flash,*=exact",
                                        seq=128))
    # without the ':flash' opt-in the ATTN_QK sites run exact — silent
    assert not T.check_attention(_graph("*=pc3_tr"))


def test_attention_checker_flags_padded_head_dim():
    # D = 40: the tensor-core kernel (bf16 exact) pads it to 48, the
    # integer kernel (an approximate variant) to its 64-column lane tiles
    cfg = dict(head_dim=40, seq=128)
    (f,) = T.check_attention(_graph("*/attn/kernel=exact:flash,*=exact",
                                    **cfg))
    assert f.code == "TIL004" and "head_dim: 40 -> 48" in f.message
    assert f"steps of {fa.TC_HEAD_STEP}" in f.message
    (f,) = T.check_attention(_graph("*/attn/kernel=pc3_tr:flash,*=exact",
                                    **cfg))
    assert f.code == "TIL004" and "head_dim: 40 -> 64" in f.message
    assert "padded to 64" in f.message and "sq" not in f.message
    # D = 192 on the tensor cores: 64-key tiles, so Skv = 64 is whole
    assert fa.kernel_tiles(192, "bfloat16") == (64, fa.TC_BLOCK_K_QS, 192)
    # the integer kernel: int_plan's query tile for the heads and rows
    assert fa.kernel_tiles(192, "bfloat16", Variant.PC3_TR, bh=96,
                           sq=2048) == (32, 128, 192)
    assert fa.kernel_tiles(40, "float32", bh=20, sq=448) == (16, 128, 64)


def test_attention_checker_flags_non_bf16_flash_variant():
    j, t = both(lambda side: smoke_lm(side, compute_dtype="float32",
                                      param_dtype="float32"),
                "*/attn/kernel=pc3_tr:flash,*=exact")
    found = T.check_attention(t.graph)
    assert any(f.code == "TIL005" and f.severity == "error" for f in found)
    assert "TIL005" in codes(j.errors)
    assert t.exit_code == j.exit_code == 1


def test_recompile_hazards_on_depth_schedule():
    def depth_policy(side):
        s = SIDES[side]
        n = s["get"]("tinyllama_1_1b").n_layers
        rules = tuple(
            s["policy"].Rule(f"*/layer_{i}/*",
                             dataclasses.replace(pc3_tr(side), k_chunk=64 + i))
            for i in range(n))
        return s["policy"].ApproxPolicy(rules=rules, default=pc3_tr(side))

    _, t = both(lambda side: SIDES[side]["get"]("tinyllama_1_1b"),
                depth_policy)
    found = T.check_recompile(t.graph)
    assert {"RCP001", "RCP002"} <= codes(found)
    rcp = {f.code: f.message for f in found}
    assert "run_policy_segments" in rcp["RCP001"]
    assert "matmul_kernel" in rcp["RCP002"]


# ---------------------------------------------------------------------------
# Serving checkers
# ---------------------------------------------------------------------------

def test_serving_window_incompatibility_is_an_error():
    _, t = both(lambda side: smoke_lm(side, window=16), engine=dict())
    found = T.check_serving(t.graph, tserve.EngineConfig())
    assert any(f.code == "SRV001" and f.severity == "error" for f in found)


def test_serving_pool_capacity_and_oversubscription():
    _, t = both(smoke_lm, engine=dict(num_blocks=4, block_size=16))
    assert "SRV002" in codes(t.findings)
    tiers = (("free", "*=pc3_tr"), ("paid", "*/attn/*=exact,*=pc3_tr"))
    _, t = both(smoke_lm, engine=dict(num_blocks=32, block_size=16,
                                      tiers=tiers))
    assert "SRV003" in codes(t.findings)


def test_serving_duplicate_tier_groups_and_bad_tier_spec():
    _, t = both(smoke_lm, engine=dict(tiers=(("free", "*=pc3_tr"),
                                             ("paid", "*=pc3_tr"))))
    assert "SRV004" in codes(t.findings)
    _, t = both(smoke_lm, engine=dict(tiers=(("free",
                                              "*/xx/*=exact,*=pc3_tr"),)))
    assert "SRV005" in codes(t.findings)


def test_serving_shard_divisibility_srv007():
    bad = dict(num_slots=4, num_blocks=30, block_size=16, shards=4)
    _, t = both(smoke_lm, engine=bad)
    assert any(f.code == "SRV007" and f.severity == "error"
               for f in t.findings)
    _, t = both(smoke_lm, engine=dict(num_slots=3, num_blocks=32,
                                      block_size=16, shards=4))
    assert "SRV007" in codes(t.findings)
    ok = dict(num_slots=4, num_blocks=32, block_size=16, shards=4)
    _, t = both(smoke_lm, engine=ok)
    assert "SRV007" not in codes(t.findings)
    _, t = both(smoke_lm, engine=bad, advisory_serving=True)
    assert any(f.code == "SRV007" and f.severity == "warning"
               for f in t.findings)


@pytest.mark.parametrize("shards", [2, 4])
def test_serving_shards_refused_as_srv000_by_design(shards):
    """Tensor-parallel serving is ported: a divisible ``shards > 1``
    layout lints as the reference's does (equal findings and exit code,
    no SRV000 and no SRV007), in strict and advisory mode, as shards=1."""
    ecfg = dict(num_slots=4, num_blocks=32, block_size=16, shards=shards)
    for kw in (dict(), dict(advisory_serving=True)):
        j, t = both(smoke_lm, engine=ecfg, **kw)
        assert t.exit_code == j.exit_code == 0
        assert not {"SRV000", "SRV007"} & set(codes(t.findings))
    _, one = both(smoke_lm, engine=dict(ecfg, shards=1))
    assert codes(one.findings) == codes(t.findings)


def test_serving_undersized_swap_buffer_srv008():
    _, t = both(smoke_lm, engine=dict(preempt=True, swap_blocks=4))
    assert any(f.code == "SRV008" and f.severity == "warning"
               for f in t.findings)
    for ecfg in (dict(preempt=True), dict(preempt=True, swap_blocks=8),
                 dict(swap_blocks=4)):
        _, t = both(smoke_lm, engine=ecfg)
        assert "SRV008" not in codes(t.findings)


def test_serving_advisory_mode_caps_severity():
    _, t = both(lambda side: smoke_lm(side, window=16), engine=dict(),
                advisory_serving=True)
    found = T.check_serving(t.graph, tserve.EngineConfig(), advisory=True)
    assert any(f.code == "SRV001" for f in found)
    assert all(f.severity != "error" for f in found)


def test_serving_skipped_for_non_servable_family():
    _, t = both(lambda side: SIDES[side]["get"]("lenet5"), engine=dict())
    found = T.check_serving(t.graph, tserve.EngineConfig())
    assert codes(found) == {"SRV006"}
    assert all(f.severity == "info" for f in found)


def test_serving_spec_draft_srv009():
    def srv9(cfg=smoke_lm, advisory=False, **ecfg):
        _, t = both(cfg, engine=ecfg, advisory_serving=advisory)
        return [f for f in t.findings if f.code == "SRV009"]

    assert srv9(spec_draft="*=pc3_tr", spec_k=3) == []
    assert srv9() == []
    found = srv9(spec_draft="*=exact", spec_k=3)
    assert [f.severity for f in found] == ["error"]
    assert "not cheaper" in found[0].message
    assert srv9(tiers=(("cheap", "*=pc3_tr"),), spec_draft="cheap",
                spec_k=3) == []
    found = srv9(tiers=(("cheap", "*=pc3_tr"),), spec_draft="*=pc2",
                 spec_k=3)
    assert any(f.severity == "warning" and "tier 'cheap'" in f.message
               for f in found)
    found = srv9(spec_draft="*=bogus", spec_k=3)
    assert [f.severity for f in found] == ["error"]
    assert "rejected" in found[0].message
    found = srv9(lambda side: smoke_lm(side, window=16),
                 spec_draft="*=pc3_tr", spec_k=3)
    assert any("window" in f.message and f.severity == "error"
               for f in found)
    found = srv9(lambda side: smoke_lm(side, compute_dtype="float32",
                                       param_dtype="float32"),
                 spec_draft="*=pc3_tr:lut", spec_k=3)
    assert any(f.severity == "error" for f in found)
    found = srv9(advisory=True, spec_draft="*=exact", spec_k=3)
    assert found and all(f.severity == "warning" for f in found)


def test_engine_config_finding_wraps_construction_error():
    errs = {}
    for side, s in SIDES.items():
        with pytest.raises(ValueError) as e:
            s["serve"].EngineConfig(tiers=(("free",),))
        errs[side] = s["A"].engine_config_finding(e.value)
    f = errs["torch"]
    assert f.code == "SRV000" and f.severity == "error"
    assert _key(f) == _key(errs["jax"])
    # analyze reports it in place of the serving checks, as the reference's
    # lint CLI does
    report = T.analyze(smoke_lm(), engine_error=e.value)
    assert report.findings[0].code == "SRV000" and report.exit_code == 1
    assert "serving" in report.categories


# ---------------------------------------------------------------------------
# Reports, preflight, and the shipped-config sweep
# ---------------------------------------------------------------------------

def test_report_formats_and_exit_codes():
    j, report = both(smoke_lm, "*/attn/*=exact,*=pc3_tr")
    assert report.exit_code == 0
    text = T.format_text(report)
    assert "daism-lint" in text and "ENE001" in text
    data = json.loads(T.format_json(report))
    assert set(data) == set(json.loads(J.format_json(j)))
    assert data["exit_code"] == 0
    assert data["sites"] and data["findings"]
    assert set(data["energy_uj"]) == {"policy", "exact"}


def test_preflight_raises_on_error_findings(capsys):
    for side in SIDES:
        with pytest.raises(SystemExit, match="daism-lint found"):
            SIDES[side]["A"].preflight(smoke_lm(side),
                                       "*/bogus/*=exact,*=pc3_tr",
                                       label="train t")
        assert "POL001" in capsys.readouterr().out


def test_preflight_passes_clean_config():
    for side in SIDES:
        report = SIDES[side]["A"].preflight(smoke_lm(side), serving=False,
                                            label="train t")
        assert report.exit_code == 0


@pytest.mark.parametrize("name", list(ARCH_IDS) + list(PAPER_IDS))
def test_all_shipped_configs_lint_clean(name):
    """The sweep invariant: every registered config's defaults produce zero
    error findings (serving advisory) and the reference's findings."""
    _, t = both(lambda side: SIDES[side]["get"](name),
                advisory_serving=True)
    assert t.errors == [], [str(f) for f in t.errors]
    assert t.graph.sites
    assert "TIL003" not in codes(t.findings)
