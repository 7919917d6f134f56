"""Port parity: the paper's energy and architecture models, the per-site
energy report and the abstract op-site graph, against the JAX package.

Everything here is plain Python float arithmetic or shape-level work, so
every number must be *equal*, not close: the energy and cycle models
(``core/energy.py``, ``core/arch_model.py``), ``energy_per_mult_pj``,
``site_report`` (string-identical) and ``estimated_energy_uj`` after one
forward of the same model on the same weights, and ``trace_site_graph``'s
records, segments and energy.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.policy as jpolicy  # noqa: E402
import repro_torch.policy as tpolicy  # noqa: E402
from repro.analyze import trace_site_graph as jtrace  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import arch_model as JA  # noqa: E402
from repro.core import energy as JE  # noqa: E402
from repro.core.config import Backend as JBackend  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.analyze import trace_site_graph  # noqa: E402
from repro_torch.configs import PORTED_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import arch_model as TA  # noqa: E402
from repro_torch.core import energy as TE  # noqa: E402
from repro_torch.core.config import Backend, DaismConfig, Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANTS = [v.value for v in Variant]
APPROX = [v for v in VARIANTS if v != "exact"]
DTYPES = ["bfloat16", "float32"]
# (bank kB, bus bits) of benchmarks/energy.py's grid, plus the defaults
BANK_BUS = [(32, 512), (8, 256)]


# ---------------------------------------------------------------------------
# core/energy.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_energy_geometry_equal(variant, dtype):
    assert TE.mantissa_width(dtype) == JE.mantissa_width(dtype)
    for truncated in (False, True):
        assert (TE.product_bits(dtype, truncated)
                == JE.product_bits(dtype, truncated))
        for _, bus in BANK_BUS:
            assert (TE.concurrent_mults(dtype, truncated, bus)
                    == JE.concurrent_mults(dtype, truncated, bus))
    if variant == "exact":
        with pytest.raises(ValueError):
            JE.active_wordlines(variant, dtype)
        with pytest.raises(ValueError):
            TE.active_wordlines(variant, dtype)
    else:
        assert (TE.active_wordlines(variant, dtype)
                == JE.active_wordlines(variant, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", APPROX)
def test_daism_energy_and_improvement_equal(variant, dtype):
    for kb, bus in BANK_BUS:
        got = TE.daism_energy_per_mult(variant, dtype, bank_kb=kb,
                                       bus_bits=bus)
        assert got == JE.daism_energy_per_mult(variant, dtype, bank_kb=kb,
                                               bus_bits=bus)
        assert TE.total(got) == JE.total(got)
        for with_exp in (True, False):
            assert TE.relative_improvement(
                variant, dtype, bank_kb=kb, bus_bits=bus,
                with_exponent=with_exp) == JE.relative_improvement(
                variant, dtype, bank_kb=kb, bus_bits=bus,
                with_exponent=with_exp)
    with pytest.raises(ValueError):
        TE.daism_energy_per_mult("exact", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eyeriss_energy_and_technology_equal(dtype):
    assert (dataclasses.asdict(TE.TECH_45NM)
            == dataclasses.asdict(JE.TECH_45NM))
    for kb in (0.5, 8.0, 32.0, 512.0):
        assert (TE.TECH_45NM.sram_read_energy(kb)
                == JE.TECH_45NM.sram_read_energy(kb))
    linear_t = TE.TechnologyModel(sram_sqrt_scale=False)
    linear_j = JE.TechnologyModel(sram_sqrt_scale=False)
    assert linear_t.sram_read_energy(32.0) == linear_j.sram_read_energy(32.0)
    for truncated in (False, True):
        for spad in (0.5, 2.0):
            assert TE.eyeriss_energy_per_mult(
                dtype, truncated=truncated, pe_spad_kb=spad) == \
                JE.eyeriss_energy_per_mult(dtype, truncated=truncated,
                                           pe_spad_kb=spad)
    assert (TE.exponent_handling_energy(dtype)
            == JE.exponent_handling_energy(dtype))


# ---------------------------------------------------------------------------
# core/arch_model.py
# ---------------------------------------------------------------------------

# VGG-8 layer 1 (the Fig-9 default), a deep VGG layer, a strided one
LAYERS = [dict(), dict(h=28, w=28, cin=256, cout=512),
          dict(h=32, w=32, cin=64, cout=128, kh=5, kw=5, stride=2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", APPROX)
def test_arch_cycles_area_energy_equal(variant, dtype):
    for bt, bj in zip(TA.FIG9_CONFIGS, JA.FIG9_CONFIGS):
        assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
        assert (bt.bits, bt.side, bt.bus_bits, bt.total_kbytes) == \
            (bj.bits, bj.side, bj.bus_bits, bj.total_kbytes)
        assert TA.daism_area_mm2(bt, variant, dtype) == \
            JA.daism_area_mm2(bj, variant, dtype)
        for kw in LAYERS:
            lt, lj = TA.ConvLayer(**kw), JA.ConvLayer(**kw)
            assert (lt.out_pixels, lt.k_rows, lt.kernel_elements, lt.inputs,
                    lt.macs) == (lj.out_pixels, lj.k_rows, lj.kernel_elements,
                                 lj.inputs, lj.macs)
            assert TA.daism_cycles(lt, bt, variant, dtype) == \
                JA.daism_cycles(lj, bj, variant, dtype)
            assert TA.daism_layer_energy_uj(lt, bt, variant, dtype) == \
                JA.daism_layer_energy_uj(lj, bj, variant, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eyeriss_cycles_area_energy_equal(dtype):
    assert dataclasses.asdict(TA.AREA_45NM) == dataclasses.asdict(JA.AREA_45NM)
    for kw in LAYERS:
        lt, lj = TA.ConvLayer(**kw), JA.ConvLayer(**kw)
        for pes in (168, 256):
            assert TA.eyeriss_cycles(lt, pes) == JA.eyeriss_cycles(lj, pes)
        assert (TA.eyeriss_layer_energy_uj(lt, dtype)
                == JA.eyeriss_layer_energy_uj(lj, dtype))
    for pes in (168, 256):
        assert (TA.eyeriss_area_mm2(pes, dtype)
                == JA.eyeriss_area_mm2(pes, dtype))


# ---------------------------------------------------------------------------
# policy/dispatch.py: per-mult energy, site_report, estimated_energy_uj
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES + ["float16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_energy_per_mult_pj_equal(variant, dtype):
    for backend in (("exact",) if variant == "exact" else ("jnp", "pallas")):
        t = DaismConfig(variant=Variant(variant), backend=Backend(backend))
        j = JConfig(variant=variant, backend=JBackend(backend))
        assert (tpolicy.energy_per_mult_pj(t, dtype)
                == jpolicy.energy_per_mult_pj(j, dtype))


SMOKE = dict(n_layers=2, vocab=128, param_dtype="float32",
             compute_dtype="float32")
MIXED = {"tinyllama_1_1b": "*/layer_0/*=exact,@lm_head=exact,*=pc3_tr",
         "lenet5": "cnn/c1=exact,@lm_head=exact,*=pc3_tr"}


def _forward_both(arch):
    """One forward of the same model (f32, JAX weights) through both
    packages under ``MIXED[arch]``; returns the two policies used."""
    name = f"mixed-{arch}"
    jpol = jpolicy.parse_policy(MIXED[arch], name=name)
    tpol = tpolicy.parse_policy(MIXED[arch], name=name)
    if arch == "lenet5":
        jcfg, tcfg = jget(arch), tget(arch)
        rng = np.random.default_rng(0)
        batch = {"images": rng.normal(size=(2, 28, 28, 1)).astype(np.float32)}
    else:
        jcfg, tcfg = jget(arch).smoke(**SMOKE), tget(arch).smoke(**SMOKE)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, 128, size=(2, 8)).astype(np.int32)}
    jm = jbuild(jcfg.with_policy(jpol))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg.with_policy(tpol), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jpolicy.clear_log(jpol)
    tpolicy.clear_log(tpol)
    jm.forward(jp, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jpol, tpol


@pytest.mark.parametrize("arch", sorted(MIXED))
def test_site_report_identical_after_one_forward(arch):
    jpol, tpol = _forward_both(arch)
    got = tpolicy.site_report(tpol)
    assert "per-site resolution" in got and "saves" in got
    assert got == jpolicy.site_report(jpol)
    assert (tpolicy.estimated_energy_uj(tpol)
            == jpolicy.estimated_energy_uj(jpol))
    total, exact = tpolicy.estimated_energy_uj(tpol)
    assert 0 < total < exact


def test_site_report_before_any_site_matches():
    pol = "*=pc3_tr"
    jp = jpolicy.parse_policy(pol, name="never-run")
    tp = tpolicy.parse_policy(pol, name="never-run")
    jpolicy.clear_log(jp)
    tpolicy.clear_log(tp)
    assert tpolicy.site_report(tp) == jpolicy.site_report(jp)
    assert tpolicy.estimated_energy_uj(tp) == (0.0, 0.0)


def test_make_dot_binds_the_policy():
    pol = tpolicy.parse_policy("*=pc3_tr", name="bound")
    tpolicy.clear_log(pol)
    dot = tpolicy.make_dot(pol)
    x = torch.randn(3, 16)
    w = torch.randn(16, 4)
    with tpolicy.site_scope("m"):
        got = dot(x, w, name="w")
    ref = tpolicy.policy_dot(pol, x, w, name="w", record=False)
    assert torch.equal(got, ref)
    assert list(tpolicy.resolution_log(pol)) == [("m/w", tpolicy.OpKind.DENSE)]


# ---------------------------------------------------------------------------
# analyze/sitegraph.py
# ---------------------------------------------------------------------------

# (label, spec): the config's own policy, a mixed policy with an
# approximate flash rule, and an illegal candidate (a bf16-only backend on
# an f32 model)
GRAPH_POLICIES = [
    ("own", None),
    ("mixed-flash", "*/attn/kernel=pc3_tr:flash,*/layer_0/*=exact,"
                    "@lm_head=exact,*=pc3_tr:pallas"),
    ("exact-flash", "*/attn/kernel=exact:flash,*=pc3_tr"),
    ("illegal-lut-f32", "*=pc3_tr:lut"),
]


def _record(s):
    c = s.config
    return (s.path, s.kind.value, c.variant.value, c.backend.value,
            c.integer_drop_lsb, c.accum_dtype, c.backward, c.calibrated,
            c.k_chunk, c.attn_kernel, s.dtype, tuple(s.dims), s.macs,
            s.repeat)


def _cfgs(arch, label):
    jcfg, tcfg = jget(arch), tget(arch)
    if label == "illegal-lut-f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype="float32",
                                   param_dtype="float32")
        tcfg = dataclasses.replace(tcfg, compute_dtype="float32",
                                   param_dtype="float32")
    return jcfg, tcfg


def _gemm_calls():
    """Approximate GEMM calls through the dispatcher: each looks its
    kernel up in ``matmul_kernel``'s cache."""
    s = tpolicy.kernel_stats()
    return s["cache_hits"] + s["cache_misses"]


@pytest.mark.parametrize("label,spec", GRAPH_POLICIES)
@pytest.mark.parametrize("arch", PORTED_IDS)
def test_site_graph_equal(arch, label, spec):
    jcfg, tcfg = _cfgs(arch, label)
    jg = jtrace(jcfg, spec)
    before = (dm.launches, dm.sum_launches, fa.launches, _gemm_calls(),
              tpolicy.kernel_stats()["attention_calls"])
    tg = trace_site_graph(tcfg, spec)
    after = (dm.launches, dm.sum_launches, fa.launches, _gemm_calls(),
             tpolicy.kernel_stats()["attention_calls"])
    assert [_record(s) for s in tg.sites] == [_record(s) for s in jg.sites]
    assert tg.segments == jg.segments
    assert tg.energy_uj() == jg.energy_uj()
    assert tg.total_macs() == jg.total_macs()
    assert tg.paths() == jg.paths()
    # shape-level only: nothing launched, no GEMM run (flash calls on
    # meta tensors are counted by the dispatcher but launch nothing)
    assert after[:4] == before[:4]


def test_site_graph_allocates_no_parameters(monkeypatch):
    """The trace builds ``meta`` parameters from the specs: no model's
    ``init`` runs and no parameter storage is drawn."""
    from repro_torch.models import cnn, module, transformer

    def refuse(*a, **k):
        raise AssertionError("trace_site_graph allocated parameters")

    for mod in (module, cnn, transformer):
        monkeypatch.setattr(mod, "init_params", refuse)
    for arch in PORTED_IDS:
        g = trace_site_graph(tget(arch), "*=pc3_tr:pallas")
        assert g.total_macs() > 0
        assert all(s.config.variant is Variant.PC3_TR for s in g.sites
                   if s.kind is not tpolicy.OpKind.ATTN_QK)
