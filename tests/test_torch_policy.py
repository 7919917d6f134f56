"""Port parity: policy parsing, resolution and segmentation
(repro_torch.policy against repro.policy)."""
import pytest

torch = pytest.importorskip("torch")

import repro.policy as JP  # noqa: E402
import repro_torch.policy as TP  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.transformer import decoder_block_sites as jsites  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.transformer import decoder_block_sites as tsites  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the README's specs (serving quickstart, policy section, kernels section)
README_SPECS = [
    "*=pc3_tr",
    "*/attn/*=exact,*=pc3_tr",
    "*/layer_0/*=exact,@lm_head=exact,*=pc3_tr",
    "*/attn/*=exact,*/layer_0/*=exact,*=pc3_tr",
    "*=pc3_tr:lut",
    "*=pc3_tr:jnp",
    "*=pc3_tr:pallas",
    "*/attn/*=exact,*=pc3_tr:pallas",
    "*/attn/kernel=pc3_tr:flash,*=pc3_tr",
    "*/attn/*=exact:flash,default=fla:lut",
    "*/layer_1/ffn/*=hla,@lm_head=pc2,*=pc2_tr",
]

BAD_SPECS = [
    "*=nope",             # unknown variant
    "*=pc3_tr:gpu",       # unknown backend
    "*=exact:jnp",        # exact takes no backend
    "*=pc3:jnp:lut",      # too many fields
    "*pc3_tr",            # no '='
    "*=fla,*=hla",        # duplicate glob
]

PATHS = [
    ("decoder/layer_0/attn/wq", "dense"),
    ("decoder/layer_1/ffn/wo", "dense"),
    ("decoder/layer_1/attn/kernel", "attn_qk"),
    ("decoder/lm_head", "lm_head"),
    ("cnn/c1", "conv"),
]


def _describe(policy, mod):
    return ([(r.pattern, mod.describe_config(r.config)) for r in policy.rules],
            mod.describe_config(policy.default), policy.name)


@pytest.mark.parametrize("spec", README_SPECS)
def test_parse_policy_matches(spec):
    jpol, tpol = JP.parse_policy(spec), TP.parse_policy(spec)
    assert _describe(tpol, TP) == _describe(jpol, JP)
    for path, kind in PATHS:
        jc = jpol.resolve(path, JP.OpKind(kind))
        tc = tpol.resolve(path, TP.OpKind(kind))
        assert TP.describe_config(tc) == JP.describe_config(jc)
        # the same fields, value for value
        jd, td = vars(jc), vars(tc)
        assert {k: getattr(v, "value", v) for k, v in td.items()} == \
            {k: getattr(v, "value", v) for k, v in jd.items()}


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_invalid_specs_raise_the_same_errors(spec):
    with pytest.raises(Exception) as jerr:
        JP.parse_policy(spec)
    with pytest.raises(Exception) as terr:
        TP.parse_policy(spec)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", [
    "*=pc3_tr",
    "*/layer_0/*=exact,*/layer_3/*=exact,*=pc3_tr",
    "*/layer_1/attn/*=exact,*/layer_2/*=fla,*=pc3_tr",
    "*/layer_2/attn/kernel=pc3_tr:flash,*=exact",
])
def test_plan_segments_matches(spec):
    jcfg = jget("tinyllama_1_1b").smoke(n_layers=5)
    tcfg = tget("tinyllama_1_1b").smoke(n_layers=5)
    jpol, tpol = JP.parse_policy(spec), TP.parse_policy(spec)
    jseg = JP.plan_segments(jpol, lambda i: jsites(jcfg, i), 0, 5)
    tseg = TP.plan_segments(tpol, lambda i: tsites(tcfg, i), 0, 5)
    assert tseg == jseg
    assert [(p, k.value) for p, k in tsites(tcfg, 3)] == \
        [(p, k.value) for p, k in jsites(jcfg, 3)]


def test_depth_schedule_and_constructors_match():
    base_j = JP.parse_config("pc3_tr")
    base_t = TP.parse_config("pc3_tr")
    pairs = [
        (JP.ApproxPolicy.first_last_exact(base_j, 4),
         TP.ApproxPolicy.first_last_exact(base_t, 4)),
        (JP.ApproxPolicy.attention_exact(base_j),
         TP.ApproxPolicy.attention_exact(base_t)),
        (JP.ApproxPolicy.uniform(base_j), TP.ApproxPolicy.uniform(base_t)),
        (JP.ApproxPolicy.depth_schedule([base_j, JP.EXACT]),
         TP.ApproxPolicy.depth_schedule([base_t, TP.EXACT])),
    ]
    for jpol, tpol in pairs:
        assert _describe(tpol, TP) == _describe(jpol, JP)
        assert tpol.describe() == jpol.describe()


def test_validate_for_dtype_errors_match():
    from repro.core.config import Backend as JB
    from repro.core.config import DaismConfig as JC
    from repro_torch.core.config import Backend as TB
    from repro_torch.core.config import DaismConfig as TC

    with pytest.raises(ValueError) as jerr:
        JP.validate_for_dtype(JC(backend=JB.PALLAS), "float32", site="s")
    with pytest.raises(ValueError) as terr:
        TP.validate_for_dtype(TC(backend=TB.PALLAS), torch.float32, site="s")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jget("tinyllama_1_1b").smoke(compute_dtype="float32").with_policy(
            "*=pc3_tr:pallas")
    with pytest.raises(ValueError) as terr:
        tget("tinyllama_1_1b").smoke(compute_dtype="float32").with_policy(
            "*=pc3_tr:pallas")
    assert str(terr.value) == str(jerr.value)


def test_flash_rule_on_eligible_site_is_not_ported_yet():
    cfg = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=64).with_policy(
        "*/attn/kernel=exact:flash,*=exact")
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(NotImplementedError, match="flash attention"):
        model.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
