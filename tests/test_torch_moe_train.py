"""Port parity: one ``train_step`` of the MoE ids (DBRX, Qwen3-MoE; smoke
configs, 2 layers) against the JAX package's on a 1x1 ``Mesh`` (loss with
its 0.01 x aux term and grad norm: exact within 1e-5, STE ~1.5-2x the
measured gap), and the port's own identity of a paged step and a
slot-cache decode step, bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild_artifacts  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.policy import ApproxPolicy as JPolicy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import DaismConfig, Variant  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.policy import ApproxPolicy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE = ("dbrx_132b", "qwen3_moe_235b")
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
BF16 = dict(n_layers=2, vocab=128)


@pytest.fixture(scope="module")
def np_params():
    out = {}
    for arch in MOE:
        for key, kw in (("f32", F32), ("bf16", BF16)):
            p, _ = jbuild(jget(arch).smoke(**kw)).init(jax.random.PRNGKey(0))
            out[(arch, key)] = jax.tree.map(np.asarray, p)
    return out


def _models(arch, spec, key, np_params, port_spec=None):
    kw = F32 if key == "f32" else BF16
    jm = jbuild(jget(arch).smoke(**kw).with_policy(spec))
    tcfg = tget(arch).smoke(**kw).with_policy(port_spec or spec)
    p = np_params[(arch, key)]
    return (jm, jax.tree.map(jnp.asarray, p), tbuild(tcfg, device="cpu"),
            params_from_jax(p, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_paged_step_equals_decode_step_inside_the_port(arch, np_params):
    """bf16 ``*=pc3_tr:pallas``: a request decoded through the paged pool
    (its row beside three others, a 12-token prefill chunk of 4 rows) gives
    the logits of the slot-cache ``prefill`` + ``decode_step`` run, bit for
    bit. The router's rows and the expert products do not depend on how
    many rows share the call."""
    _, _, tm, tp = _models(arch, "*=pc3_tr", "bf16", np_params,
                           port_spec="*=pc3_tr:pallas")
    toks = torch.from_numpy(_tokens(4, 12, seed=7)).long()
    bs = 4
    kv = tm.init_paged_cache(16, bs)
    tables = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    pos = torch.zeros(4, dtype=torch.int32)
    cache = tm.init_cache(1, 16)
    with torch.no_grad():
        pl, kv = tm.paged_step(tp, toks, dict(kv, block_tables=tables,
                                              pos=pos), block_size=bs)
        sl, cache = tm.prefill(tp, toks[:1], cache)
        assert torch.equal(pl[0], sl[0])
        nxt = pl[:, -1:].argmax(-1)
        for step in range(3):
            pl, kv = tm.paged_step(tp, nxt, dict(kv, block_tables=tables,
                                                 pos=pos + 12 + step),
                                   block_size=bs)
            sl, cache = tm.decode_step(tp, nxt[:1], cache)
            assert torch.equal(pl[0], sl[0]), step
            nxt = pl.argmax(-1)


# (arch, kind) -> (loss rel, grad_norm rel) of one train step (lm_loss adds
# 0.01 * aux on both sides): exact tests/test_torch_train.py's 1e-5, STE
# ~1.5-2x the measured gap (in the comments)
TRAIN_TOL = {("dbrx_132b", "exact"): (1e-5, 1e-5),        # 8.5e-8, 0
             ("qwen3_moe_235b", "exact"): (1e-5, 1e-5),   # 0, 0
             ("dbrx_132b", "ste"): (2.5e-5, 3.5e-5),      # 1.54e-5, 2.28e-5
             ("qwen3_moe_235b", "ste"): (5e-5, 1.2e-5)}   # 3.36e-5, 6.98e-6


@pytest.mark.parametrize("kind", ["exact", "ste"])
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_jax(arch, kind, np_params):
    """One ``train_step`` through ``build_artifacts`` on both sides (the
    reference on a 1x1 ``Mesh``), warmup 1: the loss, whose aux term is
    0.01 x the layers' summed load-balance losses, and the grad norm within
    ``TRAIN_TOL``; the step-1 schedule leaves every parameter as it was.

    Both take the default ``moe_impl="ep"``: each ``build_artifacts``
    installs a sharder (the port's a sizes-only 1x1 one), so both run the
    capacity-dropping expert-parallel FFN, as on a 1x1 mesh."""
    if kind == "exact":
        jpol = tpol = "*=exact"
    else:
        jpol = JPolicy.uniform(JConfig(variant=JVariant.PC3_TR, backward=kind))
        tpol = ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                                backward=kind))
    jcfg = jget(arch).smoke(**F32).with_policy(jpol)
    tcfg = tget(arch).smoke(**F32).with_policy(tpol)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ja = jbuild_artifacts(jcfg, mesh, warmup=1, total_steps=100)
    ta = build_artifacts(tcfg, device="cpu", warmup=1, total_steps=100)
    npp = np_params[(arch, "f32")]
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, tcfg, device="cpu")
    before = {k: v.clone() for k, v in flatten(tp).items()}
    batch = next(lm_batches(128, 2, 16, seed=0))
    _, _, jm = ja.train_step(jp, ja.init_opt(jp), {
        k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tm = ta.train_step(tp, ta.init_opt(tp), batch)
    loss_rel, gn_rel = TRAIN_TOL[(arch, kind)]
    for key, rel in (("loss", loss_rel), ("grad_norm", gn_rel)):
        got, ref = float(tm[key]), float(jm[key])
        assert np.isfinite(got) and abs(got - ref) <= rel * abs(ref), \
            (key, got, ref)
    for k, t in flatten(tp).items():
        assert torch.equal(t, before[k]), k
