"""The cross-attention K/V that ``EncDecLM.decode_step`` keeps on
``cache['enc']`` across steps (``models/layers.py::kept_cross_kv``), on the
smoke Whisper of tests/test_torch_zoo_encdec.py (2 encoder + 2 decoder
layers, 16 frames, vocab 128, f32), exact and PC3_TR:

* (a) steps that reuse the kept K/V give the bits of steps that project
  them anew;
* (b) encoder states written in place and (c) weights written in place or
  replaced are picked up at the next step;
* (d) ``cross_kv.taken`` moves once a layer at the first step, and
  ``cross_kv.kept`` once a layer at every later one;
* (e) with gradients on, states that take gradients, or on ``meta``,
  nothing is kept; the cache keeps the reference's four leaves.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCH = "whisper_large_v3"
F32 = dict(vocab=128, param_dtype="float32", compute_dtype="float32")
SPECS = ["*=exact", "*=pc3_tr"]
B, STEPS = 2, 6
LEAVES = ["enc", "k", "pos", "v"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(spec, device="cpu"):
    """Artifacts, params, two clips' encoder states and the tokens."""
    cfg = get_config(ARCH).smoke(**F32).with_policy(spec)
    art = build_artifacts(cfg, device=device)
    params = art.init_params(0)
    gen = torch.Generator().manual_seed(7)
    frames = torch.randn((2, B, cfg.enc_frames, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab, (B, STEPS), generator=gen)
    if device == "meta":
        return art, params, [torch.empty_like(f, device="meta")
                             for f in frames], tokens
    with torch.no_grad():
        encs = [art.model.encode(params, f) for f in frames]
    return art, params, encs, tokens


def _cache(art, enc):
    cache = art.init_cache(B, STEPS)
    with torch.no_grad():
        cache["enc"].copy_(enc)
    return cache


def _copy(cache, enc=None):
    """Another cache in the same state: new tensors (nothing kept on its
    ``enc``), ``enc`` replaced where given."""
    out = {k: v.clone() for k, v in cache.items()}
    if enc is not None:
        out["enc"] = enc.clone()
    return out


def _moved(before):
    """(taken, kept) since the counts ``before``."""
    now = layers.cross_kv_counts()
    return (now["cross_kv.taken"] - before["cross_kv.taken"],
            now["cross_kv.kept"] - before["cross_kv.kept"])


@pytest.mark.parametrize("spec", SPECS)
def test_kept_steps_equal_steps_that_project_anew(spec):
    """(a) 6 steps on one cache against 6 in which each step gets
    ``enc.clone()`` (always a miss): logits and ``k``/``v`` equal."""
    art, params, encs, tokens = _setup(spec)
    kept, fresh = _cache(art, encs[0]), _cache(art, encs[0])
    for t in range(STEPS):
        got, kept = art.decode_step(params, tokens[:, t:t + 1], kept)
        fresh["enc"] = fresh["enc"].clone()
        want, fresh = art.decode_step(params, tokens[:, t:t + 1], fresh)
        assert torch.equal(got, want), t
    for leaf in ("k", "v"):
        assert torch.equal(kept[leaf], fresh[leaf]), leaf
    assert sorted(kept) == LEAVES


@pytest.mark.parametrize("spec", SPECS)
def test_states_written_in_place_are_picked_up(spec):
    """(b) after ``cache['enc'].copy_(other)`` the next step's logits are
    those of a cache that holds ``other`` from the start, and not those of
    the states it held before."""
    art, params, encs, tokens = _setup(spec)
    cache = _cache(art, encs[0])
    for t in range(3):
        _, cache = art.decode_step(params, tokens[:, t:t + 1], cache)
    fresh, stale = _copy(cache, encs[1]), _copy(cache)
    with torch.no_grad():
        cache["enc"].copy_(encs[1])
    step = tokens[:, 3:4]
    before = layers.cross_kv_counts()
    got, cache = art.decode_step(params, step, cache)
    assert _moved(before) == (art.cfg.n_layers, 0)
    want, _ = art.decode_step(params, step, fresh)
    old, _ = art.decode_step(params, step, stale)
    assert torch.equal(got, want)
    assert not torch.equal(got, old)


@pytest.mark.parametrize("change", ["write_wk", "new_tree", "policy"])
@pytest.mark.parametrize("spec", SPECS)
def test_changed_weights_are_picked_up(spec, change):
    """(c) an in-place write to layer 1's cross ``wk``, a new params tree
    of the same shapes (where the old one's memory may be reused), or the
    same weights under the other policy, is taken up at the next step: its
    logits are those of a step that projects the K/V anew."""
    art, params, encs, tokens = _setup(spec)
    cache = _cache(art, encs[0])
    for t in range(2):
        _, cache = art.decode_step(params, tokens[:, t:t + 1], cache)
    if change == "write_wk":
        with torch.no_grad():
            params["dec_blocks"]["xattn"]["wk"][1].mul_(1.5)
    elif change == "new_tree":   # the old tree freed first: its memory
        del params               # may be reused
        params = art.init_params(1)
    else:
        other, = set(SPECS) - {spec}
        art = build_artifacts(art.cfg.with_policy(other), device="cpu")
    fresh = _copy(cache, cache["enc"])
    before = layers.cross_kv_counts()
    got, cache = art.decode_step(params, tokens[:, 2:3], cache)
    taken, kept = _moved(before)
    assert taken == art.cfg.n_layers and kept == 0
    want, _ = art.decode_step(params, tokens[:, 2:3], fresh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("spec", SPECS)
def test_counts_move_once_a_layer_a_step(spec):
    """(d) ``cross_kv.taken`` rises by one a layer at the first step only,
    ``cross_kv.kept`` by one a layer at each later step."""
    art, params, encs, tokens = _setup(spec)
    cache = _cache(art, encs[0])
    n = art.cfg.n_layers
    for t in range(STEPS):
        before = layers.cross_kv_counts()
        _, cache = art.decode_step(params, tokens[:, t:t + 1], cache)
        assert _moved(before) == ((n, 0) if t == 0 else (0, n)), t


@pytest.mark.parametrize("how", ["grad_enabled", "enc_requires_grad",
                                 "meta"])
@pytest.mark.parametrize("spec", SPECS)
def test_nothing_kept_with_gradients_or_on_meta(spec, how):
    """(e) with gradients enabled, with states that require grad, or on
    the ``meta`` device, every step projects the K/V and keeps nothing;
    the cache's leaves stay the reference's."""
    art, params, encs, tokens = _setup(
        spec, device="meta" if how == "meta" else "cpu")
    cache = _cache(art, encs[0])
    if how == "enc_requires_grad":
        cache["enc"].requires_grad_(True)
    enc = cache["enc"]
    before = layers.cross_kv_counts()
    for t in range(3):
        step = tokens[:, t:t + 1].to(enc.device)
        if how == "grad_enabled":
            with torch.enable_grad():
                _, cache = art.model.decode_step(params, step, cache)
        else:
            _, cache = art.decode_step(params, step, cache)
    assert _moved(before) == (0, 0)
    assert cache["enc"] is enc and not hasattr(enc, "_repro_cross_kv")
    assert sorted(cache) == LEAVES
