"""The benchmark's own arithmetic: work counts by hand, the window's rate
and tail, the trace's idle share, and the import check."""
import sys

import pytest

import tiny  # noqa: F401
from perfbench import harness, port, work


def widths(name):
    return port.widths(harness.load_json(
        harness.BENCH / "configs" / f"{name}.json"))


def test_starcoder2_counts_by_hand():
    w = widths("starcoder2-15b")
    per_tok = sum(k * n for _, k, n in work.decoder_layer_gemms(w))
    # q, o: 6144 x 6144; k, v: 6144 x 512 (4 kv heads of 128); MLP 2 x 6144 x 24576
    assert per_tok == 6144 * (6144 + 512 + 512 + 6144) + 2 * 6144 * 24576
    assert per_tok == 383_778_816
    assert work.lm_head_gemm(w) == ("lm_head", 6144, 49152)
    s = 2048
    pairs = s * (s + 1) // 2
    want = (2 * s * (4 * 383_778_816 + 6144 * 49152)
            + 4 * (4 * 48 * 128 * pairs))
    assert work.decoder_flops(w, s, pairs) == want
    # the flash bound is compute-bound at S = 2048: 4 FLOPs a pair a dim a head
    assert work.flash_bound_s(w, 1, s) == pytest.approx(
        4 * 48 * 128 * pairs / 989e12)


def test_whisper_counts_by_hand():
    w = widths("whisper-large-v3")
    per_tok = sum(k * n for _, k, n in work.encdec_decode_gemms(w))
    assert per_tok == 6 * 1280 * 1280 + 2 * 1280 * 5120
    flops = work.encdec_decode_flops(w, 8, 8 * 10)
    want = (2 * 8 * (32 * per_tok + 1280 * 51866)
            + 32 * (4 * 20 * 64 * 80 + 4 * 20 * 64 * 8 * 1500))
    assert flops == want


def test_gemm_bound_is_bytes_at_decode_and_flops_at_prefill():
    k, n = 6144, 24576
    assert work.gemm_bound_s(4, k, n) == pytest.approx(
        (2 * (4 * k + k * n) + 4 * 4 * n) / 3.35e12)
    assert work.gemm_bound_s(2048, k, n) == pytest.approx(
        2 * 2048 * k * n / 989e12)
    assert work.gemm_bound_s(0, k, n) == 0.0


def timeline(stall: float):
    """Closed-loop requests of a fixed plan: each takes 0.1 s of service
    after its client's last; ``stall`` s of stall hits request 5."""
    t, ttft, done = 0.0, [], 0
    for i in range(20):
        wait = 0.02 + (stall if i == 5 else 0.0)
        ttft.append(wait)
        t += wait + 0.1
        done += 10
    return done, t, ttft


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    tok0, s0, ttft0 = timeline(0.0)
    tok1, s1, ttft1 = timeline(0.5)
    assert harness.rate(tok1, s1) < harness.rate(tok0, s0)
    assert harness.percentile(ttft1, 95) > harness.percentile(ttft0, 95)
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    assert harness.percentile(list(range(11)), 90) == pytest.approx(9.0)


def _events(gap_us):
    ev = [{"name": harness.TRACED, "cat": "user_annotation", "ts": 0,
           "dur": 1000 + gap_us},
          {"name": "step", "cat": "user_annotation", "ts": 0,
           "dur": 1000 + gap_us},
          {"name": "gemm_a", "cat": "kernel", "ts": 0, "dur": 400},
          {"name": "gemm_a", "cat": "kernel", "ts": 300, "dur": 200},
          {"name": "other", "cat": "kernel", "ts": 600 + gap_us, "dur": 400}]
    return harness.summarize_trace(ev)


def test_an_idle_gap_shows_in_the_trace_summary():
    a, b = _events(0), _events(500)
    assert a.busy_s == pytest.approx(900e-6)   # 0-500 and 600-1000
    assert b.busy_s == pytest.approx(a.busy_s)
    assert b.window_s - b.busy_s > a.window_s - a.busy_s
    assert b.gaps["step"] == pytest.approx(600e-6)
    assert a.kernel_seconds(("gemm",)) == pytest.approx(600e-6)
    assert harness.summarize_trace([]) is None


@pytest.mark.parametrize("name,bad", [("jax", True), ("jax.numpy", True),
                                      ("jaxlib", True), ("flax", True),
                                      ("repro", True), ("repro.core", True),
                                      ("repro_torch", False),
                                      ("repro_torch.models", False),
                                      ("jaxtyping", False)])
def test_import_check(monkeypatch, name, bad):
    for m in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_loaded()) is bad
