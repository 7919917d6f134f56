"""The engine's span metrics (``span_readers.py``) on synthetic records and
a synthetic trace summary."""
import types

import pytest

import tiny  # noqa: F401
from perfbench import harness, span_readers


def rec(name, ms=1.0, **attrs):
    return types.SimpleNamespace(name=name, ms=ms, attrs=attrs)


KERNELS = {"daism_matmul.launches": 17, "daism_matmul.sum_launches": 12,
           "flash_attention.launches": 0}
RECORDS = [
    rec("engine.tick"),
    rec("engine.launch", 9.0, kind="prefill", positions=128, tokens=32,
        **KERNELS),
    rec("model.lm_head"),
    rec("engine.launch", 2.0, kind="decode", positions=4, tokens=4,
        **KERNELS),
    rec("model.lm_head"),
    rec("engine.launch", 4.0, kind="decode", positions=4, tokens=3,
        **dict(KERNELS, **{"daism_matmul.sum_launches": 10})),
    rec("engine.launch", 3.0, kind="prefill", positions=128, tokens=64),
    rec("model.lm_head"),
    rec("engine.fetch", 20.0),
]
GAPS = {"engine.launch": 0.10, "engine.stage": 0.02, "model.attn": 0.03,
        "model.lm_head": 0.01, "engine.tick": 0.05, "engine.blocks": 0.01,
        "engine.admit": 0.02, "engine.apply": 0.04, "engine.fetch": 0.005,
        "engine.swap": 0.005, "serve.tick": 0.03, "outside any span": 0.01}


def layer(gaps=GAPS, window_s=2.0):
    idle = sum(gaps.values())
    return {"trace": harness.TraceSummary(
        window_s=window_s, busy_s=window_s - idle, kernels={}, gaps=gaps)}


def test_idle_shares_split_the_idle_share():
    lay = layer()
    launch = span_readers.idle_share(lay, span_readers.in_launch, RECORDS)
    host = span_readers.idle_share(lay, span_readers.in_host, RECORDS)
    assert launch == pytest.approx(100 * 0.16 / 2.0)
    assert host == pytest.approx(100 * 0.13 / 2.0)
    rest = 100 * (GAPS["serve.tick"] + GAPS["outside any span"]) / 2.0
    from perfbench.readers import idle

    assert launch + host + rest == pytest.approx(idle(lay))


def test_idle_shares_need_the_ports_engine_spans():
    lay = layer({"serve.tick": 0.3})
    for charged in (span_readers.in_launch, span_readers.in_host):
        assert span_readers.idle_share(lay, charged, RECORDS) == 0.0
        assert span_readers.idle_share(lay, charged, RECORDS[1:]) is None
        assert span_readers.idle_share({"trace": None}, charged,
                                       RECORDS) is None


def test_launch_median_reads_decode_launches_only():
    assert span_readers.launch_ms_p50(RECORDS) == pytest.approx(3.0)
    assert span_readers.launch_ms_p50(RECORDS[:3]) is None


def test_prefill_pad_share():
    assert span_readers.prefill_pad_share(RECORDS) == pytest.approx(
        100 * (1 - 96 / 256))
    assert span_readers.prefill_pad_share(RECORDS[3:6]) is None


def test_launches_per_decode_reads_decode_launches_only():
    assert span_readers.launches_per_decode(RECORDS) == pytest.approx(28.0)
    assert span_readers.launches_per_decode(RECORDS[:3]) is None


def host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def launch(ts, corr):
    return dict(host("cudaLaunchKernel", ts, 2, "cuda_runtime"),
                args={"correlation": corr})


def kernel(ts, dur, corr, cat="kernel"):
    return dict(host("k", ts, dur, cat), args={"correlation": corr})


# two launches; the first's lm_head range issues kernels 3 and 4; kernel 5
# is issued outside any launch, kernel 6 has no launching call
EVENTS = [
    host(harness.TRACED, 0, 1000),
    host("engine.launch", 10, 100), host("model.lm_head", 60, 40),
    launch(20, 1), launch(30, 2), launch(70, 3), launch(80, 4),
    host("engine.launch", 300, 100), launch(310, 7),
    launch(250, 5),
    kernel(100, 50, 1), kernel(150, 25, 2), kernel(175, 15, 3),
    kernel(190, 10, 4, "gpu_memcpy"), kernel(260, 30, 5), kernel(400, 9, 6),
    kernel(410, 20, 7),
    dict(host("k", 175, 15, "gpu_user_annotation"),
         args={"correlation": 3}),
]


def test_lm_head_share_joins_device_ops_to_their_launching_range():
    s = span_readers.range_device_s(EVENTS, ("model.lm_head",
                                             "engine.launch"))
    assert s == pytest.approx({"model.lm_head": 25e-6,
                               "engine.launch": 120e-6})
    assert span_readers.lm_head_share(layer(), EVENTS) == pytest.approx(
        100 * 25 / 120)
    without = [e for e in EVENTS if e["name"] != "model.lm_head"]
    assert span_readers.lm_head_share(layer(), without) is None


def test_lm_head_share_finds_the_segments_chrome_trace(tmp_path):
    import json
    import os

    other = [host(harness.TRACED, 0, 2000)] + EVENTS[1:]
    for name, events, mtime in (("trace-a.json", EVENTS, 1),
                                ("trace-b.json", other, 2)):
        path = tmp_path / name
        path.write_text(json.dumps({"traceEvents": events}))
        os.utime(path, (mtime, mtime))
    lay = layer(window_s=1e-3)
    assert span_readers.trace_events(lay, tmp_path) == EVENTS
    assert span_readers.trace_events(layer(window_s=3e-3), tmp_path) is None
    assert span_readers.trace_events({"trace": None}, tmp_path) is None


def test_without_the_ports_span_module_every_reader_is_silent(monkeypatch):
    import sys

    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace", raising=False)
    assert span_readers.port_records() is None
    assert span_readers.idle_share(layer(), span_readers.in_host) is None
    assert span_readers.launch_ms_p50() is None
    assert span_readers.prefill_pad_share() is None
    assert span_readers.launches_per_decode() is None
