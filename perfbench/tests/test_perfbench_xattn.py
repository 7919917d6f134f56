"""``xattn.kv_kept_share`` on synthetic ``model.xattn`` records."""
import types

import pytest

import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench import harness

read = harness.metric_reader("xattn.kv_kept_share")


def rec(name, **attrs):
    return types.SimpleNamespace(name=name, ms=1.0, attrs=attrs)


def xattn(kept, taken):
    return rec("model.xattn", **{"cross_kv.kept": kept,
                                 "cross_kv.taken": taken})


@pytest.mark.parametrize("records, share", [
    ([xattn(1, 0)] * 6, 100.0),
    ([xattn(0, 1)] * 2 + [xattn(1, 0)] * 6, 75.0),
    ([xattn(0, 1)] * 4, 0.0),
    ([rec("model.attn"), xattn(0, 1), rec("engine.launch",
                                           **{"cross_kv.kept": 9}),
      xattn(1, 0), xattn(1, 0), xattn(1, 0)], 75.0),
])
def test_share_of_kept_cross_kv(records, share):
    assert read({}, records) == pytest.approx(share)


def test_none_without_counted_xattn_records():
    assert read({}, []) is None
    assert read({}, [rec("model.attn"), rec("model.ffn")]) is None
    # a program whose model.xattn spans carry no counts
    assert read({}, [rec("model.xattn"), rec("model.xattn")]) is None


def test_none_without_the_ports_span_module(monkeypatch):
    import sys

    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace", raising=False)
    assert read({}) is None
