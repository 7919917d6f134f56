"""Tiny stand-ins for the benchmark's configurations and traffic, for tests
on the CPU: every width cut, every file's shape kept."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402

CONFIGS = {
    "dense": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=128, vocab_size=256, num_hidden_layers=2),
    "encdec": dict(d_model=64, encoder_layers=2, decoder_layers=2,
                   encoder_attention_heads=4, decoder_attention_heads=4,
                   encoder_ffn_dim=128, decoder_ffn_dim=128, vocab_size=256,
                   max_source_positions=16, max_target_positions=32),
}
WORKLOADS = {
    "score": dict(seq=32, distinct_batches=2),
    "serve_closed": dict(
        engine={"num_slots": 4, "prefill_chunk": 8, "block_size": 8,
                "max_seq": 32},
        traffic={"clients": 8, "per_client": 2, "prompt": [4, 12],
                 "output": [3, 8], "tiers": ["free", "paid"]},
        trace_ticks=4),
    "decode": dict(batch=2, trace_steps=1),
    "train": dict(seq=16, distinct_batches=2),
}


def cell(name: str, seed: int = 1, seconds: float = 0.2, bench_dir=None,
         **over) -> harness.Cell:
    """Cell ``name`` at tiny widths on the CPU."""
    import torch

    bench_dir = bench_dir or harness.BENCH
    bench = harness.load_json(bench_dir.parent / "BENCHMARK.json")
    entry, wl, cfg = harness.find_cell(bench, name, bench_dir)
    cfg = dict(cfg, **CONFIGS[cfg["family"]])
    wl = dict(wl, **WORKLOADS[wl["driver"]], **over)
    return harness.Cell(name=name, entry=entry, workload=wl, config=cfg,
                        seed=seed, seconds=seconds, trace=False,
                        device=torch.device("cpu"))


def run(c: harness.Cell, bench_dir=None, **kw) -> dict:
    import time

    mod = harness.driver_module(c.kind, bench_dir or harness.BENCH)
    return mod.run(c, time.time(), harness.Spans(), **kw)
