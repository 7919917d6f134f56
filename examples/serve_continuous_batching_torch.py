"""Continuous-batching serving demo on the PyTorch port: per-request policy
tiers on one engine (``examples/serve_continuous_batching.py`` on
``repro_torch``).

One paged ServeEngine (8-token KV pages, chunked prefill) serves six
requests: three prompts, each submitted twice — once under the "exact"
tier and once under the "approx" (PC3_TR) tier. The engine batches rows by
resolved policy into one step per group, so exact and approximate traffic
decode side by side; the KV pool is shared, but prefix caching is
policy-keyed, so approximate K/V never leaks into the exact tier. The
paired greedy generations are compared token by token, and the per-group
site resolution with its estimated multiply energy closes the run.

Run:  PYTHONPATH=src python examples/serve_continuous_batching_torch.py
      [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, Request, ServeEngine

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda",
                    help="where the model and the KV pool live (cuda | cpu)")
args = parser.parse_args()

cfg = get_config("tinyllama_1_1b").smoke(n_layers=4, vocab=128, window=0)
model = build_model(cfg, device=args.device)
with torch.inference_mode():
    params = model.init(0)

engine = ServeEngine(model, params, EngineConfig(
    num_slots=2, max_seq=64, block_size=8, prefill_chunk=8,
    tiers=(("exact", "*=exact"), ("approx", "*=pc3_tr"))),
    device=args.device)

rng = np.random.default_rng(1)
requests = []
for i, (plen, gen) in enumerate(((11, 8), (5, 6), (17, 10))):
    prompt = rng.integers(0, cfg.vocab, size=plen).tolist()
    for tier in ("exact", "approx"):
        requests.append(Request(prompt=prompt, max_new_tokens=gen,
                                arrival_step=2 * i, policy=tier))

report = engine.run(requests)
for ev in report.events:
    what = (f"admit  req {ev['request_id']} -> {ev['group']}/row {ev['slot']}"
            if ev["event"] == "admit"
            else f"retire req {ev['request_id']} "
                 f"({ev['group']}/row {ev['slot']}, {ev['reason']})")
    print(f"step {ev['step']:3d}  {what}")
print(report.summary())

print("\nexact vs pc3_tr greedy generations (same prompt, paired tiers):")
done = sorted(report.completed, key=lambda s: s.request_id)
for e, a in zip(done[0::2], done[1::2]):  # submissions alternate tiers
    n = min(len(e.output), len(a.output))
    agree = sum(x == y for x, y in zip(e.output, a.output)) / max(n, 1)
    print(f"req {e.request_id}/{a.request_id}: token agreement "
          f"{agree * 100:5.1f}%  exact={e.output[:8]}  pc3_tr={a.output[:8]}")
print()
print(engine.resolution_report())
