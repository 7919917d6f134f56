"""Run a small LM with DAISM-approximate parameter GEMMs and compare its
logits and next tokens against the exact model, through the per-site policy
API: uniform variants first, then mixed policies that keep the sensitive
sites (attention, first/last layer, lm_head) exact while the middle MLPs
run approximate, and the last policy's per-site resolution and estimated
multiply energy. ``examples/approx_lm_inference.py`` on ``repro_torch``
(random weights drawn by torch from seed 0, so the numbers differ from the
JAX example's).

Run:  PYTHONPATH=src python examples/approx_lm_inference_torch.py
      [--policy SPEC] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import policy as P
from repro_torch.configs import get_config
from repro_torch.core import Backend, DaismConfig, Variant
from repro_torch.models.registry import build_model

parser = argparse.ArgumentParser()
parser.add_argument("--policy", default="",
                    help="extra policy spec to evaluate, e.g. "
                         "'*/attn/*=exact,*=pc3_tr'")
parser.add_argument("--device", default="cuda",
                    help="where the model runs (cuda | cpu)")
args = parser.parse_args()

cfg = get_config("tinyllama_1_1b").smoke(n_layers=4, vocab=128)
model = build_model(cfg, device=args.device)
params = model.init(0)
prompt = torch.randint(0, cfg.vocab, (2, 12), device=model.device,
                       generator=torch.Generator(model.device).manual_seed(1))

with torch.no_grad():
    logits_exact, _ = model.forward(params, {"tokens": prompt})


def fidelity(policy):
    with torch.no_grad():
        logits_v, _ = build_model(cfg.with_policy(policy),
                                  device=model.device).forward(
            params, {"tokens": prompt})
    e = logits_exact.float().cpu().numpy().ravel()
    a = logits_v.float().cpu().numpy().ravel()
    corr = np.corrcoef(e, a)[0, 1]
    agree = (logits_exact.argmax(-1) == logits_v.argmax(-1)).float().mean()
    return corr, float(agree)


pc3_tr = DaismConfig(variant=Variant.PC3_TR, backend=Backend.JNP)
policies = [P.ApproxPolicy.uniform(
    DaismConfig(variant=v, backend=Backend.JNP))
    for v in (Variant.FLA, Variant.PC3, Variant.PC3_TR)]
policies += [
    P.ApproxPolicy.first_last_exact(pc3_tr, cfg.n_layers),
    P.ApproxPolicy.attention_exact(pc3_tr),
]
if args.policy:
    policies.append(P.parse_policy(args.policy))

print(f"{'policy':26s} logit-corr  next-token agreement")
for pol in policies:
    corr, agree = fidelity(pol)
    print(f"{pol.name:26s} {corr:10.4f}  {agree * 100:6.1f}%")

# per-site resolution + energy estimate for the last mixed policy
print()
print(P.site_report(policies[-1]))
