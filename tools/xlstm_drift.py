#!/usr/bin/env python3
"""How far PC3_TR moves xLSTM-1.3B's logits, in each package (ROADMAP C5).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xlstm_drift.py [--layers 8] [--seq 16]

Builds xLSTM-1.3B at its published width (cut in depth to ``--layers``,
bf16 weights drawn by the JAX package from seed 0 and converted to the
PyTorch port), and runs both packages' CPU forwards of one sequence of
``--seq`` seeded tokens under ``*=exact`` and ``*=pc3_tr``. Prints, for
each package, the drift max |logits(pc3_tr) - logits(exact)| / max
|logits(exact)|, and, for each policy, the gap between the packages. Equal
drifts make the drift the model's; a drift of the port alone is a fault of
the port. Outside the test suite: a forward at this width takes minutes on
the CPU.
"""
import argparse
import dataclasses
import json
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jget
    from repro.models.registry import build_model as jbuild
    from repro_torch.configs import get_config as tget
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model as tbuild

    torch.set_num_threads(args.threads)
    jcfg = dataclasses.replace(jget("xlstm_1_3b"), n_layers=args.layers)
    tcfg = dataclasses.replace(tget("xlstm_1_3b"), n_layers=args.layers)
    t0 = time.perf_counter()
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    print(f"xlstm_1_3b: {args.layers} of 48 layers, d_model {jcfg.d_model}, "
          f"{jcfg.param_dtype}; init {time.perf_counter() - t0:.1f} s",
          flush=True)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab,
                                             size=(1, args.seq))
    logits = {}
    for spec in ("*=exact", "*=pc3_tr"):
        jm = jbuild(jcfg.with_policy(spec))
        t0 = time.perf_counter()
        ref, _ = jax.jit(jm.forward)(jax.tree.map(jnp.asarray, np_params),
                                     {"tokens": jnp.asarray(toks)})
        ref = np.asarray(ref, np.float32)
        t_ref = time.perf_counter() - t0
        cfg = tcfg.with_policy(spec)
        tm = tbuild(cfg, device="cpu")
        tp = params_from_jax(np_params, cfg, device="cpu")
        t0 = time.perf_counter()
        with torch.no_grad():
            got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
        got = got.float().numpy()
        t_port = time.perf_counter() - t0
        logits[spec] = (ref, got)
        gap = float(np.abs(got - ref).max() / np.abs(ref).max())
        print(f"{spec}: reference {t_ref:.1f} s, port {t_port:.1f} s; port "
              f"vs reference max |diff| / max |ref| {gap:.4g}", flush=True)

    def drift(i):
        ex, ap = logits["*=exact"][i], logits["*=pc3_tr"][i]
        return float(np.abs(ap - ex).max() / np.abs(ex).max())

    out = {"layers": args.layers, "seq": args.seq,
           "drift_reference": drift(0), "drift_port": drift(1),
           "gap_exact": float(np.abs(logits["*=exact"][1]
                                     - logits["*=exact"][0]).max()
                              / np.abs(logits["*=exact"][0]).max()),
           "gap_pc3_tr": float(np.abs(logits["*=pc3_tr"][1]
                                      - logits["*=pc3_tr"][0]).max()
                               / np.abs(logits["*=pc3_tr"][0]).max())}
    print(f"PC3_TR drift of the logits (max |pc3_tr - exact| / max |exact|)"
          f": reference {out['drift_reference']:.4g}, port "
          f"{out['drift_port']:.4g}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
