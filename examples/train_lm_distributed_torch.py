"""Distributed LM training on the PyTorch port
(``examples/train_lm_distributed.py`` on ``repro_torch``): 8 ranks, a
(4 data x 2 model) mesh, FSDP + tensor-parallel sharding, checkpointed and
resumable.

Run:  PYTHONPATH=src python examples/train_lm_distributed_torch.py --device cpu

With ``--device cpu`` it spawns 8 ``gloo`` ranks; on the card it needs 8
cards (one ``nccl`` rank a card). Re-run it and it resumes from the newest
checkpoint in ``--ckpt``.
"""
import argparse
import os
import tempfile


def train(rank, args):
    """One rank: the mesh, its shards and its batch rows, the resumable
    loop; rank 0 prints."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault_tolerance import TrainLoopConfig, run

    mesh = make_mesh((4, 2), ("data", "model"))
    cfg = get_config("tinyllama_1_1b").smoke(n_layers=2, vocab=128)
    dev = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    art = build_artifacts(cfg, mesh, device=dev,
                          opt_cfg=AdamWConfig(lr=3e-3),
                          total_steps=args.steps, warmup=5)
    params = art.init_params(0)
    opt = art.init_opt(params)
    gen = lm_batches(cfg.vocab, 16, 32, seed=0)
    bsh = art.batch_sharding(next(gen))

    def show(step, m):
        if rank == 0:
            print(f"step {step:4d} loss {m['loss']:.4f}", flush=True)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                           ckpt_every=25, log_every=10)
    params, opt, state = run(
        loop, art.train_step, params, opt, gen,
        lambda b: shard_batch(b, bsh, device=dev), metrics_hook=show,
        param_shardings=art.param_shardings,
        opt_shardings=art.opt_shardings)
    if rank == 0:
        print(f"finished at step {state.step} "
              "(re-run me: I resume from the checkpoint)")
    return state.step


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (8 cards) | cpu (8 gloo ranks)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    args = p.parse_args()

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch

        if torch.cuda.device_count() < 8:
            raise SystemExit(f"8 ranks need 8 cards; the host has "
                             f"{torch.cuda.device_count()}")
    run_ranks(train, 8, args, device=dev.type, timeout_s=3600.0)


if __name__ == "__main__":
    main()
