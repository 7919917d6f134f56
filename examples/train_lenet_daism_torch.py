"""End-to-end driver on the PyTorch port: train LeNet-5 (~100k params) for
a few hundred steps on synthetic MNIST, then evaluate it under every DAISM
multiplier (the paper's Table-2 experiment as a runnable example), plus a
*mixed* per-site policy (first conv and classifier head exact, the middle
layers PC3_tr) through the policy API. The same protocol as
``examples/train_lenet_daism.py``, on ``repro_torch``.

Run:  PYTHONPATH=src python examples/train_lenet_daism_torch.py [--steps 300]
      [--policy 'cnn/c1=exact,@lm_head=exact,*=pc3_tr'] [--device cpu]

Training is f32 and exact (f32 convolutions, never TF32); the sweep
evaluates the trained weights with the jnp backend (f32 operands; the CUDA
kernel is bf16-only). The mixed policy's per-site resolution and estimated
multiply energy (the paper's 45 nm model) close the run.
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--policy", default="cnn/c1=exact,@lm_head=exact,*=pc3_tr",
                   help="mixed per-site policy evaluated after the variant "
                        "sweep")
    p.add_argument("--device", default="cuda",
                   help="where the model trains and runs (cuda | cpu)")
    args = p.parse_args(argv)

    import torch

    from repro_torch import policy as P
    from repro_torch.configs import get_config
    from repro_torch.core import ALL_VARIANTS, Backend, DaismConfig
    from repro_torch.data import eval_set, image_batches
    from repro_torch.models.cnn import CNNModel
    from repro_torch.models.module import flatten, unflatten
    from repro_torch.models.registry import classifier_loss
    from repro_torch.optim import AdamWConfig, apply_updates, init_state

    cfg = get_config("lenet5")
    model = CNNModel(cfg, device=args.device)
    dev = model.device
    params = model.init(0)
    opt = init_state(params)
    ocfg = AdamWConfig(lr=1e-3, weight_decay=0.01)

    def step(params, opt, images, labels):
        leaves = list(flatten(params).values())
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            try:
                logits, _ = model.forward(params, {"images": images})
                loss = classifier_loss(logits, labels)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
        grads = unflatten(dict(zip(flatten(params), grads)))
        params, opt, _ = apply_updates(params, grads, opt, ocfg)
        return params, opt, loss.detach()

    def put(b):
        return (torch.from_numpy(b["images"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev))

    gen = image_batches(10, 64, shape=(28, 28, 1), noise=0.5, seed=0)
    for i in range(args.steps):
        params, opt, loss = step(params, opt, *put(next(gen)))
        if i % 50 == 0:
            print(f"step {i:4d} loss {float(loss):.4f}")

    test = eval_set(image_batches(10, 64, shape=(28, 28, 1), noise=0.5,
                                  seed=99), 4)

    def accuracy(cfg_eval):
        m = CNNModel(cfg_eval, device=dev)
        correct = total = 0
        with torch.no_grad():
            for b in test:
                images, labels = put(b)
                logits, _ = m.forward(params, {"images": images})
                correct += int((logits.argmax(-1) == labels).sum())
                total += len(b["labels"])
        return correct / total

    print(f"\n{'multiplier':28s} accuracy")
    print(f"{'exact':28s} {accuracy(cfg) * 100:6.2f}%")
    for v in ALL_VARIANTS:
        pol = P.ApproxPolicy.uniform(DaismConfig(variant=v,
                                                 backend=Backend.JNP))
        print(f"{v.value:28s} {accuracy(cfg.with_policy(pol)) * 100:6.2f}%")

    # mixed per-site policy: sensitive sites exact, middle approximate
    mixed = P.parse_policy(args.policy)
    print(f"{'mixed(' + args.policy + ')':28s} "
          f"{accuracy(cfg.with_policy(mixed)) * 100:6.2f}%")
    print()
    print(P.site_report(mixed))


if __name__ == "__main__":
    main()
