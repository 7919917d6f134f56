"""Plain-torch training of the dense decoder: the reference's forward
(``models.decoder_logits``) with autograd through every op, the DAISM
GEMMs' backward as approximate GEMMs too (``da = approx(g, w^T)``,
``dw = approx(x^T, g)``, g rounded to bf16 first, the gradients in the
operands' dtype), the next-token cross entropy in f32, and AdamW with f32
master weights and global-norm clipping, written out as the optimizer of
a bf16 deployment is (lr warmed up linearly over ``warmup`` steps, then
cosine to a tenth over ``total``).
"""
from __future__ import annotations

import math

import torch

from . import daism, models


class ApproxMM(torch.autograd.Function):
    """(M, K) @ (K, N) bf16 -> f32 through the DAISM product, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, variant, lower):
        ctx.save_for_backward(x, w)
        ctx.variant, ctx.lower = variant, lower
        return daism.matmul(x, w, variant, lower=lower)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float().to(x.dtype)
        da = daism.matmul(g, w.t().contiguous(), ctx.variant, lower=ctx.lower)
        dw = daism.matmul(x.t().contiguous(), g, ctx.variant, lower=ctx.lower)
        return da.to(x.dtype), dw.to(w.dtype), None, None


class TrainNumerics(models.Numerics):
    """:class:`models.Numerics` whose approximate GEMMs take gradients."""

    def dense(self, site, x, w, b=None):
        if self.sites[site] != "approx":
            return super().dense(site, x, w, b)
        lead = x.shape[:-1]
        out = ApproxMM.apply(x.reshape(-1, x.shape[-1]), w, self.variant,
                             self.lower).to(x.dtype)
        out = out.reshape(*lead, w.shape[-1])
        return out + b.to(out.dtype) if b is not None else out


def lm_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def lr_scale(step: int, warmup: int, total: int) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """AdamW over a flat ``{path: bf16 tensor}`` dict (updated in place):
    f32 master copies, moments in f32, the gradients clipped to a global
    norm of ``clip`` first."""

    def __init__(self, flat, *, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 wd=0.1, clip=1.0, warmup=1, total=100):
        self.flat = flat
        self.master = {k: v.detach().float().clone() for k, v in flat.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.master.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.master.items()}
        self.hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, clip=clip)
        self.warmup, self.total = warmup, total
        self.step = 0

    @torch.no_grad()
    def update(self, grads) -> dict:
        """One step; returns each leaf's clipped gradient norm."""
        hp = self.hp
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        clip = torch.clamp(hp["clip"] / (gnorm + 1e-9), max=1.0)
        lr = hp["lr"] * lr_scale(self.step, self.warmup, self.total)
        self.step += 1
        b1c = 1.0 - hp["b1"] ** self.step
        b2c = 1.0 - hp["b2"] ** self.step
        norms = {}
        for k, p in self.flat.items():
            g = grads[k].float() * clip
            norms[k] = float(torch.linalg.vector_norm(g))
            m, v, mast = self.m[k], self.v[k], self.master[k]
            m.mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
            v.mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
            mast.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + hp["eps"])
                            + hp["wd"] * mast))
            p.copy_(mast)
        return norms


def train(params: dict, cfg: dict, batches, num: TrainNumerics, *,
          warmup: int, total: int, keep_every: float = 1.0):
    """Train ``params`` (a tree, updated in place) on ``batches`` (dicts of
    ``tokens`` and ``labels``); returns (losses, step-1 clipped gradient
    norm of each leaf by path)."""
    from perfbench.weights import flatten, unflatten

    flat = flatten(params)
    opt = AdamW(flat, warmup=warmup, total=total)
    losses, first = [], None
    for batch in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        logits = models.decoder_logits(unflatten(leaves), cfg,
                                       batch["tokens"], num)
        n = int(batch["labels"].shape[1] * keep_every)
        loss = lm_loss(logits[:, :n], batch["labels"][:, :n])
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(leaves.items(), grads)}
        del leaves, logits
        norms = opt.update(grads)
        first = first or norms
        losses.append(float(loss.detach()))
    return losses, first
