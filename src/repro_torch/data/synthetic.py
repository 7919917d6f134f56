"""Synthetic data pipelines (offline: no MNIST/CIFAR downloads).

A copy of the numpy generators of ``repro/data/synthetic.py``: given a seed
they yield the same arrays as the JAX package's copy.

* ``lm_batches`` — token streams from a fixed random bigram automaton with
  copy motifs: a model that learns the transition table reaches much lower
  loss than unigram entropy.
* ``image_batches`` — class-template images (one fixed random template per
  class) + Gaussian noise + random shifts.

Batches are host numpy arrays; the step functions move them to the device
(``launch/steps.py``). ``shard_batch`` has no counterpart: there is no mesh.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    # sparse bigram automaton: each token has 4 likely successors
    succ = rng.integers(0, vocab, (vocab, 4))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            choice = succ[toks[:, t], rng.integers(0, 4, batch)]
            noise = rng.integers(0, vocab, batch)
            use_noise = rng.random(batch) < 0.1
            toks[:, t + 1] = np.where(use_noise, noise, choice)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def image_batches(n_classes: int, batch: int, *, shape=(28, 28, 1),
                  noise: float = 0.35, seed: int = 0,
                  template_seed: int = 1234, max_shift: int = 0,
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """``seed`` drives sampling; ``template_seed`` fixes the class identity
    so train/eval splits with different sampling seeds share the task.
    ``max_shift``: circular-shift augmentation — note white-noise templates
    decorrelate under shifts, so >0 makes the task drastically harder."""
    rng = np.random.default_rng(seed)
    # smooth (low-res-upsampled) templates: local 3x3 patches carry class
    # signal, matching the inductive bias of convnets (white-noise templates
    # have ~no local structure and starve early conv layers of SNR)
    trng = np.random.default_rng(template_seed)
    h, w, c = shape
    f = max(h // 8, 1)
    low = trng.normal(size=(n_classes, -(-h // f), -(-w // f), c))
    templates = np.kron(low, np.ones((1, f, f, 1))).astype(np.float32)
    templates = templates[:, :h, :w, :c]
    templates /= np.linalg.norm(
        templates.reshape(n_classes, -1), axis=1).reshape(
        (n_classes,) + (1,) * len(shape))
    templates *= 8.0
    while True:
        labels = rng.integers(0, n_classes, batch)
        imgs = templates[labels] + rng.normal(
            size=(batch,) + shape).astype(np.float32) * noise
        if max_shift:  # circular-shift augmentation (see docstring)
            sx, sy = rng.integers(-max_shift, max_shift + 1, 2)
            imgs = np.roll(imgs, (sx, sy), axis=(1, 2))
        yield {"images": imgs.astype(np.float32), "labels": labels.astype(np.int32)}


def eval_set(gen: Iterator, n_batches: int):
    return [next(gen) for _ in range(n_batches)]
