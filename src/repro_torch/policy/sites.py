"""Op-site abstraction: stable names for every approximate contraction.

Every matmul a model executes gets a *site*: a stable, human-readable path
like ``decoder/layer_3/attn/wq`` plus an :class:`OpKind`. Policies
(:mod:`repro_torch.policy.policy`) map sites to
:class:`~repro_torch.core.config.DaismConfig` numerics, so per-layer / per-op
approximation levels become addressable instead of one global knob.

Paths are built from a scope stack:

* :meth:`repro_torch.models.module.Ctx.scope` pushes its scope names
  (``attn``, ``ffn``, ...) automatically, so site paths mirror parameter
  paths;
* models push structural prefixes (``decoder``, ``layer_3``) with
  :func:`site_scope` around their layer stacks.

The stack is read each time a model function runs. Layer stacks run in
segments of uniform resolved config
(:func:`repro_torch.policy.policy.plan_segments`), each labelled with its
first layer index, exactly as the JAX package's scans are, so a site path
names the same layers in both packages.
"""
from __future__ import annotations

import contextlib
import enum
import threading
from typing import Iterator, Tuple


class OpKind(str, enum.Enum):
    """What kind of contraction a site performs (coarse classes for rules)."""

    DENSE = "dense"            # parameter GEMM (projections, FC, MLP)
    CONV = "conv"              # convolution lowered to im2col GEMM
    ATTN_QK = "attn_qk"        # dynamic attention GEMMs (qk^T + att@v); exact
    #                            unless the rule opts into ':flash' dispatch
    MOE_EXPERT = "moe_expert"  # batched expert GEMM inside an MoE FFN
    LM_HEAD = "lm_head"        # unembedding / classifier head


_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


@contextlib.contextmanager
def site_scope(name: str, *, repeat: int = 1) -> Iterator[None]:
    """Push ``name`` onto the site-path stack for the duration of the block.

    ``repeat`` declares how many times the traced region executes per model
    step (a scan segment of N layers traces once but runs N times); the
    dispatcher scales its per-site multiply counts by the ambient repeat
    product so energy estimates stay honest.
    """
    st = _stack()
    st.append((str(name), int(repeat)))
    try:
        yield
    finally:
        st.pop()


def scope_snapshot() -> Tuple[Tuple[str, int], ...]:
    """The whole scope stack, names and repeats, to re-enter it later
    (:func:`use_scope`: an activation-checkpoint recompute runs in the
    backward, outside the scopes of its forward)."""
    return tuple(_stack())


@contextlib.contextmanager
def use_scope(snapshot: Tuple[Tuple[str, int], ...]) -> Iterator[None]:
    """Run the block with the scope stack set to ``snapshot``; the stack
    object itself is put back after it (the enclosing :func:`site_scope`
    blocks pop from that object)."""
    prev = _stack()
    _LOCAL.stack = list(snapshot)
    try:
        yield
    finally:
        _LOCAL.stack = prev


def current_path(leaf: str = "") -> str:
    """The site path at this point of the trace, optionally with a leaf name."""
    parts = [name for name, _ in _stack()] + ([str(leaf)] if leaf else [])
    return "/".join(parts)


def current_repeat() -> int:
    """Product of ambient ``repeat`` declarations (trace multiplicity)."""
    out = 1
    for _, r in _stack():
        out *= r
    return out


def current_prefix() -> Tuple[str, ...]:
    """The current scope stack as a tuple (for tests / debugging)."""
    return tuple(name for name, _ in _stack())
