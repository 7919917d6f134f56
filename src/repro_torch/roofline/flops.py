"""FLOP, byte and memory counting of a step traced on ``meta`` tensors.

The port of ``repro/roofline/flops.py``. The reference walks the jaxpr;
the port has none, so a :class:`Tally` (a ``TorchDispatchMode``) sees
every aten op the step runs, forward, backward and activation-checkpoint
recompute alike, and counts it by the reference's rules, case by case:

* ``mm``/``bmm``/``addmm``/``baddbmm`` (``dot_general``): 2mnk (+ mn for
  the add of ``addmm``); ``convolution`` (``conv_general_dilated``): 2 x
  the output elements x the kernel's elements per output;
* data movement, views, fills, comparisons, selects and bit operations
  (the reference's ``_ZERO``): 0;
* reductions (``sum``, ``amax``, ``argmax``, ``cumsum``, ...): the input's
  elements; ``mean`` the input's and the output's (``reduce_sum`` +
  ``div``); ``sort``/``topk``: n log2 n;
* composite aten ops, counted as the reference's decomposition of the same
  function counts: ``_softmax`` 5n, ``_log_softmax`` 5n + rows, ``silu``
  2n, tanh ``gelu`` 8n, ``softplus`` 7n, their backward formulas likewise
  (``_BACKWARD``);
* every other op: one a output element (the reference's ``_EXPENSIVE``
  ops count so too).

A hand-written kernel on ``meta`` runs nothing (``kernels/ops.py``,
``kernels/flash_attention.py``): its wrapper reports the call
(:func:`note_kernel_call`) and it counts as the
reference counts a ``pallas_call``, none of the primitives it names: one
operation an output element. Under ``*=pc3_tr:pallas`` the approximate
GEMMs therefore count by their outputs, in both packages: that compute
term is not the GEMM's work (ROADMAP C3).

``bytes`` is the sum over the ops of each op's inputs and outputs as
shaped (views, fills and ``empty`` move none): the eager program's HBM
traffic, since nothing is fused. It is not XLA's post-fusion ``bytes
accessed``, and no test holds it against the reference's.

``peak_bytes`` is the peak of the bytes of the storages the traced
function allocates, live at once: each new storage adds its bytes and a
``weakref.finalize`` on it takes them off when it is freed (the storages
of ``meta`` tensors are freed like any other; checked by
``tests/test_torch_roofline.py``).

The port's Python recurrences (xLSTM's cells, Zamba's SSD) go through
:func:`run_steps`: under a :class:`Tally` a loop whose state keeps its
shape runs its body once, the body's counts (forward, and through
:class:`_Mark` its backward) scaled by the trip count, as the reference's
``scan`` rule multiplies a body by its ``length``; the stacked outputs are
that one step's, copied to the full length. Outside a tally nothing
changes.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# aten ops with zero FLOPs (data movement, bookkeeping, comparisons, bits)
_ZERO = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "copy", "copy_", "_to_copy", "clone", "contiguous",
    "cat", "stack", "constant_pad_nd", "pad", "repeat", "flip", "roll",
    "index", "index_select", "gather", "scatter", "index_put", "index_put_",
    "index_copy", "index_copy_", "embedding", "masked_fill", "masked_fill_",
    "where", "slice_scatter", "select_scatter", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "__and__", "__or__", "__xor__", "sign", "isfinite", "isnan", "isinf",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "detach",
    "alias", "_unsafe_view", "tril", "triu", "embedding_dense_backward",
    "select_backward", "slice_backward", "unbind", "split_with_sizes",
    "split", "nll_loss_backward", "im2col", "col2im",
}
# reductions: the input's elements
_REDUCE = {"sum", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
           "cumsum", "cumprod", "any", "all", "logsumexp"}
# composite ops: FLOPs an element of the (first) input, as the reference's
# decomposition of the same function counts them
_PER_ELEMENT = {"_softmax": 5, "_log_softmax": 5, "silu": 2, "gelu": 8,
                "softplus": 7, "sigmoid": 1, "linalg_vector_norm": 2,
                "mean": 1}
# their backward formulas (the reference's AD of the decomposition)
_BACKWARD = {"_softmax_backward_data": 4, "_log_softmax_backward_data": 4,
             "silu_backward": 4, "gelu_backward": 14, "softplus_backward": 4,
             "sigmoid_backward": 2, "tanh_backward": 2}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "dot", "mv", "addmv"}
# ops that move no bytes: allocations, and aliases that are not views
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias",
               "_local_scalar_dense"}

# the open tallies (module-wide: a backward may run on another thread)
_ACTIVE: List["Tally"] = []


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def matmul_flops(name: str, args) -> float:
    """2mnk of one matmul-like aten op (plus mn for an ``addmm``'s add)."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        m, k = a.shape
        n = b.shape[1]
        return 2.0 * m * n * k + (m * n if name == "addmm" else 0)
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        bb, m, k = a.shape
        n = b.shape[2]
        return 2.0 * bb * m * n * k + (bb * m * n if name == "baddbmm" else 0)
    if name == "dot":
        return 2.0 * args[0].numel()
    a = args[0] if name == "mv" else args[1]
    return 2.0 * a.numel() + (a.shape[0] if name == "addmv" else 0)


def conv_flops(out: torch.Tensor, weight: torch.Tensor) -> float:
    """The reference's ``_conv_flops`` for an ungrouped convolution: 2 x
    the output's elements x the kernel's elements an output feature."""
    return 2.0 * out.numel() * math.prod(weight.shape[1:])


def op_flops(name: str, args, out) -> float:
    """FLOPs of one aten op by the reference's rules (module doc)."""
    if name in _MATMULS:
        return matmul_flops(name, args)
    if name == "convolution":
        return conv_flops(out, args[1])
    if name == "convolution_backward":  # the input's and the kernel's
        return 2.0 * conv_flops(args[0], args[2])
    if name in _ZERO:
        return 0.0
    if name in _REDUCE:
        return float(_numel(args[0]))
    if name in ("sort", "topk"):
        n = _numel(args[0])
        return n * max(math.log2(max(n, 2)), 1)
    if name in _PER_ELEMENT:
        n = _numel(args[0])
        extra = 0
        if name == "mean":
            extra = _numel(out)
        elif name == "_log_softmax":
            dim = args[1] % max(args[0].dim(), 1)
            extra = n // max(args[0].shape[dim], 1) if args[0].dim() else 1
        return float(_PER_ELEMENT[name] * n + extra)
    if name in _BACKWARD:
        return float(_BACKWARD[name] * _numel(args[0]))
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return float(sum(_numel(t) for t in outs))


class Tally(TorchDispatchMode):
    """Counts of everything run inside it (module doc).

    ``flops``: every op by the rules; ``dot_flops``: matmuls and
    convolutions alone; ``kernel_calls`` / ``kernel_flops``: the
    hand-written kernels' calls (by name) and output elements;
    ``bytes``: each op's inputs and outputs; ``peak_bytes``: the peak of
    the live bytes of storages made inside (not those of ``known``
    tensors, the arguments); ``by_op``: FLOPs by aten op name.
    """

    def __init__(self, known: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_calls: Dict[str, float] = {}
        self.by_op: Dict[str, float] = {}
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._scales: List[float] = []
        self.backward_scale = 1.0
        for t in known:
            self._seen[id(t.untyped_storage())] = 0

    # -- scaling (run_steps) --------------------------------------------
    @property
    def scale(self) -> float:
        return math.prod(self._scales) * self.backward_scale

    @contextlib.contextmanager
    def scaled(self, n: float):
        self._scales.append(float(n))
        try:
            yield
        finally:
            self._scales.pop()

    # -- live storages ----------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        nb = st.nbytes()
        self._seen[key] = nb
        self.live += nb
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    # -- the dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        s = self.scale
        f = 0.0 if func.is_view else op_flops(name, args, out) * s
        self.flops += f
        if f:
            self.by_op[name] = self.by_op.get(name, 0.0) + f
        if name in _MATMULS:
            self.dot_flops += matmul_flops(name, args) * s
        elif name in ("convolution", "convolution_backward"):
            self.dot_flops += f
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not (func.is_view or name in _NO_TRAFFIC):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += s * (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        return out

    def note_kernel(self, name: str, inputs, out: torch.Tensor) -> None:
        s = self.scale
        self.kernel_calls[name] = self.kernel_calls.get(name, 0.0) + s
        self.kernel_flops += out.numel() * s
        self.flops += out.numel() * s
        self.by_op[name] = self.by_op.get(name, 0.0) + out.numel() * s
        self.bytes += s * (sum(_nbytes(t) for t in inputs) + _nbytes(out))

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)



def active_tally() -> Optional[Tally]:
    """The innermost open :class:`Tally`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def note_kernel_call(name: str, inputs, out: torch.Tensor) -> None:
    """Called by a kernel wrapper's ``meta`` branch: the call counts in
    every open tally, as the reference counts a ``pallas_call``."""
    for t in _ACTIVE:
        t.note_kernel(name, inputs, out)


# ---------------------------------------------------------------------------
# Python recurrences
# ---------------------------------------------------------------------------


class _Mark(torch.autograd.Function):
    """Identity forward. Backward: sets the tally's backward scale, to the
    trip count at a loop's outputs (``n``), back to 1 at its inputs. The
    autograd engine runs a graph's nodes from the last made to the first,
    so the nodes of the body run between the two."""

    @staticmethod
    def forward(ctx, x, tally, n):
        ctx.tally, ctx.n = tally, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.tally.backward_scale = ctx.n
        return g, None, None


def _mark(tree, tally: Tally, n: float):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_mark(t, tally, n) for t in tree)
    if (isinstance(tree, torch.Tensor) and torch.is_grad_enabled()
            and tree.requires_grad):
        return _Mark.apply(tree, tally, n)
    return tree


def run_steps(step: Callable, state, inputs: Sequence[torch.Tensor],
              length: int):
    """``for t in range(length): state, y_t = step(state, *(x[:, t] for x
    in inputs))``; returns (the final state, the ``y_t`` stacked along dim
    1). Under a :class:`Tally`, on ``meta`` inputs, the body runs once,
    counted ``length`` times, and the stacked output is its one step
    copied to the full length (module doc); the state must keep its
    shapes."""
    tally = active_tally()
    if (tally is None or length <= 1
            or any(x.device.type != "meta" for x in inputs)):
        cols = [x.unbind(1) for x in inputs]
        ys = []
        for t in range(length):
            state, y = step(state, *(c[t] for c in cols))
            ys.append(y)
        return state, torch.stack(ys, 1)
    state, cols0 = _mark((state, [x.select(1, 0) for x in inputs]), tally,
                         1.0)
    with tally.scaled(length):
        new, y = step(state, *cols0)
    shapes = [t.shape for t in tree_flatten(state)[0]]
    if shapes != [t.shape for t in tree_flatten(new)[0]]:
        raise ValueError("run_steps: the state changed its shapes")
    new, y = _mark((new, y), tally, float(length))
    return new, y.unsqueeze(1).expand(
        y.shape[0], length, *y.shape[1:]).contiguous()


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------


def count(fn: Callable, *args, **kw):
    """Run ``fn(*args, **kw)`` (on ``meta`` tensors: nothing runs) under a
    :class:`Tally` and :func:`~repro_torch.parallel.sharding.record_collectives`.
    Returns (the result, the tally, the collective calls); the arguments'
    storages are ``known``, not the trace's own."""
    from repro_torch.parallel.sharding import record_collectives

    with record_collectives() as calls, Tally(_tensors_in((args, kw))) as tally:
        out = fn(*args, **kw)
    return out, tally, calls


def _tensors_in(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, tuples (named too) and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_in(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors_in(v)]
    return []


def count_flops(fn: Callable, *args, **kw) -> float:
    """Global FLOPs of ``fn(*args)`` (the reference's ``count_flops``; run
    it on ``meta`` tensors at global shapes for a trace that runs nothing)."""
    return count(fn, *args, **kw)[1].flops
