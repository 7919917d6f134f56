"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) over a mesh.

Ported from ``repro/parallel/sharding.py``. Parameters and activations are
annotated with *logical* axis names; a :class:`Sharder` maps them onto mesh
axes with the reference's divisibility fallback (an axis that does not
divide the dimension is dropped, so 4 KV heads on a 16-way model axis
degrade to replication).

The reference lays tensors out through GSPMD: ``constrain`` is a
sharding constraint and the compiler inserts the collectives. The port's
layout is explicit: every rank holds its own shard (:func:`shard_tensor`,
``models/convert.py::shard_params``), the model code calls the collectives
itself (``models/layers.py``, ``models/moe.py``), and ``constrain`` is the
identity, as the reference's is outside a mesh.

A :class:`Sharder` is built over a ``torch.distributed`` ``DeviceMesh``
(``launch/mesh.py::make_mesh``) or over a plain ``{axis: size}`` dict, so
that the specs can be computed, and tensors sliced, with no process group.
On ``meta`` tensors (a shape-only trace, ``launch/dryrun.py``) a sizes-only
sharder's collectives run too: a sum returns its input, a gather the
concatenation of its input's copies, and no process group is called.

Inside :func:`record_collectives` every group call is noted, sizes-only
ones on ``meta`` as well, with its operation, bytes (an all-reduce's
operand, an all-gather's result), group size and wire bytes under the
reference's ring factors (``roofline/analysis.py::_wire_factor``). A run
over a process group and a ``meta`` trace of the same step under a
sizes-only sharder of the same sizes note the same calls. These notes take
the place of the reference's ``collective_bytes_from_hlo``: the port has
no HLO.

The collectives are seen by autograd. Each call site names what lies
downstream of it (``downstream=``), and that fixes the backward:

* ``"same"``: every rank of the axes does the same work with the result
  (activations after a sum or gather over ``model``; the logits after
  their vocab gather). The backward takes this rank's part of the
  gradient: the identity for a sum of partials, its slice for a gather.
  Summing there would make the gradient n times too large.
* ``"per_rank"``: the ranks do different work with it (an FSDP weight
  gathered over ``data``, where each data rank holds its own batch rows).
  The backward sums the gradient over the axes: an all-reduce for a sum,
  a reduce-scatter (an all-reduce, then this rank's slice) for a gather.

:meth:`Sharder.sum_grad` is Megatron's ``f``: the identity forward, an
all-reduce of the gradient backward, on the whole input of a
column-parallel GEMM (each rank's input gradient is a partial sum). Out of
autograd (``torch.no_grad``, or an input that takes no gradient) every
collective runs as it did before, in place where it was in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

AxisRule = Union[None, str, Tuple[str, ...]]
# process-group calls made by Sharder.all_reduce / all_gather, by kind
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}
# the open record_collectives() lists (module-wide: a backward may run on
# another thread than the forward)
_TALLIES: list = []
# one entry per tensor dim, as the reference's PartitionSpec: None, a mesh
# axis name, or a tuple of them; trailing None entries are trimmed
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------


def base_rules(multi_pod: bool, *, seq_sharded_cache: bool = False,
               sp_activations: bool = False,
               serve: bool = False) -> Dict[str, AxisRule]:
    """Default production rules (the reference's table, entry for entry).

    Weights: 2-D sharded, 'fsdp'-tagged dims over the data(+pod) axes
    (ZeRO-3), 'model'-tagged dims over the tensor axis. Activations: batch
    over data(+pod), heads/vocab/experts over model. ``seq_sharded_cache``
    moves the decode KV cache's sequence dim onto the model axis;
    ``sp_activations`` shards the token dim of norm/elementwise regions over
    the model axis; ``serve`` is the decode-optimized table (activations
    contraction-sharded over the data axes, the decode batch replicated).
    """
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    if serve:
        return {
            "embed": dp, "heads": "model", "kv_heads": "model",
            "mlp": "model", "vocab": "model", "expert": "model",
            "expert_mlp": None, "layers": None, "conv": None, "ssm": None,
            "act_batch": None,
            "act_seq": None,
            "act_embed": dp,
            "act_heads": "model",
            "act_kv_heads": "model",
            "act_mlp": "model",
            "act_vocab": "model",
            "act_expert": "model",
            "cache_seq": "model" if seq_sharded_cache else None,
            "cache_batch": dp,
            "frames": None,
        }
    return {
        # weight dims
        "embed": dp,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        "ssm": None,
        # activation dims
        "act_batch": dp,
        "act_seq": "model" if sp_activations else None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_expert": "model",
        "cache_seq": "model" if seq_sharded_cache else None,
        "cache_batch": dp,
        "frames": None,
    }


# ---------------------------------------------------------------------------
# Sharder
# ---------------------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an ``{axis: size}`` dict."""
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


class Sharder:
    """Logical axes -> mesh axes for one mesh and one rule table.

    ``mesh`` is a ``DeviceMesh`` with named dims, or a ``{axis: size}``
    mapping (no process group: specs and slicing only; a collective over
    an axis of size > 1 then raises, but on ``meta`` tensors, where it
    returns the shape the group call would).
    """

    def __init__(self, mesh, rules: Dict[str, AxisRule]):
        self.mesh = mesh
        self.rules = dict(rules)
        sizes = (mesh.values() if isinstance(mesh, Mapping) else mesh.shape)
        self.axis_names: Tuple[str, ...] = mesh_axis_names(mesh)
        self._axis_sizes: Dict[str, int] = dict(
            zip(self.axis_names, (int(s) for s in sizes)))
        self._specs: Dict[tuple, Spec] = {}  # a layer asks every step

    def size(self, axis: str) -> int:
        """Size of a mesh axis (1 for an axis the mesh does not have)."""
        return self._axis_sizes.get(axis, 1)

    def _axes_for(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        rule = self.rules.get(name)
        if rule is None:
            return ()
        if isinstance(rule, str):
            rule = (rule,)
        return tuple(a for a in rule if a in self._axis_sizes)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """The reference's ``PartitionSpec`` entries for a tensor with the
        given logical axes, as a tuple.

        With ``shape`` provided, axes that do not divide the dim are dropped
        (partial tuples are trimmed greedily from the right); a mesh axis
        shards at most one dim of a spec.
        """
        key = (tuple(logical_axes), None if shape is None else tuple(shape))
        if key not in self._specs:
            self._specs[key] = self._spec(logical_axes, shape)
        return self._specs[key]

    def _spec(self, logical_axes, shape) -> Spec:
        parts = []
        used = set()
        for d, name in enumerate(logical_axes):
            axes = tuple(a for a in self._axes_for(name) if a not in used)
            if shape is not None and axes:
                dim = shape[d]
                while axes and dim % math.prod(
                        self._axis_sizes[a] for a in axes) != 0:
                    axes = axes[:-1]
            used.update(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def ways(self, entry) -> int:
        """How many shards a spec entry splits its dim into."""
        return math.prod(self.size(a) for a in spec_axes(entry))

    def local_shape(self, shape: Sequence[int], spec: Spec) -> Tuple[int, ...]:
        """A rank's shard shape of a tensor of global ``shape``."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(d // self.ways(e) for d, e in zip(shape, spec))

    # -- this rank on the mesh (DeviceMesh only) -----------------------------

    def coords(self) -> Dict[str, int]:
        """This rank's index along every mesh axis (all 0 without a
        process group)."""
        if isinstance(self.mesh, Mapping):
            return {a: 0 for a in self.axis_names}
        return dict(zip(self.axis_names, self.mesh.get_coordinate()))

    def group(self, axis: str):
        """The process group of one mesh axis."""
        if isinstance(self.mesh, Mapping):
            raise RuntimeError(
                f"mesh axis {axis!r} of size {self.size(axis)} has no process "
                "group: build the Sharder over a DeviceMesh "
                "(repro_torch.launch.mesh.make_mesh)")
        return self.mesh.get_group(axis)

    def constrain(self, x, logical_axes):
        """Identity: the port's layout is explicit (see the module doc)."""
        return x

    # -- collectives over named mesh axes ------------------------------------

    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch rows are split over (``act_batch``: the
        data axes under the train rules, none under the serve rules). A
        weight dim split over these is FSDP's (ZeRO-3): gathered whole
        before use, since every such rank holds other rows."""
        return self._axes_for("act_batch")

    def is_fsdp(self, entry) -> bool:
        """Whether a weight spec entry splits over batch axes only."""
        axes = spec_axes(entry)
        return bool(axes) and set(axes) <= set(self.batch_axes())

    def _groups(self, axes, meta: bool = False):
        """(axis, its process group) for each mesh axis of a spec entry. A
        sizes-only mesh has no group; its axes of size 1 need none, and on
        ``meta`` tensors (``meta``) its larger axes yield None."""
        for a in spec_axes(axes):
            if not isinstance(self.mesh, Mapping):
                yield a, self.group(a)
            elif self.size(a) > 1:
                yield a, None if meta else self.group(a)

    def _reduce(self, x: torch.Tensor, axes, op=None) -> torch.Tensor:
        import torch.distributed as dist

        for a, group in self._groups(axes, x.device.type == "meta"):
            _note("all-reduce", x, self.size(a))
            if group is not None:
                COLLECTIVES["all_reduce"] += 1
                dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
        return x

    def _gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        meta = x.device.type == "meta"
        for a, group in reversed(list(self._groups(axes, meta))):
            n = self.size(a)
            if group is None:
                x = torch.cat([x] * n, dim=dim)
            else:
                COLLECTIVES["all_gather"] += 1
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts, dim=dim)
            _note("all-gather", x, n)
        return x

    def _slice(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's part of ``x`` along ``dim`` under spec entry
        ``axes`` (what :meth:`all_gather` concatenated)."""
        n = self.ways(axes)
        if n == 1:
            return x
        dim = dim % x.dim()
        size = x.shape[dim] // n
        return x.narrow(dim, shard_index(self, axes, self.coords()) * size,
                        size).contiguous()

    def _traced(self, x: torch.Tensor, axes) -> bool:
        """Whether a collective over ``axes`` must be seen by autograd: it
        runs at least one group call and ``x`` takes a gradient."""
        return (torch.is_grad_enabled() and x.requires_grad
                and any(True for _ in self._groups(
                    axes, x.device.type == "meta")))

    def all_reduce(self, x: torch.Tensor, axes, op=None, *,
                   downstream: str) -> torch.Tensor:
        """Sum (or ``op``) ``x`` over the mesh axes ``axes`` (a spec entry):
        in place out of autograd, a new tensor inside it. Over a
        ``DeviceMesh`` an axis of size 1 still calls its group, so one card
        runs the code of many. ``downstream`` fixes the backward (module
        doc): ``"same"`` passes the gradient through, ``"per_rank"`` sums
        it over ``axes``."""
        _check_downstream(downstream)
        if not self._traced(x, axes):
            return self._reduce(x, axes, op)
        import torch.distributed as dist

        if op not in (None, dist.ReduceOp.SUM):
            raise NotImplementedError(
                f"the gradient of an all-reduce by {op} (only sums)")
        return _AllReduce.apply(x, self, axes, downstream)

    def all_gather(self, x: torch.Tensor, axes, dim: int, *,
                   downstream: str) -> torch.Tensor:
        """Concatenate the shards of ``x`` along ``dim`` over the mesh axes
        ``axes`` (a spec entry, major axis first, as :func:`shard_tensor`
        lays them out). ``downstream`` fixes the backward (module doc):
        ``"same"`` takes this rank's slice of the gradient, ``"per_rank"``
        sums it over ``axes`` first (a reduce-scatter)."""
        _check_downstream(downstream)
        if not self._traced(x, axes):
            return self._gather(x, axes, dim)
        return _AllGather.apply(x, self, axes, dim, downstream)

    def sum_grad(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's ``f``: ``x`` itself forward; backward, the gradient
        summed over ``axes``. Put on a whole input that the ranks of
        ``axes`` each use only in part (a column-parallel GEMM's ``x``, an
        ``x`` sliced along a row-parallel K, EP's tokens and router)."""
        if not self._traced(x, axes):
            return x
        return _SumGrad.apply(x, self, axes)


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One group call: the reference's op name (``all-reduce``,
    ``all-gather``), its bytes (the reduce's operand, the gather's
    result), the group size and the bytes each rank puts on the wire."""
    op: str
    bytes: int
    group: int
    wire_bytes: float


def _note(op: str, x: torch.Tensor, n: int) -> None:
    if not _TALLIES:
        return
    from repro_torch.roofline.analysis import _wire_factor

    b = x.numel() * x.element_size()
    call = CollectiveCall(op, b, n, b * _wire_factor(op, n))
    for tally in _TALLIES:
        tally.append(call)


@contextlib.contextmanager
def record_collectives():
    """Collect a :class:`CollectiveCall` for every group call made inside
    the block (on any thread), in call order, into the yielded list."""
    calls: list = []
    _TALLIES.append(calls)
    try:
        yield calls
    finally:
        _TALLIES.remove(calls)


_DOWNSTREAM = ("same", "per_rank")


def _check_downstream(downstream: str) -> None:
    if downstream not in _DOWNSTREAM:
        raise ValueError(f"downstream={downstream!r}: one of {_DOWNSTREAM}")


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharder, axes, downstream):
        ctx.sharder, ctx.axes, ctx.downstream = sharder, axes, downstream
        return sharder._reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.downstream == "per_rank":
            g = ctx.sharder._reduce(g.clone(), ctx.axes)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharder, axes, dim, downstream):
        ctx.sharder, ctx.axes, ctx.dim = sharder, axes, dim
        ctx.downstream = downstream
        return sharder._gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.sharder
        if ctx.downstream == "per_rank":
            g = s._reduce(g.clone(), ctx.axes)
        return s._slice(g, ctx.axes, ctx.dim), None, None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharder, axes):
        ctx.sharder, ctx.axes = sharder, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharder._reduce(g.clone(), ctx.axes), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """One tensor's layout: a spec over a sharder's mesh (the reference's
    ``NamedSharding(mesh, spec)``). The trees ``build_artifacts`` returns
    (``param_shardings``, ``opt_shardings``, ``batch_sharding``,
    ``cache_shardings_for``) hold these."""
    sharder: "Sharder"
    spec: Spec

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor ``full``."""
        return shard_tensor(self.sharder, full, self.spec,
                            self.sharder.coords())

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (a collective: every
        rank of the mesh calls it)."""
        for dim, entry in enumerate(self.spec):
            local = self.sharder._gather(local, entry, dim)
        return local

    def mesh_axes(self) -> Tuple[str, ...]:
        """The mesh axes the tensor is split over, in spec order."""
        return tuple(a for e in self.spec for a in spec_axes(e))


def shard_index(sharder: Sharder, entry, coords: Mapping[str, int]) -> int:
    """This rank's shard number along a dim with spec ``entry``: the mesh
    coordinates of its axes, the first axis major."""
    idx = 0
    for a in spec_axes(entry):
        idx = idx * sharder.size(a) + int(coords.get(a, 0))
    return idx


def shard_tensor(sharder: Sharder, t: torch.Tensor, spec: Spec,
                 coords: Mapping[str, int]) -> torch.Tensor:
    """The shard of the full tensor ``t`` that the rank at mesh ``coords``
    holds under ``spec`` (a contiguous copy; ``t`` itself when nothing is
    split)."""
    out = t
    for d, entry in enumerate(spec):
        n = sharder.ways(entry)
        if n > 1:
            size = t.shape[d] // n
            out = out.narrow(d, shard_index(sharder, entry, coords) * size,
                             size)
    return out if out is t else out.contiguous()


# ---------------------------------------------------------------------------
# The ambient sharder
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_sharder() -> Optional[Sharder]:
    return getattr(_tls, "sharder", None)


@contextlib.contextmanager
def use_sharder(sharder: Optional[Sharder]):
    prev = current_sharder()
    _tls.sharder = sharder
    try:
        yield sharder
    finally:
        _tls.sharder = prev


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Ambient sharding constraint: the identity (explicit layout), with or
    without a sharder."""
    s = current_sharder()
    if s is None:
        return x
    return s.constrain(x, logical_axes)


def tree_shardings(sharder: Sharder, params, axes_tree_):
    """Tree of specs for a param tree and a congruent axes tree (nested
    dicts; leaves are tensors, or anything with a ``shape``)."""
    if isinstance(params, dict):
        return {k: tree_shardings(sharder, params[k], axes_tree_[k])
                for k in params}
    return sharder.spec(axes_tree_, getattr(params, "shape", None))
