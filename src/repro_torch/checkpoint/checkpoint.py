"""Checkpointing: atomic and resumable, in the JAX package's format.

Format (that of ``repro/checkpoint/checkpoint.py``): one directory per
step, ``step_<N:08d>/``, containing

  * ``arrays.npz`` — every leaf as a full array on the host, keyed by its
                     flattened tree path;
  * ``meta.json``  — the step number, the sorted keys and a sha256 digest;
  * ``_COMPLETE``  — the sentinel, written last. The directory is written
                     under a ``.tmp_`` name and renamed, so a crash
                     mid-write leaves no sentinel and the loader skips it.

Key paths are the reference's: dict keys joined by ``/``, a NamedTuple field
as ``.<field>`` and a sequence entry as its index, so the optimizer state
``AdamWState`` flattens to ``opt/.step``, ``opt/.master/...``,
``opt/.m/...`` and ``opt/.v/...`` in both packages.

bf16 leaves are stored as 2-byte void (``|V2``): the bits, which is what
``np.savez`` writes for the reference's ``ml_dtypes`` bf16 arrays. So each
package reads the other's checkpoints: the reference views ``V`` arrays
back to bf16, and this module views them as int16 and then as
``torch.bfloat16``, with no ``ml_dtypes``.

Under a mesh the file holds the same global arrays. :func:`save` with
``shardings`` (a tree of ``parallel.sharding.NamedSharding`` like the
tree's) gathers every leaf whole (a collective every rank joins), rank 0
writes the directory and its sentinel, and the other ranks wait at a
barrier. :func:`restore` with ``shardings`` reads the global arrays and
keeps this rank's shard of each, so a run restores onto another mesh
than the one that saved it (elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

SENTINEL = "_COMPLETE"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in the reference's key names and leaf order (dict
    keys sorted, as ``jax.tree_util`` orders them)."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
        return out
    if _is_namedtuple(tree):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_flatten(v, join(f".{name}")))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
        return out
    return {prefix: tree}


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with its leaves taken from ``leaves`` by path."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, join(k)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten_like(v, leaves, join(f".{name}"))
                            for name, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, join(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the host array ``np.savez`` stores: bf16 as ``|V2`` bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """A stored array as a host tensor with ``like``'s dtype, on the
    array's memory (``np.load`` gives each array its own) or a copy."""
    want = like.dtype if isinstance(like, torch.Tensor) else None
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.kind == "V":  # bf16 bits (either package's save)
        if arr.dtype.itemsize != 2 or want not in (None, torch.bfloat16):
            raise ValueError(f"stored {arr.dtype} cannot restore a {want} "
                             "leaf")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if want is not None and t.dtype != want:
        t = t.to(want)
    return t


def _head_bytes(arr: np.ndarray, n: int) -> bytes:
    """``arr.tobytes()[:n]`` without copying the whole array first."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:n].tobytes()


def is_writer() -> bool:
    """Whether this process writes and deletes checkpoint files: rank 0 of
    the process group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any,
         shardings: Optional[Any] = None) -> str:
    """Atomically persist ``tree`` (copied to the host). With
    ``shardings``, ``tree`` is this rank's shards: every rank calls it, the
    leaves are gathered whole, rank 0 writes (module doc)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(tree)
    if shardings is not None:
        import torch.distributed as dist

        layout = _flatten(shardings)
        flat = {k: layout[k].gather(v) if isinstance(v, torch.Tensor) else v
                for k, v in flat.items()}
        if is_writer():
            _write(ckpt_dir, final, step, flat)
        if dist.is_initialized():
            dist.barrier()
        return final
    _write(ckpt_dir, final, step, flat)
    return final


def _write(ckpt_dir: str, final: str, step: int, flat: Dict[str, Any]):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays = {k: _to_numpy(v) for k, v in flat.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        digest = hashlib.sha256()
        for k in sorted(arrays):  # the reference's: each leaf's first 4 KiB
            digest.update(k.encode())
            digest.update(_head_bytes(arrays[k], 4096))
        meta = {"step": step, "keys": sorted(arrays.keys()),
                "digest": digest.hexdigest()}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, SENTINEL), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a complete checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, SENTINEL)):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like``: fresh tensors with the dtype
    and on the device of ``like``'s leaves (nothing aliases ``like``).
    With ``shardings`` (a tree like ``like``'s), each leaf is this rank's
    shard of the stored global array, whatever mesh saved it."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, SENTINEL)):
        raise FileNotFoundError(f"incomplete/missing checkpoint {path}")
    flat_like = _flatten(like)
    layout = _flatten(shardings) if shardings is not None else {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        leaves = {}
        for k, leaf in flat_like.items():
            t = _to_tensor(data[k], leaf)
            if k in layout:
                t = layout[k].shard(t)
            if isinstance(leaf, torch.Tensor) and t.shape != leaf.shape:
                raise ValueError(f"{k}: restored shard {tuple(t.shape)}, the "
                                 f"tree holds {tuple(leaf.shape)}")
            leaves[k] = t.to(leaf.device if isinstance(leaf, torch.Tensor)
                             else "cpu")
    return _unflatten_like(like, leaves)


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(s for s in (
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
