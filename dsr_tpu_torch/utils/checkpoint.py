"""Checkpoint/resume: sharded checkpoints of model parameters, beamformer
state and trainer accumulators, plus the decode-progress high-water mark
that makes recovery = re-decode the lost batch.

Counterpart of `dsr_tpu/utils/checkpoint.py`'s per-shard format, the same
on disk, so either package restores the other's checkpoints:

- `index.<process>.json` maps each leaf's name to `complex` and `parts`:
  per part suffix (`""`, or `.re` / `.im` for a complex leaf) its global
  `shape`, its `dtype` (numpy's name, e.g. `float32`) and its `shards`, a
  list of `{file, bounds}` with one `[start, stop]` per dimension;
- each block is `leaf<i><suffix>.p<process>.s<shard>.npy`.

Leaf names are spelled as `jax.tree_util.keystr` spells them: `['key']`
for a dict entry (dicts flattened in sorted key order, as JAX does),
`[i]` for a list or tuple item, `.field` for a NamedTuple field.  An
`nn.Module` is checkpointed through its `state_dict()`, each entry
spelled as an attribute, so the port's `GmmParams` names its leaves
`.means`, `.variances`, `.logweights` as the JAX `GmmParams` NamedTuple
does.

The process index is the rank of the default process group, or 0 without
one.  With a mesh and a layout (a spec of `parallel/sharding.py`, the same
for every leaf), each leaf holds this rank's block of a global array, as
`local_block` cuts it with `torch.tensor_split`: a rank writes only its
block, and restores only the block its coordinate names, onto the template
leaf's device and dtype.  Without them every leaf is whole.  The port has no orbax: `save` writes this format, and `restore`
reads it or the legacy `ckpt.npz`.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dsr_tpu_torch.parallel.mesh import axis_size, mesh_device
from dsr_tpu_torch.parallel.sharding import _named, all_gather_dim

_INDEX = "index.{}.json"


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool, complex))


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flattening order, named as keystr does."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(f"{prefix}.{k}", v) for k, v in tree.state_dict().items()]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _flatten(x, f"{prefix}[{i}]")]
    raise TypeError(f"checkpoint: cannot flatten a {type(tree).__name__} at {prefix or 'the root'}")


def _unflatten(template: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """`template`'s structure with each leaf replaced by leaves[name]; a
    Module gets the restored entries loaded into it (and is returned)."""
    if template is None:
        return None
    if _is_leaf(template):
        return leaves[prefix]
    if isinstance(template, nn.Module):
        template.load_state_dict({k: leaves[f"{prefix}.{k}"] for k in template.state_dict()})
        return template
    if isinstance(template, dict):
        return type(template)((k, _unflatten(v, leaves, f"{prefix}[{k!r}]"))
                              for k, v in template.items())
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves, f"{prefix}.{f}")
                                for f in template._fields))
    return type(template)(_unflatten(x, leaves, f"{prefix}[{i}]") for i, x in enumerate(template))


def _split_bounds(length: int, n: int, i: int) -> list[int]:
    """[start, stop] of part i of `length` split in n by `torch.tensor_split`."""
    q, r = divmod(length, n)
    start = i * q + min(i, r)
    return [start, start + q + (1 if i < r else 0)]


def _block_bounds(block: torch.Tensor, mesh, spec) -> tuple[list[int], list[list[int]]]:
    """(global shape, this block's bounds): each named dimension's block
    lengths are exchanged over its axis (a collective over the mesh)."""
    shape = list(block.shape)
    bounds = [[0, s] for s in shape]
    for d, axis in _named(spec, block.dim()):
        size = torch.tensor([block.shape[d]], device=mesh_device(mesh))
        sizes = all_gather_dim(size, mesh.get_group(axis), 0).tolist()
        c = mesh.get_local_rank(axis)
        shape[d] = sum(sizes)
        bounds[d] = [sum(sizes[:c]), sum(sizes[:c + 1])]
    return shape, bounds


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().resolve_conj().cpu().numpy()


def save_sharded(path: str, tree: Any, mesh=None, layout=None) -> None:
    """Write this rank's block of each leaf as .npy, plus its index file.

    Every rank calls this (with a mesh, the block lengths are exchanged);
    each writes only its own blocks and its own index file
    (process-local I/O, no gather beyond the lengths, a shared filesystem).
    Without a mesh each leaf is written whole.
    """
    p = pathlib.Path(os.path.abspath(path))
    p.mkdir(parents=True, exist_ok=True)
    proc = process_index()
    index: dict[str, dict] = {}
    for li, (name, leaf) in enumerate(_flatten(tree)):
        block = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        spec = layout if mesh is not None and layout else ()
        shape, bounds = _block_bounds(block, mesh, spec) if spec else (list(block.shape), [
            [0, s] for s in block.shape])
        cplx = block.is_complex()
        parts = {".re": block.real, ".im": block.imag} if cplx else {"": block}
        entry = {"complex": cplx, "parts": {}}
        for suffix, part in parts.items():
            data = _host(part)
            fn = f"leaf{li}{suffix}.p{proc}.s0.npy"
            np.save(p / fn, data)
            entry["parts"][suffix] = {"shape": shape, "dtype": str(data.dtype),
                                      "shards": [{"file": fn, "bounds": bounds}]}
        index[name] = entry
    with open(p / _INDEX.format(proc), "w") as f:
        json.dump(index, f)


def _read_index(p: pathlib.Path) -> dict[str, dict]:
    """The per-process index files merged leaf by leaf: each process records
    only its own shards, so the shard lists concatenate."""
    index: dict[str, dict] = {}
    for f in sorted(p.glob(_INDEX.format("*"))):
        for name, entry in json.loads(f.read_text()).items():
            if name not in index:
                index[name] = entry
                continue
            for suffix, part in entry["parts"].items():
                have = index[name]["parts"][suffix]
                if part["shape"] != have["shape"] or part["dtype"] != have["dtype"]:
                    raise ValueError(f"{name}{suffix}: inconsistent shape/dtype across "
                                     "process index files")
                have["shards"].extend(part["shards"])
    return index


def restore_sharded(path: str, template: Any, mesh=None, layout=None) -> Any:
    """Restore into `template`'s structure: each leaf becomes this rank's
    block (its bounds from the saved global shape and the rank's
    coordinate under `layout`), read from the file saved with
    exactly those bounds and placed on the template leaf's device and
    dtype (a numpy template leaf gives a numpy array).  Raises ValueError
    naming the bounds when no saved shard has them."""
    p = pathlib.Path(os.path.abspath(path))
    index = _read_index(p)
    out = {}
    for name, leaf in _flatten(template):
        if name not in index:
            raise KeyError(f"checkpoint {p} has no leaf {name}")
        entry = index[name]
        part0 = entry["parts"][".re" if entry["complex"] else ""]
        shape = part0["shape"]
        spec = layout if mesh is not None and layout else ()
        bounds = [[0, s] for s in shape]
        for d, axis in _named(spec, len(shape)):
            bounds[d] = _split_bounds(shape[d], axis_size(mesh, axis), mesh.get_local_rank(axis))
        key = tuple(tuple(b) for b in bounds)

        def load(suffix):
            files = {tuple(tuple(b) for b in s["bounds"]): s["file"]
                     for s in entry["parts"][suffix]["shards"]}
            if key not in files:
                raise ValueError(f"{name}{suffix}: no saved shard with bounds {key} "
                                 "(restoring onto a different sharding layout?)")
            return torch.from_numpy(np.load(p / files[key]))

        block = torch.complex(load(".re"), load(".im")) if entry["complex"] else load("")
        if isinstance(leaf, torch.Tensor):
            out[name] = block.to(device=leaf.device, dtype=leaf.dtype)
        else:
            out[name] = block.numpy().astype(np.asarray(leaf).dtype)
    return _unflatten(template, out)


def save(path: str, tree: Any, mesh=None, layout=None) -> None:
    """Save a checkpoint (the per-shard format; the port has no orbax)."""
    save_sharded(path, tree, mesh, layout)


def restore(path: str, template: Any, mesh=None, layout=None) -> Any:
    """Restore a checkpoint into `template`'s structure: the per-shard
    format, or a legacy `ckpt.npz` (its arrays in the template's leaf
    order).  An orbax checkpoint of the JAX package's `save` is not
    readable here."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, _INDEX.format(process_index()))):
        return restore_sharded(path, template, mesh, layout)
    legacy = os.path.join(path, "ckpt.npz")
    if os.path.exists(legacy):
        with np.load(legacy) as z:
            arrays = [z[k] for k in z.files]
        flat = _flatten(template)
        if len(arrays) != len(flat):
            raise ValueError(f"{legacy}: {len(arrays)} arrays for {len(flat)} template leaves")
        return _unflatten(template, {
            name: (torch.as_tensor(a).to(device=leaf.device, dtype=leaf.dtype)
                   if isinstance(leaf, torch.Tensor) else a)
            for (name, leaf), a in zip(flat, arrays)})
    raise FileNotFoundError(f"no checkpoint of this format at {path} (an orbax checkpoint "
                            "is not readable by the port)")


class DecodeProgress:
    """Utterance-id high-water mark for restartable batch decoding."""

    def __init__(self, path: str):
        self.path = path
        self.done: set[str] = set()
        if os.path.exists(path):
            with open(path) as f:
                self.done = set(json.load(f))

    def is_done(self, utt_id: str) -> bool:
        return utt_id in self.done

    def mark(self, utt_id: str) -> None:
        self.done.add(utt_id)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sorted(self.done), f)
        os.replace(tmp, self.path)
