"""Round-granular checkpoints (port of ``repro/checkpoint/ckpt.py``), in the
JAX package's on-disk layout, so a checkpoint written by either package
restores into the other:

  <dir>/round_<n:08d>/shard_0.npz   leaf_0 ... leaf_{L-1}, numpy arrays
  <dir>/round_<n:08d>/manifest.json {"round", "n_leaves", "treedef", "extra"}

The leaves are numbered in JAX's flatten order: dict keys sorted, at every
level; tuples and lists in order; an empty tuple holds no leaf. The port's
state has the JAX package's names and layouts, so the same state gives the
same leaves. ``restore`` reads the leaves into the structure of a state of
the same run and puts them on that state's devices.

numpy has no bfloat16: a bf16 leaf is written as its bits (``uint16``) and
read back into the bf16 leaf it replaces, so an LM state on the card saves
and restores bitwise. (The JAX package writes bf16 through ``ml_dtypes``;
restores across the packages are held for f32 states.)

A save copies the leaves to host memory and writes them into a temporary
directory that is renamed into place, so a reader never sees half a
checkpoint. The newest ``KEEP_LAST`` rounds are kept.
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Optional

import numpy as np
import torch

KEEP_LAST = 3   # rounds kept on disk; older ones are deleted


def _leaves(tree, path=""):
    """(path, tensor) pairs of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order (``jax.tree.leaves``)."""
    return [t for _, t in _leaves(tree)]


def rebuild(tree, it):
    """``tree``'s structure with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, it) for v in tree)
    if tree is None:
        return None
    return next(it)


def _to_host(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir, round_idx: int, state, extra: Optional[dict] = None):
    """Write ``state`` as round ``round_idx``; returns its directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    path = ckpt_dir / f"round_{round_idx:08d}"
    tmp = ckpt_dir / f".tmp_round_{round_idx:08d}"
    named = list(_leaves(state))
    host = [_to_host(t) for _, t in named]
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": h for i, h in enumerate(host)})
    manifest = {"round": round_idx, "n_leaves": len(host),
                "treedef": "repro_torch: " + " ".join(p for p, _ in named),
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)                                           # atomic publish
    _gc(ckpt_dir)
    return path


def _gc(ckpt_dir: pathlib.Path):
    rounds = sorted(p for p in ckpt_dir.glob("round_*") if p.is_dir())
    for p in rounds[:-KEEP_LAST]:
        shutil.rmtree(p, ignore_errors=True)


def latest_round(ckpt_dir) -> Optional[int]:
    """The newest saved round in ``ckpt_dir``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    rounds = sorted(ckpt_dir.glob("round_*"))
    if not rounds:
        return None
    return int(rounds[-1].name.split("_")[1])


def read(ckpt_dir, round_idx: int):
    """Round ``round_idx``'s leaves as host arrays, in flatten order, and
    its manifest's extras."""
    path = pathlib.Path(ckpt_dir) / f"round_{round_idx:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "shard_0.npz") as z:
        host = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    return host, manifest["extra"]


def as_leaf(h, like: torch.Tensor) -> torch.Tensor:
    """A saved host array as a CPU tensor of ``like``'s dtype where the
    file holds it (bf16 from its ``uint16`` bits)."""
    bits = like.dtype == torch.bfloat16 and h.dtype == np.uint16
    got = torch.from_numpy(np.array(h.view(np.int16) if bits else h, order="C"))
    return got.view(torch.bfloat16) if bits else got


def restore(ckpt_dir, round_idx: int, like_state):
    """Load round ``round_idx`` into the structure of ``like_state``, each
    leaf on the device of the leaf it replaces. Returns (state, extra).
    Raises if the leaves' count, shapes or dtypes differ from the state's."""
    host, extra = read(ckpt_dir, round_idx)
    like = list(_leaves(like_state))
    if len(like) != len(host):
        raise ValueError(f"checkpoint has {len(host)} leaves, the state needs {len(like)}")
    out = []
    for (name, t), h in zip(like, host):
        got = as_leaf(h, t)
        if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
            raise ValueError(f"checkpoint leaf {name}: {tuple(got.shape)} {got.dtype}, "
                             f"the state has {tuple(t.shape)} {t.dtype}")
        out.append(got.to(t.device))
    return rebuild(like_state, iter(out)), extra
