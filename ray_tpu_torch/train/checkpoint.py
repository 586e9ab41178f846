"""Directory checkpoints and top-k retention: the port of
``ray_tpu/train/checkpoint.py``.

- :meth:`Checkpoint.from_state` / :meth:`Checkpoint.load_state` write and
  read the reference's format: ``state.npz`` with ``leaf_{i}`` in
  ``jax.tree_util``'s flatten order, and ``meta.json``. The port's flat
  parameter dict is written in the layout of the reference's params tree
  (:data:`ray_tpu_torch.models.gpt.PARAM_PATHS`), so a params checkpoint
  written by either package loads in the other.
- :meth:`Checkpoint.from_sharded_state` / :meth:`load_sharded_state`
  are ``torch.distributed.checkpoint`` (the reference uses orbax): each
  rank writes only its own shards, given their placements, and a load
  onto another mesh reshards on read. Sharded checkpoints do not cross
  packages (DCP and orbax differ).
- :class:`CheckpointManager` keeps the top k by a metric.

A checkpoint's path is a local directory or a storage URI
(``mock://…``, ``file://…``: :mod:`ray_tpu_torch.train.storage`); a URI
checkpoint downloads to a local cache on first :meth:`as_directory`, and
the manager's retention deletes through the URI's filesystem.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._private import tree as _tree


def _local(path: str) -> str:
    """A local path made absolute; a storage URI as it is."""
    from .storage import is_uri

    return path if is_uri(path) else os.path.abspath(path)


def _delete(path: str) -> None:
    from .storage import get_filesystem, is_uri

    if is_uri(path):
        get_filesystem(path)[0].rmtree(path)
    else:
        shutil.rmtree(path, ignore_errors=True)


def _is_port_params(state) -> bool:
    from ..models.gpt import PARAM_PATHS

    return isinstance(state, dict) and "embed" in state and \
        set(state) <= set(PARAM_PATHS) and \
        all(isinstance(v, torch.Tensor) for v in state.values())


def _as_tree(state):
    """``state`` as the reference would flatten it (the port's params in
    the reference's layout)."""
    if _is_port_params(state):
        from ..models.gpt import params_tree

        return params_tree(state)
    return state


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:     # no numpy bf16: exact in f32
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Checkpoint:
    """A directory of files; the unit of save/restore. ``path`` may be a
    storage URI (``checkpoint.py:25``)."""

    def __init__(self, path: str):
        self.path = _local(path)
        self._local_cache: Optional[str] = None

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        """A local directory holding the checkpoint: the path itself, or
        a URI checkpoint's download (once)."""
        from .storage import get_filesystem, is_uri

        if not is_uri(self.path):
            return self.path
        if self._local_cache is None or not os.path.exists(
                self._local_cache):
            fs, _ = get_filesystem(self.path)
            cache = tempfile.mkdtemp(prefix="ckpt_dl_")
            self._local_cache = fs.download_dir(self.path, cache)
        return self._local_cache

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def to_dict(self) -> dict:
        return {"path": self.path}

    # ---- whole-state payload (the reference's npz format) ---------------
    @classmethod
    def from_state(cls, state: Any, base_dir: Optional[str] = None,
                   name: str = "state") -> "Checkpoint":
        """Save a tree of tensors/arrays (``checkpoint.py:60``): each leaf
        whole, bf16 stored as f32 (exact)."""
        tree = _as_tree(state)
        leaves = _tree.leaves(tree)
        d = tempfile.mkdtemp(prefix="ckpt_", dir=base_dir)
        np.savez(os.path.join(d, f"{name}.npz"),
                 **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"n_leaves": len(leaves),
                       "treedef": _treedef_repr(tree), "name": name}, f)
        return cls(d)

    def load_state(self, like: Any = None, name: str = "state") -> Any:
        """The saved leaves (numpy, flatten order) or, given ``like``, a
        tree of its structure whose tensor leaves take the dtype and
        device of ``like``'s (``checkpoint.py:82``)."""
        with np.load(os.path.join(self.as_directory(),
                                  f"{name}.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        if like is None:
            return leaves
        port = _is_port_params(like)
        ref = _tree.leaves(_as_tree(like))
        if len(ref) != len(leaves):
            raise ValueError(f"{self.path}: {len(leaves)} leaves saved, the "
                             f"structure given has {len(ref)}")
        out = [torch.from_numpy(np.ascontiguousarray(h)).to(
            dtype=r.dtype, device=r.device) if isinstance(r, torch.Tensor)
            else h for h, r in zip(leaves, ref)]
        tree = _tree.unflatten(_as_tree(like), out)
        if port:
            from ..models.gpt import params_flat

            return {k: params_flat(tree)[k] for k in like}
        return tree

    # ---- sharded payload (torch.distributed.checkpoint) -----------------
    @classmethod
    def from_sharded_state(cls, state: Any, base_dir: Optional[str] = None,
                           name: str = "sharded", path: Optional[str] = None,
                           *, placements: Any = None) -> "Checkpoint":
        """Save a tree of this rank's shards (``checkpoint.py:103``):
        ``placements`` (a tree of the same structure, e.g.
        ``make_train_step``'s ``state_placements["params"]``) says where
        each shard lies; without it every leaf is whole, and the same on
        every rank of the process group. Every rank of the mesh calls
        this with the same ``path``; each writes only its own shards.
        Inside a train session whose storage is a directory no ``path``
        is needed (with URI storage the save lands in a temporary
        directory that ``report`` uploads); a single process may omit
        it."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        if path is None:
            from . import session as _session
            from .storage import is_uri

            s = _session.get_session()
            if s is not None and s.storage_dir \
                    and not is_uri(s.storage_dir):
                path = s.next_sharded_checkpoint_path()
        if path is not None:
            d = _local(path)
            os.makedirs(d, exist_ok=True)
        else:
            if dist.is_initialized() and dist.get_world_size() > 1:
                raise ValueError(
                    "multi-process sharded save outside a Train session "
                    "needs an explicit `path` every process agrees on "
                    "(mkdtemp would scatter shards across directories)")
            d = tempfile.mkdtemp(prefix="ckpt_", dir=base_dir)
        sd, pg = _dcp_state(state, placements)
        dcp.save(sd, checkpoint_id=os.path.join(d, name), process_group=pg,
                 no_dist=pg is None)
        return cls(d)

    def load_sharded_state(self, like: Any, name: str = "sharded", *,
                           placements: Any = None) -> Any:
        """This rank's shards of a sharded checkpoint: ``like`` (local
        tensors, or anything with ``shape``/``dtype``/``device``) fixes
        structure, dtypes and devices, ``placements`` the TARGET layout
        (default: every leaf whole); a save on another mesh is resharded
        on read (``checkpoint.py:157``). Every rank of the target mesh
        calls it."""
        import torch.distributed.checkpoint as dcp

        sd, pg = _dcp_state(like, placements, empty=True)
        dcp.load(sd, checkpoint_id=os.path.join(self.as_directory(), name),
                 process_group=pg, no_dist=pg is None)
        return _tree.unflatten(like, [
            (v.to_local() if hasattr(v, "to_local") else v).to(
                dtype=r.dtype, device=r.device)
            for v, r in zip(sd.values(), _tree.leaves(like))])


def _dcp_state(state, placements, empty: bool = False
               ) -> Tuple[Dict[str, Any], Any]:
    """DCP's flat state dict for ``state``'s leaves: a CPU ``DTensor``
    over the placement's mesh for each leaf of a multi-rank mesh (its
    global shape and where this rank's shard lies), the plain CPU tensor
    otherwise; and the process group of the mesh's ranks (``None`` for
    one rank, which saves and loads alone). Without ``placements`` every
    leaf is whole on every rank of the process group (DCP writes each
    once)."""
    import torch.distributed as dist

    pairs = _tree.leaves_with_paths(state)
    pg = None
    if placements is None:
        places = [None] * len(pairs)
        if dist.is_initialized() and dist.get_world_size() > 1:
            pg = dist.group.WORLD
    else:
        places = _tree.leaves(placements)
    if len(places) != len(pairs):
        raise ValueError("placements do not match the state's leaves")
    sd: Dict[str, Any] = {}
    for (path, leaf), pl in zip(pairs, places):
        local = torch.empty(tuple(leaf.shape), dtype=leaf.dtype) if empty \
            else leaf.detach().cpu()
        mesh = None if pl is None else pl.mesh
        if mesh is not None and mesh.size > 1:
            from torch.distributed.tensor import DTensor

            full = list(local.shape)
            for d, axes in pl._dims():
                full[d] *= mesh.size_of(axes)
            local = DTensor.from_local(
                local, _device_mesh(mesh), _dtensor_placements(pl),
                run_check=False, shape=torch.Size(full),
                stride=torch.empty(full, device="meta").stride())
            pg = mesh.group(mesh.axis_names).pg
        sd[_tree.path_str(path)] = local
    return sd, pg


def _device_mesh(mesh):
    """The DTensor view of a port mesh: metadata only (no process groups
    of its own), on the CPU where the shards are staged."""
    from torch.distributed.device_mesh import DeviceMesh

    dims = [mesh.shape[a] for a in mesh.axis_names]
    return DeviceMesh("cpu", torch.tensor(mesh.ranks).reshape(dims),
                      mesh_dim_names=mesh.axis_names, _init_backend=False)


def _dtensor_placements(pl):
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for d, axes in pl._dims():
        pl._check_order(axes)
        for a in axes:
            by_axis[a] = Shard(d)
    return [by_axis.get(a, Replicate()) for a in pl.mesh.axis_names]


def _treedef_repr(tree) -> str:
    """A readable record of the saved structure (paths in leaf order)."""
    return ", ".join(_tree.path_str(p) for p, _ in
                     _tree.leaves_with_paths(tree))


class _TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    """Top-k retention by score attribute (``checkpoint.py:178``)."""

    def __init__(self, storage_dir: str,
                 num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        from .storage import get_filesystem, is_uri

        self.storage_dir = _local(storage_dir)
        if is_uri(storage_dir):
            get_filesystem(storage_dir)[0].makedirs(storage_dir)
        else:
            os.makedirs(self.storage_dir, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: List[_TrackedCheckpoint] = []
        self._counter = 0

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        """Adopt the checkpoint in place and apply retention (never the
        most recent one is deleted)."""
        tracked = _TrackedCheckpoint(checkpoint, metrics, self._counter)
        self._counter += 1
        self._tracked.append(tracked)
        self._apply_retention()
        return tracked.checkpoint

    def _score(self, t: _TrackedCheckpoint) -> Tuple:
        """Higher tuple = better; a missing metric always ranks worst."""
        if not self.score_attribute:
            return (t.index,)
        v = t.metrics.get(self.score_attribute)
        if v is None:
            return (float("-inf"), t.index)
        v = float(v)
        return (v if self.score_order == "max" else -v, t.index)

    def _apply_retention(self):
        if self.num_to_keep is None:
            return
        while len(self._tracked) > self.num_to_keep:
            worst = min(self._tracked, key=self._score)
            # never delete the most recent (resume anchor)
            if worst is self._tracked[-1]:
                worst = min(self._tracked[:-1], key=self._score)
            self._tracked.remove(worst)
            _delete(worst.checkpoint.path)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=self._score).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._tracked[-1].checkpoint if self._tracked else None

    @property
    def checkpoints(self) -> List[Checkpoint]:
        return [t.checkpoint for t in self._tracked]
