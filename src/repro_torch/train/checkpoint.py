"""Fault-tolerant checkpointing, the port of ``repro.train.checkpoint``:
atomic, async, with retention, in the reference's format.

* **Atomic**: state is written to ``step_XXXXXXXX.tmp`` and then
  ``os.rename``-d into place, so a crash mid-save never corrupts the
  latest checkpoint.
* **Async**: ``AsyncCheckpointer.save`` copies the state to host memory
  on the caller's thread (a copy, so the in-place train step cannot
  change it), then writes it on a background thread.
* **Retention**: the newest ``keep`` checkpoints stay, older ones go.

Format, as the reference writes it: ``<dir>/step_<N>/manifest.json``
(leaf names, shapes, dtypes, the tree's ``PyTreeDef`` string) and
``arrays.npz`` (member ``a<i>.npy`` for the i-th leaf). Leaves are named
by their path in the reference's tree (``params/table``,
``params/cross/0/w``, ``params/mlp/ws/1``, ``opt/m/table``, ``step``),
visited in its order (dict keys sorted, list items in order): a module
is its ``named_parameters()``, and every dotted name splits into that
path. So each package restores the other's checkpoints.

bfloat16 leaves are stored as the reference's numpy writes an ml_dtypes
bfloat16 array: the raw 2-byte words under the ``.npy`` descriptor
``<V2``, ``"dtype": "bfloat16"`` in the manifest. ``restore`` reads them
back by the manifest's dtype. (The reference's own ``restore`` cannot:
its ``astype`` from ``V2`` to bfloat16 raises.)

``restore`` writes into the tensors of ``like`` in place and returns
it; the reference's ``sharding_tree`` has no one-device counterpart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Optional

import numpy as np
import torch
from torch import nn

_SEP = "/"
_BF16 = np.dtype("V2")     # the host form of a bfloat16 leaf


def _tree(state):
    """``state`` as the reference's nested tree: dicts (every dotted key
    split into levels, a module by its parameter names) and lists (a
    level whose keys are 0..n-1), with tensors or arrays at the
    leaves."""
    if isinstance(state, nn.Module):
        state = dict(state.named_parameters())
    if isinstance(state, (list, tuple)):
        state = dict(enumerate(state))
    if not isinstance(state, dict):
        return state
    out: dict = {}
    for key, val in state.items():
        *head, last = str(key).split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = _tree(val)
    return _listify(out)


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """(path name, leaf) in the reference's order: sorted dict keys,
    list items in order."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: kv[0])
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, val in items:
        out.extend(_flatten_with_paths(
            val, f"{prefix}{_SEP}{key}" if prefix else key))
    return out


def _treedef(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists and leaves."""
    def node(t):
        if isinstance(t, dict):
            items = sorted(t.items(), key=lambda kv: kv[0])
            return "{" + ", ".join(f"{k!r}: {node(v)}"
                                   for k, v in items) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf: a bfloat16 tensor becomes its 2-byte
    words as ``V2``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16)
        return x.numpy()
    return np.array(x)


def _host_tree(state):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return _to_host(t)
    return walk(_tree(state))


def save(directory: str, state, step: int, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    return _write(directory, _host_tree(state), step, keep)


class AsyncCheckpointer:
    """Device->host snapshot on the caller thread, disk I/O on a worker.

    ``wait()`` joins the in-flight save (call before shutdown / before
    restoring). A new save waits for the previous one (single-flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: list[BaseException] = []

    def save(self, state, step: int) -> None:
        self.wait()
        host_state = _host_tree(state)   # snapshot NOW (consistent)

        def work():
            try:
                _write(self.directory, host_state, step, self.keep)
            except BaseException as e:   # noqa: BLE001 — re-raised in wait
                self._err.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            raise self._err.pop(0)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``, but a ``V2`` (bfloat16) array gets
    the descriptor ``<V2`` that numpy writes for an ml_dtypes bfloat16
    array, so the members are byte-equal to the reference's."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zipf:
        for key, arr in arrays.items():
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype != _BF16:
                    np.lib.format.write_array(fid, arr)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
                fid.write(arr.tobytes())


def _write(directory: str, host_state, step: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": step, "leaves": [], "treedef": _treedef(host_state)}
    for i, (name, arr) in enumerate(_flatten_with_paths(host_state)):
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"].append(
            {"name": name, "key": key, "shape": list(arr.shape),
             "dtype": "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)})
    _savez(os.path.join(tmp, "arrays.npz"), arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)              # atomicity point
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def restore(directory: str, like, step: Optional[int] = None):
    """Restore checkpoint ``step`` (the newest when None) into the
    tensors of ``like`` (a state of the same tree), in place, each cast
    to its tensor's dtype; returns ``like``. Raises ``KeyError`` for a
    leaf the checkpoint lacks and ``ValueError`` for a shape that
    differs."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {l["name"]: l for l in manifest["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, leaf in _flatten_with_paths(_tree(like)):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            entry = by_name[name]
            arr = data[entry["key"]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {name!r}: checkpoint shape {arr.shape} != "
                    f"model shape {tuple(leaf.shape)}")
            if entry["dtype"] == "bfloat16":
                src = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                src = torch.from_numpy(np.array(arr))
            with torch.no_grad():
                leaf.copy_(src.to(leaf.dtype))
    return like
