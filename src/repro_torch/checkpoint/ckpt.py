"""Checkpointing with atomic commit, an async writer and step recovery.

Counterpart of repro/checkpoint/ckpt.py, on the same format, so either
package restores what the other wrote:

  <dir>/step_<N>/
      manifest.json   {"step": N, "leaves": [{"file", "shape", "dtype"}, ...]}
      arr_<i>.npy     one file per leaf
      COMMITTED       empty marker, written LAST (atomic commit)

Leaves come in `jax.tree.flatten`'s order: dict keys sorted, NamedTuple
(and tuple, list) items in order, None no leaf at all. A bf16 leaf, which
numpy has no type for, is written as the JAX package writes one (an npy
header of '<V2' with the 2-byte patterns, "bfloat16" in the manifest) and
read back as those bit patterns.

  * a crash mid-write leaves no COMMITTED marker: restore() ignores it;
  * orphaned uncommitted step directories are swept on the next save();
  * latest_step() returns the newest committed step; `keep` bounds how
    many stay;
  * the async Writer copies the leaves to host memory at once and writes
    the files on a thread; wait() joins it;
  * restore() validates every leaf file's npy header (shape, dtype, size)
    against the manifest and the target tree BEFORE loading anything, and
    raises CorruptCheckpoint naming the leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


class CorruptCheckpoint(RuntimeError):
    """A committed checkpoint failed validation (truncated or corrupt leaf
    file, or a manifest at odds with the files or the target tree). The
    message names the leaf, so the caller can fall back to an older
    step."""


_BF16_DESCR = "<V2"


def flatten(tree) -> tuple[list, Any]:
    """(leaves, structure) in jax.tree.flatten's order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (tuple, list)):
        parts = [flatten(t) for t in tree]
        return ([l for ls, _ in parts for l in ls],
                ("seq", type(tree), [s for _, s in parts]))
    if tree is None:
        return [], ("none",)
    return [tree], ("leaf",)


def unflatten(struct, leaves: list):
    """The tree of `struct` with `leaves` in flatten's order."""
    it = iter(leaves)

    def build(s):
        if s[0] == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if s[0] == "seq":
            items = [build(c) for c in s[2]]
            return s[1](*items) if hasattr(s[1], "_fields") else s[1](items)
        if s[0] == "none":
            return None
        return next(it)
    return build(struct)


def _to_host(x):
    """A leaf -> (numpy array, manifest dtype); bf16 as its int16 bits."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any, *, async_: bool = False,
         keep: int = 3) -> "Writer | None":
    """Checkpoint `tree` at `step`. Returns a Writer handle if async_."""
    leaves, _ = flatten(tree)
    w = Writer(directory, step, [_to_host(x) for x in leaves], keep)
    if async_:
        w.start()
        return w
    w.run()
    return None


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        np.ascontiguousarray(arr).tofile(f)


class Writer:
    def __init__(self, directory, step, host_leaves, keep):
        self.dir = directory
        self.step = step
        self.leaves = host_leaves
        self.keep = keep
        self._t = None

    def start(self):
        self._t = threading.Thread(target=self.run, daemon=True)
        self._t.start()

    def wait(self):
        if self._t is not None:
            self._t.join()

    def run(self):
        self._sweep_orphans()
        d = os.path.join(self.dir, f"step_{self.step:08d}")
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": self.step, "leaves": []}
        for i, (arr, dtype) in enumerate(self.leaves):
            _write_leaf(os.path.join(tmp, f"arr_{i}.npy"), arr, dtype)
            manifest["leaves"].append(
                {"file": f"arr_{i}.npy", "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w"):
            pass
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        self._gc()

    def _gc(self):
        for s in committed_steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _sweep_orphans(self):
        """Remove crash leftovers before writing: stale `step_*.tmp`
        directories (other than this save's own) and uncommitted `step_*`
        directories."""
        own_tmp = f"step_{self.step:08d}.tmp"
        for name in os.listdir(self.dir) if os.path.isdir(self.dir) else []:
            if not name.startswith("step_") or name == own_tmp:
                continue
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp") or \
                    not os.path.exists(os.path.join(path, "COMMITTED")):
                shutil.rmtree(path, ignore_errors=True)


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMITTED")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _header_dtype(dtype: np.dtype, manifest_dtype: str) -> str:
    """The dtype a header stands for: a 2-byte void one is a bf16 leaf
    where the manifest says so."""
    if manifest_dtype == "bfloat16" and dtype.kind == "V" \
            and dtype.itemsize == 2:
        return "bfloat16"
    return str(dtype)


def _validate_leaf(path: str, i: int, meta: dict, ref) -> None:
    """Pre-load validation of one leaf file: npy header parseable, header
    shape and dtype match the manifest, shape matches the target tree, and
    the file holds the bytes its header promises. Raises
    CorruptCheckpoint naming the leaf."""
    name = meta["file"]
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, _, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"unsupported npy format version {version}")
            header_end = f.tell()
    except FileNotFoundError:
        raise CorruptCheckpoint(
            f"leaf {i} ({name}): file missing from committed "
            "checkpoint") from None
    except Exception as e:
        raise CorruptCheckpoint(
            f"leaf {i} ({name}): unreadable npy header ({e})") from e
    hdt = _header_dtype(dtype, meta["dtype"])
    if list(shape) != list(meta["shape"]) or hdt != meta["dtype"]:
        raise CorruptCheckpoint(
            f"leaf {i} ({name}): file header {shape}/{dtype} != manifest "
            f"{tuple(meta['shape'])}/{meta['dtype']}")
    ref_shape = tuple(ref.shape) if torch.is_tensor(ref) \
        else np.shape(ref)
    if tuple(shape) != ref_shape:
        raise CorruptCheckpoint(
            f"leaf {i} ({name}): ckpt shape {tuple(shape)} != model "
            f"{ref_shape}")
    need = header_end + int(dtype.itemsize) * int(np.prod(shape,
                                                           dtype=np.int64))
    have = os.path.getsize(path)
    if have < need:
        raise CorruptCheckpoint(
            f"leaf {i} ({name}): truncated — {have} bytes on disk, header "
            f"promises {need}")


def _load_leaf(path: str, meta: dict, ref, device) -> torch.Tensor:
    arr = np.load(path)
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if torch.is_tensor(ref):
        return t.to(device=device or ref.device, dtype=ref.dtype)
    return t.to(device=device or "cpu")


def restore(directory: str, step: int, like: Any, *, device=None) -> Any:
    """Restore into the structure of `like`: each leaf a tensor with the
    dtype of `like`'s leaf, on `device` (default: that leaf's device).
    Every leaf file is header-validated against the manifest and `like`
    up front; corruption raises CorruptCheckpoint naming the leaf."""
    d = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    leaves, struct = flatten(like)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if len(manifest["leaves"]) != len(leaves):
        raise CorruptCheckpoint(
            f"manifest holds {len(manifest['leaves'])} leaves, target tree "
            f"has {len(leaves)}")
    for i, ref in enumerate(leaves):
        meta = manifest["leaves"][i]
        if meta is not None:
            _validate_leaf(os.path.join(d, meta["file"]), i, meta, ref)
    out = []
    for i, ref in enumerate(leaves):
        meta = manifest["leaves"][i]
        if meta is None:
            out.append(None)
            continue
        try:
            out.append(_load_leaf(os.path.join(d, meta["file"]), meta, ref,
                                  device))
        except Exception as e:
            raise CorruptCheckpoint(
                f"leaf {i} ({meta['file']}): load failed after header "
                f"validation ({e})") from e
    return unflatten(struct, out)
