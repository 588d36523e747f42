"""Flat-npz checkpoints in the reference's on-disk format.  Port of
``repro/checkpoint/checkpoint.py``: a checkpoint written by either
package restores into the other.

* One npz entry per leaf, keyed by its path joined with ``/`` — for a
  Parle state ``x/blocks/attn/wq``, ..., ``step``, ``scopes/gamma``,
  ``scopes/rho``, and under a compressed / overlapped sync the residual
  ``e/...`` and the in-flight consensus ``c/...`` (``ParleState.tree()``
  gives the port's state in the reference's tree form, each leaf a view
  into the flat buffers).
* bf16 leaves are stored as their uint16 bit patterns (npz has no bf16).
* A JSON sidecar ``<file>.npz.json`` holds the step, the sorted keys,
  the npz's sha1 digest, ``meta`` (with the writing algorithm's ``algo``
  stamp) and the obs counter stamp.
* Every write goes tmp file -> flush -> fsync -> atomic ``os.replace``,
  npz before sidecar, so a sidecar that names a digest always describes
  a complete npz.  :func:`resolve` turns a directory (or a corrupt file)
  into the newest checkpoint that verifies.

:func:`restore` writes the checkpoint's values INTO the leaves of the
``like`` state (its device buffers) and returns it.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves_with_paths

SEP = "/"


class CheckpointCorruptError(ValueError):
    """A checkpoint failed its integrity check (torn npz, digest
    mismatch, or an unreadable sidecar)."""


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _as_tree(tree):
    return tree.tree() if hasattr(tree, "tree") else tree


def _flat_leaves(tree) -> dict:
    """{path key: leaf} of a nested dict (or of a state's ``tree()``)."""
    return {SEP.join(str(k) for k in path): leaf
            for path, leaf in tree_leaves_with_paths(_as_tree(tree))}


def to_numpy(leaf) -> np.ndarray:
    """A leaf as numpy, bf16 as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _file_digest(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save(path: str, tree: Any, step: int = 0, meta: dict | None = None,
         algo: str | None = None, metrics: list | None = None):
    """``algo`` stamps the writing algorithm's registry name into the
    sidecar; :func:`restore` validates it.  ``metrics``: a cumulative
    counter stamp (``Registry.counter_stamp()``), read back with
    :func:`saved_metrics`."""
    path = _npz(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: to_numpy(v) for k, v in _flat_leaves(tree).items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    digest = _file_digest(tmp)
    os.replace(tmp, path)
    meta = dict(meta or {})
    if algo is not None:
        meta["algo"] = algo
    sidecar = {"step": int(step), "keys": sorted(flat.keys()),
               "digest": digest, "meta": meta}
    if metrics:
        sidecar["metrics"] = metrics
    sc_tmp = f"{path}.json.tmp.{os.getpid()}"
    with open(sc_tmp, "w") as f:
        json.dump(sidecar, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(sc_tmp, path + ".json")


def _sidecar(path: str) -> dict | None:
    """The parsed sidecar, None when absent, raises
    :class:`CheckpointCorruptError` when unreadable."""
    try:
        with open(_npz(path) + ".json") as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except ValueError as e:
        raise CheckpointCorruptError(
            f"checkpoint sidecar {_npz(path)}.json is unreadable: {e}") \
            from e


def verify(path: str) -> None:
    """Integrity-check one checkpoint, raising
    :class:`CheckpointCorruptError` on failure: the npz is re-hashed
    against the sidecar's digest, or (digest-less) its header parsed."""
    path = _npz(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    want = (_sidecar(path) or {}).get("digest")
    if want is not None:
        got = _file_digest(path)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint {path!r} content digest {got[:12]} does not "
                f"match sidecar digest {want[:12]} (torn or tampered "
                f"write)")
        return
    try:
        np.load(path).files
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is unreadable: {e}") from e


def latest_valid(dirpath: str, exclude=()) -> str | None:
    """The newest checkpoint in ``dirpath`` that passes :func:`verify`
    — ordered by sidecar step, then mtime.  None when nothing valid."""
    try:
        names = sorted(f for f in os.listdir(dirpath) if f.endswith(".npz"))
    except FileNotFoundError:
        return None
    ranked = []
    for name in names:
        p = os.path.join(dirpath, name)
        if p in exclude:
            continue
        try:
            sc = _sidecar(p)
        except CheckpointCorruptError:
            sc = None
        ranked.append(((sc or {}).get("step", -1), os.path.getmtime(p), p))
    for _, _, p in sorted(ranked, reverse=True):
        try:
            verify(p)
            return p
        except (CheckpointCorruptError, FileNotFoundError):
            continue
    return None


def resolve(path: str) -> str:
    """Turn a ``--resume`` argument into a verified checkpoint file: a
    directory resolves to its newest valid checkpoint, a valid file to
    itself, a CORRUPT file (with a warning) to the newest other valid
    checkpoint in its directory; a missing file raises
    FileNotFoundError."""
    if os.path.isdir(path):
        best = latest_valid(path)
        if best is None:
            raise CheckpointCorruptError(
                f"no valid checkpoint found in directory {path!r}")
        return best
    npz = _npz(path)
    if not os.path.exists(npz):
        raise FileNotFoundError(npz)
    try:
        verify(npz)
        return npz
    except CheckpointCorruptError as e:
        fallback = latest_valid(os.path.dirname(npz) or ".", exclude={npz})
        if fallback is None:
            raise
        warnings.warn(f"{e}; falling back to newest valid checkpoint "
                      f"{fallback!r}")
        return fallback


def saved_meta(path: str) -> dict:
    try:
        sc = _sidecar(path)
    except CheckpointCorruptError:
        return {}
    return (sc or {}).get("meta", {})


def saved_metrics(path: str) -> list:
    """The cumulative counter stamp written by :func:`save` (empty list
    for stamp-less or sidecar-less checkpoints)."""
    try:
        sc = _sidecar(path)
    except CheckpointCorruptError:
        return []
    return (sc or {}).get("metrics", [])


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int64: np.int64, torch.float64: np.float64}


def restore(path: str, like: Any, algo: str | None = None) -> Any:
    """Restore into ``like`` (a state with ``tree()``, or a nested dict
    of tensors): every leaf is validated by shape and dtype against the
    checkpoint, naming the offending key, then overwritten IN PLACE.
    Returns ``like``.

    The path goes through :func:`resolve` first.  ``algo``: expected
    algorithm name; raises ValueError when the sidecar was stamped by a
    different algorithm."""
    path = resolve(path)
    if algo is not None:
        stamped = saved_meta(path).get("algo")
        if stamped is not None and stamped != algo:
            raise ValueError(
                f"checkpoint {path!r} was written by algo {stamped!r}; "
                f"refusing to restore it as {algo!r}")
    data = np.load(path)
    leaves = _flat_leaves(like)
    for key in leaves:
        if key not in data:
            raise KeyError(f"checkpoint missing key {key}")
    loaded = {}
    for key, leaf in leaves.items():
        arr = data[key]
        if leaf.dtype == torch.bfloat16:
            if arr.dtype != np.uint16:
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {arr.dtype} but the "
                    f"restore template expects bfloat16 (stored as uint16 "
                    f"bits); restore with a matching-precision state")
            src = torch.from_numpy(
                np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
        else:
            if arr.dtype == np.uint16:
                raise ValueError(
                    f"checkpoint leaf {key!r} was saved as bfloat16 bits "
                    f"but the restore template expects {leaf.dtype}; "
                    "restore with a matching-precision state (e.g. "
                    "--precision bf16)")
            want = _NP_DTYPES.get(leaf.dtype)
            if arr.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {arr.dtype} but the "
                    f"restore template expects {leaf.dtype}; restore with a "
                    f"matching-precision state (a float32 checkpoint does "
                    f"not restore into a --precision bf16 template)")
            src = torch.from_numpy(np.array(arr, copy=True))
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(src.shape)} "
                f"but the restore template expects {tuple(leaf.shape)} — "
                f"checkpoint from a different --arch/--replicas/config?")
        loaded[key] = src
    with torch.no_grad():
        for key, leaf in leaves.items():
            leaf.copy_(loaded[key])
    return like


def load_flat(path: str) -> dict:
    """Template-free load: the raw {path key: ndarray} mapping as written
    (bf16 leaves stay uint16 bit patterns), for a reader whose structure
    differs from the writer's — an elastic async pod resuming with
    another worker count reads the consensus vectors with no ``like``
    state.  Digest-verified when the sidecar carries one."""
    path = _npz(path)
    verify(path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def latest_step(path: str) -> int:
    with open(_npz(path) + ".json") as f:
        return json.load(f)["step"]
