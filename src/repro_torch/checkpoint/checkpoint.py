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
* The npz is written one member at a time in one sequential pass (each
  member's CRC and sizes in a data descriptor after its data, as a zip
  written to a stream has them), and its sha1 is taken from the bytes as
  they go, in a thread: no second pass over the file.  ``np.load`` and
  the reference read it as any npz.  :func:`restore` finds each
  member's bytes from the headers and reads them (a rank: only its
  rows) straight into a host buffer, pinned for a device state.

:func:`restore` writes the checkpoint's values INTO the leaves of the
``like`` state (its device buffers) and returns it.

Across the ranks of a ``ReplicaGroup`` or a ``MeshGroups`` the file is
the same one: the state's prefix tree of replica axes
(``Algorithm.state_pspecs``) says which fields carry the n replica rows,
and every leaf is written whole.  :func:`save_rows` gathers those rows
leaf by leaf to rank 0's host (``ReplicaGroup.gather_rows``); under axes
inside a replica each leaf's blocks first meet on the replica's first
in-replica rank, which assembles the whole leaf
(``MeshGroups.gather_state``).  Rank 0 writes the one npz, and every
rank passes a barrier.  :func:`restore` with ``group=`` reads each such
leaf's rows of the rank (one byte range) and copies the rank's blocks
of them into its template.  So a file written under any mesh shape, in
one process or by the reference, restores under any mesh shape whose
replica axis divides its n.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import struct
import threading
import time
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.sharding.partition import in_replica
from repro_torch.utils.pytree import tree_leaves_with_paths

SEP = "/"
WRITE_CHUNK = 64 << 20     # bytes handed to the zip writer at a time


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
        for block in iter(lambda: f.read(16 << 20), b""):
            h.update(block)
    return h.hexdigest()


class _HashedStream:
    """A write-only, non-seekable file over ``f`` that hashes every byte
    written (sha1, in a thread of its own, so the digest costs no second
    pass over the file).  Non-seekable, a ``zipfile`` writes each member
    in one sequential pass (sizes and CRC in a data descriptor after its
    data), so the bytes hashed are the file's.  The hash thread reads the
    writer's buffers in place: :meth:`drain` before a buffer changes."""

    def __init__(self, f):
        self.f, self.n = f, 0
        self.sha1 = hashlib.sha1()
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._hash, daemon=True)
        self.thread.start()

    def _hash(self):
        while (b := self.q.get()) is not None:
            self.sha1.update(b)
            self.q.task_done()
        self.q.task_done()

    def write(self, b) -> int:
        self.f.write(b)
        self.q.put(b)
        n = memoryview(b).nbytes
        self.n += n
        return n

    def drain(self):
        """Wait until every byte written so far is hashed."""
        self.q.join()

    def tell(self) -> int:
        return self.n

    def seek(self, *args):
        raise OSError("not seekable")

    def flush(self):
        self.f.flush()

    def hexdigest(self) -> str:
        self.q.put(None)
        self.thread.join()
        return self.sha1.hexdigest()


class _NpzWriter:
    """An npz written one array at a time (the members ``np.savez``
    writes: ``<key>.npy``, stored, zip64) to ``<path>.tmp.<pid>``,
    hashed as it goes; :meth:`close` fsyncs it and returns (tmp path,
    sha1 digest)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.tmp = f"{path}.tmp.{os.getpid()}"
        self.f = open(self.tmp, "wb")
        self.stream = _HashedStream(self.f)
        self.zf = zipfile.ZipFile(self.stream, mode="w",
                                  compression=zipfile.ZIP_STORED,
                                  allowZip64=True)
        self.keys = []

    def add(self, key: str, arr: np.ndarray):
        """One member: the .npy header (format 1.0, as ``np.save`` writes
        it) and the array's bytes, straight from its buffer."""
        arr = np.asarray(arr)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        data = memoryview(arr.reshape(-1)).cast("B")
        with self.zf.open(key + ".npy", "w", force_zip64=True) as fid:
            np.lib.format.write_array_header_1_0(
                fid, np.lib.format.header_data_from_array_1_0(arr))
            for i in range(0, len(data), WRITE_CHUNK):
                fid.write(data[i:i + WRITE_CHUNK])
        self.stream.drain()         # the caller may reuse arr's buffer
        self.keys.append(key)

    def close(self):
        self.zf.close()
        digest = self.stream.hexdigest()
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()
        return self.tmp, digest


def save(path: str, tree: Any, step: int = 0, meta: dict | None = None,
         algo: str | None = None, metrics: list | None = None):
    """``algo`` stamps the writing algorithm's registry name into the
    sidecar; :func:`restore` validates it.  ``metrics``: a cumulative
    counter stamp (``Registry.counter_stamp()``), read back with
    :func:`saved_metrics`."""
    path = _npz(path)
    w = _NpzWriter(path)
    for k, v in _flat_leaves(tree).items():
        w.add(k, to_numpy(v))
    _finish(path, w, step, meta, algo, metrics)


def _is_row_key(key: str, pspecs: dict) -> bool:
    return pspecs.get(key.split(SEP)[0]) is not None


def _layout_keys(state) -> dict:
    """{key: layout index} of the leaves a state holds through its
    ``layout`` (the views of its flat buffers: not ``step`` or the
    scopes)."""
    lay = state.layout
    names = {SEP.join(p): i for i, p in enumerate(lay.paths)}
    out = {}
    for f in state._fields:
        t = getattr(state, f)
        if (isinstance(t, torch.Tensor) and t.dim()
                and t.shape[-1] == lay.numel):
            out.update({f + SEP + k: i for k, i in names.items()})
    return out


def save_rows(path: str, state: Any, group, pspecs: dict, step: int = 0,
              meta: dict | None = None, algo: str | None = None,
              metrics=None) -> dict:
    """:func:`save` of a state held across the ranks of ``group`` (a
    ``ReplicaGroup`` or a ``MeshGroups``): rank 0 alone writes the file
    :func:`save` would write for the whole state, the same keys, whole
    leaves of shape ``(n, *leaf)`` and dtypes, each leaf as it arrives.

    The leaves of each field that ``pspecs`` gives a replica axis are
    gathered to rank 0's host one at a time (``ReplicaGroup.
    gather_rows``); under axes inside a replica every leaf a rank holds
    as blocks is assembled on its replica's first in-replica rank first,
    the fields without the replica axis (Parle's ``c``, Elastic-SGD's
    ``ref``, SGD's model) in replica 0 (``MeshGroups.gather_state``).
    ``step`` and the scopes are rank 0's own.  ``metrics``: a callable
    giving rank 0's counter stamp, read after the gather.  Every rank
    returns after the file is complete; rank 0 returns ``{"write_s": the
    seconds of its writes, digest and sidecar}``, the others ``{}``."""
    path = _npz(path)
    leaves = _flat_leaves(state)
    w = _NpzWriter(path) if group.rank == 0 else None
    spent = [0.0]

    def write(key, t):
        t0 = time.perf_counter()
        w.add(key, to_numpy(t))
        spent[0] += time.perf_counter() - t0

    mesh = in_replica(group)
    if mesh is not None:
        index = _layout_keys(state)
        keys = list(leaves)
        mesh.gather_state(
            [(leaves[k], index.get(k), _is_row_key(k, pspecs))
             for k in keys], state.layout,
            each=None if w is None else lambda i, t: write(keys[i], t))
    else:
        rows = [k for k in leaves if _is_row_key(k, pspecs)]
        if w is not None:
            for k, v in leaves.items():
                if not _is_row_key(k, pspecs):
                    write(k, v)
        if rows:                # SGD has no row field: nothing to gather
            group.gather_rows([leaves[k] for k in rows],
                              each=None if w is None else
                              lambda i, t: write(rows[i], t))
    out = {}
    if w is not None:
        t0 = time.perf_counter()
        _finish(path, w, step, meta, algo,
                metrics() if metrics is not None else None)
        out["write_s"] = round(spent[0] + time.perf_counter() - t0, 3)
    group.barrier()
    return out


def _finish(path: str, w: _NpzWriter, step, meta, algo, metrics):
    """Close ``w``, move its npz into place, then write the sidecar (tmp
    -> fsync -> ``os.replace``), so a sidecar naming a digest always
    describes a complete npz."""
    tmp, digest = w.close()
    os.replace(tmp, path)
    meta = dict(meta or {})
    if algo is not None:
        meta["algo"] = algo
    sidecar = {"step": int(step), "keys": sorted(w.keys),
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


def _members(path: str) -> dict:
    """{key: (byte offset of its data, shape, dtype)} of every
    ``<key>.npy`` member of the npz at ``path`` (stored, not compressed,
    by either package's writer), read from the zip's and the .npy
    headers alone."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"checkpoint {path!r}: member "
                                 f"{info.filename!r} is compressed")
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if fortran and len(shape) > 1:
                raise ValueError(f"checkpoint {path!r}: member "
                                 f"{info.filename!r} is in Fortran order")
            out[info.filename[:-4]] = (f.tell(), tuple(shape), dtype)
    return out


def restore(path: str, like: Any, algo: str | None = None, group=None,
            pspecs: dict | None = None, resolved: bool = False) -> Any:
    """Restore into ``like`` (a state with ``tree()``, or a nested dict
    of tensors): every leaf is validated by shape and dtype against the
    checkpoint, naming the offending key, then overwritten IN PLACE, one
    leaf at a time (host memory holds one leaf's copy).  Returns
    ``like``.

    The path goes through :func:`resolve` first, unless ``resolved``
    (the caller resolved it).  ``algo``: expected algorithm name; raises
    ValueError when the sidecar was stamped by a different algorithm.
    ``group`` (a ``ReplicaGroup`` or a ``MeshGroups`` of several ranks)
    and ``pspecs`` (the algorithm's ``state_pspecs``): ``like`` holds the
    rank's k rows of each field with a replica axis, and gets rows
    ``group.rows`` of the checkpoint's n (which must be ``group.n``);
    only those rows are read, one contiguous byte range a leaf.  Under
    axes inside a replica ``like`` holds the rank's blocks of each leaf
    (its ``ShardedLayout``): the rank's rows of the whole leaf are read,
    and its blocks copied out of them; the gaps stay zero.  Any mesh
    shape reads a file of any other, or of one process."""
    if not resolved:
        path = resolve(path)
    if algo is not None:
        stamped = saved_meta(path).get("algo")
        if stamped is not None and stamped != algo:
            raise ValueError(
                f"checkpoint {path!r} was written by algo {stamped!r}; "
                f"refusing to restore it as {algo!r}")
    rows = group is not None and not group.trivial
    mesh = in_replica(group)
    blocks = _layout_keys(like) if mesh is not None else {}
    leaves = _flat_leaves(like)
    members = _members(path)
    spans = {}          # key: (byte offset, bytes, whole shape, layout index)
    for key, leaf in leaves.items():
        if key not in members:
            raise KeyError(f"checkpoint missing key {key}")
        off, shape, dtype = members[key]
        b = blocks.get(key)
        whole = tuple(leaf.shape)
        if b is not None:
            lead = whole[:leaf.dim() - len(like.layout.shapes[b])]
            whole = lead + tuple(like.layout.full.shapes[b])
        want_shape = whole
        nbytes = torch.Size(whole).numel() * leaf.element_size()
        if rows and _is_row_key(key, pspecs):
            want_shape = (group.n,) + whole[1:]
            off += group.rows.start * nbytes // group.local
        _check_leaf(key, leaf, shape, dtype, want_shape)
        spans[key] = (off, nbytes, whole, b)
    # each leaf's bytes (a rank's rows: one contiguous range) read
    # straight into one host buffer, pinned for a device template
    cuda = any(t.device.type != "cpu" for t in leaves.values())
    stage = torch.empty(max([n for _, n, _, _ in spans.values()] + [1]),
                        dtype=torch.uint8, pin_memory=cuda)
    with open(path, "rb") as f, torch.no_grad():
        for key, leaf in leaves.items():
            off, nbytes, whole, b = spans[key]
            f.seek(off)
            if f.readinto(stage[:nbytes].numpy()) != nbytes:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: leaf {key!r} is truncated")
            got = stage[:nbytes].view(leaf.dtype).view(whole)
            leaf.copy_(got if b is None else like.layout.block_of(b, got))
    return like


def _check_leaf(key, leaf, shape, dtype, want_shape):
    """Raise naming ``key`` when the checkpoint's (shape, dtype) does not
    fit the template leaf (``want_shape``: its shape in the file)."""
    if leaf.dtype == torch.bfloat16:
        if dtype != np.uint16:
            raise ValueError(
                f"checkpoint leaf {key!r} has dtype {dtype} but the "
                f"restore template expects bfloat16 (stored as uint16 "
                f"bits); restore with a matching-precision state")
    else:
        if dtype == np.uint16:
            raise ValueError(
                f"checkpoint leaf {key!r} was saved as bfloat16 bits "
                f"but the restore template expects {leaf.dtype}; "
                "restore with a matching-precision state (e.g. "
                "--precision bf16)")
        want = _NP_DTYPES.get(leaf.dtype)
        if dtype != want:
            raise ValueError(
                f"checkpoint leaf {key!r} has dtype {dtype} but the "
                f"restore template expects {leaf.dtype}; restore with a "
                f"matching-precision state (a float32 checkpoint does "
                f"not restore into a --precision bf16 template)")
    if shape != want_shape:
        raise ValueError(
            f"checkpoint leaf {key!r} has shape {shape} "
            f"but the restore template expects {want_shape} — "
            f"checkpoint from a different --arch/--replicas/config?")


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
