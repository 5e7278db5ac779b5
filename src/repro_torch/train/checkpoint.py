"""Checkpoints (``repro.train.checkpoint``): a state tree to
``arrays.npz`` + ``manifest.json``, in the reference's on-disk format.

The manifest's ``names`` are the strings ``jax.tree_util.keystr`` gives
for the same tree (``['opt']['m']['blocks'][0]['mixer']['wq']``), its
``dtypes`` and ``shapes`` numpy's, and array ``a<i>`` is leaf i in that
flattening order (dict keys sorted). The trainer saves its state through
``lm.reference_tree``, whose :class:`~repro_torch.utils.Stacked` leaves
are written as the reference's arrays stacked over layers, so a
checkpoint written by either package is read by the other.

Two write paths share the format and its atomicity:

- :func:`save_checkpoint`, synchronous: copy to the host, write, commit;
- :class:`AsyncCheckpointer`: the caller only queues one device-side copy
  of every leaf (``torch._foreach_copy_`` into one buffer, allocated once
  and reused) and records a CUDA event after it; a writer thread waits
  on that event, copies the buffer to the host on a side stream and
  writes the files. The next optimizer step, which updates the masters
  in place, is queued behind the snapshot on the same stream, so it
  cannot race the read. The copy to the host goes through two pinned
  64 MiB staging chunks: one copy of the whole buffer into pageable
  memory would hold the driver for seconds and stall the training
  thread's own copies (the input's, measured at 8 s for 16 GB).

A bfloat16 leaf (grok's Adam moments) is stored as the reference's
are: numpy has no bfloat16, so ``arrays.npz`` holds its bytes as 2-byte
voids and the manifest names the dtype ``bfloat16``.

Memory: the device snapshot is as large as the state, 12 B a parameter
for fp32 masters and Adam's two fp32 moments, and must fit on the card
beside it; the host holds one buffer of the same size.

Atomicity: everything is written into a ``.tmp_<name>.<pid>`` sibling,
``arrays.npz`` first and fsynced, then ``manifest.json`` fsynced, then
the directory is renamed into place. A crash at any point leaves only
the tmp directory, which ``latest_step`` and ``manifest_step`` never
read, so the previous checkpoint stays the latest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import Stacked

_ALIGN = 64  # bytes between leaves in the snapshot buffer
_CHUNK = 64 << 20  # bytes of one pinned staging chunk (async writer)


def _flatten_with_names(tree, prefix: str = "") -> Tuple[List[str], List]:
    """(names, leaves) in ``jax.tree_util`` order with its ``keystr``
    names: dict keys sorted, ``['key']``; list and tuple items ``[i]``."""
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, lv = _flatten_with_names(tree[k], f"{prefix}[{k!r}]")
            names += n
            leaves += lv
        return names, leaves
    if isinstance(tree, (list, tuple)):
        names, leaves = [], []
        for i, t in enumerate(tree):
            n, lv = _flatten_with_names(t, f"{prefix}[{i}]")
            names += n
            leaves += lv
        return names, leaves
    return [prefix], [tree]


_BF16 = np.dtype("V2")  # how numpy stores the reference's bfloat16 leaves


def _numpy_dtype(dtype) -> np.dtype:
    """The dtype of a leaf's array in ``arrays.npz``: numpy's own, and
    for bfloat16, which numpy lacks, the 2-byte void that ``np.savez``
    writes for the reference's bfloat16 arrays."""
    if dtype == torch.bfloat16:
        return _BF16
    if isinstance(dtype, torch.dtype):
        try:
            return torch.empty((), dtype=dtype).numpy().dtype
        except TypeError:
            raise TypeError(f"checkpoints hold numpy dtypes; {dtype} has "
                            f"none") from None
    return np.dtype(dtype)


def _dtype_name(dtype) -> str:
    """The manifest's name of a leaf's dtype, the reference's."""
    return "bfloat16" if dtype == torch.bfloat16 else str(_numpy_dtype(dtype))


def _torch_view(a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor sharing its memory; a bfloat16 array (void
    bytes) as bfloat16."""
    if a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _parts(leaf) -> list:
    return leaf.parts if isinstance(leaf, Stacked) else [leaf]


class _Layout:
    """Where each leaf lies in one flat byte buffer: a Stacked leaf's
    parts are consecutive, so the buffer holds the reference's stacked
    array as it is."""

    def __init__(self, leaves):
        self.entries = []
        off = 0
        for leaf in leaves:
            dt = _numpy_dtype(leaf.dtype)
            shape = tuple(int(d) for d in leaf.shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self.entries.append((off, nbytes, dt, shape))
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.nbytes = max(off, 1)
        self.signature = tuple((dt.str, shape)
                               for _, _, dt, shape in self.entries)

    def arrays(self, buf: np.ndarray) -> List[np.ndarray]:
        """Each leaf's array, a view of the host buffer ``buf``."""
        return [buf[o:o + n].view(dt).reshape(shape)
                for o, n, dt, shape in self.entries]

    def tensor_views(self, buf: torch.Tensor, leaves) -> List[torch.Tensor]:
        """A view of ``buf`` (uint8) for every part of every leaf."""
        views = []
        for (o, n, dt, shape), leaf in zip(self.entries, leaves):
            parts = _parts(leaf)
            v = buf[o:o + n].view(_torch_view(np.empty(0, dt)).dtype)
            if isinstance(leaf, Stacked):
                v = v.view(shape)
                views += [v[b] for b in range(len(parts))]
            else:
                views.append(v.view(shape))
        return views


def _build_manifest(names, leaves, step: Optional[int]) -> Dict[str, Any]:
    return {"names": names,
            "dtypes": [_dtype_name(leaf.dtype) for leaf in leaves],
            "shapes": [[int(d) for d in leaf.shape] for leaf in leaves],
            "step": step}


class _InjectedCrash(RuntimeError):
    """Raised by the fault-injection hook (crash-safety tests only)."""


def _write_files(path: str, arrays: List[np.ndarray], manifest: dict, *,
                 crash_after_tensors: bool = False) -> None:
    """Write one checkpoint directory atomically: the arrays, then the
    manifest, then the rename that commits. ``crash_after_tensors``
    simulates the worst crash, between the two files."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp_{os.path.basename(path)}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})
            f.flush()
            os.fsync(f.fileno())
        if crash_after_tensors:
            raise _InjectedCrash(
                "injected crash between tensor write and manifest commit")
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _to_host_chunked(snap: torch.Tensor, host: np.ndarray, ready,
                     staging: List[torch.Tensor]) -> None:
    """Copy the device buffer ``snap`` into ``host`` through the pinned
    ``staging`` chunks, on a side stream that first waits on ``ready``:
    chunk i + 1 is in flight while chunk i is copied out on the host."""
    side = torch.cuda.Stream(snap.device)
    out = torch.from_numpy(host)
    n = snap.numel()
    inflight = []  # (event, staging chunk, offset, size)
    with torch.cuda.stream(side):
        side.wait_event(ready)  # the snapshot is complete
        for i, off in enumerate(range(0, n, _CHUNK)):
            if len(inflight) == len(staging):
                ev, buf, o, size = inflight.pop(0)
                ev.synchronize()
                out[o:o + size].copy_(buf[:size])
            buf = staging[i % len(staging)]
            size = min(_CHUNK, n - off)
            buf[:size].copy_(snap[off:off + size], non_blocking=True)
            inflight.append((side.record_event(), buf, off, size))
    for ev, buf, o, size in inflight:
        ev.synchronize()
        out[o:o + size].copy_(buf[:size])


def save_checkpoint(path: str, state, *, step: Optional[int] = None) -> None:
    """Synchronous save: copy every leaf to the host, then write and
    commit before returning."""
    names, leaves = _flatten_with_names(state)
    lay = _Layout(leaves)
    host = np.empty(lay.nbytes, np.uint8)
    with torch.no_grad():
        for dst, src in zip(lay.tensor_views(torch.from_numpy(host), leaves),
                            [p for leaf in leaves for p in _parts(leaf)]):
            dst.copy_(torch.as_tensor(src))
    _write_files(path, lay.arrays(host), _build_manifest(names, leaves, step))


class AsyncCheckpointer:
    """Non-blocking checkpoint writer: the snapshot is queued on the
    caller's stream, the copy to the host and the files are made on a
    writer thread, and at most one save is in flight.

    ``save()`` first drains the previous save (saves never reorder, and
    one snapshot buffer serves them all), queues the device-side copy
    and returns once the writer thread owns it. ``wait()`` joins the
    in-flight save and re-raises the writer's failure; call it (or rely
    on ``CheckpointHook.on_finish``) before reading the checkpoint."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._in_flight_path: Optional[str] = None
        self._signature = None
        self._device_buf: Optional[torch.Tensor] = None
        self._host_buf: Optional[np.ndarray] = None
        self._staging: List[torch.Tensor] = []
        # test-only fault injection: crash the writer at the worst point
        self._crash_after_tensors = False

    @property
    def in_flight(self) -> Optional[str]:
        """Path of the save being written (None when idle)."""
        return self._in_flight_path

    def save(self, path: str, state, *, step: Optional[int] = None) -> None:
        self.wait()
        names, leaves = _flatten_with_names(state)
        lay = _Layout(leaves)
        parts = [p for leaf in leaves for p in _parts(leaf)]
        device = parts[0].device if torch.is_tensor(parts[0]) \
            else torch.device("cpu")
        if self._signature != (lay.signature, device):
            self._device_buf = None
            self._host_buf = None
            self._device_buf = torch.empty(lay.nbytes, dtype=torch.uint8,
                                           device=device)
            self._signature = (lay.signature, device)
        with torch.no_grad():
            torch._foreach_copy_(lay.tensor_views(self._device_buf, leaves),
                                 [torch.as_tensor(p, device=device)
                                  for p in parts])
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        manifest = _build_manifest(names, leaves, step)
        crash = self._crash_after_tensors
        snap = self._device_buf

        def write():
            try:
                if ready is None:
                    host = snap.numpy()
                else:
                    if self._host_buf is None:
                        self._host_buf = np.empty(lay.nbytes, np.uint8)
                    if not self._staging:
                        self._staging = [
                            torch.empty(_CHUNK, dtype=torch.uint8,
                                        pin_memory=True) for _ in range(2)]
                    host = self._host_buf
                    _to_host_chunked(snap, host, ready, self._staging)
                _write_files(path, lay.arrays(host), manifest,
                             crash_after_tensors=crash)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._error = e

        self._in_flight_path = path
        self._thread = threading.Thread(target=write,
                                        name="repro-torch-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Drain the in-flight save; re-raise the writer's failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._in_flight_path = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def release(self) -> None:
        """Drain, then free the snapshot buffers."""
        self.wait()
        self._device_buf = self._host_buf = self._signature = None
        self._staging = []


def restore_into(path: str, state) -> None:
    """Copy a checkpoint into the tensors (or arrays) of ``state`` in
    place, each Stacked leaf part by part. Raises ``AssertionError`` on
    a structure mismatch, as the reference does, and ``ValueError`` on a
    shape or dtype mismatch."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names, leaves = _flatten_with_names(state)
    if names != manifest["names"]:
        raise AssertionError(
            "checkpoint structure mismatch: "
            f"{set(names) ^ set(manifest['names'])}")
    with np.load(os.path.join(path, "arrays.npz")) as data, torch.no_grad():
        for i, leaf in enumerate(leaves):
            a = data[f"a{i}"]
            if a.shape != tuple(leaf.shape) or \
                    a.dtype != _numpy_dtype(leaf.dtype):
                raise ValueError(
                    f"{names[i]}: checkpoint holds {a.dtype}{list(a.shape)}"
                    f", the state {_numpy_dtype(leaf.dtype)}"
                    f"{list(leaf.shape)}")
            if isinstance(leaf, np.ndarray):
                np.copyto(leaf, a)
            elif isinstance(leaf, Stacked):
                for b, part in enumerate(leaf.parts):
                    part.copy_(_torch_view(a[b]))
            else:
                leaf.copy_(_torch_view(a))


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(t) for t in tree)
    if isinstance(tree, Stacked):
        return Stacked([torch.empty_like(p) for p in tree.parts])
    if isinstance(tree, np.ndarray):
        return np.empty_like(tree)
    return torch.empty_like(tree)


def restore_checkpoint(path: str, state_like):
    """A new tree of ``state_like``'s structure, devices and dtypes
    holding the checkpoint (the reference's API)."""
    out = _like(state_like)
    restore_into(path, out)
    return out


def manifest_step(path: str) -> Optional[int]:
    """The global step recorded in a checkpoint directory's manifest."""
    manifest = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        step = json.load(f).get("step")
    return None if step is None else int(step)


def latest_step(root: str) -> Optional[int]:
    """Latest committed ``step_<N>`` under ``root``; tmp directories
    (in-flight or crashed writes) and directories without a manifest
    never count."""
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("step_") and d.split("_")[-1].isdigit()
             and os.path.exists(os.path.join(root, d, "manifest.json"))]
    return max(steps) if steps else None
