"""Checkpoint and resume (counterpart of paddle_tpu/checkpoint.py),
single process, in the JAX package's on-disk format
``paddle_tpu_ckpt/v1``, so a checkpoint moves between the packages.

Layout: ``<dir>/manifest.json`` and one ``.npy`` per leaf. The manifest
holds the tree's skeleton (dict keys sorted, the order ``jax.tree_util``
flattens in), each leaf's ``/``-joined path, file, dtype, shape and a
``spec`` (always ``null`` here: the port has no mesh yet), and every
file's checksum (``resilience.integrity``). A ``COMMITTED`` marker
carrying the manifest's checksum is written last into ``<dir>.tmp``,
and only then is the step published by an atomic rename, through a
``<dir>.old`` swap when a step of that name exists. bfloat16 and
float8 leaves are stored as a same-width unsigned view named by the
dtype, as the JAX package stores them (the port views through torch;
no ``ml_dtypes``).

``save_state`` copies every leaf into fresh host memory before it
returns (CUDA leaves by one batched copy into pinned buffers on a side
stream, waited on; CPU leaves cloned, since ``.numpy()`` would alias
live storage), so the caller may update its parameters in place at
once; with ``async_save`` the file I/O runs on a thread. Restores
return CPU tensors; ``Trainer.restore_checkpoint`` copies them into its
live parameters and optimizer state.

Multi-process checkpoints (``per_host=True``, shard-region files, the
barriers, ``GLOBAL_COMMITTED`` and a manager's ``coordinator=``) and
restoring onto a mesh (``mesh=``, ``shardings=``) raise
:class:`UnimplementedError` naming ROADMAP queue 1 item 11. The JAX
package's checkpoint metrics are telemetry (item 8)."""

from __future__ import annotations

import io
import json
import math
import os
import re
import shutil
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core.enforce import EnforceError, UnimplementedError, enforce
from .resilience import faults as _faults
from .resilience.integrity import ChecksumError, checksum_bytes, verify_bytes
from .resilience.retry import retry_io
from .utils.atomic import atomic_write_bytes, atomic_write_text

_FORMAT = "paddle_tpu_ckpt/v1"
_MANIFEST = "manifest.json"
# written last into the staging dir: its presence in a published step
# certifies every byte above it (a torn copy lacks it; restore skips it)
_COMMITTED = "COMMITTED"
_ITEM11 = "is not ported yet: ROADMAP queue 1 item 11 (distributed)"

# dtypes the .npy format cannot hold, as (same-width view in torch, in
# numpy), by the name the manifest records
_EXOTIC = {"bfloat16": (torch.int16, np.uint16),
           "float8_e4m3fn": (torch.uint8, np.uint8),
           "float8_e5m2": (torch.uint8, np.uint8)}
_TORCH_EXOTIC = {getattr(torch, name): name for name in _EXOTIC}


def _is_leaf(x) -> bool:
    return (torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic))
            or isinstance(x, (bool, int, float)))


def _flatten(tree, path=(), out=None):
    """[(path, leaf)] in the JAX package's order: dict keys sorted, lists
    and tuples in order, ``None`` an empty subtree."""
    out = [] if out is None else out
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    else:
        enforce(_is_leaf(tree),
                "tree has custom pytree nodes the checkpoint skeleton can't "
                "represent (a leaf of type %s at %s) — use dict/list/tuple "
                "containers of tensors, arrays or numbers",
                type(tree).__name__, "/".join(path) or "_root")
        out.append(("/".join(path) or "_root", tree))
    return out


def _skeleton(tree, counter):
    """JSON nesting with leaf-index placeholders (the JAX package's)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _skeleton(tree[k], counter)
                          for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_skeleton(v, counter) for v in tree]}
    idx = counter[0]
    counter[0] += 1
    return {"__kind__": "leaf", "index": idx}


def _unskeleton(skel, leaves):
    if skel is None:
        return None
    kind = skel["__kind__"]
    if kind == "dict":
        return {k: _unskeleton(v, leaves) for k, v in skel["items"].items()}
    if kind == "list":
        return [_unskeleton(v, leaves) for v in skel["items"]]
    if kind == "tuple":
        return tuple(_unskeleton(v, leaves) for v in skel["items"])
    return leaves[skel["index"]]


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


_COPY_STREAMS: Dict[torch.device, Any] = {}


def _snapshot(leaves) -> List[Any]:
    """Owned host copies of ``leaves``: CUDA tensors into pinned buffers
    by non-blocking copies on a side stream that first waits for the
    compute stream, all waited on before returning; CPU tensors and
    arrays cloned; numbers as numpy scalars (a Python int is int64, as
    the JAX package writes it). Returns CPU tensors or numpy arrays."""
    out: List[Any] = [None] * len(leaves)
    by_device: Dict[torch.device, List[int]] = {}
    for i, x in enumerate(leaves):
        if torch.is_tensor(x) and x.is_cuda:
            by_device.setdefault(x.device, []).append(i)
        elif torch.is_tensor(x):
            out[i] = x.detach().clone()
        else:
            out[i] = np.array(x)
    events = []
    for dev, idx in by_device.items():
        stream = _COPY_STREAMS.get(dev)
        if stream is None:
            stream = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for i in idx:
                host = torch.empty(leaves[i].shape, dtype=leaves[i].dtype,
                                   pin_memory=True)
                host.copy_(leaves[i].detach(), non_blocking=True)
                out[i] = host
        ev = torch.cuda.Event()
        ev.record(stream)
        events.append(ev)
    for ev in events:
        ev.synchronize()
    return out


def _to_numpy(x):
    """(array to write, dtype name for the manifest)."""
    if torch.is_tensor(x):
        name = _TORCH_EXOTIC.get(x.dtype)
        if name is not None:
            tview, nview = _EXOTIC[name]
            return x.contiguous().view(tview).numpy().view(nview), name
        x = x.contiguous().numpy()
    arr = np.asarray(x, order="C")     # keeps 0-dim arrays 0-dim
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    view = _EXOTIC.get(dtype)
    if view is None:
        return torch.from_numpy(arr)
    tview, nview = view
    return torch.from_numpy(arr.view(np.dtype(str(tview)[6:]))).view(
        getattr(torch, dtype))


def _npy_bytes(arr: np.ndarray):
    """The exact ``.npy`` file bytes, as a read-only view (one pass
    gives the bytes to checksum and to write)."""
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getbuffer().toreadonly()


def _parse_npy(raw, name: str) -> np.ndarray:
    """Array over ``raw``'s payload without a copy (``raw`` a bytearray,
    so the array, and a tensor over it, is writable)."""
    try:
        bio = io.BytesIO(raw)
        major, _ = np.lib.format.read_magic(bio)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(bio)
        enforce(not fortran, "fortran-ordered payload")
        count = math.prod(shape)
        arr = np.frombuffer(raw, dtype=dtype, count=count,
                            offset=bio.tell())
        return arr.reshape(shape)
    except (ValueError, EnforceError) as e:
        raise ChecksumError(f"{name}: unreadable npy payload ({e})") from e


def _write_resilient(path: str, data, point: str, inj) -> None:
    """Atomic write under the retry policy, through the injection points
    ``io.slow`` and ``point``."""
    def attempt():
        d = data
        if inj is not None:
            inj.fire("io.slow", path=path)
            d = inj.fire(point, data=d, path=path)
        atomic_write_bytes(path, d)

    retry_io(attempt, what=point)


def _read_resilient(path: str, inj) -> bytearray:
    """Whole-file read under the retry policy; the bytes pass through
    ``restore.read``, so a ``corrupt`` rule hands the verifier corrupt
    bytes."""
    def attempt():
        if inj is not None:
            inj.fire("io.slow", path=path)
        with open(path, "rb") as f:
            raw = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(raw)
        if inj is not None:
            raw = inj.fire("restore.read", data=raw, path=path)
        return raw if isinstance(raw, bytearray) else bytearray(raw)

    return retry_io(attempt, what="restore.read")


class _WriteHandle:
    """A join-able async write that re-raises the writer's failure."""

    DEFAULT_JOIN_TIMEOUT_S = 600.0

    def __init__(self, fn=None, directory: Optional[str] = None):
        self.directory = directory
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if fn is not None:
            def run():
                try:
                    fn()
                except BaseException as e:  # re-raised at join()
                    # pt-lint: disable=PT-RACE-401 join() reads _exc only after Thread.join returns (the happens-before edge)
                    self._exc = e

            self._thread = threading.Thread(target=run, daemon=True,
                                            name="pt-ckpt-async-writer")
            self._thread.start()

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            t = (timeout if timeout is not None
                 else float(os.environ.get("PT_CKPT_JOIN_TIMEOUT_S",
                                           self.DEFAULT_JOIN_TIMEOUT_S)))
            self._thread.join(t)
            if self._thread.is_alive():
                raise EnforceError(
                    f"checkpoint writer thread still running after {t:.0f}s "
                    f"(target {self.directory or '?'}): wedged IO — refusing "
                    f"to hang teardown (PT_CKPT_JOIN_TIMEOUT_S overrides)")
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def save_state(directory: str, tree, *, async_save: bool = False,
               per_host: Optional[bool] = None):
    """Write ``tree`` (dicts, lists, tuples and None over tensors, numpy
    arrays and numbers) as a checkpoint at ``directory``. Every leaf is
    copied to owned host memory before this returns; with ``async_save``
    the files are written on a thread and the returned handle's
    ``.join()`` waits and re-raises a failed write. Namedtuples come back
    as tuples; any other container raises."""
    if per_host:
        raise UnimplementedError(f"save_state per_host=True {_ITEM11}")
    flat = _flatten(tree)
    counter = [0]
    skel = _skeleton(tree, counter)
    enforce(counter[0] == len(flat), "skeleton and leaves disagree")
    entries, payload, seen = [], [], set()
    for (path, _), host in zip(flat, _snapshot([x for _, x in flat])):
        base = _sanitize(path)
        enforce(base not in seen, "leaf path collision on %s", base)
        seen.add(base)
        arr, dtype = _to_numpy(host)
        entries.append({"path": path, "file": base + ".npy",
                        "dtype": dtype, "shape": list(arr.shape),
                        "spec": None})
        payload.append((base + ".npy", arr))

    def write():
        inj = _faults.active()
        tmp = directory + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        checksums: Dict[str, str] = {}
        for fname, arr in payload:
            data = _npy_bytes(arr)
            # the true bytes' checksum, before an injected corruption
            checksums[fname] = checksum_bytes(data)
            _write_resilient(os.path.join(tmp, fname), data, "ckpt.write",
                             inj)
        text = json.dumps({"format": _FORMAT, "skeleton": skel,
                           "leaves": entries, "checksums": checksums})
        _write_resilient(os.path.join(tmp, _MANIFEST), text.encode(),
                         "ckpt.manifest", inj)
        retry_io(lambda: atomic_write_text(
            os.path.join(tmp, _COMMITTED),
            json.dumps({"format": _FORMAT,
                        "manifest_checksum": checksum_bytes(text.encode()),
                        "process_count": 1})), what="ckpt.commit")
        enforce(not os.path.exists(directory) or os.path.isdir(directory),
                "checkpoint target %s exists and is not a directory",
                directory)

        def publish():
            # re-entrant on retry; the live step is never deleted before
            # the new one is in place: a kill mid-swap leaves it as .old
            if os.path.isdir(directory):
                trash = directory + ".old"
                if os.path.exists(trash):
                    shutil.rmtree(trash)
                os.rename(directory, trash)
                os.replace(tmp, directory)
                shutil.rmtree(trash, ignore_errors=True)
            else:
                os.replace(tmp, directory)

        retry_io(publish, what="ckpt.publish")

    if async_save:
        return _WriteHandle(write, directory=directory)
    write()
    return None


def _torch_dtype(x) -> torch.dtype:
    if torch.is_tensor(x):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def restore_state(directory: str, *, mesh=None, shardings=None, target=None,
                  verify: bool = True):
    """Read a checkpoint back as a tree of CPU tensors (0-dim for
    scalars).

    ``target``: a tree whose leaves' shapes and dtypes the restored ones
    must match, by path (leaves without a shape, as Python ints, are not
    checked). ``verify``: check every file against the manifest's
    checksums and the manifest against the ``COMMITTED`` marker's; a torn
    or bit-flipped file raises :class:`ChecksumError`. A checkpoint
    written before checksums restores unverified. Reads retry under the
    transient-I/O policy."""
    for name, value in (("mesh", mesh), ("shardings", shardings)):
        if value is not None:
            raise UnimplementedError(f"restore_state {name}= {_ITEM11}")
    inj = _faults.active()
    mpath = os.path.join(directory, _MANIFEST)
    enforce(os.path.exists(mpath), "no checkpoint at %s", directory)
    raw_manifest = _read_resilient(mpath, inj)
    cpath = os.path.join(directory, _COMMITTED)
    if verify and os.path.exists(cpath):
        try:
            marker = json.loads(_read_resilient(cpath, inj))
        except ValueError as e:
            raise ChecksumError(f"{cpath}: torn COMMITTED marker "
                                f"({e})") from e
        tag = marker.get("manifest_checksum")
        if tag:
            verify_bytes(raw_manifest, tag, name=mpath)
    try:
        manifest = json.loads(raw_manifest)
    except ValueError as e:
        raise ChecksumError(f"{mpath}: unparseable manifest ({e})") from e
    enforce(manifest.get("format") == _FORMAT,
            "unknown checkpoint format %s", manifest.get("format"))
    checksums: Dict[str, str] = dict(manifest.get("checksums") or {})
    leaves = []
    for e in manifest["leaves"]:
        if "shards" in e:
            raise UnimplementedError(
                f"restore_state of a per-host (shard-region) leaf "
                f"{e['path']} {_ITEM11}")
        path = os.path.join(directory, e["file"])
        raw = _read_resilient(path, inj)
        tag = checksums.get(e["file"])
        if verify and tag is not None:
            verify_bytes(raw, tag, name=path)
        leaves.append(_from_numpy(_parse_npy(raw, path), e["dtype"]))
    tree = _unskeleton(manifest["skeleton"], leaves)
    if target is not None:
        tmap = dict(_flatten(target))
        for path, leaf in _flatten(tree):
            want = tmap.get(path)
            if want is None or not hasattr(want, "shape"):
                continue
            enforce(tuple(want.shape) == tuple(leaf.shape),
                    "checkpoint leaf %s shape %s != target %s", path,
                    tuple(leaf.shape), tuple(want.shape))
            enforce(_torch_dtype(want) == leaf.dtype,
                    "checkpoint leaf %s dtype %s != target %s", path,
                    leaf.dtype, _torch_dtype(want))
    return tree


class CheckpointManager:
    """Step-numbered checkpoints under ``directory`` (``step_<N>``) with
    retention: ``max_to_keep`` committed steps survive. ``save``
    snapshots at once and writes on a thread by default;
    ``wait_until_finished`` joins the writes (call it before exit).
    ``coordinator=`` (the fleet transaction) raises, naming ROADMAP queue
    1 item 11."""

    _STEP_RE = re.compile(r"^step_(\d+)$")
    # errors that mean "this step's bytes are bad", where the previous
    # committed step is worth a try; EnforceError (config, shapes) would
    # fail the same on every step and propagates
    _FALLBACK_ERRORS = (ChecksumError, OSError, ValueError, KeyError)

    def __init__(self, directory: str, max_to_keep: int = 5,
                 async_save: bool = True, coordinator=None):
        if coordinator is not None:
            raise UnimplementedError(
                f"CheckpointManager coordinator= {_ITEM11}")
        enforce(max_to_keep >= 1, "max_to_keep must be >= 1, got %s",
                max_to_keep)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.coordinator = None
        self._pending: List[_WriteHandle] = []
        self.last_restored_step: Optional[int] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        """Steps with a manifest on disk (committed or not)."""
        return sorted(int(m.group(1)) for m in map(
            self._STEP_RE.match, os.listdir(self.directory))
            if m and os.path.exists(os.path.join(
                self.directory, m.group(0), _MANIFEST)))

    def _is_committed(self, name: str) -> bool:
        d = os.path.join(self.directory, name)
        mpath = os.path.join(d, _MANIFEST)
        if not os.path.exists(mpath):
            return False
        if os.path.exists(os.path.join(d, _COMMITTED)):
            return True
        # no marker: a checkpoint from before checksums is trusted; a
        # checksummed manifest without its marker is a torn copy
        try:
            with open(mpath) as f:
                return "checksums" not in json.load(f)
        except (OSError, ValueError):
            return False

    def committed_steps(self) -> List[int]:
        """Steps whose save provably completed."""
        return sorted(int(m.group(1)) for m in map(
            self._STEP_RE.match, os.listdir(self.directory))
            if m and self._is_committed(m.group(0)))

    def latest_step(self) -> Optional[int]:
        """The newest committed step."""
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, *, coordinate: bool = True) -> None:
        """Snapshot ``tree`` now and write it as ``step`` (on a thread
        with ``async_save``); a write still in flight to the same step is
        joined first. ``coordinate`` only matters with a coordinator."""
        target = self._step_dir(step)
        still = []
        for t in self._pending:
            if t.directory == target:
                t.join()
            else:
                still.append(t)
        self._pending = still
        handle = save_state(target, tree, async_save=self.async_save)
        if isinstance(handle, _WriteHandle):
            self._pending.append(handle)
        self._gc()

    def restore(self, step: Optional[int] = None, *, mesh=None,
                shardings=None, target=None):
        """Restore ``step`` (exactly that step: integrity errors
        propagate) or, with ``step=None``, the newest committed step that
        verifies: a torn or corrupt newer step is reported on stderr and
        the next older committed one is tried. ``last_restored_step``
        records what was restored."""
        self.wait_until_finished()
        if step is not None:
            tree = restore_state(self._step_dir(step), mesh=mesh,
                                 shardings=shardings, target=target)
            self.last_restored_step = step
            return tree
        steps = self.committed_steps()
        enforce(steps, "no checkpoints under %s", self.directory)
        last_exc: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                tree = restore_state(self._step_dir(s), mesh=mesh,
                                     shardings=shardings, target=target)
                self.last_restored_step = s
                return tree
            except EnforceError:
                raise
            except self._FALLBACK_ERRORS as e:
                last_exc = e
                print(f"[checkpoint] step {s} failed restore "
                      f"({type(e).__name__}: {e}); falling back to the "
                      f"previous committed step", file=sys.stderr)
        raise last_exc

    def wait_until_finished(self) -> None:
        """Join outstanding writes, re-raising the first failure, then
        run the retention pass."""
        pending, self._pending = self._pending, []
        first_exc = None
        for t in pending:
            try:
                t.join()
            except BaseException as e:
                first_exc = first_exc or e
        self._gc()
        if first_exc is not None:
            raise first_exc

    def _gc(self) -> None:
        """Retention over COMMITTED steps only (an in-flight newer save
        never costs the newest committed one), then crash litter: torn
        step dirs older than the newest committed step with no writer of
        ours, and ``.old`` trash (put back when it is a step's only
        copy). Never blocks on a writer; failed handles stay pending so
        ``wait_until_finished`` re-raises them."""
        self._pending = [t for t in self._pending
                         if not t.done() or t._exc is not None]
        steps = self.committed_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        newest = steps[-1] if steps else None
        pending = {t.directory for t in self._pending}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            full = os.path.join(self.directory, name)
            if name.endswith(".old") and \
                    self._STEP_RE.match(name[:-len(".old")]):
                base = full[:-len(".old")]
                if os.path.exists(base):
                    shutil.rmtree(full, ignore_errors=True)
                elif os.path.exists(os.path.join(full, _MANIFEST)):
                    try:
                        os.rename(full, base)
                    except OSError:
                        pass
                else:
                    shutil.rmtree(full, ignore_errors=True)
                continue
            base = name[:-len(".tmp")] if name.endswith(".tmp") else name
            m = self._STEP_RE.match(base)
            if (m and newest is not None and int(m.group(1)) < newest
                    and os.path.join(self.directory, base) not in pending
                    and not self._is_committed(base)):
                shutil.rmtree(full, ignore_errors=True)


# --- dygraph-style convenience (reference: dygraph/checkpoint.py) ---------

_BUFFER = "_buffer."


def save(state_or_layer, path: str) -> None:
    """``save(module, path)`` or ``save(state_dict, path)``. A module is
    written as the JAX package's ``Layer.state_dict()`` is: parameters by
    name, persistent buffers as ``_buffer.<name>``, so the file loads in
    either package."""
    if isinstance(state_or_layer, torch.nn.Module):
        params = dict(state_or_layer.named_parameters())
        state = {(k if k in params else _BUFFER + k): v
                 for k, v in state_or_layer.state_dict().items()}
    else:
        state = state_or_layer
    save_state(path, state)


def load(path: str, *, mesh=None) -> Dict[str, Any]:
    """The saved state dict, with ``_buffer.`` prefixes stripped, as
    ``torch.nn.Module.load_state_dict`` takes it."""
    state = restore_state(path, mesh=mesh)
    return {(k[len(_BUFFER):] if k.startswith(_BUFFER) else k): v
            for k, v in state.items()}
