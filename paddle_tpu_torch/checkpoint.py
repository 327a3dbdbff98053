"""Checkpoint and resume (counterpart of paddle_tpu/checkpoint.py) in the
JAX package's on-disk format ``paddle_tpu_ckpt/v1``, so a checkpoint
moves between the packages, single-process or per host.

Layout: ``<dir>/manifest.json`` and one ``.npy`` per leaf. The manifest
holds the tree's skeleton (dict keys sorted, the order ``jax.tree_util``
flattens in), each leaf's ``/``-joined path, file, dtype, shape and its
``spec`` (the placed leaf's PartitionSpec as JSON, ``null`` for a whole
leaf), and every file's checksum (``resilience.integrity``). A
``COMMITTED`` marker carrying the manifest's checksum and the
``process_count`` is written last into ``<dir>.tmp``, and only then is
the step published by an atomic rename, through a ``<dir>.old`` swap
when a step of that name exists. bfloat16 and float8 leaves are stored
as a same-width unsigned view named by the dtype, as the JAX package
stores them (the port views through torch; no ``ml_dtypes``).

Per host. A placed leaf (a plan's shard, parallel/sharding.py) is
written as one ``.npy`` per shard region, ``<leaf>.shard_<starts>.npy``
with the starts ``_``-joined as the JAX package names them, and the
manifest lists every region with its start and shape. Every rank
derives the same region list from the leaf's sharding, and of the ranks
that hold a region the one at coordinate 0 on every axis the spec does
not split writes it, so each region is written once. Whole leaves and
the manifest are rank 0's; the other ranks' checksums go to
``checksums.<rank>.json`` sidecars. The ranks meet at three barriers
(staging dir made, every file written, step renamed) on the process
group's store (a key barrier that names the missing ranks and fails at
once for a rank the launcher marked dead), or on files beside the
target when there is no store, never on a device collective: the writer
thread runs while the step's collectives use the group.

``save_state`` copies what the rank writes into fresh host memory before
it returns (CUDA leaves by one batched copy into pinned buffers on a
side stream, waited on; CPU leaves cloned, since ``.numpy()`` would
alias live storage), so the caller may update its parameters in place
at once; with ``async_save`` the file I/O and the barriers run on a
thread. ``restore_state`` returns CPU tensors: whole leaves, or with
``mesh=``/``shardings=`` each rank's shard under the leaf's saved spec
re-applied to the mesh (an axis the mesh lacks replicates) or under the
given sharding, read from the regions that overlap it; a restored shard
carries its sharding as ``_pt_sharding`` and its whole shape as
``_pt_global_shape``. ``CheckpointManager(coordinator=)`` makes each
periodic save a fleet transaction: a step is restore-worthy for the
fleet once every live rank staged it and its ``GLOBAL_COMMITTED``
marker landed. The JAX package's checkpoint instruments are not ported
yet (ROADMAP queue 1 entry 7's second half); :data:`WRITTEN` counts the
bytes and files this process wrote."""

from __future__ import annotations

import io
import json
import math
import os
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core.enforce import EnforceError, enforce
from .core.mesh import _world, get_mesh
from .core.sharding_types import NamedSharding, PartitionSpec as P, _axes
from .resilience import faults as _faults
from .resilience.controller import (_KV_POLICY, BarrierTimeoutError,
                                    ClientTransport, ENV_FLEET_DIR,
                                    ENV_RUN_ID, FileTransport,
                                    active as _fleet_active,
                                    coordination_client,
                                    note_barrier_timeout)
from .resilience.integrity import ChecksumError, checksum_bytes, verify_bytes
from .resilience.retry import retry_io
from .utils.atomic import atomic_write_bytes, atomic_write_text

_FORMAT = "paddle_tpu_ckpt/v1"
_MANIFEST = "manifest.json"
# written last into the staging dir: its presence in a published step
# certifies every byte above it (a torn copy lacks it; restore skips it)
_COMMITTED = "COMMITTED"
# the fleet's commit marker (a manager with a coordinator): present once
# every live rank staged the step; never written by one process alone
_GLOBAL = "GLOBAL_COMMITTED"

# dtypes the .npy format cannot hold, as (same-width view in torch, in
# numpy), by the name the manifest records
_EXOTIC = {"bfloat16": (torch.int16, np.uint16),
           "float8_e4m3fn": (torch.uint8, np.uint8),
           "float8_e5m2": (torch.uint8, np.uint8)}
_TORCH_EXOTIC = {getattr(torch, name): name for name in _EXOTIC}

# payload bytes and files this process wrote (every save, every rank)
WRITTEN = {"bytes": 0, "files": 0}


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


# --- placed leaves: specs and shard regions ---------------------------------

def _split(leaf) -> Optional[NamedSharding]:
    """The sharding of a placed leaf that splits it over more than one
    rank; None for a whole leaf or a spec over axes of one rank."""
    sh = getattr(leaf, "_pt_sharding", None)
    if sh is None or not torch.is_tensor(leaf):
        return None
    axes = sh.axes()
    return sh if axes and sh.mesh.axis_size(axes) > 1 else None


def _spec_of(leaf) -> Optional[List[Any]]:
    """A placed leaf's PartitionSpec as JSON (None, an axis name or a
    list of names per dim); None for a whole leaf."""
    sh = getattr(leaf, "_pt_sharding", None)
    if sh is None:
        return None
    return [None if ax is None else list(ax) if isinstance(ax, tuple)
            else str(ax) for ax in sh.spec]


def _spec_from(spec_json, mesh) -> Optional[P]:
    """The saved spec on ``mesh``; None when it names an axis the mesh
    lacks (the leaf then restores replicated)."""
    if spec_json is None:
        return None
    axes = []
    for ax in spec_json:
        names = [ax] if isinstance(ax, str) else (ax or [])
        if not all(a in mesh.shape for a in names):
            return None
        axes.append(tuple(ax) if isinstance(ax, list) else ax)
    return P(*axes)


def _window_at(sh: NamedSharding, shape, coord) -> List[tuple]:
    """[(start, stop)] per dim of the shard that the rank at mesh
    coordinate ``coord`` holds under ``sh`` (``NamedSharding.index`` for
    any rank)."""
    out = []
    for dim, n in enumerate(shape):
        part = sh.spec[dim] if dim < len(sh.spec) else None
        if part is None:
            out.append((0, n))
            continue
        k, i = sh.mesh.axis_size(part), 0
        for a in _axes(part):
            i = i * sh.mesh.shape[a] + coord[a]
        out.append((i * (n // k), (i + 1) * (n // k)))
    return out


def _shard_regions(sh: NamedSharding, shape):
    """[(region key, starts, shape)] of the leaf's distinct shard
    regions, sorted by start: the same list on every rank (it comes from
    the sharding alone)."""
    regions = {}
    mesh = sh.mesh
    for idx in np.ndindex(*mesh.devices.shape):
        win = _window_at(sh, shape, dict(zip(mesh.axis_names, idx)))
        starts = tuple(lo for lo, _ in win)
        regions.setdefault(starts, tuple(hi - lo for lo, hi in win))
    return [("_".join(map(str, k)), list(k), list(v))
            for k, v in sorted(regions.items())]


def _region_key(sh: NamedSharding, shape) -> Optional[str]:
    """The key of the region this rank writes, or None when a peer
    writes it: of the ranks that hold a region, the one at coordinate 0
    on every mesh axis the spec does not split."""
    split = set(sh.axes())
    mesh = sh.mesh
    if any(mesh.coordinate[a] for a in mesh.axis_names if a not in split):
        return None
    return "_".join(str(lo) for lo, _ in
                    _window_at(sh, shape, mesh.coordinate))


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        name = _TORCH_EXOTIC.get(x.dtype)
        if name is not None:
            return name
        return str(torch.empty(0, dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


def _shape_of(x) -> List[int]:
    return list(x.shape) if torch.is_tensor(x) else list(np.shape(x))


# --- barriers ----------------------------------------------------------------

_barrier_counts: Dict[str, int] = {}
# the last barrier's latency and tag, and this process's barrier timeouts
# (the controller's statusz reads them)
_BARRIER_STATS: Dict[str, Any] = {"last_latency_s": None,
                                  "last_tag": None, "timeouts": 0}
_BARRIER_SUBDIR = ".pt_barrier"
_RUN_START = time.time()  # the stale-barrier sweep's boundary
_swept_barrier_roots: Dict[str, float] = {}
_BARRIER_TIMEOUT_S = 300.0
_SWEEP_INTERVAL_S = 300.0
_STALE_BARRIER_AGE_S = 60.0
_WRITTEN_LOCK = threading.Lock()


def barrier_stats() -> Dict[str, Any]:
    """The last coordination barrier's latency and tag and this
    process's barrier-timeout count."""
    return dict(_BARRIER_STATS)


def _barrier_root(directory: str) -> str:
    """The file barrier's rendezvous directory, beside the target."""
    parent = os.path.dirname(os.path.abspath(directory))
    return os.path.join(parent, _BARRIER_SUBDIR)


def _sweep_stale_barriers(root: str, now: Optional[float] = None) -> int:
    """Remove rendezvous files of dead runs (every run restarts its
    per-directory sequence at 1, so a dead run's ``<tag>.<rank>`` would
    read as an arrival): files older than this process's start and at
    least ``_STALE_BARRIER_AGE_S`` old, or older than twice the barrier
    timeout plus a minute. Once per root every ``_SWEEP_INTERVAL_S``; a
    live rank re-publishes a file swept by mistake. Returns the count
    removed."""
    t = time.time() if now is None else now
    last = _swept_barrier_roots.get(root)
    if last is not None and t - last < _SWEEP_INTERVAL_S:
        return 0
    _swept_barrier_roots[root] = t
    cutoff = min(_RUN_START, t - _STALE_BARRIER_AGE_S)
    dead_by_timeout = t - (_BARRIER_TIMEOUT_S * 2 + 60.0)
    removed = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        path = os.path.join(root, name)
        try:
            mtime = os.path.getmtime(path)
            if mtime < cutoff or mtime < dead_by_timeout:
                os.unlink(path)
                removed += 1
        except OSError:
            pass  # a peer swept it first
    return removed


def _file_barrier(directory: str, tag: str, *,
                  rank: Optional[int] = None,
                  world: Optional[int] = None,
                  timeout_s: float = 300.0,
                  poll_s: float = 0.01) -> None:
    """The shared-filesystem barrier (no store): each rank publishes
    ``<root>/<tag>.<rank>`` and polls until all ``world`` exist; expiry
    raises :class:`BarrierTimeoutError` naming the missing ranks. The
    files stay until the sequence after next (``_next_barrier_prefix``)
    or a later run's sweep."""
    root = _barrier_root(directory)
    _sweep_stale_barriers(root)
    os.makedirs(root, exist_ok=True)
    r0, w0 = _world()
    rank = r0 if rank is None else rank
    world = w0 if world is None else world
    mine = os.path.join(root, f"{tag}.{rank}")
    atomic_write_text(mine, "1")
    deadline = time.monotonic() + timeout_s
    while True:
        present = sum(
            os.path.exists(os.path.join(root, f"{tag}.{r}"))
            for r in range(world))
        if present >= world:
            return
        if not os.path.exists(mine):
            atomic_write_text(mine, "1")  # a peer swept it: re-publish
        if time.monotonic() >= deadline:
            missing = [r for r in range(world) if not os.path.exists(
                os.path.join(root, f"{tag}.{r}"))]
            _BARRIER_STATS["timeouts"] += 1
            note_barrier_timeout()
            raise BarrierTimeoutError(tag, missing=missing, world=world,
                                      timeout_s=timeout_s)
        time.sleep(poll_s)


def _client_kv_barrier(client, tag: str, *, timeout_s: float,
                       poll_s: float = 0.02) -> None:
    """A barrier over the store's keys: each rank publishes an arrival
    key (retried under the transport policy) and polls for its peers',
    so an expiry names the ranks that never arrived. A rank the launcher
    marked dead fails the save at once: its regions can never arrive,
    and committing without them would publish a torn step."""
    rank, world = _world()
    kv = ClientTransport(client, "ckptbar")
    retry_io(lambda: kv.put(f"{tag}.{rank}", "1"), policy=_KV_POLICY,
             what="ckpt.barrier")

    def is_dead(r: int) -> bool:
        # the launcher's markers, through the active controller or
        # straight from the launcher's file root
        ctl = _fleet_active()
        if ctl is not None:
            return ctl._marker(f"dead.{r}") is not None
        root = os.environ.get(ENV_FLEET_DIR)
        if not root:
            return False
        run_id = os.environ.get(ENV_RUN_ID) or "r0"
        return FileTransport(root, run_id).get(f"dead.{r}") is not None

    deadline = time.monotonic() + timeout_s
    while True:
        missing = [r for r in range(world)
                   if r != rank and kv.get(f"{tag}.{r}") is None]
        if not missing:
            return
        dead = [r for r in missing if is_dead(r)]
        if dead or time.monotonic() >= deadline:
            _BARRIER_STATS["timeouts"] += 1
            note_barrier_timeout()
            raise BarrierTimeoutError(
                tag, missing=missing, world=world, timeout_s=timeout_s,
                detail=(f"rank(s) {dead} died mid-save" if dead
                        else None))
        time.sleep(poll_s)


def _barrier(tag: str, directory: str) -> None:
    """The ranks' barrier for a save: on the process group's store, or
    on files beside ``directory`` without one; a no-op for one process.
    A timeout raises :class:`BarrierTimeoutError` naming the missing
    ranks."""
    if _world()[1] <= 1:
        return
    client = coordination_client()
    t0 = time.monotonic()
    try:
        if client is None:
            _file_barrier(directory, tag)
        else:
            _client_kv_barrier(client, tag, timeout_s=_BARRIER_TIMEOUT_S)
    finally:
        _BARRIER_STATS["last_latency_s"] = round(time.monotonic() - t0, 4)
        _BARRIER_STATS["last_tag"] = tag


def _next_barrier_prefix(directory: str) -> str:
    """``ckpt_<crc32 of the target>_<n>``: the n-th save to this target
    by this process. Keyed by target, so a rank that skipped one save
    desyncs only that target's barriers. Entering sequence n proves every
    rank left n - 2: its file-barrier files go."""
    n = _barrier_counts.get(directory, 0) + 1
    _barrier_counts[directory] = n
    crc = zlib.crc32(directory.encode()) & 0xffffffff
    if n > 2:
        root = _barrier_root(directory)
        stale = f"ckpt_{crc:08x}_{n - 2}_"
        try:
            for name in os.listdir(root):
                if name.startswith(stale):
                    try:
                        os.unlink(os.path.join(root, name))
                    except OSError:
                        pass
        except OSError:
            pass
    return f"ckpt_{crc:08x}_{n}"


# --- save and restore ----------------------------------------------------------

def save_state(directory: str, tree, *, async_save: bool = False,
               per_host: Optional[bool] = None):
    """Write ``tree`` (dicts, lists, tuples and None over tensors, numpy
    arrays and numbers) as a checkpoint at ``directory``. What this rank
    writes is copied to owned host memory before this returns; with
    ``async_save`` the files are written on a thread and the returned
    handle's ``.join()`` waits and re-raises a failed write. Namedtuples
    come back as tuples; any other container raises.

    In a process group every rank calls this with the same tree
    skeleton. A placed leaf that splits over more than one rank is
    written per host, one file per shard region: that is automatic, and
    ``per_host`` (the JAX package's switch for addressable leaves, which
    the port's ranks never hold whole) changes nothing. A placed leaf of
    a mesh with no process group behind it (a layout only) raises: its
    other regions have no rank to write them."""
    flat = _flatten(tree)
    counter = [0]
    skel = _skeleton(tree, counter)
    enforce(counter[0] == len(flat), "skeleton and leaves disagree")
    rank, world = _world()
    rank0 = rank == 0
    entries, todo, seen = [], [], set()
    for path, leaf in flat:
        base = _sanitize(path)
        enforce(base not in seen, "leaf path collision on %s", base)
        seen.add(base)
        sh = _split(leaf)
        if sh is None:
            entries.append({"path": path, "file": base + ".npy",
                            "dtype": _dtype_name(leaf),
                            "shape": _shape_of(leaf),
                            "spec": _spec_of(leaf)})
            if rank0:
                todo.append((base + ".npy", leaf))
            continue
        enforce(world > 1, "leaf %s is a shard over %s ranks of a mesh "
                "with no process group (a layout only): no rank would "
                "write its other regions", path,
                sh.mesh.axis_size(sh.axes()))
        shape = tuple(leaf._pt_global_shape)
        entries.append({
            "path": path, "dtype": _dtype_name(leaf), "shape": list(shape),
            "spec": _spec_of(leaf),
            "shards": [{"file": f"{base}.shard_{key}.npy", "start": starts,
                        "shape": rshape}
                       for key, starts, rshape in _shard_regions(sh, shape)]})
        key = _region_key(sh, shape)
        if key is not None:
            todo.append((f"{base}.shard_{key}.npy", leaf))
    payload = [(fname, _to_numpy(host)[0]) for (fname, _), host in
               zip(todo, _snapshot([x for _, x in todo]))]
    multi = world > 1
    bprefix = _next_barrier_prefix(directory) if multi else None

    def write():
        inj = _faults.active()
        tmp = directory + ".tmp"
        if rank0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        if multi:
            _barrier(f"{bprefix}_staged", directory)  # the tmp dir exists
        checksums: Dict[str, str] = {}
        for fname, arr in payload:
            data = _npy_bytes(arr)
            # the true bytes' checksum, before an injected corruption
            checksums[fname] = checksum_bytes(data)
            _write_resilient(os.path.join(tmp, fname), data, "ckpt.write",
                             inj)
            with _WRITTEN_LOCK:
                WRITTEN["bytes"] += arr.nbytes
                WRITTEN["files"] += 1
        if rank0:
            text = json.dumps({"format": _FORMAT, "skeleton": skel,
                               "leaves": entries, "checksums": checksums})
            _write_resilient(os.path.join(tmp, _MANIFEST), text.encode(),
                             "ckpt.manifest", inj)
        elif checksums:
            # rank 0 cannot know these without a gather: a sidecar the
            # restore merges with the manifest's map
            _write_resilient(os.path.join(tmp, f"checksums.{rank}.json"),
                             json.dumps(checksums).encode(), "ckpt.write",
                             inj)
        if multi:
            _barrier(f"{bprefix}_written", directory)  # all on disk
        if rank0:
            retry_io(lambda: atomic_write_text(
                os.path.join(tmp, _COMMITTED),
                json.dumps({"format": _FORMAT,
                            "manifest_checksum": checksum_bytes(
                                text.encode()),
                            "process_count": world})), what="ckpt.commit")
            enforce(not os.path.exists(directory)
                    or os.path.isdir(directory),
                    "checkpoint target %s exists and is not a directory",
                    directory)

            def publish():
                # re-entrant on retry; the live step is never deleted
                # before the new one is in place: a kill mid-swap leaves
                # it as .old
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
        if multi:
            _barrier(f"{bprefix}_renamed", directory)  # visible to all

    if async_save:
        return _WriteHandle(write, directory=directory)
    write()
    return None


def _torch_dtype(x) -> torch.dtype:
    if torch.is_tensor(x):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def _global_shape(x) -> tuple:
    shape = getattr(x, "_pt_global_shape", None)
    return tuple(shape) if shape is not None else tuple(x.shape)


def _flatten_shardings(tree, path=(), out=None):
    """[(path, sharding)] of a shardings tree, whose leaves are
    ``NamedSharding`` or ``PartitionSpec`` (None: no override)."""
    out = [] if out is None else out
    if tree is None:
        return out
    if isinstance(tree, (NamedSharding, P)):
        out.append(("/".join(path) or "_root", tree))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_shardings(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_shardings(v, path + (str(i),), out)
    else:
        raise EnforceError(f"shardings leaf of type {type(tree).__name__} "
                           f"at {'/'.join(path) or '_root'}: give "
                           f"NamedSharding or PartitionSpec leaves")
    return out


def restore_state(directory: str, *, mesh=None, shardings=None, target=None,
                  verify: bool = True):
    """Read a checkpoint back as a tree of CPU tensors (0-dim for
    scalars), of either package, written by one process or per host.

    - No ``mesh`` and no ``shardings``: every leaf whole.
    - ``shardings``: a tree matching the saved one whose leaves are
      ``NamedSharding`` (or ``PartitionSpec``, on ``mesh`` or the
      current mesh): each such leaf comes back as this rank's shard
      under it, read from the regions (or the whole file) overlapping
      it. A None leaf, or a path the tree lacks, falls to the next rule.
    - ``mesh``: each leaf's saved spec re-applied to ``mesh`` when the
      mesh has every axis it names, else the leaf comes back whole
      (replicated): a state saved under one plan restores under
      another.

    A shard carries ``_pt_sharding`` and ``_pt_global_shape``.
    ``target``: a tree whose leaves' (whole) shapes and dtypes the
    restored ones must match, by path (leaves without a shape, as
    Python ints, are not checked). ``verify``: check every file read
    against the manifest's and sidecars' checksums and the manifest
    against the ``COMMITTED`` marker's; a torn or bit-flipped file
    raises :class:`ChecksumError`. A checkpoint written before checksums
    restores unverified. Reads retry under the transient-I/O policy."""
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
    if verify:
        for name in sorted(os.listdir(directory)):
            if name.startswith("checksums.") and name.endswith(".json"):
                try:
                    checksums.update(json.loads(_read_resilient(
                        os.path.join(directory, name), inj)))
                except ValueError as e:
                    raise ChecksumError(f"{name}: torn checksum sidecar "
                                        f"({e})") from e
    override = (dict(_flatten_shardings(shardings))
                if shardings is not None else None)

    def load(fname: str) -> np.ndarray:
        path = os.path.join(directory, fname)
        raw = _read_resilient(path, inj)
        tag = checksums.get(fname)
        if verify and tag is not None:
            verify_bytes(raw, tag, name=path)
        return _parse_npy(raw, path)

    def assemble(e, window) -> np.ndarray:
        """The ``window`` [(start, stop)] of a per-host leaf, reading
        only the region files that overlap it."""
        view = _EXOTIC.get(e["dtype"])
        out = np.empty(tuple(hi - lo for lo, hi in window),
                       view[1] if view else np.dtype(e["dtype"]))
        for rec in e["shards"]:
            src, dst = [], []
            for (lo, hi), r0, rn in zip(window, rec["start"], rec["shape"]):
                a, b = max(lo, r0), min(hi, r0 + rn)
                if a >= b:
                    break
                src.append(slice(a - r0, b - r0))
                dst.append(slice(a - lo, b - lo))
            else:
                out[tuple(dst)] = load(rec["file"])[tuple(src)]
        return out

    leaves = []
    for e in manifest["leaves"]:
        shape = tuple(e["shape"])
        sh = None
        if override is not None and e["path"] in override:
            sh = override[e["path"]]
            if isinstance(sh, P):
                sh = NamedSharding(mesh or get_mesh(), sh)
        elif mesh is not None:
            spec = _spec_from(e["spec"], mesh)
            if spec is not None:
                sh = NamedSharding(mesh, spec)
        if sh is not None and not sh.axes():
            sh = None
        window = ([(0, n) for n in shape] if sh is None else
                  [(s.start or 0, n if s.stop is None else s.stop)
                   for s, n in zip(sh.index(shape), shape)])
        if "shards" in e:
            arr = assemble(e, window)
        else:
            arr = load(e["file"])
            if sh is not None:
                arr = np.ascontiguousarray(
                    arr[tuple(slice(lo, hi) for lo, hi in window)])
        leaf = _from_numpy(arr, e["dtype"])
        if sh is not None:
            leaf._pt_sharding = sh
            leaf._pt_global_shape = shape
        leaves.append(leaf)
    tree = _unskeleton(manifest["skeleton"], leaves)
    if target is not None:
        tmap = dict(_flatten(target))
        for path, leaf in _flatten(tree):
            want = tmap.get(path)
            if want is None or not hasattr(want, "shape"):
                continue
            enforce(_global_shape(want) == _global_shape(leaf),
                    "checkpoint leaf %s shape %s != target %s", path,
                    _global_shape(leaf), _global_shape(want))
            enforce(_torch_dtype(want) == leaf.dtype,
                    "checkpoint leaf %s dtype %s != target %s", path,
                    leaf.dtype, _torch_dtype(want))
    return tree


class CheckpointManager:
    """Step-numbered checkpoints under ``directory`` (``step_<N>``) with
    retention: ``max_to_keep`` committed steps survive. ``save``
    snapshots at once and writes on a thread by default;
    ``wait_until_finished`` joins the writes (call it before exit).

    ``coordinator`` (a :class:`resilience.FleetController`, which
    ``TrainLoop.run(controller=)`` attaches) makes every periodic save a
    fleet transaction, all ranks save step N or none: the local write is
    the stage, the rank publishes ``staged`` on the transport, and the
    step becomes the fleet's once every live rank staged it and the
    global commit landed, mirrored as the step's ``GLOBAL_COMMITTED``
    file (the transport dies with the job; the file is what a restarted
    fleet trusts). Restore and retention then consult globally committed
    steps only, so no rank prunes the step a peer is still staging. With
    no coordinator, or a world of one, every path is the single-process
    manager's."""

    _STEP_RE = re.compile(r"^step_(\d+)$")
    # errors that mean "this step's bytes are bad", where the previous
    # committed step is worth a try; EnforceError (config, shapes) would
    # fail the same on every step and propagates
    _FALLBACK_ERRORS = (ChecksumError, OSError, ValueError, KeyError)

    def __init__(self, directory: str, max_to_keep: int = 5,
                 async_save: bool = True, coordinator=None):
        enforce(max_to_keep >= 1, "max_to_keep must be >= 1, got %s",
                max_to_keep)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.coordinator = coordinator
        self._pending: List[_WriteHandle] = []
        self.last_restored_step: Optional[int] = None
        self.last_commit_barrier_s: Optional[float] = None
        os.makedirs(directory, exist_ok=True)

    def _coord(self):
        """The coordinator when it can coordinate (a world of more than
        one rank with a transport), else None."""
        c = self.coordinator
        if c is None or getattr(c, "world", 1) <= 1 or \
                getattr(c, "transport", None) is None:
            return None
        return c

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

    def globally_committed_steps(self) -> List[int]:
        """Committed steps that also carry ``GLOBAL_COMMITTED``: those the
        whole fleet finished saving."""
        return [s for s in self.committed_steps()
                if os.path.exists(os.path.join(self._step_dir(s), _GLOBAL))]

    def promote_global(self, step: int) -> None:
        """Mark ``step`` globally committed: the restore agreement found
        it on every live rank, the evidence the save-time marker records
        (a crash between the staging and the marker must not demote the
        step for good)."""
        d = self._step_dir(step)
        if os.path.isdir(d) and not os.path.exists(os.path.join(d, _GLOBAL)):
            retry_io(lambda: atomic_write_text(
                os.path.join(d, _GLOBAL),
                json.dumps({"step": int(step), "promoted": True})),
                what="ckpt.commit")

    def align_global(self, agreed: Optional[int]) -> None:
        """Reconcile the durable markers with the fleet's restore
        agreement: promote ``agreed`` and demote every marker above it
        (all of them on a cold start). A dead attempt's later marker
        would otherwise set the fleet GC's floor and prune this run's
        fresh commits; demoted steps keep their data."""
        for s in self.globally_committed_steps():
            if agreed is None or s > agreed:
                try:
                    os.unlink(os.path.join(self._step_dir(s), _GLOBAL))
                except OSError:
                    pass
        if agreed is not None:
            self.promote_global(agreed)

    def latest_step(self) -> Optional[int]:
        """The newest committed step (globally committed, with a
        coordinator)."""
        steps = (self.globally_committed_steps()
                 if self._coord() is not None else self.committed_steps())
        return steps[-1] if steps else None

    def save(self, step: int, tree, *, coordinate: bool = True) -> None:
        """Snapshot ``tree`` now and write it as ``step`` (on a thread
        with ``async_save``); a write still in flight to the same step is
        joined first. With a coordinator and ``coordinate`` the stage is
        followed by the global commit (on the writer thread when async;
        an expired commit surfaces as :class:`BarrierTimeoutError` at the
        next join). ``coordinate=False`` stages only: the clean-exit
        save, since ranks may finish at different steps."""
        target = self._step_dir(step)
        still = []
        for t in self._pending:
            if t.directory == target:
                t.join()
            else:
                still.append(t)
        self._pending = still
        coord = self._coord() if coordinate else None
        if coord is None:
            handle = save_state(target, tree, async_save=self.async_save)
            if isinstance(handle, _WriteHandle):
                self._pending.append(handle)
            self._gc()
            return
        if self.async_save:
            inner = save_state(target, tree, async_save=True)

            def commit_after():
                inner.join()  # the stage on disk (re-raises I/O errors)
                self._global_commit(step, coord)

            self._pending.append(_WriteHandle(commit_after,
                                              directory=target))
        else:
            save_state(target, tree, async_save=False)
            self._global_commit(step, coord)
        self._gc()

    def _global_commit(self, step: int, coord) -> None:
        """After the local stage: publish ``staged``, hold for every live
        rank's, land the global marker, mirror it into the step dir. The
        ``ckpt.stage`` and ``ckpt.commit`` injection points bracket the
        two phases."""
        inj = _faults.active()
        if inj is not None:
            inj.fire("ckpt.stage", path=self._step_dir(step))
        t0 = time.perf_counter()
        coord.note_stage(step)
        if coord.wait_global_commit(step) is None:
            return  # deferred to a preempt agreement in flight
        if inj is not None:
            inj.fire("ckpt.commit", path=self._step_dir(step))
        retry_io(lambda: atomic_write_text(
            os.path.join(self._step_dir(step), _GLOBAL),
            json.dumps({"step": int(step), "world": coord.world,
                        "run_id": coord.run_id})), what="ckpt.commit")
        self.last_commit_barrier_s = time.perf_counter() - t0

    def restore(self, step: Optional[int] = None, *, mesh=None,
                shardings=None, target=None):
        """Restore ``step`` (exactly that step: integrity errors
        propagate) or, with ``step=None``, the newest committed step
        (globally committed, with a coordinator) that verifies: a torn or
        corrupt newer step is reported on stderr and the next older one
        is tried. ``last_restored_step`` records what was restored."""
        self.wait_until_finished()
        if step is not None:
            tree = restore_state(self._step_dir(step), mesh=mesh,
                                 shardings=shardings, target=target)
            self.last_restored_step = step
            return tree
        steps = (self.globally_committed_steps()
                 if self._coord() is not None else self.committed_steps())
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
        ``wait_until_finished`` re-raises them. With a coordinator,
        :meth:`_gc_fleet`."""
        self._pending = [t for t in self._pending
                         if not t.done() or t._exc is not None]
        if self._coord() is not None:
            self._gc_fleet()
            return
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
                self._recover_old(full)
                continue
            base = name[:-len(".tmp")] if name.endswith(".tmp") else name
            m = self._STEP_RE.match(base)
            if (m and newest is not None and int(m.group(1)) < newest
                    and os.path.join(self.directory, base) not in pending
                    and not self._is_committed(base)):
                shutil.rmtree(full, ignore_errors=True)

    @staticmethod
    def _recover_old(full: str) -> None:
        """A ``step_N.old`` trash dir: superseded when ``step_N`` exists,
        else the step's only copy (a kill mid-swap), put back."""
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

    def _gc_fleet(self) -> None:
        """Fleet retention: a step goes only when strictly older than the
        newest globally committed step and outside the newest
        ``max_to_keep`` of them; with none, nothing goes (a step at or
        above the floor may be the fleet's next common restore point)."""
        gsteps = self.globally_committed_steps()
        if not gsteps:
            return
        newest = gsteps[-1]
        protected = set(gsteps[-self.max_to_keep:])
        pending = {t.directory for t in self._pending
                   if t.directory is not None}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            base = name
            for suf in (".tmp", ".old"):
                if name.endswith(suf):
                    base = name[:-len(suf)]
                    break
            m = self._STEP_RE.match(base)
            if not m:
                continue
            full = os.path.join(self.directory, name)
            if name.endswith(".old"):
                self._recover_old(full)
                continue
            s = int(m.group(1))
            if s >= newest or s in protected or \
                    os.path.join(self.directory, base) in pending:
                continue
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
