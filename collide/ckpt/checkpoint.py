"""Checkpoint/restore — the disaster-recovery story (SURVEY.md §5).

The reference's reliability stack (BackupManager JSON snapshots with keep-5
retention, disaster_recovery.py:92-245; StateTransferManager node-to-node
pulls, :267-519; ReplicationManager leader re-broadcast,
high_availability.py:614-895) reduces here to: periodically snapshot the
device state pytree to disk, resume from the latest snapshot after any
failure. One mechanism covers backup, replication and state transfer.

Format: one directory per checkpoint (`ckpt_<step>/`) holding `state.npz`
(every array leaf) + `meta.json` (step, timestamp, config echo, user
metadata) — np-based so checkpoints are portable and inspectable; writes go
through a temp dir + atomic rename so a crash mid-write never corrupts the
latest checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import numpy as np

from collide.core.state import ObjectState
from collide.core.utils import get_logger

logger = get_logger(__name__)

_FIELDS = ("pos", "vel", "acc", "heading", "size", "otype", "alive", "oid")


class CheckpointManager:
    """Snapshot/restore the fleet state with keep-last retention
    (reference keep-5 cleanup, disaster_recovery.py:231-245)."""

    def __init__(self, directory: str, keep_last: int = 5):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self.stats = {"saved": 0, "restored": 0, "cleaned": 0,
                      "async_saves": 0}
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        # save/cleanup touch the same directory from the async thread and
        # the caller; serialize the filesystem mutations
        self._fs_lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}")

    def save(self, state: ObjectState, step: int,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Blocking snapshot. Device -> host copy happens here; callers on a
        hot loop should snapshot every K steps, not every step — or use
        save_async, which overlaps the transfer+compress with stepping."""
        arrays = {f: np.asarray(jax.device_get(getattr(state, f)))
                  for f in _FIELDS}
        return self._write(arrays, step, metadata)

    def _write(self, arrays: Dict[str, np.ndarray], step: int,
               metadata: Optional[Dict[str, Any]]) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        with self._fs_lock:
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "state.npz"), **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as fh:
                json.dump({"step": step, "timestamp": time.time(),
                           "num_objects": int(arrays["alive"].sum()),
                           "capacity": int(arrays["alive"].shape[0]),
                           "metadata": metadata or {}}, fh)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self.stats["saved"] += 1
            self._cleanup()
        return final

    def save_async(self, state: ObjectState, step: int,
                   metadata: Optional[Dict[str, Any]] = None,
                   transfer_lock=None) -> threading.Thread:
        """Non-blocking snapshot (the orbax-style async
        SURVEY §7.6 planned): takes a DEVICE-SIDE copy of the state
        synchronously (cheap on-device copy, so later donation/mutation of the
        live state cannot race the snapshot), then moves the device->host
        transfer + npz compression + atomic rename to a background thread.
        The step loop stalls only for the device copy.

        transfer_lock: when given, the worker's device->host transfer
        acquires it — the Scene facades pass their device lock so the read
        never overlaps a donating step dispatch (concurrent reads +
        donation wedge some backends, CLAUDE.md; compression + IO — the
        bulk of a compressed snapshot's wall time — still overlap).

        One async save in flight at a time: a second call joins the
        previous one first. Returns the thread (join() to wait);
        wait_async() re-raises any background failure."""
        self.wait_async()
        # device-side copy pinned before any subsequent donation: jnp ops
        # enqueue in order, and device_get of `snap` in the worker reads
        # this copy, never the live buffers
        snap = jax.tree.map(jax.numpy.copy,
                            {f: getattr(state, f) for f in _FIELDS})

        def worker():
            try:
                if transfer_lock is not None:
                    with transfer_lock:
                        arrays = {f: np.asarray(jax.device_get(v))
                                  for f, v in snap.items()}
                else:
                    arrays = {f: np.asarray(jax.device_get(v))
                              for f, v in snap.items()}
                self._write(arrays, step, metadata)
                self.stats["async_saves"] += 1
            except BaseException as e:          # surfaced by wait_async
                self._async_error = e

        t = threading.Thread(target=worker, name=f"ckpt-async-{step}",
                             daemon=True)
        self._async_thread = t
        t.start()
        return t

    def wait_async(self) -> None:
        """Join any in-flight async save; re-raise its failure if any."""
        t = self._async_thread
        if t is not None:
            t.join()
            self._async_thread = None
        if self._async_error is not None:
            e, self._async_error = self._async_error, None
            raise e

    def _cleanup(self) -> None:
        ckpts = self.list_checkpoints()
        for step in ckpts[:-self.keep_last]:
            shutil.rmtree(self._path(step), ignore_errors=True)
            self.stats["cleaned"] += 1

    def list_checkpoints(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ck = self.list_checkpoints()
        return ck[-1] if ck else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[ObjectState, Dict[str, Any]]:
        """Load a checkpoint (latest by default) as a host-resident
        ObjectState + its metadata. Put it on device / distribute it over a
        mesh afterwards (shard.distribute_state)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with np.load(os.path.join(path, "state.npz")) as z:
            state = ObjectState(**{f: jax.numpy.asarray(z[f])
                                   for f in _FIELDS})
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        self.stats["restored"] += 1
        return state, meta

    def delete(self, step: int) -> bool:
        p = self._path(step)
        if os.path.exists(p):
            shutil.rmtree(p)
            return True
        return False


class BackupManager:
    """Host-component backups: registered (get_state, apply_state) sources
    dumped to JSON (reference disaster_recovery.py:18-264 — same shape,
    minus the uuid dirs: backups are named by timestamp for sortability)."""

    def __init__(self, backup_dir: str, keep_last: int = 5):
        self.backup_dir = backup_dir
        self.keep_last = keep_last
        os.makedirs(backup_dir, exist_ok=True)
        self._sources: Dict[str, Tuple[Callable[[], Any],
                                       Callable[[Any], None]]] = {}

    def register_source(self, name: str, get_state: Callable[[], Any],
                        apply_state: Callable[[Any], None]) -> None:
        self._sources[name] = (get_state, apply_state)

    def create_backup(self) -> str:
        stamp = time.strftime("%Y%m%d_%H%M%S") + f"_{int(time.time_ns() % 1e6):06d}"
        path = os.path.join(self.backup_dir, f"backup_{stamp}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for name, (get_state, _) in self._sources.items():
            fname = f"{name}.json"
            with open(os.path.join(tmp, fname), "w") as fh:
                json.dump(get_state(), fh, default=str)
            manifest[name] = fname
        with open(os.path.join(tmp, "metadata.json"), "w") as fh:
            json.dump({"timestamp": time.time(), "sources": manifest}, fh)
        os.rename(tmp, path)
        self._cleanup()
        return path

    def restore_backup(self, path: Optional[str] = None) -> List[str]:
        if path is None:
            backups = self.list_backups()
            if not backups:
                raise FileNotFoundError(f"no backups in {self.backup_dir}")
            path = backups[-1]
        with open(os.path.join(path, "metadata.json")) as fh:
            manifest = json.load(fh)["sources"]
        restored = []
        for name, fname in manifest.items():
            if name in self._sources:
                with open(os.path.join(path, fname)) as fh:
                    self._sources[name][1](json.load(fh))
                restored.append(name)
        return restored

    def list_backups(self) -> List[str]:
        return sorted(os.path.join(self.backup_dir, d)
                      for d in os.listdir(self.backup_dir)
                      if d.startswith("backup_") and not d.endswith(".tmp"))

    def _cleanup(self) -> None:
        for p in self.list_backups()[:-self.keep_last]:
            shutil.rmtree(p, ignore_errors=True)
