"""Async, atomic, self-validating checkpoints of a train state: the port of
``repro.checkpoint.manager`` with the same on-disk layout::

    <dir>/step_00000100.tmp/      # written first, renamed on commit
    <dir>/step_00000100/
        manifest.json             # leaf paths, shapes, dtypes, checksums
        leaf_00000.npy ...        # one file per leaf, in tree order

Leaves are flattened in the reference's order with its path strings
(``tree``), so either package restores the other's checkpoints.  ``save``
copies the state to host memory at once (one synchronising device-to-host
copy per leaf) and writes the files on a background thread.  A sharded
state (DTensor leaves) is gathered whole first, every rank taking part,
and rank 0 writes; ``restore(..., shardings=)`` places each leaf by the
*new* mesh's layouts, so a checkpoint saved on one mesh restores onto
another (elastic re-sharding).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..tree import flatten_with_paths, unflatten_like


def _host_copy(leaf) -> np.ndarray:
    """A host array that no later update of ``leaf`` can change (a DTensor
    gathered whole: every rank must call this)."""
    from ..sharding import is_dtensor
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach()
    a = t.cpu().numpy()
    return a.copy() if t.device.type == 'cpu' else a


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, blocking: bool = False):
        """Snapshot now, write in the background (unless ``blocking``)."""
        self.wait()                                     # one in flight max
        host = [(path, _host_copy(leaf))
                for path, leaf in flatten_with_paths(state)]
        if _rank() != 0:                   # rank 0 writes a sharded state
            return
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()

    def _write_guarded(self, step, leaves):
        try:
            self._write(step, leaves)
        except BaseException as e:                      # raised by wait()
            self._error = e

    def _write(self, step, leaves):
        final = self.dir / f'step_{step:08d}'
        tmp = self.dir / f'step_{step:08d}.tmp'
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {'step': step, 'time': time.time(), 'sharded': False,
                    'leaves': []}
        for i, (path, arr) in enumerate(leaves):
            fname = f'leaf_{i:05d}.npy'
            np.save(tmp / fname, arr)
            manifest['leaves'].append({
                'path': path, 'file': fname, 'shape': list(arr.shape),
                'dtype': str(arr.dtype),
                'sha1': hashlib.sha1(arr.tobytes()).hexdigest()[:16],
            })
        (tmp / 'manifest.json').write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                               # commit point
        self._gc()

    def wait(self):
        """Join the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('async checkpoint write failed') from err

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f'step_{s:08d}', ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(p.name.split('_')[1])
                      for p in self.dir.glob('step_*')
                      if p.is_dir() and not p.name.endswith('.tmp'))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, state_like, step: Optional[int] = None,
                shardings=None, validate: bool = True,
                match_paths: bool = True):
        """Restore into the structure of ``state_like``: each leaf becomes a
        tensor on its target leaf's device (the CPU for a target that is not
        a tensor).  ``shardings``: a tree like ``state_like`` of
        ``sharding.Layout``s (a missing leaf: unplaced) — pass the new
        mesh's layouts to re-shard on restore: each rank keeps its shard of
        each leaf.  ``match_paths`` checks every manifest path against the
        target's, so a structurally different state fails loudly, naming the
        first mismatched leaf; ``validate`` checks the checksums."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {self.dir}')
        d = self.dir / f'step_{step:08d}'
        manifest = json.loads((d / 'manifest.json').read_text())
        pathed = flatten_with_paths(state_like)
        layout = dict(flatten_with_paths(shardings)) if shardings else {}
        if len(manifest['leaves']) != len(pathed):
            raise ValueError(f'checkpoint has {len(manifest["leaves"])} '
                             f'leaves, target has {len(pathed)}')
        out = []
        for i, (meta, (path, target)) in enumerate(zip(manifest['leaves'],
                                                       pathed)):
            if match_paths and meta.get('path') not in (None, path):
                raise ValueError(
                    f'checkpoint/target tree mismatch at leaf {i}: '
                    f'checkpoint has {meta["path"]!r}, target has {path!r}')
            arr = np.load(d / meta['file'])
            if validate and (hashlib.sha1(arr.tobytes()).hexdigest()[:16]
                             != meta['sha1']):
                raise IOError(f'checksum mismatch for {meta["path"]}')
            t = torch.from_numpy(arr)
            if layout.get(path) is not None:
                out.append(layout[path].distribute(t))
                continue
            dev = target.device if isinstance(target, torch.Tensor) else 'cpu'
            out.append(t.to(dev))
        return unflatten_like(state_like, out)
