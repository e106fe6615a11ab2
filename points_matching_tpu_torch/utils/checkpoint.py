"""Checkpoint / resume of map state — port of
``points_matching_tpu/utils/checkpoint.py`` (Orbax there, ``torch.save``
here).

Layout: one directory per step, ``<directory>/<step>/``, holding one file
per rank, ``rank<r>of<W>.pt``.  A process outside a process group is rank 0
of 1.  Each file is written under a temporary name and renamed when it is
complete, and a step counts (``latest_step``, ``all_steps``) only when all W
of its files are there, so an interrupted save never leaves a step behind.

A file holds the state as plain containers: dicts, lists, tensors and
Python scalars, loaded with ``weights_only=True``.  Dataclasses (``SfMState``,
``Pose``, ...) and NamedTuples are saved as dicts of their fields and tuples
as lists; no class is pickled.  ``restore`` with a ``template`` rebuilds the
template's structure and puts each tensor on the template tensor's device
and dtype.

Under ``torch.distributed`` each rank saves and restores its own state:
for a tensor sharded over a mesh axis (a ``model``-axis block of landmarks,
say), its own shard.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

_FILE = re.compile(r"rank(\d+)of(\d+)\.pt$")


def _to_plain(x: Any) -> Any:
    """State → dicts, lists, host tensors and scalars (copies: the caller
    may change its state while the write goes on)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):            # NamedTuple
        return {k: _to_plain(v) for k, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_plain(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _from_plain(template: Any, x: Any, path: str = "state") -> Any:
    """Rebuild ``template``'s structure from the plain tree ``x``."""
    if isinstance(template, torch.Tensor):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(template.shape):
            raise ValueError(f"{path}: saved {getattr(x, 'shape', type(x).__name__)}, "
                             f"template {tuple(template.shape)}")
        return x.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return x.numpy().astype(template.dtype)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _from_plain(getattr(template, f.name), x[f.name], f"{path}.{f.name}")
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_from_plain(v, x[k], f"{path}.{k}")
                                for k, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return type(template)((k, _from_plain(v, x[k], f"{path}[{k!r}]"))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        if len(x) != len(template):
            raise ValueError(f"{path}: saved {len(x)} items, template {len(template)}")
        return type(template)(_from_plain(v, xi, f"{path}[{i}]")
                              for i, (v, xi) in enumerate(zip(template, x)))
    return x


def _listdir(d: str) -> List[str]:
    """Entries of ``d``, none if another rank removed it meanwhile."""
    try:
        return os.listdir(d)
    except FileNotFoundError:
        return []


def _rank_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    """Save and restore state trees (SfM maps, BA states, configs).

    ``save`` copies the state's tensors to the host before it returns; the
    file is written in a thread, which ``wait()`` (or ``close()``) joins, so
    the caller may go on changing its state at once.  ``max_to_keep``
    complete steps are kept; older ones are removed after a save.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self.rank, self.world = _rank_world()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _file(self, step: int) -> str:
        return os.path.join(self.directory, str(step), f"rank{self.rank}of{self.world}.pt")

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` as ``step`` (asynchronously).  A step that exists
        already raises ``FileExistsError`` unless ``force``, which
        overwrites it."""
        self.wait()
        if not force and os.path.exists(self._file(step)):
            raise FileExistsError(f"step {step} exists in {self.directory}")
        payload = {"step": int(step), "world": self.world, "state": _to_plain(state)}
        self._thread = threading.Thread(target=self._write, args=(step, payload))
        self._thread.start()
        return True

    def _write(self, step: int, payload: dict) -> None:
        path = self._file(step)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(payload, tmp)
            os.replace(tmp, path)
            self._prune()
        except BaseException as e:          # re-raised by wait()
            self._error = e
            if os.path.exists(tmp):
                os.remove(tmp)

    def _prune(self) -> None:
        keep = self.all_steps()[-self.max_to_keep:]
        if not keep:
            return
        for step in self._step_dirs():
            if step >= keep[0]:
                continue
            own = self._file(step)
            if os.path.exists(own):
                os.remove(own)
            d = os.path.dirname(own)
            if not _listdir(d):          # the last rank's file of the step is gone
                shutil.rmtree(d, ignore_errors=True)

    def _step_dirs(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """This rank's state of ``step`` (the latest complete one by
        default): the template's structure, devices and dtypes with a
        ``template``, else the plain tree on the CPU.  Raises
        ``FileNotFoundError`` when there is no such step."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint {'' if step is None else step} "
                                    f"in {self.directory}")
        payload = torch.load(self._file(step), map_location="cpu", weights_only=True)
        state = payload["state"]
        return state if template is None else _from_plain(template, state)

    def all_steps(self) -> List[int]:
        """The complete steps (every rank's file present), oldest first."""
        out = []
        for step in self._step_dirs():
            d = os.path.join(self.directory, str(step))
            found = [m for m in (_FILE.match(n) for n in _listdir(d)) if m]
            worlds = {int(m.group(2)) for m in found}
            if any({int(m.group(1)) for m in found if int(m.group(2)) == w} == set(range(w))
                   for w in worlds):
                out.append(step)
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Join the pending write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
