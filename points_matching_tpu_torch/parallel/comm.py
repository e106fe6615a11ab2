"""Collectives over a ``torch.distributed`` process group — port of
``points_matching_tpu/parallel/comm.py``.

``Comm(group)`` names the group a collective runs over, as the reference's
``Comm(axis)`` names a mesh axis.  ``Comm(None)`` is the no-op backend:
every method is the identity (a sum over one participant), so the same code
runs with and without process groups.  A fault hook (``set_fault_hook``)
sees every collective's input, as in the reference, so tests can perturb
one collective.

Transport: NCCL groups take CUDA tensors as they are.  gloo groups are
given host tensors: a CUDA tensor is copied to the host, reduced or moved
there, and copied back to its device.  That is a transport choice: gloo's
all_reduce, broadcast and all_gather take CUDA tensors, but its send of a
CUDA tensor aborts the process (``examples/probe_gloo_cuda_torch.py``), so
every collective of a gloo group uses one rule; and a gloo group is what
two processes sharing one GPU can use, since NCCL allows one rank a GPU.
No computation moves to the CPU.

Collectives return new tensors and never write into their inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# fn(name, tensor) -> tensor, applied to every collective's input; tests
# install one to emulate a flaky link, production leaves it None
_FAULT_HOOK: Optional[Callable[[str, Tensor], Tensor]] = None


def set_fault_hook(hook: Optional[Callable[[str, Tensor], Tensor]]) -> None:
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def _inject(name: str, x: Tensor) -> Tensor:
    return x if _FAULT_HOOK is None else _FAULT_HOOK(name, x)


def _back(buf: Tensor, like: Tensor) -> Tensor:
    """A received buffer on ``like``'s device with ``like``'s dtype."""
    return buf.to(device=like.device, dtype=like.dtype)


def pack(tensors: Sequence[Tensor]) -> Tuple[Tensor, list]:
    """Tensors of one device as one flat uint8 buffer, and the spec that
    ``unpack`` needs: several leaves then travel in one collective."""
    spec = [(t.shape, t.dtype) for t in tensors]
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    flat = [t.to(torch.uint8) if t.dtype == torch.bool else t for t in flat]
    return torch.cat([t.view(torch.uint8) for t in flat]), spec


def unpack(buf: Tensor, spec: list) -> list:
    """The tensors ``pack`` put in ``buf`` (copies, on ``buf``'s device)."""
    out, o = [], 0
    for shape, dtype in spec:
        wire = torch.uint8 if dtype == torch.bool else dtype
        n = math.prod(shape) * torch.empty((), dtype=wire).element_size()
        t = buf[o:o + n].clone().view(wire).reshape(shape)
        out.append(t.bool() if dtype == torch.bool else t)
        o += n
    return out


@dataclasses.dataclass(frozen=True)
class Comm:
    """Collectives bound to a process group (``None``: the no-op backend)."""

    group: Optional[Any] = None

    # -- introspection ----------------------------------------------------
    def index(self) -> int:
        """This process's rank in the group."""
        return 0 if self.group is None else dist.get_rank(self.group)

    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    def _host(self, x: Tensor) -> bool:
        """Whether ``x`` travels as a host copy (a CUDA tensor on gloo)."""
        return x.device.type != "cpu" and dist.get_backend(self.group) == "gloo"

    def _wire(self, x: Tensor) -> Tensor:
        """A contiguous copy of ``x`` that the group's backend can move
        (bool travels as uint8)."""
        x = x.detach()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.to("cpu", copy=True).contiguous() if self._host(x) \
            else x.clone().contiguous()

    # -- reductions -------------------------------------------------------
    def _reduce(self, name: str, x: Tensor, op) -> Tensor:
        if self.group is None:
            return x
        buf = self._wire(_inject(name, x))
        dist.all_reduce(buf, op=op, group=self.group)
        return _back(buf, x)

    def psum(self, x: Tensor) -> Tensor:
        return self._reduce("psum", x, dist.ReduceOp.SUM)

    def pmean(self, x: Tensor) -> Tensor:
        if self.group is None:
            return x
        return self._reduce("pmean", x, dist.ReduceOp.SUM) / self.size()

    def pmax(self, x: Tensor) -> Tensor:
        return self._reduce("pmax", x, dist.ReduceOp.MAX)

    def pmin(self, x: Tensor) -> Tensor:
        return self._reduce("pmin", x, dist.ReduceOp.MIN)

    # -- data movement ----------------------------------------------------
    def _gather(self, name: str, x: Tensor) -> Tuple[Tensor, ...]:
        buf = self._wire(_inject(name, x))
        parts = [torch.empty_like(buf) for _ in range(self.size())]
        dist.all_gather(parts, buf, group=self.group)
        return tuple(_back(p, x) for p in parts)

    def all_gather(self, x: Tensor, axis: int = 0, tiled: bool = False) -> Tensor:
        """Every rank's ``x`` in rank order: stacked on a new ``axis``, or
        (``tiled``) concatenated along ``axis``."""
        if self.group is None:
            return x if tiled else x.unsqueeze(axis)
        parts = self._gather("all_gather", x)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def reduce_scatter(self, x: Tensor, axis: int = 0) -> Tensor:
        """The sum over ranks of ``x``, split into ``size`` blocks along
        ``axis``: this rank's block (a sum then a slice, which every
        backend supports)."""
        if self.group is None:
            return x
        n = self.size()
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of length {x.shape[axis]} does not split "
                             f"over {n} ranks")
        total = self._reduce("reduce_scatter", x, dist.ReduceOp.SUM)
        return total.chunk(n, axis)[self.index()].contiguous()

    def all_to_all(self, x: Tensor, split_axis: int, concat_axis: int) -> Tensor:
        """Block r of ``x`` along ``split_axis`` goes to rank r; the blocks
        received, in rank order, are concatenated along ``concat_axis``
        (the reference's tiled ``all_to_all``, built on ``all_gather``)."""
        if self.group is None:
            return x
        n = self.size()
        if x.shape[split_axis] % n:
            raise ValueError(f"axis {split_axis} of length {x.shape[split_axis]} does "
                             f"not split over {n} ranks")
        me = self.index()
        parts = self._gather("all_to_all", x)
        return torch.cat([p.chunk(n, split_axis)[me] for p in parts], concat_axis)

    def ppermute(self, x: Tensor, perm: Sequence[Tuple[int, int]]) -> Tensor:
        """Send ``x`` from rank ``src`` to rank ``dst`` for every (src, dst)
        in ``perm``; a rank that receives nothing gets zeros (the
        reference's ``ppermute``).  Point-to-point ops in one
        ``batch_isend_irecv``; a pair (r, r) is a local copy."""
        if self.group is None:
            return x
        me = self.index()
        x = _inject("ppermute", x)
        send_to = [d for s, d in perm if s == me]
        recv_from = [s for s, d in perm if d == me]
        if len(send_to) > 1 or len(recv_from) > 1:
            raise ValueError(f"perm {perm} sends or receives twice at rank {me}")
        if recv_from and recv_from[0] == me:
            return x.detach().clone()
        buf = self._wire(x)
        out = torch.zeros_like(buf)
        ops = []
        if send_to:
            ops.append(dist.P2POp(dist.isend, buf,
                                  dist.get_global_rank(self.group, send_to[0]), self.group))
        if recv_from:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(self.group, recv_from[0]), self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return _back(out, x)

    def ring_shift(self, x: Tensor, shift: int = 1) -> Tensor:
        """Send to the neighbour ``shift`` ranks further on the ring."""
        if self.group is None:
            return x
        n = self.size()
        return self.ppermute(x, [(i, (i + shift) % n) for i in range(n)])

    def broadcast(self, x: Tensor, src: int = 0) -> Tensor:
        """Group rank ``src``'s ``x`` on every rank."""
        if self.group is None:
            return x
        buf = self._wire(_inject("broadcast", x))
        dist.broadcast(buf, dist.get_global_rank(self.group, src), group=self.group)
        return _back(buf, x)
