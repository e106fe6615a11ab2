"""Pipeline parallelism over the ``stage`` process group — port of
``points_matching_tpu/parallel/pipeline.py`` (GPipe).

Rank s of the ``stage`` group runs stage s.  Microbatch m enters stage 0
at tick m and leaves stage S−1 at tick m + S − 1, so M microbatches take
M + S − 1 ticks and the bubble share is (S−1)/(M+S−1), as in the reference.
Every stage maps a wire (a dict of tensors, one microbatch) to a wire of
the same leaves.  The reference traces one SPMD program, so it computes
every tick on every device and carries a validity bit with the activation;
here each process knows the static schedule, so the validity bit of stage s
at tick t is 0 ≤ t − s < M on the host: a stage runs and sends only on
valid ticks, and stage s + 1 receives exactly then.  An activation goes one
hop a tick by send/recv (the wire packed into one buffer), and the last
stage's outputs are broadcast to every rank of the group.

Without a mesh, with one stage, or with a one-rank stage axis, the stages
are composed sequentially per microbatch: the same numerics.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from points_matching_tpu_torch.parallel.comm import pack, unpack
from points_matching_tpu_torch.parallel.mesh import STAGE_AXIS, axis_comm, axis_size

Tensor = torch.Tensor
Wire = Dict[str, Tensor]


def _microbatch(xs: Wire, m: int) -> Wire:
    return {k: v[m] for k, v in xs.items()}


def _stack(wires: Sequence[Wire]) -> Wire:
    return {k: torch.stack([w[k] for w in wires]) for k in wires[0]}


def _check_wire(w: Wire, spec: Dict[str, tuple], s: int) -> Wire:
    """``w``, after checking that stage ``s`` kept the wire's leaves, their
    shapes and dtypes (``spec``: key → (shape, dtype) of one microbatch).
    Over ranks a wire travels packed into buffers sized from stage 0's
    input, so any other layout would be read as other bytes, silently."""
    got = {k: (tuple(v.shape), v.dtype) for k, v in w.items()}
    if got != spec:
        bad = sorted(k for k in set(got) | set(spec) if got.get(k) != spec.get(k))
        raise ValueError(f"stage {s} changed the wire's leaves {bad}: "
                         f"{[(k, got.get(k), spec.get(k)) for k in bad]}")
    return w


def pipeline_stages(stage_fns: Sequence[Callable[[Wire], Wire]], xs: Wire, mesh=None,
                    axis: str = STAGE_AXIS) -> Wire:
    """Run ``xs`` (a dict of tensors with leading microbatch dim M) through
    ``stage_fns`` as a pipeline over ``mesh``'s ``axis``; returns the dict
    with leading dim M, microbatch m's output after all S stages, on every
    rank.  Every rank passes the same ``xs``; stage 0 reads it."""
    S = len(stage_fns)
    M = next(iter(xs.values())).shape[0]
    keys = list(xs)
    layout = {k: (tuple(xs[k].shape[1:]), xs[k].dtype) for k in keys}

    def compose(x: Wire) -> Wire:
        for i, f in enumerate(stage_fns):
            x = _check_wire(f(x), layout, i)
        return x

    n = axis_size(mesh, axis)
    if S == 1 or n == 1:
        return _stack([compose(_microbatch(xs, m)) for m in range(M)])
    if n != S:
        raise ValueError(f"stage axis has {n} ranks but {S} stage functions were given; "
                         "pad stages with identities or reshape the mesh")

    comm = axis_comm(mesh, axis)
    s = comm.index()
    dev = xs[keys[0]].device
    # every stage maps the wire to the same leaves: one microbatch's layout
    spec = [layout[k] for k in keys]
    nbytes = pack([xs[k][0] for k in keys])[0].numel()
    act, outs = None, []
    for t in range(M + S - 1):
        m = t - s                              # the microbatch at this stage now
        if 0 <= m < M:
            y = _check_wire(stage_fns[s](_microbatch(xs, m) if s == 0 else act), layout, s)
            if s == S - 1:
                outs.append(y)
        # one hop: stage r hands what it ran at tick t to stage r + 1
        hops = [(r, r + 1) for r in range(S - 1) if 0 <= t - r < M]
        if any(s in h for h in hops):
            sends = (s, s + 1) in hops
            buf = pack([y[k] for k in keys])[0] if sends else \
                torch.zeros(nbytes, dtype=torch.uint8, device=dev)
            got = comm.ppermute(buf, hops)
            if (s - 1, s) in hops:
                act = dict(zip(keys, unpack(got, spec)))
    # the last stage's outputs, on every rank of the group
    out_spec = [((M,) + tuple(shape), dtype) for shape, dtype in spec]
    if s == S - 1:
        buf = pack([torch.stack([o[k] for o in outs]) for k in keys])[0]
    else:
        buf = torch.zeros(M * nbytes, dtype=torch.uint8, device=dev)
    return dict(zip(keys, unpack(comm.broadcast(buf, src=S - 1), out_spec)))
