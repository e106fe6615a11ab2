"""Numerical sanitizers — port of ``points_matching_tpu/utils/sanitize.py``.

The failure modes left in a fixed-capacity, masked pipeline are numerical:
NaN/Inf escaping an ill-conditioned solve (8-point F, Schur complements)
and out-of-range indices in gathers and scatters.  The JAX package wraps
``jax.experimental.checkify``; torch has no counterpart, so its semantics
are rebuilt here on a ``TorchDispatchMode`` that sees every ATen op:

  * float checks: the first op whose floating output holds a NaN (as
    checkify's ``float_checks``: infinities are the pipelines' own
    sentinels — the detector's ``-inf`` padding, the matchers' masked
    extrema — so only a NaN is a fault), and an integer division by zero
    (the run goes on dividing by 1 there);
  * index checks: an index of a gather, scatter or indexing op outside its
    dimension.  The index is clamped into range and the run goes on (what
    a TPU gather does silently), so the fault is reported, not turned into
    a device-side assert.  (A Python integer index, or a 0-d index tensor
    that ``x[i]`` reads on the host, is bounds-checked by torch itself
    before any op runs: it raises ``IndexError`` at once.)

Each check leaves its verdict on the device (the number of the first
failing check, kept with ``torch.minimum``), so a checked run does not
wait for the device once per op; ``err.throw()`` reads the verdicts once.

Usage:
    checked_fn = checked(two_view_pipeline)          # NaN + index checks
    out, err = checked_fn(img1, img2, generator, config)
    err.throw()                                      # raises, naming the op

    with debug_mode():                               # interactive debugging
        pipeline(...)  # raises at the first op that makes a NaN
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

FLOAT_CHECKS = frozenset({"float"})
INDEX_CHECKS = frozenset({"index"})
DEFAULT_CHECKS = FLOAT_CHECKS | INDEX_CHECKS

_NONE = 2 ** 62                  # "no check failed" on the device
_ACTIVE: List["_CheckedMode"] = []
_debug_nans = False

aten = torch.ops.aten
# op → (argument position of the index tensor, of the dim, of the indexed
# tensor); dim None: the index addresses the flattened tensor (take) or
# dim 0 (embedding)
_DIM_INDEX_OPS = {
    aten.index_select: (2, 1, 0), aten.gather: (2, 1, 0),
    aten.scatter: (2, 1, 0), aten.scatter_: (2, 1, 0),
    aten.scatter_add: (2, 1, 0), aten.scatter_add_: (2, 1, 0),
    aten.scatter_reduce: (2, 1, 0), aten.scatter_reduce_: (2, 1, 0),
    aten.index_add: (2, 1, 0), aten.index_add_: (2, 1, 0),
    aten.index_copy: (2, 1, 0), aten.index_copy_: (2, 1, 0),
    aten.index_fill: (2, 1, 0), aten.index_fill_: (2, 1, 0),
    aten.embedding: (1, None, 0), aten.take: (1, None, 0),
}
# ops taking a list of optional index tensors, one per leading dimension
_LIST_INDEX_OPS = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}
# integer divisions (``div`` only with a rounding mode: true division of
# integers gives floats, and x / 0 an infinity)
_INT_DIV_OPS = {aten.div, aten.div_, aten.floor_divide, aten.floor_divide_, aten.remainder,
                aten.remainder_, aten.fmod, aten.fmod_}


class SanitizerError(RuntimeError):
    """A check of a ``checked`` run failed."""


class CheckErrors:
    """The verdicts of one ``checked`` run.  ``get()`` reads them (once per
    device) and returns the first failure's message or None; ``throw()``
    raises ``SanitizerError`` with it."""

    def __init__(self, names: List[Tuple[str, str]], first: Dict[torch.device, torch.Tensor]):
        self._names = names
        self._first = first
        self._message: Optional[str] = None
        self._read = False

    def get(self) -> Optional[str]:
        if not self._read:
            firsts = [int(v) for v in self._first.values()]
            n = min(firsts, default=_NONE)
            if n != _NONE:
                kind, where = self._names[n]
                self._message = {
                    "float": f"nan in the output of {where} (float check)",
                    "div": f"integer division by zero in {where} (float check)",
                    "index": f"out-of-bounds index in {where} (index check)"}[kind]
            self._read = True
        return self._message

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise SanitizerError(msg)


def _op_name(func) -> str:
    return str(func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else func)


class _CheckedMode(TorchDispatchMode):
    def __init__(self, errors=DEFAULT_CHECKS):
        super().__init__()
        self.float_checks = "float" in errors
        self.index_checks = "index" in errors
        self.names: List[Tuple[str, str]] = []
        self.first: Dict[torch.device, torch.Tensor] = {}

    def record(self, failed: torch.Tensor, kind: str, where: str) -> None:
        """Keep check number n if ``failed`` (a 0-d bool) is True and no
        earlier check on its device failed."""
        n = len(self.names)
        self.names.append((kind, where))
        code = torch.where(failed, n, _NONE)
        prev = self.first.get(failed.device)
        self.first[failed.device] = code if prev is None else torch.minimum(prev, code)

    def _checked_index(self, idx, size: int, where: str, negative: bool):
        if not isinstance(idx, torch.Tensor) or idx.dtype in (torch.bool, torch.uint8) \
                or idx.is_floating_point() or size == 0:
            return idx
        lo = -size if negative else 0
        self.record(((idx < lo) | (idx >= size)).any(), "index", where)
        return idx.clamp(lo, size - 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = getattr(func, "overloadpacket", None)
        if self.index_checks and packet in _DIM_INDEX_OPS:
            i_idx, i_dim, i_src = _DIM_INDEX_OPS[packet]
            if len(args) > i_idx:
                src = args[i_src]
                if i_dim is None:
                    size = src.numel() if packet is aten.take else src.shape[0]
                else:
                    size = src.shape[args[i_dim]] if src.dim() else 1
                args = list(args)
                args[i_idx] = self._checked_index(args[i_idx], size, _op_name(func),
                                                  negative=packet is aten.take)
        elif self.index_checks and packet in _LIST_INDEX_OPS and len(args) > 1:
            src, indices = args[0], list(args[1])
            d = 0                           # the dimension the next index addresses
            for k, idx in enumerate(indices):
                if isinstance(idx, torch.Tensor) and idx.dtype in (torch.bool, torch.uint8):
                    d += idx.dim()          # a mask spans as many dimensions as it has
                    continue
                if idx is not None and d < src.dim():
                    indices[k] = self._checked_index(idx, src.shape[d], _op_name(func),
                                                     negative=True)
                d += 1
            args = (src, indices, *args[2:])
        if self.float_checks and packet in _INT_DIV_OPS and len(args) > 1 \
                and isinstance(args[1], torch.Tensor) and not args[1].is_floating_point() \
                and not args[1].is_complex() \
                and (packet not in (aten.div, aten.div_) or kwargs.get("rounding_mode")):
            zero = args[1] == 0
            self.record(zero.any(), "div", _op_name(func))
            # divide by 1 there and go on (the CPU kernel would raise)
            args = (args[0], torch.where(zero, 1, args[1]), *args[2:])
        out = func(*args, **kwargs)
        if self.float_checks and not func.is_view:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                    self.record(torch.isnan(t).any(), "float", _op_name(func))
        return out


def checked(fn: Callable, errors=DEFAULT_CHECKS) -> Callable:
    """Wrap ``fn`` with the checks: returns ``f(*args, **kwargs) -> (out,
    err)``; call ``err.throw()`` to raise on failure.

    The hand-written CUDA kernels write through ctypes, so the dispatcher
    never sees their interiors; their wrappers check their outputs instead
    (``check_finite`` / ``check_index``), the same limit the JAX version
    has with its Pallas kernels.  Every op of the run adds a few small
    device ops (the checks); none waits for the device."""
    errors = frozenset(errors)

    def wrapper(*args, **kwargs):
        mode = _CheckedMode(errors)
        _ACTIVE.append(mode)
        try:
            with mode:
                out = fn(*args, **kwargs)
        finally:
            _ACTIVE.pop()
        return out, CheckErrors(mode.names, mode.first)

    return wrapper


def check_finite(x: torch.Tensor, name: str) -> None:
    """Record, in the active ``checked`` run, whether ``x`` is finite
    (reported as ``name``); nothing outside one."""
    if _ACTIVE and _ACTIVE[-1].float_checks and x.numel():
        with _disable_current_modes():
            _ACTIVE[-1].record(torch.isfinite(x).all().logical_not(), "float", name)


def check_index(idx: torch.Tensor, size: int, name: str) -> None:
    """Record, in the active ``checked`` run, whether every entry of
    ``idx`` lies in [0, size) (reported as ``name``); nothing outside one."""
    if _ACTIVE and _ACTIVE[-1].index_checks and idx.numel():
        with _disable_current_modes():
            _ACTIVE[-1].record(((idx < 0) | (idx >= size)).any(), "index", name)


class _DebugNansMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _debug_nans and not func.is_view:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() \
                        and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"nan in the output of {_op_name(func)}")
        return out


def debug_nans_enabled() -> bool:
    """Whether ``debug_mode`` traps non-finite values now."""
    return _debug_nans


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Interactive debugging: with ``nans``, raise ``FloatingPointError``
    at the first op that makes a NaN (``jax_debug_nans``; each op then
    waits for the device).  ``disable_jit`` is accepted for the JAX signature and does
    nothing: torch runs eagerly already.  The state found on entry is
    restored on exit."""
    global _debug_nans
    prev = _debug_nans
    mode = _DebugNansMode() if nans else None
    _debug_nans = nans
    try:
        if mode is None:
            yield
        else:
            with mode:
                yield
    finally:
        _debug_nans = prev
