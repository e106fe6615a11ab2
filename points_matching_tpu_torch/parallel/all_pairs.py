"""All-pairs descriptor matching scores (BASELINE config 1's all-pairs
sweep; the covisibility statistic of loop detection) — port of
``points_matching_tpu/parallel/all_pairs.py``.

Pair score = the number of query rows of frame i whose 1-NN in frame j
passes the ratio test: ``scores[i, j]`` over every ordered pair, the
diagonal included (callers typically ignore it).

The ring (the reference's ``_ring_all_pairs``): with a ``mesh``, the frames
are split over its ``data`` group; every rank scores its query block
against the train block it holds, then forwards that block one hop with
``ring_shift``, so after n steps each rank has scored its queries against
every frame without holding all of them at once.  The score rows are then
gathered, so every rank returns the full [N, N] matrix.  Without a mesh the
same ring runs on the no-op backend: one step, the frames against
themselves.

On the card a block is scored by kernel K1 (``fused_l2_top2``), which
computes exactly the per-row squared-L2 top-2 that the reference's
``_pair_scores_block`` takes with a GEMM and two masked minima.  K1 keeps a
separate top-2 per (pair, query row) over the pair's train rows, so one
launch takes the query rows of a block of frames at once (the [Q·K, D]
rows are a view of ``desc``, nothing is copied) against one train frame:
its [Q·K] top-2s are column j of the block's scores.  A block is one launch
a train frame, of ⌈Q·K / 128⌉ blocks each (one per query tile of at most
``_QUERY_ROWS`` rows), with no gathered copy of any frame; the top-2s of
``train_chunk`` train frames are counted together.  On the CPU the
reference's block function runs as written (``pair_scores_plain``).

K1 adds ‖q‖² after the top-2 and clamps at 0; the reference adds it
before and clamps before the minima.  Clamping is monotone, so the two
agree up to f32 rounding at near-ties of the ratio test.
"""
from __future__ import annotations

import torch

from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
from points_matching_tpu_torch.parallel.comm import Comm
from points_matching_tpu_torch.parallel.mesh import DATA_AXIS, axis_comm, has_axis, shard

Tensor = torch.Tensor

_BIG = 1e30
# query rows of one K1 launch (4 Mi: 64 MiB of top-2 outputs); config 1's
# 1,024 frames × 256 rows take one launch a train frame
_QUERY_ROWS = 1 << 22


def _check_inputs(desc: Tensor, mask: Tensor) -> None:
    if desc.dim() != 3 or tuple(mask.shape) != tuple(desc.shape[:2]):
        raise ValueError(f"expected desc [N, K, D] and mask [N, K], got "
                         f"{tuple(desc.shape)} and {tuple(mask.shape)}")
    if desc.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("desc must be float32 and mask bool")
    if desc.device != mask.device:
        raise ValueError(f"desc and mask on different devices: {desc.device}, {mask.device}")


def _pair_scores_block(qd: Tensor, qm: Tensor, td: Tensor, tm: Tensor,
                       ratio: float) -> Tensor:
    """The reference's ``_pair_scores_block``: qd [Q, K, D], qm [Q, K], td
    [T, K, D], tm [T, K] → [Q, T] int32 counts of ratio-passing 1-NN
    matches, from the [Q, T, K, K] squared-L2 matrix (GEMM identity,
    clamped at 0; invalid rows and columns 1e30) and two masked minima (a
    duplicated minimum gives second == best, which the ratio test sees)."""
    q2 = (qd * qd).sum(-1)
    t2 = (td * td).sum(-1)
    ip = torch.einsum("qkd,tld->qtkl", qd, td)
    d2 = (q2[:, None, :, None] + t2[None, :, None, :] - 2.0 * ip).clamp_min(0.0)
    invalid = ~qm[:, None, :, None] | ~tm[None, :, None, :]
    d2 = torch.where(invalid, _BIG, d2)
    best, i1 = d2.min(-1)                      # first minimum on ties
    second = d2.scatter(-1, i1[..., None], _BIG).min(-1).values
    ok = (best < ratio * ratio * second) & (best < _BIG / 2) & qm[:, None, :]
    return ok.sum(-1, dtype=torch.int32)


def pair_scores_plain(qd: Tensor, qm: Tensor, td: Tensor, tm: Tensor,
                      ratio: float = 0.8, train_chunk: int = 8) -> Tensor:
    """Plain version: [Q, T] scores of query frames ``qd`` against train
    frames ``td``, ``train_chunk`` train frames at a time (the working set
    is [Q, train_chunk, K, K])."""
    return torch.cat([_pair_scores_block(qd, qm, td[j:j + train_chunk],
                                         tm[j:j + train_chunk], ratio)
                      for j in range(0, td.shape[0], train_chunk)], 1)


def _scores_on_card(qd: Tensor, qm: Tensor, td: Tensor, tm: Tensor, ratio: float,
                    train_chunk: int) -> Tensor:
    """[Q, T] scores of query frames ``qd`` against train frames ``td`` on
    K1: one launch a train frame with every query frame's rows."""
    Q, K, D = qd.shape
    T = td.shape[0]
    qd, qm, td, tm = (x.contiguous() for x in (qd, qm, td, tm))
    scores = torch.empty((Q, T), dtype=torch.int32, device=qd.device)
    qf = max(1, _QUERY_ROWS // max(K, 1))        # query frames a launch
    for q0 in range(0, Q, qf):
        q1 = min(Q, q0 + qf)
        rows = qd[q0:q1].reshape(1, (q1 - q0) * K, D)
        qmask = qm[q0:q1].reshape(-1)
        for j0 in range(0, T, train_chunk):
            j1 = min(T, j0 + train_chunk)
            dist = torch.cat([fused_l2_top2(rows, td[j:j + 1], tm[j:j + 1])[0]
                              for j in range(j0, j1)])           # [tc, Q·K, 2]
            best, second = dist[..., 0], dist[..., 1]
            ok = (best < ratio * ratio * second) & (best < _BIG / 2) & qmask
            counts = ok.reshape(j1 - j0, q1 - q0, K).sum(-1, dtype=torch.int32)
            scores[q0:q1, j0:j1] = counts.T
    return scores


def _score_block(qd: Tensor, qm: Tensor, td: Tensor, tm: Tensor, ratio: float,
                 train_chunk: int) -> Tensor:
    """[Q, T] block scores on the inputs' device: K1 for CUDA tensors, the
    plain version for CPU tensors."""
    if qd.device.type == "cpu":
        return pair_scores_plain(qd, qm, td, tm, ratio, train_chunk)
    if qd.device.type != "cuda":
        raise ValueError(f"unsupported device {qd.device}")
    return _scores_on_card(qd, qm, td, tm, ratio, train_chunk)


def _ring_all_pairs(qd: Tensor, qm: Tensor, comm: Comm, ratio: float,
                    train_chunk: int) -> Tensor:
    """The ring: ``qd``/``qm`` are this rank's frames and its first train
    block; returns its [Q, Q·n] score rows, columns in global frame order.
    After s hops the block in hand came from rank (my − s) mod n."""
    n, my = comm.size(), comm.index()
    Q = qd.shape[0]
    scores = torch.empty((Q, Q * n), dtype=torch.int32, device=qd.device)
    td, tm = qd, qm
    for s in range(n):
        src = (my - s) % n
        scores[:, src * Q:(src + 1) * Q] = _score_block(qd, qm, td, tm, ratio, train_chunk)
        if s + 1 < n:                  # the last block is not forwarded
            td, tm = comm.ring_shift(td), comm.ring_shift(tm)
    return scores


def all_pairs_scores(desc: Tensor, mask: Tensor, ratio: float = 0.8,
                     train_chunk: int = 8, mesh=None) -> Tensor:
    """[N, K, D] float descriptors + [N, K] masks → [N, N] int32
    match-count matrix (diagonal included), on the inputs' device: kernel
    K1 for CUDA tensors, the plain version for CPU tensors.

    With ``mesh`` (every rank passing the same inputs), the frames are split
    over its ``data`` group and scored by the ring; N must divide the group
    (pad with masked frames).  Every rank returns the full matrix."""
    _check_inputs(desc, mask)
    if not has_axis(mesh, DATA_AXIS):
        return _ring_all_pairs(desc, mask, Comm(None), ratio, train_chunk)
    comm = axis_comm(mesh, DATA_AXIS)
    rows = _ring_all_pairs(shard(desc, mesh), shard(mask, mesh), comm, ratio, train_chunk)
    return comm.all_gather(rows, tiled=True)
