"""All-pairs descriptor matching scores (BASELINE config 1's all-pairs
sweep; the covisibility statistic of loop detection) — port of
``points_matching_tpu/parallel/all_pairs.py`` in its single-process form
(the reference at ``mesh=None``; the ring over devices comes with the
port's process groups).

Pair score = the number of query rows of frame i whose 1-NN in frame j
passes the ratio test: ``scores[i, j]`` over every ordered pair, the
diagonal included (callers typically ignore it).

On the card the sweep is kernel K1 (``fused_l2_top2``), which computes
exactly the per-row squared-L2 top-2 that the reference's
``_pair_scores_block`` takes with a GEMM and two masked minima.  K1 keeps a
separate top-2 per (pair, query row) over the pair's train rows, so one
launch takes the query rows of a block of frames at once (the [Q·K, D]
rows are a view of ``desc``, nothing is copied) against one train frame:
its [Q·K] top-2s are column j of the block's scores.  A sweep is N launches
of ⌈N·K / 128⌉ blocks each (one per train frame and query block of at
most ``_QUERY_ROWS`` rows), with no gathered copy of any frame; the top-2s
of ``train_chunk`` train frames are counted together.  On the CPU the
reference's block function runs as written (``pair_scores_plain``).

K1 adds ‖q‖² after the top-2 and clamps at 0; the reference adds it
before and clamps before the minima.  Clamping is monotone, so the two
agree up to f32 rounding at near-ties of the ratio test.
"""
from __future__ import annotations

import torch

from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2

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


def _scores_on_card(desc: Tensor, mask: Tensor, ratio: float, train_chunk: int) -> Tensor:
    N, K, D = desc.shape
    desc = desc.contiguous()
    mask = mask.contiguous()
    scores = torch.empty((N, N), dtype=torch.int32, device=desc.device)
    qf = max(1, _QUERY_ROWS // max(K, 1))        # query frames a launch
    for q0 in range(0, N, qf):
        q1 = min(N, q0 + qf)
        rows = desc[q0:q1].reshape(1, (q1 - q0) * K, D)
        qmask = mask[q0:q1].reshape(-1)
        for j0 in range(0, N, train_chunk):
            j1 = min(N, j0 + train_chunk)
            dist = torch.cat([fused_l2_top2(rows, desc[j:j + 1], mask[j:j + 1])[0]
                              for j in range(j0, j1)])           # [tc, Q·K, 2]
            best, second = dist[..., 0], dist[..., 1]
            ok = (best < ratio * ratio * second) & (best < _BIG / 2) & qmask
            counts = ok.reshape(j1 - j0, q1 - q0, K).sum(-1, dtype=torch.int32)
            scores[q0:q1, j0:j1] = counts.T
    return scores


def all_pairs_scores(desc: Tensor, mask: Tensor, ratio: float = 0.8,
                     train_chunk: int = 8) -> Tensor:
    """[N, K, D] float descriptors + [N, K] masks → [N, N] int32
    match-count matrix (diagonal included), on the inputs' device: kernel
    K1 for CUDA tensors, the plain version for CPU tensors."""
    _check_inputs(desc, mask)
    if desc.device.type == "cpu":
        return pair_scores_plain(desc, mask, desc, mask, ratio, train_chunk)
    if desc.device.type != "cuda":
        raise ValueError(f"unsupported device {desc.device}")
    return _scores_on_card(desc, mask, ratio, train_chunk)
