"""Parity of the PyTorch port's matching (kernel K1/K1b plain versions and
ops/matching.py) with the JAX package: same numpy inputs through both, the
JAX kernels in Pallas interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.config import MatcherConfig as JMatcherConfig  # noqa: E402
from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.ops import matching as jm  # noqa: E402
from points_matching_tpu.ops.pallas.matching_kernel import (  # noqa: E402
    fused_l2_top2 as j_top2,
    fused_l2_top2_points as j_top2_points,
)
from points_matching_tpu_torch.core.config import MatcherConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    descriptors_from_numpy,
    matches_from_numpy,
)
from points_matching_tpu_torch.ops import matching as tm  # noqa: E402
from points_matching_tpu_torch.ops.kernels.matching_kernel import (  # noqa: E402
    fused_l2_top2,
    fused_l2_top2_points,
)


def _unit_rows(rng, n, d=64):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n1,n2", [(128, 128), (100, 70)])
def test_l2_top2_plain_matches_jax_kernel_f32(n1, n2):
    rng = np.random.RandomState(0)
    q, t = _unit_rows(rng, n1), _unit_rows(rng, n2)
    t_mask = np.arange(n2) < n2 - 9
    jd, ji = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                              jnp.asarray(t_mask), interpret=True))
    td, ti = fused_l2_top2(_t(q)[None], _t(t)[None], _t(t_mask)[None])
    td, ti = td[0].numpy(), ti[0].numpy()
    # f32 sums in another order: 1e-5 on unit-vector distances (≤ 4)
    np.testing.assert_allclose(td, jd, atol=1e-5)
    # the 1-NN index may only differ where best and runner-up are a near-tie
    tie = np.abs(jd[:, 0] - jd[:, 1]) < 1e-5
    np.testing.assert_array_equal(ti[~tie, 0], ji[~tie, 0])
    assert np.all(ti[:, 1] != ti[:, 0])


def test_l2_top2_plain_matches_jax_kernel_bf16():
    rng = np.random.RandomState(1)
    q, t = _unit_rows(rng, 96), _unit_rows(rng, 128)
    t_mask = np.ones(128, bool)
    jd, _ = j_top2(jnp.asarray(q), jnp.asarray(t), jnp.asarray(t_mask),
                   interpret=True, compute_dtype="bf16")
    td, _ = fused_l2_top2(_t(q)[None], _t(t)[None], _t(t_mask)[None],
                          compute_dtype="bf16")
    # bf16 operands (8-bit mantissa): ~1e-2 absolute on distances ≤ 4
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), atol=2e-2)


def test_l2_top2_plain_duplicate_descriptors():
    # every query appears twice in train: best = runner-up = 0, the 1-NN is
    # the lowest column (as in the JAX kernel test)
    q = np.eye(8, 64, dtype=np.float32)
    t = np.concatenate([q, q], axis=0)
    t_mask = np.ones(16, bool)
    jd, ji = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                              jnp.asarray(t_mask), tile_q=8,
                                              tile_t=8, interpret=True))
    td, ti = fused_l2_top2(_t(q)[None], _t(t)[None], _t(t_mask)[None])
    np.testing.assert_allclose(td[0].numpy(), jd, atol=1e-6)
    np.testing.assert_array_equal(ti[0].numpy(), ji)
    np.testing.assert_array_equal(ti[0, :, 0].numpy(), np.arange(8))


def test_l2_top2_plain_all_train_masked_but_one():
    rng = np.random.RandomState(2)
    q = rng.randn(32, 64).astype(np.float32)
    t = rng.randn(128, 64).astype(np.float32)
    t_mask = np.zeros(128, bool)
    t_mask[5] = True
    jd, ji = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                              jnp.asarray(t_mask), interpret=True))
    td, ti = fused_l2_top2(_t(q)[None], _t(t)[None], _t(t_mask)[None])
    np.testing.assert_array_equal(ti[0].numpy(), ji)   # (5, 0): the +inf pad
    np.testing.assert_array_equal(ti[0, :, 0].numpy(), np.full(32, 5))
    # runner-up is the 1e30 sentinel in both; best within f32 rounding of
    # un-normalized (|·|² ~ 128) rows
    np.testing.assert_allclose(td[0].numpy(), jd, rtol=1e-6, atol=1e-4)
    assert np.all(td[0, :, 1].numpy() > 1e20)


def test_l2_top2_points_plain_matches_jax_kernel():
    rng = np.random.RandomState(3)
    q, t = _unit_rows(rng, 100), _unit_rows(rng, 120)
    t_mask = np.arange(120) < 111
    pts = rng.uniform(0, 993, (120, 2)).astype(np.float32)
    jd, ji, jp = (np.asarray(a) for a in j_top2_points(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(t_mask), jnp.asarray(pts),
        interpret=True))
    td, ti, tp = (a[0].numpy() for a in fused_l2_top2_points(
        _t(q)[None], _t(t)[None], _t(t_mask)[None], _t(pts)[None]))
    np.testing.assert_allclose(td, jd, atol=1e-5)
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    # the port's epilogue is an exact load; the TPU kernel's 3-term bf16
    # split reconstructs to f32 rounding
    np.testing.assert_array_equal(tp, pts[ti[:, 0]])
    np.testing.assert_allclose(tp, jp, rtol=1e-6)


def _desc_pair(seed=7, n=120):
    rng = np.random.RandomState(seed)
    q = _unit_rows(rng, n)
    t = q[::-1] + 0.05 * rng.randn(n, 64).astype(np.float32)
    t = (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)
    qm = np.arange(n) < n - 10
    tmask = np.arange(n) >= 4
    return q, qm, t, tmask


_FILTER_CASES = [
    dict(filter="ratio", ratio=0.9),
    dict(filter="midpoint"),
    dict(filter="threshold", threshold=0.6),
    dict(filter="none"),
    dict(filter="ratio", ratio=0.9, cross_check=True),
    dict(filter="threshold", threshold=0.6, cross_check=True),
]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("kw", _FILTER_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_match_descriptors_matches_jax(kw, compact):
    q, qm, t, tmask = _desc_pair()
    jd1 = JDescriptors(data=jnp.asarray(q), mask=jnp.asarray(qm))
    jd2 = JDescriptors(data=jnp.asarray(t), mask=jnp.asarray(tmask))
    ref = jm.match_descriptors(jd1, jd2, JMatcherConfig(compact=compact,
                                                        backend="xla", **kw))
    out = tm.match_descriptors(descriptors_from_numpy(jd1, device="cpu"),
                               descriptors_from_numpy(jd2, device="cpu"),
                               MatcherConfig(compact=compact, backend="auto", **kw))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.query_idx.numpy(), np.asarray(ref.query_idx))
    np.testing.assert_array_equal(out.train_idx.numpy(), np.asarray(ref.train_idx))
    # sqrt of f32 squared distances summed in another order
    np.testing.assert_allclose(out.distance.numpy(), np.asarray(ref.distance), atol=1e-5)
    jmin, jmax = jm.match_stats(ref)
    tmin, tmax = tm.match_stats(out)
    np.testing.assert_allclose([float(tmin), float(tmax)], [float(jmin), float(jmax)],
                               atol=1e-5)
    # the same statistic on the JAX matches carried across
    cmin, cmax = tm.match_stats(matches_from_numpy(ref, device="cpu"))
    np.testing.assert_array_equal([float(cmin), float(cmax)], [float(jmin), float(jmax)])


def test_match_descriptors_xla_backend_matches_fused():
    q, qm, t, tmask = _desc_pair(seed=8)
    d1 = descriptors_from_numpy(JDescriptors(data=q, mask=qm), device="cpu")
    d2 = descriptors_from_numpy(JDescriptors(data=t, mask=tmask), device="cpu")
    a = tm.match_descriptors(d1, d2, MatcherConfig(backend="xla"))
    b = tm.match_descriptors(d1, d2, MatcherConfig(backend="auto"))
    np.testing.assert_array_equal(a.mask.numpy(), b.mask.numpy())
    np.testing.assert_array_equal(a.train_idx.numpy(), b.train_idx.numpy())
    np.testing.assert_allclose(a.distance.numpy(), b.distance.numpy(), atol=1e-5)


@pytest.mark.parametrize("filt", ["ratio", "threshold", "midpoint"])
def test_match_descriptors_points_invariant(filt):
    q, qm, t, tmask = _desc_pair(seed=9)
    pts = np.random.RandomState(9).uniform(0, 640, (len(t), 2)).astype(np.float32)
    d1 = descriptors_from_numpy(JDescriptors(data=q, mask=qm), device="cpu")
    d2 = descriptors_from_numpy(JDescriptors(data=t, mask=tmask), device="cpu")
    cfg = MatcherConfig(filter=filt, ratio=0.9, threshold=0.6, compact=False)
    m, got = tm.match_descriptors_points(d1, d2, _t(pts), cfg)
    ref = tm.match_descriptors(d1, d2, cfg)
    np.testing.assert_array_equal(m.mask.numpy(), ref.mask.numpy())
    np.testing.assert_array_equal(m.train_idx.numpy(), ref.train_idx.numpy())
    # pts[i] == t_points[train_idx[i]] on EVERY row, filtered rows included
    np.testing.assert_array_equal(got.numpy(), pts[m.train_idx.numpy()])


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_unknown_metric_raises(backend):
    # the Hamming metric is tested in tests/test_torch_orb.py
    q, qm, t, tmask = _desc_pair(seed=10)
    d1 = descriptors_from_numpy(JDescriptors(data=q, mask=qm), device="cpu")
    d2 = descriptors_from_numpy(JDescriptors(data=t, mask=tmask), device="cpu")
    with pytest.raises(ValueError):
        tm.match_descriptors(d1, d2, MatcherConfig(metric="cosine", backend=backend))


@pytest.mark.parametrize("width", [16, 48, 100, 160, 200])
def test_l2_width_padding_is_exact(width):
    """On the card K1/K1b pad D with zero columns to the next built width,
    or above the widest to whole chunks of the chunked kernel; the plain
    version on the padded input gives the original's indices and its
    distances to f32 rounding (a zero column adds exact zeros, but the GEMM
    may sum in another order at another width)."""
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        BUILT_DIMS, CHUNK_DIM, l2_top2_plain, l2_top2_points_plain)

    rng = np.random.RandomState(width)
    q = _t(np.stack([_unit_rows(rng, 90, width) for _ in range(2)]))
    t = _t(np.stack([_unit_rows(rng, 70, width) for _ in range(2)]))
    t_mask = _t(rng.rand(2, 70) > 0.1)
    qp, tp = (_build.pad_width(x, BUILT_DIMS, CHUNK_DIM) for x in (q, t))
    want = next((w for w in BUILT_DIMS if w >= width), -(-width // CHUNK_DIM) * CHUNK_DIM)
    assert qp.shape[-1] == want
    assert torch.equal(qp[..., :width], q) and not qp[..., width:].any()
    d0, i0 = l2_top2_plain(q, t, t_mask)
    d1, i1 = l2_top2_plain(qp, tp, t_mask)
    torch.testing.assert_close(d1, d0, atol=1e-6, rtol=0)
    tie = (d0[..., 0] - d0[..., 1]).abs() < 1e-5
    assert bool(((i0 == i1).all(-1) | tie).all())
    pts = _t(rng.rand(2, 70, 2).astype(np.float32))
    _, ip, pp = l2_top2_points_plain(qp, tp, t_mask, pts)
    assert torch.equal(pp, torch.gather(pts, 1, ip[..., :1].long().expand(-1, -1, 2)))


def test_width_padding_raises_above_the_widest():
    """No width raises any more: above the widest built width the kernels
    take their chunked path, and the widths pad to whole chunks (D to a
    multiple of 64, W to a multiple of 8); a width that is already such a
    width is not copied."""
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import BUILT_WORDS, CHUNK_WORDS
    from points_matching_tpu_torch.ops.kernels.matching_kernel import BUILT_DIMS, CHUNK_DIM

    x = torch.zeros(1, 4, 64)
    assert _build.pad_width(x, BUILT_DIMS, CHUNK_DIM) is x     # a built width: no copy
    x = torch.zeros(1, 4, 256)
    assert _build.pad_width(x, BUILT_DIMS, CHUNK_DIM) is x     # whole chunks: no copy
    assert _build.pad_width(torch.zeros(1, 4, 160), BUILT_DIMS, CHUNK_DIM).shape[-1] == 192
    assert _build.pad_width(torch.zeros(1, 4, 513), BUILT_DIMS, CHUNK_DIM).shape[-1] == 576
    w = torch.zeros(1, 4, 20, dtype=torch.int32)
    assert _build.pad_width(w, BUILT_WORDS, CHUNK_WORDS).shape[-1] == 24
    w = torch.zeros(1, 4, 32, dtype=torch.int32)
    assert _build.pad_width(w, BUILT_WORDS, CHUNK_WORDS) is w