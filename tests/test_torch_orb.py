"""Parity of the PyTorch port's ORB path (BASELINE config 0) with the JAX
package: FAST and Harris responses, detection, the rotated-BRIEF describe
step, the plain version of kernel K4 (Hamming top-2), Hamming matching and
the ORB two-view pipeline.  The same numpy inputs go through both; the JAX
kernel runs in Pallas interpret mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core import config as jc  # noqa: E402
from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.data.render import render_sequence as j_render  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_minimal_points  # noqa: E402
from points_matching_tpu.ops import descriptors as jdesc  # noqa: E402
from points_matching_tpu.ops import detect as jdet  # noqa: E402
from points_matching_tpu.ops import matching as jm  # noqa: E402
from points_matching_tpu.ops.pallas.hamming import fused_hamming_top2 as j_top2  # noqa: E402
from points_matching_tpu.pipelines.two_view import two_view_pipeline as j_pipeline  # noqa: E402
from points_matching_tpu_torch.core.config import (  # noqa: E402
    DescriptorConfig,
    DetectorConfig,
    MatcherConfig,
    TwoViewConfig,
    named_config,
    orb_default_config,
    surf_parity_config,
)
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    config_from_dict,
    descriptors_from_numpy,
    keypoints_from_numpy,
)
from points_matching_tpu_torch.ops import descriptors as tdesc  # noqa: E402
from points_matching_tpu_torch.ops import detect as tdet  # noqa: E402
from points_matching_tpu_torch.ops import matching as tm  # noqa: E402
from points_matching_tpu_torch.ops.kernels.hamming_kernel import (  # noqa: E402
    fused_hamming_top2,
    popcount32,
)
from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline  # noqa: E402

# jit the JAX references: eager dispatch is slower than one compile
j_fast = jax.jit(jdet.fast_response, static_argnames=("threshold",))
j_harris = jax.jit(jdet.harris_response, static_argnames=("sigma",))
j_blur = jax.jit(jdet.gaussian_blur, static_argnames=("sigma",))
j_detect = jax.jit(jdet.detect_keypoints, static_argnames=("config",))
j_orb = jax.jit(jdesc.orb_describe)

_FAST = jc.DetectorConfig(kind="fast", threshold=20.0, max_keypoints=256)
_HARRIS = jc.DetectorConfig(kind="harris", threshold=1e3, max_keypoints=128, num_octaves=2)


@pytest.fixture(scope="module")
def images():
    """Blurred noise (the JAX package's ORB pipeline test image) and a small
    rendered view."""
    rng = np.random.RandomState(2)
    noise = np.array(j_blur(jnp.asarray(rng.rand(160, 200).astype(np.float32)) * 255.0,
                            sigma=1.2))
    imgs, *_ = j_render(num_frames=1, num_landmarks=120, image_size=(160, 128), seed=1)
    return {"noise": noise, "rendered": np.array(imgs[0])}


@pytest.fixture(scope="module")
def jax_keypoints(images):
    """The reference's keypoints of each (image, detector config) the tests
    use, each computed once for the module."""
    cache = {}

    def get(name, jcfg):
        if (name, jcfg) not in cache:
            cache[name, jcfg] = j_detect(jnp.asarray(images[name]), jcfg)
        return cache[name, jcfg]

    return get


def _port_config(jcfg, cls):
    return config_from_dict(dataclasses.asdict(jcfg), cls)


@pytest.mark.parametrize("sigma", [1.2, 2.0])
def test_gaussian_blur_matches_jax(images, sigma):
    img = images["rendered"]
    jb = np.asarray(j_blur(jnp.asarray(img), sigma=sigma))
    tb = tdet.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    # values ≤ 255 summed in another f32 order
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("threshold", [10.0, 20.0])
@pytest.mark.parametrize("name", ["noise", "rendered"])
def test_fast_response_matches_jax(images, name, threshold):
    img = images[name]
    jr = np.asarray(j_fast(jnp.asarray(img), threshold=threshold))
    tr = tdet.fast_response(torch.from_numpy(img), threshold).numpy()
    # the corner test compares the same f32 differences: the masks are equal;
    # the score sums 16 ring terms, whose f32 order may differ
    np.testing.assert_array_equal(tr > 0, jr > 0)
    assert (jr > 0).sum() > 1000
    np.testing.assert_allclose(tr, jr, rtol=1e-5)


@pytest.mark.parametrize("sigma", [1.2, 2.4])
def test_harris_response_matches_jax(images, sigma):
    img = images["noise"]
    jr = np.asarray(j_harris(jnp.asarray(img), sigma=sigma))
    tr = tdet.harris_response(torch.from_numpy(img), sigma).numpy()
    # rtol 1e-4; det − k·tr² cancels, so values near 0 compare against the
    # map's scale (as the Hessian test does)
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4 * np.abs(jr).max())


@pytest.mark.parametrize("jcfg", [_FAST, _HARRIS], ids=["fast", "harris"])
def test_detect_keypoints_matches_jax_as_sets(images, jax_keypoints, jcfg):
    img = images["noise"]
    jk = jax_keypoints("noise", jcfg)
    tk = tdet.detect_keypoints(torch.from_numpy(img), _port_config(jcfg, DetectorConfig))
    jmask, tmask = np.asarray(jk.mask), tk.mask.numpy()
    assert tmask.sum() == jmask.sum() > 20
    jxy, txy = np.asarray(jk.xy)[jmask], tk.xy.numpy()[tmask]
    # top-k tie order may differ: compare as sets, nearest neighbour ≤ 1e-3 px
    dist = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    near = dist.min(1) < 1e-3
    assert near.mean() >= 0.95, near.mean()
    j_idx, t_idx = np.nonzero(near)[0], dist.argmin(1)[near]
    np.testing.assert_array_equal(tk.scale.numpy()[tmask][t_idx],
                                  np.asarray(jk.scale)[jmask][j_idx])
    np.testing.assert_allclose(tk.score.numpy()[tmask][t_idx],
                               np.asarray(jk.score)[jmask][j_idx], rtol=1e-4)
    if jcfg.kind == "fast":
        # FAST keypoints stay upright in both packages
        assert not tk.angle.numpy().any()
        assert not np.asarray(jk.angle).any()
    else:
        dang = np.angle(np.exp(1j * (tk.angle.numpy()[tmask][t_idx]
                                     - np.asarray(jk.angle)[jmask][j_idx])))
        assert np.abs(dang).max() < 1e-3


@pytest.mark.parametrize("num_bits", [256, 128])
def test_brief_pattern_is_identical(num_bits):
    ja, jb = (np.asarray(p) for p in jdesc._brief_pattern(num_bits))
    ta, tb = tdesc._brief_pattern(num_bits)
    assert ta.dtype == np.float32 and ta.shape == (num_bits, 2)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("jcfg,name", [(_FAST, "noise"), (_HARRIS, "rendered")],
                         ids=["fast-noise", "harris-rendered"])
def test_orb_describe_on_same_keypoints(images, jax_keypoints, jcfg, name):
    img = images[name]
    jk = jax_keypoints(name, jcfg)
    jd = j_orb(jnp.asarray(img), jk)
    td = tdesc.extract_descriptors(torch.from_numpy(img), keypoints_from_numpy(jk, device="cpu"),
                                   DescriptorConfig(kind="orb"))
    assert td.binary and td.data.dtype == torch.int32 and td.data.shape == jd.data.shape
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    a = np.asarray(jd.data)
    b = td.data.numpy().view(np.uint32)
    assert not b[~td.mask.numpy()].any()          # masked rows are all-zero words
    # a bit can flip only where the two blurred samples of a test tie within
    # f32 rounding (blur sums in another order); measured: every bit equal
    equal = np.unpackbits(~(a ^ b).view(np.uint8)).mean()
    assert equal >= 0.999, equal


def _words(rng, shape):
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _planted(seed, n1, n2, w=8):
    """Random 256-bit descriptors with exact duplicates of train rows,
    near-duplicates (a few flipped bits), repeated train rows (tied best and
    runner-up) and ~5 % invalid train rows."""
    rng = np.random.RandomState(seed)
    t = _words(rng, (n2, w))
    q = _words(rng, (n1, w))
    t[n2 - n2 // 8:] = t[:n2 // 8]
    src = rng.permutation(n2)[:n1 // 2]
    q[:n1 // 4] = t[src[:n1 // 4]]
    flips = np.packbits(rng.rand(n1 // 2 - n1 // 4, w * 32) < 3 / 256, axis=-1,
                        bitorder="little").view(np.uint32)
    q[n1 // 4:n1 // 2] = t[src[n1 // 4:n1 // 2]] ^ flips
    t_mask = rng.rand(n2) > 0.05
    return q, t, t_mask


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _port_top2(q, t, t_mask):
    d, i = fused_hamming_top2(_i32(q)[None], _i32(t)[None], torch.from_numpy(t_mask)[None])
    return d[0].numpy(), i[0].numpy()


def _hamming(q, t):
    return np.unpackbits((q ^ t).view(np.uint8), axis=-1).sum(-1)


def _assert_runner_up(q, t, t_mask, d, i):
    """Column 1 is a valid train row other than column 0 at the runner-up
    distance — all the JAX kernel promises (its cross-tile duel may pick
    another index tied at that distance)."""
    has2 = d[:, 1] < 1e29
    i2 = i[has2, 1]
    np.testing.assert_array_equal(_hamming(q[has2], t[i2]), d[has2, 1])
    assert t_mask[i2].all()
    assert (i2 != i[has2, 0]).all()


@pytest.mark.parametrize("n1,n2,tile_t", [(256, 512, 128), (100, 300, 128)])
def test_hamming_top2_plain_matches_jax(n1, n2, tile_t):
    q, t, t_mask = _planted(n1 + n2, n1, n2)
    td, ti = _port_top2(q, t, t_mask)
    # the JAX kernel, several train tiles (the cross-tile duel runs)
    kd, ki = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                             jnp.asarray(t_mask), tile_t=tile_t,
                                             interpret=True))
    # integer counts: distances and the 1-NN (lowest column on ties) are exact
    np.testing.assert_array_equal(td, kd)
    np.testing.assert_array_equal(ti[:, 0], ki[:, 0])
    _assert_runner_up(q, t, t_mask, td, ti)
    _assert_runner_up(q, t, t_mask, kd, ki)
    assert (td[:, 0] == td[:, 1]).mean() > 0.05        # ties are the normal case
    # the XLA reference: two argmin passes, both columns exactly
    jd1 = JDescriptors(data=jnp.asarray(q), mask=jnp.ones(n1, bool), binary=True)
    jd2 = JDescriptors(data=jnp.asarray(t), mask=jnp.asarray(t_mask), binary=True)
    xd, xi = (np.asarray(a) for a in jm.knn_match(jd1, jd2, k=2, metric="hamming"))
    np.testing.assert_array_equal(td, xd)
    np.testing.assert_array_equal(ti, xi)


def test_hamming_top2_runner_up_tied_across_tiles():
    # a query at distance 3 from train columns 5, 600 and 601 (tile 512):
    # the port gives knn_match's runner-up (the lowest tied column, 600);
    # the JAX kernel's cross-tile duel may give another tied column
    rng = np.random.RandomState(4)
    q = _words(rng, (1, 8))
    t = ~np.repeat(q, 1024, axis=0)                   # distance 256 elsewhere
    for j, bits in ((5, (0, 1, 2)), (600, (3, 4, 5)), (601, (6, 7, 8))):
        t[j] = q[0]
        for b in bits:
            t[j, 0] ^= np.uint32(1 << b)
    t_mask = np.ones(1024, bool)
    td, ti = _port_top2(q, t, t_mask)
    np.testing.assert_array_equal(td, [[3.0, 3.0]])
    np.testing.assert_array_equal(ti, [[5, 600]])
    kd, ki = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                             jnp.asarray(t_mask), interpret=True))
    np.testing.assert_array_equal(kd, td)
    assert ki[0, 0] == 5 and ki[0, 1] in (600, 601)


@pytest.mark.parametrize("n_valid", [0, 1])
def test_hamming_top2_plain_fewer_than_two_valid_train_rows(n_valid):
    q, t, _ = _planted(9, 40, 200)
    t_mask = np.zeros(200, bool)
    t_mask[137:137 + n_valid] = True
    td, ti = _port_top2(q, t, t_mask)
    # every invalid entry is exactly 1e30, as in knn_match
    jd1 = JDescriptors(data=jnp.asarray(q), mask=jnp.ones(40, bool), binary=True)
    jd2 = JDescriptors(data=jnp.asarray(t), mask=jnp.asarray(t_mask), binary=True)
    xd, xi = (np.asarray(a) for a in jm.knn_match(jd1, jd2, k=2, metric="hamming"))
    np.testing.assert_array_equal(td, xd)
    np.testing.assert_array_equal(ti, xi)
    assert (td[:, 1] == np.float32(1e30)).all()
    np.testing.assert_array_equal(ti[:, 0], np.full(40, 137 if n_valid else 0))
    kd, ki = (np.asarray(a) for a in j_top2(jnp.asarray(q), jnp.asarray(t),
                                             jnp.asarray(t_mask), tile_t=128,
                                             interpret=True))
    np.testing.assert_array_equal(td, kd)
    np.testing.assert_array_equal(ti, ki)


def test_hamming_distance_matrix_and_popcount_match_jax():
    q, t, _ = _planted(11, 30, 50)
    jd = np.asarray(jm.hamming_distance_matrix(jnp.asarray(q), jnp.asarray(t)))
    td = tm.hamming_distance_matrix(_i32(q), _i32(t))
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), jd)
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0x0F0F0F0F], np.uint32)
    np.testing.assert_array_equal(popcount32(_i32(edge)).numpy(), [0, 1, 1, 32, 16, 16])


def test_binary_descriptors_keep_every_bit():
    words = np.array([[0xFFFFFFFF, 0x80000000, 1, 0]], np.uint32)
    d = descriptors_from_numpy(JDescriptors(data=jnp.asarray(words), mask=jnp.ones(1, bool),
                                            binary=True), device="cpu")
    assert d.binary and d.data.dtype == torch.int32
    np.testing.assert_array_equal(d.data.numpy().view(np.uint32), words)
    with pytest.raises(TypeError):
        descriptors_from_numpy(JDescriptors(data=words.astype(np.float32),
                                            mask=np.ones(1, bool), binary=True), device="cpu")


def _binary_pair(seed=7, n=120):
    rng = np.random.RandomState(seed)
    q = _words(rng, (n, 8))
    flips = np.packbits(rng.rand(n, 256) < 0.1, axis=-1, bitorder="little").view(np.uint32)
    t = q[::-1] ^ flips
    t[:10] = _words(rng, (10, 8))                     # rows with no true partner
    return q, np.arange(n) < n - 10, np.ascontiguousarray(t), np.arange(n) >= 4


_HAMMING_CASES = [
    dict(filter="ratio", ratio=0.8),
    dict(filter="midpoint"),
    dict(filter="threshold", threshold=40.0),
    dict(filter="none"),
    dict(filter="ratio", ratio=0.8, cross_check=True),
    dict(filter="threshold", threshold=40.0, cross_check=True),
]


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("kw", _HAMMING_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_match_descriptors_hamming_matches_jax(kw, compact, backend):
    q, qm, t, tmask = _binary_pair()
    jd1 = JDescriptors(data=jnp.asarray(q), mask=jnp.asarray(qm), binary=True)
    jd2 = JDescriptors(data=jnp.asarray(t), mask=jnp.asarray(tmask), binary=True)
    ref = jm.match_descriptors(jd1, jd2, jc.MatcherConfig(metric="hamming", compact=compact,
                                                          backend="xla", **kw))
    out = tm.match_descriptors(descriptors_from_numpy(jd1, device="cpu"),
                               descriptors_from_numpy(jd2, device="cpu"),
                               MatcherConfig(metric="hamming", compact=compact,
                                             backend=backend, **kw))
    assert 10 < int(out.mask.sum()) or kw["filter"] == "midpoint"
    # integer distances: everything is exactly equal
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.query_idx.numpy(), np.asarray(ref.query_idx))
    np.testing.assert_array_equal(out.train_idx.numpy(), np.asarray(ref.train_idx))
    np.testing.assert_array_equal(out.distance.numpy(), np.asarray(ref.distance))
    jmin, jmax = jm.match_stats(ref)
    tmin, tmax = tm.match_stats(out)
    np.testing.assert_array_equal([float(tmin), float(tmax)], [float(jmin), float(jmax)])


H_RANSAC = 256


@pytest.fixture(scope="module")
def orb_runs(images):
    """The ORB pipeline on the blurred-noise pair (second view shifted by
    (9, 4) px), 256 keypoints, 256 hypotheses: JAX, and the port fed the
    minimal sets the JAX run drew."""
    base = images["noise"]
    im2 = np.roll(base, (4, 9), axis=(0, 1))
    cfg = jc.orb_default_config()
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=256),
        ransac=jc.RansacConfig(num_hypotheses=H_RANSAC))
    key = jax.random.PRNGKey(1)
    ref = jax.device_get(j_pipeline(jnp.asarray(base), jnp.asarray(im2), key, cfg))
    samples = sample_minimal_points(key, jnp.asarray(ref.matches.mask), H_RANSAC, 8,
                                    (jnp.asarray(ref.p1), jnp.asarray(ref.p2)))
    out = two_view_pipeline(torch.from_numpy(base), torch.from_numpy(im2), None,
                            _port_config(cfg, TwoViewConfig),
                            samples=tuple(torch.from_numpy(np.array(s)) for s in samples))
    return ref, out


def test_orb_two_view_pipeline_matches_jax(orb_runs):
    ref, out = orb_runs
    assert int(out.kps1.mask.sum()) == int(np.asarray(ref.kps1.mask).sum()) == 256
    assert int(out.kps2.mask.sum()) == int(np.asarray(ref.kps2.mask).sum())
    n_ref, n_out = int(np.asarray(ref.matches.mask).sum()), int(out.matches.mask.sum())
    # a keypoint whose top-k tie or descriptor bit differs can move a match
    assert n_ref >= 64 and abs(n_out - n_ref) <= 2
    for r in (ref, out):
        m = np.asarray(r.matches.mask)
        shift = np.median((np.asarray(r.p2) - np.asarray(r.p1))[m], axis=0)
        np.testing.assert_allclose(shift, [9, 4], atol=1.0)
    # same minimal sets: the same consensus up to near-threshold gates
    i_ref, i_out = int(ref.estimate.num_inliers), int(out.estimate.num_inliers)
    assert abs(i_out - i_ref) <= max(2, i_ref // 20)
    assert abs(float(np.sum(np.asarray(ref.estimate.F) * out.estimate.F.numpy()))) >= 0.99


def test_named_configs():
    assert named_config("orb") == orb_default_config()
    assert named_config("surf_parity") == surf_parity_config()
    ransac = named_config("ransac")
    assert (ransac.matcher.ratio, ransac.use_ransac) == (0.85, True)
    assert ransac.detector == surf_parity_config().detector
    with pytest.raises(ValueError):
        named_config("sift")


def test_pack_bits_matches_numpy():
    bits = np.random.RandomState(12).rand(5, 256) < 0.5
    words = tdesc.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    ref = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("words", [4, 12, 20])
def test_hamming_width_padding_is_exact(words):
    """On the card K4 pads W to the next built width with zero words, or
    above the widest to whole 8-word chunks, which add no bits: the plain
    version on the padded input equals it on the
    original, distances and both index columns."""
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import (
        BUILT_WORDS, CHUNK_WORDS, hamming_top2_plain)

    rng = np.random.RandomState(words)
    t = rng.randint(0, 2**32, (2, 60, words), dtype=np.uint64).astype(np.uint32)
    q = rng.randint(0, 2**32, (2, 50, words), dtype=np.uint64).astype(np.uint32)
    q[:, :20] = t[:, :20] ^ np.uint32(6)                # near-duplicates
    qt, tt = (torch.from_numpy(x.view(np.int32)) for x in (q, t))
    t_mask = torch.from_numpy(rng.rand(2, 60) > 0.1)
    qp, tp = (_build.pad_width(x, BUILT_WORDS, CHUNK_WORDS) for x in (qt, tt))
    want = next((w for w in BUILT_WORDS if w >= words), -(-words // CHUNK_WORDS) * CHUNK_WORDS)
    assert qp.shape[-1] == want
    assert torch.equal(qp[..., :words], qt) and not qp[..., words:].any()
    d0, i0 = hamming_top2_plain(qt, tt, t_mask)
    d1, i1 = hamming_top2_plain(qp, tp, t_mask)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
