"""Parity of the PyTorch port's frontend (bilinear sampling, Hessian
response, keypoint detection, SURF description) with the JAX package on
rendered images."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.config import DetectorConfig as JDetectorConfig  # noqa: E402
from points_matching_tpu.data.render import render_sequence as j_render  # noqa: E402
from points_matching_tpu.ops import descriptors as jdesc  # noqa: E402
from points_matching_tpu.ops import detect as jdet  # noqa: E402
from points_matching_tpu.ops.sampling import bilinear_sample as j_sample  # noqa: E402
from points_matching_tpu_torch.core.convert import config_from_dict, keypoints_from_numpy  # noqa: E402
from points_matching_tpu_torch.core.config import DescriptorConfig, DetectorConfig  # noqa: E402
from points_matching_tpu_torch.data.render import render_sequence  # noqa: E402
from points_matching_tpu_torch.ops.descriptors import (  # noqa: E402
    extract_descriptors,
    surf_describe,
)
from points_matching_tpu_torch.ops.detect import detect_keypoints, hessian_response  # noqa: E402
from points_matching_tpu_torch.ops.sampling import bilinear_sample  # noqa: E402


# jit the JAX references: eager dispatch is slower than one compile
j_detect = jax.jit(jdet.detect_keypoints, static_argnames=("config",))
j_describe = jax.jit(jdesc.surf_describe)
j_hessian = jax.jit(jdet.hessian_response, static_argnames=("sigma",))


@pytest.fixture(scope="module")
def image():
    imgs, *_ = j_render(num_frames=1, num_landmarks=120, image_size=(160, 128), seed=1)
    return np.array(imgs[0])


def test_render_copy_is_identical():
    a, pa, qa, Ka = j_render(num_frames=2, num_landmarks=40, image_size=(96, 64), seed=2)
    b, pb, qb, Kb = render_sequence(num_frames=2, num_landmarks=40, image_size=(96, 64),
                                    seed=2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa, pb)
    assert Ka == Kb


def test_bilinear_sample_matches_jax_including_fringe(image):
    H, W = image.shape
    rng = np.random.RandomState(0)
    xy = np.concatenate([
        rng.uniform(-1.5, W + 0.5, (400, 2)).astype(np.float32) * [1, H / W],
        np.array([[-0.25, 0.0], [1.0, -0.5], [-0.75, -0.75], [W - 0.5, H - 1.0]],
                 np.float32),
    ]).astype(np.float32)
    jv = np.asarray(j_sample(jnp.asarray(image), jnp.asarray(xy)))
    tv = bilinear_sample(torch.from_numpy(image), torch.from_numpy(xy)).numpy()
    # pixel values ≤ 255: 1e-4 absolute is f32 rounding of the blend
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    # the [-1, 0) fringe blends the fill (0) with pixel 0, not pixel 1
    np.testing.assert_allclose(tv[400], 0.75 * image[0, 0], atol=1e-4)
    np.testing.assert_allclose(tv[401], 0.5 * image[0, 1], atol=1e-4)


@pytest.mark.parametrize("sigma", [1.2, 3.39])
def test_hessian_response_matches_jax(image, sigma):
    jr = np.asarray(j_hessian(jnp.asarray(image), sigma))
    tr = hessian_response(torch.from_numpy(image), sigma).numpy()
    # rtol 1e-4; the determinant cancels (Lxx·Lyy − (0.9·Lxy)²), so values
    # near 0 compare against the map's scale
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-4 * np.abs(jr).max())


def _detector_config():
    return JDetectorConfig(kind="hessian", threshold=8000.0, max_keypoints=96,
                           num_octaves=3)


@pytest.fixture(scope="module")
def jax_keypoints(image):
    """The reference's keypoints on ``image``, shared by the detector and
    the descriptor tests."""
    return j_detect(jnp.asarray(image), _detector_config())


def test_detect_keypoints_matches_jax_as_sets(image, jax_keypoints):
    jcfg = _detector_config()
    jk = jax_keypoints
    tk = detect_keypoints(torch.from_numpy(image),
                          config_from_dict(dataclasses.asdict(jcfg), DetectorConfig))
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tm.sum() == jm.sum() > 20
    jxy, txy = np.asarray(jk.xy)[jm], tk.xy.numpy()[tm]
    # top-k tie order may differ: compare as sets, nearest neighbour ≤ 1e-3 px
    dist = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    near = dist.min(1) < 1e-3
    assert near.mean() >= 0.95, near.mean()
    # matched keypoints carry the same scale, score and orientation
    j_idx, t_idx = np.nonzero(near)[0], dist.argmin(1)[near]
    np.testing.assert_array_equal(tk.scale.numpy()[tm][t_idx], np.asarray(jk.scale)[jm][j_idx])
    np.testing.assert_allclose(tk.score.numpy()[tm][t_idx], np.asarray(jk.score)[jm][j_idx],
                               rtol=1e-4)
    dang = np.angle(np.exp(1j * (tk.angle.numpy()[tm][t_idx]
                                 - np.asarray(jk.angle)[jm][j_idx])))
    assert np.abs(dang).max() < 1e-3


def test_surf_describe_on_same_keypoints(image, jax_keypoints):
    jk = jax_keypoints
    jd = j_describe(jnp.asarray(image), jk)
    td = surf_describe(torch.from_numpy(image), keypoints_from_numpy(jk, device="cpu"))
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    # unit-norm 64-d rows from f32 sums of weighted pixel differences
    np.testing.assert_allclose(td.data.numpy(), np.asarray(jd.data), atol=1e-4)


def test_unknown_detector_and_descriptor_kinds_raise(image):
    # FAST, Harris and ORB are tested in tests/test_torch_orb.py
    img = torch.from_numpy(image)
    with pytest.raises(ValueError):
        detect_keypoints(img, DetectorConfig(kind="sift"))
    kps = detect_keypoints(img, DetectorConfig(max_keypoints=16))
    with pytest.raises(ValueError):
        extract_descriptors(img, kps, DescriptorConfig(kind="sift"))


@pytest.mark.parametrize("shape", [(32, 32), (40, 24)])
def test_detector_top_k_on_small_images(shape):
    """Images below the reference's minimum at 512 keypoints (it crashes
    there: its per-scale top-k exceeds the plane): the port caps the
    per-scale top-k at the plane size, and its two-stage top-k gives a
    flat ``torch.topk``'s cells over the same masked responses."""
    from points_matching_tpu_torch.ops import detect as tdet

    rng = np.random.RandomState(sum(shape))
    img = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32))
    cfg = DetectorConfig(kind="hessian", threshold=0.0, max_keypoints=512, border=3)
    kp = detect_keypoints(img, cfg)
    assert kp.capacity == 512 and kp.xy.shape == (512, 2)
    n = int(kp.mask.sum())
    assert 0 < n < 512 and bool(kp.mask[:n].all())
    # the same peak map the detector builds, at random responses
    resp = torch.from_numpy(rng.rand(4, *shape).astype(np.float32))
    peak = tdet._spatial_nms(resp, cfg.nms_radius) & tdet._scale_nms(resp)
    score_m = torch.where(peak, resp, -torch.inf)
    scores, s_idx, y_idx, x_idx = tdet._top_k_peaks(score_m, 512, cfg.nms_radius)
    flat_s, flat_i = torch.topk(score_m.reshape(-1), 512)
    finite = torch.isfinite(flat_s)
    m = int(finite.sum())
    assert 0 < m < 512 and int(torch.isfinite(scores).sum()) == m
    assert torch.equal(scores[:m], flat_s[:m])
    H, W = shape
    assert torch.equal(s_idx[:m] * H * W + y_idx[:m] * W + x_idx[:m], flat_i[:m])
