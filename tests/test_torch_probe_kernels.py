"""The probes' kernels P1–P4 (``ops/kernels/probe_match.py``,
``probe_score.py``): their plain PyTorch versions against the JAX probes'
Pallas kernels run in TPU interpret mode on the CPU, and the wrappers on CPU
tensors against the plain versions.

The JAX kernels come from the probe scripts as they are:
``benchmarks/probe/score_variants.py`` is loaded as a module, and
``match_variants.py``'s ``gemm_only`` and ``packed_top2`` — closures inside
its ``main`` — are lifted out of the function's body with ``ast`` and run
with ``jax``, ``jnp``, ``pl``, ``pltpu`` and ``functools`` in scope.  Inputs
are made with numpy from a seed and handed to both.

Tolerances:
* P1: |Δ| ≤ 1e-5 on unit-norm rows (bf16 products are exact in fp32; the
  sums differ in order only).
* P2: the packed key drops the distance's low ``idx_bits`` mantissa bits (a
  quantum), so an index may differ only on rows where plain's competing
  keys lie within 2 quanta; dist within a quantum + 1e-5 elsewhere and 2
  quanta + 1e-5 on those rows.
* Scores: counts equal except by cells at the gate — where r² − τ²·denom,
  in float64, lies within 16 fp32 roundings of the magnitudes summed into
  it (the sums run in another order, or with fused multiply-adds) — and the
  (divide, fp32) counts equal exactly.
* CPU interpret mode computes the TPU's ``DEFAULT`` precision as full fp32,
  so the one-bf16-pass variant is held to ``def_prec`` on inputs that are
  bf16 already, where one pass is exact; a second test shows that on
  general inputs it does round.
"""
import ast
import functools
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch

from points_matching_tpu_torch.ops.kernels import probe_match as pm
from points_matching_tpu_torch.ops.kernels import probe_score as ps
from points_matching_tpu_torch.ops.kernels import work
from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses

PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks", "probe")
TAU = 1.5


@functools.lru_cache(maxsize=None)
def _match_kernels():
    """``gemm_only`` and ``packed_top2`` from ``match_variants.main``."""
    path = os.path.join(PROBE, "match_variants.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = ("_gemm_only_kernel", "gemm_only", "_packed_kernel", "packed_top2")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert [d.name for d in defs] == list(wanted)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns["gemm_only"], ns["packed_top2"]


@functools.lru_cache(maxsize=None)
def _score_variants():
    spec = importlib.util.spec_from_file_location(
        "score_variants", os.path.join(PROBE, "score_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _descriptors(seed, B, N1, N2, D=64):
    rng = np.random.RandomState(seed)
    q = _unit(rng, B, N1, D)
    t = _unit(rng, B, N2, D)
    m = min(N1, N2) // 2                      # the first m query rows have a clear match
    t[:, :m] = q[:, :m] + 0.1 * rng.randn(B, m, D)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return q, t.astype(np.float32), (t * t).sum(-1).astype(np.float32)


# (N1, N2, tile_q, tile_t): the probe's tiles, and train tiles of 128 so that
# the TPU kernel carries its minimum / top-2 across four grid steps
MATCH_SHAPES = [(256, 512, 256, 512), (512, 512, 512, 128), (256, 384, 256, 128)]


@pytest.mark.parametrize("n1,n2,tq,tt", MATCH_SHAPES)
def test_gemm_rowmin_plain_matches_jax(n1, n2, tq, tt):
    gemm_only, _ = _match_kernels()
    q, t, _ = _descriptors(0, 2, n1, n2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.stack([np.asarray(gemm_only(jnp.asarray(q[b]), jnp.asarray(t[b]), tq=tq, tt=tt))
                        for b in range(2)])
    got = pm.gemm_rowmin_plain(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, n1, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors, and launches nothing
    before = pm.gemm_rowmin.launches
    wrapped = pm.gemm_rowmin(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    assert np.array_equal(wrapped, got) and pm.gemm_rowmin.launches == before


@pytest.mark.parametrize("n1,n2,tq,tt", MATCH_SHAPES)
def test_packed_top2_plain_matches_jax(n1, n2, tq, tt):
    _, packed_top2 = _match_kernels()
    q, t, t2 = _descriptors(1, 2, n1, n2)
    tq = min(tq, n1)
    with pltpu.force_tpu_interpret_mode():
        outs = [packed_top2(jnp.asarray(q[b]), jnp.asarray(t[b]), jnp.asarray(t2[b][None]),
                            tq=tq, tt=tt) for b in range(2)]
    ref_d = np.stack([np.asarray(d) for d, _ in outs])
    ref_i = np.stack([np.asarray(i) for _, i in outs])
    args = tuple(torch.from_numpy(x) for x in (q, t, t2))
    got_d, got_i = (x.numpy() for x in pm.packed_top2_plain(*args))
    quantum = pm.quantum(args[0], args[2])   # 2^idx_bits ulp of |d| ≤ 3
    near = pm.near_tie_rows(*args).numpy()
    assert near.mean() < 0.1                  # the data have clear best matches
    assert np.array_equal(got_i[~near], ref_i[~near])
    err = np.abs(got_d - ref_d)
    assert err[~near].max() <= quantum + 1e-5
    assert err.max() <= 2 * quantum + 1e-5
    # a planted row's best column is its match (bf16 moves a product by ~4e-3,
    # far below its margin)
    m = min(n1, n2) // 2
    assert np.array_equal(got_i[:, :m, 0], np.broadcast_to(np.arange(m), (2, m)))
    wrapped = pm.packed_top2(*args)
    assert all(np.array_equal(w.numpy(), g) for w, g in zip(wrapped, (got_d, got_i)))


def _scene(seed, H, N, noise=0.7):
    """Hypotheses around a true F (rank 2, unit norm) of a two-camera scene,
    its projected points (pixel scale, ~0..640) with noise, 5 % masked."""
    rng = np.random.RandomState(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, N)]
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    tr = np.array([0.5, 0.05, 0.1])
    x1 = (K @ X.T).T
    x2 = (K @ (R @ X.T + tr[:, None])).T
    p1 = x1[:, :2] / x1[:, 2:] + noise * rng.randn(N, 2)
    p2 = x2[:, :2] / x2[:, 2:] + noise * rng.randn(N, 2)
    tx = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]], [-tr[1], tr[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ tx @ R @ Kinv
    F /= np.linalg.norm(F)
    scale = np.geomspace(1e-6, 1e-2, H)[:, None, None]
    Fh = F[None] + scale * rng.randn(H, 3, 3)
    Fh /= np.linalg.norm(Fh, axis=(-2, -1), keepdims=True)
    mask = rng.rand(N) > 0.05
    return Fh.astype(np.float32), p1.astype(np.float32), p2.astype(np.float32), mask


def _near_gate(F, p1, p2, mask, products="f32", ulps=16):
    """Cells at the gate, per hypothesis [H] (``probe_score.near_gate_cells``)."""
    return ps.near_gate_cells(*(torch.from_numpy(x)[None] for x in (F, p1, p2, mask)), TAU,
                              products=products, ulps=ulps)[0].numpy()


def _jax_counts(variant, F, p1, p2, mask):
    score = _score_variants().build_fn(variant)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(score(jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(mask)))


def _port_counts(port, F, p1, p2, mask):
    args = (torch.from_numpy(F)[None], torch.from_numpy(p1)[None], torch.from_numpy(p2)[None],
            torch.from_numpy(mask)[None], TAU)
    if port is None:                          # the multiply gate in fp32: K2
        return ransac_score_hypotheses(*args)[0].numpy()
    plain = ps.score_variant_plain(*args, *port)
    assert torch.equal(ps.score_variant(*args, *port), plain)
    return plain[0].numpy()


# every JAX variant → the port's function: (gate, products), None for K2
SCORE_VARIANTS = [("prod", ("divide", "f32")), ("oneop", ("divide", "f32")),
                  ("nodiv", None), ("stacked", None), ("ostack", None),
                  ("split3", ("multiply", "bf16x3")), ("stack3", ("multiply", "bf16x3")),
                  ("ostack3", ("multiply", "bf16x3"))]


@pytest.mark.parametrize("variant,port", SCORE_VARIANTS, ids=[v for v, _ in SCORE_VARIANTS])
def test_score_variant_plain_matches_jax(variant, port):
    F, p1, p2, mask = _scene(2, 128, 512)
    ref = _jax_counts(variant, F, p1, p2, mask)
    got = _port_counts(port, F, p1, p2, mask)
    near = _near_gate(F, p1, p2, mask, "f32" if port is None else port[1])
    assert near.sum() > 0 and ref.max() > 256          # cells at the gate, real inliers
    if port == ("divide", "f32"):
        assert np.array_equal(got, ref)
    assert np.all(np.abs(got.astype(np.int64) - ref) <= near)


def test_score_one_bf16_pass_matches_jax_on_bf16_inputs():
    F, p1, p2, mask = _scene(3, 128, 512)
    bf16 = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    F, p1, p2 = bf16(F), bf16(p1), bf16(p2)
    ref = _jax_counts("def_prec", F, p1, p2, mask)
    got = _port_counts(("divide", "bf16x1"), F, p1, p2, mask)
    assert np.all(np.abs(got.astype(np.int64) - ref) <= _near_gate(F, p1, p2, mask, "bf16x1"))
    # one pass is exact there: the fp32 function gives the same counts
    assert np.array_equal(got, _port_counts(("divide", "f32"), F, p1, p2, mask))


def test_score_one_bf16_pass_rounds_general_inputs():
    F, p1, p2, mask = _scene(3, 128, 512)
    one = _port_counts(("divide", "bf16x1"), F, p1, p2, mask)
    f32 = _port_counts(("divide", "f32"), F, p1, p2, mask)
    split = _port_counts(("multiply", "bf16x3"), F, p1, p2, mask)
    # hi + lo keep 16 of an operand's 24 mantissa bits, so the 3-term split
    # (which drops lo·lo too) is the fp32 function to ~2^-16 relative: its
    # counts are the fp32 ones but at the gate at that precision
    near16 = _near_gate(F, p1, p2, mask, ulps=2 ** 9)
    assert np.all(np.abs(split.astype(np.int64) - f32) <= near16)
    # one pass keeps 8 bits (a coordinate near 640 moves by up to 2 px):
    # counts move far beyond even those cells
    assert int((np.abs(one.astype(np.int64) - f32) > near16).sum()) >= 32   # of 128


def test_probe_work_counts():
    B, N, H = 64, 512, 512
    q = torch.empty(B, N, 64)
    peaks = dict(hbm_gbps=3350.0, instr_per_s=33.5e12, bf16_tc_flops=989e12, flops=67e12)
    b1 = work.bound(pm.gemm_rowmin.work(q, q), peaks)
    b2 = work.bound(pm.packed_top2.work(q, q, q[..., 0]), peaks)
    # the fp32 inputs: 16.8 MB at 3.35 TB/s
    assert b1["bound_by"] == "bytes" and abs(b1["bound_ms"] - 0.00505) < 1e-4
    assert b2["bound_by"] == "bytes" and b2["bound_ms"] > b1["bound_ms"]
    F = torch.empty(B, H, 3, 3)
    p = torch.empty(B, N, 2)
    mask = torch.ones(B, N, dtype=torch.bool)
    k2 = work.ransac_score_work(F, p, p, mask).ops
    for gate, products in ps.VARIANTS:
        w = ps.score_variant.work(F, p, p, mask, TAU, gate, products)
        b = work.bound(w, peaks)
        if products == "f32":        # the whole chain on the CUDA cores, as K2
            assert w.unit == "instr" and w.ops >= k2
        else:                        # products on the matrix unit, the gate on the cores
            assert w.unit == "bf16_tc" and w.more[0][0] < k2 / 2
            assert b["bound_unit"] == "instr"
