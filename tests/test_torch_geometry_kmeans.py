"""The port's exact-cap and MIPS geometry, k-means++ seeding and
``datasets.uniform`` against the JAX package.

- ``exact_beta_fn`` and ``cap_fraction_exact`` are scipy's f64
  ``betainc`` to within f32 rounding (``exact_beta_fn`` rounds to f32, as
  the reference's result is), and agree with the reference's within
  1e-4: the reference evaluates ``jax.scipy.special.betainc`` in f32,
  which is itself up to 6.3e-5 off the f64 value over dims 2-256 (a grid
  of 2,001 points in [0, 1]), so no tighter bound against it can hold.
- The port's table-interpolated cap fraction agrees with its own exact
  form within 2e-3, the reference's bound (``tests/test_properties.py``).
- ``augment_for_mips``, ``MipsGeometry.rho_sq``, the k-means++ seeds and
  ``datasets.uniform`` are equal to the reference's; the Lloyd steps
  after the seeding agree at the k-means parity tolerance of
  ``test_torch_core.py`` (centroids 1e-4, assignments 99%).
- APS-RP (the exact beta function in place of the table, ``tau_rho = 0``;
  paper Table 2) on a JAX-built index carried over to the port gives the
  reference's ids and nprobe.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from hypothesis import given, settings, strategies as st

from repro.core import geometry as jgeo
from repro.core import kmeans as jkmeans
from repro.core.index import QuakeConfig as JConfig
from repro.core.index import QuakeIndex as JIndex
from repro.data import datasets as jds
from repro_torch.core import geometry, kmeans
from repro_torch.core.convert import index_from_arrays
from repro_torch.data import datasets
from test_torch_core import export_jax_index

SET = settings(max_examples=20, deadline=None)
F32_ROUND = 1.2e-7          # half an f32 ulp below 2, and more
REF_TOL = 1e-4              # the reference's own f32 error is up to 6.3e-5


@given(st.integers(2, 256), st.integers(0, 10**6))
@SET
def test_exact_beta_fn_matches_reference(dim, seed):
    x = np.concatenate([np.linspace(0.0, 1.0, 33),
                        np.random.default_rng(seed).random(31)])
    got = geometry.exact_beta_fn(dim)(x)
    want = jgeo.exact_beta_fn(dim)(x)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, got.astype(np.float32))
    exact = scipy.special.betainc((dim + 1) / 2.0, 0.5,
                                  x.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0, atol=F32_ROUND)
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_TOL)


@given(st.integers(2, 256))
@SET
def test_cap_fraction_exact_matches_reference(dim):
    ts = np.linspace(-1.2, 1.2, 41).astype(np.float32)
    got = geometry.cap_fraction_exact(torch.as_tensor(ts), dim)
    want = np.asarray(jgeo.cap_fraction_exact(jnp.asarray(ts), dim))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)


@given(st.integers(2, 256))
@SET
def test_port_table_matches_its_exact_form(dim):
    ts = torch.linspace(-1, 1, 33)
    approx = geometry.cap_fraction(
        ts, torch.as_tensor(geometry.betainc_table(dim)))
    exact = geometry.cap_fraction_exact(ts, dim)
    np.testing.assert_allclose(approx.numpy(), exact.numpy(), atol=2e-3)


def test_cap_fraction_exact_keeps_dtype_and_bounds():
    ts = torch.tensor([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 3.0],
                      dtype=torch.float64)
    v = geometry.cap_fraction_exact(ts, 16)
    assert v.dtype == torch.float64 and v.device == ts.device
    assert v[3] == pytest.approx(0.5)
    assert v[0] == v[1] == pytest.approx(1.0)
    assert v[-1] == v[-2] == pytest.approx(0.0)
    assert bool((v[1:] <= v[:-1]).all())       # falls with the margin


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m2", [None, 50.0])
def test_augment_for_mips_equals_reference(dtype, m2):
    x = np.random.default_rng(3).normal(size=(40, 7)).astype(dtype)
    got, got_m2 = geometry.augment_for_mips(x, m2)
    want, want_m2 = jgeo.augment_for_mips(x, m2)
    assert got.dtype == want.dtype == dtype and got_m2 == want_m2
    np.testing.assert_array_equal(got, want)
    # the augmented rows all have the norm M
    np.testing.assert_allclose(np.sum(got.astype(np.float64) ** 2, -1),
                               got_m2, rtol=1e-5)


def test_mips_rho_sq_equals_reference():
    rng = np.random.default_rng(4)
    qn = rng.random(16).astype(np.float32) * 9
    kth = rng.normal(size=16).astype(np.float32) * 4
    mg, jmg = geometry.MipsGeometry(12.5), jgeo.MipsGeometry(12.5)
    want = np.asarray(jmg.rho_sq(jnp.asarray(qn), jnp.asarray(kth)))
    got_t = mg.rho_sq(torch.as_tensor(qn), torch.as_tensor(kth))
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(mg.rho_sq(qn, kth), want)
    assert float(mg.rho_sq(np.float32(0.0), np.float32(100.0))) == 0.0


@pytest.mark.parametrize("n,d,k,seed", [(300, 8, 6, 5), (1000, 16, 31, 0),
                                        (257, 3, 64, 11)])
def test_kmeanspp_seeds_bit_equal_then_converge(n, d, k, seed):
    x = jds.clustered(n, d, n_clusters=max(2, k // 2), seed=seed).vectors
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(kmeans._kmeanspp_init(x, k, rng_t),
                                  jkmeans._kmeanspp_init(x, k, rng_j))
    c0_t, _ = kmeans.kmeans(x, k, iters=0, seed=seed, init="pp",
                            device="cpu")
    c0_j, _ = jkmeans.kmeans(x, k, iters=0, seed=seed, init="pp")
    np.testing.assert_array_equal(c0_t, c0_j)
    c_t, a_t = kmeans.kmeans(x, k, iters=8, seed=seed, init="pp",
                             device="cpu")
    c_j, a_j = jkmeans.kmeans(x, k, iters=8, seed=seed, init="pp")
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    assert np.mean(a_t == a_j) > 0.99


def test_kmeans_init_is_checked():
    x = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="unknown init"):
        kmeans.kmeans(x, 2, init="kmeans||", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_uniform_equals_reference(metric):
    a = datasets.uniform(500, 12, seed=7, metric=metric)
    b = jds.uniform(500, 12, seed=7, metric=metric)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.cluster_of, b.cluster_of)
    np.testing.assert_array_equal(a.centers, b.centers)
    assert a.metric == b.metric == metric
    q = jds.queries_near(b, 9, seed=2)
    np.testing.assert_array_equal(a.ground_truth(q, 5),
                                  b.ground_truth(q, 5))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_aps_rp_search_matches_reference(metric):
    """APS-RP on the same index: the exact beta function (one evaluation
    per recall recompute) at ``tau_rho = 0`` in both packages."""
    ds = jds.clustered(3000, 16, n_clusters=24, seed=2, metric=metric)
    jidx = JIndex.build(ds.vectors,
                        config=JConfig(metric=metric, tau_rho=0.0),
                        kmeans_iters=4)
    state = export_jax_index(jidx)
    idx = index_from_arrays(state, device="cpu")
    idx_tab = index_from_arrays(state, device="cpu")   # the table (APS-R)
    assert idx.config.tau_rho == 0.0
    jidx._beta_table = jgeo.exact_beta_fn(jidx.geometry_dim)
    idx._beta_table = geometry.exact_beta_fn(idx.geometry_dim)
    q = jds.queries_near(ds, 24, seed=5)
    for i in range(len(q)):
        rj = jidx.search(q[i], 10, recall_target=0.9, record_stats=False)
        rt = idx.search(q[i], 10, recall_target=0.9, record_stats=False)
        np.testing.assert_array_equal(rt.ids, rj.ids)
        assert rt.nprobe == rj.nprobe
        assert rt.recall_estimate == pytest.approx(rj.recall_estimate,
                                                   abs=1e-5)
    # the exact form and the table plan alike here
    n_exact = [idx.search(q[i], 10, recall_target=0.9,
                          record_stats=False).nprobe[0] for i in range(24)]
    n_tab = [idx_tab.search(q[i], 10, recall_target=0.9,
                            record_stats=False).nprobe[0] for i in range(24)]
    assert abs(np.mean(n_exact) - np.mean(n_tab)) <= 1.0


def test_kmeanspp_seeds_the_index_build():
    """``init="pp"`` reaches the Lloyd steps on the index's device: a
    build seeded that way holds every point once."""
    x = datasets.uniform(800, 8, seed=1).vectors
    c, a = kmeans.kmeans(x, 20, iters=3, seed=0, init="pp", device="cpu")
    assert c.shape == (20, 8) and a.shape == (800,)
    assert set(np.unique(a)) <= set(range(20))
    d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    assert np.mean(d.argmin(1) == a) > 0.99
    assert dataclasses.is_dataclass(geometry.MipsGeometry(1.0))
