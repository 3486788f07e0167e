"""The port's penalty-model layer (features, Lasso, calibration, fleet
cache) against the JAX package's on the same numpy inputs, on the CPU.

Tolerances: features 1e-4 relative (float32 cumsums summed in another
order); FISTA weights 1e-4 (the same float32 iteration on two BLAS
builds); the calibrated fleet's k and β 1e-4 relative (the EDD labels are
the same numpy code; only the float32 features differ in their last
bits, before a float64 least-squares fit).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.penalty as jpen
from repro.core import features as jfeat
from repro.core import fleetcache as jcache
from repro.core.lasso import fit_lasso_cv as j_fit_lasso_cv
from repro.core.lasso import lasso_fista as j_lasso_fista
from repro_torch import convert
from repro_torch.core import features as tfeat
from repro_torch.core import fleetcache as tcache
from repro_torch.core import penalty as tpen
from repro_torch.core.lasso import fit_lasso_cv, lasso_fista

T = 48


def _rows(W, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 1.0, (W, T)).astype(np.float32)
    u = (np.abs(rng.normal(2.0, 0.3, (W, T))) + 0.5).astype(np.float32)
    j = (np.abs(rng.normal(1.0, 0.2, (W, T))) + 0.1).astype(np.float32)
    return d, u, j


@pytest.mark.parametrize("smooth", [0.0, 0.5])
def test_feature_matrix_matches_jax(smooth):
    d, u, j = _rows(7, seed=1)
    want = jfeat.feature_matrix(d, u, j, slo_hours=4, smooth=smooth)
    got = tfeat.feature_matrix(*(torch.as_tensor(a) for a in (d, u, j)),
                               slo_hours=4, smooth=smooth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("workload", ["AITraining", "DataPipeline"])
def test_selected_features_match_jax(workload):
    d, u, j = _rows(3, seed=2)
    want = jfeat.selected_features(workload, d[0], u[0], j[0])
    got = tfeat.selected_features(workload, *(torch.as_tensor(a[0])
                                              for a in (d, u, j)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _design(n, F, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X = (X - X.mean(0)) / X.std(0)
    w = np.r_[1.5, -2.0, np.zeros(F - 2)]
    y = X @ w + 0.3 * rng.normal(size=n) + 4.0
    return X, y


def test_lasso_fista_matches_jax():
    X, y = _design(80, 5, seed=3)
    wj, bj = j_lasso_fista(jnp.asarray(X), jnp.asarray(y), jnp.asarray(0.05),
                           iters=500)
    wt, bt = lasso_fista(torch.as_tensor(X, dtype=torch.float32),
                         torch.as_tensor(y, dtype=torch.float32), 0.05,
                         iters=500)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-4)
    assert float(bt) == pytest.approx(float(bj), rel=1e-6)


def test_fit_lasso_cv_matches_jax():
    X, y = _design(60, 5, seed=4)
    X = X * np.array([1.0, 3.0, 0.5, 2.0, 1.0]) + 1.0
    want = j_fit_lasso_cv(X, y, seed=0)
    got = fit_lasso_cv(X, y, seed=0, device="cpu")
    assert got.alpha == want.alpha
    assert got.selected == want.selected
    np.testing.assert_allclose(got.coef, want.coef, rtol=1e-4, atol=1e-4)
    assert got.intercept == pytest.approx(want.intercept, rel=1e-4)
    assert got.r2 == pytest.approx(want.r2, rel=1e-5)


@pytest.fixture(scope="module")
def both_fleets():
    """`build_paper_fleet(num_samples=32, num_jobs=1000)` in both
    packages. The JAX package seeds job traces with Python's `hash`; for
    one comparable build its module is handed the port's `name_hash`."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        ref = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    return ref, tpen.build_paper_fleet(num_samples=32, num_jobs=1000,
                                       device="cpu")


def test_build_paper_fleet_matches_jax(both_fleets):
    ref, ours = both_fleets
    assert list(ours) == list(ref)
    for name, m in ours.items():
        r = ref[name]
        assert (m.kind, m.feature_names) == (r.kind, r.feature_names)
        np.testing.assert_array_equal(m.usage, r.usage)
        if r.jobs is not None:
            np.testing.assert_array_equal(m.jobs, r.jobs)
        assert m.k == pytest.approx(r.k, rel=1e-4)
        np.testing.assert_allclose(m.params, r.params, rtol=1e-4)


def test_penalties_match_jax(both_fleets):
    ref, ours = both_fleets
    rng = np.random.default_rng(5)
    for name, m in ours.items():
        d = (0.3 * m.usage * rng.uniform(-0.5, 1.0, m.usage.shape)
             ).astype(np.float32)
        for smooth in (0.0, 0.2):
            want = float(ref[name].penalty(jnp.asarray(d), smooth))
            got = float(m.penalty(torch.as_tensor(d), smooth))
            assert got == pytest.approx(want, rel=1e-4, abs=1e-6), name


def test_cache_layout_round_trip(both_fleets, tmp_path):
    """The port writes the JAX package's .npz layout under its own key,
    and reads the JAX package's cache files."""
    ref, ours = both_fleets
    first = tcache.cached_paper_fleet(num_samples=32, num_jobs=1000,
                                      device="cpu", cache_dir=tmp_path)
    (path,) = tmp_path.glob("*.npz")
    assert path.name == "torch_fleet_h48_p100_s32_j1000_r0.npz"
    again = tcache.cached_paper_fleet(num_samples=32, num_jobs=1000,
                                      device="cpu", cache_dir=tmp_path)
    read_by_jax = jcache._load_cache(path)
    for name, m in first.items():
        assert (m.k, m.params) == (ours[name].k, ours[name].params)
        for other in (again[name], read_by_jax[name]):
            assert (other.k, other.params) == (m.k, m.params)
            np.testing.assert_array_equal(other.usage, m.usage)
    carried = {n: convert.penalty_model_from_arrays(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(m)})
        for n, m in ref.items()}
    tcache.save_cache(tmp_path / "ref.npz", carried)
    back = jcache._load_cache(tmp_path / "ref.npz")
    for name, m in ref.items():
        assert (back[name].k, back[name].params) == (m.k, m.params)
        assert back[name].feature_names == m.feature_names


def test_cache_key_names_the_calibrating_device():
    """A fleet calibrated on the card is cached apart from one calibrated
    on the CPU (their float32 fits round differently), under the CPU's
    key with the device type appended."""
    cpu = tcache.cache_key(48, 100.0, 32, 1000, 0, torch.device("cpu"))
    assert cpu == "torch_fleet_h48_p100_s32_j1000_r0"
    assert tcache.cache_key(48, 100.0, 32, 1000, 0,
                            torch.device("cuda")) == cpu + "_cuda"
    assert tcache.cache_key(48, 100.0, 32, 1000, 0,
                            torch.device("cuda", 1)) == cpu + "_cuda"
