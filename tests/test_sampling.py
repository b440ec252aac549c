"""Statistical tests for the quantum sampling schemes — the moment checks
the reference does offline in `simulator/check_var.py:25-54`."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu import config as cfg
from msm_tpu.models import ics, sampling


def _params(ntot, dims=2, size=32, L=16.0):
    toml = cfg.TomlParameters(
        axis_length=L,
        final_sim_time=10.0,
        cfl=0.5,
        num_data_dumps=10,
        total_mass=1e10,
        sim_name="t",
        k2_cutoff=0.95,
        alias_threshold=0.02,
        dims=dims,
        size=size,
        ics=cfg.ColdGauss(mean=(L / 2,) * dims, std=(L / 5,) * dims),
        ntot=ntot,
        hbar_=0.05,
    )
    return cfg.resolve_parameters(toml)


def _base_psi(p):
    return jnp.asarray(ics.build_ics(p), jnp.complex128)


@pytest.mark.parametrize("scheme", ["Wigner", "Husimi"])
def test_gaussian_schemes_moments(scheme):
    """Per-cell count perturbation: mean 0, E|delta|^2 = 2/(c^2 n)."""
    p = _params(ntot=1e6)
    psi = _base_psi(p)
    seeds = jnp.arange(1, 65, dtype=jnp.uint32)
    batch = sampling.sample_stream_batch(psi, p, seeds, scheme)
    delta_count = (np.asarray(batch) - np.asarray(psi)[None]) * p.dx ** (p.dims / 2)
    c2 = 4.0 if scheme == "Wigner" else 2.0
    expected_var = 2.0 / (c2 * p.n_tot)  # re + im variances
    measured = np.mean(np.abs(delta_count) ** 2)
    assert measured == pytest.approx(expected_var, rel=0.05)
    assert abs(np.mean(delta_count.real)) < 5 * np.sqrt(
        expected_var / delta_count.size
    )


def test_poisson_moments():
    """E[|psi'|^2] = |psi|^2; var of counts = lam (small-lam branch)."""
    p = _params(ntot=1e5)
    psi = _base_psi(p)
    seeds = jnp.arange(1, 129, dtype=jnp.uint32)
    batch = np.asarray(sampling.sample_stream_batch(psi, p, seeds, "Poisson"))
    dens = np.abs(batch) ** 2
    expected = np.abs(np.asarray(psi)) ** 2
    # ensemble mean of |psi'|^2 converges to |psi|^2
    err = np.abs(dens.mean(axis=0) - expected).max() / expected.max()
    assert err < 0.15
    # phases preserved
    mask = np.abs(batch) > 0
    ref_phase = np.exp(1j * np.angle(np.asarray(psi)))[None]
    np.testing.assert_allclose(
        np.angle(batch[mask] * np.conj(ref_phase * np.ones_like(batch))[mask]),
        0.0,
        atol=1e-6,
    )


def test_poisson_large_lambda_branch():
    """Huge n exercises the Gaussian-limit branch without overflow."""
    p = _params(ntot=1e20)
    psi = _base_psi(p)
    out = np.asarray(
        sampling.sample_quantum_perturbation(psi, p, seed=3, scheme="Poisson")
    )
    assert np.all(np.isfinite(out))
    # relative fluctuation ~ 1/sqrt(lam) is tiny at n=1e20
    rel = np.abs(np.abs(out) ** 2 - np.abs(np.asarray(psi)) ** 2).max() / (
        np.abs(np.asarray(psi)) ** 2
    ).max()
    assert rel < 1e-4


def test_seeds_reproducible_and_distinct():
    p = _params(ntot=1e6)
    psi = _base_psi(p)
    a = sampling.sample_quantum_perturbation(psi, p, 7, "Wigner")
    b = sampling.sample_quantum_perturbation(psi, p, 7, "Wigner")
    c = sampling.sample_quantum_perturbation(psi, p, 8, "Wigner")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.abs(np.asarray(a) - np.asarray(c)).max() > 0


def test_astronomical_n_is_noop_in_f32():
    """hbar_-specified configs give n ~ 1e99: perturbation underflows f32."""
    toml = cfg.read_toml(
        os.path.join(os.path.dirname(__file__), "fixtures", "spherical-tophat.toml")
    )
    p = cfg.resolve_parameters(toml)
    psi = jnp.asarray(ics.build_ics(p), jnp.complex64)
    out = sampling.sample_quantum_perturbation(psi, p, 1, "Husimi")
    np.testing.assert_array_equal(np.asarray(out), np.asarray(psi))


def test_norm_approximately_preserved():
    p = _params(ntot=1e8)
    psi = _base_psi(p)
    out = np.asarray(sampling.sample_quantum_perturbation(psi, p, 5, "Husimi"))
    norm = np.sum(np.abs(out) ** 2) * p.dx**p.dims
    assert norm == pytest.approx(1.0, rel=1e-2)


def test_poisson_gaussian_crossover_moment_continuity():
    """The Poisson sampler switches to the Gaussian limit at lam > 1e6
    (sampling.py sqrt_lam > 1e3 branch). Moments of the per-cell counts
    must be continuous across the threshold: mean ~ lam, var ~ lam on both
    sides, and the two branches agree on overlapping statistics."""
    from msm_tpu.models.sampling import _sample, stream_key

    n_cells = 1 << 14
    dims, dx = 1, 1.0
    results = {}
    for tag, lam in (("below", 0.64e6), ("above", 1.44e6)):
        # uniform |psi|^2 so every cell has the same lam = |psi|^2 dx n_tot
        n_tot = 1e12
        amp = math.sqrt(lam / n_tot)
        psi = jnp.full((n_cells,), amp + 0j, jnp.complex128)
        out = _sample(psi, stream_key(7), "Poisson", dims, dx, n_tot)
        counts = np.asarray(jnp.abs(out) ** 2) * dx * n_tot  # recovered draws
        mean, var = counts.mean(), counts.var()
        # Poisson(lam): mean = var = lam; allow 5 sigma of the estimators
        tol_mean = 5 * math.sqrt(lam / n_cells)
        assert abs(mean - lam) < tol_mean, (tag, mean, lam)
        assert abs(var - lam) < 0.05 * lam, (tag, var, lam)
        results[tag] = (mean / lam, var / lam)
    # continuity: normalized moments agree across the branch switch
    assert abs(results["below"][0] - results["above"][0]) < 1e-3
    assert abs(results["below"][1] - results["above"][1]) < 0.05
