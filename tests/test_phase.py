"""Elementwise step pieces against numpy closed forms: the kinetic and
potential phase rotations (`ops/phase.py`) and the spectral Poisson solve
(`Stepper._poisson_multiply` on the full spectrum, `Stepper._potential` on
the half spectrum), in 1-D, 2-D and 3-D."""

import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu import config as cfg
from msm_tpu import grid
from msm_tpu.ops.phase import apply_kinetic_phase, apply_potential_phase
from msm_tpu.stepper import Stepper


def _params(dims, size=16):
    toml = cfg.TomlParameters(
        axis_length=30.0,
        final_sim_time=1.0,
        cfl=0.5,
        num_data_dumps=2,
        total_mass=1e11,
        sim_name="phase",
        k2_cutoff=0.95,
        alias_threshold=0.02,
        dims=dims,
        size=size,
        ics=cfg.ColdGauss(mean=(15.0,) * dims, std=(3.0,) * dims),
        hbar_=0.05,
    )
    return cfg.resolve_parameters(toml)


def _field(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("op", ["kinetic", "potential", "poisson"])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_matches_closed_form(rng, op, dims):
    p = _params(dims)
    shape = (p.size,) * dims
    k2 = grid.spec_grid(p.dx, dims, p.size)
    axes = tuple(range(-dims, 0))
    if op == "kinetic":
        psik = _field(rng, (2,) + shape)  # per-stream coefficients
        coeff = np.array([-0.3, 0.7]).reshape(2, *(1,) * dims)
        got = apply_kinetic_phase(jnp.asarray(psik), jnp.asarray(k2), coeff)
        want = psik * np.exp(1j * coeff * k2)
    elif op == "potential":
        psi = _field(rng, shape)
        phi = rng.standard_normal(shape)
        got = apply_potential_phase(jnp.asarray(psi), jnp.asarray(phi), -1.3)
        want = psi * np.exp(-1.3j * phi)
    else:
        st = Stepper(p, jnp.complex128)
        rho = np.abs(_field(rng, shape)) ** 2
        rho_k = np.fft.fftn(rho, axes=axes, norm="ortho")
        with np.errstate(divide="ignore"):
            inv = np.where(k2 > 0, 1.0 / k2, 0.0)
        want_k = -st.poisson_coeff * inv * rho_k
        got_k = st._poisson_multiply(jnp.asarray(rho_k), st.consts)
        np.testing.assert_allclose(np.asarray(got_k), want_k, rtol=1e-12, atol=1e-300)
        # the half-spectrum solve on a real density: phi = F^-1[want_k]
        # with psi = sqrt(rho / prefactor) so that prefactor |psi|^2 = rho
        psi = np.sqrt(rho / st.density_prefactor)
        got = st._potential(jnp.asarray(psi, jnp.complex128))
        want = np.real(np.fft.ifftn(want_k, axes=axes, norm="ortho"))
        # unnormalized rfft/irfft pair == ortho fftn/ifftn pair
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=0, atol=1e-12 * np.abs(want).max()
        )
        return
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)
