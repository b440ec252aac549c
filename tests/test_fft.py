"""FFT layer tests (mirrors `simulator/tests/fft.rs:1-601`): round-trip
identity and norm preservation for every dims x dtype combination, plus the
batched leading-axis path the reference doesn't have."""

import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu import grid
from msm_tpu.ops import fft


def _random_psi(rng, shape, dtype):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_roundtrip_identity(rng, dims, dtype):
    size = 16
    psi = _random_psi(rng, (size,) * dims, dtype)
    back = fft.inverse(fft.forward(psi, dims), dims)
    tol = 1e-6 if dtype == jnp.complex64 else 1e-12
    np.testing.assert_allclose(np.asarray(back), np.asarray(psi), atol=tol, rtol=tol)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_norm_preserved_in_k_space(rng, dims):
    # dk = dx convention: ortho FFT preserves sum|psi|^2, so a field
    # normalized wrt dx is normalized wrt dk (SURVEY.md §7).
    size = 8
    dx = 2.0 / size
    psi = _random_psi(rng, (size,) * dims, jnp.complex128)
    psi = grid.normalize(psi, dx, dims)
    psik = fft.forward(psi, dims)
    assert float(grid.norm_squared(psik, dx, dims)) == pytest.approx(1.0, abs=1e-10)


def test_matches_numpy_ortho(rng):
    psi = _random_psi(rng, (8, 8, 8), jnp.complex128)
    ours = np.asarray(fft.forward(psi, 3))
    ref = np.fft.fftn(np.asarray(psi), norm="ortho")
    np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_batched_leading_axis(rng):
    # A leading stream axis must be batched, not transformed.
    psi = _random_psi(rng, (4, 8, 8), jnp.complex128)
    out = fft.forward(psi, 2)
    for i in range(4):
        np.testing.assert_allclose(
            np.asarray(out[i]), np.asarray(fft.forward(psi[i], 2)), atol=1e-12
        )


@pytest.mark.parametrize(
    "dims,shape",
    [
        (1, (128,)),
        (1, (3, 256)),
        (1, (512,)),
        (1, (1024,)),
        (2, (256, 256)),
        (3, (128, 128, 128)),
    ],
)
def test_forward_inverse_match_numpy_f64(rng, dims, shape):
    """Both transforms against numpy's f64 FFT at the grid sizes the
    production configs use (leading batch axes included)."""
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    axes = tuple(range(-dims, 0))
    ref = np.fft.fftn(x, axes=axes, norm="ortho")
    got = np.asarray(fft.forward(jnp.asarray(x), dims))
    np.testing.assert_allclose(got, ref, atol=1e-12)
    back = np.asarray(fft.inverse(jnp.asarray(ref), dims))
    np.testing.assert_allclose(back, x, atol=1e-12)

