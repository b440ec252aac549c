"""Grid utilities: k-grids, spectral grids, normalization, sanity checks.

Counterpart of `simulator/src/utils/fft.rs:100-161` (k grids) and
`simulator/src/utils/grid.rs:11-105` (normalize / check_norm / NaN scans).

Axis convention: config axis i (x=0, y=1, z=2) lives on array axis
``dims - 1 - i`` so that x is the fastest-varying (last) axis, making dumps
byte-compatible with the reference's column-major ArrayFire buffers written
to row-major npy (see `config.SimulationParameters.shape`).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def get_kgrid(dx: float, size: int, dtype=np.float64) -> np.ndarray:
    """Fourier frequencies in cycles per unit length (fftfreq layout).

    k[i] = i / (size * dx) for i < size/2, else (i - size) / (size * dx).
    Matches `get_kgrid` (`simulator/src/utils/fft.rs:100-120`), which asserts
    an even grid size.
    """
    assert size % 2 == 0, "grid size must be even"
    return np.fft.fftfreq(size, d=dx).astype(dtype)


def spec_grid(dx: float, dims: int, size: int, dtype=np.float64) -> np.ndarray:
    """k^2 spectral grid: (2*pi)^2 * sum_i k_i^2, shape (size,)*dims.

    Matches `spec_grid` (`simulator/src/utils/fft.rs:123-161`): broadcast-add
    of squared fftfreq per axis, scaled by (2*pi)^2. Built host-side with
    numpy (it is a compile-time constant folded into the jitted step).
    """
    k2_1d = get_kgrid(dx, size, dtype) ** 2
    out = np.zeros((size,) * dims, dtype=dtype)
    for axis in range(dims):
        shape = [1] * dims
        shape[axis] = size
        out = out + k2_1d.reshape(shape)
    return out * (2.0 * math.pi) ** 2


def k2_max(dx: float, dims: int, size: int) -> float:
    """Maximum of the spectral grid (reference: simulation_object.rs:274)."""
    kmax = np.abs(get_kgrid(dx, size)).max()
    return float(dims * (2.0 * math.pi * kmax) ** 2)


def norm_squared(psi: jnp.ndarray, dx: float, dims: int) -> jnp.ndarray:
    """sum |psi|^2 * dx^dims — should be 1 for a normalized field."""
    return jnp.sum(jnp.abs(psi) ** 2) * dx**dims


def normalize(psi: jnp.ndarray, dx: float, dims: int) -> jnp.ndarray:
    """Scale psi so that sum |psi|^2 dx^dims = 1.

    Matches `normalize` (`simulator/src/utils/grid.rs:11-33`).
    """
    norm = jnp.sum(jnp.real(psi * jnp.conj(psi)))
    return psi * jnp.sqrt(dx ** float(-dims) / norm).astype(psi.dtype)


def check_norm(psi, dx: float, dims: int, eps: float = 1e-4) -> bool:
    """Whether psi is normalized to within eps (grid.rs:35-64)."""
    return bool(abs(float(norm_squared(psi, dx, dims)) - 1.0) < eps)


def check_finite(arr) -> bool:
    """True when arr has no NaNs or Infs (grid.rs:66-105)."""
    return bool(jnp.all(jnp.isfinite(arr.real)) & jnp.all(jnp.isfinite(arr.imag)))
