"""Ortho-normalized Fourier transforms over the spatial axes.

Counterpart of `simulator/src/utils/fft.rs:6-98`: the reference scales
ArrayFire FFTs by 1/N^(d/2) in both directions, which is exactly numpy/JAX
``norm="ortho"``. The spatial axes are always the *last* ``dims`` axes, so
any leading axes (the stream ensemble batch) are batched for free.

`jnp.fft` lowers to the vendor FFT library on the GPU (cuFFT) — the same
library the reference reaches through ArrayFire's CUDA backend. The
mesh-sharded pencil FFT lives in ``msm_tpu.parallel.pfft``.
"""

from __future__ import annotations

import jax.numpy as jnp


def _spatial_axes(dims: int) -> tuple[int, ...]:
    return tuple(range(-dims, 0))


def forward(psi: jnp.ndarray, dims: int) -> jnp.ndarray:
    """psi(x) -> psi(k), unitary normalization (fft.rs:6-30)."""
    return jnp.fft.fftn(psi, axes=_spatial_axes(dims), norm="ortho")


def inverse(psik: jnp.ndarray, dims: int) -> jnp.ndarray:
    """psi(k) -> psi(x), unitary normalization (fft.rs:32-57)."""
    return jnp.fft.ifftn(psik, axes=_spatial_axes(dims), norm="ortho")
