"""Phase-rotation ops: psi * exp(i * coeff * field).

These are the memory-bound elementwise interludes between FFTs in the KDK
step (`simulator/src/simulation_object.rs:504-516,535-545,562-574`). The
expressions below are written on real planes so XLA fuses each into a
single elementwise loop (and folds it into its producer or consumer where
it can).
"""

from __future__ import annotations

import jax.numpy as jnp


def _rotate_jnp(z, theta):
    """z * exp(i * theta) on real planes: one fused cos/sin + FMA loop."""
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    re, im = jnp.real(z), jnp.imag(z)
    return (re * c - im * s) + 1j * (re * s + im * c)


def apply_kinetic_phase(psik, spec_grid, coeff):
    """psik * exp(i * coeff * k^2); coeff broadcastable against spec_grid."""
    theta = jnp.asarray(coeff).astype(spec_grid.dtype) * spec_grid
    return _rotate_jnp(psik, theta)


def apply_potential_phase(psi, phi, coeff):
    """psi * exp(i * coeff * phi); phi is real with psi's shape."""
    theta = jnp.asarray(coeff).astype(phi.dtype) * phi
    return _rotate_jnp(psi, theta)
