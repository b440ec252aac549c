"""Quantum phase-space sampling schemes (Poisson / Wigner / Husimi).

Counterpart of `sample_quantum_perturbation`
(`simulator/src/ics.rs:434-648`). The field is converted to an expected
particle count per cell (psi * sqrt(dx^dims)), perturbed by sampling the
chosen quantum distribution, and converted back to a density amplitude:

  Poisson:  |psi'| = sqrt(Poisson(n * |count|^2) / n), phase preserved
  Wigner:   psi'  += (N(0,1) + i N(0,1)) / (2 sqrt(n))
  Husimi:   psi'  += (N(0,1) + i N(0,1)) / (sqrt(2) sqrt(n))

where n = total_mass / particle_mass is the total particle number.

All three schemes run on-device with `jax.random` (threefry counter RNG) and
batch over a leading stream axis via `vmap`. Deliberate divergence from the
reference: its Poisson path draws host-side from `rand::thread_rng()`,
ignoring the stream seed entirely (`ics.rs:497`) — ours is seeded and
reproducible, so parity with the reference is statistical (mean/variance),
never bitwise.

Precision note: n can be astronomically large (hbar_-specified configs give
n ~ 1e99, far beyond float32/float64 dynamic range in intermediate products),
so all n-dependent scales are resolved host-side in Python floats. When the
perturbation scale 1/sqrt(n) underflows the working dtype the perturbation
is exactly zero at that precision and sampling is a (documented) no-op.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..config import SimulationParameters


def stream_key(seed) -> jax.Array:
    """Per-stream PRNG key derived from the stream's integer seed."""
    return jax.random.key(jnp.asarray(seed, jnp.uint32))


def _perturbation_scale(scheme: str, n_tot: float) -> float:
    """1 / (c * sqrt(n)): c = 2 (Wigner, ics.rs:578-585), sqrt(2) (Husimi,
    ics.rs:621-629); for Poisson this is the relative-fluctuation scale."""
    c = {"Poisson": 1.0, "Wigner": 2.0, "Husimi": math.sqrt(2.0)}[scheme]
    return 1.0 / (c * math.sqrt(n_tot))


@partial(jax.jit, static_argnames=("scheme", "dims", "dx", "n_tot"))
def _sample(psi, key, scheme: str, dims: int, dx: float, n_tot: float):
    rdtype = jnp.finfo(psi.dtype).dtype
    sqrt_measure = math.sqrt(dx**dims)
    scale = _perturbation_scale(scheme, n_tot)

    if scheme == "Poisson":
        # lam = |psi|^2 dx^d * n per cell (ics.rs:507-515). Large-lam cells
        # use the Gaussian limit Poisson(lam) ~ lam + sqrt(lam) N(0,1)
        # (as rand_distr does internally for the reference), arranged so no
        # intermediate ever forms lam itself — only sqrt(lam)/n-free terms —
        # keeping huge n within dtype range.
        prob = jnp.real(psi * jnp.conj(psi)) * jnp.asarray(dx**dims, rdtype)
        sqrt_prob = jnp.sqrt(prob)
        sqrt_lam = sqrt_prob * jnp.asarray(math.sqrt(n_tot), rdtype)
        use_normal = sqrt_lam > 1e3  # lam > 1e6
        lam_small = jnp.where(use_normal, 0.0, sqrt_lam * sqrt_lam)
        pois = jax.random.poisson(key, lam_small).astype(rdtype)
        gauss = jax.random.normal(jax.random.fold_in(key, 2), psi.shape, rdtype)
        # draws / n, branch-free in range:
        #   small lam: pois * (1/n); large lam: prob + sqrt(prob) * N * scale
        draws_over_n = jnp.where(
            use_normal,
            prob + sqrt_prob * gauss * jnp.asarray(scale, rdtype),
            pois * jnp.asarray(1.0 / n_tot, rdtype),
        )
        magnitude = jnp.sqrt(jnp.maximum(draws_over_n, 0.0))
        phase = jnp.exp(1j * jnp.angle(psi)).astype(psi.dtype)
        new_count = magnitude.astype(psi.dtype) * phase
    elif scheme in ("Wigner", "Husimi"):
        count = psi * jnp.asarray(sqrt_measure, psi.dtype)
        re = jax.random.normal(key, psi.shape, rdtype)
        im = jax.random.normal(jax.random.fold_in(key, 1), psi.shape, rdtype)
        noise = (re + 1j * im).astype(psi.dtype) * jnp.asarray(scale, psi.dtype)
        new_count = count + noise
    else:
        raise ValueError(f"unknown sampling scheme: {scheme!r}")

    return new_count * jnp.asarray(1.0 / sqrt_measure, psi.dtype)


def _is_noop(scheme: str, n_tot: float, dtype) -> bool:
    """Whether the perturbation underflows to exactly zero at this dtype."""
    scale = _perturbation_scale(scheme, n_tot)
    tiny = float(jnp.finfo(jnp.finfo(jnp.dtype(dtype)).dtype).tiny)
    return scale < tiny


def sample_quantum_perturbation(
    psi: jax.Array,
    params: SimulationParameters,
    seed,
    scheme: str,
) -> jax.Array:
    """Perturb one stream's psi according to its sampling scheme and seed."""
    if _is_noop(scheme, params.n_tot, psi.dtype):
        return psi
    return _sample(psi, stream_key(seed), scheme, params.dims, params.dx, params.n_tot)


def sample_stream_batch(
    psi: jax.Array,
    params: SimulationParameters,
    seeds: jax.Array,
    scheme: str,
) -> jax.Array:
    """Vectorized sampling: one shared psi -> (n_streams, *grid) perturbed.

    This replaces the reference's sequential per-seed loop
    (`simulator/src/main.rs:43-79`): every stream's perturbation is drawn in
    one batched, device-resident op.
    """
    n = len(seeds)
    seeds = jnp.asarray(seeds, jnp.uint32)

    @partial(jax.jit, static_argnames=("noop",))
    def batch(psi, seeds, noop):
        if noop:
            return jnp.broadcast_to(psi[None], (n,) + psi.shape)
        keys = jax.vmap(stream_key)(seeds)
        return jax.vmap(
            lambda k: _sample(psi, k, scheme, params.dims, params.dx, params.n_tot)
        )(keys)

    return batch(psi, seeds, noop=_is_noop(scheme, params.n_tot, psi.dtype))
