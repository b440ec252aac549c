"""Flat-LCDM cosmology: scale-factor evolution and tau <-> t conversion.

Counterpart of `simulator/src/expanding.rs` (a thin wrapper over
the external `cosmology` crate) plus the tau/t machinery in
`simulator/src/simulation_object.rs:1344-1453`.

The Friedmann equation for a flat universe:

    da/dt = H0 * sqrt(Omega_m / a + Omega_r / a^2 + Omega_de * a^2)

with H0 = h * LITTLE_H_TO_BIG_H in 1/Myr. Super-comoving time tau obeys

    dtau/dt = C / a^2,   C = sqrt(3/2 * H0^2 * Omega_m)

(`simulation_object.rs:1418-1429`).

Design differences from the reference (documented, tolerance-based parity):

- The reference's `get_tau` re-integrates t -> tau from zero on every dump
  query, O(steps^2) over a run (`simulation_object.rs:1408-1453`). We
  precompute tau at every dump time once at setup (`tau_at_times`), making
  the in-step "tau to next dump" a table lookup carried into the jitted loop.
- The reference advances a(t) through a stateful nested solver inside RK4
  derivative evaluations (`:1344-1388`). We integrate the coupled system
  d(a, t)/dtau with a single classic RK4 step per half-kick — the same order
  of accuracy without solver-state cloning, and expressible inside jit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .config import CosmologyConfig

DEFAULT_MAX_DLOGA: float = 1e-3  # reference: expanding.rs:27


def a_dot(a, cosmo: CosmologyConfig):
    """da/dt from the flat Friedmann equation."""
    h0 = cosmo.h0_per_myr
    return h0 * np.sqrt(
        cosmo.omega_matter_now / a
        + cosmo.omega_radiation_now / a**2
        + cosmo.omega_de_now * a**2
    )


def a_dot_jax(a, cosmo: CosmologyConfig):
    h0 = cosmo.h0_per_myr
    return h0 * jnp.sqrt(
        cosmo.omega_matter_now / a
        + cosmo.omega_radiation_now / a**2
        + cosmo.omega_de_now * a**2
    )


def supercomoving_coeff(cosmo: CosmologyConfig) -> float:
    """C = sqrt(3/2 * H0^2 * Omega_m): dtau/dt = C / a^2."""
    return float(np.sqrt(1.5 * cosmo.omega_matter_now * cosmo.h0_per_myr**2))


@dataclasses.dataclass
class ScaleFactorSolver:
    """Host-side a(t) integrator with max_dloga-bounded RK4 substeps.

    Mirrors the behavior of the `cosmology` crate wrapper
    (`expanding.rs:56-118`): starts at a = 1/(1+z0), t = 0; `step(dt)`
    advances by dt using substeps no larger than max_dloga * a / (da/dt).
    """

    cosmo: CosmologyConfig
    a: float = dataclasses.field(init=False)
    t: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.a = 1.0 / (1.0 + self.cosmo.z0)
        self.t = 0.0
        self.max_dloga = (
            self.cosmo.max_dloga
            if self.cosmo.max_dloga is not None
            else DEFAULT_MAX_DLOGA
        )

    def step(self, dt: float) -> float:
        remaining = dt
        while remaining > 0.0:
            h = min(remaining, self.max_dloga * self.a / a_dot(self.a, self.cosmo))
            self.a = _rk4_scalar(lambda a: a_dot(a, self.cosmo), self.a, h)
            self.t += h
            remaining -= h
        return self.a

    def get_a(self) -> float:
        return self.a

    def get_dadt(self) -> float:
        return float(a_dot(self.a, self.cosmo))


def _rk4_scalar(f, y, h):
    k1 = f(y)
    k2 = f(y + h * k1 / 2.0)
    k3 = f(y + h * k2 / 2.0)
    k4 = f(y + h * k3)
    return y + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def tau_at_times(cosmo: CosmologyConfig, times: np.ndarray) -> np.ndarray:
    """tau(t) at each requested time (sorted, >= 0), via one fine sweep.

    Equivalent to calling the reference's `get_tau`
    (`simulation_object.rs:1408-1453`) per time, but integrated once: the
    coupled (a, tau) system is swept over [0, max(times)] with
    max_dloga-bounded RK4 steps and tau is recorded at each target.
    """
    times = np.asarray(times, dtype=np.float64)
    assert np.all(np.diff(times) >= 0.0), "times must be sorted"
    out = np.zeros_like(times)
    if times.size == 0:
        return out

    max_dloga = cosmo.max_dloga if cosmo.max_dloga is not None else DEFAULT_MAX_DLOGA
    coeff = supercomoving_coeff(cosmo)
    target_max = float(times[-1])

    a = 1.0 / (1.0 + cosmo.z0)
    t = 0.0
    tau = 0.0
    idx = 0
    while idx < times.size and times[idx] <= 0.0:
        out[idx] = 0.0
        idx += 1

    # Reference step-size rule (simulation_object.rs:1436-1444): for each
    # queried target, dt = min(target/1000, max_dloga * a / dadt, remaining).
    base_h = target_max / 1000.0 if target_max > 0 else 0.0
    while idx < times.size:
        target = float(times[idx])
        h = min(base_h, max_dloga * a / a_dot(a, cosmo), target - t)

        def deriv(state):
            a_, tau_ = state
            da = a_dot(a_, cosmo)
            dtau = coeff / a_**2
            return np.array([da, dtau])

        state = np.array([a, tau])
        k1 = deriv(state)
        k2 = deriv(state + h * k1 / 2.0)
        k3 = deriv(state + h * k2 / 2.0)
        k4 = deriv(state + h * k3)
        state = state + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        a, tau = float(state[0]), float(state[1])
        t += h

        while idx < times.size and t >= times[idx] - 1e-12 * max(1.0, target_max):
            out[idx] = tau
            idx += 1
    return out


def get_tau(cosmo: CosmologyConfig, target_time: float) -> float:
    """tau at a single target time (reference get_tau semantics)."""
    return float(tau_at_times(cosmo, np.array([target_time]))[0])


def advance_a_t_by_dtau(a, t, dtau, cosmo: CosmologyConfig):
    """One RK4 step of d(a, t)/dtau — jit-compatible, used inside the step.

    dt/dtau = a^2 / C;  da/dtau = (da/dt) * a^2 / C.
    Replaces the reference's solver-clone-plus-RK4 `calculate_dt_from_dtau`
    (`simulation_object.rs:1344-1388`) and the scale-factor advance between
    potential half-kicks (`:726-760`).
    """
    inv_c = 1.0 / supercomoving_coeff(cosmo)

    def deriv(a_):
        dt_dtau = a_**2 * inv_c
        return a_dot_jax(a_, cosmo) * dt_dtau, dt_dtau

    ka1, kt1 = deriv(a)
    ka2, kt2 = deriv(a + dtau * ka1 / 2.0)
    ka3, kt3 = deriv(a + dtau * ka2 / 2.0)
    ka4, kt4 = deriv(a + dtau * ka3)
    a_new = a + dtau * (ka1 + 2.0 * ka2 + 2.0 * ka3 + ka4) / 6.0
    t_new = t + dtau * (kt1 + 2.0 * kt2 + 2.0 * kt3 + kt4) / 6.0
    return a_new, t_new
