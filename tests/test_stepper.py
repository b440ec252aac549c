"""Stepper tests: unitarity, exact free-particle propagation, analytic
Poisson solve, alias detection, and dump scheduling.

The reference validates these only via debug_asserts in the hot loop
(`simulator/src/simulation_object.rs:485-529`); here they are real tests.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu import config as cfg
from msm_tpu import grid
from msm_tpu.constants import POIS_CONST
from msm_tpu.models import ics
from msm_tpu.ops import fft
from msm_tpu.stepper import Stepper


def _params(dims=1, size=64, L=30.0, total_mass=1e11, hbar_=0.05, **kw):
    defaults = dict(
        axis_length=L,
        final_sim_time=40.0,
        cfl=0.5,
        num_data_dumps=200,
        total_mass=total_mass,
        sim_name="t",
        k2_cutoff=0.95,
        alias_threshold=0.02,
        dims=dims,
        size=size,
        ics=cfg.ColdGauss(mean=(L / 2,) * dims, std=(L / 10,) * dims),
        hbar_=hbar_,
    )
    defaults.update(kw)
    toml = cfg.TomlParameters(**defaults)
    return cfg.resolve_parameters(toml)


def test_unitarity_over_many_steps():
    p = _params(dims=2, size=32)
    st = Stepper(p, jnp.complex128)
    state = st.init_state(ics.build_ics(p))
    for _ in range(20):
        state = st.step(state)
    assert float(grid.norm_squared(state.psi, p.dx, p.dims)) == pytest.approx(
        1.0, abs=1e-10
    )
    assert grid.check_finite(state.psi)


def test_free_particle_exact_propagation():
    """With negligible mass the step must reproduce the exact free
    propagator psi_k(t) = psi_k(0) * exp(-i hbar_ k^2 t / 2)."""
    p = _params(dims=1, size=128, total_mass=1e-30, num_data_dumps=40)
    st = Stepper(p, jnp.complex128)
    psi0 = ics.build_ics(p)
    state = st.init_state(psi0)
    state = st.snap_after_dump(st.evolve_to_next_dump(state))
    t = float(state.time)
    assert t == pytest.approx(1.0)  # 40 / 40 dumps

    psik0 = np.asarray(fft.forward(jnp.asarray(psi0), 1))
    spec = np.asarray(st.consts.spec_grid)
    exact_k = psik0 * np.exp(-1j * p.hbar_ * spec * t / 2.0)
    exact = np.fft.ifftn(exact_k, norm="ortho")
    np.testing.assert_allclose(np.asarray(state.psi), exact, atol=1e-10)


def test_potential_analytic_single_mode():
    """|psi|^2 = (1 + A cos(k0 x))/V  =>  phi = -C Mtot A cos(k0 x)/k0^2."""
    p = _params(dims=1, size=128)
    st = Stepper(p, jnp.complex128)
    L = p.axis_length
    x = (2 * np.arange(p.size) + 1) * p.dx / 2
    A = 0.3
    k0 = 2 * math.pi / L
    dens = (1 + A * np.cos(k0 * x)) / L
    psi = jnp.asarray(np.sqrt(dens), jnp.complex128)
    phi = np.asarray(st.potential(psi))
    expected = -POIS_CONST * p.total_mass * A * np.cos(k0 * x) / (L * k0**2)
    np.testing.assert_allclose(phi, expected, atol=1e-10 * np.abs(expected).max())


def test_potential_zero_mode_removed():
    p = _params(dims=1, size=64)
    st = Stepper(p, jnp.complex128)
    psi = jnp.full((p.size,), 1.0 / math.sqrt(p.axis_length), jnp.complex128)
    phi = np.asarray(st.potential(psi))
    np.testing.assert_allclose(phi, 0.0, atol=1e-12)  # uniform density => phi = 0


def test_timestep_dump_limited():
    # huge cfl + negligible mass: the dump boundary is the binding limit
    p = _params(dims=1, size=32, cfl=10.0, total_mass=1.0)
    st = Stepper(p, jnp.complex128)
    state = st.init_state(ics.build_ics(p))
    s = st.step(state)
    assert bool(s.just_dumped)
    assert float(s.time) == pytest.approx(
        p.final_sim_time / p.num_data_dumps, rel=1e-12
    )


def test_timestep_cfl_limited():
    p = _params(dims=1, size=32, cfl=1e-4)
    st = Stepper(p, jnp.complex128)
    state = st.init_state(ics.build_ics(p))
    s = st.step(state)
    assert not bool(s.just_dumped)
    dump_dt = p.final_sim_time / p.num_data_dumps
    assert float(s.time) < dump_dt


def test_alias_detection():
    """A field with all its mass at the highest k must trip the monitor."""
    p = _params(dims=1, size=64, alias_threshold=0.01)
    st = Stepper(p, jnp.complex128)
    # put everything in the top-k modes
    psik = np.zeros(p.size, np.complex128)
    psik[p.size // 2] = 1.0  # Nyquist: k^2 = k2_max region
    psik /= math.sqrt(np.sum(np.abs(psik) ** 2) * p.dk)
    psi = np.fft.ifftn(psik, norm="ortho")
    state = st.init_state(jnp.asarray(psi))
    s = st.step(state)
    assert bool(s.aliased)
    assert float(s.alias_mass) > p.alias_threshold


def test_evolve_to_dump_counts():
    p = _params(dims=1, size=32, num_data_dumps=10, final_sim_time=4.0)
    st = Stepper(p, jnp.complex128)
    state = st.init_state(ics.build_ics(p))
    for i in range(1, 4):
        state = st.snap_after_dump(st.evolve_to_next_dump(state))
        assert int(state.current_dumps) == i
        assert float(state.time) == pytest.approx(i * 0.4, rel=1e-12)
    assert st.not_finished(state)


def test_batched_streams_evolve_independently():
    p = _params(dims=1, size=32, num_data_dumps=5, final_sim_time=2.0)
    st = Stepper(p, jnp.complex128)
    psi0 = jnp.asarray(ics.build_ics(p))
    # two identical + one different stream
    x = jnp.arange(p.size) * p.dx
    other = grid.normalize(
        psi0 * jnp.exp(0.3j * jnp.sin(2 * jnp.pi * x / p.axis_length)), p.dx, 1
    )
    batch = jnp.stack([psi0, psi0, other])
    state = st.init_state(batch, batched=True)
    state = st.evolve_to_next_dump(state, batched=True)
    assert np.asarray(state.just_dumped).all()
    # identical streams stay identical; different stream differs
    psi = np.asarray(state.psi)
    np.testing.assert_array_equal(psi[0], psi[1])
    assert np.abs(psi[2] - psi[0]).max() > 1e-8
    # batched result matches unbatched run of the same stream
    solo = st.evolve_to_next_dump(st.init_state(psi0))
    np.testing.assert_allclose(psi[0], np.asarray(solo.psi), atol=1e-12)


def test_lagged_dt_mode():
    """Lagged-dt mode: one fewer Poisson solve per step, physically
    consistent trajectory (norm conserved, dt within CFL bounds, close to
    the exact-mode trajectory over a dump interval)."""
    p = _params(dims=2, size=32, num_data_dumps=20, final_sim_time=8.0)
    exact = Stepper(p, jnp.complex128, dt_mode="exact")
    lagged = Stepper(p, jnp.complex128, dt_mode="lagged")
    psi0 = ics.build_ics(p)

    se = exact.snap_after_dump(exact.evolve_to_next_dump(exact.init_state(psi0)))
    sl = lagged.snap_after_dump(lagged.evolve_to_next_dump(lagged.init_state(psi0)))

    assert float(grid.norm_squared(sl.psi, p.dx, p.dims)) == pytest.approx(
        1.0, abs=1e-10
    )
    # both land exactly on the dump boundary
    assert float(sl.time) == pytest.approx(float(se.time), rel=1e-12)
    # fields agree to integrator-order tolerance (dt sequences differ)
    err = float(jnp.abs(sl.psi - se.psi).max())
    scale = float(jnp.abs(se.psi).max())
    assert err / scale < 5e-3


def test_predict_bound_zero_potential_f32():
    """f32 regression: a zero-potential stream (uniform density -> phi=0,
    e.g. unperturbed ICs) must not poison the carried optimistic bound.
    A python 1e-300 floor underflows to 0.0 in float32 (the production
    non-x64 tdtype), making growth = 0/0 = NaN -> NaN dt -> a
    never-terminating jitted while_loop; the floor must be finfo.tiny of
    the carried dtype so 0/tiny = 0 and the clip lifts growth to 1."""
    p = _params(dims=1, size=32, num_data_dumps=2, final_sim_time=1.0)
    st = Stepper(p, jnp.complex128, dt_mode="optimistic")
    state = st.init_state(np.asarray(ics.build_ics(p)))
    zero32 = jnp.zeros((), jnp.float32)
    s = dataclasses.replace(state, phi_ref=zero32, phi_max=zero32)
    out = np.asarray(st._predict_bound(zero32, s))
    assert np.isfinite(out).all()
    assert float(out) == 0.0  # zero bound => infinite potential dt, CFL-safe


def test_optimistic_dt_matches_exact_when_not_potential_bound():
    """Optimistic mode (the production default): when dt is kinetic- or
    dump-bound throughout, the proposal equals the exact-mode dt and the
    trajectory is identical to exact mode with zero replays."""
    p = _params(
        dims=3, size=16, total_mass=1e6, num_data_dumps=2,
        final_sim_time=2.0, cfl=0.4,
    )
    psi0 = np.asarray(ics.build_ics(p))
    se = Stepper(p, jnp.complex128, dt_mode="exact")
    so = Stepper(p, jnp.complex128, dt_mode="optimistic")
    a = se.init_state(psi0)
    b = so.init_state(psi0)
    for _ in range(2):
        a = se.snap_after_dump(se.evolve_to_next_dump(a))
        b = so.snap_after_dump(so.evolve_to_next_dump(b))
        np.testing.assert_allclose(
            np.asarray(a.psi), np.asarray(b.psi), atol=1e-13
        )
        np.testing.assert_array_equal(
            np.asarray(a.n_steps), np.asarray(b.n_steps)
        )
        np.testing.assert_allclose(
            np.asarray(a.time), np.asarray(b.time), rtol=1e-14
        )
        assert int(b.replays) == 0


def test_optimistic_dt_potential_bound_validation_and_replay():
    """Potential-bound regime: optimistic takes ~1/safety more (smaller)
    steps than the stale lagged bound with zero replays in smooth
    evolution; an understated carried max|phi| forces a validation
    failure, which is replayed (not accepted) and the run still completes
    unitarily. Also covers the in-state dt telemetry."""
    p = _params(
        dims=3, size=16, total_mass=5e12, num_data_dumps=2,
        final_sim_time=0.5, cfl=0.4, alias_threshold=0.5,
    )
    psi0 = np.asarray(ics.build_ics(p))
    so = Stepper(p, jnp.complex128, dt_mode="optimistic")
    sl = Stepper(p, jnp.complex128, dt_mode="lagged")

    b = so.init_state(psi0)
    l = sl.init_state(psi0)
    kinetic = p.cfl * 2.0 * p.axis_length / (math.sqrt(so.k2_max) * p.hbar_)
    for _ in range(2):
        raw = so.evolve_to_next_dump(b)
        # telemetry: dt range populated pre-snap, within the CFL bounds
        assert 0.0 < float(raw.dt_min) <= float(raw.dt_max) <= kinetic + 1e-12
        b = so.snap_after_dump(raw)
        # snap resets the per-interval dt stats
        assert float(b.dt_min) == float("inf") and float(b.dt_max) == 0.0
        l = sl.snap_after_dump(sl.evolve_to_next_dump(l))
    n_opt, n_lag = int(b.n_steps), int(l.n_steps)
    assert n_opt > 2 * (p.num_data_dumps)  # genuinely potential-bound
    assert n_lag <= n_opt <= int(math.ceil(n_lag / so.dt_safety)) + 2
    assert int(b.replays) == 0  # smooth evolution: no validation failures
    assert float(np.sum(np.abs(np.asarray(b.psi)) ** 2) * p.dx**3) == (
        pytest.approx(1.0, abs=1e-10)
    )

    # force a replay: the carried bound understates the true potential, so
    # the first proposal is kinetic/dump-bound but potential-invalid
    forced = dataclasses.replace(
        so.init_state(psi0), phi_max=jnp.zeros_like(b.phi_max) + 1e-30
    )
    raw = so.evolve_to_next_dump(forced)
    assert int(raw.replays) >= 1
    assert bool(np.asarray(raw.just_dumped))
    assert float(
        np.sum(np.abs(np.asarray(raw.psi)) ** 2) * p.dx**3
    ) == pytest.approx(1.0, abs=1e-10)


def test_dt_init_bound_scale_env_knob(monkeypatch):
    """MSM_DT_INIT_BOUND_SCALE < 1 understates the INITIAL carried bound
    through the production init path (no state surgery), deterministically
    forcing the optimistic validation/replay machinery to execute — the
    knob __graft_entry__.dryrun_multichip uses so the driver artifact
    exercises replays on the mesh. Default (unset) leaves init_state at
    the true initial max|phi|; the run completes unitarily either way."""
    p = _params(
        dims=3, size=16, total_mass=5e12, num_data_dumps=2,
        final_sim_time=0.5, cfl=0.4, alias_threshold=0.5,
    )
    psi0 = np.asarray(ics.build_ics(p))
    monkeypatch.setenv("MSM_DT_INIT_BOUND_SCALE", "1e-4")
    so = Stepper(p, jnp.complex128, dt_mode="optimistic")
    st = so.init_state(psi0)
    # phi_ref keeps the true fresh value; only the carried proposal bound
    # is understated
    assert float(st.phi_max) == pytest.approx(
        1e-4 * float(st.phi_ref), rel=1e-12
    )
    raw = so.evolve_to_next_dump(st)
    assert int(raw.replays) >= 1
    assert float(
        np.sum(np.abs(np.asarray(raw.psi)) ** 2) * p.dx**3
    ) == pytest.approx(1.0, abs=1e-10)

    monkeypatch.delenv("MSM_DT_INIT_BOUND_SCALE")
    s_default = Stepper(p, jnp.complex128, dt_mode="optimistic")
    st2 = s_default.init_state(psi0)
    assert float(st2.phi_max) == pytest.approx(float(st2.phi_ref), rel=1e-12)


def test_optimistic_dt_expanding():
    """Expanding-universe optimistic mode: the validation bound carries
    the scale factor (dtau <= cfl*2pi/(2*a*max|phi|), get_timestep
    :969-975). Not-potential-bound => identical to exact; an understated
    carried bound forces a validated replay and the run still completes
    with a grown scale factor."""
    import math as _m

    from msm_tpu.constants import LITTLE_H_TO_BIG_H, POIS_CONST

    hbar_, h, z0 = 0.01, 0.5, 19.0
    cosmo = cfg.CosmologyConfig(
        omega_matter_now=1.0, omega_radiation_now=0.0, h=h, z0=z0,
        max_dloga=0.01,
    )
    h0 = h * LITTLE_H_TO_BIG_H
    box_sc = 100.0
    L_p = box_sc / _m.sqrt(_m.sqrt(1.5 * h0**2) / hbar_) / (1.0 + z0)

    def params(mass_scale):
        total_mass = mass_scale * box_sc**3 * hbar_**1.5 / (
            POIS_CONST * (2.0 / (3.0 * h0**2)) ** 0.25
        )
        return _params(
            dims=3, size=16, L=L_p, hbar_=hbar_, total_mass=total_mass,
            final_sim_time=40.0, num_data_dumps=2, cosmology=cosmo,
        )

    p = params(1.0)
    assert p.expanding
    psi0 = np.asarray(ics.build_ics(p))
    se = Stepper(p, jnp.complex128, dt_mode="exact")
    so = Stepper(p, jnp.complex128, dt_mode="optimistic")
    a = se.snap_after_dump(se.evolve_to_next_dump(se.init_state(psi0)))
    b = so.snap_after_dump(so.evolve_to_next_dump(so.init_state(psi0)))
    if int(b.replays) == 0 and int(a.n_steps) == int(b.n_steps):
        # not potential-bound at this mass: trajectories identical
        np.testing.assert_allclose(
            np.asarray(a.psi), np.asarray(b.psi), atol=1e-12
        )
    assert float(b.a) > 1.0 / (1.0 + z0)  # universe expanded

    # forced replay through the expanding validation path
    forced = dataclasses.replace(
        so.init_state(psi0), phi_max=jnp.zeros_like(b.phi_max) + 1e-30
    )
    raw = so.evolve_to_next_dump(forced)
    assert int(raw.replays) >= 1
    assert bool(np.asarray(raw.just_dumped))
    assert np.isfinite(np.asarray(raw.psi)).all()


def test_initial_time_offsets_dump_grid():
    """With time = t0 > 0 dumps land at t0 + i*T/n (the reference's
    "TODO: fix for initial_time != 0", simulation_object.rs:627-631,
    fixed here; divergence documented in PARITY.md)."""
    t0 = 5.0
    p = _params(dims=1, size=32, num_data_dumps=4, final_sim_time=2.0, time=t0)
    st = Stepper(p, jnp.complex128)
    np.testing.assert_allclose(st.dump_times, t0 + np.arange(5) * 0.5)
    state = st.init_state(ics.build_ics(p))
    assert float(state.time) == pytest.approx(t0)
    for i in range(1, 5):
        state = st.snap_after_dump(st.evolve_to_next_dump(state))
        assert int(state.current_dumps) == i
        assert float(state.time) == pytest.approx(t0 + i * 0.5, rel=1e-12)
    assert not st.not_finished(state)


def test_debug_checks_norm_monitor():
    """debug_checks carries a per-step unitarity monitor inside the jitted
    loop (the reference's per-substep debug_assert!(check_norm..),
    simulation_object.rs:485-529): tiny for a sane run, inf after a NaN."""
    p = _params(dims=1, size=64, num_data_dumps=4, final_sim_time=2.0)
    st = Stepper(p, jnp.complex128, debug_checks=True)
    state = st.init_state(ics.build_ics(p))
    state = st.snap_after_dump(st.evolve_to_next_dump(state))
    assert float(state.max_norm_err) < 1e-10
    assert int(state.n_steps) > 0

    bad = dataclasses.replace(
        state,
        psik=state.psik * jnp.nan,
        psi=state.psi * jnp.nan,
    )
    bad = st.step(bad)
    assert np.isinf(float(bad.max_norm_err))


def test_lagged_kick_fusion_consistency():
    """Lagged mode defers the closing half-kick via pending_k; states at
    dump boundaries must be fully materialized (pending 0, psi = F^-1 psik)
    and match exact-mode dumps to integrator tolerance."""
    p = _params(dims=2, size=32, num_data_dumps=8, final_sim_time=4.0)
    st_e = Stepper(p, jnp.complex128, dt_mode="exact")
    st_l = Stepper(p, jnp.complex128, dt_mode="lagged")
    psi0 = ics.build_ics(p)
    se = st_e.init_state(psi0)
    sl = st_l.init_state(psi0)
    for _ in range(3):
        se = st_e.snap_after_dump(st_e.evolve_to_next_dump(se))
        sl = st_l.snap_after_dump(st_l.evolve_to_next_dump(sl))
        assert float(jnp.abs(sl.pending_k).max()) == 0.0
        # psik fully materialized at dump exits
        np.testing.assert_allclose(
            np.asarray(sl.psi),
            np.asarray(fft.inverse(sl.psik, 2)),
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(sl.psi), np.asarray(se.psi), atol=5e-4
        )
        assert float(grid.norm_squared(sl.psi, p.dx, p.dims)) == pytest.approx(
            1.0, abs=1e-10
        )
    # mid-interval: pending is set on non-dump steps (the saved pass)
    s_mid = st_l.step(sl)
    if not bool(np.asarray(s_mid.just_dumped).any()):
        assert float(jnp.abs(s_mid.pending_k).max()) > 0.0


def _expanding_params(size):
    """A small EdS expanding box (supercomoving units, total mass chosen so
    the supercomoving density prefactor is O(1))."""
    from msm_tpu.constants import LITTLE_H_TO_BIG_H

    hbar_, h, z0 = 0.01, 0.5, 19.0
    cosmo = cfg.CosmologyConfig(
        omega_matter_now=1.0, omega_radiation_now=0.0, h=h, z0=z0, max_dloga=0.005
    )
    h0 = h * LITTLE_H_TO_BIG_H
    box_sc = 100.0
    L_p = box_sc / math.sqrt(math.sqrt(1.5 * h0**2) / hbar_) / (1.0 + z0)
    total_mass = box_sc**3 * hbar_**1.5 / (POIS_CONST * (2.0 / (3.0 * h0**2)) ** 0.25)
    return _params(
        dims=3, size=size, L=L_p, hbar_=hbar_, total_mass=total_mass,
        final_sim_time=50.0, num_data_dumps=4, cosmology=cosmo,
    )


# The plain c64 step against the c128 reference: one case per configuration
# the production step has to serve — 2-D static, a batched 3-D ensemble
# with the deferred (lagged) closing kick, the expanding double half-kick,
# and both validated (optimistic) and reference (exact) dt in 3-D.
_C64_CASES = {
    "2d-static-exact": (lambda: _params(dims=2, size=128, num_data_dumps=10,
                                        final_sim_time=4.0), "exact", 1),
    "3d-batched-lagged": (lambda: _params(dims=3, size=32, cfl=0.03,
                                          num_data_dumps=2, final_sim_time=4.0),
                          "lagged", 2),
    "3d-expanding": (lambda: _expanding_params(32), "exact", 1),
    "3d-optimistic": (lambda: _params(dims=3, size=32, total_mass=1e8,
                                      num_data_dumps=4), "optimistic", 1),
    "3d-exact": (lambda: _params(dims=3, size=32, total_mass=1e8,
                                 num_data_dumps=4), "exact", 1),
}


@pytest.mark.parametrize("case", sorted(_C64_CASES))
def test_c64_step_matches_c128_reference(case):
    """Four steps in complex64 stay within f32 rounding of the complex128
    trajectory from the same psi0: max|dpsi|/max|psi| <= 1e-4 (f32 eps is
    1.2e-7; each step is ~8 FFT passes of sqrt(log N) eps growth plus the
    dt difference from an f32 max|phi|) and the norm within 1e-5."""
    make, dt_mode, batch = _C64_CASES[case]
    p = make()
    psi0 = np.asarray(ics.build_ics(p))
    if batch > 1:
        psi0 = np.stack([psi0, np.roll(psi0, 3, axis=0)])
    out = {}
    for dtype in (jnp.complex64, jnp.complex128):
        st = Stepper(p, dtype, dt_mode=dt_mode)
        s = st.init_state(psi0, batched=batch > 1)
        for _ in range(4):
            s = st.step(s)
        out[dtype] = s
    lo, hi = out[jnp.complex64], out[jnp.complex128]
    assert lo.psi.dtype == jnp.complex64
    # compare materialized psi: apply any deferred kick through psik
    def psi_of(s):
        pend = np.asarray(s.pending_k, np.float64).reshape((-1,) + (1,) * p.dims)
        spec = grid.spec_grid(p.dx, p.dims, p.size)
        psik = np.asarray(s.psik, np.complex128) * np.exp(1j * pend * spec)
        return np.fft.ifftn(psik, axes=tuple(range(-p.dims, 0)), norm="ortho")

    a, b = psi_of(lo), psi_of(hi)
    rel = np.abs(a - b).max() / np.abs(b).max()
    assert rel < 1e-4, rel
    np.testing.assert_allclose(np.asarray(lo.time), np.asarray(hi.time), rtol=1e-5)
    norm = np.sum(np.abs(a) ** 2, axis=tuple(range(-p.dims, 0))) * p.dx**p.dims
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)

