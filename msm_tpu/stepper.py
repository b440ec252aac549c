"""Split-step (kick-drift-kick) pseudo-spectral Schrodinger-Poisson stepper.

Counterpart of `SimulationObject::update`
(`simulator/src/simulation_object.rs:475-661` static, `:669-873` expanding),
`get_timestep` (`:878-990`), `calculate_potential` (`:1031-1110`) and
`check_alias` (`:1249-1293`).

Architecture (deliberately not a port):

- The state is a pytree (`SimState`) and one step is a pure function
  ``step(state, consts) -> state``; the whole advance-to-next-dump loop runs
  inside a single jitted `lax.while_loop` (`evolve_to_next_dump`), so the
  reference's per-step device->host syncs for `max|phi|` and the alias sum
  disappear — the host only sees the state at dump boundaries.
- The step is **batch-generic**: a leading stream-ensemble axis is handled
  natively (reductions are over the trailing spatial axes; per-stream
  scalars broadcast back). Streams that reach their dump boundary (or
  alias) are frozen by a mask-select in the evolve loop — one stream
  aliasing does not kill the batch, unlike the reference panic
  (`simulation_object.rs:607-617`).
- The same step runs single-device or inside `shard_map` over a device
  mesh: with ``spatial_axis`` set, FFTs go through the pencil transforms
  (`parallel.pfft`, all_to_all between devices) and the max/sum reductions finish
  with `pmax`/`psum` over the mesh axis. k-space state then lives in the
  transposed pencil layout (see pfft docstring) — the global array values
  are identical, only the sharding differs.
- Grid constants (spectral grid, alias mask, tau tables) travel in a
  `StepConsts` pytree so they can be sharded alongside the state.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import cosmo as cosmo_mod
from .config import SimulationParameters
from .constants import POIS_CONST
from .grid import spec_grid as build_spec_grid
from .ops.phase import apply_kinetic_phase, apply_potential_phase


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """Per-stream integrator state (pytree), optionally with a leading
    stream-batch axis on every leaf.

    psi and psik are kept mutually consistent at step boundaries, mirroring
    the reference's `SimulationGrid` (`simulation_object.rs:42-64`); in
    sharded mode psik is stored in the transposed pencil layout.
    """

    psi: jax.Array
    psik: jax.Array
    time: jax.Array
    tau: jax.Array  # supercomoving time (expanding mode; 0 otherwise)
    a: jax.Array  # scale factor (expanding mode; 1 otherwise)
    current_dumps: jax.Array  # int32
    n_steps: jax.Array  # int32
    just_dumped: jax.Array  # bool: last step landed exactly on a dump boundary
    aliased: jax.Array  # bool: Fourier aliasing detected (stream is frozen)
    alias_mass: jax.Array
    # Proposal bound for the lagged/optimistic dt modes. Lagged: the last
    # midpoint max|phi| verbatim. Optimistic: the PREDICTED next-midpoint
    # bound — fresh max|phi| extrapolated by the observed per-step growth
    # ratio (phi_ref), with slow-decay hysteresis (dt_decay) — so the
    # proposal tracks runaway collapse without validation replays.
    phi_max: jax.Array
    phi_ref: jax.Array  # fresh midpoint max|phi| of the last accepted step
    norm0: jax.Array  # initial sum|psik|^2 dk^d (debug-checks reference)
    max_norm_err: jax.Array  # running max |norm/norm0 - 1| (inf on NaN)
    # Step telemetry carried in-jit (the reference's per-update logging,
    # simulation_object.rs:482,1210-1222, without per-step host syncs):
    # dt_min/dt_max over the CURRENT dump interval (reset at snap),
    # replays = cumulative optimistic-dt validation replays (dt_mode
    # "optimistic" only; stays 0 otherwise).
    dt_min: jax.Array
    dt_max: jax.Array
    replays: jax.Array  # int32
    # Deferred closing half-kick: true psik = exp(i pending_k k^2) psik.
    # Nonzero on lagged/optimistic non-dump steps; always zero in states
    # leaving the evolve loop.
    pending_k: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepConsts:
    """Grid constants threaded through the jitted step (shardable pytree).

    spec_grid / alias_mask are the standard global k^2 grid and cutoff mask
    (`utils/fft.rs:123-161`, `simulation_object.rs:1262-1277`); tau_dumps is
    the precomputed tau-at-dump-time table (zeros in static mode).
    """

    spec_grid: jax.Array
    alias_mask: jax.Array
    tau_dumps: jax.Array
    spec_grid_r: jax.Array  # half-spectrum k^2 for the rfft Poisson path


def _donate_enabled() -> bool:
    """Whether interval-block dispatches donate their input state
    (kill-switch for backends without buffer-aliasing support)."""
    return os.environ.get("MSM_DONATE", "1") not in ("0", "false")


class Stepper:
    """Compiled stepper for one resolved configuration.

    All jitted callables treat `params` as compile-time constants;
    re-instantiate for a different config. With ``spatial_axis`` set the
    instance is meant to be driven from inside `shard_map` (see
    `parallel.sharded.MeshStepper`), and `consts` must then be passed in
    pre-sharded.
    """

    def __init__(
        self,
        params: SimulationParameters,
        dtype=jnp.complex64,
        spatial_axis: "str | tuple[str, ...] | None" = None,
        dt_mode: str = "exact",
        debug_checks: bool = False,
        stream_axis: "str | None" = None,
    ):
        # stream_axis: mesh axis name the stream batch is sharded over
        # (MeshStepper passes it; only the online-synthesis combine row
        # reduces over it — every other per-stream quantity stays local).
        # spatial_axis: one mesh-axis name (slab decomposition) or a tuple
        # of two (2-D pencil, 3-D grids only; parallel/pfft.fftn_pencil).
        # debug_checks: carry a per-STEP unitarity/finiteness monitor inside
        # the jitted loop (the reference's debug_assert!(check_norm..) after
        # every substep, simulation_object.rs:485-529, as a runtime flag).
        # Catches mid-interval blowups the dump-boundary checks would see
        # one dump late. Costs one spatial reduction per step.
        self.debug_checks = debug_checks
        self.params = params
        self.dtype = jnp.dtype(dtype)
        self.rdtype = jnp.finfo(self.dtype).dtype
        # Time bookkeeping in float64 when enabled (x64 mode), else float32.
        self.tdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.spatial_axis = spatial_axis
        self.stream_axis = stream_axis
        # dt_mode "exact": the potential is solved twice per step like the
        # reference (once at t for dt, once at the drift midpoint for the
        # kick; update() :497 and :530). "lagged": dt bounds max|phi| with
        # the previous step's midpoint value carried in the state — one
        # Poisson solve (~2 FFTs) fewer per step; trajectories differ from
        # the reference only through the dt sequence, and the CFL bound
        # remains enforced against a potential at most one step stale.
        # "optimistic" (production default): dt is PROPOSED from the carried
        # max|phi| like lagged, scaled by a safety factor (MSM_DT_SAFETY,
        # default 0.95), and VALIDATED after the step against the fresh
        # midpoint max|phi| the step's own Poisson solve produces. A step
        # whose dt violates the CFL potential bound against the fresh value
        # is discarded and replayed with the corrected bound (the same
        # per-stream revert machinery as the alias freeze; `replays`
        # counts them). Accepted steps therefore satisfy the potential CFL
        # bound against their OWN midpoint potential — the field that
        # actually enters the kick, fresher than the reference's pre-step
        # phi(t) — at the lagged step's pass count. Whenever dt is
        # kinetic- or dump-bound throughout (the potential bound never
        # binds), trajectories are bit-identical to exact mode.
        assert dt_mode in ("exact", "lagged", "optimistic")
        self.dt_mode = dt_mode
        # Optimistic proposal safety factor on the potential bound: dt may
        # stand as long as the fresh midpoint max|phi| grew by less than
        # 1/safety since the carried value; each consecutive replay
        # inflates the carried bound by another 1/safety, so replay
        # cascades terminate geometrically. Clamped to (0, 1]. Default
        # 0.95: measured max per-step max|phi| growth on a violent 32^3
        # tophat collapse is 0.24%/step (finer grids grow slower — the
        # growth scales with dt), so 5% headroom is ~20x margin while
        # costing only ~5% more (smaller) steps than the stale lagged
        # bound would take.
        self.dt_safety = min(
            1.0, max(1e-3, float(os.environ.get("MSM_DT_SAFETY", "0.95")))
        )
        # Hysteresis on the carried proposal bound: accepted steps carry
        # max(fresh midpoint max|phi|, decay * previous carried) instead of
        # snapping straight down to the fresh value. Without it, a replay
        # near the kinetic<->potential crossover (the fresh potential bound
        # dipping just below the kinetic dt) inflates the carried bound,
        # the next accepted step resets it, and the loop churns replays
        # while max|phi| oscillates around the threshold (a large share of
        # a 256^3 collapse's steps replayed). With decay the carried
        # bound remembers the recent maximum and relaxes ~1%/step, so the
        # proposal stays just below the validated bound through the band.
        # Validation semantics are untouched — only the proposal adapts.
        self.dt_decay = min(
            1.0, max(0.0, float(os.environ.get("MSM_DT_DECAY", "0.99")))
        )
        # Validation-exercise knob (default 1.0 = production): scale the
        # INITIAL carried proposal bound. Values < 1 understate it, so the
        # first optimistic step(s) propose an over-long dt, fail the fresh
        # midpoint validation and replay with the corrected bound — the
        # full revert/replay machinery runs deterministically through the
        # production driver (used by __graft_entry__.dryrun_multichip and
        # harness smoke; semantics stay correct because validation always
        # enforces the CFL bound against the fresh max|phi|).
        self.dt_init_bound_scale = max(
            0.0, float(os.environ.get("MSM_DT_INIT_BOUND_SCALE", "1.0"))
        )
        p = params
        # k2_max from the separable 1-D table: the axes are independent and
        # share dk, so max(sum_i k_i^2) = dims * max(k_1d^2) — identical to
        # the full grid's max without materializing it.
        s1d_np = build_spec_grid(p.dx, 1, p.size)
        self.k2_max = float(s1d_np.max()) * p.dims
        spec = build_spec_grid(p.dx, p.dims, p.size)
        # Static alias mask: modes with k^2 > k2_cutoff * k2_max.
        mask = (spec > p.k2_cutoff * self.k2_max).astype(np.float64)

        # Dump schedule: t_dump[i] = t0 + i * T / num_dumps. The reference
        # mis-schedules dumps when `time != 0` (its "TODO: fix for
        # initial_time != 0", simulation_object.rs:627-631, keeps the grid
        # anchored at 0); here the grid is offset by the start time, so
        # final_sim_time is the simulated DURATION from t0. Divergence
        # documented in PARITY.md; identical when time == 0 (the default).
        n_dumps = p.num_data_dumps
        self.t0 = float(p.time)
        self.dump_times = self.t0 + np.arange(n_dumps + 1) * (
            p.final_sim_time / n_dumps
        )

        if p.expanding:
            assert p.cosmology is not None and p.comoving_boxsize is not None
            self.tau_dumps = cosmo_mod.tau_at_times(p.cosmology, self.dump_times)
            self.final_sim_tau = float(self.tau_dumps[-1])
            self.a0 = 1.0 / (1.0 + p.cosmology.z0)
            # Density prefactor in supercomoving units
            # (calculate_density, simulation_object.rs:1032-1048):
            # Mtot * POIS_CONST * (2 / (3 H0^2 Omega_m))^(1/4) / hbar_^(d/2)
            c = p.cosmology
            self.density_prefactor = (
                p.total_mass
                * POIS_CONST
                * (2.0 / (3.0 * c.h0_per_myr**2 * c.omega_matter_now)) ** 0.25
                / p.hbar_ ** (p.dims / 2.0)
            )
            self.poisson_coeff = 1.0
            tau_dumps = self.tau_dumps
        else:
            self.tau_dumps = None
            self.density_prefactor = p.total_mass
            self.poisson_coeff = POIS_CONST
            tau_dumps = np.zeros(n_dumps + 1)

        # NB: grid constants travel as ARGUMENTS of every jitted entry
        # point, never as closure captures — a captured grid would be
        # embedded in the compiled program as a literal, so program size
        # and compile time would grow with the grid's megabytes.
        self.consts = StepConsts(
            spec_grid=jnp.asarray(spec, self.rdtype),
            alias_mask=jnp.asarray(mask, self.rdtype),
            tau_dumps=jnp.asarray(tau_dumps, self.tdtype),
            spec_grid_r=jnp.asarray(spec[..., : p.size // 2 + 1], self.rdtype),
        )

        # The driver path consists of compiled calls plus host transfers:
        # each entry point below is one jitted program.
        self._jit_step = jax.jit(self._step)
        # NB: the one-interval evolve entries do NOT donate their input
        # (the driver's kblock==1 loop re-reads it), but the interval-block
        # path (evolve_intervals) DOES donate under MSM_DONATE=1 (default):
        # after a blocked dispatch the driver reads only the stacked outs
        # payload, never the donated state — do not add reads of it. The
        # donation is what halves the resident set and makes speculative
        # dispatch affordable at 512^3 (simulator._speculation_ok).
        self._jit_evolve = jax.jit(self._evolve_to_next_dump)
        self._interval_jits: dict = {}
        self._jit_potential = jax.jit(self._potential)
        self._jit_snap = jax.jit(self._snap_after_dump)
        self._jit_init = jax.jit(self._init_from_psi)

    # ------------------------------------------------------------------
    # Axis helpers (batch-generic + mesh-collective aware)
    # ------------------------------------------------------------------

    @property
    def _spatial_axes(self) -> tuple[int, ...]:
        return tuple(range(-self.params.dims, 0))

    def _bcast(self, scalar):
        """Broadcast a per-stream scalar over the spatial axes."""
        return scalar.reshape(scalar.shape + (1,) * self.params.dims)

    def _spatial_max(self, x):
        out = jnp.max(x, axis=self._spatial_axes)
        if self.spatial_axis is not None:
            out = jax.lax.pmax(out, self.spatial_axis)
        return out

    def _spatial_sum(self, x):
        out = jnp.sum(x, axis=self._spatial_axes)
        if self.spatial_axis is not None:
            out = jax.lax.psum(out, self.spatial_axis)
        return out

    @property
    def _pencil(self) -> bool:
        return isinstance(self.spatial_axis, tuple) and len(self.spatial_axis) > 1

    @property
    def _slab_axis(self) -> str:
        ax = self.spatial_axis
        return ax[0] if isinstance(ax, tuple) else ax

    def _fwd(self, x):
        """Forward ortho FFT (canonical -> k layout)."""
        if self.spatial_axis is not None:
            from .parallel import pfft

            if self._pencil:
                return pfft.fftn_pencil(x, self.params.dims, self.spatial_axis)
            return pfft.fftn_sharded(x, self.params.dims, self._slab_axis)
        from .ops import fft as fft_ops

        return fft_ops.forward(x, self.params.dims)

    def _inv(self, xk):
        """Inverse ortho FFT (k layout -> canonical)."""
        if self.spatial_axis is not None:
            from .parallel import pfft

            if self._pencil:
                return pfft.ifftn_pencil(xk, self.params.dims, self.spatial_axis)
            return pfft.ifftn_sharded(xk, self.params.dims, self._slab_axis)
        from .ops import fft as fft_ops

        return fft_ops.inverse(xk, self.params.dims)

    # ------------------------------------------------------------------
    # Elementwise k-space / real-space ops (XLA fuses each chain)
    # ------------------------------------------------------------------

    def _apply_kinetic(self, psik, coeff, consts: StepConsts):
        """psik * exp(i * coeff * k^2); coeff is a per-stream scalar array."""
        return apply_kinetic_phase(psik, consts.spec_grid, self._bcast(coeff))

    def _apply_potential(self, psi, phi, coeff):
        """psi * exp(i * coeff * phi); coeff is a per-stream scalar array."""
        return apply_potential_phase(psi, phi, self._bcast(coeff))

    def _inv_with_kick(self, psik, coeff, consts: StepConsts):
        """F^-1[exp(i*coeff*k^2) * psik] — the opening kinetic half-kick
        (update :504-516)."""
        return self._inv(self._apply_kinetic(psik, coeff, consts))

    def _fwd_with_kick(self, psi, phi, coeff):
        """F[exp(i*coeff*phi) * psi] — the potential kick (update :535-545)."""
        return self._fwd(self._apply_potential(psi, phi, coeff))

    def _poisson_multiply(self, rho_k, consts: StepConsts):
        """phi_k = -poisson_coeff * rho_k / k^2 with the k=0 mode zeroed."""
        spec = consts.spec_grid
        inv_k2 = jnp.where(spec > 0.0, 1.0, 0.0) / jnp.where(spec > 0.0, spec, 1.0)
        return (-self.poisson_coeff * inv_k2).astype(rho_k.dtype) * rho_k

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    def init_state(self, psi0, batched: bool = False) -> SimState:
        """Build the initial state; psik is populated with F[psi] up front
        (the reference lazily initializes it on the first update,
        simulation_object.rs:477-479).

        psi0 may be a host array or a device array.
        """
        if not isinstance(psi0, jax.Array):
            psi0 = jax.device_put(np.asarray(psi0, self.dtype))
        return self._jit_init(psi0, self.consts)

    def _init_from_psi(self, psi, consts: StepConsts | None = None) -> SimState:
        consts = consts if consts is not None else self.consts
        psi = psi.astype(self.dtype)
        psik = self._fwd(psi)
        t0 = jnp.asarray(self.params.time, self.tdtype)
        if self.params.expanding:
            tau0 = jnp.asarray(
                cosmo_mod.get_tau(self.params.cosmology, self.params.time),
                self.tdtype,
            )
            a0 = jnp.asarray(self.a0, self.tdtype)
        else:
            tau0 = jnp.zeros((), self.tdtype)
            a0 = jnp.ones((), self.tdtype)

        def scalars(x):
            return jnp.broadcast_to(x, psi.shape[: psi.ndim - self.params.dims])

        return SimState(
            psi=psi,
            psik=psik,
            time=scalars(t0),
            tau=scalars(tau0),
            a=scalars(a0),
            current_dumps=scalars(jnp.zeros((), jnp.int32)),
            n_steps=scalars(jnp.zeros((), jnp.int32)),
            just_dumped=scalars(jnp.zeros((), jnp.bool_)),
            aliased=scalars(jnp.zeros((), jnp.bool_)),
            alias_mass=scalars(jnp.zeros((), self.rdtype)),
            phi_max=(pm0 := self._spatial_max(
                jnp.abs(self._potential(psi, consts))
            ).astype(self.tdtype)) * self.dt_init_bound_scale,
            phi_ref=pm0,
            norm0=self._norm_measure(psik),
            max_norm_err=scalars(jnp.zeros((), self.rdtype)),
            pending_k=scalars(jnp.zeros((), self.rdtype)),
            dt_min=scalars(jnp.asarray(jnp.inf, self.tdtype)),
            dt_max=scalars(jnp.zeros((), self.tdtype)),
            replays=scalars(jnp.zeros((), jnp.int32)),
        )

    def _norm_measure(self, psik):
        """sum|psik|^2 dk^d — equals the real-space norm (ortho + dk = dx)."""
        return self._spatial_sum(jnp.real(psik * jnp.conj(psik))) * jnp.asarray(
            self.params.dk**self.params.dims, self.rdtype
        )

    def _track_norm(self, state: SimState, psik, nrm=None):
        """Update the running unitarity monitor (debug-checks mode only)."""
        if not self.debug_checks:
            return state.max_norm_err
        if nrm is None:
            nrm = self._norm_measure(psik)
        err = jnp.abs(nrm / state.norm0 - 1.0)
        err = jnp.where(jnp.isfinite(err), err, jnp.inf)
        return jnp.maximum(state.max_norm_err, err.astype(state.max_norm_err.dtype))

    # ------------------------------------------------------------------
    # Physics pieces
    # ------------------------------------------------------------------

    def _potential(self, psi, consts: StepConsts | None = None):
        """Spectral Poisson solve (calculate_potential, :1031-1110).

        rho = prefactor |psi|^2; phi_k = -coeff rho_k / k^2 (k=0 zeroed by
        masking, cleaner than the reference's NaN-replace :1097-1102);
        phi = Re F^-1[phi_k].

        Single-device path exploits that rho and phi are REAL: rfftn/irfftn
        transform the half-spectrum, roughly halving the Poisson solve's
        FFT flops and bandwidth vs the reference's complex in-place FFTs
        (`fft.rs:60-98`). The sharded path stays complex (pencil transposes
        are defined on the full spectrum).
        """
        consts = consts if consts is not None else self.consts
        rho = jnp.asarray(self.density_prefactor, self.rdtype) * jnp.real(
            psi * jnp.conj(psi)
        )
        if self.spatial_axis is None:
            axes = self._spatial_axes
            rho_k = jnp.fft.rfftn(rho, axes=axes)
            spec_r = consts.spec_grid_r
            inv_k2 = jnp.where(spec_r > 0.0, 1.0, 0.0) / jnp.where(
                spec_r > 0.0, spec_r, 1.0
            )
            phi_k = (-self.poisson_coeff * inv_k2).astype(rho_k.dtype) * rho_k
            return jnp.fft.irfftn(
                phi_k, s=(self.params.size,) * self.params.dims, axes=axes
            ).astype(self.rdtype)
        rho_k = self._fwd(rho.astype(self.dtype))
        phi_k = self._poisson_multiply(rho_k, consts)
        return jnp.real(self._inv(phi_k))

    def _potential_with_max(self, psi, consts: StepConsts):
        """(phi, per-stream max|phi|) — the midpoint potential of a step."""
        phi = self._potential(psi, consts)
        return phi, self._spatial_max(jnp.abs(phi)).astype(self.tdtype)

    def _fwd_with_kick_reduce(self, psi, phi, coeff, consts: StepConsts):
        """(psik, norm, alias_mass) after the potential kick (check_alias
        :1249-1293, check_norm grid.rs:35-64)."""
        psik = self._fwd_with_kick(psi, phi, coeff)
        nrm = self._norm_measure(psik) if self.debug_checks else None
        return psik, nrm, self._alias_mass(psik, consts)

    def _timestep(self, phi, state: SimState, consts: StepConsts, phi_max=None):
        """Adaptive dt (or dtau): min of kinetic, potential, next-dump.

        Static: get_timestep `simulation_object.rs:878-934`;
        expanding: `:939-990` (with the per-step get_tau re-integration
        replaced by the precomputed tau-at-dump table).
        Returns per-stream (dt, is_dump). `phi_max` short-circuits the
        grid reduction when the caller already owns max|phi|.
        """
        p = self.params
        if phi_max is not None:
            phi_max = phi_max.astype(self.tdtype)
        elif phi is None:  # lagged mode: previous midpoint max carried in state
            phi_max = state.phi_max
        else:
            phi_max = self._spatial_max(jnp.abs(phi)).astype(self.tdtype)
        next_idx = jnp.minimum(state.current_dumps + 1, p.num_data_dumps)
        if p.expanding:
            kinetic = jnp.asarray(
                p.cfl * 2.0 * p.comoving_boxsize / np.sqrt(self.k2_max), self.tdtype
            )
            potential = p.cfl * 2.0 * np.pi / (2.0 * state.a * phi_max)
            to_next = consts.tau_dumps[next_idx] - state.tau
        else:
            kinetic = jnp.asarray(
                p.cfl * 2.0 * p.axis_length / (np.sqrt(self.k2_max) * p.hbar_),
                self.tdtype,
            )
            potential = p.cfl * 2.0 * np.pi * p.hbar_ / (2.0 * phi_max)
            next_dump_time = self.t0 + next_idx.astype(self.tdtype) * (
                p.final_sim_time / p.num_data_dumps
            )
            to_next = next_dump_time - state.time
        if self.dt_mode == "optimistic":
            # proposal: shrink only the (stale-bound) potential term
            potential = potential * self.dt_safety
        dt = jnp.minimum(jnp.minimum(kinetic, potential), to_next)
        return dt, dt == to_next

    def _predict_bound(self, pm_fresh, state: SimState):
        """Optimistic proposal bound for the NEXT step: the fresh midpoint
        max|phi| extrapolated by the observed per-step growth ratio
        (clipped to [1, 2] — never predict decline, cap spikes), floored
        by the slowly-decaying previous carried bound (anti-churn
        hysteresis around the kinetic<->potential crossover). In a steady
        runaway collapse the prediction tracks the growth, so validation
        failures stay confined to growth-rate CHANGES instead of firing
        every step (with the raw fresh bound a 256^3 collapse replayed a
        large share of its steps; with prediction almost none).

        The division floor MUST be representable in the carried dtype: a
        python 1e-300 underflows to 0.0 in float32 (the production
        non-x64 tdtype), making a zero-potential stream produce
        growth = 0/0 = NaN -> NaN dt -> a never-terminating jitted
        while_loop. finfo.tiny of the actual dtype keeps 0/tiny = 0,
        which the clip lifts to growth 1 (tests/test_stepper.py::
        test_predict_bound_zero_potential_f32)."""
        ref = jnp.maximum(
            state.phi_ref, jnp.finfo(jnp.asarray(state.phi_ref).dtype).tiny
        )
        growth = jnp.clip(pm_fresh / ref, 1.0, 2.0)
        return jnp.maximum(pm_fresh * growth, state.phi_max * self.dt_decay)

    def _dt_invalid(self, dt, phi_max_fresh, a):
        """Optimistic-dt validation: did the executed dt violate the CFL
        potential bound against the FRESH midpoint max|phi| the step's own
        Poisson solve produced? (The bound the reference enforces against
        the stale pre-step phi(t), get_timestep :905-909 / :969-975.)
        `a` is the scale factor the proposal used (state.a; 1 static).
        Written so NaN/Inf in phi_max yields False — a blown-up stream is
        accepted and caught by the norm/alias monitors, never replayed
        forever."""
        p = self.params
        pm = phi_max_fresh.astype(self.tdtype)
        if p.expanding:
            lhs = dt * (2.0 * a * pm)
            rhs = p.cfl * 2.0 * np.pi
        else:
            lhs = dt * (2.0 * pm)
            rhs = p.cfl * 2.0 * np.pi * p.hbar_
        return lhs > jnp.asarray(rhs, self.tdtype)

    def _alias_mass(self, psik, consts: StepConsts):
        """Probability mass above the alias cutoff (check_alias, :1249-1293)."""
        p = self.params
        mass = self._spatial_sum(jnp.real(psik * jnp.conj(psik)) * consts.alias_mask)
        return mass * jnp.asarray(p.dk**p.dims, self.rdtype)

    def _finalize_step(self, psik, psi_old, is_dump, kcoeff, consts):
        """End-of-step half-kick + psi materialization -> (psi, psik, pending).

        Exact mode: apply the closing kinetic half-kick and invert (the
        reference's :562-581). Lagged mode fuses the closing half-kick of
        step i with the opening half-kick of step i+1 (they are adjacent
        elementwise k-space multiplies — no FFT between them): on non-dump
        steps the kick is DEFERRED by storing its coefficient in
        `pending_k` (one fewer full-grid pass per step; |psik| — alias
        mass, norms — is phase-invariant so monitors are unaffected). At
        dump boundaries the pending kick is applied and psi materialized,
        so states leaving the evolve loop are always fully consistent.
        Trajectories equal the unfused ones to rounding (exp(i(a+b)k^2)
        vs two successive phase multiplies).
        """
        if self.dt_mode == "exact":
            psik = self._apply_kinetic(psik, kcoeff, consts)
            return self._inv(psik), psik, jnp.zeros_like(kcoeff)

        def materialize(pk):
            pk = self._apply_kinetic(pk, kcoeff, consts)
            return self._inv(pk), pk, jnp.zeros_like(kcoeff)

        def defer(pk):
            return psi_old, pk, kcoeff

        return jax.lax.cond(jnp.any(is_dump), materialize, defer, psik)

    # ------------------------------------------------------------------
    # One KDK step (batch-generic)
    # ------------------------------------------------------------------

    def _step(self, state: SimState, consts: StepConsts | None = None) -> SimState:
        consts = consts if consts is not None else self.consts
        if self.params.expanding:
            return self._step_expanding(state, consts)
        return self._step_static(state, consts)

    def _step_static(self, state: SimState, consts: StepConsts) -> SimState:
        """One static-space KDK step (update, :475-661)."""
        phi0 = self._potential(state.psi, consts) if self.dt_mode == "exact" else None
        _dt, is_dump, kcoeff, vcoeffs, time, _tau, _a = self._scalar_advance(
            state, consts, phi0
        )
        vcoeff = vcoeffs[0]

        # Half kick in k-space: exp(-i * dt/4 * hbar_ * k^2) (:504-516),
        # merged with any half-kick deferred by the previous step (lagged);
        # full potential kick at the half-step: exp(-i * dt/hbar_ * phi)
        # (:530-545).
        psi = self._inv_with_kick(state.psik, state.pending_k + kcoeff, consts)
        phi, phi_max = self._potential_with_max(psi, consts)
        psik, nrm, alias_mass = self._fwd_with_kick_reduce(psi, phi, vcoeff, consts)
        # Second half kick (:562-574), deferred on lagged non-dump steps
        psi, psik, pending = self._finalize_step(
            psik, state.psi, is_dump, kcoeff, consts
        )
        return self._finish_step(
            state,
            psi=psi,
            psik=psik,
            time=time,
            tau=state.tau,
            a=state.a,
            is_dump=is_dump,
            alias_mass=alias_mass,
            phi_max=phi_max,
            nrm=nrm,
            pending=pending,
            dt=_dt,
        )

    def _finish_step(
        self, state: SimState, *, psi, psik, time, tau, a, is_dump,
        alias_mass, phi_max, nrm, pending, dt
    ) -> SimState:
        """Assemble the advanced state and, in optimistic dt mode, validate
        the executed dt against the fresh midpoint max|phi| — an invalid
        step is discarded per-stream (replayed by the next loop iteration
        with the corrected carried bound)."""
        p = self.params
        pm_fresh = phi_max.astype(self.tdtype)
        pm_carry = pm_fresh
        if self.dt_mode == "optimistic":
            # predicted next-midpoint bound (growth extrapolation +
            # hysteresis) — proposal only, validation below still uses
            # the fresh value
            pm_carry = self._predict_bound(pm_fresh, state)
        new = dataclasses.replace(
            state,
            psi=psi,
            psik=psik,
            time=time,
            tau=tau,
            a=a,
            n_steps=state.n_steps + 1,
            just_dumped=is_dump,
            aliased=state.aliased | (alias_mass > p.alias_threshold),
            alias_mass=alias_mass,
            phi_max=pm_carry,
            phi_ref=pm_fresh,
            max_norm_err=self._track_norm(state, psik, nrm=nrm),
            pending_k=pending,
            dt_min=jnp.minimum(state.dt_min, dt.astype(self.tdtype)),
            dt_max=jnp.maximum(state.dt_max, dt.astype(self.tdtype)),
        )
        if self.dt_mode != "optimistic":
            return new
        invalid = self._dt_invalid(dt, phi_max, state.a)
        # revert: keep the old state, adopt the fresh bound (inflated by
        # 1/safety so consecutive replays shrink dt geometrically) and
        # count the replay. Plain where-select, NOT lax.cond: a cond over
        # the whole state blocks XLA's fusion and buffer aliasing of the
        # loop carry. The selects are not free either: on the GPU they run
        # as full-grid passes (PERF.md, 256^3 trace).
        rev = dataclasses.replace(
            state,
            phi_max=jnp.where(
                invalid,
                jnp.maximum(pm_fresh, state.phi_max) / self.dt_safety,
                state.phi_max,
            ),
            replays=state.replays + invalid.astype(jnp.int32),
        )
        return self._select(~invalid, new, rev)

    def _step_expanding(self, state: SimState, consts: StepConsts) -> SimState:
        """One expanding-universe KDK step in dtau (update, :669-873).

        The kinetic factor drops hbar_ (:699-706); the potential update is
        two half-kicks exp(-i * dtau/2 * a * phi) with the scale factor (and
        physical time) advanced by dtau/2 between them (:726-760).
        """
        phi0 = self._potential(state.psi, consts) if self.dt_mode == "exact" else None
        _dt, is_dump, kcoeff, vcoeffs, t, tau, a = self._scalar_advance(
            state, consts, phi0
        )

        psi = self._inv_with_kick(state.psik, state.pending_k + kcoeff, consts)
        phi, phi_max = self._potential_with_max(psi, consts)
        for vcoeff in vcoeffs:
            psi = self._apply_potential(psi, phi, vcoeff)
        psik = self._fwd(psi)
        nrm = self._norm_measure(psik) if self.debug_checks else None
        alias_mass = self._alias_mass(psik, consts)
        psi, psik, pending = self._finalize_step(
            psik, state.psi, is_dump, kcoeff, consts
        )
        return self._finish_step(
            state,
            psi=psi,
            psik=psik,
            time=t,
            tau=tau,
            a=a,
            is_dump=is_dump,
            alias_mass=alias_mass,
            phi_max=phi_max,
            nrm=nrm,
            pending=pending,
            dt=_dt,
        )

    # ------------------------------------------------------------------
    # Dump-to-dump evolution (the jitted hot loop)
    # ------------------------------------------------------------------

    def _scalar_advance(
        self, state: SimState, consts: StepConsts, phi=None, phi_max=None
    ):
        """The step's scalar prologue, shared by _step_static and
        _step_expanding: adaptive dt/dtau (from
        `phi`/`phi_max` in exact mode, the carried max|phi| when both are
        None), dump flag, kick coefficients and the advanced time/tau/a.

        Static: kcoeff = -dt/4*hbar_, one potential kick -dt/hbar_
        (update :504-516, :535-545). Expanding: kcoeff = -dtau/4 (no
        hbar_, :699-706) and TWO half-kicks -dtau/2*a with the scale
        factor advanced by RK4 between them (:726-760) — returned as the
        `vcoeffs` list.
        """
        p = self.params
        dt, is_dump = self._timestep(phi, state, consts, phi_max=phi_max)
        if p.expanding:
            kcoeff = (-dt / 4.0).astype(self.rdtype)
            a, t, tau = state.a, state.time, state.tau
            vcoeffs = []
            for _ in range(2):
                vcoeffs.append(((-dt / 2.0) * a).astype(self.rdtype))
                a, t = cosmo_mod.advance_a_t_by_dtau(a, t, dt / 2.0, p.cosmology)
                tau = tau + dt / 2.0
            return dt, is_dump, kcoeff, vcoeffs, t, tau, a
        kcoeff = (-dt / 4.0 * p.hbar_).astype(self.rdtype)
        vcoeffs = [(-dt / p.hbar_).astype(self.rdtype)]
        return dt, is_dump, kcoeff, vcoeffs, state.time + dt, state.tau, state.a

    def _active(self, state: SimState, finished):
        return ~(state.just_dumped | state.aliased | finished)

    def _select(self, mask, new: SimState, old: SimState) -> SimState:
        """Per-stream select: advance active streams, freeze the rest."""
        gmask = self._bcast(mask)

        def pick(n, o):
            m = gmask if n.ndim == gmask.ndim else mask
            return jnp.where(m, n, o)

        return jax.tree_util.tree_map(pick, new, old)

    def _evolve_to_next_dump(
        self,
        state: SimState,
        consts: StepConsts | None = None,
    ) -> SimState:
        """Advance every active stream until its step lands on the next dump
        boundary (or it aliases).

        The loop exit mirrors the reference's dump flag: the step that took
        `time_to_next_dump` as its dt sets just_dumped (get_timestep,
        :926-930); dump counter increment and time snapping happen at the
        host via `snap_after_dump`, as in update() (:620-631). Batched
        streams are masked rather than vmapped so the same code path works
        under shard_map with collectives inside the body.
        """
        consts = consts if consts is not None else self.consts
        finished = state.current_dumps >= self.params.num_data_dumps
        batched = state.psi.ndim > self.params.dims

        def cond(s: SimState):
            return jnp.any(self._active(s, finished))

        if batched:
            # per-stream freeze: blend advanced and frozen streams — but in
            # the steady state every stream is active, so a scalar cond
            # skips the full-grid select traffic on those iterations
            def body(s: SimState):
                mask = self._active(s, finished)
                new = self._step(s, consts)
                return jax.lax.cond(
                    jnp.all(mask), lambda: new, lambda: self._select(mask, new, s)
                )
        else:
            # single stream: the loop condition already guarantees activity,
            # so step unconditionally — no full-grid select traffic
            def body(s: SimState):
                return self._step(s, consts)

        return jax.lax.while_loop(cond, body, state)

    def evolve_to_next_dump(self, state: SimState, batched: bool = False) -> SimState:
        del batched  # the step is batch-generic; kept for API compatibility
        return self._jit_evolve(state, self.consts)

    def _evolve_intervals(
        self,
        state: SimState,
        consts: StepConsts,
        *,
        k: int,
        with_potential: bool,
        combine: "tuple[int, float] | None" = None,
    ):
        """Advance k dump intervals inside ONE compiled program (lax.scan).

        Returns (final_state, outs): `outs` stacks each interval's dump
        payload along a leading (k,) axis — psi, the post-snap manifest
        scalars, and the pre-snap just_dumped/aliased flags the
        driver keys on. Intervals after every stream has finished are
        harmless no-ops: the evolve while_loop's condition fails
        immediately and snap is just_dumped-gated (snap zeroed the flag),
        so their rows carry just_dumped=False and the host skips them.

        This exists for dispatch-latency amortization: one program per
        dump interval costs a dispatch and a host round trip per dump,
        which dominates 200-dump runs of small ensembles. One scan
        compiles once (same body as a single interval) and fetches k dumps
        per round trip.

        With ``combine=(n_runs, dv)`` each interval row additionally
        carries the ONLINE-SYNTHESIS reductions (the `-combined/` ensemble
        averages + the Qx scalar, `synthesizer/src/main.rs:63-93,161-173`)
        computed in-jit over the stream batch axis: streams 0..n_runs-2
        that produced this row's dump (just_dumped & ~aliased) are
        averaged — the MFT (index n_runs-1) and internal padding rows
        never participate. psik rides the synthesizer's UNnormalized
        convention (ortho state psik x N^(d/2); `lib.rs:206-213`), in
        natural k order. This is what lets `--online-synthesis` keep
        interval blocking, donation and budgeted speculation instead of
        forcing the one-interval host loop.
        """

        def body(s, _):
            raw = self._evolve_to_next_dump(s, consts)
            snapped = self._snap_after_dump(raw)
            out = {
                "just_dumped": raw.just_dumped,
                "aliased": raw.aliased,
                "alias_mass": raw.alias_mass,
                "max_norm_err": raw.max_norm_err,
                "n_steps": raw.n_steps,
                # pre-snap step telemetry: this interval's dt range and the
                # cumulative optimistic-dt replay count (reference-grade
                # per-update visibility, simulation_object.rs:1210-1222,
                # with zero extra host syncs)
                "dt_min": raw.dt_min,
                "dt_max": raw.dt_max,
                "replays": raw.replays,
                "current_dumps": snapped.current_dumps,
                "time": snapped.time,
                "tau": snapped.tau,
                "a": snapped.a,
                "psi": snapped.psi,
            }
            if with_potential:
                out["pot"] = self._potential(snapped.psi, consts)
            if combine is not None:
                out.update(self._combine_row(raw, snapped, combine))
            return snapped, out

        return jax.lax.scan(body, state, None, length=k)

    def _combine_row(self, raw: SimState, snapped: SimState, combine) -> dict:
        """One interval row's online-synthesis payload (see
        `_evolve_intervals`): masked stream-axis means of psi / |psi|^2 /
        psik / |psik|^2 plus the Qx scalar, all in-jit. |psi|^2 and
        |psik|^2 are real by construction (their files carry zero
        imaginary parts, matching OnlineCombiner's host output).

        Mesh-aware: with ``stream_axis`` set (MeshStepper under shard_map)
        the stream mask uses GLOBAL stream indices (the batch is split in
        contiguous blocks along the stream axis; internal padding rows sit
        at global index >= n_runs and never participate) and the masked
        sums finish in a `psum` over the stream axis; with spatial sharding
        the mean fields stay space-sharded (the mesh interval program
        all_gathers them with the dump planes) and the Qx scalar finishes
        in a `psum` over the space axes."""
        n_runs, dv = combine
        p = self.params
        psi = snapped.psi
        batch = psi.shape[0]
        idx = jnp.arange(batch)
        if self.stream_axis is not None:
            idx = idx + jax.lax.axis_index(self.stream_axis) * batch
        smask = idx < (n_runs - 1)
        w = (raw.just_dumped & ~raw.aliased & smask).astype(self.rdtype)
        wg = self._bcast(w)
        nv = jnp.sum(w)
        psik = snapped.psik
        # synthesizer file convention: UNnormalized per-axis FFT
        # (`lib.rs:206-213`) = ortho psik scaled by N^(d/2)
        psik = psik * jnp.asarray(p.size ** (p.dims / 2.0), self.rdtype)
        psi_s = jnp.sum(psi * wg.astype(psi.dtype), axis=0)
        psi2_s = jnp.sum(jnp.real(psi * jnp.conj(psi)) * wg, axis=0)
        psik_s = jnp.sum(psik * wg.astype(psik.dtype), axis=0)
        psik2_s = jnp.sum(jnp.real(psik * jnp.conj(psik)) * wg, axis=0)
        if self.stream_axis is not None:
            nv, psi_s, psi2_s, psik_s, psik2_s = jax.lax.psum(
                (nv, psi_s, psi2_s, psik_s, psik2_s), self.stream_axis
            )
        den = jnp.maximum(nv, 1.0)
        psi_m = psi_s / den.astype(psi.dtype)
        psi2_m = psi2_s / den
        psik_m = psik_s / den.astype(psik.dtype)
        psik2_m = psik2_s / den
        qx = jnp.sum(
            psi2_m - jnp.real(psi_m * jnp.conj(psi_m))
        ) * jnp.asarray(dv, self.rdtype)
        if self.spatial_axis is not None:
            qx = jax.lax.psum(qx, self.spatial_axis)
        return {
            "comb_n": nv,
            "comb_psi": psi_m,
            "comb_psi2": psi2_m,
            "comb_psik": psik_m,
            "comb_psik2": psik2_m,
            "comb_qx": qx,
        }

    def evolve_intervals(
        self,
        state: SimState,
        k: int,
        with_potential: bool = False,
        combine: "tuple[int, float] | None" = None,
    ):
        """Jitted k-interval advance; see `_evolve_intervals`.

        The input state is DONATED: each dispatch's input is the previous
        dispatch's output and the drivers read only the `outs` payload
        (plus the final returned state), so XLA reuses the input buffers
        for the output — one full state resident instead of two, which is
        what makes speculative dispatch affordable at 512^3
        (_speculation_ok). MSM_DONATE=0 opts out.
        """
        return self.interval_fn(k, with_potential, combine)(state, self.consts)

    def interval_fn(
        self,
        k: int,
        with_potential: bool = False,
        combine: "tuple[int, float] | None" = None,
    ):
        """The cached jit `evolve_intervals` dispatches, called as
        `fn(state, consts)` (also lowered ahead of time for its
        memory analysis)."""
        key = (int(k), bool(with_potential), combine)
        fn = self._interval_jits.get(key)
        if fn is None:
            donate = (0,) if _donate_enabled() else ()
            fn = jax.jit(
                functools.partial(
                    self._evolve_intervals,
                    k=key[0],
                    with_potential=key[1],
                    combine=combine,
                ),
                donate_argnums=donate,
            )
            self._interval_jits[key] = fn
        return fn

    def step(self, state: SimState) -> SimState:
        return self._jit_step(state, self.consts)

    def _chain_n_steps(self, state: SimState, consts: StepConsts, n: int) -> SimState:
        """Run exactly n steps of the production hot-loop BODY (the same
        program as _evolve_to_next_dump, with the dump/alias exit replaced
        by a trip count) — benchmarking helper: the slope between two n
        values measures the steady-state per-step cost."""
        return jax.lax.fori_loop(0, n, lambda i, s: self._step(s, consts), state)

    def potential(self, psi):
        return self._jit_potential(psi, self.consts)

    # ------------------------------------------------------------------
    # Host-side dump bookkeeping
    # ------------------------------------------------------------------

    def snap_after_dump(self, state: SimState) -> SimState:
        return self._jit_snap(state)

    def _snap_after_dump(self, state: SimState) -> SimState:
        """Increment the dump counter and snap time onto the dump grid.

        Mirrors update()'s post-dump bookkeeping
        (`simulation_object.rs:620-631` static, `:828-844` expanding).
        Vectorizes over any leading batch axes.
        """
        p = self.params
        # A stream that aliased ON its dump step never has that dump
        # written (the driver checks aliased first), so its counter must
        # not count it — otherwise the manifest points resume at a dump
        # file that does not exist.
        counted = state.just_dumped & ~state.aliased
        dumps = state.current_dumps + counted.astype(jnp.int32)
        snapped_t = self.t0 + dumps.astype(self.tdtype) * (
            p.final_sim_time / p.num_data_dumps
        )
        new_time = jnp.where(counted, snapped_t, state.time)
        if p.expanding:
            snapped_tau = jnp.asarray(self.tau_dumps, self.tdtype)[
                jnp.minimum(dumps, p.num_data_dumps)
            ]
            new_tau = jnp.where(counted, snapped_tau, state.tau)
        else:
            new_tau = state.tau
        return dataclasses.replace(
            state,
            current_dumps=dumps,
            time=new_time,
            tau=new_tau,
            just_dumped=jnp.zeros_like(state.just_dumped),
            # per-interval dt telemetry resets at the dump boundary
            dt_min=jnp.where(
                counted, jnp.asarray(jnp.inf, state.dt_min.dtype), state.dt_min
            ),
            dt_max=jnp.where(counted, jnp.zeros_like(state.dt_max), state.dt_max),
        )

    def not_finished(self, state: SimState) -> bool:
        """Whether any stream still has evolution left (not_finished, :1226-1228).

        Host-side numpy on fetched scalars — no eager device ops. Multi-host
        states (process-sharded stream axis) gather the tiny scalar leaves.
        """
        dumps, aliased = state.current_dumps, state.aliased
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            dumps = multihost_utils.process_allgather(dumps, tiled=True)
            aliased = multihost_utils.process_allgather(aliased, tiled=True)
        done = (np.asarray(dumps) >= self.params.num_data_dumps) | np.asarray(aliased)
        return not bool(np.all(done))
