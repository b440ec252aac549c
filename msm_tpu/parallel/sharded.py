"""Mesh-sharded stepping: the full KDK update over a (stream, x) device mesh.

This is the scale-out path the reference does not have (it is strictly
single-GPU, `simulator/src/main.rs:23`): streams are data-parallel over the
``stream`` mesh axis and the grid's leading spatial axis is sharded over the
``x`` axis, with FFTs transposing via `all_to_all` (parallel.pfft) and
scalar reductions finishing in `pmax`/`psum` — XLA lowers the collectives
to NCCL on GPUs.

Layouts inside the shard_map region (3-D, batched):

  psi   : (S_loc, Z/nx, Y, X)    canonical
  psik  : (S_loc, Z, Y/nx, X)    transposed pencil (see pfft)
  scalars: (S_loc,)              per-stream, replicated along x

The whole evolve-to-dump while_loop runs inside one shard_map: per-stream
loop exit masks are replicated along the x rows (every x-device computes
identical per-stream scalars via the collective reductions), so control
flow stays coherent where collectives occur.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimulationParameters
from ..stepper import SimState, StepConsts, Stepper
from .mesh import SPACE_AXIS, STREAM_AXIS


class MeshStepper:
    """Stepper compiled over a device mesh.

    The public API mirrors `Stepper` (init_state / evolve_to_next_dump /
    snap_after_dump / not_finished); states it returns are mesh-sharded
    jax.Arrays whose psik leaf lives in the transposed pencil layout.
    """

    def __init__(
        self,
        params: SimulationParameters,
        mesh: Mesh,
        dtype=jnp.complex64,
        shard_space: Optional[bool] = None,
        dt_mode: str = "exact",
        debug_checks: bool = False,
    ):
        self.params = params
        self.mesh = mesh
        # Space axes: every mesh axis except the stream axis, kept in mesh
        # order; only axes of extent > 1 shard anything. One active axis is
        # a slab; two (3-D grids) is the 2-D pencil (parallel/pfft).
        space_names = [n for n in mesh.axis_names if n != STREAM_AXIS]
        active = [n for n in space_names if mesh.shape[n] > 1]
        if shard_space is None:
            shard_space = bool(active) and params.dims >= 2
        if shard_space and params.dims < 2:
            raise ValueError("1-D grids cannot be spatially sharded")
        if shard_space and not active:
            raise ValueError("shard_space=True but every space axis has size 1")
        if shard_space:
            for name in active:
                if params.size % mesh.shape[name] != 0:
                    raise ValueError(
                        f"grid size {params.size} not divisible by mesh axis "
                        f"{name}={mesh.shape[name]}"
                    )
            if len(active) > 2 or (len(active) == 2 and params.dims < 3):
                raise ValueError(
                    "pencil decomposition needs a 3-D grid and at most two "
                    f"space axes; got dims={params.dims}, axes={active}"
                )
        self.shard_space = shard_space
        pencil = shard_space and len(active) == 2
        self.space_axes = tuple(active) if shard_space else ()

        self.stepper = Stepper(
            params,
            dtype,
            spatial_axis=(
                (tuple(active) if pencil else active[0]) if shard_space else None
            ),
            dt_mode=dt_mode,
            debug_checks=debug_checks,
            # the stream axis is always bound inside this mesh's shard_map
            # (extent 1 included) — the combine row reduces over it
            stream_axis=STREAM_AXIS,
        )
        dims = params.dims
        nones = (None,) * (dims - 1)
        if pencil:
            ax0, ax1 = active
            # real space (Z/px, Y/py, X); k space (Z, Y/px, X/py)
            self.psi_spec = P(STREAM_AXIS, ax0, ax1, None)
            self.psik_spec = P(STREAM_AXIS, None, ax0, ax1)
            kspec = P(None, ax0, ax1)
        elif shard_space:
            ax0 = active[0]
            self.psi_spec = P(STREAM_AXIS, ax0, *nones)
            # transposed slab layout: k-space sharded on the second axis
            self.psik_spec = P(STREAM_AXIS, None, ax0, *nones[1:])
            kspec = P(None, ax0, *nones[1:])
        else:
            self.psi_spec = P(STREAM_AXIS, *((None,) * dims))
            self.psik_spec = self.psi_spec
            kspec = P(*((None,) * dims))
        self.scalar_spec = P(STREAM_AXIS)

        self.state_specs = SimState(
            psi=self.psi_spec,
            psik=self.psik_spec,
            time=self.scalar_spec,
            tau=self.scalar_spec,
            a=self.scalar_spec,
            current_dumps=self.scalar_spec,
            n_steps=self.scalar_spec,
            just_dumped=self.scalar_spec,
            aliased=self.scalar_spec,
            alias_mass=self.scalar_spec,
            phi_max=self.scalar_spec,
            phi_ref=self.scalar_spec,
            norm0=self.scalar_spec,
            max_norm_err=self.scalar_spec,
            pending_k=self.scalar_spec,
            dt_min=self.scalar_spec,
            dt_max=self.scalar_spec,
            replays=self.scalar_spec,
        )
        # Total over the StepConsts dataclass: every field MUST have an
        # explicit spec here, so a new const field cannot silently shard as
        # "whatever device_put does" under shard_map — adding one without a
        # spec fails loudly at MeshStepper construction. Fields whose value
        # is None in this configuration get a None spec (empty subtree,
        # matching the consts pytree structure).
        field_specs = {
            "spec_grid": kspec,
            "alias_mask": kspec,
            "tau_dumps": P(),
            "spec_grid_r": P(),
        }
        names = {f.name for f in dataclasses.fields(StepConsts)}
        missing = names - field_specs.keys()
        if missing:
            raise NotImplementedError(
                f"StepConsts fields without mesh sharding specs: {sorted(missing)}"
            )
        self.consts_specs = StepConsts(
            **{
                name: (
                    None
                    if getattr(self.stepper.consts, name) is None
                    else field_specs[name]
                )
                for name in names
            }
        )

        def smap(f, out_specs):
            return jax.jit(
                jax.shard_map(
                    f,
                    mesh=self.mesh,
                    in_specs=(self.state_specs, self.consts_specs),
                    out_specs=out_specs,
                    check_vma=False,
                )
            )

        self._evolve = smap(self.stepper._evolve_to_next_dump, self.state_specs)
        self._step_fn = smap(self.stepper._step, self.state_specs)
        self._interval_jits: dict = {}
        self._init_fn = jax.jit(
            jax.shard_map(
                lambda psi, consts: self.stepper._init_from_psi(psi, consts),
                mesh=self.mesh,
                in_specs=(self.psi_spec, self.consts_specs),
                out_specs=self.state_specs,
                check_vma=False,
            )
        )
        self._potential_fn = jax.jit(
            jax.shard_map(
                lambda psi, consts: self.stepper._potential(psi, consts),
                mesh=self.mesh,
                in_specs=(self.psi_spec, self.consts_specs),
                out_specs=self.psi_spec,
                check_vma=False,
            )
        )

        # Device-placed, mesh-sharded constants. With spatial sharding the
        # rfft half-spectrum grid is unused (pencil path) — replace it with
        # a placeholder instead of replicating a large array per device.
        consts_host = self.stepper.consts
        if shard_space:
            consts_host = dataclasses.replace(
                consts_host,
                spec_grid_r=jnp.zeros((1,) * params.dims, self.stepper.rdtype),
            )
        self.consts = jax.device_put(
            consts_host,
            jax.tree_util.tree_map(
                lambda spec: NamedSharding(mesh, spec), self.consts_specs
            ),
        )

    # -- public API mirroring Stepper ----------------------------------

    @property
    def dtype(self):
        return self.stepper.dtype

    @property
    def tdtype(self):
        return self.stepper.tdtype

    @property
    def tau_dumps(self):
        return self.stepper.tau_dumps

    def init_state(self, psi0, batched: bool = True) -> SimState:
        n_stream = self.mesh.shape[STREAM_AXIS]
        if psi0.ndim == self.params.dims:
            raise ValueError("MeshStepper requires a leading stream batch axis")
        if psi0.shape[0] % n_stream != 0:
            raise ValueError(
                f"stream count {psi0.shape[0]} not divisible by stream axis {n_stream}"
            )
        sharding = NamedSharding(self.mesh, self.psi_spec)
        if not isinstance(psi0, jax.Array):
            psi0 = np.asarray(psi0, self.stepper.dtype)
        # device arrays reshard without a host round trip
        return self._init_fn(jax.device_put(psi0, sharding), self.consts)

    def gather_psi(self, state: SimState) -> np.ndarray:
        """Fetch the full (streams, *grid) psi to host."""
        return np.asarray(state.psi)

    def gather_spatial(self, arr):
        """Reshard (streams, *grid) to stream-only sharding.

        Space axes become replicated, so every process holds WHOLE grids
        for the streams on its devices — the dump/combine path for grids
        that span hosts (one all_gather over the space axes, at dump
        cadence only). No-op without spatial sharding.
        """
        if not self.shard_space:
            return arr
        import jax as _jax

        spec = P(STREAM_AXIS, *((None,) * self.params.dims))
        sharding = NamedSharding(self.mesh, spec)
        return _jax.jit(lambda a: a, out_shardings=sharding)(arr)

    def evolve_to_next_dump(self, state: SimState, batched: bool = True) -> SimState:
        return self._evolve(state, self.consts)

    def evolve_intervals(
        self, state: SimState, k: int, with_potential: bool = False, combine=None
    ):
        """Advance k dump intervals in ONE compiled mesh program (the
        dispatch-latency amortization of `Stepper.evolve_intervals`, on the
        mesh: one host round trip per k dumps instead of per dump).

        The stacked dump payload leaves the program host-consumable:
        per-stream scalars are all_gathered over the stream axis (tiny;
        every process can read them without further collectives —
        mesh.host_local_value) and the psi/pot planes are all_gathered over
        the SPACE axes (one gather per block at dump cadence, the same
        traffic `gather_spatial` pays per dump on the one-interval path),
        staying stream-sharded so multi-host fetches stay process-local
        (mesh.fetch_stacked_slices).

        With ``combine=(n_runs, dv)`` each row additionally carries the
        online-synthesis reductions (Stepper._combine_row, mesh-aware:
        global-index stream mask + psum over the stream axis; Qx psummed
        over the space axes). The combined mean fields are all_gathered
        over the space axes alongside the dump planes and leave the
        program fully replicated — every process reads them from the
        payload, process 0 writes (`OnlineCombiner.write_row`).
        """
        return self._interval_fn(k, with_potential, combine)(state, self.consts)

    def _interval_fn(self, k: int, with_potential: bool = False, combine=None):
        """The compiled k-interval mesh program (cached per key). Exposed
        so callers can AOT-lower and compile it (e.g. for
        `memory_analysis()`) with ShapeDtypeStruct inputs."""
        from jax import lax

        key = (int(k), bool(with_potential), combine)
        fn = self._interval_jits.get(key)
        if fn is None:
            scalar_names = (
                "just_dumped", "aliased", "alias_mass", "max_norm_err",
                "n_steps", "dt_min", "dt_max", "replays",
                "current_dumps", "time", "tau", "a",
            )
            grid_names = ("psi",) + (
                ("pot",) if with_potential else ()
            )
            # array-axis -> mesh-axis gathers for the payload grids, from
            # the psi spec (skip the leading stream entry; +2 for the scan
            # and stream axes)
            space_gathers = [
                (ax + 2, names)
                for ax, names in enumerate(self.psi_spec[1:])
                if names is not None
            ]
            # combine mean fields have NO stream axis (already psummed over
            # it): payload offset +1, sharding from psi/psik grid specs
            comb_psi_names = ("comb_psi", "comb_psi2")
            comb_psik_names = ("comb_psik", "comb_psik2")
            comb_gathers = [
                (name, ax + 1, mesh_names)
                for spec, names_ in (
                    (self.psi_spec, comb_psi_names),
                    (self.psik_spec, comb_psik_names),
                )
                for ax, mesh_names in enumerate(spec[1:])
                if mesh_names is not None
                for name in names_
            ]

            def body(s, consts):
                snapped, outs = self.stepper._evolve_intervals(
                    s, consts, k=key[0], with_potential=key[1], combine=combine
                )
                for name in scalar_names:
                    outs[name] = lax.all_gather(
                        outs[name], STREAM_AXIS, axis=1, tiled=True
                    )
                for name in grid_names:
                    for ax, mesh_names in space_gathers:
                        outs[name] = lax.all_gather(
                            outs[name], mesh_names, axis=ax, tiled=True
                        )
                if combine is not None:
                    for name, ax, mesh_names in comb_gathers:
                        outs[name] = lax.all_gather(
                            outs[name], mesh_names, axis=ax, tiled=True
                        )
                return snapped, outs

            dims = self.params.dims
            payload_spec = P(None, STREAM_AXIS, *((None,) * dims))
            outs_specs = {name: P(None, None) for name in scalar_names}
            outs_specs.update({name: payload_spec for name in grid_names})
            if combine is not None:
                comb_grid_spec = P(None, *((None,) * dims))
                outs_specs.update(
                    {n: comb_grid_spec for n in comb_psi_names + comb_psik_names}
                )
                outs_specs.update({"comb_n": P(None), "comb_qx": P(None)})
            from ..stepper import _donate_enabled

            fn = jax.jit(
                jax.shard_map(
                    body,
                    mesh=self.mesh,
                    in_specs=(self.state_specs, self.consts_specs),
                    out_specs=(self.state_specs, outs_specs),
                    check_vma=False,
                ),
                # input state donated, same contract as Stepper.evolve_intervals
                donate_argnums=(0,) if _donate_enabled() else (),
            )
            self._interval_jits[key] = fn
        return fn

    def step(self, state: SimState) -> SimState:
        return self._step_fn(state, self.consts)

    def potential(self, psi):
        return self._potential_fn(psi, self.consts)

    def snap_after_dump(self, state: SimState) -> SimState:
        return self.stepper.snap_after_dump(state)

    def not_finished(self, state: SimState) -> bool:
        return self.stepper.not_finished(state)

