"""Device mesh construction and state sharding.

The reference is strictly single-device for simulation (`main.rs:23`
`set_device(0)`) and uses MPI only for offline analysis. Here the two
physical parallelism axes of the problem become mesh axes:

- ``stream``: the quantum-sampling ensemble (embarrassingly parallel; the
  reference runs seeds sequentially, `main.rs:43-79`). Pure data parallel.
- ``x``: spatial decomposition of the grid along its first (slowest) axis —
  the field-simulation analogue of sequence parallelism. FFTs across the
  sharded axis go through `msm_tpu.parallel.pfft` (all_to_all transposes
  between devices) or XLA SPMD resharding.

Multi-host: `jax.distributed.initialize` + the same mesh over all devices;
host-side work (dump writing, offline synthesis) is split by process index
(`local_dump_range`), replacing the reference's MPI Balancer
(`synthesizer/src/balancer.rs:75-83`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

STREAM_AXIS = "stream"
SPACE_AXIS = "x"
SPACE2_AXIS = "y"


def _split_devices(n: int) -> tuple[int, int, int]:
    """Factor n devices into (stream, x, y) mesh dims.

    Powers of two are dealt round-robin across (stream, x, y) — 8 devices
    become the (2, 2, 2) pencil mesh, 4 become (2, 2, 1) — and any odd
    remainder goes to the stream axis (free parallelism). There is no cap
    on the space axes (the round-1 max_space=4 slab cap is gone): the 2-D
    pencil scales to px*py devices.
    """
    dims = [1, 1, 1]
    i = 0
    while n % 2 == 0:
        dims[i % 3] *= 2
        n //= 2
        i += 1
    dims[0] *= n
    return tuple(dims)


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> tuple[Mesh, tuple[str, str, str]]:
    """Build a (stream, x, y) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    shape = _split_devices(n)
    names = (STREAM_AXIS, SPACE_AXIS, SPACE2_AXIS)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, names), names


def local_dump_range(dumps: Sequence[int]) -> Sequence[int]:
    """Contiguous chunk of the dump list owned by this host process.

    Multi-host analogue of Balancer::local_set
    (`synthesizer/src/balancer.rs:75-83`).
    """
    n_proc = jax.process_count()
    rank = jax.process_index()
    chunk = (len(dumps) + n_proc - 1) // n_proc
    return dumps[rank * chunk : (rank + 1) * chunk]


def addressable_batch_indices(arr) -> Sequence[int]:
    """Leading-axis indices whose shards live on this process's devices.

    Multi-host dump ownership: with the stream axis sharded over processes,
    each process writes exactly the streams it holds (the simulator-side
    analogue of the Balancer's rank-chunked ownership,
    `synthesizer/src/balancer.rs:75-83`).
    """
    idx = set()
    n = arr.shape[0]
    for shard in arr.addressable_shards:
        sl = shard.index[0]
        if isinstance(sl, slice):
            idx.update(range(*sl.indices(n)))
        else:
            idx.add(int(sl))
    return sorted(idx)


def _owner_indices(arr, axis: int) -> Sequence[int]:
    """Stream indices (along `axis`) this process should WRITE: ownership
    goes to the lowest process index holding each index, so every dump is
    written exactly once across the job even when grids are replicated
    over space axes (after `MeshStepper.gather_spatial`)."""
    n = arr.shape[axis]
    owners: dict[int, int] = {}
    for dev, idx in arr.sharding.devices_indices_map(arr.shape).items():
        sl = idx[axis]
        rng = range(*sl.indices(n)) if isinstance(sl, slice) else [int(sl)]
        for i in rng:
            p = dev.process_index
            if i not in owners or p < owners[i]:
                owners[i] = p
    me = jax.process_index()
    return sorted(i for i, p in owners.items() if p == me)


def _fetch_slices(arr, indices: Sequence[int], axis: int):
    """Fetch {i: np.ndarray} of per-stream slices (along `axis`) from this
    process's local shards. Axes other than `axis` must be unsharded."""
    import numpy as _np

    out = {}
    want = set(indices)
    for shard in arr.addressable_shards:
        sl = shard.index[axis]
        start = (
            sl.indices(arr.shape[axis])[0] if isinstance(sl, slice) else int(sl)
        )
        data = None
        for j in range(shard.data.shape[axis]):
            gi = start + j
            if gi in want and gi not in out:
                if data is None:
                    data = _np.asarray(shard.data)
                out[gi] = data[j] if axis == 0 else data[:, j]
    return out


def write_owner_indices(arr) -> Sequence[int]:
    """Leading-axis (stream) indices this process should WRITE."""
    return _owner_indices(arr, 0)


def fetch_batch_slices(arr, indices: Sequence[int]):
    """Fetch {i: np.ndarray} for owned leading-axis slices from local shards."""
    return _fetch_slices(arr, indices, 0)


def write_owner_indices_axis1(arr) -> Sequence[int]:
    """`write_owner_indices` for a STACKED payload: the stream axis is
    axis 1 (axis 0 is the interval-block scan axis)."""
    return _owner_indices(arr, 1)


def fetch_stacked_slices(arr, indices: Sequence[int]):
    """Fetch {i: np.ndarray of shape (k, *grid)} for owned STREAM indices
    (axis 1) of a stacked (k, streams, *grid) payload from local shards.

    Requires the payload to be unsharded along axis 0 and the space axes
    (the mesh interval-block path all_gathers those first)."""
    return _fetch_slices(arr, indices, 1)


def host_local_value(arr):
    """np.ndarray of a jax.Array that is replicated across processes (or
    fully addressable): multi-host states keep tiny per-stream scalars
    replicated so every process can read them without collectives."""
    import numpy as _np

    if getattr(arr, "is_fully_addressable", True):
        return _np.asarray(arr)
    return _np.asarray(arr.addressable_shards[0].data)
