"""Distributed (slab/pencil) FFT over a mesh axis via shard_map collectives.

The reference runs whole-grid single-GPU FFTs (ArrayFire fft3,
`simulator/src/utils/fft.rs:6-98`; largest configured grid 512^3). This
module is the scalability counterpart: the grid's first spatial axis is
sharded over the ``x`` mesh axis, and a d-dim FFT becomes

    local FFT over the (d-1) unsharded axes
    -> all_to_all transpose between devices (split next axis, gather sharded axis)
    -> local FFT over the remaining axis

**Layout convention** (the key throughput decision): forward transforms
return k-space in the *transposed* distribution and inverse transforms accept
it, so the k-space round trip F -> (elementwise phase) -> F^-1 costs TWO
all_to_alls instead of four. All k-space elementwise work in the stepper
(kinetic phases, Poisson k^-2 multiply, alias reduction) is layout-agnostic:
the global k-array contents equal `jnp.fft.fftn` output exactly; only the
sharding differs.

  canonical  (real space): sharded along axis -dims   (z for 3-D)
  transposed (k space)   : sharded along axis -dims+1 (y for 3-D)

Leading (stream batch) axes pass through untouched. 1-D grids cannot be
spatially sharded (use the stream axis instead).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def canonical_shard_axis(dims: int) -> int:
    """Array axis (negative) sharded in real space."""
    return -dims


def transposed_shard_axis(dims: int) -> int:
    """Array axis (negative) sharded in k space (transposed layout)."""
    return -dims + 1


def _pos(axis: int, ndim: int) -> int:
    return axis % ndim


def fftn_pencil(x: jnp.ndarray, dims: int, axis_names: tuple) -> jnp.ndarray:
    """Forward ortho FFT over a 2-D pencil decomposition (3-D grids).

    Input layout  (.., Z/px, Y/py, X)  — real-space pencil
    Output layout (.., Z, Y/px, X/py) — transposed k-space pencil

    Stages: local FFT over X -> all_to_all over `py` (split X, gather Y) ->
    local FFT over Y -> all_to_all over `px` (split Y, gather Z) -> local
    FFT over Z. Two all_to_alls per transform; the inverse runs the mirror,
    so a full F -> elementwise -> F^-1 round trip costs four — the pencil
    analogue of the slab layout convention above. Scales to px*py devices
    (vs `size` for a slab) with per-stage message sizes N^3/(px*py).
    """
    px, py = axis_names
    nd = x.ndim
    assert dims == 3, "pencil decomposition is defined for 3-D grids"
    zax, yax, xax = nd - 3, nd - 2, nd - 1
    x = jnp.fft.fft(x, axis=xax, norm="ortho")
    x = lax.all_to_all(x, py, split_axis=xax, concat_axis=yax, tiled=True)
    x = jnp.fft.fft(x, axis=yax, norm="ortho")
    x = lax.all_to_all(x, px, split_axis=yax, concat_axis=zax, tiled=True)
    x = jnp.fft.fft(x, axis=zax, norm="ortho")
    return x


def ifftn_pencil(xk: jnp.ndarray, dims: int, axis_names: tuple) -> jnp.ndarray:
    """Inverse ortho FFT: transposed k-pencil in, real-space pencil out."""
    px, py = axis_names
    nd = xk.ndim
    assert dims == 3, "pencil decomposition is defined for 3-D grids"
    zax, yax, xax = nd - 3, nd - 2, nd - 1
    x = jnp.fft.ifft(xk, axis=zax, norm="ortho")
    x = lax.all_to_all(x, px, split_axis=zax, concat_axis=yax, tiled=True)
    x = jnp.fft.ifft(x, axis=yax, norm="ortho")
    x = lax.all_to_all(x, py, split_axis=yax, concat_axis=xax, tiled=True)
    x = jnp.fft.ifft(x, axis=xax, norm="ortho")
    return x


def fftn_sharded(x: jnp.ndarray, dims: int, axis_name: str) -> jnp.ndarray:
    """Forward ortho FFT: canonical-sharded in, transposed-sharded out."""
    assert dims >= 2, "1-D grids cannot be spatially sharded"
    nd = x.ndim
    local_axes = tuple(range(nd - dims + 1, nd))  # all but the sharded axis
    x = jnp.fft.fftn(x, axes=local_axes, norm="ortho")
    # transpose: split the next axis across devices, gather the sharded axis
    x = lax.all_to_all(
        x,
        axis_name,
        split_axis=_pos(-dims + 1, nd),
        concat_axis=_pos(-dims, nd),
        tiled=True,
    )
    x = jnp.fft.fft(x, axis=_pos(-dims, nd), norm="ortho")
    return x


def ifftn_sharded(xk: jnp.ndarray, dims: int, axis_name: str) -> jnp.ndarray:
    """Inverse ortho FFT: transposed-sharded in, canonical-sharded out."""
    assert dims >= 2, "1-D grids cannot be spatially sharded"
    nd = xk.ndim
    x = jnp.fft.ifft(xk, axis=_pos(-dims, nd), norm="ortho")
    x = lax.all_to_all(
        x,
        axis_name,
        split_axis=_pos(-dims, nd),
        concat_axis=_pos(-dims + 1, nd),
        tiled=True,
    )
    local_axes = tuple(range(nd - dims + 1, nd))
    x = jnp.fft.ifftn(x, axes=local_axes, norm="ortho")
    return x
