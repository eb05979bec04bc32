"""Halo-sharded sorted-carry and aligned steps via ``shard_map``.

Every halo row is independent (the reference parallelized the same
axis with its process pool,
``/root/reference/orbitanalysis/track_orbits.py:189-194``), so the
mesh-parallel step is an explicit ``shard_map`` over the halo axis:
each device runs the whole step on its row block with **zero
collectives** — the interconnect is only touched by the host's initial
sharding of the batch.  Rows are whole per device (the per-row sort
and compaction need the full row); shard halos, not particles.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

try:  # moved out of experimental in newer jax
    from jax import shard_map
    _SHARD_MAP_KW = {"check_vma": False}
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
    _SHARD_MAP_KW = {"check_rep": False}

from orbitanalysis_tpu.ops.sorted_step import (
    make_aligned_native_step,
    make_sorted_orbit_step,
)
from orbitanalysis_tpu.parallel.sharding import tree_sharding_specs


def _shard_step(step, mesh: Mesh):
    """Wrap a per-row step in a halo-axis ``shard_map``: every halo row
    is independent, so each device runs the full step on its row block
    with zero collectives."""
    if "halos" not in mesh.axis_names:
        raise ValueError("mesh needs a 'halos' axis")
    if "particles" in mesh.axis_names:
        raise ValueError(
            "the sorted and aligned steps need whole rows per device; "
            "shard the halo axis only"
        )

    def sharded(carry, batch):
        in_specs = tree_sharding_specs((carry, batch), mesh)
        out_shape = jax.eval_shape(step, carry, batch)
        out_specs = tree_sharding_specs(out_shape, mesh)
        f = shard_map(
            step,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            **_SHARD_MAP_KW,
        )
        return f(carry, batch)

    return sharded


def make_sharded_sorted_step(mesh: Mesh, event_capacity: int, **kwargs):
    """Build a halo-sharded ``step(carry, batch) -> (carry, events)``.

    ``mesh`` must have a ``'halos'`` axis and no ``'particles'`` axis;
    the halo count must divide by the axis size.  Remaining kwargs go to
    :func:`orbitanalysis_tpu.ops.sorted_step.make_sorted_orbit_step`.
    """
    return _shard_step(make_sorted_orbit_step(event_capacity, **kwargs), mesh)


def make_sharded_aligned_step(mesh: Mesh, event_capacity: int, **kwargs):
    """Halo-sharded stable-layout aligned step (same mesh contract as
    :func:`make_sharded_sorted_step`; kwargs go to
    :func:`orbitanalysis_tpu.ops.sorted_step.make_aligned_native_step` —
    the carry is an ``AlignedCarry``)."""
    return _shard_step(
        make_aligned_native_step(event_capacity, **kwargs), mesh
    )
