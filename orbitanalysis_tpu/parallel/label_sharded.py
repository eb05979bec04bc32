"""Particle-sharded label-native detection via ``shard_map``.

The label detector (:mod:`orbitanalysis_tpu.ops.label_step`) is
elementwise over the global particle pool except for the per-halo
frame moments, so the multi-chip form shards the PARTICLE axis: each
device detects over its pool block with zero joins, and the only
collective per step is a ``psum`` of the tiny ``[H, 4]`` bulk-velocity
moments (the same collective shape as the hash engine's — SURVEY.md
§2's "distributed comm" row).  Centers are replicated (``[H, 3]`` is
bytes).  Events come back per shard-local compaction row; the global
pool index of an event is ``shard_offset + local_index``, added
in-kernel so consumers never see shard-local coordinates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # moved out of experimental in newer jax
    from jax import shard_map
    _SHARD_MAP_KW = {"check_vma": False}
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
    _SHARD_MAP_KW = {"check_rep": False}

from orbitanalysis_tpu.ops.label_step import (
    LabelCarry,
    _segment_moments_gather,
    _segment_moments_matmul,
    _segment_moments_twolevel,
    make_label_orbit_step,
)
from orbitanalysis_tpu.policy import label_frames

__all__ = ["make_sharded_label_step", "shard_label_tree"]


def shard_label_tree(mesh: Mesh, carry: LabelCarry):
    """Place a :class:`LabelCarry` with its ``[R, W]`` row planes
    sharded over the mesh's 'particles' axis (rows are contiguous
    particle blocks, so row-sharding IS particle-sharding; ``R`` must
    be a multiple of the axis size)."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x,
            NamedSharding(
                mesh,
                P("particles", None) if x.ndim == 2
                else P(None, "particles", None),
            ),
        ),
        carry,
    )


def make_sharded_label_step(
    mesh: Mesh,
    event_capacity: int,
    n_halos: int,
    mode: str = "pericentric",
    box_size=None,
    row_width: int = 1 << 15,
    frames: str = "auto",
):
    """Particle-sharded label step: ``step(carry, (pos [3, N], vel,
    label [N], centers [H, 3], mass or None, hubble_drag))`` with every
    ``[N]`` plane sharded over ``mesh``'s 'particles' axis.

    Per-shard work is the single-chip step on the local block; the one
    collective is the psum of the ``[H, 4]`` mass-weighted velocity
    moments (reference bulk semantics, ``track_orbits.py:267-284``).
    Event indices are global pool indices.
    """
    if "particles" not in mesh.axis_names:
        raise ValueError("mesh needs a 'particles' axis")
    n_shards = int(mesh.shape["particles"])

    local = make_label_orbit_step(
        event_capacity, mode=mode, box_size=box_size, n_halos=n_halos,
        row_width=row_width, frames=frames,
    )

    def shard_fn(carry, pos, vel, label, centers, mass, drag):
        # global mass-weighted bulk moments: local pass + one tiny psum
        # over the particle axis; 'auto' resolves per halo count, like
        # the single-chip step
        valid = label >= 0
        lab_m = jnp.where(valid, label, -1)
        impl = label_frames(n_halos) if frames == "auto" else frames
        w = (jnp.ones(label.shape, jnp.float32) if mass is None
             else mass)
        w = jnp.where(valid, w, 0.0)
        if impl == "gather":
            mom = _segment_moments_gather(
                jnp.concatenate([vel * w[None], w[None, :]], axis=0),
                lab_m, n_halos,
            )
        elif impl == "twolevel":
            mom = _segment_moments_twolevel(
                jnp.concatenate([vel * w[None], w[None, :]], axis=0),
                lab_m, n_halos,
            )
        else:
            mom = _segment_moments_matmul(
                jnp.stack([vel[0] * w, vel[1] * w, vel[2] * w, w],
                          axis=-1),
                lab_m, n_halos,
                precision=("bf16x3" if impl == "matmul_bf16x3"
                           else "f32"),
            )
        mom = jax.lax.psum(mom, axis_name="particles")
        bulk = mom[:, :3] / jnp.maximum(mom[:, 3:4], 1e-30)
        new_carry, ev = local(
            carry, (pos, vel, label, centers, bulk, mass, drag)
        )
        # shard-local event positions -> global pool indices
        shard = jax.lax.axis_index("particles")
        n_local = label.shape[0]
        ev = ev._replace(
            index=jnp.where(
                ev.index >= 0, ev.index + shard * n_local, ev.index
            ),
            bulk_vel=bulk,
        )
        return new_carry, ev

    pspec = P("particles")
    # carry planes are [R, W] rows (rhat [3, R, W]), sharded on rows
    rowspec = P("particles", None)
    carry_spec = LabelCarry(
        lab_sv=rowspec, rhat=P(None, "particles", None), packed=rowspec
    )

    def step(carry, inputs):
        pos, vel, label, centers, mass, drag = inputs
        from orbitanalysis_tpu.ops.label_step import LabelEvents

        if mass is None:
            # uniform weights: the mass-weighted mean IS the plain mean
            # (keeps the shard_map arg tree static)
            mass = jnp.ones(label.shape, jnp.float32)
        ev_spec = LabelEvents(
            count=pspec, index=pspec, angle=pspec, bulk_vel=P()
        )
        f = shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                carry_spec,
                P(None, "particles"),
                P(None, "particles"),
                pspec,
                P(),  # centers replicated
                pspec,
                P(),
            ),
            out_specs=(carry_spec, ev_spec),
            **_SHARD_MAP_KW,
        )
        return f(carry, pos, vel, label, centers, mass, drag)

    return step, n_shards
