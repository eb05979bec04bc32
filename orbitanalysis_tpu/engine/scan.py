"""Device-resident snapshot-sequence driver via ``lax.scan``.

The reference walks the snapshot axis with a host Python loop, reloading
state each iteration (``/root/reference/orbitanalysis/track_orbits.py:104``).
The time axis is a true dependency chain (each step consumes the previous
step's per-particle state, ``track_orbits.py:234-240``), so the TPU-native
formulation is a ``lax.scan`` with the per-particle carry resident on device
and the snapshot stack either pre-staged in HBM or fed per-step by the
host pipeline in :mod:`orbitanalysis_tpu.engine.tracker`.

Two variants:

- :func:`scan_events` — emits the per-step apsis event tensors needed by
  the savefile writer (apsis mask + angle at apsis, prev-snapshot layout);
- :func:`scan_counts` — accumulates per-particle apsis counts in the carry
  and emits nothing per step: the pure-throughput configuration used for
  benchmarking and for on-device orbit-count censuses
  (the device-side equivalent of ``postprocessing.py:133-142``'s
  per-halo counting, without materializing intermediate catalogs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbitanalysis_tpu.ops.apsis import Carry, SnapshotBatch, make_orbit_step


def _with_drag_axis(snaps: SnapshotBatch) -> SnapshotBatch:
    """Broadcast a scalar ``hubble_drag`` to the snapshot axis so every
    leaf scans (lax.scan rejects axis-less leaves)."""
    drag = snaps.hubble_drag
    if jnp.ndim(drag) == 0:
        n = snaps.ids.shape[0]
        drag = jnp.broadcast_to(jnp.asarray(drag, jnp.float32), (n,))
        return snaps._replace(hubble_drag=drag)
    return snaps


class CountingCarry(NamedTuple):
    """Carry for the count-accumulating scan: the tracking carry plus a
    per-slot apsis counter aligned with the *current* snapshot layout."""

    track: Carry
    counts: jnp.ndarray  # [H, P] int32, current-snapshot slot layout


def scan_events(
    carry: Carry,
    snaps: SnapshotBatch,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
):
    """Run the fused orbit step over a stacked snapshot sequence.

    ``snaps`` is a :class:`SnapshotBatch` whose leaves carry a leading
    snapshot axis ``[S, ...]`` (``mass``/``bulk_vel`` may be ``None``;
    ``hubble_drag`` may be scalar or ``[S]``).  Returns
    ``(final_carry, (apsis [S,H,P] bool, apsis_angle [S,H,P]))`` with the
    event tensors in previous-snapshot slot layout, exactly what the
    savefile writer compacts (``track_orbits.py:199-217``).
    """
    step = make_orbit_step(mode=mode, box_size=box_size, id_dtype=id_dtype)

    def body(c, s):
        c, ev = step(c, s)
        return c, (ev.apsis, ev.apsis_angle)

    return jax.lax.scan(body, carry, _with_drag_axis(snaps))


def scan_events_compact(
    carry: Carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
):
    """Like :func:`scan_events` but with on-device event compaction: per
    step the events are sorted to the front of each halo row so the
    output is ``(ev_count [S,H], ev_ids [S,H,K], ev_angles [S,H,K])`` —
    an ~P/K cut in HBM event traffic and host transfer.  Rows where
    ``ev_count > K`` overflowed; re-run those snapshots through
    :func:`scan_events` (or raise ``event_capacity``).
    """
    step = make_orbit_step(
        mode=mode, box_size=box_size, id_dtype=id_dtype,
        event_capacity=event_capacity,
    )

    def body(c, s):
        c, ev = step(c, s)
        return c, (ev.ev_count, ev.ev_ids, ev.ev_angles)

    return jax.lax.scan(body, carry, _with_drag_axis(snaps))


def scan_events_sorted(
    carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
    soa_batch: bool = False,
):
    """Sorted-carry variant of :func:`scan_events_compact` — identical
    compact event stream, one fewer sort per step.  Staged SoA
    (``ops.sorted_step.presort_snapshot(..., soa=True)``), pass
    ``soa_batch=True`` and the per-step AoS transpose disappears.
    ``carry`` is a
    :class:`orbitanalysis_tpu.ops.sorted_step.SortedCarry`.
    """
    from orbitanalysis_tpu.ops.sorted_step import make_sorted_orbit_step

    step = make_sorted_orbit_step(
        event_capacity, mode=mode, box_size=box_size, id_dtype=id_dtype,
        soa_batch=soa_batch,
    )

    def body(c, s):
        c, ev = step(c, s)
        return c, (ev.count, ev.ids, ev.angles)

    return jax.lax.scan(body, carry, _with_drag_axis(snaps))


def scan_events_aligned(
    carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
    soa_batch: bool = False,
    batched: bool = False,
    rhat_packed: bool = False,
):
    """Stable-layout sequence driver: snapshots staged by
    :func:`orbitanalysis_tpu.engine.packing.stage_batch_aligned` are
    element-wise aligned across the sequence, so membership churn needs
    no device-side join.  ``carry`` is an
    :class:`orbitanalysis_tpu.ops.sorted_step.AlignedCarry`
    (:func:`~orbitanalysis_tpu.ops.sorted_step.init_aligned_carry`);
    events come back ``(count [S,H], positions [S,H,K],
    angles [S,H,K])`` — the stable layout makes events purely
    positional: callers map positions through their staged tables
    (``staged.ids[s][h, pos]`` for particle IDs, the previous
    snapshot's staged slots for reference-order restoration, as the
    tracker does).  Event angles are quantized to float16 at the
    device boundary (the savefile's storage dtype) — that is what lets
    the whole event ride one u32 payload word through the compaction
    (:func:`orbitanalysis_tpu.ops.compact.compact_payload`).

    ``batched=False`` (default) runs the per-step ``lax.scan`` over
    :func:`~orbitanalysis_tpu.ops.sorted_step.make_aligned_native_step`
    (XLA fuses each step into a few passes over ``[H, P]`` planes).

    ``batched=True`` exploits the aligned engine's key structural
    property at the *sequence* level: apsis detection depends only on
    adjacent-snapshot sign bits and the staged FRESH flags — never on
    the angle recurrence — so nothing about detection is sequential.
    The driver therefore runs

      1. region frames for ALL snapshots in one fused elementwise pass
         (rows ``[S*H, P]`` — halo rows are independent, so the
         snapshot axis folds into the row axis for free);
      2. sign flips / apsides / ``dtheta`` batched over shifted
         snapshot slices (one ``[S, H, P]`` pass);
      3. the only true time dependency — the angle accumulator — as a
         ``lax.scan`` whose carry is a SINGLE ``[H, P]`` plane reading
         precomputed ``dtheta``/reset slices (a few MB per iteration);
      4. ONE :func:`~orbitanalysis_tpu.ops.compact.compact_payload`
         over all ``S*H`` rows.

    It materializes ~18 ``[S, H, P]`` planes, so it trades memory
    traffic for the absence of a per-step loop; the tracker and the
    benchmarks use the default.
    """
    if not batched:
        from orbitanalysis_tpu.ops.sorted_step import (
            make_aligned_native_step,
        )

        step = make_aligned_native_step(
            event_capacity, mode=mode, box_size=box_size,
            id_dtype=id_dtype, soa_batch=soa_batch,
            rhat_packed=rhat_packed,
        )

        def body(c, s):
            c, ev = step(c, s)
            return c, (ev.count, ev.ids, ev.angles)

        return jax.lax.scan(body, carry, _with_drag_axis(snaps))

    if rhat_packed:
        raise ValueError(
            "rhat_packed applies to the per-step scan (batched=False); "
            "the batched driver materializes rhat planes per snapshot "
            "anyway"
        )
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    from orbitanalysis_tpu.ops.geometry import region_frame
    from orbitanalysis_tpu.ops.compact import (
        PAYLOAD_MAX_ROW,
        compact_payload,
        compact_payload_pair,
    )
    from orbitanalysis_tpu.utils.numerics import acos_f32
    from orbitanalysis_tpu.ops.sorted_step import (
        AlignedCarry,
        _vr_bits,
    )
    from orbitanalysis_tpu.utils.padding import invalid_id_for

    if snaps.slot is None:
        raise ValueError(
            "the aligned sequence driver needs stable-layout staging: "
            "snaps.slot (with FRESH flags in bit 27) is mandatory — "
            "stage via stage_batch_aligned"
        )
    pericentric = mode == "pericentric"
    id_dt = jnp.dtype(id_dtype)
    if id_dt.itemsize != 4 or not jnp.issubdtype(id_dt, jnp.signedinteger):
        # the positional carry packs the sentinel into uint32 keys;
        # wide (e.g. Gadget uint64) IDs must be staged through the
        # int32 position-surrogate (pack_snapshot_aligned does this)
        raise ValueError(
            "the aligned sequence driver requires 32-bit signed particle "
            "IDs on device; stage wide IDs through the int32 position "
            "surrogate (pack_snapshot_aligned / the tracker's aligned "
            "engine does this automatically)"
        )
    invalid = invalid_id_for(id_dtype)
    snaps = _with_drag_axis(snaps)
    ids = snaps.ids
    S, H, P = ids.shape
    K = int(event_capacity)
    k_eff = min(K, P)

    valid = ids != invalid
    if soa_batch:
        pos = jnp.moveaxis(snaps.pos, 1, 0).reshape(3, S * H, P)
        vel = jnp.moveaxis(snaps.vel, 1, 0).reshape(3, S * H, P)
    else:
        pos = snaps.pos.reshape(S * H, P, 3)
        vel = snaps.vel.reshape(S * H, P, 3)
    frame = region_frame(
        pos,
        vel,
        valid.reshape(S * H, P),
        snaps.center.reshape(S * H, 3),
        mass=None if snaps.mass is None else snaps.mass.reshape(S * H, P),
        bulk_vel=(
            None if snaps.bulk_vel is None
            else snaps.bulk_vel.reshape(S * H, 3)
        ),
        box_size=box_size,
        hubble_drag=jnp.repeat(
            snaps.hubble_drag.astype(jnp.float32), H
        )[:, None],
        soa=soa_batch,
    )
    rhat = frame.rhat.reshape(3, S, H, P)
    vrb = _vr_bits(frame.vrad.reshape(S, H, P)).astype(jnp.int32)
    fresh = (snaps.slot & (1 << 27)) != 0
    live = valid & ~fresh

    # prev-side quantities via shifted snapshot slices (carry for s=0)
    cos0 = (
        carry.rhat[0] * rhat[0, 0]
        + carry.rhat[1] * rhat[1, 0]
        + carry.rhat[2] * rhat[2, 0]
    )
    cos_rest = (
        rhat[0, :-1] * rhat[0, 1:]
        + rhat[1, :-1] * rhat[1, 1:]
        + rhat[2, :-1] * rhat[2, 1:]
    )
    cosang = jnp.clip(
        jnp.concatenate([cos0[None], cos_rest], axis=0), -1.0, 1.0
    )
    dtheta = jnp.where(live, acos_f32(cosang), 0.0)
    prev_vrb = jnp.concatenate(
        [((carry.sv >> 24) & 3)[None], vrb[:-1]], axis=0
    )
    if pericentric:
        flip = ((prev_vrb & 1) > 0) & ((vrb & 2) > 0)
    else:
        flip = ((prev_vrb & 2) > 0) & ((vrb & 1) > 0)
    apsis = live & flip
    count = jnp.sum(apsis, axis=-1, dtype=jnp.int32)

    # the single true time dependency: the angle accumulator (one
    # [H, P] carry plane; every operand slice is precomputed above)
    ang0 = jax.lax.bitcast_convert_type(
        carry.packed & jnp.uint32(0x7FFFFFFF), jnp.float32
    )

    def body(ang, x):
        dth, frs, aps, vld = x
        acc = jnp.where(frs, 0.0, ang + dth)
        return jnp.where(aps | ~vld, 0.0, acc), jnp.where(aps, acc, 0.0)

    ang_final, ev_ang = jax.lax.scan(
        body, ang0, (dtheta, fresh, apsis, valid)
    )

    # one compaction over all S*H rows — a single u32 payload word per
    # event (see compact_payload): position + f16 angle.  Rows wider
    # than PAYLOAD_MAX_ROW take the two-word format: pos + 1 = 2**17
    # would wrap the single word to zero and drop the last position.
    pos_iota = jax.lax.broadcasted_iota(jnp.int32, (S, H, P), 2)
    ang15 = jax.lax.bitcast_convert_type(
        ev_ang.astype(jnp.float16), jnp.uint16
    ).astype(jnp.uint32)
    if P <= PAYLOAD_MAX_ROW:
        payload = jnp.where(
            apsis,
            ((pos_iota + 1).astype(jnp.uint32) << 15) | ang15,
            jnp.uint32(0),
        )
        evpay, _ = compact_payload(payload.reshape(S * H, P), k_eff)
        ev_pos = (evpay >> 15).astype(jnp.int32) - 1
        ev_ang_bits = evpay & jnp.uint32(0x7FFF)
    else:
        posw = jnp.where(
            apsis, (pos_iota + 1).astype(jnp.uint32), jnp.uint32(0)
        )
        evposw, ev_ang_bits, _ = compact_payload_pair(
            posw.reshape(S * H, P), ang15.reshape(S * H, P), k_eff
        )
        ev_pos = evposw.astype(jnp.int32) - 1
    evang = jax.lax.bitcast_convert_type(
        ev_ang_bits.astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    kw = ev_pos.shape[-1]
    kiota = jax.lax.broadcasted_iota(jnp.int32, (S * H, kw), 1)
    ev_ok = kiota < count.reshape(S * H)[:, None]
    ev_ids = jnp.where(ev_ok, ev_pos, jnp.asarray(invalid, id_dt))[:, :K]
    ev_angles = jnp.where(ev_ok, evang, 0.0)[:, :K]
    kw = ev_ids.shape[-1]
    key = jnp.where(
        valid[-1],
        (pos_iota[-1].astype(jnp.uint32) << 1) | 1,
        (jnp.uint32(invalid) << 1) | 1,
    )
    cur_sv = snaps.slot | (vrb << 24)
    final_carry = AlignedCarry(
        key=key,
        sv=cur_sv[-1],
        rhat=rhat[:, -1],
        packed=jax.lax.bitcast_convert_type(ang_final, jnp.uint32)
        | (live[-1].astype(jnp.uint32) << 31),
    )
    return final_carry, (
        count,
        ev_ids.reshape(S, H, kw),
        ev_angles.reshape(S, H, kw),
    )


def scan_counts(
    carry: CountingCarry,
    snaps: SnapshotBatch,
    mode: str = "pericentric",
    box_size=None,
    angle_cut: float = 0.0,
    id_dtype=jnp.int32,
):
    """Scan that keeps cumulative per-particle apsis counts on device.

    Counts ride the ID-matched slot permutation each step (entered
    particles restart at 0, matching region-entry semantics at
    ``track_orbits.py:180-183``).  ``angle_cut`` filters spurious
    in-subhalo passages exactly like collation does
    (``postprocessing.py:121-128``) but on device, fused into the scan.

    Returns ``(final CountingCarry, total apsis events per step [S])``.
    """
    from orbitanalysis_tpu.ops.join import gather_rows

    step = make_orbit_step(
        mode=mode, box_size=box_size, id_dtype=id_dtype, with_prev_slot=True
    )

    def body(c: CountingCarry, s):
        track, ev = step(c.track, s)
        hit = ev.apsis & (ev.apsis_angle > angle_cut)
        counts_prev = c.counts + hit.astype(c.counts.dtype)
        # re-index counts from prev layout to the new snapshot's layout
        # via the slot map the step already computed; entered / padding
        # slots reset to zero (region-entry semantics).
        counts_new = gather_rows(counts_prev, ev.prev_slot, fill=0)
        return (
            CountingCarry(track=track, counts=counts_new),
            jnp.sum(hit, dtype=jnp.int32),
        )

    return jax.lax.scan(body, carry, _with_drag_axis(snaps))


def stack_batches(batches):
    """Stack per-snapshot :class:`SnapshotBatch` pytrees along a new
    leading snapshot axis (host-side helper for pre-staging sequences)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *batches)
