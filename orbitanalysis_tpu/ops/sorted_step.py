"""Sorted-carry and stable-layout (aligned) variants of the per-snapshot
orbit step.

Same semantics as :func:`orbitanalysis_tpu.ops.apsis.make_orbit_step`
with event compaction (the reference's ``compare_radial_velocities`` +
``calc_angles`` chain, ``/root/reference/orbitanalysis/track_orbits.py:
293-351``), with the carried per-particle state laid out differently.

**Sorted carry** (:func:`make_sorted_orbit_step`): the carry is kept
sorted by particle ID between steps instead of in snapshot load order.
The general step's cost is three ``lax.sort`` networks per snapshot —

  1. merge sort of ``concat(prev, cur)`` by ID   (the join),
  2. restore sort back to slot order             (layout restoration),
  3. event-compaction sort                        (front-pack apsides).

With the carry stored in ID order, sorts 2 and 3 collapse into one:
after the merge, a single sort keyed by

  ``cur entry -> 0`` (stable: preserves ID order = the next carry),
  ``prev entry at an apsis -> 1 + load_slot`` (events, reference order),
  ``anything else -> BIG``

produces the next carry in positions ``[:P]`` and the compacted event
list — already in previous-snapshot load order, the reference's
within-halo output order (``track_orbits.py:199-217``) — in positions
``[P:P+K]``.  One 2P sort replaces a 2P sort plus a P sort.

**Aligned carry** (:func:`make_aligned_native_step`): the host staging
assigns every particle a persistent row position, so prev and cur are
aligned element-wise and the device runs no join at all; detection is
elementwise and only the event compaction (``ops/compact.py``) is not.

The compact event outputs are **identical** (same IDs, same order, same
angles) to the general step's ``ev_*`` outputs; only the carry layout
differs.  Load-order bookkeeping survives in the carry's ``slot``
channel, so checkpointing per-particle angles in reference layout stays
possible (``track_orbits.py:390-394``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbitanalysis_tpu.ops.geometry import region_frame
from orbitanalysis_tpu.utils.numerics import acos_f32, f16_bits_rne
from orbitanalysis_tpu.utils.padding import invalid_id_for

#: Per-row capacity ceiling of the sorted and aligned engines: the
#: packed ``sv`` channel holds the load-order slot in bits 0-23 (the
#: radial-velocity sign bits and the aligned staging's FRESH flag sit
#: above it, ``engine/packing.py``), so a row holds at most 2**24
#: entries.  Rows wider than the single-word payload's
#: ``PAYLOAD_MAX_ROW`` take the two-word event format automatically.
MAX_ROW_CAPACITY = 1 << 24

#: key_B value for merged entries that are neither part of the next
#: carry nor an apsis event (departed / padding / matched-away prev).
_DEAD_KEY = 1 << 30  # python int: a jnp scalar here would
#   initialize the XLA backend at import (breaks jax.distributed)


class SortedCarry(NamedTuple):
    """Per-particle state carried across snapshots, sorted by ID.

    ``ids`` is ascending within each halo row with the dtype-max padding
    sentinel last; ``slot`` records each particle's load-order slot in
    the snapshot it arrived with (for reference-layout reconstruction).
    ``vrb`` stores the radial-velocity sign as 2 bits (bit0: v_r < 0,
    bit1: v_r > 0) — detection only ever uses the sign
    (``track_orbits.py:311-314``), so the full value never rides a sort.
    """

    ids: jnp.ndarray     # [H, P] sorted ascending, sentinel-padded
    slot: jnp.ndarray    # [H, P] int32 load-order slot
    vrb: jnp.ndarray     # [H, P] uint8 v_r sign bits
    rhat: jnp.ndarray    # [3, H, P] radial unit vectors (SoA)
    angles: jnp.ndarray  # [H, P] cumulative angle since last apsis/entry


class CompactEvents(NamedTuple):
    """Per-step compact apsis events: previous-snapshot load order, or
    layout order with the previous load slots alongside (``slots``)."""

    count: jnp.ndarray     # [H] int32 apsides per halo (exact, may be > K)
    ids: jnp.ndarray       # [H, K] event particle IDs
    angles: jnp.ndarray    # [H, K] angle at each apsis
    bulk_vel: jnp.ndarray  # [H, 3] region bulk velocity of this snapshot
    slots: jnp.ndarray | None = None  # [H, K] prev load slots (id order)
    #: full pre-compaction event plane (aligned xla step with
    #: ``emit_payload=True`` only): ``[H, P]`` uint32 angle words
    #: ``f32_bits(angle) | (apsis << 31)`` (position = column index) —
    #: or the ``(posw, ang15)`` pair past PAYLOAD_MAX_ROW.  Lets the
    #: host recover EVERY event exactly when ``count > K`` truncated
    #: the compacted lists (the tracker's event-capacity growth path),
    #: with no step re-run; decode angles as the f32 bits cast to f16
    #: (RNE — identical bits to the device's f16_bits_rne encode).
    payload: jnp.ndarray | tuple | None = None


def init_sorted_carry(
    n_halos: int,
    capacity: int,
    id_dtype=jnp.int32,
    angle_dtype=jnp.float32,
    pos_dtype=jnp.float32,
) -> SortedCarry:
    """All-invalid carry: every halo behaves as 'no progenitor yet'."""
    invalid = invalid_id_for(id_dtype)
    return SortedCarry(
        ids=jnp.full((n_halos, capacity), invalid, dtype=id_dtype),
        slot=jnp.broadcast_to(
            jnp.arange(capacity, dtype=jnp.int32), (n_halos, capacity)
        ),
        vrb=jnp.zeros((n_halos, capacity), dtype=jnp.uint8),
        rhat=jnp.zeros((3, n_halos, capacity), dtype=pos_dtype),
        angles=jnp.zeros((n_halos, capacity), dtype=angle_dtype),
    )


def presort_snapshot(batch, soa: bool = False):
    """Stage a :class:`SnapshotBatch` in ID-sorted row layout (host-side).

    Sorts each halo row ascending by particle ID (padding sentinels
    last, they are the dtype max) and records the original load-order
    slots in ``batch.slot``, for :func:`make_sorted_orbit_step`
    (the tracker's sorted engine stages rows this way).  Accepts
    ``[H, P]`` or stacked ``[S, H, P]`` batches; runs in NumPy at
    staging time.

    ``soa=True`` additionally stages ``pos``/``vel`` in structure-of-
    arrays ``[3, H, P]`` (stacked: ``[S, 3, H, P]``) layout for
    ``make_sorted_orbit_step(..., soa_batch=True)`` — the AoS->SoA
    transpose the step would otherwise pay per snapshot happens once
    here instead.
    """
    import numpy as np

    ids = np.asarray(batch.ids)
    order = np.argsort(ids, axis=-1, kind="stable").astype(np.int32)

    def take(x):
        return np.take_along_axis(np.asarray(x), order, axis=-1)

    def take3(x):
        out = np.take_along_axis(np.asarray(x), order[..., None], axis=-2)
        if soa:
            out = np.moveaxis(out, -1, out.ndim - 3)
        return out

    slot = order if batch.slot is None else take(batch.slot)
    return batch._replace(
        ids=take(ids),
        pos=take3(batch.pos),
        vel=take3(batch.vel),
        mass=None if batch.mass is None else take(batch.mass),
        slot=slot,
    )


def _vr_bits(vr: jnp.ndarray) -> jnp.ndarray:
    return (vr < 0).astype(jnp.uint8) | ((vr > 0).astype(jnp.uint8) << 1)


def _shift_right(x, fill):
    """Value at the left neighbor (index i-1) along the last axis."""
    return jnp.concatenate([jnp.full_like(x[:, :1], fill), x[:, :-1]], axis=1)


def _shift_left(x, fill):
    """Value at the right neighbor (index i+1) along the last axis."""
    return jnp.concatenate([x[:, 1:], jnp.full_like(x[:, :1], fill)], axis=1)


def make_sorted_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
    angle_dtype=jnp.float32,
    soa_batch: bool = False,
):
    """Build the sorted-carry per-snapshot step.

    Returns ``step(carry, snap) -> (carry, CompactEvents)`` — pure,
    static-shape, jit/scan/shard_map-ready.  ``snap`` is the same
    :class:`orbitanalysis_tpu.ops.apsis.SnapshotBatch` the general step
    takes, in any row order (``snap.slot``, when given, records each
    entry's load-order slot — :func:`presort_snapshot` stages rows
    ID-sorted this way; without it the row order is the load order).
    The join is one 2P variadic ``lax.sort`` of prev + cur; events come
    back in previous-snapshot load order, ``[H, K]`` wide.
    """
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    id_dt = jnp.dtype(id_dtype)
    # Single-key packing (id << 1 | side) requires ids < 2^31; guaranteed
    # for signed <=32-bit ids (sentinel is the dtype max).  See
    # ops/join.py for the aliasing argument.
    pack_key = (
        id_dt.itemsize * 8 <= 32 and jnp.issubdtype(id_dt, jnp.signedinteger)
    )
    K = int(event_capacity)

    def step(carry: SortedCarry, snap):
        h, p = snap.ids.shape
        valid_cur = snap.ids != invalid

        frame = region_frame(
            snap.pos,
            snap.vel,
            valid_cur,
            snap.center,
            mass=snap.mass,
            bulk_vel=snap.bulk_vel,
            box_size=box_size,
            hubble_drag=snap.hubble_drag,
            soa=soa_batch,
        )

        iota = jax.lax.broadcasted_iota(jnp.int32, (h, p), 1)
        cur_vrb = _vr_bits(frame.vrad)
        cur_slot = iota if snap.slot is None else snap.slot

        # slot and the 3 v_r sign/match bits share one i32 sort channel
        # (slot < 2^24; channel count is the sort-cost driver)
        prev_sv = carry.slot | (carry.vrb.astype(jnp.int32) << 24)
        cur_sv = cur_slot | (cur_vrb.astype(jnp.int32) << 24)

        def cat(a, b):
            return jnp.concatenate([a, b], axis=1)

        if pack_key:
            keys = cat(
                carry.ids.astype(jnp.uint32) << 1,
                (snap.ids.astype(jnp.uint32) << 1) | 1,
            )
            num_keys = 1
            head = (keys,)
        else:
            keys = cat(carry.ids, snap.ids)
            side = cat(
                jnp.zeros((h, p), jnp.uint8), jnp.ones((h, p), jnp.uint8)
            )
            num_keys = 2
            head = (keys, side)
        sorted_ops = jax.lax.sort(
            head
            + (
                cat(prev_sv, cur_sv),
                cat(carry.rhat[0], frame.rhat[0]),
                cat(carry.rhat[1], frame.rhat[1]),
                cat(carry.rhat[2], frame.rhat[2]),
                cat(carry.angles, jnp.zeros((h, p), angle_dtype)),
            ),
            dimension=-1,
            num_keys=num_keys,
        )
        if pack_key:
            k_s = sorted_ops[0]
            is_cur = (k_s & 1) == 1
            ids_s = (k_s >> 1).astype(id_dt)
            sv_s, rx_s, ry_s, rz_s, ang_s = sorted_ops[1:]
        else:
            ids_s, side_s = sorted_ops[0], sorted_ops[1]
            is_cur = side_s == 1
            sv_s, rx_s, ry_s, rz_s, ang_s = sorted_ops[2:]
        slot_s = sv_s & 0x00FFFFFF
        vrb_s = (sv_s >> 24).astype(jnp.uint8)

        # ---- detection in the merged domain (matched pairs adjacent,
        # prev first — exactly ops/apsis.py's compute()) ----
        valid_key = ids_s != invalid
        left_is_prev = ~_shift_right(is_cur, True)
        match_cur = (
            is_cur
            & left_is_prev
            & valid_key
            & (ids_s == _shift_right(ids_s, jnp.asarray(invalid, ids_s.dtype)))
        )
        vrb_l = _shift_right(vrb_s, jnp.uint8(0))
        rx_l = _shift_right(rx_s, 0.0)
        ry_l = _shift_right(ry_s, 0.0)
        rz_l = _shift_right(rz_s, 0.0)
        ang_l = _shift_right(ang_s, jnp.asarray(0, angle_dtype))

        cosang = jnp.clip(rx_l * rx_s + ry_l * ry_s + rz_l * rz_s, -1.0, 1.0)
        dtheta = jnp.where(match_cur, jnp.arccos(cosang), 0.0)
        if pericentric:
            flip = ((vrb_l & 1) > 0) & ((vrb_s & 2) > 0)
        else:
            flip = ((vrb_l & 2) > 0) & ((vrb_s & 1) > 0)
        apsis = match_cur & flip                      # at the cur position
        angle_acc = (ang_l + dtheta.astype(angle_dtype)).astype(angle_dtype)
        apsis_angle = jnp.where(apsis, angle_acc, 0).astype(angle_dtype)
        angle_new = jnp.where(
            apsis | ~match_cur, 0, angle_acc
        ).astype(angle_dtype)

        # route the event to its prev partner position (one slot left),
        # which holds the reference-layout slot number for event ordering
        apsis_prev = _shift_left(apsis, False)
        ev_angle_prev = _shift_left(apsis_angle, jnp.asarray(0, angle_dtype))
        count = jnp.sum(apsis, axis=-1, dtype=jnp.int32)

        # ---- one sort: next carry to the front (stable keeps ID
        # order), events next (in prev load-slot order), dead last
        key_b = jnp.where(
            is_cur,
            jnp.int32(0),
            jnp.where(apsis_prev, jnp.int32(1) + slot_s, jnp.int32(_DEAD_KEY)),
        )
        angle_b = jnp.where(is_cur, angle_new, ev_angle_prev)
        # bit2 of vrb: this cur entry matched (entered = valid & ~bit2)
        sv_b = slot_s | (
            (vrb_s | (match_cur.astype(jnp.uint8) << 2)).astype(jnp.int32)
            << 24
        )

        out = jax.lax.sort(
            (key_b, ids_s, sv_b, rx_s, ry_s, rz_s, angle_b),
            dimension=-1,
            num_keys=1,
        )
        _, ids_o, sv_o, rx_o, ry_o, rz_o, ang_o = out

        new_carry = SortedCarry(
            ids=ids_o[:, :p],
            slot=sv_o[:, :p] & 0x00FFFFFF,
            vrb=(sv_o[:, :p] >> 24).astype(jnp.uint8),
            rhat=jnp.stack([rx_o[:, :p], ry_o[:, :p], rz_o[:, :p]]),
            angles=ang_o[:, :p],
        )
        events = CompactEvents(
            count=count,
            ids=ids_o[:, p:p + K],
            angles=ang_o[:, p:p + K],
            bulk_vel=frame.bulk_vel,
        )
        return new_carry, events

    return step


class AlignedCarry(NamedTuple):
    """Carry of the carry-native aligned engine, stored in the packed
    channel formats the detect chain reads and writes — the step needs
    no decode/encode pass over the ``[H, P]`` planes around detection.

    ``key``: ``(pos << 1) | 1`` (the staged cur key of the last step);
    ``sv``: ``load_slot | FRESH?<<27 | vrb<<24`` (last step's staged
    ``csv``); ``rhat``: last snapshot's radial unit vectors;
    ``packed``: f32 angle accumulator in bits 0-30, match flag bit 31.
    """

    key: jnp.ndarray     # [H, P] uint32
    sv: jnp.ndarray      # [H, P] int32
    rhat: jnp.ndarray    # [3, H, P] float32
    packed: jnp.ndarray  # [H, P] uint32


def init_aligned_carry(n_halos: int, capacity: int,
                       pos_dtype=jnp.float32,
                       rhat_packed: bool = False) -> AlignedCarry:
    """All-invalid native carry (32-bit signed IDs; the int32-max
    sentinel's key is ``0xFFFFFFFF``).  ``rhat_packed=True`` stores the
    radial unit vectors octahedral-compressed (one uint32 plane instead
    of 3 f32: carry drops 24 -> 16 B/particle — the 1e8-per-chip
    memory diet; pair with ``make_aligned_native_step(...,
    rhat_packed=True)``).  Apsis counts are unaffected by construction:
    radial-velocity signs are recomputed from positions every step and
    never read the carried rhat, which feeds only the angle
    accumulator (~1e-4 rad quantization per step)."""
    invalid = invalid_id_for(jnp.int32)
    return AlignedCarry(
        key=jnp.full(
            (n_halos, capacity),
            (np.uint32(invalid) << np.uint32(1)) | np.uint32(1),
            dtype=jnp.uint32,
        ),
        sv=jnp.broadcast_to(
            jnp.arange(capacity, dtype=jnp.int32), (n_halos, capacity)
        ),
        rhat=(
            jnp.zeros((n_halos, capacity), dtype=jnp.uint32)
            if rhat_packed
            else jnp.zeros((3, n_halos, capacity), dtype=pos_dtype)
        ),
        packed=jnp.zeros((n_halos, capacity), dtype=jnp.uint32),
    )


def decode_aligned_carry(carry: AlignedCarry) -> SortedCarry:
    """Host-side NumPy unpack of the native carry into the
    :class:`SortedCarry` channel layout (ids / slot / vrb / angles) —
    for the rare host consumers: checkpointing, capacity growth,
    engine conversion."""
    key = np.asarray(carry.key)
    sv = np.asarray(carry.sv)
    packed = np.asarray(carry.packed)
    match = (packed >> 31).astype(np.uint8)
    return SortedCarry(
        ids=(key >> np.uint32(1)).astype(np.int32),
        slot=(sv & 0x00FFFFFF).astype(np.int32),
        vrb=((sv >> 24) & 3).astype(np.uint8) | (match << 2),
        rhat=np.asarray(carry.rhat),
        angles=(packed & np.uint32(0x7FFFFFFF)).view(np.float32),
    )


def encode_aligned_carry(c: SortedCarry) -> AlignedCarry:
    """Inverse of :func:`decode_aligned_carry` (host-side NumPy)."""
    ids = np.asarray(c.ids)
    vrb = np.asarray(c.vrb)
    angles = np.ascontiguousarray(c.angles, dtype=np.float32)
    return AlignedCarry(
        key=(ids.astype(np.uint32) << np.uint32(1)) | np.uint32(1),
        sv=(np.asarray(c.slot) & 0x00FFFFFF).astype(np.int32)
        | ((vrb & 3).astype(np.int32) << 24),
        rhat=np.asarray(c.rhat),
        packed=angles.view(np.uint32)
        | (((vrb >> 2) & 1).astype(np.uint32) << np.uint32(31)),
    )


def aligned_detect_math(carry: AlignedCarry, valid_cur, slot, frame,
                        pericentric: bool, invalid,
                        rhat_packed: bool = False):
    """The aligned engine's detect chain: positional keys, FRESH
    gating, sign-flip detection, angle accumulation and the packed
    carry encode — all elementwise over ``[H, P]`` planes.

    Returns ``(cur_key, cur_sv, apsis, angle_acc, packed, ang15,
    count, pos_iota)`` — everything :func:`make_aligned_native_step`
    needs around the event compaction.
    """
    from orbitanalysis_tpu.utils.numerics import oct_decode

    h, p = valid_cur.shape
    cur_vrb = _vr_bits(frame.vrad)
    pos_iota = jax.lax.broadcasted_iota(jnp.int32, (h, p), 1)
    inv_key = (jnp.uint32(invalid) << 1) | 1
    cur_key = jnp.where(
        valid_cur, (pos_iota.astype(jnp.uint32) << 1) | 1, inv_key
    )
    cur_sv = slot | (cur_vrb.astype(jnp.int32) << 24)
    fresh = (slot & (1 << 27)) != 0
    vrb_p = carry.sv >> 24  # sign bits 0-1 (bit 3 = stale FRESH)
    pang = jax.lax.bitcast_convert_type(
        carry.packed & jnp.uint32(0x7FFFFFFF), jnp.float32
    )
    prev_rhat = oct_decode(carry.rhat) if rhat_packed else carry.rhat
    cosang = jnp.clip(
        prev_rhat[0] * frame.rhat[0]
        + prev_rhat[1] * frame.rhat[1]
        + prev_rhat[2] * frame.rhat[2],
        -1.0, 1.0,
    )
    dtheta = jnp.where(valid_cur, acos_f32(cosang), 0.0)
    if pericentric:
        flip = ((vrb_p & 1) > 0) & ((cur_vrb & 2) > 0)
    else:
        flip = ((vrb_p & 2) > 0) & ((cur_vrb & 1) > 0)
    apsis = valid_cur & flip & ~fresh
    angle_acc = jnp.where(fresh, 0.0, pang + dtheta)
    packed = jax.lax.bitcast_convert_type(
        jnp.where(apsis | ~valid_cur, 0.0, angle_acc),
        jnp.uint32,
    ) | ((valid_cur & ~fresh).astype(jnp.uint32) << 31)
    # integer RNE f32->f16 bits, bit-identical to astype(float16) for
    # the non-negative finite angles here
    ang15 = f16_bits_rne(angle_acc)
    count = jnp.sum(apsis, axis=-1, dtype=jnp.int32)
    return (cur_key, cur_sv, apsis, angle_acc, packed, ang15, count,
            pos_iota)


def make_aligned_native_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
    angle_dtype=jnp.float32,
    soa_batch: bool = False,
    rhat_packed: bool = False,
    emit_payload: bool = False,
):
    """Carry-native stable-layout step — the flagship tracking path.

    Semantically identical to :func:`make_aligned_orbit_step` (same
    staged-snapshot contract, same :class:`CompactEvents` outputs), but
    the carry is an :class:`AlignedCarry` held in packed channel
    formats and the tenant-change (FRESH) flag is computed by the *host
    staging* (bit 27 of ``snap.slot``,
    :data:`orbitanalysis_tpu.engine.packing.FRESH_BIT`) instead of a
    device-side ID compare: the staged ``cur_key``/``cur_sv`` are the
    next carry's key/sv planes, the packed angle plane is stored as
    computed, and ``frame.rhat`` is stored as-is.

    Detection (sign flips, angle accumulation, carry packing) is plain
    elementwise XLA; the only non-elementwise piece is the event
    compaction (:mod:`orbitanalysis_tpu.ops.compact`).  The arccos is a
    fixed polynomial (:func:`orbitanalysis_tpu.utils.numerics.acos_f32`)
    so angles agree across backends.

    Requires snapshots staged by the stable-layout pipeline
    (``pack_snapshot_aligned`` / ``stage_batch_aligned``), whose
    ``slot`` channel carries the FRESH flags; ``snap.slot`` is
    mandatory here.  Replaces the reference's per-snapshot ``myin1d``
    join (``/root/reference/orbitanalysis/track_orbits.py:300-309``)
    with host-side integer bookkeeping exactly like
    :func:`make_aligned_orbit_step` — see there for the semantics
    citations.

    Events are positional: ``CompactEvents.ids`` holds stable-layout
    row positions (the host maps them through its staged tables), and
    angles are f16-exact.  ``emit_payload=True`` additionally returns
    the full pre-compaction event plane in ``CompactEvents.payload`` so
    a host consumer can recover every event exactly when a row's count
    exceeds ``event_capacity`` — the tracker's event-capacity growth
    path (the reference has no static event bound at all,
    ``track_orbits.py:199-217``).
    """
    from orbitanalysis_tpu.ops.compact import (
        PAYLOAD_MAX_ROW,
        compact_angle,
        compact_payload_pair,
        decode_payload,
    )
    from orbitanalysis_tpu.utils.numerics import oct_encode

    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    if jnp.dtype(angle_dtype) != jnp.float32:
        raise ValueError(
            "the aligned engine packs the match bit into the f32 angle "
            "sign bit; use angle_dtype=float32"
        )
    id_dt = jnp.dtype(id_dtype)
    if id_dt.itemsize != 4 or not jnp.issubdtype(id_dt, jnp.signedinteger):
        raise ValueError(
            "the aligned engine requires 32-bit signed particle IDs "
            "(packed uint32 keys)"
        )
    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    K = int(event_capacity)

    def step(carry: AlignedCarry, snap):
        if snap.slot is None:
            raise ValueError(
                "the carry-native aligned step needs stable-layout "
                "staging: snap.slot (with FRESH flags in bit 27) is "
                "mandatory — stage via pack_snapshot_aligned / "
                "stage_batch_aligned"
            )
        h, p = snap.ids.shape
        valid_cur = snap.ids != invalid

        frame = region_frame(
            snap.pos,
            snap.vel,
            valid_cur,
            snap.center,
            mass=snap.mass,
            bulk_vel=snap.bulk_vel,
            box_size=box_size,
            hubble_drag=snap.hubble_drag,
            soa=soa_batch,
        )
        (cur_key, cur_sv, apsis, angle_acc, packed, ang15, count,
         pos_iota) = aligned_detect_math(
            carry, valid_cur, snap.slot, frame, pericentric,
            invalid, rhat_packed=rhat_packed,
        )
        if p <= PAYLOAD_MAX_ROW:
            # angle-word plane: f32 angle bits + apsis flag in bit 31
            # (angles are non-negative); the payload word is built from
            # it inside the compaction's fused pass
            aw = jax.lax.bitcast_convert_type(
                angle_acc, jnp.uint32
            ) | (apsis.astype(jnp.uint32) << 31)
            full_payload = aw if emit_payload else None
            evpay, _ = compact_angle(aw, K)
            ev_pos, evang = decode_payload(evpay)
        else:
            # the last position's pos + 1 = 2**17 would wrap the single
            # payload word to zero: such rows take the two-word format
            posw = jnp.where(
                apsis, (pos_iota + 1).astype(jnp.uint32), jnp.uint32(0)
            )
            full_payload = (posw, ang15) if emit_payload else None
            evposw, ev_ang_bits, _ = compact_payload_pair(posw, ang15, K)
            ev_pos = evposw.astype(jnp.int32) - 1
            evang = jax.lax.bitcast_convert_type(
                ev_ang_bits.astype(jnp.uint16), jnp.float16,
            ).astype(angle_dtype)
        new_carry = AlignedCarry(
            key=cur_key, sv=cur_sv,
            rhat=(oct_encode(frame.rhat) if rhat_packed else frame.rhat),
            packed=packed,
        )
        kw = ev_pos.shape[1]
        ev_ok = jax.lax.broadcasted_iota(jnp.int32, (h, kw), 1) < (
            count[:, None])
        return new_carry, CompactEvents(
            count=count,
            ids=jnp.where(ev_ok, ev_pos, jnp.int32(invalid)),
            angles=jnp.where(ev_ok, evang, 0.0),
            bulk_vel=frame.bulk_vel,
            slots=None,
            payload=full_payload,
        )

    return step


def make_aligned_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=jnp.int32,
    angle_dtype=jnp.float32,
    soa_batch: bool = False,
):
    """Stable-layout per-snapshot step over a :class:`SortedCarry` —
    the select-staged form of the aligned engine, kept as the in-repo
    oracle for step-level parity tests of
    :func:`make_aligned_native_step`.

    The device never needs ID-*sorted* rows — it needs rows whose
    layout is *stable across snapshots*.  The host staging assigns each
    particle a persistent position
    (:class:`orbitanalysis_tpu.engine.packing.StableLayout`: a matched
    particle keeps its position, an entrant reuses a departure's hole),
    so prev carry and staged cur are aligned element-wise and detection
    is elementwise.  The O(N log N) work the reference's ``myin1d``
    join does per snapshot
    (``/root/reference/orbitanalysis/track_orbits.py:300-309``) becomes
    integer bookkeeping on the host.

    Positions whose tenant changed between snapshots (entrant, or a
    reused hole) are detected here by an ID compare against the carry:
    the stale prev state is suppressed and the angle accumulation
    restarts at exactly 0 — an entrant starts from zero, the
    reference's semantics for newly tracked particles
    (``/root/reference/orbitanalysis/track_orbits.py:337-344``).

    ``snap`` must be staged in the stable layout (``snap.slot`` maps
    positions back to the row's load order, as produced by
    ``pack_snapshot_aligned``).  Events come back compacted in
    position order with their previous load slots alongside (the host
    restores reference order by one [H, K] sort).
    """
    from orbitanalysis_tpu.ops.compact import compact_rows

    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    if jnp.dtype(angle_dtype) != jnp.float32:
        raise ValueError(
            "the aligned engine packs the match bit into the f32 angle "
            "sign bit; use angle_dtype=float32"
        )
    id_dt = jnp.dtype(id_dtype)
    if id_dt.itemsize != 4 or not jnp.issubdtype(id_dt, jnp.signedinteger):
        raise ValueError(
            "the aligned engine requires 32-bit signed particle IDs "
            "(packed uint32 keys)"
        )
    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    K = int(event_capacity)

    def step(carry: SortedCarry, snap):
        h, p = snap.ids.shape
        valid = snap.ids != invalid

        frame = region_frame(
            snap.pos,
            snap.vel,
            valid,
            snap.center,
            mass=snap.mass,
            bulk_vel=snap.bulk_vel,
            box_size=box_size,
            hubble_drag=snap.hubble_drag,
            soa=soa_batch,
        )

        iota = jax.lax.broadcasted_iota(jnp.int32, (h, p), 1)
        cur_vrb = _vr_bits(frame.vrad)
        cur_slot = iota if snap.slot is None else snap.slot
        cur_sv = cur_slot | (cur_vrb.astype(jnp.int32) << 24)

        # continuing tenant at this position <=> carry state applies
        same = snap.ids == carry.ids
        vrb_p = jnp.where(same, carry.vrb & 3, jnp.uint8(0))
        cosang = jnp.clip(
            carry.rhat[0] * frame.rhat[0]
            + carry.rhat[1] * frame.rhat[1]
            + carry.rhat[2] * frame.rhat[2],
            -1.0, 1.0,
        )
        dtheta = jnp.where(valid, acos_f32(cosang), 0.0)
        if pericentric:
            flip = ((vrb_p & 1) > 0) & ((cur_vrb & 2) > 0)
        else:
            flip = ((vrb_p & 2) > 0) & ((cur_vrb & 1) > 0)
        apsis = valid & flip & same
        angle_acc = jnp.where(same, carry.angles + dtheta, 0.0)
        apsis_angle = jnp.where(apsis, angle_acc, 0.0)
        angle_new = jnp.where(apsis | ~valid, 0.0, angle_acc)
        match = (valid & same).astype(jnp.uint8)

        (ev_ids, ev_slot, ev_ang), count = compact_rows(
            apsis, (snap.ids, carry.slot, apsis_angle), min(K, p))
        ev_ok = jax.lax.broadcasted_iota(
            jnp.int32, ev_ids.shape, 1) < count[:, None]
        new_carry = SortedCarry(
            ids=snap.ids,
            slot=cur_sv & 0x00FFFFFF,
            vrb=(cur_sv >> 24).astype(jnp.uint8) | (match << 2),
            rhat=frame.rhat,
            angles=angle_new,
        )
        return new_carry, CompactEvents(
            count=count,
            ids=jnp.where(ev_ok, ev_ids, jnp.asarray(invalid, id_dt)),
            angles=ev_ang,
            bulk_vel=frame.bulk_vel,
            slots=jnp.where(ev_ok, ev_slot, -1),
        )

    return step
