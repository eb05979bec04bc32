"""Stable per-row stream compaction in plain XLA.

Every event-extraction path (the aligned step and scan, the label
step) ends in the same operation: for each row of an ``[H, P]`` plane,
move the flagged entries to the front, in ascending position order,
into an ``[H, K]`` buffer.  Here that is a per-row inclusive ``cumsum``
of the flags (each flagged entry's rank) followed by one scatter with
``mode="drop"``: ranks ``>= K`` fall off the end, and unflagged entries
are sent to distinct out-of-range columns so the scatter's indices stay
unique.  Both are native on the GPU and XLA fuses the payload encode
into the scatter's operands.

Contracts shared by every function here:

- output slots ``[count, K)`` are zero;
- ``count`` is the TRUE number of flagged entries per row, also when
  it exceeds ``K`` (``count > K`` is the overflow signal — the tracker
  then recovers every event from the full pre-compaction plane and
  grows ``K``, see ``engine/tracker.py``);
- output width is ``min(K, P)`` (a row cannot hold more than ``P``
  events).

Positional payload words (the aligned and label engines' event
format): ``((pos + 1) << 15) | f16_bits(angle)`` — angles are
non-negative, so their f16 encoding needs 15 bits, and the 17 bits
above hold ``pos + 1 <= 2**17 - 1``; zero means "no event".  Rows wider
than :data:`PAYLOAD_MAX_ROW` use the two-word
:func:`compact_payload_pair`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from orbitanalysis_tpu.utils.numerics import f16_bits_rne

#: Widest row the single-word positional payload supports: the 17 bits
#: above the f16 angle hold ``pos + 1 <= 2**17 - 1``, i.e. positions up
#: to 131070.  A 131072-wide row's LAST position would wrap
#: ``(2**17) << 15`` to zero and silently drop the event — rows that
#: wide must go through :func:`compact_payload_pair`.
PAYLOAD_MAX_ROW = (1 << 17) - 1


def compact_rows(sel, chans, k: int):
    """Front-pack ``chans`` entries where ``sel`` is set, per row.

    ``sel``: ``[H, P]`` bool (or 0/1); ``chans``: tuple of ``[H, P]``
    arrays.  Returns ``(outs, count)``: ``outs`` a tuple of ``[H,
    min(k, P)]`` arrays with the selected entries in ascending position
    order and zeros after them, ``count`` ``[H]`` int32 the exact number
    of selected entries per row (may exceed ``k``).
    """
    h, p = sel.shape
    kw = min(int(k), p)
    sel = sel.astype(bool)
    rank = jnp.cumsum(sel, axis=1, dtype=jnp.int32)   # inclusive
    col = jax.lax.broadcasted_iota(jnp.int32, (h, p), 1)
    # unselected entries go to distinct columns past the end: every
    # index is unique, and everything >= kw is dropped
    dest = jnp.where(sel, rank - 1, kw + col)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, p), 0)
    outs = tuple(
        jnp.zeros((h, kw), c.dtype).at[row, dest].set(
            c, mode="drop", unique_indices=True)
        for c in chans
    )
    return outs, rank[:, -1]


def _check_single_word(p: int):
    if p > PAYLOAD_MAX_ROW:
        raise ValueError(
            f"single-word positional payloads address at most "
            f"{PAYLOAD_MAX_ROW} row positions (got row length {p}); "
            "use compact_payload_pair"
        )


def compact_payload(payload, k: int):
    """Single-word positional event compaction: entries with ``payload
    >= 2**15`` (any event, since ``pos + 1 >= 1``) front-packed per row.
    Returns ``(events [H, min(k, P)] uint32, count [H])``."""
    _check_single_word(payload.shape[1])
    (out,), count = compact_rows(
        payload >= jnp.uint32(1 << 15), (payload,), k)
    return out, count


def angle_payload(aw):
    """Positional payload words from an angle-word plane ``aw =
    f32_bits(angle) | (apsis << 31)`` (position = column index)."""
    h, p = aw.shape
    sel = (aw >> 31) != 0
    ang = jax.lax.bitcast_convert_type(
        aw & jnp.uint32(0x7FFFFFFF), jnp.float32)
    ang15 = f16_bits_rne(ang) & jnp.uint32(0x7FFF)
    pos1 = (jax.lax.broadcasted_iota(jnp.int32, (h, p), 1) + 1).astype(
        jnp.uint32)
    return sel, jnp.where(sel, (pos1 << 15) | ang15, jnp.uint32(0))


def compact_angle(aw, k: int):
    """:func:`compact_payload` with the payload built from the
    angle-word plane (:func:`angle_payload`) — the aligned engine's
    whole extract phase in one fused pass."""
    _check_single_word(aw.shape[1])
    sel, payload = angle_payload(aw)
    (out,), count = compact_rows(sel, (payload,), k)
    return out, count


def compact_payload_pair(posw, angw, k: int):
    """Two-word positional compaction for rows wider than
    :data:`PAYLOAD_MAX_ROW`: ``posw`` holds ``pos + 1`` where an event
    fired and 0 elsewhere, ``angw`` the angle bits alongside.  Returns
    ``(ev_pos_word, ev_ang_word, count)``."""
    (ev_pos, ev_ang), count = compact_rows(posw != 0, (posw, angw), k)
    return ev_pos, ev_ang, count


def decode_payload(evpay):
    """Split compacted payload words into ``(positions int32, f16-exact
    angles float32)``; empty slots decode to position -1."""
    pos = (evpay >> 15).astype(jnp.int32) - 1
    ang = jax.lax.bitcast_convert_type(
        (evpay & jnp.uint32(0x7FFF)).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    return pos, ang
