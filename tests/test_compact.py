"""Stable per-row compaction (ops/compact.py) vs NumPy boolean indexing.

Contracts: ascending position order, zero fill past the count, TRUE
counts past K (the tracker's overflow recovery reads them), output
width min(K, P), and the single-word / two-word payload split at
PAYLOAD_MAX_ROW."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from orbitanalysis_tpu.ops.compact import (
    PAYLOAD_MAX_ROW,
    angle_payload,
    compact_angle,
    compact_payload,
    compact_payload_pair,
    compact_rows,
)


def _check_rows(got, sel, vals, k):
    for r in range(sel.shape[0]):
        want = vals[r, sel[r]]
        n = min(len(want), k)
        np.testing.assert_array_equal(got[r, :n], want[:n])
        assert not got[r, n:].any(), "slots past the count must be zero"


def _payload(rng, h, p, density):
    sel = rng.random((h, p)) < density
    pos = np.broadcast_to(np.arange(p, dtype=np.uint32), (h, p))
    ang = rng.integers(0, 1 << 15, size=(h, p), dtype=np.int64).astype(
        np.uint32
    )
    return sel, np.where(sel, ((pos + 1) << 15) | ang, np.uint32(0))


@pytest.mark.parametrize("h,n,density_a,density_b", [
    (3, 512, 0.5, 0.02),
    (2, 256, 1.0, 0.0),
    (1, 1024, 0.03, 0.7),
])
def test_compact_two_groups(rng, h, n, density_a, density_b):
    """Two selections over the same channels, one full-width and one
    capped at 128: each front-packs its entries in position order."""
    sel_a = rng.random((h, n)) < density_a
    sel_b = rng.random((h, n)) < density_b
    vals = rng.integers(0, 2**31, size=(h, n), dtype=np.int64).astype(
        np.int32
    )
    fvals = rng.normal(size=(h, n)).astype(np.float32)

    (a_i, a_f), cnt_a = compact_rows(
        jnp.asarray(sel_a), (jnp.asarray(vals), jnp.asarray(fvals)), n)
    (b_i,), cnt_b = compact_rows(jnp.asarray(sel_b), (jnp.asarray(vals),),
                                 128)
    a_i, a_f, b_i = map(np.asarray, (a_i, a_f, b_i))
    assert b_i.shape == (h, 128)
    _check_rows(a_i, sel_a, vals, n)
    _check_rows(a_f, sel_a, fvals, n)
    _check_rows(b_i, sel_b, vals, 128)
    np.testing.assert_array_equal(np.asarray(cnt_a), sel_a.sum(1))
    np.testing.assert_array_equal(np.asarray(cnt_b), sel_b.sum(1))


def test_compact_adversarial_gaps(rng):
    """Alternating runs, all-dead prefixes, single survivors at the
    end, survivors at both row ends."""
    n = 512
    r0 = np.zeros(n, bool); r0[-1] = True
    r1 = np.zeros(n, bool); r1[::2] = True
    r2 = np.ones(n, bool); r2[:300] = False
    r3 = np.zeros(n, bool); r3[[0, 255, 256, 511]] = True
    rows = np.stack([r0, r1, r2, r3])
    vals = np.arange(1, 4 * n + 1, dtype=np.int32).reshape(4, n)
    (got,), cnt = compact_rows(jnp.asarray(rows), (jnp.asarray(vals),), n)
    _check_rows(np.asarray(got), rows, vals, n)
    np.testing.assert_array_equal(np.asarray(cnt), rows.sum(1))


@pytest.mark.parametrize("h,p,density,k", [
    (4, 512, 0.1, 512),
    (2, 1024, 0.9, 256),
    (3, 256, 0.0, 128),
])
def test_compact_payload_front_packs(rng, h, p, density, k):
    """Single-word payload compaction: flagged entries (payload >=
    2^15) land front-packed in position order; selection derives from
    the payload itself — no flag stream."""
    sel, payload = _payload(rng, h, p, density)
    got, cnt = compact_payload(jnp.asarray(payload), k)
    got = np.asarray(got)
    assert got.shape == (h, min(k, p))
    _check_rows(got, sel, payload, k)
    np.testing.assert_array_equal(np.asarray(cnt), sel.sum(1))


def test_compact_payload_edges():
    """Boundary payloads: event at position 0 (smallest key 1<<15),
    event at the last position, max angle bits, fully dense row."""
    p = 256
    pay = np.zeros((3, p), np.uint32)
    pay[0, 0] = (1 << 15) | 0x7FFF        # pos 0, max angle
    pay[0, p - 1] = (np.uint32(p) << 15)  # last position, angle 0
    pay[1] = ((np.arange(p, dtype=np.uint32) + 1) << 15) | 1  # dense
    got, cnt = compact_payload(jnp.asarray(pay), p)
    got = np.asarray(got)
    np.testing.assert_array_equal(got[0, :2], [pay[0, 0], pay[0, p - 1]])
    assert not got[0, 2:].any()
    np.testing.assert_array_equal(got[1], pay[1])
    assert not got[2].any()
    np.testing.assert_array_equal(np.asarray(cnt), [2, p, 0])


@pytest.mark.parametrize("h,p,density,k", [
    (2, 2048, 0.015, 256),   # typical sparse
    (1, 2048, 0.0, 128),     # empty
    (2, 2048, 0.5, 2048),    # dense
    (3, 4096, 0.05, 512),    # mixed
])
def test_compact_angle_matches_payload_form(rng, h, p, density, k):
    """The aligned engine's angle-word path (payload built inside the
    compaction's pass) equals compacting the explicitly built payload
    words, and the payload words carry the f16 RNE angle bits."""
    sel = rng.random((h, p)) < density
    ang = rng.uniform(0, 7.0, (h, p)).astype(np.float32)
    aw = ang.view(np.uint32) | (sel.astype(np.uint32) << 31)
    got, cnt = compact_angle(jnp.asarray(aw), k)
    _, payload = jax.jit(angle_payload)(jnp.asarray(aw))
    want, wcnt = compact_payload(payload, k)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(wcnt))
    payload = np.asarray(payload)
    np.testing.assert_array_equal(
        payload[sel] & 0x7FFF, ang[sel].astype(np.float16).view(np.uint16))
    np.testing.assert_array_equal(
        (payload[sel] >> 15) - 1, np.nonzero(sel)[1])


def test_compact_payload_clustered_events():
    """Events clustered in one stretch of a row (plus a sparse row)
    come out exact."""
    p = 2048
    pay = np.zeros((2, p), np.uint32)
    pay[0, 300:340] = ((np.arange(300, 340, dtype=np.uint32) + 1) << 15) | 7
    pay[1, ::512] = ((np.arange(0, p, 512, dtype=np.uint32) + 1) << 15) | 3
    got, cnt = compact_payload(jnp.asarray(pay), 256)
    got = np.asarray(got)
    np.testing.assert_array_equal(got[0, :40], pay[0, 300:340])
    np.testing.assert_array_equal(got[1, :4], pay[1, ::512])
    np.testing.assert_array_equal(np.asarray(cnt), [40, 4])


def test_compact_payload_rejects_overwide_rows():
    """The single-word encoding holds pos + 1 <= 2**17 - 1; a 131072-wide
    row would wrap the LAST position's payload to zero and silently drop
    its event — such rows must be rejected, not mis-compacted."""
    assert PAYLOAD_MAX_ROW == (1 << 17) - 1
    pay = jnp.zeros((1, 1 << 17), jnp.uint32)
    with pytest.raises(ValueError, match="compact_payload_pair"):
        compact_payload(pay, 128)
    with pytest.raises(ValueError, match="compact_payload_pair"):
        compact_angle(pay, 128)


@pytest.mark.parametrize("h,p,density,k", [
    (4, 512, 0.1, 512),
    (2, 1024, 0.9, 256),
    (3, 256, 0.0, 128),
])
def test_compact_payload_pair_front_packs(rng, h, p, density, k):
    """Two-word positional compaction: selection derives from the
    position word (pos + 1, 0 = no event); the angle word rides along."""
    sel = rng.random((h, p)) < density
    pos = np.broadcast_to(np.arange(p, dtype=np.uint32), (h, p))
    ang = rng.integers(0, 1 << 15, size=(h, p), dtype=np.int64).astype(
        np.uint32
    )
    posw = np.where(sel, pos + 1, np.uint32(0))
    angw = np.where(sel, ang, np.uint32(0))
    got_pos, got_ang, cnt = compact_payload_pair(
        jnp.asarray(posw), jnp.asarray(angw), k
    )
    _check_rows(np.asarray(got_pos), sel, posw, k)
    _check_rows(np.asarray(got_ang), sel, angw, k)
    np.testing.assert_array_equal(np.asarray(cnt), sel.sum(1))


def test_compact_payload_pair_last_position_131072():
    """An event at row position 131071 of a 131072-wide row (pos + 1 =
    2**17, unrepresentable in the single-word encoding) survives the
    two-word form."""
    p = 1 << 17
    posw = np.zeros((1, p), np.uint32)
    angw = np.zeros((1, p), np.uint32)
    posw[0, p - 1] = p          # pos + 1 = 131072
    angw[0, p - 1] = 0x7ABC
    posw[0, 7] = 8
    angw[0, 7] = 3
    got_pos, got_ang, cnt = compact_payload_pair(
        jnp.asarray(posw), jnp.asarray(angw), 128
    )
    np.testing.assert_array_equal(np.asarray(got_pos)[0, :2], [8, p])
    np.testing.assert_array_equal(np.asarray(got_ang)[0, :2], [3, 0x7ABC])
    assert int(np.asarray(cnt)[0]) == 2


def test_compact_empty_rows_zero_filled(rng):
    """Rows without any flagged entry come out all zero with count 0,
    next to rows that do have events."""
    sel = np.zeros((3, 384), bool)
    sel[1, [5, 200]] = True
    vals = rng.integers(1, 1000, size=(3, 384)).astype(np.int32)
    (got,), cnt = compact_rows(jnp.asarray(sel), (jnp.asarray(vals),), 64)
    got = np.asarray(got)
    assert not got[0].any() and not got[2].any()
    np.testing.assert_array_equal(got[1, :2], vals[1, [5, 200]])
    np.testing.assert_array_equal(np.asarray(cnt), [0, 2, 0])


def test_compact_capacity_above_row_length(rng):
    """K > P clamps the output width to P (a row cannot hold more than
    P events) and keeps every event."""
    sel, payload = _payload(rng, 2, 256, 0.6)
    got, cnt = compact_payload(jnp.asarray(payload), 1000)
    got = np.asarray(got)
    assert got.shape == (2, 256)
    _check_rows(got, sel, payload, 256)
    np.testing.assert_array_equal(np.asarray(cnt), sel.sum(1))


def test_compact_overflow_counts_exceed_capacity(rng):
    """More events than K: the first K (in position order) are kept and
    the count stays the TRUE number of events — the signal the
    tracker's lossless overflow recovery reads."""
    sel, payload = _payload(rng, 3, 1024, 0.4)
    k = 64
    got, cnt = compact_payload(jnp.asarray(payload), k)
    got, cnt = np.asarray(got), np.asarray(cnt)
    assert got.shape == (3, k)
    np.testing.assert_array_equal(cnt, sel.sum(1))
    assert (cnt > k).all()
    for r in range(3):
        np.testing.assert_array_equal(got[r], payload[r, sel[r]][:k])
