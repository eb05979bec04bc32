"""Sorted-carry step vs the general step: identical compact events.

The sorted-carry variant (ops/sorted_step.py) must produce exactly the
same compact event stream (same IDs, same order, same counts, angles to
float tolerance) as the general step's event-compaction path for every
membership pattern, while keeping its carry sorted by ID.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu.ops.apsis import (
    SnapshotBatch,
    init_carry,
    make_orbit_step,
)
from orbitanalysis_tpu.ops.sorted_step import (
    init_sorted_carry,
    make_sorted_orbit_step,
)
from orbitanalysis_tpu.utils import INVALID_ID, round_up

from test_step import _pack
from orbitanalysis_tpu.models.synthetic import churn_snapshots


def _ev_triplets(count, ids, angles):
    """Per-halo (count, ids[:count], angles[:count]) lists."""
    count = np.asarray(count)
    ids = np.asarray(ids)
    angles = np.asarray(angles)
    out = []
    for h in range(len(count)):
        c = int(count[h])
        out.append((c, ids[h, :c].tolist(), angles[h, :c]))
    return out


def _run_pair(snaps, n_halos, cap, box, mode, K, id_dtype=jnp.int32,
              presorted=False):
    from orbitanalysis_tpu.ops.sorted_step import presort_snapshot

    step_g = jax.jit(
        make_orbit_step(mode=mode, box_size=box, event_capacity=K,
                        id_dtype=id_dtype)
    )
    step_s = jax.jit(
        make_sorted_orbit_step(K, mode=mode, box_size=box,
                               id_dtype=id_dtype)
    )
    carry_g = init_carry(n_halos, cap, id_dtype=id_dtype)
    carry_s = init_sorted_carry(n_halos, cap, id_dtype=id_dtype)

    for s, snap in enumerate(snaps):
        ids, pos, vel, mass, center = _pack(snap, n_halos, cap)
        if jnp.dtype(id_dtype) != jnp.int32:
            inval = np.iinfo(np.dtype(id_dtype)).max
            ids64 = ids.astype(np.dtype(id_dtype))
            ids64[ids == INVALID_ID] = inval
            ids = ids64
        batch = SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=center, mass=mass,
            bulk_vel=None, hubble_drag=0.0,
        )
        carry_g, ev_g = step_g(carry_g, batch)
        carry_s, ev_s = step_s(
            carry_s, presort_snapshot(batch) if presorted else batch)

        got = _ev_triplets(ev_s.count, ev_s.ids, ev_s.angles)
        exp = _ev_triplets(ev_g.ev_count, ev_g.ev_ids, ev_g.ev_angles)
        for h, ((cg, ig, ag), (cs, is_, as_)) in enumerate(zip(exp, got)):
            assert cg == cs, (s, h)
            assert ig == is_, (s, h)
            assert np.allclose(ag, as_, atol=1e-4), (s, h)
        np.testing.assert_allclose(
            np.asarray(ev_s.bulk_vel), np.asarray(ev_g.bulk_vel),
            atol=1e-5,
        )

        # carry invariants: IDs ascending (sentinels last), and the
        # (id, angle) multiset matches the general carry's
        cs_ids = np.asarray(carry_s.ids)
        assert np.all(np.diff(cs_ids.astype(np.int64), axis=-1) >= 0)
        cg_ids = np.asarray(carry_g.ids)
        for h in range(n_halos):
            order_g = np.argsort(cg_ids[h], kind="stable")
            np.testing.assert_array_equal(cs_ids[h], cg_ids[h][order_g])
            np.testing.assert_allclose(
                np.asarray(carry_s.angles)[h],
                np.asarray(carry_g.angles)[h][order_g],
                atol=1e-4,
            )


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
def test_sorted_step_matches_general_on_churn(mode, presorted):
    """Load-order rows and ID-sorted staged rows (the tracker's sorted
    engine staging) both give the general step's events and carry."""
    n_halos, n_part, n_snap = 3, 150, 8
    box = 60.0
    snaps, _ = churn_snapshots(n_halos, n_part, n_snap, box_size=box, seed=3)
    cap = round_up(n_part)
    _run_pair(snaps, n_halos, cap, box, mode, K=cap, presorted=presorted)


@pytest.mark.slow
def test_sorted_step_soa_staging_matches_aos():
    """SoA-staged batches (presort_snapshot(soa=True) + soa_batch=True)
    give identical events and carry to AoS staging."""
    from orbitanalysis_tpu.ops.sorted_step import presort_snapshot

    n_halos, n_part, n_snap = 3, 140, 6
    box = 60.0
    snaps, _ = churn_snapshots(n_halos, n_part, n_snap, box_size=box,
                               seed=13)
    cap = round_up(n_part)
    K = cap
    step_a = jax.jit(make_sorted_orbit_step(
        K, mode="pericentric", box_size=box))
    step_s = jax.jit(make_sorted_orbit_step(
        K, mode="pericentric", box_size=box, soa_batch=True))
    carry_a = init_sorted_carry(n_halos, cap)
    carry_b = init_sorted_carry(n_halos, cap)
    for snap in snaps:
        ids, pos, vel, mass, center = _pack(snap, n_halos, cap)
        batch = SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=center, mass=mass,
            bulk_vel=None, hubble_drag=0.0,
        )
        carry_a, ev_a = step_a(carry_a, presort_snapshot(batch))
        staged = presort_snapshot(batch, soa=True)
        assert staged.pos.shape == (3, n_halos, cap)
        carry_b, ev_b = step_s(carry_b, staged)
        np.testing.assert_array_equal(
            np.asarray(ev_a.count), np.asarray(ev_b.count))
        np.testing.assert_array_equal(
            np.asarray(ev_a.ids), np.asarray(ev_b.ids))
        np.testing.assert_allclose(
            np.asarray(ev_a.angles), np.asarray(ev_b.angles), atol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(carry_a.ids), np.asarray(carry_b.ids))


@pytest.mark.parametrize("soa", [False, True])
def test_sorted_step_presorted_staging(soa):
    """ID-sorted staged rows + slot channel (AoS or SoA staging) give
    the identical event stream (reference load order) as load-order
    rows."""
    from orbitanalysis_tpu.ops.sorted_step import presort_snapshot

    n_halos, n_part, n_snap = 3, 150, 8
    box = 60.0
    snaps, _ = churn_snapshots(n_halos, n_part, n_snap, box_size=box, seed=7)
    cap = round_up(n_part)
    K = cap

    step_g = jax.jit(
        make_orbit_step(mode="pericentric", box_size=box, event_capacity=K)
    )
    step_s = jax.jit(
        make_sorted_orbit_step(K, mode="pericentric", box_size=box,
                               soa_batch=soa)
    )
    carry_g = init_carry(n_halos, cap)
    carry_s = init_sorted_carry(n_halos, cap)
    for s, snap in enumerate(snaps):
        ids, pos, vel, mass, center = _pack(snap, n_halos, cap)
        batch = SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=center, mass=mass,
            bulk_vel=None, hubble_drag=0.0,
        )
        carry_g, ev_g = step_g(carry_g, batch)
        staged = presort_snapshot(batch, soa=soa)
        assert np.all(np.diff(staged.ids.astype(np.int64), axis=-1) >= 0)
        carry_s, ev_s = step_s(carry_s, staged)
        got = _ev_triplets(ev_s.count, ev_s.ids, ev_s.angles)
        exp = _ev_triplets(ev_g.ev_count, ev_g.ev_ids, ev_g.ev_angles)
        for h, ((cg, ig, ag), (cs, is_, as_)) in enumerate(zip(exp, got)):
            assert cg == cs, (s, h)
            assert ig == is_, (s, h)
            assert np.allclose(ag, as_, atol=1e-4), (s, h)


def test_sorted_step_int64_ids():
    n_halos, n_part, n_snap = 2, 90, 6
    box = 40.0
    snaps, _ = churn_snapshots(n_halos, n_part, n_snap, box_size=box, seed=9)
    cap = round_up(n_part)
    with jax.enable_x64(True):
        _run_pair(snaps, n_halos, cap, box, "pericentric", K=cap,
                  id_dtype=jnp.int64)


@pytest.mark.parametrize("seed", range(4))
def test_sorted_step_fuzz(seed):
    rng = np.random.default_rng(3000 + seed)
    n_halos = int(rng.integers(1, 5))
    cap = 128 * int(rng.integers(1, 3))
    box = float(rng.uniform(20, 200)) if rng.random() < 0.7 else None
    mode = "pericentric" if rng.random() < 0.5 else "apocentric"
    n_snap = int(rng.integers(3, 7))

    pools = [
        np.arange(h * 10**6, h * 10**6 + int(rng.integers(1, cap)))
        for h in range(n_halos)
    ]
    centers = rng.uniform(0, box or 100.0, size=(n_halos, 3))
    snaps = []
    for _ in range(n_snap):
        snap = {}
        for h in range(n_halos):
            member = rng.random(len(pools[h])) < rng.uniform(0.2, 1.0)
            ids_h = pools[h][member]
            pos = centers[h] + rng.normal(scale=3.0, size=(len(ids_h), 3))
            if box is not None:
                pos = np.mod(pos, box)
            snap[h] = dict(
                ids=ids_h,
                pos=pos,
                vel=rng.normal(size=(len(ids_h), 3)),
                mass=rng.uniform(0.5, 2.0, len(ids_h)),
                center=centers[h],
            )
        snaps.append(snap)
    _run_pair(snaps, n_halos, cap, box, mode, K=cap)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
def test_sorted_step_static_membership_fast_path(mode):
    """Fixed membership (ids identical step-to-step) with ID-sorted
    staging — events and carry must match the general step exactly,
    also across a churn snapshot mid-sequence."""
    from orbitanalysis_tpu.ops.sorted_step import presort_snapshot

    rng = np.random.default_rng(77)
    n_halos, n_part, n_snap = 3, 140, 7
    box = 60.0
    cap = round_up(n_part)
    K = cap
    centers = rng.uniform(0, box, size=(n_halos, 3))
    pools = [np.arange(h * 10**6, h * 10**6 + n_part) for h in range(n_halos)]

    snaps = []
    for s in range(n_snap):
        snap = {}
        for h in range(n_halos):
            if s == 4:  # membership churn only at snapshot 4
                member = rng.random(n_part) < 0.7
            else:
                member = np.ones(n_part, bool)
            ids_h = pools[h][member]
            order = rng.permutation(len(ids_h))  # shuffled load order
            snap[h] = dict(
                ids=ids_h[order],
                pos=np.mod(
                    centers[h]
                    + rng.normal(scale=3.0, size=(len(ids_h), 3)),
                    box,
                )[order],
                vel=rng.normal(size=(len(ids_h), 3)),
                mass=rng.uniform(0.5, 2.0, len(ids_h)),
                center=centers[h],
            )
        snaps.append(snap)

    step_g = jax.jit(
        make_orbit_step(mode=mode, box_size=box, event_capacity=K)
    )
    step_s = jax.jit(
        make_sorted_orbit_step(K, mode=mode, box_size=box)
    )
    carry_g = init_carry(n_halos, cap)
    carry_s = init_sorted_carry(n_halos, cap)
    for s, snap in enumerate(snaps):
        ids, pos, vel, mass, center = _pack(snap, n_halos, cap)
        batch = SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=center, mass=mass,
            bulk_vel=None, hubble_drag=0.0,
        )
        carry_g, ev_g = step_g(carry_g, batch)
        carry_s, ev_s = step_s(carry_s, presort_snapshot(batch))
        got = _ev_triplets(ev_s.count, ev_s.ids, ev_s.angles)
        exp = _ev_triplets(ev_g.ev_count, ev_g.ev_ids, ev_g.ev_angles)
        for h, ((cg, ig, ag), (cs, is_, as_)) in enumerate(zip(exp, got)):
            assert cg == cs, (s, h)
            assert ig == is_, (s, h)
            assert np.allclose(ag, as_, atol=1e-4), (s, h)
        # carry parity
        cs_ids = np.asarray(carry_s.ids)
        cg_ids = np.asarray(carry_g.ids)
        for h in range(n_halos):
            order_g = np.argsort(cg_ids[h], kind="stable")
            np.testing.assert_array_equal(cs_ids[h], cg_ids[h][order_g])
            np.testing.assert_allclose(
                np.asarray(carry_s.angles)[h],
                np.asarray(carry_g.angles)[h][order_g],
                atol=1e-4,
            )


def test_sorted_step_scan_compatible():
    """The sorted step must run under lax.scan with stacked snapshots."""
    from orbitanalysis_tpu.engine.scan import _with_drag_axis, stack_batches

    n_halos, n_part, n_snap = 2, 100, 6
    box = 50.0
    snaps, _ = churn_snapshots(n_halos, n_part, n_snap, box_size=box, seed=5)
    cap = round_up(n_part)
    K = 128
    batches = []
    for snap in snaps:
        ids, pos, vel, mass, center = _pack(snap, n_halos, cap)
        batches.append(SnapshotBatch(
            ids=jnp.asarray(ids), pos=jnp.asarray(pos), vel=jnp.asarray(vel),
            center=jnp.asarray(center), mass=jnp.asarray(mass),
            bulk_vel=None, hubble_drag=jnp.float32(0.0),
        ))
    stacked = _with_drag_axis(stack_batches(batches))
    step = make_sorted_orbit_step(K, mode="pericentric", box_size=box)

    @jax.jit
    def run(c, s):
        return jax.lax.scan(lambda c, b: step(c, b), c, s)

    carry, ev = run(init_sorted_carry(n_halos, cap), stacked)
    assert ev.ids.shape == (n_snap, n_halos, K)
    assert int(np.asarray(ev.count).sum()) > 0

    # sequential reference
    step_j = jax.jit(step)
    c2 = init_sorted_carry(n_halos, cap)
    for s, b in enumerate(batches):
        c2, ev2 = step_j(c2, b)
        np.testing.assert_array_equal(
            np.asarray(ev2.count), np.asarray(ev.count)[s]
        )
    np.testing.assert_array_equal(np.asarray(c2.ids), np.asarray(carry.ids))
