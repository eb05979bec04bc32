"""Stable-layout aligned engine (join_impl='aligned'): the host staging
pipeline gives every particle a persistent row position, so the device
runs no join at all — churn proceeds at static-kernel speed.

Tiers: StableLayout unit invariants, step-level equality against the
sorted engine, tracker savefile parity vs the general engine
(incl. growth, resume, halo birth), and the halo-sharded mesh path.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu import track_orbits
from orbitanalysis_tpu.engine.packing import (
    SLOT_MASK,
    StableLayout,
    pack_snapshot_aligned,
)
from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.utils.padding import invalid_id_for

from helpers import make_callbacks
from test_engine import (  # noqa: F401
    _assert_files_equal,
    _capacities,
    churn_setup,
    growing_setup,
)


INV = invalid_id_for(np.int32)


def _random_membership(rng, pool, k):
    return rng.choice(pool, size=k, replace=False).astype(np.int32)


class TestStableLayout:
    def test_survivors_keep_positions(self):
        lay = StableLayout(2, 8)
        ids0 = np.full((2, 8), INV, np.int32)
        ids0[0, :5] = [3, 9, 4, 7, 1]
        ids0[1, :3] = [10, 2, 5]
        d0, v0 = lay.assign(ids0)
        # entrants fill free positions in ascending order: 0..k-1
        assert np.array_equal(d0[0, :5], np.arange(5))
        assert np.array_equal(d0[1, :3], np.arange(3))
        assert (d0[~v0] == -1).all()

        # drop id 4 (pos 2), keep the rest shuffled, add 42 and 99;
        # row 1 keeps the same membership reordered
        ids1 = np.full((2, 8), INV, np.int32)
        ids1[0, :6] = [7, 1, 42, 3, 9, 99]
        ids1[1, :3] = [5, 10, 2]
        d1, v1 = lay.assign(ids1)
        # survivors keep their original positions
        assert d1[0, 0] == 3   # id 7
        assert d1[0, 1] == 4   # id 1
        assert d1[0, 3] == 0   # id 3
        assert d1[0, 4] == 1   # id 9
        # entrants reuse the freed hole (2) then the first untouched (5)
        assert sorted([d1[0, 2], d1[0, 5]]) == [2, 5]
        # same-membership row keeps its layout
        assert np.array_equal(lay.layout[1, :3], [10, 2, 5])
        assert np.array_equal(d1[1, :3], [2, 0, 1])

        # a row whose membership empties frees every position
        ids2 = np.full((2, 8), INV, np.int32)
        ids2[0, :6] = ids1[0, :6]
        lay.assign(ids2)
        assert (lay.layout[1] == INV).all()

    def test_occupancy_never_exceeds_membership(self):
        rng = np.random.default_rng(0)
        lay = StableLayout(3, 64)
        pool = np.arange(500)
        for _ in range(30):
            ids = np.full((3, 64), INV, np.int32)
            for h in range(3):
                k = rng.integers(1, 65)
                ids[h, :k] = np.sort(_random_membership(rng, pool, k))
            dest, valid = lay.assign(ids)
            for h in range(3):
                d = dest[h][valid[h]]
                assert len(np.unique(d)) == len(d)  # injective
                assert (d >= 0).all() and (d < 64).all()
                occ = lay.layout[h] != INV
                assert occ.sum() == valid[h].sum()

    def test_layout_matches_assignment(self):
        rng = np.random.default_rng(1)
        lay = StableLayout(1, 32)
        prev_dest = {}
        pool = np.arange(100)
        for _ in range(20):
            k = int(rng.integers(1, 33))
            members = _random_membership(rng, pool, k)
            ids = np.full((1, 32), INV, np.int32)
            ids[0, :k] = members
            dest, valid = lay.assign(ids)
            for i, pid in enumerate(members):
                if pid in prev_dest:  # survivor: position is sticky
                    assert dest[0, i] == prev_dest[pid]
            prev_dest = {
                pid: dest[0, i] for i, pid in enumerate(members)
            }
            # layout mirrors the assignment
            for pid, d in prev_dest.items():
                assert lay.layout[0, d] == pid

    def test_grow_preserves_positions(self):
        lay = StableLayout(1, 8)
        ids = np.full((1, 8), INV, np.int32)
        ids[0, :4] = [5, 1, 9, 3]
        lay.assign(ids)
        lay.grow(16)
        assert lay.capacity == 16
        ids2 = np.full((1, 16), INV, np.int32)
        ids2[0, :4] = [5, 1, 9, 3]
        d2, _ = lay.assign(ids2)
        assert np.array_equal(d2[0, :4], np.arange(4))

    def test_overflow_raises(self):
        lay = StableLayout(1, 4)
        ids = np.full((1, 4), INV, np.int32)
        ids[0] = [1, 2, 3, 4]
        lay.assign(ids)
        # all 4 positions occupied by other tenants; 4 entrants > 0 free
        # can't happen via the public packer (membership <= capacity is
        # fine — holes are reused), so poke the layout directly
        lay.layout[0] = [1, 2, 3, 4]
        ids2 = np.full((1, 4), INV, np.int32)
        ids2[0] = [5, 6, 7, 8]
        d, v = lay.assign(ids2)  # full turnover still fits: 4 frees
        assert sorted(d[0]) == [0, 1, 2, 3]


def test_aligned_slot_is_permutation(churn_setup):  # noqa: F811
    """pack_snapshot_aligned's slot channel must be a full [0, P)
    permutation per row under SLOT_MASK (checkpoint scatter relies on
    it), with load slots at occupied positions and the FRESH flag (bit
    27) exactly where the position's tenant changed."""
    from orbitanalysis_tpu.engine.packing import FRESH_BIT, SLOT_MASK

    box, snaps, regions, loader, snap_nums, branches = churn_setup
    rows = np.arange(3)
    lay = StableLayout(3, 256)
    prev_layout = lay.layout.copy()
    for s in range(4):
        rp, rr = regions(s, branches[s])
        snap = loader(s, rp, rr)
        packed = pack_snapshot_aligned(snap, rows, 3, lay, rp, None)
        slot = packed.slot & SLOT_MASK
        fresh = (packed.slot & FRESH_BIT) != 0
        for h in range(3):
            assert np.array_equal(
                np.sort(slot[h]), np.arange(256)
            ), (s, h)
        # FRESH exactly where the tenant changed (and only at occupied
        # positions)
        exp_fresh = (packed.ids != INV) & (packed.ids != prev_layout)
        assert np.array_equal(fresh, exp_fresh), s
        prev_layout = lay.layout.copy()
        # occupied positions carry the right particle: scatter back by
        # slot recovers the load-order front-packed ids
        offs = np.asarray(snap["region_offsets"])
        lens = np.diff(np.concatenate([offs, [len(snap["ids"])]]))
        for h in range(3):
            back = np.full(256, INV, np.int32)
            np.put_along_axis(back, slot[h], packed.ids[h], -1)
            exp = snap["ids"][offs[h]:offs[h] + lens[h]]
            assert np.array_equal(back[:lens[h]], exp), (s, h)
            assert (back[lens[h]:] == INV).all()


def test_aligned_step_matches_sorted_engine(churn_setup):  # noqa: F811
    """Step-level: the aligned engines' events must equal the sorted
    engine's on a churning sequence — the native and legacy aligned
    steps bit-identically, the sorted engine (``jnp.arccos`` where the
    aligned steps use the fixed polynomial) in IDs and order exactly,
    angles to f32 tolerance."""
    from orbitanalysis_tpu.engine.packing import pack_snapshot
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import (
        decode_aligned_carry,
        init_aligned_carry,
        init_sorted_carry,
        make_aligned_native_step,
        make_aligned_orbit_step,
        make_sorted_orbit_step,
    )

    box, snaps, regions, loader, snap_nums, branches = churn_setup
    rows = np.arange(3)
    P = 256
    lay = StableLayout(3, P)
    step_a = jax.jit(make_aligned_orbit_step(P, box_size=box))
    step_n = jax.jit(make_aligned_native_step(P, box_size=box))
    step_s = jax.jit(make_sorted_orbit_step(P, box_size=box))
    carry_a = init_sorted_carry(3, P)
    carry_n = init_aligned_carry(3, P)
    carry_s = init_sorted_carry(3, P)
    # no events can fire on the first snapshot (everything FRESH), so
    # the initial prev-slot table is never actually consulted
    prev_slot = np.zeros((3, P), np.int32)

    for s in range(len(snaps)):
        rp, rr = regions(s, branches[s])
        snap = loader(s, rp, rr)
        pk_a = pack_snapshot_aligned(snap, rows, 3, lay, rp, None)
        pk_s = pack_snapshot(snap, rows, 3, P, rp, None, sort_ids=True)

        def batch(pk):
            return SnapshotBatch(
                ids=jnp.asarray(pk.ids), pos=jnp.asarray(pk.pos),
                vel=jnp.asarray(pk.vel), center=jnp.asarray(pk.center),
                mass=None if pk.mass is None else jnp.asarray(pk.mass),
                bulk_vel=None, hubble_drag=jnp.float32(0),
                slot=jnp.asarray(pk.slot),
            )

        carry_a, ev_a = step_a(carry_a, batch(pk_a))
        carry_n, ev_n = step_n(carry_n, batch(pk_a))
        carry_s, ev_s = step_s(carry_s, batch(pk_s))

        # the carry-native step's events are positional (row positions
        # + f16-exact angles); the legacy select-staged step emits real
        # IDs + prev load slots + f32 angles.  Map positions through the
        # staged tables (IDs from the current snapshot, slots from the
        # previous — an event position's tenant is unchanged across the
        # pair) and compare at the savefile's f16 storage precision.
        en = jax.tree.map(np.asarray, ev_n)
        ea = jax.tree.map(np.asarray, ev_a)
        assert en.slots is None
        assert np.array_equal(en.count, ea.count), s
        id_tab = np.asarray(pk_a.ids)
        for h in range(3):
            n = en.count[h]
            pos = en.ids[h][:n]
            en_ids = id_tab[h, pos]
            en_slots = prev_slot[h, pos]
            on = np.argsort(en_slots, kind="stable")
            oa = np.argsort(ea.slots[h][:n], kind="stable")
            assert np.array_equal(en_ids[on], ea.ids[h][:n][oa]), (s, h)
            assert np.array_equal(
                en_slots[on], ea.slots[h][:n][oa]), (s, h)
            np.testing.assert_array_equal(
                en.angles[h][:n][on],
                ea.angles[h][:n][oa].astype(np.float16).astype(
                    np.float32),
                err_msg=f"native vs legacy {s},{h}",
            )
        dn = decode_aligned_carry(jax.tree.map(np.asarray, carry_n))
        na_ = jax.tree.map(np.asarray, carry_a)
        # native carry keys hold row positions at valid entries; the
        # legacy carry holds the real IDs — same validity, and the
        # staged ID table maps one onto the other
        valid_n = dn.ids != INV
        assert np.array_equal(valid_n, na_.ids != INV), s
        pos_iota = np.broadcast_to(np.arange(P), (3, P))
        assert np.array_equal(dn.ids[valid_n], pos_iota[valid_n]), s
        assert np.array_equal(id_tab[valid_n], na_.ids[valid_n]), s
        np.testing.assert_array_equal(dn.angles, na_.angles)
        assert np.array_equal(dn.vrb & 3, np.asarray(na_.vrb) & 3), s
        prev_slot = np.asarray(pk_a.slot) & SLOT_MASK

        ca = jax.tree.map(np.asarray, ev_a)
        cs = jax.tree.map(np.asarray, ev_s)
        assert np.array_equal(ca.count, cs.count), s
        for h in range(3):
            n = ca.count[h]
            # the sorted engine emits events in prev load-slot order
            # (the reference's); order the legacy step's by its slots
            oa = np.argsort(ca.slots[h][:n], kind="stable")
            assert np.array_equal(ca.ids[h][:n][oa], cs.ids[h][:n]), (s, h)
            np.testing.assert_allclose(
                ca.angles[h][:n][oa], cs.angles[h][:n], rtol=1e-5,
                atol=1e-6, err_msg=f"{s},{h}",
            )
        np.testing.assert_allclose(ca.bulk_vel, cs.bulk_vel, atol=1e-5)

        # carries agree as (id -> angle) maps
        na = jax.tree.map(np.asarray, carry_a)
        ns = jax.tree.map(np.asarray, carry_s)
        for h in range(3):
            ma = {i: a for i, a in zip(na.ids[h], na.angles[h]) if i != INV}
            ms = {i: a for i, a in zip(ns.ids[h], ns.angles[h]) if i != INV}
            assert ma.keys() == ms.keys(), (s, h)
            for i in ma:
                np.testing.assert_allclose(ma[i], ms[i], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{s},{h},{i}")


@pytest.mark.parametrize("batched", [False, True])
def test_scan_aligned_matches_scan_sorted(batched):
    """The scan-resident aligned path (stage_batch_aligned +
    scan_events_aligned, the bench configuration) emits the same event
    stream as the sorted scan on a churning sequence — in both the
    per-step (default) and sequence-batched forms."""
    from orbitanalysis_tpu.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu.engine.scan import (
        scan_events_aligned,
        scan_events_sorted,
    )
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import (
        init_aligned_carry,
        init_sorted_carry,
        presort_snapshot,
    )
    import bench

    H, P, S = 2, 256, 6
    ids, pos, vel, centers, n_valid = bench.make_sequence(
        H, P, S, seed=3, churn=0.1
    )
    snaps = SnapshotBatch(
        ids=np.ascontiguousarray(ids), pos=pos, vel=vel,
        center=np.ascontiguousarray(centers), mass=None, bulk_vel=None,
        hubble_drag=np.zeros(S, np.float32),
    )
    K = P
    sorted_staged = jax.tree.map(
        jnp.asarray, presort_snapshot(snaps, soa=True)
    )
    aligned_staged = jax.tree.map(
        jnp.asarray, stage_batch_aligned(snaps, soa=True)
    )
    _, (cnt_s, ids_s, ang_s) = jax.jit(
        lambda c, s: scan_events_sorted(
            c, s, K, box_size=100.0, soa_batch=True,
        )
    )(init_sorted_carry(H, P), sorted_staged)
    carry_a, (cnt_a, ids_a, ang_a) = jax.jit(
        lambda c, s: scan_events_aligned(
            c, s, K, box_size=100.0, soa_batch=True, batched=batched
        )
    )(init_aligned_carry(H, P), aligned_staged)
    if batched:
        # the two aligned forms share the AlignedCarry format — the
        # batched form's final carry must be bit-identical so chained
        # scans / resume can mix forms freely
        carry_p, _ = jax.jit(
            lambda c, s: scan_events_aligned(
                c, s, K, box_size=100.0, soa_batch=True, batched=False
            )
        )(init_aligned_carry(H, P), aligned_staged)
        for a, b in zip(jax.tree.leaves(carry_a), jax.tree.leaves(carry_p)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    cnt_s, cnt_a = np.asarray(cnt_s), np.asarray(cnt_a)
    assert np.array_equal(cnt_s, cnt_a)
    ids_s, ids_a = np.asarray(ids_s), np.asarray(ids_a)
    ang_s, ang_a = np.asarray(ang_s), np.asarray(ang_a)
    # aligned events are positional: map row positions through the
    # staged ID tables; angles come back f16-exact, so compare both
    # engines at the savefile's f16 storage precision, to one f16 ulp
    # (the sorted engine's jnp.arccos vs the aligned polynomial — the
    # savefile tolerance of tests/test_engine.py::_assert_files_equal)
    staged_ids = np.asarray(aligned_staged.ids)
    total = 0
    for s in range(S):
        for h in range(H):
            n = cnt_s[s, h]
            total += n
            pos = ids_a[s, h][:n]
            ea = dict(zip(staged_ids[s, h][pos].tolist(),
                          ang_a[s, h][:n].astype(np.float16)))
            es = dict(zip(ids_s[s, h][:n].tolist(),
                          ang_s[s, h][:n].astype(np.float16)))
            assert ea.keys() == es.keys(), (s, h)
            for i in ea:
                assert abs(float(ea[i]) - float(es[i])) <= float(
                    np.spacing(np.float16(max(ea[i], es[i])))), (s, h, i)
    assert total > 0  # the sequence must actually produce events


@pytest.mark.slow
def test_aligned_tracker_identical(tmp_path, churn_setup):  # noqa: F811
    """join_impl='aligned' must write a savefile identical to the
    general engine's — dataset-for-dataset, including event order."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "general.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="general", checkpoint=True, verbose=False)
    got = str(tmp_path / "aligned.h5")
    track_orbits(snap_nums, branches, regions, loader, got,
                 join_impl="aligned", checkpoint=True, verbose=False)
    _assert_files_equal(ref, got)
    with h5py.File(ref + ".checkpoint") as a, \
         h5py.File(got + ".checkpoint") as b:
        np.testing.assert_allclose(
            a["angles"][:], b["angles"][:], atol=1e-4
        )


@pytest.mark.slow
def test_aligned_growth_and_resume(tmp_path, growing_setup):  # noqa: F811
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = growing_setup
    ref = str(tmp_path / "ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="aligned", checkpoint=True, verbose=False)

    # capacity growth mid-run (grow_impl='keep' re-jits at the grown
    # capacity; the stable layout grows alongside)
    grown = str(tmp_path / "grown.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, grown,
                 join_impl="aligned", capacity=128, headroom=1.05,
                 metrics=m, verbose=False)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps
    _assert_files_equal(ref, grown)

    # growth converting to the general engine mid-run
    conv = str(tmp_path / "converted.h5")
    m2 = Metrics()
    track_orbits(snap_nums, branches, regions, loader, conv,
                 join_impl="aligned", grow_impl="general",
                 capacity=128, headroom=1.05, metrics=m2, verbose=False)
    assert _capacities(m2)[-1] > 128
    _assert_files_equal(ref, conv)

    # crash at snapshot 5 then resume
    resumed = str(tmp_path / "resumed.h5")
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == 5 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError):
        track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                     join_impl="aligned", checkpoint=True, verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                 join_impl="aligned", checkpoint=True, resume=True,
                 verbose=False)
    # BIT-identical, not just tolerance-equal: the sidecar's
    # layout_positions dataset restores the history-dependent stable
    # layout, so the resumed run reproduces the straight run's row
    # order (and thus its bulk-velocity reduction order) exactly
    with h5py.File(ref) as a, h5py.File(resumed) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_aligned_resume_bit_identical(tmp_path, churn_setup):  # noqa: F811
    """Crash-resume through the aligned engine is bit-identical to the
    straight run: the checkpoint sidecar's ``layout_positions`` dataset
    restores the history-dependent stable layout (a fresh layout would
    re-place particles and perturb the bulk-velocity reduction order)."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "straight.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="aligned", checkpoint=True, verbose=False)

    resumed = str(tmp_path / "resumed.h5")
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == 4 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError):
        track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                     join_impl="aligned", checkpoint=True, verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                 join_impl="aligned", checkpoint=True, resume=True,
                 verbose=False)
    with h5py.File(ref) as a, h5py.File(resumed) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_aligned_halo_born_mid_run(tmp_path, churn_setup):  # noqa: F811
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    branches = branches.copy()
    branches[:4, 1] = -1
    ref = str(tmp_path / "born_g.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="general", verbose=False)
    got = str(tmp_path / "born_a.h5")
    track_orbits(snap_nums, branches, regions, loader, got,
                 join_impl="aligned", verbose=False)
    _assert_files_equal(ref, got)


@pytest.mark.slow
def test_aligned_tracker_sharded_mesh(tmp_path):
    """Halo-sharded aligned engine over the virtual CPU mesh writes the
    same savefile as the unsharded run."""
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    box = 60.0
    n_halos, n_part, n_snap = 8, 120, 6
    snaps, centers = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=23
    )
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))

    ref = str(tmp_path / "single.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="aligned", verbose=False)

    mesh = make_mesh({"halos": 4})
    got = str(tmp_path / "sharded.h5")
    track_orbits(snap_nums, branches, regions, loader, got,
                 mesh=mesh, join_impl="aligned", verbose=False)
    _assert_files_equal(ref, got)


@pytest.mark.slow
def test_aligned_both_mode(tmp_path, churn_setup):  # noqa: F811
    """mode='both' through the aligned engine: one stable-layout staging
    pass feeds both detectors; each savefile equals the single-mode
    aligned run's."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    peri1 = str(tmp_path / "peri_single.h5")
    apo1 = str(tmp_path / "apo_single.h5")
    track_orbits(snap_nums, branches, regions, loader, peri1,
                 mode="pericentric", join_impl="aligned", verbose=False)
    track_orbits(snap_nums, branches, regions, loader, apo1,
                 mode="apocentric", join_impl="aligned", verbose=False)
    peri2 = str(tmp_path / "peri_both.h5")
    apo2 = str(tmp_path / "apo_both.h5")
    track_orbits(snap_nums, branches, regions, loader, (peri2, apo2),
                 mode="both", join_impl="aligned", verbose=False)
    _assert_files_equal(peri1, peri2)
    _assert_files_equal(apo1, apo2)


# ----------------------------------------------------------------------
# wide (64-bit) particle IDs: position-surrogate device path
# ----------------------------------------------------------------------

def _widen_ids_inplace(snaps, shift):
    for s in snaps:
        for h in s:
            s[h]["ids"] = s[h]["ids"].astype(np.int64) + shift


def test_stable_layout_wide_ids_assign():
    """StableLayout invariants hold for int64 IDs beyond 2^32 (the
    NumPy per-row searchsorted path; the batched << 32 row-offset trick
    only covers 32-bit IDs)."""
    rng = np.random.default_rng(3)
    H, P = 3, 64
    inv = invalid_id_for(np.int64)
    lay = StableLayout(H, P, id_dtype=np.int64)
    base = np.int64(2) ** 40

    def front_pack(members_per_row):
        ids = np.full((H, P), inv, np.int64)
        for h, m in enumerate(members_per_row):
            ids[h, :len(m)] = m
        return ids

    pools = [
        base + rng.choice(10_000, size=P, replace=False).astype(np.int64)
        for _ in range(H)
    ]
    m0 = [p[:40] for p in pools]
    dest0, valid0 = lay.assign(front_pack(m0))
    # every member placed exactly once per row
    for h in range(H):
        d = dest0[h][valid0[h]]
        assert len(np.unique(d)) == len(d)
        assert np.array_equal(np.sort(lay.layout[h][lay.layout[h] != inv]),
                              np.sort(m0[h]))
    # churn: survivors keep their position
    m1 = [np.concatenate([p[10:40], p[40:55]]) for p in pools]
    pos_before = {
        (h, int(i)): int(np.where(lay.layout[h] == i)[0][0])
        for h in range(H) for i in m0[h][10:]
    }
    lay.assign(front_pack(m1))
    for h in range(H):
        for i in m0[h][10:40]:
            assert lay.layout[h][pos_before[(h, int(i))]] == i, (h, i)


def test_stable_align_native_wide_matches_numpy():
    """Native i64 stable_align (packing.cpp) == the NumPy fallback,
    including slot permutation and FRESH flags."""
    from orbitanalysis_tpu import native
    from orbitanalysis_tpu.engine.packing import align_packed

    if not native.available() and not native.build():
        pytest.skip("no native toolchain")

    rng = np.random.default_rng(7)
    H, P = 4, 128
    inv = invalid_id_for(np.int64)
    base = np.int64(2) ** 45

    def seq(seed_shift):
        ids = np.full((2, H, P), inv, np.int64)
        pos = rng.normal(size=(2, H, P, 3)).astype(np.float32)
        vel = rng.normal(size=(2, H, P, 3)).astype(np.float32)
        for s in range(2):
            for h in range(H):
                n = int(rng.integers(60, 100))
                members = rng.choice(
                    1000, size=n, replace=False
                ).astype(np.int64) + base + seed_shift * h
                ids[s, h, :n] = members
        return ids, pos, vel

    ids, pos, vel = seq(10_000)
    lay_nat = StableLayout(H, P, id_dtype=np.int64)
    lay_np = StableLayout(H, P, id_dtype=np.int64)
    for s in range(2):
        got = native.stable_align_native(
            lay_nat.layout, ids[s], pos[s], vel[s], None, inv
        )
        assert got is not None, "native i64 path unavailable"
        # NumPy reference: align_packed's fallback body via .assign
        import orbitanalysis_tpu.native as nat_mod
        real_fn = nat_mod.stable_align_native
        nat_mod.stable_align_native = lambda *a, **k: None
        try:
            exp = align_packed(lay_np, ids[s], pos[s], vel[s], None)
        finally:
            nat_mod.stable_align_native = real_fn
        for g, e, name in zip(got[:3], exp[:3], ("ids", "pos", "vel")):
            assert np.array_equal(g, e), name
        assert np.array_equal(got[4], exp[4]), "slot/FRESH"
        assert np.array_equal(lay_nat.layout, lay_np.layout)


def test_aligned_wide_ids_no_x64(tmp_path, churn_setup):  # noqa: F811
    """int64 IDs beyond 2^31 on the aligned engine with x64 DISABLED:
    the device streams a 32-bit position surrogate (never the wide ID),
    and the savefile carries the real int64 IDs — byte-identical to the
    same run on unshifted int32 IDs, modulo the shift."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    narrow = str(tmp_path / "narrow.h5")
    track_orbits(snap_nums, branches, regions, loader, narrow,
                 join_impl="aligned", checkpoint=True, verbose=False)

    shift = np.int64(2) ** 33
    _widen_ids_inplace(snaps, shift)
    wide = str(tmp_path / "wide.h5")
    track_orbits(snap_nums, branches, regions, loader, wide,
                 join_impl="aligned", id_dtype=np.int64, checkpoint=True,
                 verbose=False)

    # identical placement/order: every dataset matches, IDs modulo shift
    with h5py.File(narrow) as a, h5py.File(wide) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            if not k.startswith("snapshot"):
                continue
            for ds in a[k]:
                va, vb = a[k][ds][:], b[k][ds][:]
                if ds.endswith("center_IDs"):
                    assert vb.dtype == np.int64, ds
                    assert np.array_equal(va.astype(np.int64) + shift, vb)
                else:
                    assert np.array_equal(va, vb), (k, ds)
    with h5py.File(narrow + ".checkpoint") as a, \
         h5py.File(wide + ".checkpoint") as b:
        assert np.array_equal(a["angles"][:], b["angles"][:])


def test_aligned_wide_ids_growth_and_resume(tmp_path, growing_setup):  # noqa: F811
    """Wide-ID aligned runs grow IN PLACE (converting to the general
    engine would need 64-bit device IDs), resume bit-identically, and
    explicit grow_impl='general' refuses loudly."""
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = growing_setup
    shift = np.int64(2) ** 33
    _widen_ids_inplace(snaps, shift)

    ref = str(tmp_path / "ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="aligned", id_dtype=np.int64, checkpoint=True,
                 verbose=False)

    grown = str(tmp_path / "grown.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, grown,
                 join_impl="aligned", id_dtype=np.int64,
                 capacity=128, headroom=1.05, metrics=m, verbose=False)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps  # grew in place
    _assert_files_equal(ref, grown)

    with pytest.raises(ValueError, match="surrogate|x64|64-bit"):
        track_orbits(snap_nums, branches, regions, loader,
                     str(tmp_path / "refuse.h5"),
                     join_impl="aligned", id_dtype=np.int64,
                     grow_impl="general", capacity=128, headroom=1.05,
                     verbose=False)

    resumed = str(tmp_path / "resumed.h5")
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == 4 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError):
        track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                     join_impl="aligned", id_dtype=np.int64,
                     checkpoint=True, verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                 join_impl="aligned", id_dtype=np.int64,
                 checkpoint=True, resume=True, verbose=False)
    with h5py.File(ref) as a, h5py.File(resumed) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def _ceiling_batch(ids, slot_arr, vx, fresh):
    """[1, P] SnapshotBatch: all particles at +x radius 1, radial
    velocity = vx (bulk velocity pinned to zero so vr == vx exactly)."""
    from orbitanalysis_tpu.engine.packing import FRESH_BIT
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch

    P = len(ids)
    pos = np.zeros((1, P, 3), np.float32)
    pos[0, :, 0] = 1.0
    vel = np.zeros((1, P, 3), np.float32)
    vel[0, :, 0] = vx
    return SnapshotBatch(
        ids=jnp.asarray(ids[None]),
        pos=jnp.asarray(pos),
        vel=jnp.asarray(vel),
        center=jnp.zeros((1, 3), jnp.float32),
        mass=None,
        bulk_vel=jnp.zeros((1, 3), jnp.float32),
        hubble_drag=jnp.float32(0),
        slot=jnp.asarray(slot_arr[None] | (FRESH_BIT if fresh else 0)),
    )


def test_aligned_step_last_position_event_at_fused_ceiling():
    """At P = 131072 (the first row width past PAYLOAD_MAX_ROW) the
    single-word positional payload would wrap ``(pos + 1) << 15`` to
    zero for the LAST row position, silently dropping its event while
    the count keeps it.  Wide rows must route through the two-word
    format and emit every event, last position included."""
    from orbitanalysis_tpu.ops.compact import PAYLOAD_MAX_ROW
    from orbitanalysis_tpu.ops.sorted_step import (
        init_aligned_carry,
        make_aligned_native_step,
    )

    P = PAYLOAD_MAX_ROW + 1
    fire = np.array([0, 12345, P - 1])
    ids = np.arange(P, dtype=np.int32)
    slot = np.arange(P, dtype=np.int32)
    vx0 = np.full(P, -1.0, np.float32)   # inward everywhere
    vx1 = np.full(P, -1.0, np.float32)
    vx1[fire] = 1.0                      # sign flip -> pericenter

    step = make_aligned_native_step(256)
    carry = init_aligned_carry(1, P)
    carry, ev0 = step(carry, _ceiling_batch(ids, slot, vx0, True))
    carry, ev1 = step(carry, _ceiling_batch(ids, slot, vx1, False))
    ev0, ev1 = jax.tree.map(np.asarray, (ev0, ev1))
    assert int(ev0.count[0]) == 0        # everything FRESH at snap 0
    assert int(ev1.count[0]) == len(fire)
    got = np.sort(ev1.ids[0][: len(fire)])
    np.testing.assert_array_equal(got, fire)
    # rhat is identical across the pair, so the apsis angles are ~0
    assert np.all(np.abs(ev1.angles[0][: len(fire)]) < 1e-3)


def test_scan_aligned_batched_last_position_event_at_fused_ceiling():
    """Same regression through the batched sequence driver (the second
    site of the single-word encoding, engine/scan.py)."""
    from orbitanalysis_tpu.engine.scan import scan_events_aligned
    from orbitanalysis_tpu.ops.compact import PAYLOAD_MAX_ROW
    from orbitanalysis_tpu.ops.sorted_step import init_aligned_carry

    P = PAYLOAD_MAX_ROW + 1
    fire = np.array([7, P - 1])
    ids = np.arange(P, dtype=np.int32)
    slot = np.arange(P, dtype=np.int32)
    vx0 = np.full(P, -1.0, np.float32)
    vx1 = np.full(P, -1.0, np.float32)
    vx1[fire] = 1.0

    b0 = _ceiling_batch(ids, slot, vx0, True)
    b1 = _ceiling_batch(ids, slot, vx1, False)
    snaps = jax.tree.map(lambda *xs: jnp.stack(xs), b0, b1)
    _, (count, ev_pos, _ang) = scan_events_aligned(
        init_aligned_carry(1, P), snaps, event_capacity=256, batched=True
    )
    count, ev_pos = np.asarray(count), np.asarray(ev_pos)
    assert int(count[0, 0]) == 0
    assert int(count[1, 0]) == len(fire)
    np.testing.assert_array_equal(
        np.sort(ev_pos[1, 0][: len(fire)]), fire
    )


def test_scan_aligned_batched_rejects_wide_id_dtype():
    """Advisor round-2 low finding: the batched driver crashed with an
    OverflowError building a uint32 sentinel when handed
    id_dtype=int64; it must reject wide dtypes with a pointer at the
    int32 position-surrogate instead."""
    from orbitanalysis_tpu.engine.scan import scan_events_aligned
    from orbitanalysis_tpu.ops.sorted_step import init_aligned_carry

    P = 256
    ids = np.arange(P, dtype=np.int32)
    slot = np.arange(P, dtype=np.int32)
    b = _ceiling_batch(ids, slot, np.full(P, -1.0, np.float32), True)
    snaps = jax.tree.map(lambda *xs: jnp.stack(xs), b, b)
    with pytest.raises(ValueError, match="position\\s+surrogate|surrogate"):
        scan_events_aligned(
            init_aligned_carry(1, P), snaps, event_capacity=64,
            batched=True, id_dtype=np.int64,
        )


@pytest.mark.slow
def test_aligned_big_halo_wide_ids_growth():
    """The big-halo x wide-ID exit: a halo growing past 131072 rows
    (the first width past the single-word payload) with
    id_dtype=np.int64 completes a tracked run on the aligned engine —
    rows wider than PAYLOAD_MAX_ROW route through the two-word event
    format.  Savefiles must equal the int32 twin's, IDs shifted."""
    import tempfile

    from orbitanalysis_tpu.ops.compact import PAYLOAD_MAX_ROW
    from orbitanalysis_tpu.ops.sorted_step import MAX_ROW_CAPACITY
    from orbitanalysis_tpu.utils.metrics import Metrics

    wide_row = PAYLOAD_MAX_ROW + 1
    assert MAX_ROW_CAPACITY > wide_row
    rng = np.random.default_rng(31)
    box = 200.0
    n_pool, n_small, n_big, n_snap = 160_000, 95_000, 150_000, 6
    center = np.array([100.0, 100.0, 100.0], np.float32)
    x = (center + rng.normal(scale=5.0, size=(n_pool, 3))).astype(
        np.float32
    )
    v = rng.normal(scale=1.0, size=(n_pool, 3)).astype(np.float32)
    snaps = []
    for s in range(n_snap):
        if s:
            v = (v + rng.normal(scale=0.5, size=v.shape)).astype(
                np.float32
            )
            x = (x + 0.3 * v).astype(np.float32)
        n_mem = n_small if s < 3 else n_big  # growth at snapshot 3
        sel = rng.permutation(n_pool)[:n_mem]
        snaps.append(dict(ids=sel.astype(np.int64), pos=x[sel].copy(),
                          vel=v[sel].copy()))

    def regions(snapshot_number, halo_ids):
        return center[None, :], np.array([1e9])

    def make_loader(shift):
        def loader(s, rp, rr):
            d = snaps[s]
            return dict(
                ids=d["ids"] + shift,
                coordinates=d["pos"],
                velocities=d["vel"],
                masses=1.0,
                region_offsets=np.array([0]),
                box_size=box,
            )
        return loader

    snap_nums = np.arange(n_snap)
    branches = np.zeros((n_snap, 1), np.int64)
    out = {}
    for tag, shift, idt in (
        ("narrow", 0, np.int32), ("wide", np.int64(2) ** 33, np.int64)
    ):
        m = Metrics()
        save = tempfile.mktemp(suffix=f"_{tag}.h5")
        track_orbits(
            snap_nums, branches, regions, make_loader(shift), save,
            join_impl="aligned", id_dtype=idt, metrics=m, verbose=False,
        )
        caps = _capacities(m)
        assert caps and caps[0] <= wide_row
        assert max(caps) > wide_row, caps  # growth fired
        out[tag] = save

    SHIFT = np.int64(2) ** 33
    with h5py.File(out["narrow"]) as a, h5py.File(out["wide"]) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        n_events = 0
        for k in a:
            for ds in a[k]:
                va, vb = a[k][ds][:], b[k][ds][:]
                if ds.endswith("center_IDs"):
                    assert vb.dtype == np.int64, (k, ds)
                    assert np.array_equal(
                        va.astype(np.int64) + SHIFT, vb), (k, ds)
                    n_events += va.size
                else:
                    assert np.array_equal(va, vb), (k, ds)
        assert n_events > 0
