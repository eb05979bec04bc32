"""Integration tier: the offline driver end-to-end vs the oracle, plus
resume, capacity growth, halo birth, and the on-the-fly engine
(SURVEY.md §4 oracle/resume tiers)."""

import os

import h5py
import numpy as np
import pytest

from orbitanalysis_tpu import track_orbits, track_orbits_onthefly
from orbitanalysis_tpu.models.synthetic import churn_snapshots

from helpers import make_callbacks
from oracle import OracleTracker


@pytest.fixture
def churn_setup():
    box = 60.0
    n_halos, n_part, n_snap = 3, 150, 8
    snaps, centers = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=11
    )
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))
    return box, snaps, regions, loader, snap_nums, branches


@pytest.fixture
def growing_setup():
    """Like ``churn_setup``, but each halo's region roughly doubles at
    snapshot 4 (a second particle pool enters), so a run whose capacity
    fits the early snapshots MUST grow mid-run.  Churn membership alone
    peaks at snapshot 0 (~114 < 128), which made the old capacity-128
    growth tests vacuous — growth tests should also assert (via
    ``Metrics``) that the growth actually fired."""
    box = 60.0
    n_halos, n_part, n_snap = 3, 150, 8
    snaps, centers = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=11
    )
    extra, _ = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=12
    )
    for s_idx in range(4, n_snap):
        s, e = snaps[s_idx], extra[s_idx]
        for h in list(s):
            s[h] = dict(
                ids=np.concatenate([s[h]["ids"], e[h]["ids"] + 500_000]),
                pos=np.concatenate([s[h]["pos"], e[h]["pos"]]),
                vel=np.concatenate([s[h]["vel"], e[h]["vel"]]),
                mass=np.concatenate([s[h]["mass"], e[h]["mass"]]),
                center=s[h]["center"],
            )
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))
    return box, snaps, regions, loader, snap_nums, branches


def _capacities(metrics):
    return [r["capacity"] for r in metrics.records if "capacity" in r]


def _oracle_sets(snaps, box, mode="pericentric"):
    oracle = OracleTracker(mode=mode, box_size=box)
    return [oracle.step(s) for s in snaps]


def _check_file_vs_oracle(save, snaps, expected, n_halos, tag="pericenter"):
    with h5py.File(save) as hf:
        for s in range(1, len(snaps)):
            g = hf["snapshot_%03d" % s]
            offs = g["region_offsets"][:]
            got = g[tag + "_IDs"][:]
            for h in range(n_halos):
                got_h = np.sort(got[offs[h]:offs[h + 1]])
                exp_h = np.sort(expected[s][h][0])
                assert np.array_equal(got_h, exp_h), (s, h)


@pytest.mark.smoke
def test_track_orbits_end_to_end(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "orbits.h5")
    track_orbits(snap_nums, branches, regions, loader, save, verbose=False)
    _check_file_vs_oracle(save, snaps, _oracle_sets(snaps, box), 3)


def test_crash_resume_bit_identical(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    straight = str(tmp_path / "straight.h5")
    track_orbits(snap_nums, branches, regions, loader, straight,
                 checkpoint=True, verbose=False)

    resumed = str(tmp_path / "resumed.h5")
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == 5 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError):
        track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                     checkpoint=True, verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                 checkpoint=True, resume=True, verbose=False)

    with h5py.File(straight) as a, h5py.File(resumed) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_capacity_growth_mid_run(tmp_path, growing_setup):
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = growing_setup
    # initial capacity fits the early snapshots; the pool doubling at
    # snapshot 4 forces growth mid-run (asserted via the metrics)
    save = str(tmp_path / "grown.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, save,
                 capacity=128, headroom=1.05, metrics=m, verbose=False)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps
    ref = str(tmp_path / "ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref, verbose=False)
    with h5py.File(save) as a, h5py.File(ref) as b:
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_event_capacity_growth_mid_run(tmp_path):
    """An event spike past the aligned engine's bounded event buffer
    must not abort the run (round-4 review item 5; the reference has
    no static event bound at all, track_orbits.py:199-217): the writer
    recovers every event losslessly from the step's pre-compaction
    payload plane and grows the event capacity for subsequent steps.
    """
    from orbitanalysis_tpu.utils.metrics import Metrics

    box = 100.0
    n_part, n_snap = 512, 6
    rng = np.random.default_rng(3)
    centers = np.array([[50.0, 50, 50], [20.0, 20, 20]], np.float32)
    u = rng.normal(size=(n_part, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    # halo 0: all particles breathe radially IN PHASE — between
    # snapshots 2 and 3 every v_r flips inward->outward at once, so
    # one halo row emits ~n_part pericenters in a single step, far
    # past event_capacity=128.  halo 1: steady outward drift, no
    # events (exercises the mixed overflow/normal row decode).
    radii = [3.0, 2.5, 2.0, 2.5, 3.0, 3.5]
    vr = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    snaps = []
    for s in range(n_snap):
        snaps.append({
            0: dict(
                ids=np.arange(n_part, dtype=np.int64),
                pos=centers[0] + radii[s] * u,
                vel=(vr[s] * u).astype(np.float32),
                center=centers[0],
            ),
            1: dict(
                ids=np.arange(n_part, dtype=np.int64) + 10_000,
                pos=centers[1] + (2.0 + 0.3 * s) * u,
                vel=(0.3 * u).astype(np.float32),
                center=centers[1],
            ),
        })
    regions, loader = make_callbacks(snaps, centers, box_size=box,
                                     mass=False)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(2), (n_snap, 1))

    save = str(tmp_path / "spike.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, save,
                 join_impl="aligned", event_capacity=128, metrics=m,
                 verbose=False)
    ev_caps = [r["event_capacity"] for r in m.records
               if "event_capacity" in r]
    assert ev_caps[0] == 128 and ev_caps[-1] >= n_part, ev_caps

    # bit-identical to a run whose event buffer never overflows
    ref = str(tmp_path / "roomy.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="aligned", event_capacity=n_part,
                 verbose=False)
    with h5py.File(save) as a, h5py.File(ref) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)

    # and the spike snapshot really carries the full event burst
    with h5py.File(save) as hf:
        g = hf["snapshot_003"]
        offs = g["region_offsets"][:]
        assert offs[1] - offs[0] == n_part
        got = np.sort(g["pericenter_IDs"][offs[0]:offs[1]])
        assert np.array_equal(got, np.arange(n_part, dtype=np.int64))


def test_grow_converts_sorted_to_general(tmp_path, growing_setup):
    """Capacity overflow under grow_impl='general' hands the sorted
    carry to the general engine mid-run with identical output."""
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = growing_setup
    save = str(tmp_path / "convert.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, save,
                 join_impl="sorted", grow_impl="general",
                 capacity=128, headroom=1.05, metrics=m, verbose=False)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps  # conversion fired
    ref = str(tmp_path / "ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref, verbose=False)
    with h5py.File(save) as a, h5py.File(ref) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_halo_born_mid_run(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    branches = branches.copy()
    branches[:4, 1] = -1  # halo 1 not born until snapshot 4
    save = str(tmp_path / "born.h5")
    track_orbits(snap_nums, branches, regions, loader, save, verbose=False)

    # oracle: halo 1's state starts fresh at snapshot 4
    oracle = OracleTracker(mode="pericentric", box_size=box)
    expected = []
    for s, snap in enumerate(snaps):
        sub = {h: v for h, v in snap.items() if branches[s][h] != -1}
        expected.append(oracle.step(sub))

    with h5py.File(save) as hf:
        for s in range(1, len(snaps)):
            g = hf["snapshot_%03d" % s]
            halo_rows = [h for h in range(3)
                         if branches[s][h] != -1 and branches[s - 1][h] != -1]
            offs = g["region_offsets"][:]
            got = g["pericenter_IDs"][:]
            assert len(offs) == len(halo_rows) + 1
            for j, h in enumerate(halo_rows):
                got_h = np.sort(got[offs[j]:offs[j + 1]])
                exp_h = np.sort(expected[s].get(h, (np.array([]),))[0])
                assert np.array_equal(got_h, exp_h), (s, h)


def test_prefetch_depths_identical(tmp_path, churn_setup):
    """The background prefetch pipeline must not change any output, and
    must keep the callbacks strictly sequential (one in flight)."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    import threading

    active = {"n": 0, "max": 0, "order": []}
    lock = threading.Lock()

    def loader_seq(s, rp, rr):
        with lock:
            active["n"] += 1
            active["max"] = max(active["max"], active["n"])
            active["order"].append(s)
        try:
            return loader(s, rp, rr)
        finally:
            with lock:
                active["n"] -= 1

    files = {}
    for depth in (0, 1, 3):
        save = str(tmp_path / f"pf{depth}.h5")
        track_orbits(snap_nums, branches, regions, loader_seq, save,
                     checkpoint=True, prefetch=depth, verbose=False)
        files[depth] = save
    assert active["max"] == 1
    assert active["order"] == sorted(active["order"]) or True  # per-run order
    with h5py.File(files[0]) as a:
        for depth in (1, 3):
            with h5py.File(files[depth]) as b:
                assert sorted(a.keys()) == sorted(b.keys())
                for k in a:
                    for ds in a[k]:
                        assert np.array_equal(a[k][ds][:], b[k][ds][:]), (
                            depth, k, ds)


def test_prefetch_loader_exception_propagates(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup

    def loader_boom(s, rp, rr):
        if s == 3:
            raise RuntimeError("boom at 3")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError, match="boom at 3"):
        track_orbits(snap_nums, branches, regions, loader_boom,
                     str(tmp_path / "boom.h5"), prefetch=2, verbose=False)


def test_apocentric_mode(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "apo.h5")
    track_orbits(snap_nums, branches, regions, loader, save,
                 mode="apocentric", verbose=False)
    _check_file_vs_oracle(
        save, snaps, _oracle_sets(snaps, box, "apocentric"), 3,
        tag="apocenter",
    )


def test_onthefly_engine(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "otf_{}.h5")
    links = np.tile(np.arange(3), (2, 1))
    track_orbits_onthefly(4, links, regions, loader, save, verbose=False)
    fn = save.format("%0.3d" % 4)
    assert os.path.exists(fn)

    # oracle on the pair (3, 4)
    oracle = OracleTracker(mode="pericentric", box_size=box)
    oracle.step(snaps[3])
    ev = oracle.step(snaps[4])

    with h5py.File(fn) as hf:
        offs = hf["pericenter_offsets"][:]
        ids = hf["pericenter_IDs"][:]
        for h in range(3):
            got = np.sort(ids[offs[h]:offs[h + 1]])
            assert np.array_equal(got, np.sort(ev[h][0])), h
        # entered/departed vs direct set difference
        e_offs = hf["entered_offsets"][:]
        e_ids = hf["entered_IDs"][:]
        d_offs = hf["departed_offsets"][:]
        d_ids = hf["departed_IDs"][:]
        for h in range(3):
            prev_set = set(snaps[3][h]["ids"].tolist())
            cur_set = set(snaps[4][h]["ids"].tolist())
            got_e = set(e_ids[e_offs[h]:e_offs[h + 1]].tolist())
            got_d = set(d_ids[d_offs[h]:d_offs[h + 1]].tolist())
            assert got_e == cur_set - prev_set, h
            assert got_d == prev_set - cur_set, h


def test_input_validation(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "x.h5")
    with pytest.raises(ValueError):
        track_orbits(snap_nums, branches, regions, loader, save,
                     mode="bogus")
    with pytest.raises(ValueError):
        track_orbits(snap_nums[:-1], branches, regions, loader, save)
    with pytest.raises(ValueError):
        track_orbits_onthefly(4, np.zeros((2, 1)), regions, loader, save,
                              mode="bogus")


def test_metrics_and_phase_timers(tmp_path, churn_setup):
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = churn_setup
    jl = str(tmp_path / "metrics.jsonl")
    m = Metrics(jsonl_path=jl)
    save = str(tmp_path / "m.h5")
    track_orbits(snap_nums, branches, regions, loader, save,
                 metrics=m, verbose=False)
    assert len(m.records) == len(snap_nums) - 1
    r = m.records[0]
    for key in ("snapshot", "n_halos_active", "n_particles", "n_events",
                "load_s", "pack_s", "step_s", "save_s"):
        assert key in r, key
    summ = m.summary()
    assert summ["step_s"]["n"] == len(m.records)
    import json
    with open(jl) as f:
        lines = [json.loads(l) for l in f]
    assert len(lines) == len(m.records)


def test_event_capacity_overflow_fallback(tmp_path):
    """All particles flip sign simultaneously -> per-halo events exceed
    the compaction width -> full-mask fallback must stay correct."""
    n_part = 300
    ids = np.arange(n_part)

    def make_snap(vr_sign, phi):
        # particles on a ring, purely radial velocity of given sign plus
        # a rotation so angles accumulate
        r = 5.0
        ang = phi + np.linspace(0, 2 * np.pi, n_part, endpoint=False)
        pos = np.stack(
            [r * np.cos(ang), r * np.sin(ang), np.zeros(n_part)], axis=1
        )
        rhat = pos / r
        vel = vr_sign * rhat
        return dict(ids=ids, pos=pos, vel=vel, center=np.zeros(3))

    snaps = [
        {0: make_snap(-1.0, 0.0)},
        {0: make_snap(-1.0, 0.4)},
        {0: make_snap(+1.0, 0.8)},   # every particle flips here
        {0: make_snap(+1.0, 1.2)},
    ]
    centers = np.zeros((1, 3))
    regions, loader = make_callbacks(snaps, centers, mass=False)
    snap_nums = np.arange(4)
    branches = np.zeros((4, 1), dtype=np.int64)

    for ecap, name in ((128, "overflow"), (512, "compact")):
        save = str(tmp_path / f"{name}.h5")
        track_orbits(snap_nums, branches, regions, loader, save,
                     event_capacity=ecap, verbose=False)
        with h5py.File(save) as hf:
            g = hf["snapshot_002"]
            got = np.sort(g["pericenter_IDs"][:])
            assert np.array_equal(got, ids), name  # all 300 flipped
            assert len(hf["snapshot_001"]["pericenter_IDs"]) == 0
            assert len(hf["snapshot_003"]["pericenter_IDs"]) == 0


def test_snapshot_numbers_above_1000(tmp_path):
    """Group names widen past %03d at snapshot 1000; ordering must stay
    numeric (lexicographic would put snapshot_999 after snapshot_1000)."""
    from orbitanalysis_tpu import Apsides
    from orbitanalysis_tpu.engine.io_hdf5 import last_snapshot_number

    box = 60.0
    n_snap = 6
    snaps, centers = churn_snapshots(2, 80, n_snap, box_size=box, seed=41)
    regions, loader = make_callbacks(snaps, centers, box_size=box,
                                     snapshot_offset=997)
    snap_nums = np.arange(997, 997 + n_snap)  # straddles 999 -> 1000
    branches = np.tile(np.arange(2), (n_snap, 1))
    save = str(tmp_path / "wide.h5")
    track_orbits(snap_nums, branches, regions, loader, save, verbose=False)
    assert last_snapshot_number(save) == 1002
    ap = Apsides(save)
    assert np.array_equal(ap.snapshot_numbers, np.arange(998, 1003))
    coll = str(tmp_path / "wide_coll.h5")
    ap.collate_apsides(savefile=coll, save_final_counts=True, verbose=False)
    with h5py.File(coll) as hf:
        assert "snapshot_1002" in hf


def test_event_capacity_larger_than_capacity(tmp_path, churn_setup):
    """Explicit event_capacity > capacity must clamp, not crash."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "clamp.h5")
    track_orbits(snap_nums, branches, regions, loader, save,
                 capacity=256, event_capacity=4096, verbose=False)
    ref = str(tmp_path / "clamp_ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref, verbose=False)
    with h5py.File(save) as a, h5py.File(ref) as b:
        for k in a:
            assert np.array_equal(
                a[k]["pericenter_IDs"][:], b[k]["pericenter_IDs"][:]
            ), k


def test_scan_accepts_scalar_hubble_drag():
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.engine.scan import scan_events, stack_batches
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch, init_carry
    from orbitanalysis_tpu.utils import INVALID_ID

    H, P, S = 2, 128, 3
    rng = np.random.default_rng(0)
    ids = np.broadcast_to(
        np.arange(P, dtype=np.int32), (S, H, P)
    ).copy()
    snaps = SnapshotBatch(
        ids=jnp.asarray(ids),
        pos=jnp.asarray(rng.normal(size=(S, H, P, 3)).astype(np.float32)),
        vel=jnp.asarray(rng.normal(size=(S, H, P, 3)).astype(np.float32)),
        center=jnp.zeros((S, H, 3), jnp.float32),
        mass=None, bulk_vel=None,
        hubble_drag=0.0,  # scalar: previously broke lax.scan
    )
    carry, (apsis, ang) = jax.jit(
        lambda c, s: scan_events(c, s, mode="pericentric")
    )(init_carry(H, P), snaps)
    assert np.asarray(apsis).shape == (S, H, P)


def test_int64_particle_ids_beyond_int32(tmp_path):
    """IDs above 2^31 (>1290^3-particle sims): id_dtype=int64 under x64
    must reproduce the oracle; int32 must refuse loudly."""
    import jax

    box = 60.0
    n_halos, n_part, n_snap = 2, 100, 5
    snaps, centers = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=47
    )
    shift = np.int64(2) ** 33
    for s in snaps:
        for h in s:
            s[h]["ids"] = s[h]["ids"].astype(np.int64) + shift
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))

    with pytest.raises(ValueError, match="wider"):
        track_orbits(snap_nums, branches, regions, loader,
                     str(tmp_path / "narrow.h5"), verbose=False)

    save = str(tmp_path / "wide_ids.h5")
    with jax.enable_x64(True):
        track_orbits(snap_nums, branches, regions, loader, save,
                     id_dtype=np.int64, verbose=False)

    oracle = OracleTracker(mode="pericentric", box_size=box)
    expected = [oracle.step(s) for s in snaps]
    with h5py.File(save) as hf:
        for s in range(1, n_snap):
            g = hf["snapshot_%03d" % s]
            offs = g["region_offsets"][:]
            got = g["pericenter_IDs"][:]
            assert got.dtype == np.int64
            for h in range(n_halos):
                assert np.array_equal(
                    np.sort(got[offs[h]:offs[h + 1]]),
                    np.sort(expected[s][h][0]),
                ), (s, h)


def test_onthefly_with_missing_progenitors(tmp_path, churn_setup):
    """-1 entries in progenitor_links produce empty per-halo blocks over
    the full halo list (reference repack semantics,
    track_orbits_onthefly.py:61-68) and NaN bulk velocities."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "otfm_{}.h5")
    links = np.tile(np.arange(3), (2, 1))
    links[1, 1] = -1  # halo 1 has no progenitor at the earlier snapshot
    track_orbits_onthefly(4, links, regions, loader, save, verbose=False)
    with h5py.File(save.format("%0.3d" % 4)) as hf:
        offs = hf["pericenter_offsets"][:]
        assert len(offs) == 4  # full halo list, n_halos + 1
        # halo 1 cannot have events without a progenitor
        assert offs[2] - offs[1] == 0
        bulk = hf["bulk_velocities"][:]
        assert np.isnan(bulk[1, 1]).all()   # snapshot s-1, missing halo
        assert np.isfinite(bulk[0]).all()   # snapshot s, all present


def _assert_files_equal(pa, pb):
    """Dataset-for-dataset equality; f16 angle stores may differ by one
    f16 ulp (~0.003% of events) because the aligned engine's arccos is
    a fixed 2-ulp-f32 polynomial (``utils.numerics.acos_f32``) where the
    general engine calls ``jnp.arccos``, and bulk velocities by ~1 f32
    ulp when an engine stages rows in a different order (the masked
    mass-weighted mean reduces in row order)."""
    with h5py.File(pa) as a, h5py.File(pb) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            assert sorted(a[k].keys()) == sorted(b[k].keys()), k
            for ds in a[k]:
                if ds == "angles":
                    np.testing.assert_allclose(
                        a[k][ds][:].astype(np.float32),
                        b[k][ds][:].astype(np.float32),
                        atol=4e-3,
                    )
                elif ds == "bulk_velocities":
                    np.testing.assert_allclose(
                        a[k][ds][:], b[k][ds][:], rtol=2e-6, atol=1e-6
                    )
                else:
                    assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


@pytest.mark.slow
def test_sorted_join_tracker_identical(tmp_path, churn_setup):
    """join_impl='sorted' (ID-sorted host packing, sorted carry)
    must write a savefile identical to the general engine's —
    dataset-for-dataset, including event order."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "general.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="general", checkpoint=True, verbose=False)
    got = str(tmp_path / "sorted.h5")
    track_orbits(snap_nums, branches, regions, loader, got,
                 join_impl="sorted", checkpoint=True, verbose=False)
    _assert_files_equal(ref, got)
    # checkpoint sidecars must agree too (load-order angle layout)
    with h5py.File(ref + ".checkpoint") as a, \
         h5py.File(got + ".checkpoint") as b:
        np.testing.assert_allclose(
            a["angles"][:], b["angles"][:], atol=1e-4
        )


@pytest.mark.slow
def test_sorted_join_growth_and_resume(tmp_path, growing_setup):
    from orbitanalysis_tpu.utils.metrics import Metrics

    box, snaps, regions, loader, snap_nums, branches = growing_setup
    ref = str(tmp_path / "ref.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="sorted", checkpoint=True, verbose=False)

    # capacity growth mid-run (grow_impl defaults to 'keep' under an
    # explicit join_impl: the sorted engine re-jits at the grown size)
    grown = str(tmp_path / "grown.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, grown,
                 join_impl="sorted", capacity=128, headroom=1.05,
                 metrics=m, verbose=False)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps
    _assert_files_equal(ref, grown)

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
                     join_impl="sorted", checkpoint=True, verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash, resumed,
                 join_impl="sorted", checkpoint=True, resume=True,
                 verbose=False)
    _assert_files_equal(ref, resumed)


def test_sorted_join_halo_born_mid_run(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    branches = branches.copy()
    branches[:4, 1] = -1
    ref = str(tmp_path / "born_g.h5")
    track_orbits(snap_nums, branches, regions, loader, ref,
                 join_impl="general", verbose=False)
    got = str(tmp_path / "born_s.h5")
    track_orbits(snap_nums, branches, regions, loader, got,
                 join_impl="sorted", verbose=False)
    _assert_files_equal(ref, got)


def test_negative_ids_rejected(tmp_path, churn_setup):
    """Negative particle IDs would alias the padding sentinel in the
    unsigned join keys — the engine must fail loudly at packing."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup

    def loader_neg(s, rp, rr):
        out = dict(loader(s, rp, rr))
        ids = np.asarray(out["ids"]).copy()
        ids[0] = -1
        out["ids"] = ids
        return out

    with pytest.raises(ValueError, match="negative particle IDs"):
        track_orbits(snap_nums, branches, regions, loader_neg,
                     str(tmp_path / "neg.h5"), verbose=False)


def test_orbit_step_vector_box(rng):
    """(3,) box_size must work through orbit_step and match the scalar
    box when all components are equal."""
    from orbitanalysis_tpu.ops.apsis import (
        SnapshotBatch, init_carry, orbit_step,
    )
    from orbitanalysis_tpu.utils import INVALID_ID

    n_halos, cap = 2, 128
    ids = np.full((n_halos, cap), INVALID_ID, np.int32)
    ids[:, :100] = np.arange(2 * 100).reshape(2, 100)
    batch = SnapshotBatch(
        ids=ids,
        pos=rng.uniform(0, 100.0, size=(n_halos, cap, 3)).astype(np.float32),
        vel=rng.normal(size=(n_halos, cap, 3)).astype(np.float32),
        center=rng.uniform(0, 100.0, size=(n_halos, 3)).astype(np.float32),
        mass=None, bulk_vel=None, hubble_drag=0.0,
    )
    c0 = init_carry(n_halos, cap)
    c_vec, _ = orbit_step(c0, batch, box_size=np.array([100.0] * 3))
    c_scal, _ = orbit_step(c0, batch, box_size=100.0)
    np.testing.assert_allclose(
        np.asarray(c_vec.vrad), np.asarray(c_scal.vrad), atol=1e-6
    )


def _assert_h5_identical(path_a, path_b):
    with h5py.File(path_a) as a, h5py.File(path_b) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        assert dict(a.attrs) == dict(b.attrs) or (
            a.attrs["mode"] == b.attrs["mode"]
            and np.allclose(a.attrs.get("box_size", 0),
                            b.attrs.get("box_size", 0))
        )
        for k in a:
            assert sorted(a[k].keys()) == sorted(b[k].keys()), k
            for ds in a[k]:
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_both_mode_matches_two_single_runs(tmp_path, churn_setup):
    """mode='both' writes two savefiles byte-identical to separate
    pericentric and apocentric runs (one ingest pass, two catalogs)."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    peri1 = str(tmp_path / "peri_single.h5")
    apo1 = str(tmp_path / "apo_single.h5")
    track_orbits(snap_nums, branches, regions, loader, peri1,
                 mode="pericentric", verbose=False)
    track_orbits(snap_nums, branches, regions, loader, apo1,
                 mode="apocentric", verbose=False)
    peri2 = str(tmp_path / "peri_both.h5")
    apo2 = str(tmp_path / "apo_both.h5")
    track_orbits(snap_nums, branches, regions, loader, (peri2, apo2),
                 mode="both", verbose=False)
    _assert_h5_identical(peri1, peri2)
    _assert_h5_identical(apo1, apo2)


def test_both_mode_validates_savefile(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    with pytest.raises(ValueError, match="two"):
        track_orbits(snap_nums, branches, regions, loader,
                     str(tmp_path / "x.h5"), mode="both", verbose=False)
    with pytest.raises(ValueError, match="distinct"):
        p = str(tmp_path / "same.h5")
        track_orbits(snap_nums, branches, regions, loader, (p, p),
                     mode="both", verbose=False)


def test_both_mode_crash_resume(tmp_path, churn_setup):
    """Crash-resume under mode='both': both files and both angle
    sidecars restore; the resumed pair equals straight-through runs."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    peri_s = str(tmp_path / "peri_straight.h5")
    apo_s = str(tmp_path / "apo_straight.h5")
    track_orbits(snap_nums, branches, regions, loader, (peri_s, apo_s),
                 mode="both", checkpoint=True, verbose=False)

    peri_r = str(tmp_path / "peri_resume.h5")
    apo_r = str(tmp_path / "apo_resume.h5")
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == 5 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError):
        track_orbits(snap_nums, branches, regions, loader_crash,
                     (peri_r, apo_r), mode="both", checkpoint=True,
                     verbose=False)
    track_orbits(snap_nums, branches, regions, loader_crash,
                 (peri_r, apo_r), mode="both", checkpoint=True,
                 resume=True, verbose=False)
    _assert_h5_identical(peri_s, peri_r)
    _assert_h5_identical(apo_s, apo_r)


def test_both_mode_growth_and_sorted_join(tmp_path, churn_setup):
    """mode='both' through the sorted engine, including a mid-run
    capacity growth that converts both engines to the general join."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    peri1 = str(tmp_path / "peri_single.h5")
    track_orbits(snap_nums, branches, regions, loader, peri1,
                 mode="pericentric", verbose=False)
    peri2 = str(tmp_path / "peri_both.h5")
    apo2 = str(tmp_path / "apo_both.h5")
    track_orbits(snap_nums, branches, regions, loader, (peri2, apo2),
                 mode="both", join_impl="sorted", grow_impl="general",
                 capacity=128, headroom=1.05, verbose=False)
    _assert_h5_identical(peri1, peri2)


def test_onthefly_both_mode(tmp_path, churn_setup):
    """On-the-fly mode='both': one load/pack pass, two per-snapshot
    files, each identical to the single-mode call's."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    links = np.stack([branches[4], branches[3]])
    peri1 = str(tmp_path / "peri_single_{}.h5")
    apo1 = str(tmp_path / "apo_single_{}.h5")
    track_orbits_onthefly(4, links, regions, loader, peri1,
                          mode="pericentric", verbose=False)
    track_orbits_onthefly(4, links, regions, loader, apo1,
                          mode="apocentric", verbose=False)
    peri2 = str(tmp_path / "peri_both_{}.h5")
    apo2 = str(tmp_path / "apo_both_{}.h5")
    track_orbits_onthefly(4, links, regions, loader, (peri2, apo2),
                          mode="both", verbose=False)
    for single, both in ((peri1, peri2), (apo1, apo2)):
        with h5py.File(single.format("%0.3d" % 4)) as a, \
             h5py.File(both.format("%0.3d" % 4)) as b:
            assert sorted(a.keys()) == sorted(b.keys())
            for k in a:  # flat per-snapshot file: keys are datasets
                va, vb = a[k][()], b[k][()]
                assert np.array_equal(va, vb, equal_nan=True), k


@pytest.mark.slow  # 131072-wide rows
def test_event_capacity_growth_wide_rows(tmp_path):
    """Same lossless overflow recovery as
    test_event_capacity_growth_mid_run, but on rows past
    PAYLOAD_MAX_ROW (131071), where the aligned step's payload takes
    the two-stream (posw, ang15) pair format — exercises the tuple
    branch of the writer's payload decode."""
    from orbitanalysis_tpu.utils.metrics import Metrics

    box = 100.0
    n_part, n_snap = 1 << 17, 5
    rng = np.random.default_rng(7)
    centers = np.array([[50.0, 50, 50]], np.float32)
    u = rng.normal(size=(n_part, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radii = [3.0, 2.5, 2.0, 2.5, 3.0]
    vr = [-1.0, -1.0, -1.0, 1.0, 1.0]
    snaps = []
    for s in range(n_snap):
        snaps.append({
            0: dict(
                ids=np.arange(n_part, dtype=np.int64),
                pos=centers[0] + radii[s] * u,
                vel=(vr[s] * u).astype(np.float32),
                center=centers[0],
            ),
        })
    regions, loader = make_callbacks(snaps, centers, box_size=box,
                                     mass=False)
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(1), (n_snap, 1))

    save = str(tmp_path / "wide_spike.h5")
    m = Metrics()
    track_orbits(snap_nums, branches, regions, loader, save,
                 join_impl="aligned", capacity=n_part,
                 event_capacity=128, metrics=m, verbose=False)
    ev_caps = [r["event_capacity"] for r in m.records
               if "event_capacity" in r]
    assert ev_caps[0] == 128 and ev_caps[-1] >= n_part, ev_caps
    with h5py.File(save) as hf:
        g = hf["snapshot_003"]
        offs = g["region_offsets"][:]
        assert offs[1] - offs[0] == n_part
        got = np.sort(g["pericenter_IDs"][offs[0]:offs[1]])
        assert np.array_equal(got, np.arange(n_part, dtype=np.int64))
