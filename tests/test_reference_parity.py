"""Golden parity vs the actual reference implementation.

Runs the real ``orbitanalysis`` package from ``/root/reference`` (serial
path; its ``pathos`` dependency is stubbed since the pool is unused with
``npool=None``) and this framework on identical synthetic data, then
compares the savefiles dataset-for-dataset and the collated catalogs.
This is the strongest drop-in-compatibility evidence: same inputs, same
files, same counts.
"""

import sys
import types

import h5py
import numpy as np
import pytest

from orbitanalysis_tpu import track_orbits as track_orbits_pkg
from orbitanalysis_tpu import Apsides as ApsidesPkg
from orbitanalysis_tpu.models.synthetic import churn_snapshots

from helpers import make_callbacks


@pytest.fixture(scope="module")
def reference_pkg():
    if "pathos" not in sys.modules:
        pathos = types.ModuleType("pathos")
        mp = types.ModuleType("pathos.multiprocessing")
        class _SerialPool:  # drop-in for the serial test path
            def __init__(self, n=None):
                pass

            def map(self, f, xs):
                return list(map(f, xs))

        mp.Pool = _SerialPool
        pathos.multiprocessing = mp
        sys.modules["pathos"] = pathos
        sys.modules["pathos.multiprocessing"] = mp
    sys.path.insert(0, "/root/reference")
    try:
        from orbitanalysis.track_orbits import track_orbits
        from orbitanalysis.postprocessing import Apsides
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference not importable: {e}")
    finally:
        sys.path.remove("/root/reference")
    return track_orbits, Apsides


@pytest.fixture(scope="module")
def data():
    box = 60.0
    n_halos, n_part, n_snap = 3, 150, 8
    snaps, centers = churn_snapshots(
        n_halos, n_part, n_snap, box_size=box, seed=23
    )
    # mild Hubble rate: exercises the H*r/(1+z) term without swamping
    # the ~unit peculiar velocities (a realistic H0 with these synthetic
    # units would suppress every radial-velocity sign flip)
    cosmo = dict(redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
    regions2, loader = make_callbacks(
        snaps, centers, box_size=box, cosmology=cosmo
    )

    def regions3(snapshot_number, halo_ids):
        pos, rad = regions2(snapshot_number, halo_ids)
        return pos, rad, None  # reference unpacks three values

    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))
    return regions3, loader, snap_nums, branches


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory, reference_pkg, data):
    track_ref, Apsides_ref = reference_pkg
    regions3, loader, snap_nums, branches = data
    tmp = tmp_path_factory.mktemp("refpar")
    ref_save = str(tmp / "ref.h5")
    pkg_save = str(tmp / "pkg.h5")
    track_ref(snap_nums, branches, regions3, loader, ref_save,
              mode="pericentric", npool=None, verbose=False)
    track_orbits_pkg(snap_nums, branches, regions3, loader, pkg_save,
                     mode="pericentric", verbose=False)
    return ref_save, pkg_save, str(tmp), Apsides_ref


def test_savefile_schema_and_ids_match(both_runs):
    ref_save, pkg_save, _, _ = both_runs
    with h5py.File(ref_save) as a, h5py.File(pkg_save) as b:
        total_events = sum(
            len(a[k]["pericenter_IDs"]) for k in a if k.startswith("snap")
        )
        assert total_events > 50, "degenerate test data: no events"
        assert sorted(a.keys()) == sorted(b.keys())
        assert a.attrs["mode"] == b.attrs["mode"]
        assert np.isclose(a.attrs["box_size"], b.attrs["box_size"])
        for k in a:
            assert sorted(a[k].keys()) == sorted(b[k].keys()), k
            for ds in a[k]:
                av, bv = a[k][ds][:], b[k][ds][:]
                assert av.shape == bv.shape, (k, ds)
                if ds == "angles":
                    assert av.dtype == bv.dtype == np.float16
                    # reference accumulates the angle carry in float16
                    # (track_orbits.py:351), we accumulate in float32 and
                    # round at the store; agreement is to f16 resolution
                    assert np.allclose(
                        av.astype(np.float32), bv.astype(np.float32),
                        atol=4e-3,
                    ), (k, ds)
                elif ds == "bulk_velocities":
                    assert np.allclose(av, bv, rtol=1e-5, atol=1e-5)
                else:
                    assert np.array_equal(av, bv), (k, ds)


def test_collation_matches_reference(both_runs):
    ref_save, pkg_save, tmp, Apsides_ref = both_runs
    ref_coll = tmp + "/ref_coll.h5"
    pkg_coll = tmp + "/pkg_coll.h5"
    Apsides_ref(ref_save).collate_apsides(
        savefile=ref_coll, verbose=False
    )
    ApsidesPkg(pkg_save).collate_apsides(
        savefile=pkg_coll, verbose=False
    )
    with h5py.File(ref_coll) as a, h5py.File(pkg_coll) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in ("particle_IDs", "pericenter_counts", "halo_offsets",
                       "halo_IDs"):
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_collation_subset_and_midpoint_matches_reference(both_runs):
    """collate_apsides with an explicit halo_ids subset and a
    mid-sequence snapshot_number — the non-default arguments."""
    ref_save, pkg_save, tmp, Apsides_ref = both_runs
    import h5py as h5

    with h5.File(ref_save) as hf:
        keys = sorted(k for k in hf if k.startswith("snapshot_"))
        mid_snap = int(keys[len(keys) // 2].split("_")[1])

    ref_coll = tmp + "/ref_sub.h5"
    pkg_coll = tmp + "/pkg_sub.h5"
    subset = np.array([0, 2])
    Apsides_ref(ref_save).collate_apsides(
        halo_ids=subset, snapshot_number=mid_snap,
        angle_cut=0.05, savefile=ref_coll, verbose=False,
    )
    ApsidesPkg(pkg_save).collate_apsides(
        halo_ids=subset, snapshot_number=mid_snap,
        angle_cut=0.05, savefile=pkg_coll, verbose=False,
    )
    with h5.File(ref_coll) as a, h5.File(pkg_coll) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in ("particle_IDs", "pericenter_counts",
                       "halo_offsets", "halo_IDs"):
                assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_final_counts_retro_matches_reference(both_runs):
    """save_final_counts retro-mapping parity (values; dtype is a
    documented improvement — the reference stores float64 counts)."""
    ref_save, pkg_save, tmp, Apsides_ref = both_runs
    import h5py as h5

    ref_coll = tmp + "/ref_fin.h5"
    pkg_coll = tmp + "/pkg_fin.h5"
    Apsides_ref(ref_save).collate_apsides(
        save_final_counts=True, savefile=ref_coll, verbose=False
    )
    ApsidesPkg(pkg_save).collate_apsides(
        save_final_counts=True, savefile=pkg_coll, verbose=False
    )
    with h5.File(ref_coll) as a, h5.File(pkg_coll) as b:
        for k in sorted(a.keys())[:-1]:
            av = a[k]["pericenter_counts_final"][:]
            bv = b[k]["pericenter_counts_final"][:]
            assert np.array_equal(
                av.astype(np.int64), bv.astype(np.int64)
            ), k


def test_apocentric_mode_matches_reference(reference_pkg, data,
                                           tmp_path_factory):
    track_ref, _ = reference_pkg
    regions3, loader, snap_nums, branches = data
    tmp = tmp_path_factory.mktemp("apo")
    ref_save = str(tmp / "ref.h5")
    pkg_save = str(tmp / "pkg.h5")
    track_ref(snap_nums, branches, regions3, loader, ref_save,
              mode="apocentric", npool=None, verbose=False)
    track_orbits_pkg(snap_nums, branches, regions3, loader, pkg_save,
                     mode="apocentric", verbose=False)
    with h5py.File(ref_save) as a, h5py.File(pkg_save) as b:
        assert a.attrs["mode"] == b.attrs["mode"] == "apocentric"
        for k in a:
            assert np.array_equal(
                a[k]["apocenter_IDs"][:], b[k]["apocenter_IDs"][:]
            ), k
            assert np.array_equal(
                a[k]["region_offsets"][:], b[k]["region_offsets"][:]
            ), k


def test_onthefly_matches_reference(reference_pkg, data, tmp_path_factory):
    """The on-the-fly engine vs the real reference on one snapshot pair:
    same datasets, same per-halo apsis/entered/departed ID sets."""
    import sys

    sys.path.insert(0, "/root/reference")
    try:
        from orbitanalysis.track_orbits_onthefly import (
            track_orbits as otf_ref,
        )
    finally:
        sys.path.remove("/root/reference")

    from orbitanalysis_tpu import track_orbits_onthefly as otf_pkg

    regions3, loader, snap_nums, branches = data

    def regions2(s, hids):  # the on-the-fly engines use the 2-tuple form
        return regions3(s, hids)[:2]

    links = np.tile(np.arange(3), (2, 1))
    tmp = tmp_path_factory.mktemp("otf")
    ref_save = str(tmp / "ref_{}.h5")
    pkg_save = str(tmp / "pkg_{}.h5")
    snap = 4
    otf_ref(snap, links, regions2, loader, ref_save, verbose=False)
    otf_pkg(snap, links, regions2, loader, pkg_save, verbose=False)

    fa = ref_save.format("%0.3d" % snap)
    fb = pkg_save.format("%0.3d" % snap)
    with h5py.File(fa) as a, h5py.File(fb) as b:
        for tag in ("pericenter", "entered", "departed"):
            offs_a = a[f"{tag}_offsets"][:]
            offs_b = b[f"{tag}_offsets"][:]
            ids_a = a[f"{tag}_IDs"][:]
            ids_b = b[f"{tag}_IDs"][:]
            assert len(offs_a) == len(offs_b), tag
            for h in range(len(offs_a) - 1):
                assert np.array_equal(
                    np.sort(ids_a[offs_a[h]:offs_a[h + 1]]),
                    np.sort(ids_b[offs_b[h]:offs_b[h + 1]]),
                ), (tag, h)
        assert np.array_equal(
            a["progenitor_links"][:], b["progenitor_links"][:]
        )
        assert np.allclose(
            a["region_radii"][:], b["region_radii"][:]
        )
