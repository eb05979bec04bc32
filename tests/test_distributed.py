"""Distributed tier (SURVEY.md §4): multi-device mesh sharding on the
virtual 8-device CPU mesh — sharded results must equal single-device
results (the analogue of the reference's pooled-vs-serial equivalence,
``track_orbits.py:189-194``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.ops.apsis import SnapshotBatch, init_carry, make_orbit_step
from orbitanalysis_tpu.parallel import make_mesh, shard_tree, tree_sharding_specs
from orbitanalysis_tpu.utils import INVALID_ID, pack_ragged, round_up

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _random_batch(rng, n_halos, cap, n_valid):
    ids = np.full((n_halos, cap), INVALID_ID, np.int32)
    for h in range(n_halos):
        ids[h, :n_valid] = rng.choice(10 * cap, size=n_valid, replace=False)
    return SnapshotBatch(
        ids=ids,
        pos=rng.normal(size=(n_halos, cap, 3)).astype(np.float32),
        vel=rng.normal(size=(n_halos, cap, 3)).astype(np.float32),
        center=rng.normal(size=(n_halos, 3)).astype(np.float32),
        mass=None,
        bulk_vel=None,
        hubble_drag=np.float32(0.0),
    )


@pytest.mark.parametrize(
    "axes", [{"halos": 8}, {"halos": 4, "particles": 2}, {"halos": 2, "particles": 4}]
)
def test_sharded_step_equals_single_device(rng, axes):
    n_halos, cap, n_valid = 8, 256, 200
    step_raw = make_orbit_step(mode="pericentric", box_size=100.0)

    b1 = _random_batch(rng, n_halos, cap, n_valid)
    b2 = _random_batch(rng, n_halos, cap, n_valid)
    # overlap some ids between the two snapshots so matches occur
    b2.ids[:, :100] = b1.ids[:, 50:150]

    # single device reference
    carry = init_carry(n_halos, cap)
    c1, _ = jax.jit(step_raw)(carry, b1)
    c2, ev = jax.jit(step_raw)(c1, b2)
    ref = jax.device_get((c2, ev))

    # sharded
    mesh = make_mesh(axes)
    carry_s = shard_tree(init_carry(n_halos, cap), mesh)
    b1_s = shard_tree(b1, mesh)
    b2_s = shard_tree(b2, mesh)
    specs = tree_sharding_specs((carry_s, b1_s), mesh)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
    step_j = jax.jit(step_raw, in_shardings=shardings)
    c1_s, _ = step_j(carry_s, b1_s)
    c2_s, ev_s = step_j(c1_s, b2_s)
    got = jax.device_get((c2_s, ev_s))

    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert np.allclose(a, b, atol=1e-6), "sharded != single-device"


def test_scan_events_sharded(rng):
    """The scan driver under a halo-sharded mesh."""
    from orbitanalysis_tpu.engine.scan import scan_events

    n_halos, cap, n_valid, n_snap = 8, 256, 180, 4
    batches = [_random_batch(rng, n_halos, cap, n_valid) for _ in range(n_snap)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)

    carry = init_carry(n_halos, cap)
    fn = lambda c, s: scan_events(c, s, mode="pericentric", box_size=100.0)
    ref = jax.device_get(jax.jit(fn)(carry, stacked))

    mesh = make_mesh({"halos": 8})
    carry_s = shard_tree(init_carry(n_halos, cap), mesh)
    got = jax.device_get(jax.jit(fn)(carry_s, shard_tree_snaps(stacked, mesh)))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert np.allclose(a, b, atol=1e-6)


def shard_tree_snaps(stacked, mesh):
    """Shard a stacked SnapshotBatch: axis 0 is the snapshot axis
    (replicated), halos on axis 1."""
    from jax.sharding import PartitionSpec as P

    def spec(leaf):
        ndim = np.ndim(leaf)
        if ndim <= 1:
            return P()
        return P(None, "halos")

    return jax.tree.map(
        lambda leaf: jax.device_put(
            leaf, NamedSharding(mesh, spec(leaf))
        ),
        stacked,
    )


def test_tracker_with_mesh(rng, tmp_path):
    """track_orbits(mesh=...) end-to-end equals the unsharded run."""
    import h5py

    from orbitanalysis_tpu import track_orbits
    from helpers import make_callbacks

    box = 60.0
    snaps, centers = churn_snapshots(4, 120, 6, box_size=box, seed=21)
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(6)
    branches = np.tile(np.arange(4), (6, 1))

    plain = str(tmp_path / "plain.h5")
    track_orbits(snap_nums, branches, regions, loader, plain, verbose=False)

    mesh = make_mesh({"halos": 4})
    sharded = str(tmp_path / "sharded.h5")
    track_orbits(snap_nums, branches, regions, loader, sharded,
                 mesh=mesh, verbose=False)

    with h5py.File(plain) as a, h5py.File(sharded) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                if ds == "angles":
                    # sharded compilation fuses the f32 arccos chain
                    # differently; ill-conditioning near cos=1 shows up
                    # as last-ulp differences at the f16 store boundary
                    assert np.allclose(
                        a[k][ds][:].astype(np.float32),
                        b[k][ds][:].astype(np.float32),
                        atol=2e-3,
                    ), (k, ds)
                else:
                    assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_tracker_with_mesh_sorted_join(rng, tmp_path):
    """track_orbits(mesh=..., join_impl='sorted') — the halo-sharded
    sorted engine — matches the unsharded general engine's savefile."""
    import h5py

    from orbitanalysis_tpu import track_orbits
    from helpers import make_callbacks

    box = 60.0
    snaps, centers = churn_snapshots(4, 120, 6, box_size=box, seed=22)
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    snap_nums = np.arange(6)
    branches = np.tile(np.arange(4), (6, 1))

    plain = str(tmp_path / "plain.h5")
    track_orbits(snap_nums, branches, regions, loader, plain,
                 join_impl="general", verbose=False)

    mesh = make_mesh({"halos": 4})
    sharded = str(tmp_path / "sharded.h5")
    track_orbits(snap_nums, branches, regions, loader, sharded,
                 mesh=mesh, join_impl="sorted", verbose=False)

    with h5py.File(plain) as a, h5py.File(sharded) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                if ds == "angles":
                    # compare at f16-store resolution
                    assert np.allclose(
                        a[k][ds][:].astype(np.float32),
                        b[k][ds][:].astype(np.float32),
                        atol=2e-3,
                    ), (k, ds)
                elif ds == "bulk_velocities":
                    # ID-sorted staging sums the masked mean in a
                    # different order: last-ulp f32 differences
                    assert np.allclose(
                        a[k][ds][:], b[k][ds][:], atol=1e-5
                    ), (k, ds)
                else:
                    assert np.array_equal(a[k][ds][:], b[k][ds][:]), (k, ds)


def test_tracker_sorted_join_rejects_particle_axis(rng, tmp_path):
    from orbitanalysis_tpu import track_orbits
    from helpers import make_callbacks

    snaps, centers = churn_snapshots(4, 60, 2, box_size=60.0, seed=23)
    regions, loader = make_callbacks(snaps, centers, box_size=60.0)
    mesh = make_mesh({"halos": 4, "particles": 2})
    with pytest.raises(ValueError, match="halo axis only"):
        track_orbits(np.arange(2), np.tile(np.arange(4), (2, 1)),
                     regions, loader, str(tmp_path / "x.h5"),
                     mesh=mesh, join_impl="sorted", verbose=False)


def test_sharded_nbody_forces_and_sim(rng):
    """shard_map particle-axis forces == single device, free + periodic,
    and the fused integrator matches exactly in counts."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models.nbody import (
        NBodyState, OrbitNBodyConfig, direct_forces, simulate_with_tracking,
    )
    from orbitanalysis_tpu.parallel.nbody_sharded import (
        make_sharded_direct_force_fn,
    )

    n = 512
    pos = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    mesh = make_mesh({"particles": 8})
    f = make_sharded_direct_force_fn(mesh)

    a1 = np.asarray(jax.jit(lambda p, m: f(p, m, softening=0.1))(pos, mass))
    a2 = np.asarray(
        jax.jit(lambda p, m: direct_forces(p, m, softening=0.1))(pos, mass)
    )
    rel = np.abs(a1 - a2) / (np.linalg.norm(a2, axis=1, keepdims=True) + 1e-3)
    assert rel.max() < 1e-4

    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(dt=0.02, n_steps=15, detect_every=3, softening=0.1)
    st = NBodyState(
        pos, jnp.asarray(rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)),
        mass,
    )
    _, tr, _ = simulate_with_tracking(st, members, cfg, force_fn=f)
    _, tr2, _ = simulate_with_tracking(
        st, members, cfg,
        force_fn=lambda p, m, **kw: direct_forces(p, m, **kw),
    )
    assert np.array_equal(np.asarray(tr.counts), np.asarray(tr2.counts))


@pytest.mark.slow
def test_sharded_sorted_step_equals_single_device(rng):
    """Halo-sharded sorted step (shard_map over the halo axis) must
    reproduce the unsharded step exactly."""
    from orbitanalysis_tpu.ops.sorted_step import (
        init_sorted_carry,
        make_sorted_orbit_step,
    )
    from orbitanalysis_tpu.parallel.sorted_sharded import (
        make_sharded_sorted_step,
    )

    n_halos, cap, K = 8, 128, 128
    mesh = make_mesh({"halos": 8})
    step = jax.jit(make_sorted_orbit_step(K))
    sstep = jax.jit(make_sharded_sorted_step(mesh, K))

    carry_a = init_sorted_carry(n_halos, cap)
    carry_b = shard_tree(init_sorted_carry(n_halos, cap), mesh)
    for i in range(4):
        batch = _random_batch(rng, n_halos, cap, 100 - 7 * i)
        carry_a, ev_a = step(carry_a, batch)
        carry_b, ev_b = sstep(carry_b, shard_tree(batch, mesh))
        np.testing.assert_array_equal(
            np.asarray(ev_a.count), np.asarray(ev_b.count)
        )
        np.testing.assert_array_equal(
            np.asarray(ev_a.ids), np.asarray(ev_b.ids)
        )
        np.testing.assert_array_equal(
            np.asarray(carry_a.ids), np.asarray(carry_b.ids)
        )
        np.testing.assert_allclose(
            np.asarray(carry_a.angles), np.asarray(carry_b.angles),
            atol=1e-6,
        )


def test_sharded_sorted_step_rejects_particle_axis():
    from orbitanalysis_tpu.parallel.sorted_sharded import (
        make_sharded_sorted_step,
    )

    mesh = make_mesh({"halos": 4, "particles": 2})
    with pytest.raises(ValueError):
        make_sharded_sorted_step(mesh, 128)
