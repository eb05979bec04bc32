"""Model tier: the native on-device leapfrog/KDK integrator with fused orbit
detection (BASELINE.json configs[3]; SURVEY.md §7 step 8)."""

import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu.models.nbody import (
    NBodyState,
    OrbitNBodyConfig,
    direct_forces,
    kdk_step,
    point_mass_forces,
    simulate_with_tracking,
    total_energy,
)
from orbitanalysis_tpu.models.synthetic import kepler_ensemble


def test_direct_forces_match_numpy(rng):
    n = 32
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    eps = 0.1
    acc = np.asarray(direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                   softening=eps))
    # O(N^2) reference
    expect = np.zeros((n, 3))
    for i in range(n):
        dx = pos - pos[i]
        d2 = (dx**2).sum(-1) + eps**2
        w = mass / d2**1.5
        expect[i] = (w[:, None] * dx).sum(0)
    assert np.allclose(acc, expect, rtol=2e-4, atol=2e-4)


def test_direct_forces_periodic_minimum_image(rng):
    n, box = 16, 10.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    mass = np.ones(n, np.float32)
    acc = np.asarray(direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                   softening=0.2, box_size=box))
    expect = np.zeros((n, 3))
    for i in range(n):
        dx = pos - pos[i]
        dx -= box * np.round(dx / box)
        d2 = (dx**2).sum(-1) + 0.04
        w = mass / d2**1.5
        expect[i] = (w[:, None] * dx).sum(0)
    assert np.allclose(acc, expect, rtol=2e-4, atol=2e-4)


def test_kdk_energy_conservation(rng):
    """Plummer-ish cluster: leapfrog conserves energy to O(dt^2)."""
    n = 64
    pos = rng.normal(scale=1.0, size=(n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    state = NBodyState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass))
    eps = 0.2
    e0 = float(total_energy(state, softening=eps))
    acc = direct_forces(state.pos, state.mass, softening=eps)
    for _ in range(200):
        state, acc = kdk_step(state, acc, 0.01, direct_forces, softening=eps)
    e1 = float(total_energy(state, softening=eps))
    assert abs(e1 - e0) / abs(e0) < 2e-3


def test_tracking_counts_kepler():
    """Integrate analytic Kepler initial conditions with the point-mass
    field; fused detection must reproduce closed-form pericenter counts."""
    n_part = 64
    probe = kepler_ensemble(n_part, 2, e_range=(0.05, 0.5), seed=3)
    t_total = 2.2 * float(probe.period.max())
    # same seed => same orbital elements; dt picks the evaluation time
    ens = kepler_ensemble(n_part, 2, e_range=(0.05, 0.5), seed=3, dt=t_total)
    expected = ens.peri_counts[1]

    n_steps = 4000
    dt = t_total / n_steps
    state = NBodyState(
        pos=jnp.asarray(ens.positions[0].astype(np.float32)),
        vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
        mass=jnp.full((n_part,), 1e-12, jnp.float32),  # test particles
    )
    members = jnp.arange(n_part, dtype=jnp.int32).reshape(1, n_part)
    cfg = OrbitNBodyConfig(
        dt=dt, n_steps=n_steps, detect_every=10, mode="pericentric",
        softening=0.0, G=1.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    _, track, events = simulate_with_tracking(
        state, members, cfg, force_fn=point_mass_forces(GM=1.0)
    )
    counts = np.asarray(track.counts)[0]

    # integration + boundary effects may shift a passage that lands within
    # one detection interval of t=0 or t=t_total; allow a count of +-1 on
    # at most a couple of particles
    diff = counts - expected
    assert np.abs(diff).max() <= 1
    assert (diff != 0).sum() <= 3, (counts, expected)
    assert int(np.asarray(events).sum()) == counts.sum()


def test_tracking_matches_offline_step_on_snapshots():
    """Detection inside the integrator equals feeding the integrator's
    snapshots through the general offline step (static membership)."""
    import jax

    from orbitanalysis_tpu.ops.apsis import (
        SnapshotBatch, init_carry, make_orbit_step,
    )
    from orbitanalysis_tpu.utils import INVALID_ID, round_up

    n_part = 32
    ens = kepler_ensemble(n_part, 2, seed=9)
    state = NBodyState(
        pos=jnp.asarray(ens.positions[0].astype(np.float32)),
        vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
        mass=jnp.full((n_part,), 1e-12, jnp.float32),
    )
    members = jnp.arange(n_part, dtype=jnp.int32).reshape(1, n_part)
    dt = 0.02 * float(ens.period.min())
    n_steps = 400
    detect_every = 5
    cfg = OrbitNBodyConfig(
        dt=dt, n_steps=n_steps, detect_every=detect_every,
        mode="pericentric", softening=0.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    _, track, _ = simulate_with_tracking(
        state, members, cfg, force_fn=point_mass_forces(GM=1.0)
    )

    # replay: integrate identically, dump positions at detection cadence,
    # run the general offline step on the dumps with a pinned zero center
    from orbitanalysis_tpu.models.nbody import (
        detect_apsides_static, kdk_step,  # noqa: F401
    )
    force = point_mass_forces(GM=1.0)
    st = state
    acc = force(st.pos, st.mass)
    cap = round_up(n_part)
    ids = np.full((1, cap), INVALID_ID, np.int32)
    ids[0, :n_part] = np.arange(n_part)
    step = jax.jit(make_orbit_step(mode="pericentric"))
    carry = init_carry(1, cap)
    counts = np.zeros(n_part, np.int64)

    def feed(st):
        pos = np.zeros((1, cap, 3), np.float32)
        vel = np.zeros((1, cap, 3), np.float32)
        pos[0, :n_part] = np.asarray(st.pos)
        vel[0, :n_part] = np.asarray(st.vel)
        return SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=np.zeros((1, 3), np.float32),
            bulk_vel=np.zeros((1, 3), np.float32), mass=None, hubble_drag=0.0,
        )

    carry, _ = step(carry, feed(st))  # seed from initial conditions
    for k in range(n_steps):
        st, acc = kdk_step(st, acc, dt, force)
        if (k + 1) % detect_every == 0:
            carry, ev = step(carry, feed(st))
            counts += np.asarray(ev.apsis)[0, :n_part]

    # the integrator's fused counts (angle_cut=0) must match the replay
    assert np.array_equal(np.asarray(track.counts)[0], counts)


def test_bad_mode_raises():
    state = NBodyState(
        pos=jnp.zeros((4, 3)), vel=jnp.zeros((4, 3)), mass=jnp.ones(4)
    )
    members = jnp.arange(4, dtype=jnp.int32).reshape(1, 4)
    cfg = OrbitNBodyConfig(dt=0.1, n_steps=1, mode="bogus")
    with pytest.raises(ValueError):
        simulate_with_tracking(state, members, cfg)


def test_checkpoint_resume_exact(tmp_path):
    """Chunked orbax checkpointing + resume reproduces the straight-
    through run exactly (counts and per-detection events)."""
    from orbitanalysis_tpu.models.nbody import run_tracked_simulation

    n = 32
    ens = kepler_ensemble(n, 2, seed=5)
    st = NBodyState(
        jnp.asarray(ens.positions[0].astype(np.float32)),
        jnp.asarray(ens.velocities[0].astype(np.float32)),
        jnp.full((n,), 1e-12, jnp.float32),
    )
    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(
        dt=0.01 * float(ens.period.min()), n_steps=160, detect_every=4,
        softening=0.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    force = point_mass_forces(GM=1.0)
    _, tr_ref, ev_ref = simulate_with_tracking(st, members, cfg, force)

    # "crash" after 96 steps, then resume to the full length
    run_tracked_simulation(
        st, members, cfg._replace(n_steps=96), force,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=48,
    )
    _, tr, ev = run_tracked_simulation(
        st, members, cfg, force,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=48,
        resume=True,
    )
    assert np.array_equal(np.asarray(tr.counts), np.asarray(tr_ref.counts))
    assert np.array_equal(np.asarray(ev), np.asarray(ev_ref))


def test_identity_members_fast_path_matches_gather():
    """identity=True (gather-free member frames) must produce the same
    counts as the general gather path, and auto-detect on host arange
    membership."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import (
        NBodyState,
        OrbitNBodyConfig,
        point_mass_forces,
    )
    from orbitanalysis_tpu.models.nbody import simulate_with_tracking
    from orbitanalysis_tpu.models.synthetic import kepler_ensemble

    n = 512
    ens = kepler_ensemble(n, 2, seed=3)
    st = NBodyState(
        pos=jnp.asarray(ens.positions[0].astype(np.float32)),
        vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
        mass=jnp.full((n,), 1e-12, jnp.float32),
    )
    cfg = OrbitNBodyConfig(
        dt=float(ens.period.min()) / 40, n_steps=200, detect_every=4,
        mode="pericentric", softening=0.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    force = point_mass_forces(GM=1.0)
    mem_host = np.arange(n, dtype=np.int32).reshape(2, n // 2)
    _, tr_id, _ = simulate_with_tracking(st, mem_host, cfg, force)
    _, tr_g, _ = simulate_with_tracking(
        st, jnp.asarray(mem_host), cfg, force, identity=False
    )
    assert np.array_equal(np.asarray(tr_id.counts), np.asarray(tr_g.counts))
    assert int(np.asarray(tr_id.counts).sum()) > 0


def test_integrator_both_mode_matches_single_runs():
    """OrbitNBodyConfig(mode='both'): one scan, two accumulators — counts
    must equal the separate pericentric and apocentric runs exactly."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import (
        NBodyState,
        OrbitNBodyConfig,
        point_mass_forces,
    )
    from orbitanalysis_tpu.models.nbody import simulate_with_tracking
    from orbitanalysis_tpu.models.synthetic import kepler_ensemble

    n = 512
    ens = kepler_ensemble(n, 2, seed=9)
    st = NBodyState(
        pos=jnp.asarray(ens.positions[0].astype(np.float32)),
        vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
        mass=jnp.full((n,), 1e-12, jnp.float32),
    )
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    base = dict(
        dt=float(ens.period.min()) / 40, n_steps=220, detect_every=4,
        softening=0.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    force = point_mass_forces(GM=1.0)
    _, (tr_p, tr_a), ev = simulate_with_tracking(
        st, members, OrbitNBodyConfig(mode="both", **base), force
    )
    assert ev.shape == (220, 2)
    _, tr_p1, ev_p = simulate_with_tracking(
        st, members, OrbitNBodyConfig(mode="pericentric", **base), force
    )
    _, tr_a1, ev_a = simulate_with_tracking(
        st, members, OrbitNBodyConfig(mode="apocentric", **base), force
    )
    assert np.array_equal(np.asarray(tr_p.counts), np.asarray(tr_p1.counts))
    assert np.array_equal(np.asarray(tr_a.counts), np.asarray(tr_a1.counts))
    assert np.array_equal(np.asarray(ev[:, 0]), np.asarray(ev_p))
    assert np.array_equal(np.asarray(ev[:, 1]), np.asarray(ev_a))
    assert int(np.asarray(tr_p.counts).sum()) > 0
    assert int(np.asarray(tr_a.counts).sum()) > 0


def test_integrator_both_mode_checkpoint_resume(tmp_path):
    """run_tracked_simulation(mode='both') chunks + orbax resume."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import (
        NBodyState,
        OrbitNBodyConfig,
        point_mass_forces,
    )
    from orbitanalysis_tpu.models.nbody import run_tracked_simulation
    from orbitanalysis_tpu.models.synthetic import kepler_ensemble

    n = 256
    ens = kepler_ensemble(n, 2, seed=4)
    st = NBodyState(
        pos=jnp.asarray(ens.positions[0].astype(np.float32)),
        vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
        mass=jnp.full((n,), 1e-12, jnp.float32),
    )
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(
        dt=float(ens.period.min()) / 40, n_steps=120, detect_every=4,
        mode="both", softening=0.0,
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    force = point_mass_forces(GM=1.0)
    _, (p0, a0), ev0 = run_tracked_simulation(st, members, cfg, force)
    _, (p1, a1), ev1 = run_tracked_simulation(
        st, members, cfg, force,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=50,
    )
    # resume from the last chunk boundary reproduces the final state
    _, (p2, a2), ev2 = run_tracked_simulation(
        st, members, cfg, force,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=50,
        resume=True,
    )
    for a, b in ((p0, p1), (a0, a1), (p1, p2), (a1, a2)):
        assert np.array_equal(np.asarray(a.counts), np.asarray(b.counts))
    assert np.array_equal(np.asarray(ev0), np.asarray(ev1))


def test_array_valued_config_fields_accepted():
    """Array-valued numeric config fields (e.g. box_size off a loader)
    must be accepted — the static-arg jit cache hashes a sanitized
    config (regression: 'Non-hashable static arguments')."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import (
        NBodyState,
        OrbitNBodyConfig,
        point_mass_forces,
    )
    from orbitanalysis_tpu.models.nbody import simulate_with_tracking

    n = 64
    rng = np.random.default_rng(0)
    st = NBodyState(
        pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) + 5.0),
        vel=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.1),
        mass=jnp.full((n,), 1e-12, jnp.float32),
    )
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(
        dt=np.float32(0.01), n_steps=4, detect_every=2,
        mode="pericentric", softening=jnp.float32(0.0),
        box_size=jnp.float32(20.0), G=np.float64(1.0),
        centers=jnp.zeros((1, 3), jnp.float32),
        bulk_vels=jnp.zeros((1, 3), jnp.float32),
    )
    _, tr, ev = simulate_with_tracking(
        st, members, cfg, point_mass_forces(GM=1.0)
    )
    assert np.isfinite(np.asarray(tr.angles)).all()


def test_track_mode_mismatch_raises():
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import (
        NBodyState,
        OrbitNBodyConfig,
        point_mass_forces,
    )
    from orbitanalysis_tpu.models.nbody import (
        init_track_state,
        simulate_with_tracking,
    )

    n = 16
    st = NBodyState(
        pos=jnp.ones((n, 3)), vel=jnp.zeros((n, 3)), mass=jnp.ones((n,))
    )
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(dt=0.01, n_steps=2, mode="both", softening=0.0,
                           centers=jnp.zeros((1, 3)),
                           bulk_vels=jnp.zeros((1, 3)))
    with pytest.raises(ValueError, match="pair"):
        simulate_with_tracking(
            st, members, cfg, point_mass_forces(),
            track=init_track_state(1, n),
        )
