"""BASELINE config-5: zoom-in resimulation — multi-species masses,
subhalo pericenter census, up to 1e8 particles.

Two sections:

1. **End-to-end census** (default scales: a few minutes): a zoom
   region of ``--halos`` subhalos whose particles carry three species
   masses (high-res DM, star-like, boundary; mass ratios 1:8:64) —
   exercising the mass-weighted bulk-velocity path
   (``track_orbits.py:267-272``) through tracker -> savefile ->
   device-side collation, with an oracle cross-check on a subsample.
   The census table (pericenters per subhalo) is the config-5 product.

2. **Device-resident scale step** (``--device-scale <millions>``,
   default 100 = 1e8): the sorted-carry join + detection step with a
   per-particle mass channel, data synthesized on device (no host
   involvement), churn and static-membership variants — measures the
   per-card ceiling at zoom-in particle counts.

Usage:
  python benchmarks/config5_zoom_e2e.py                  # e2e census
  python benchmarks/config5_zoom_e2e.py --device-scale 100
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# avoid THP direct-compaction stalls on numpy's madvised large
# allocations (see bench.py) - must precede the numpy import
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np  # noqa: E402

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
)
sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "tests"))
)

SPECIES_MASSES = np.array([1.0, 8.0, 64.0], np.float32)  # 1:8:64 zoom tiers


def run_e2e(args):
    import h5py

    from orbitanalysis_tpu import Apsides, track_orbits
    from orbitanalysis_tpu.utils.metrics import Metrics
    from oracle import OracleTracker

    H, P, S = args.halos, args.cap, args.snaps
    BOX = 500.0
    rng0 = np.random.default_rng(11)
    centers = rng0.uniform(50.0, BOX - 50.0, size=(H, 3)).astype(np.float32)

    print(f"zoom region: {H} subhalos x {P} particles "
          f"({H * P / 1e6:.1f}M), 3 species, {S} snapshots", flush=True)

    def pool(h):
        rng = np.random.default_rng(2000 + h)
        r0 = rng.uniform(0.3, 4.0, P).astype(np.float32)
        omega = (1.0 / r0 ** 1.5).astype(np.float32)
        phase0 = rng.uniform(0, 2 * np.pi, P).astype(np.float32)
        ax = rng.normal(size=(P, 3)).astype(np.float32)
        ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
        tmp = rng.normal(size=(P, 3)).astype(np.float32)
        tmp -= (tmp * ax).sum(-1, keepdims=True) * ax
        ay = (tmp / np.linalg.norm(tmp, axis=-1, keepdims=True)).astype(
            np.float32
        )
        ecc = rng.uniform(0.2, 0.5, P).astype(np.float32)
        phr = rng.uniform(0, 2 * np.pi, P).astype(np.float32)
        ids = (np.arange(P) + h * P).astype(np.int32)
        # species tiers: mostly high-res, a boundary shell of heavies
        species = rng.choice(3, size=P, p=[0.8, 0.15, 0.05])
        mass = SPECIES_MASSES[species]
        return r0, omega, phase0, ax, ay, ecc, phr, ids, mass

    def block(h, s):
        r0, omega, phase0, ax, ay, ecc, phr, ids, mass = pool(h)
        dt = np.float32(0.3)
        ph = phase0 + omega * (s * dt)
        pr = phr + omega * (s * dt)
        r = r0 * (1.0 + ecc * np.sin(pr))
        rdot = r0 * ecc * omega * np.cos(pr)
        cph, sph = np.cos(ph), np.sin(ph)
        pos = centers[h] + r[:, None] * (cph[:, None] * ax
                                         + sph[:, None] * ay)
        vel = (rdot[:, None] * (cph[:, None] * ax + sph[:, None] * ay)
               + (r * omega)[:, None] * (-sph[:, None] * ax
                                         + cph[:, None] * ay))
        return ids, pos.astype(np.float32), vel.astype(np.float32), mass

    def regions(snapshot_number, halo_ids):
        return centers[halo_ids], np.full(len(halo_ids), 8.0, np.float32)

    def loader(snapshot_number, region_positions, region_radii):
        s = int(snapshot_number)
        hids = [
            int(np.argmin(np.linalg.norm(centers - rp, axis=1)))
            for rp in np.atleast_2d(region_positions)
        ]
        blocks = [block(h, s) for h in hids]
        lens = [len(b[0]) for b in blocks]
        return dict(
            ids=np.concatenate([b[0] for b in blocks]),
            coordinates=np.concatenate([b[1] for b in blocks]),
            velocities=np.concatenate([b[2] for b in blocks]),
            masses=np.concatenate([b[3] for b in blocks]),  # per-particle!
            region_offsets=np.concatenate(([0], np.cumsum(lens)))[:-1],
            box_size=BOX,
        )

    os.makedirs(args.outdir, exist_ok=True)
    save = os.path.join(args.outdir, "zoom_orbits.h5")
    if os.path.exists(save):
        os.remove(save)
    snap_nums = np.arange(S)
    branches = np.tile(np.arange(H), (S, 1))
    metrics = Metrics()
    t0 = time.time()
    track_orbits(snap_nums, branches, regions, loader, save,
                 mode="pericentric", verbose=False, metrics=metrics,
                 join_impl=args.join)
    wall = time.time() - t0
    updates = H * P * (S - 1)
    print(f"tracked {updates / 1e6:.0f}M particle-snapshots in {wall:.1f} s "
          f"({updates / wall / 1e6:.1f}M upd/s e2e); phases: "
          f"{ {k: round(v['total_s'], 2) for k, v in metrics.summary().items()} }",
          flush=True)

    # subhalo pericenter census via device-side collation
    coll = os.path.join(args.outdir, "zoom_census.h5")
    if os.path.exists(coll):
        os.remove(coll)
    t0 = time.time()
    Apsides(save).collate_apsides(savefile=coll, verbose=False, device=True)
    with h5py.File(coll) as hf:
        key = sorted(hf.keys())[-1]
        g = hf[key]
        offs = np.concatenate((g["halo_offsets"][:],
                               [len(g["particle_IDs"])]))
        counts = g["pericenter_counts"][:]
        census = [int(counts[offs[i]:offs[i + 1]].sum()) for i in range(H)]
    print(f"census (collated in {time.time() - t0:.1f} s): "
          f"total pericenters {sum(census)}; per-subhalo "
          f"min/median/max = {min(census)}/{int(np.median(census))}/"
          f"{max(census)}", flush=True)

    # oracle cross-check on a subsample (mass-weighted bulk on both sides)
    check = list(range(min(3, H)))
    oracle = OracleTracker(mode="pericentric", box_size=BOX)
    expected = []
    for s in range(S):
        snap = {}
        for h in check:
            ids, pos, vel, mass = block(h, s)
            snap[h] = dict(ids=ids, pos=pos, vel=vel, mass=mass,
                           center=centers[h])
        expected.append(oracle.step(snap))
    mism = 0
    with h5py.File(save) as hf:
        for s in range(1, S):
            g = hf["snapshot_%03d" % s]
            offs = g["region_offsets"][:]
            got = g["pericenter_IDs"][:]
            for h in check:
                got_h = np.sort(got[offs[h]:offs[h + 1]])
                exp_h = np.sort(expected[s][h][0])
                if not np.array_equal(got_h, exp_h):
                    mism += 1
    print(f"oracle cross-check ({len(check)} subhalos, species masses): "
          f"{'OK' if mism == 0 else f'{mism} MISMATCHES'}")
    return mism


def run_device_scale(args):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import (
        init_sorted_carry,
        make_sorted_orbit_step,
    )

    target = int(args.device_scale * 1e6)
    P = 65536
    S = 4
    dt, ecc = 0.3, 0.3

    # the mass channel adds ~8 bytes/particle of batch+carry state over
    # the massless fullbox config; on an out-of-memory error back off
    # by re-exec'ing at half scale in a fresh process
    H = max(1, target // P)
    try:
        _device_scale_attempt(args, H, P, S, dt, ecc)
        return
    except Exception as e:  # jaxlib wraps OOM differently per path
        msg = f"{type(e).__name__}: {e}"
        if "RESOURCE_EXHAUSTED" not in msg and "ResourceExhausted" not in msg:
            raise
        if H <= 1:
            raise
        print(f"{H * P / 1e6:.0f}M particles OOM on one card "
              "(mass channel adds state) — re-exec at half scale",
              flush=True)
        os.execv(sys.executable, [
            sys.executable, os.path.abspath(__file__), "--skip-e2e",
            f"--device-scale={H // 2 * P / 1e6}",
            "--outdir", args.outdir,
        ])


def run_device_scale_label(args):
    """Device-resident zoom census at FULL config-5 scale (1e8
    particles, 3-species masses) on ONE card, via the label-native
    detector with the octahedral-packed carry (12 B/particle: lab_sv +
    packed angle + oct rhat): the pool is the stable layout, churn is
    an elementwise label change, and counts are unaffected by the rhat
    quantization by construction (radial-velocity signs never read the
    carried rhat — parity: tests/test_label.py).
    """
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        make_label_orbit_step,
    )

    target = int(args.device_scale * 1e6)
    H, P = 1536, 65536
    while H * P > max(target, 1):
        H -= 64
    H = max(H, 64)
    N = H * P
    S = 4
    dt, ecc = 0.3, 0.3
    print(f"\nlabel-native zoom census: N={N / 1e6:.0f}M particles "
          f"({H} subhalos), 3-species masses, packed carry "
          "(12 B/particle)", flush=True)

    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    r0 = jax.random.uniform(k1, (N,), minval=0.3, maxval=4.0)
    omega = (1.0 / r0 ** 1.5).astype(jnp.float32)
    phase0 = jax.random.uniform(k2, (N,), maxval=2 * np.pi).astype(
        jnp.float32
    )
    phase_r0 = jax.random.uniform(k3, (N,), maxval=2 * np.pi).astype(
        jnp.float32
    )
    species = jax.random.categorical(
        k4, jnp.log(jnp.array([0.8, 0.15, 0.05])), shape=(N,)
    )
    mass = jnp.asarray(SPECIES_MASSES, jnp.float32)[species]
    r0 = r0.astype(jnp.float32)
    home = (jnp.arange(N, dtype=jnp.int32) // P).astype(jnp.int32)
    centers = jnp.zeros((H, 3), jnp.float32)
    churn_w = P // 16  # ~6% of each subhalo churns per step

    step = make_label_orbit_step(
        max(128, (1 << 15) // 16), box_size=None, rhat_packed=True,
    )

    # the ensemble arrays are jit ARGUMENTS, not closure captures:
    # captured device arrays get baked into the lowered module as
    # constants (2.3 GB of HLO at 1e8 particles)
    ens = (r0, omega, phase0, phase_r0, home)

    def synth(k, e):
        r0, omega, phase0, phase_r0, home = e
        t = k.astype(jnp.float32) * dt
        ph = phase0 + omega * t
        phr = phase_r0 + omega * t
        r = r0 * (1.0 + ecc * jnp.sin(phr))
        rdot = r0 * ecc * omega * jnp.cos(phr)
        c, s = jnp.cos(ph), jnp.sin(ph)
        pos = jnp.stack([r * c, r * s, jnp.zeros_like(r)])
        vel = jnp.stack(
            [rdot * c - r * omega * s, rdot * s + r * omega * c,
             jnp.zeros_like(r)]
        )
        # rotating membership window: churn_w of each subhalo's P slots
        # are out at any step, the window advancing per step
        local = jnp.arange(N, dtype=jnp.int32) % P
        out = ((local + k * churn_w) % P) < churn_w
        return pos, vel, jnp.where(out, -1, home)

    @jax.jit
    def fn(carry, e, mass, centers):
        def body(c, k):
            pos, vel, lab = synth(k, e)
            c, ev = step(c, (pos, vel, lab, centers, None, mass,
                             jnp.float32(0)))
            return c, jnp.sum(ev.count)

        return jax.lax.scan(body, carry, jnp.arange(1, S + 1))

    carry = init_label_carry(N, rhat_packed=True)

    @jax.jit
    def seed(c, e, mass, centers):
        return step(c, synth(jnp.int32(0), e)
                    + (centers, None, mass, jnp.float32(0)))[0]

    t0 = time.time()
    carry = seed(carry, ens, mass, centers)
    jax.block_until_ready(carry)
    print(f"seed step compile+run: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    _, events = fn(carry, ens, mass, centers)
    tot = int(np.asarray(jnp.sum(events)))
    print(f"scan compile+first run: {time.time() - t0:.1f} s", flush=True)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, events = fn(carry, ens, mass, centers)
        tot = int(np.asarray(jnp.sum(events)))
        best = min(best, time.perf_counter() - t0)
    per_step = best / S
    print(f"{N / 1e6:.0f}M-particle zoom census step [label-native, "
          f"churn, mass channel] on {jax.devices()[0].device_kind}: "
          f"{per_step * 1000:.3f} ms ({N / per_step:.6e} updates/s/card); "
          f"{tot} events over {S} steps", flush=True)


def _device_scale_attempt(args, H, P, S, dt, ecc):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import (
        init_sorted_carry,
        make_sorted_orbit_step,
    )

    N = H * P
    print(f"\ndevice-resident zoom step: H={H} x P={P} = {N / 1e6:.0f}M "
          "particles, 3-species mass channel", flush=True)

    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ids = (jnp.arange(P, dtype=jnp.int32)[None, :]
           + jnp.arange(H, dtype=jnp.int32)[:, None] * P)
    slot = jnp.argsort(jax.random.uniform(k5, (H, P)), axis=-1).astype(
        jnp.int32
    )
    r0 = jax.random.uniform(k1, (H, P), minval=0.3, maxval=4.0)
    omega = 1.0 / r0 ** 1.5
    phase0 = jax.random.uniform(k2, (H, P), maxval=2 * np.pi)
    phase_r0 = jax.random.uniform(k3, (H, P), maxval=2 * np.pi)
    species = jax.random.categorical(
        k4, jnp.log(jnp.array([0.8, 0.15, 0.05])), shape=(H, P)
    )
    mass = jnp.asarray(SPECIES_MASSES)[species]
    center = jnp.zeros((H, 3), jnp.float32)

    step = make_sorted_orbit_step(max(128, P // 16))

    def synth(params, k, churn):
        ids, slot, r0, omega, phase0, phase_r0, mass = params
        t = k.astype(jnp.float32) * dt
        ids = ids + k * churn
        ph = phase0 + omega * t
        phr = phase_r0 + omega * t
        r = r0 * (1.0 + ecc * jnp.sin(phr))
        rdot = r0 * ecc * omega * jnp.cos(phr)
        c, s = jnp.cos(ph), jnp.sin(ph)
        pos = jnp.stack([r * c, r * s, jnp.zeros_like(r)], axis=-1)
        vel = jnp.stack(
            [rdot * c - r * omega * s, rdot * s + r * omega * c,
             jnp.zeros_like(r)], axis=-1,
        )
        return SnapshotBatch(
            ids=ids, pos=pos.astype(jnp.float32),
            vel=vel.astype(jnp.float32), center=center,
            mass=mass, bulk_vel=None, hubble_drag=jnp.float32(0.0),
            slot=slot,
        )

    params = (ids, slot, r0.astype(jnp.float32), omega.astype(jnp.float32),
              phase0.astype(jnp.float32), phase_r0.astype(jnp.float32),
              mass.astype(jnp.float32))

    for label, churn in (("churn join", P // 16), ("static membership", 0)):
        def run(carry, params, churn=churn):
            def body(c, k):
                c, ev = step(c, synth(params, k, churn))
                return c, jnp.sum(ev.count)

            return jax.lax.scan(body, carry, jnp.arange(1, S + 1))

        fn = jax.jit(run)
        carry = init_sorted_carry(H, P)
        carry, _ = jax.jit(
            lambda c, pr: step(c, synth(pr, jnp.int32(0), churn))
        )(carry, params)

        t0 = time.time()
        _, events = fn(carry, params)
        tot = int(np.asarray(jnp.sum(events)))
        print(f"[{label}] compile+first scan: {time.time() - t0:.1f} s",
              flush=True)

        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _, events = jax.block_until_ready(fn(carry, params))
            best = min(best, time.perf_counter() - t0)
        tot = int(np.asarray(jnp.sum(events)))
        per_step = best / S
        print(f"{N / 1e6:.0f}M-particle zoom step [{label}] on "
              f"{jax.devices()[0].device_kind}: {per_step * 1000:.3f} ms "
              f"({N / per_step:.6e} updates/s/card); {tot} events",
              flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--halos", type=int, default=64)
    ap.add_argument("--cap", type=int, default=16384)
    ap.add_argument("--snaps", type=int, default=8)
    ap.add_argument("--join", default="auto")
    ap.add_argument("--outdir", default="/tmp/config5_e2e")
    ap.add_argument("--device-scale", type=float, default=0,
                    help="millions of particles for the device-resident "
                         "section (0 = skip)")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--label", action="store_true",
                    help="run the device-resident section through the "
                         "label-native detector with the octahedral-"
                         "packed 12 B/particle carry (the full-1e8-on-"
                         "one-card path) instead of the sorted engine")
    args = ap.parse_args()
    rc = 0
    if not args.skip_e2e:
        rc = run_e2e(args)
    if args.device_scale > 0:
        if args.label:
            run_device_scale_label(args)
        else:
            run_device_scale(args)
    sys.exit(1 if rc else 0)
