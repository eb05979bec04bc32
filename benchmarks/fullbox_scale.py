"""Full-box scale check: ~1e8 particle-snapshot updates per step
through the GENERAL (sort-merge join) tracking step and the sorted-carry
step, data generated on device so the host plays no part.

Measures how far ONE card gets.  Orbital motion is synthesized inside
the scan body (eccentric epicycles with per-particle random phases)
from [H, P] parameter planes resident in device memory; every step
still pays the full join + detection + event compaction.

Usage: python benchmarks/fullbox_scale.py [n_million_particles]
(``ONLY_SORTED=1`` skips the general section)
"""

from __future__ import annotations

import os
import sys
import time

# avoid THP direct-compaction stalls on numpy's madvised large
# allocations (see bench.py) - must precede the numpy import
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import jax
import jax.numpy as jnp

from orbitanalysis_tpu.ops.apsis import SnapshotBatch, init_carry, make_orbit_step
from orbitanalysis_tpu.utils.padding import invalid_id_for

target_m = float(sys.argv[1]) if len(sys.argv) > 1 else 67.0
ONLY_SORTED = os.environ.get("ONLY_SORTED", "") == "1"  # skip the
#   general section
H = 256
P = int(target_m * 1e6 / H) // 1024 * 1024
N = H * P
S = 4
print(f"device: {jax.devices()[0].device_kind} "
      f"({jax.devices()[0].platform}); H={H} halos x P={P} = "
      f"{N/1e6:.0f}M particles, {S}-step scan", flush=True)

key = jax.random.PRNGKey(0)
k1, k2, k3, k4 = jax.random.split(key, 4)
invalid = invalid_id_for(np.int32)

# ids: unique per row, shuffled (the join must do real work)
ids = jnp.argsort(
    jax.random.uniform(k1, (H, P)), axis=-1
).astype(jnp.int32) + jnp.arange(H, dtype=jnp.int32)[:, None] * P

r0 = jax.random.uniform(k2, (H, P), minval=0.5, maxval=5.0)
omega = 1.0 / r0 ** 1.5
phase0 = jax.random.uniform(k3, (H, P), maxval=2 * np.pi)
phase_r0 = jax.random.uniform(k4, (H, P), maxval=2 * np.pi)
ecc = 0.3
dt = 0.3
center = jnp.zeros((H, 3), jnp.float32)

step = make_orbit_step(mode="pericentric", box_size=None,
                       event_capacity=max(128, P // 16))


def synth_batch(params, t):
    """Positions/velocities of the epicyclic ensemble at time t (planar
    orbits; cheap elementwise work vs the join).  ``params`` are jit
    ARGUMENTS, not closures — closure-captured arrays embed as HLO
    constants (hundreds of MB shipped to the compiler)."""
    ids, r0, omega, phase0, phase_r0 = params
    ph = phase0 + omega * t
    phr = phase_r0 + omega * t
    r = r0 * (1.0 + ecc * jnp.sin(phr))
    rdot = r0 * ecc * omega * jnp.cos(phr)
    c, s = jnp.cos(ph), jnp.sin(ph)
    pos = jnp.stack([r * c, r * s, jnp.zeros_like(r)], axis=-1)
    vel = jnp.stack(
        [rdot * c - r * omega * s, rdot * s + r * omega * c,
         jnp.zeros_like(r)],
        axis=-1,
    ).astype(jnp.float32)
    return SnapshotBatch(
        ids=ids, pos=pos.astype(jnp.float32), vel=vel, center=center,
        mass=None, bulk_vel=None, hubble_drag=jnp.float32(0.0),
    )


params = (ids, r0.astype(jnp.float32), omega.astype(jnp.float32),
          phase0.astype(jnp.float32), phase_r0.astype(jnp.float32))


def run(carry, params):
    def body(c, k):
        c, ev = step(c, synth_batch(params, k.astype(jnp.float32) * dt))
        return c, jnp.sum(ev.ev_count)

    return jax.lax.scan(body, carry, jnp.arange(1, S + 1))


if not ONLY_SORTED:
    fn = jax.jit(run)
    carry0 = init_carry(H, P)
    carry0, _ = jax.jit(
        lambda c, pr: step(c, synth_batch(pr, 0.0))
    )(carry0, params)  # seed

    t0 = time.time()
    carry, events = fn(carry0, params)
    total0 = int(np.asarray(jnp.sum(events)))
    print(f"compile+first scan: {time.time()-t0:.1f} s", flush=True)

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        carry, events = jax.block_until_ready(fn(carry0, params))
        best = min(best, time.perf_counter() - t0)
    tot = int(np.asarray(jnp.sum(events)))

    per_step = best / S
    print(
        f"{N/1e6:.0f}M-particle step: {per_step*1000:.3f} ms "
        f"({N/per_step:.6e} updates/s/card); "
        f"1e8 particle-snapshots in {1e8/(N/per_step):.3f} s on one card; "
        f"{tot} events/scan"
    )


# ----------------------------------------------------------------------
# sorted-carry path: same particle count, ID-sorted staged rows
# ----------------------------------------------------------------------
from orbitanalysis_tpu.ops.sorted_step import (  # noqa: E402
    init_sorted_carry,
    make_sorted_orbit_step,
)
from orbitanalysis_tpu.utils.padding import round_up_pow2  # noqa: E402

P2 = min(65536, round_up_pow2(int(N // H)))
H2 = max(1, N // P2)
N2 = H2 * P2
print(f"\nsorted-carry path: H={H2} x P={P2} = {N2/1e6:.0f}M particles",
      flush=True)

k5 = jax.random.split(key, 5)[-1]
# staged ID-sorted rows: ids ascending, load order carried as a fixed
# random slot permutation (the detection/join workload is identical)
ids2 = (
    jnp.arange(P2, dtype=jnp.int32)[None, :]
    + jnp.arange(H2, dtype=jnp.int32)[:, None] * P2
)
slot2 = jnp.argsort(jax.random.uniform(k5, (H2, P2)), axis=-1).astype(
    jnp.int32
)
r0b = jax.random.uniform(k2, (H2, P2), minval=0.5, maxval=5.0)
omegab = 1.0 / r0b ** 1.5
phase0b = jax.random.uniform(k3, (H2, P2), maxval=2 * np.pi)
phase_r0b = jax.random.uniform(k4, (H2, P2), maxval=2 * np.pi)
center2 = jnp.zeros((H2, 3), jnp.float32)

step_s = make_sorted_orbit_step(max(128, P2 // 16))


def synth_batch2(params, k, churn):
    """``churn`` > 0 slides the ID window by ``churn`` ids per step
    (rows stay ascending); 0 keeps membership fixed."""
    ids, slot, r0, omega, phase0, phase_r0 = params
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
         jnp.zeros_like(r)],
        axis=-1,
    ).astype(jnp.float32)
    return SnapshotBatch(
        ids=ids, pos=pos.astype(jnp.float32), vel=vel, center=center2,
        mass=None, bulk_vel=None, hubble_drag=jnp.float32(0.0), slot=slot,
    )


params2 = (ids2, slot2, r0b.astype(jnp.float32), omegab.astype(jnp.float32),
           phase0b.astype(jnp.float32), phase_r0b.astype(jnp.float32))


for label, churn in (("churn join", P2 // 16), ("static membership", 0)):
    def run2(carry, params, churn=churn):
        def body(c, k):
            c, ev = step_s(c, synth_batch2(params, k, churn))
            return c, jnp.sum(ev.count)

        return jax.lax.scan(body, carry, jnp.arange(1, S + 1))

    fn2 = jax.jit(run2)
    carry2 = init_sorted_carry(H2, P2)
    carry2, _ = jax.jit(
        lambda c, pr: step_s(c, synth_batch2(pr, jnp.int32(0), churn))
    )(carry2, params2)

    t0 = time.time()
    _, events2 = fn2(carry2, params2)
    tot2 = int(np.asarray(jnp.sum(events2)))
    print(f"[{label}] compile+first scan: {time.time()-t0:.1f} s",
          flush=True)

    best2 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, events2 = jax.block_until_ready(fn2(carry2, params2))
        best2 = min(best2, time.perf_counter() - t0)
    tot2 = int(np.asarray(jnp.sum(events2)))

    per_step2 = best2 / S
    print(
        f"{N2/1e6:.0f}M-particle sorted-carry step [{label}]: "
        f"{per_step2*1000:.3f} ms "
        f"({N2/per_step2:.6e} updates/s/card); "
        f"1e8 particle-snapshots in {1e8/(N2/per_step2):.3f} s on one "
        f"card; {tot2} events/scan"
    )
