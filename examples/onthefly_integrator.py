"""On-the-fly orbit tracking inside a native on-device N-body run.

BASELINE.json configs[3]: the integrator evolves the system with KDK
leapfrog while the apsis detector runs every ``detect_every`` force
evaluations — all inside one jit'd scan, no host round-trips, with
durable orbax checkpointing.  Contrast with the reference's on-the-fly
mode, which re-loads two full snapshots from disk per call
(``/root/reference/orbitanalysis/track_orbits_onthefly.py``).

Run:  python examples/onthefly_integrator.py [outdir]
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

from orbitanalysis_tpu.models import (
    NBodyState,
    OrbitNBodyConfig,
    point_mass_forces,
)
from orbitanalysis_tpu.models.nbody import run_tracked_simulation
from orbitanalysis_tpu.models.synthetic import kepler_ensemble

outdir = sys.argv[1] if len(sys.argv) > 1 else "example_out"
os.makedirs(outdir, exist_ok=True)

# a disk of test particles around a central point mass
n = 1024
ens = kepler_ensemble(n, 2, e_range=(0.1, 0.6), seed=2)
state = NBodyState(
    pos=jnp.asarray(ens.positions[0].astype(np.float32)),
    vel=jnp.asarray(ens.velocities[0].astype(np.float32)),
    mass=jnp.full((n,), 1e-12, jnp.float32),
)
members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)

t_total = 3.0 * float(ens.period.max())
n_steps = 6000
config = OrbitNBodyConfig(
    dt=t_total / n_steps,
    n_steps=n_steps,
    detect_every=4,          # 4x coarser than the force cadence
    mode="pericentric",
    softening=0.0,
    centers=jnp.zeros((1, 3), jnp.float32),
    bulk_vels=jnp.zeros((1, 3), jnp.float32),
)

state_f, track, events = run_tracked_simulation(
    state,
    members,
    config,
    force_fn=point_mass_forces(GM=1.0),
    checkpoint_dir=os.path.join(outdir, "nbody_ck"),
    checkpoint_every=2000,
)

counts = np.asarray(track.counts)[0]
print(
    f"integrated {n} particles for {n_steps} steps "
    f"({int(np.asarray(events).sum())} pericenter passages)"
)
print(
    "count histogram:",
    dict(zip(*map(list, np.unique(counts, return_counts=True)))),
)
expected_mean = t_total / ens.period
print(
    f"mean counts: detected {counts.mean():.2f} vs analytic "
    f"{expected_mean.mean():.2f}"
)
