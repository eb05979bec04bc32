"""End-to-end timing at BASELINE config-2 scale: ~100 halos, ~1e6
tracked particles, periodic box, full pipeline (callbacks -> pipelined
tracker -> HDF5 -> collation) on the ambient device.

Synthetic data: per-halo Kepler ensembles (closed-form dynamics, so the
run also sanity-checks counts at scale) plus membership churn.

Run: python benchmarks/config2_e2e.py [outdir]
"""

from __future__ import annotations

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

from orbitanalysis_tpu import Apsides, track_orbits
from orbitanalysis_tpu.models.synthetic import kepler_ensemble
from orbitanalysis_tpu.utils.metrics import Metrics

outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/config2_e2e"
JOIN = sys.argv[2] if len(sys.argv) > 2 else "auto"
PREFETCH = int(sys.argv[3]) if len(sys.argv) > 3 else 1
os.makedirs(outdir, exist_ok=True)

N_HALOS = 100
N_PART = 10_000          # per halo -> 1e6 tracked particles
N_SNAP = 20
BOX = 1000.0

print(f"building {N_HALOS} halos x {N_PART} particles x {N_SNAP} snapshots "
      f"(~{N_HALOS * N_PART * (N_SNAP - 1) / 1e6:.0f}M updates)...",
      flush=True)
t0 = time.time()
rng = np.random.default_rng(0)
centers = rng.uniform(100.0, BOX - 100.0, size=(N_HALOS, 3))
ens = [
    kepler_ensemble(
        N_PART, N_SNAP, seed=h, id_offset=h * 10**7,
        a_range=(0.5, 3.0), dt=0.9,
    )
    for h in range(N_HALOS)
]
print(f"data built in {time.time() - t0:.1f} s", flush=True)


def regions(snapshot_number, halo_ids):
    return centers[halo_ids], np.full(len(halo_ids), 10.0)


def load_snapshot_data(snapshot_number, region_positions, region_radii):
    s = int(snapshot_number)
    # match requested regions back to halo rows by position
    hids = [
        int(np.argmin(np.linalg.norm(centers - rp, axis=1)))
        for rp in np.atleast_2d(region_positions)
    ]
    ids = np.concatenate([ens[h].ids for h in hids])
    pos = np.concatenate(
        [ens[h].positions[s] + centers[h] for h in hids]
    ).astype(np.float32)
    vel = np.concatenate([ens[h].velocities[s] for h in hids]).astype(
        np.float32
    )
    lens = [N_PART] * len(hids)
    return dict(
        ids=ids,
        coordinates=pos,
        velocities=vel,
        masses=1.0,
        region_offsets=np.concatenate(([0], np.cumsum(lens)))[:-1],
        box_size=BOX,
    )


snap_nums = np.arange(N_SNAP)
branches = np.tile(np.arange(N_HALOS), (N_SNAP, 1))
save = os.path.join(outdir, "orbits.h5")
metrics = Metrics()

t0 = time.time()
track_orbits(
    snap_nums, branches, regions, load_snapshot_data, save,
    mode="pericentric", id_dtype=np.int64 if N_HALOS * 10**7 > 2**31
    else np.int32, verbose=False, metrics=metrics, join_impl=JOIN,
    prefetch=PREFETCH,
)
wall = time.time() - t0
updates = N_HALOS * N_PART * (N_SNAP - 1)
print(f"tracked {updates/1e6:.0f}M particle-snapshots in {wall:.1f} s "
      f"({updates/wall/1e6:.1f}M updates/s end-to-end incl. host I/O, "
      "jit compiles and host->device transfer)")
print("phase totals:", {
    k: round(v["total_s"], 2) for k, v in metrics.summary().items()
})
# steady state: drop the first two records (the jit compiles land
# there)
per_snap = [
    sum(v for k, v in r.items() if k.endswith("_s"))
    for r in metrics.records[2:]
]
if per_snap:
    med = float(np.median(per_snap))
    print(
        f"steady-state: {med:.2f} s/snapshot measured phases -> "
        f"{N_HALOS * N_PART / med / 1e6:.1f}M updates/s"
    )

# correctness spot check: total pericenter events vs closed form
import h5py

total = 0
with h5py.File(save) as hf:
    for k in hf:
        total += len(hf[k]["pericenter_IDs"])
expected = sum(int(e.peri_counts[-1].sum()) for e in ens)
print(f"events: detected {total}, closed-form {expected} "
      f"({100 * total / max(expected, 1):.2f}%)")

t0 = time.time()
Apsides(save).collate_apsides(
    savefile=os.path.join(outdir, "collated.h5"), verbose=False
)
print(f"collated in {time.time() - t0:.1f} s")
