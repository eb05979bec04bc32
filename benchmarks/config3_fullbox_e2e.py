"""BASELINE config-3 end-to-end: full-box tracking at scale.

Config 3 (BASELINE.json configs[2]): a full periodic box, *all* halos
above a mass cut, pericenter AND apocenter catalogs.  This script runs
the complete pipeline — callbacks -> (optionally halo-sharded) tracker
-> HDF5 -> progenitor linking -> collation (device-side accumulation)
— on synthetic full-box data generated lazily per snapshot (closed-form
orbits + membership churn; nothing is pre-staged, the loader computes
each snapshot on demand exactly like a real Gadget reader would read
it), and cross-checks a subsample of halos against the NumPy oracle.

Scale defaults target a few-minute run; pass the full-box figures
explicitly for the real measurement, e.g.:

  python benchmarks/config3_fullbox_e2e.py --halos 1020 --cap 65536 \
      --snaps 6            # 67M tracked particles
  python benchmarks/config3_fullbox_e2e.py --mesh   # halo-sharded mesh
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

from orbitanalysis_tpu import (
    Apsides,
    find_main_progenitors,
    get_central_particle_ids,
    track_orbits,
)
from orbitanalysis_tpu.utils.metrics import Metrics

ap = argparse.ArgumentParser()
ap.add_argument("--halos", type=int, default=256)
ap.add_argument("--cap", type=int, default=16384, help="particles per halo")
ap.add_argument("--snaps", type=int, default=8)
ap.add_argument("--churn", type=float, default=0.05)
ap.add_argument("--mesh", action="store_true",
                help="halo-shard over all local devices")
ap.add_argument("--both", action="store_true",
                help="produce the pericenter AND apocenter catalogs in "
                     "ONE ingest pass (mode='both') instead of two runs")
ap.add_argument("--outdir", default="/tmp/config3_e2e")
ap.add_argument("--join", default="auto")
ap.add_argument("--oracle-halos", type=int, default=3,
                help="subsample size for the oracle cross-check")
args = ap.parse_args()
os.makedirs(args.outdir, exist_ok=True)

H, P, S = args.halos, args.cap, args.snaps
BOX = 1000.0
N_VALID = int(P * 0.9)
K_CHURN = min(int(round(args.churn * N_VALID)), P - N_VALID)

print(f"config-3 synthetic box: {H} halos x {N_VALID} tracked "
      f"({H * N_VALID / 1e6:.1f}M particles, churn {args.churn:.0%}/snap, "
      f"{S} snapshots)", flush=True)

rng0 = np.random.default_rng(7)
CENTERS = rng0.uniform(50.0, BOX - 50.0, size=(H, 3)).astype(np.float32)
# halo "masses" above the cut, only used to exercise the catalog surface
MASSES = 10.0 ** rng0.uniform(11.0, 14.5, size=H)


def _halo_pool(h):
    """Closed-form orbit pool of halo h (deterministic, O(P) memory)."""
    rng = np.random.default_rng(1000 + h)
    r0 = rng.uniform(0.5, 5.0, P).astype(np.float32)
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
    ids = (np.arange(P, dtype=np.int64) + h * P).astype(np.int32)
    return r0, omega, phase0, ax, ay, ecc, phr, ids


def _members(h, s):
    """Deterministic membership set of halo h at snapshot s."""
    rng = np.random.default_rng(5000 + h)
    member = np.zeros(P, dtype=bool)
    member[rng.choice(P, N_VALID, replace=False)] = True
    for _ in range(s):
        if K_CHURN:
            drop = rng.choice(np.flatnonzero(member), K_CHURN, replace=False)
            add = rng.choice(np.flatnonzero(~member), K_CHURN, replace=False)
            member[drop] = False
            member[add] = True
    return np.flatnonzero(member)


def _halo_block(h, s):
    r0, omega, phase0, ax, ay, ecc, phr, ids = _halo_pool(h)
    sel = _members(h, s)
    dt = np.float32(0.3)
    ph = phase0[sel] + omega[sel] * (s * dt)
    pr = phr[sel] + omega[sel] * (s * dt)
    r = r0[sel] * (1.0 + ecc[sel] * np.sin(pr))
    rdot = r0[sel] * ecc[sel] * omega[sel] * np.cos(pr)
    cph, sph = np.cos(ph), np.sin(ph)
    e1, e2 = ax[sel], ay[sel]
    pos = CENTERS[h] + r[:, None] * (cph[:, None] * e1 + sph[:, None] * e2)
    vel = (
        rdot[:, None] * (cph[:, None] * e1 + sph[:, None] * e2)
        + (r * omega[sel])[:, None]
        * (-sph[:, None] * e1 + cph[:, None] * e2)
    )
    return ids[sel], pos.astype(np.float32), vel.astype(np.float32)


def regions(snapshot_number, halo_ids):
    return CENTERS[halo_ids], np.full(len(halo_ids), 10.0, np.float32)


def load_snapshot_data(snapshot_number, region_positions, region_radii):
    s = int(snapshot_number)
    hids = [
        int(np.argmin(np.linalg.norm(CENTERS - rp, axis=1)))
        for rp in np.atleast_2d(region_positions)
    ]
    blocks = [_halo_block(h, s) for h in hids]
    lens = [len(b[0]) for b in blocks]
    return dict(
        ids=np.concatenate([b[0] for b in blocks]),
        coordinates=np.concatenate([b[1] for b in blocks]),
        velocities=np.concatenate([b[2] for b in blocks]),
        masses=1.0,
        region_offsets=np.concatenate(([0], np.cumsum(lens)))[:-1],
        box_size=BOX,
    )


mesh = None
if args.mesh:
    from orbitanalysis_tpu.parallel.mesh import make_halo_mesh

    mesh = make_halo_mesh()
    print(f"halo-sharded mesh over {mesh.devices.size} device(s)")

snap_nums = np.arange(S)
branches = np.tile(np.arange(H), (S, 1))
updates = H * N_VALID * (S - 1)

summary = {}
if args.both:
    # config 3 wants BOTH catalogs: one ingest pass produces both files
    # (mode='both'), vs the reference's two full runs
    saves = {
        m: os.path.join(args.outdir, f"orbits_{m}.h5")
        for m in ("pericentric", "apocentric")
    }
    for save in saves.values():
        if os.path.exists(save):
            os.remove(save)
    metrics = Metrics()
    t0 = time.time()
    track_orbits(
        snap_nums, branches, regions, load_snapshot_data,
        (saves["pericentric"], saves["apocentric"]),
        mode="both", id_dtype=np.int32, verbose=False, metrics=metrics,
        join_impl=args.join, mesh=mesh,
    )
    wall = time.time() - t0
    phases = {k: round(v["total_s"], 2) for k, v in metrics.summary().items()}
    print(f"[both] tracked {updates / 1e6:.0f}M particle-snapshots into "
          f"BOTH catalogs in {wall:.1f} s "
          f"({2 * updates / wall / 1e6:.1f}M catalog-upd/s e2e) "
          f"phases: {phases}", flush=True)
    for m, save in saves.items():
        summary[m] = dict(wall=wall, save=save, phases=phases)
else:
  for mode in ("pericentric", "apocentric"):
    save = os.path.join(args.outdir, f"orbits_{mode}.h5")
    if os.path.exists(save):
        os.remove(save)
    metrics = Metrics()
    t0 = time.time()
    track_orbits(
        snap_nums, branches, regions, load_snapshot_data, save,
        mode=mode, id_dtype=np.int32, verbose=False, metrics=metrics,
        join_impl=args.join, mesh=mesh,
    )
    wall = time.time() - t0
    phases = {k: round(v["total_s"], 2) for k, v in metrics.summary().items()}
    print(f"[{mode}] tracked {updates / 1e6:.0f}M particle-snapshots in "
          f"{wall:.1f} s ({updates / wall / 1e6:.1f}M upd/s e2e) "
          f"phases: {phases}", flush=True)
    summary[mode] = dict(wall=wall, save=save, phases=phases)

# ---- progenitor linking at catalog scale (identity box: the link must
# recover halo h -> halo h).  Phase split per the round-3 review: data
# synthesis (not a linking cost — real pipelines read catalogs),
# central-ID selection, and the majority vote, with the catalog-sized
# work on device (top_k + sorted-join/segment-max vote) ----
from orbitanalysis_tpu.progenitors import (  # noqa: E402
    find_main_progenitors_device,
    get_central_particle_ids_device,
)

t0 = time.time()
s_last, s_prev = S - 1, S - 2
blocks_last = [_halo_block(h, s_last) for h in range(H)]
blocks_prev = [_halo_block(h, s_prev) for h in range(H)]
snap_last = dict(
    ids=np.concatenate([b[0] for b in blocks_last]),
    coordinates=np.concatenate([b[1] for b in blocks_last]),
    region_offsets=np.concatenate(
        ([0], np.cumsum([len(b[0]) for b in blocks_last]))
    )[:-1],
)
halo_pids = np.concatenate([b[0] for b in blocks_prev])
halo_offsets = np.concatenate(
    ([0], np.cumsum([len(b[0]) for b in blocks_prev]))
)[:-1]
t_gen = time.time() - t0

t0 = time.time()
central_ids, central_offsets = get_central_particle_ids_device(
    snap_last, CENTERS, n=100
)
t_central = time.time() - t0

t0 = time.time()
prog = find_main_progenitors_device(
    halo_pids, halo_offsets, central_ids, central_offsets
)
t_vote = time.time() - t0
n_correct = int(np.sum(np.asarray(prog) == np.arange(H)))
print(f"progenitor linking: {n_correct}/{H} recovered — phase split: "
      f"synthesis {t_gen:.1f} s (bench-only), central-IDs "
      f"{t_central:.1f} s, device vote {t_vote:.1f} s "
      f"(link cost = {t_central + t_vote:.1f} s)", flush=True)

# ---- collation (device-side accumulation) ----
for mode in ("pericentric", "apocentric"):
    coll = os.path.join(args.outdir, f"collated_{mode}.h5")
    if os.path.exists(coll):
        os.remove(coll)
    t0 = time.time()
    Apsides(summary[mode]["save"]).collate_apsides(
        savefile=coll, save_final_counts=True, verbose=False, device=True,
    )
    print(f"[{mode}] device-side collation in {time.time() - t0:.1f} s",
          flush=True)

# ---- oracle cross-check on a halo subsample ----
from oracle import OracleTracker  # tests/ dir (clean-room reference model)

import h5py

check = list(range(min(args.oracle_halos, H)))
oracle = OracleTracker(mode="pericentric", box_size=BOX)
expected = []
for s in range(S):
    snap = {}
    for h in check:
        ids, pos, vel = _halo_block(h, s)
        snap[h] = dict(ids=ids, pos=pos, vel=vel, mass=None,
                       center=CENTERS[h])
    expected.append(oracle.step(snap))

mism = 0
with h5py.File(summary["pericentric"]["save"]) as hf:
    for s in range(1, S):
        g = hf["snapshot_%03d" % s]
        offs = g["region_offsets"][:]
        got = g["pericenter_IDs"][:]
        for h in check:
            got_h = np.sort(got[offs[h]:offs[h + 1]])
            exp_h = np.sort(expected[s][h][0])
            if not np.array_equal(got_h, exp_h):
                mism += 1
print(f"oracle cross-check on {len(check)} halos x {S - 1} snapshots: "
      f"{'OK' if mism == 0 else f'{mism} MISMATCHES'}")
if mism:
    sys.exit(1)
