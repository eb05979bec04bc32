#!/usr/bin/env python3
"""GPU smoke run of orbitanalysis_tpu's main paths, checked against
independent references.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the four-card paths only

One card, in this order:

1. ``gpu-tests``: the ``gpu``-marked pytest cases, in a child process
   that exits before this process touches the card (one JAX process on
   the card at a time).
2. ``tracker``: the config-2 deployment (100 halos x 10,000 tracked
   particles, 20 snapshots, periodic box, ~7 % membership churn per
   snapshot) through ``track_orbits(mode='both')`` with
   ``join_impl='aligned'`` and ``'general'``.  Event sets (particle IDs
   per halo per snapshot, both modes) must equal a float64 run of
   ``tests/oracle.OracleTracker``; the two engines' savefiles must be
   equal under ``tests/test_engine.py::_assert_files_equal``'s
   tolerances (:func:`engines_match`).  Without h5py the tracker's two savefile writes are
   captured in memory (everything else — callbacks, staging, steps,
   event fetch — runs unchanged).
3. ``pm``: 256^3 particles on a 256^3 grid.  PM accelerations against a
   float64 NumPy PM of the same scheme (relative L2 <= 1e-5), then 8
   KDK steps of ``simulate_with_tracking`` (64 halos, ``mode='both'``,
   ``detect_every=4``) whose per-particle counts must equal a float64
   detector run on the card's own states except at knife-edge
   particles (:data:`VR_EDGE`).
4. ``kepler``: the config-4 Kepler fidelity check on the card.
5. ``direct``: the blocked direct-force kernel against float64 NumPy.

``--four``: the hash-sharded tracker at 4x the config-2 data against
the one-card aligned engine (event sets may differ only at knife-edge
particles, :data:`KNIFE_EDGE`), and the slab-resident distributed PM at
grid 256 against single-device ``pm_forces`` (relative L2 <= 1e-4).

No failure is caught: any mismatch raises and the exit code is
non-zero.  The last line of a passing run is one JSON object with the
device JAX reports.  Without a GPU the script exits non-zero before
running anything.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the config-2 deployment (BASELINE.json configs[1])
N_HALOS, N_TRACKED, N_SNAPS, CHURN = 100, 10_000, 20, 0.07
BOX = 100.0
PM_GRID = 256
#: savefile angles vs float64: f16 storage plus the f32 arccos of
#: nearly parallel unit vectors (the savefile tolerance class of
#: tests/test_engine.py and tests/test_reference_parity.py)
ANGLE_ATOL = 4e-3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them; exits when
    there is no NVIDIA card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        sys.exit(f"no GPU: nvidia-smi unavailable ({exc})")
    if out.returncode != 0 or not out.stdout.strip():
        sys.exit(f"no GPU: nvidia-smi exit {out.returncode}")
    return out.stdout.strip()


class Phase:
    """Times a phase; ``compile_s`` is filled in by the phase."""

    def __init__(self, name):
        self.name = name
        self.compile_s = 0.0

    def __enter__(self):
        log(f"--- phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: wall {time.perf_counter() - self.t0:.3f}"
                f" s, compile {self.compile_s:.3f} s")
        return False


def check(name, value, limit, ok):
    log(f"check {name}: {value!r} (limit {limit})")
    if not ok:
        raise AssertionError(f"{name} = {value!r} fails its limit {limit}")


# ----------------------------------------------------------------------
# gpu-marked tests
# ----------------------------------------------------------------------

def run_gpu_tests():
    with Phase("gpu-tests"):
        env = dict(os.environ, ORBIT_TPU_TEST_PLATFORM="gpu")
        r = subprocess.run(
            [sys.executable, "-m", "pytest",
             os.path.join(ROOT, "tests", "test_gpu.py"),
             "-m", "gpu", "-q", "-p", "no:cacheprovider"],
            cwd=ROOT, env=env, capture_output=True, text=True,
        )
        tail = r.stdout.strip().splitlines()[-1:] if r.stdout else []
        log("gpu-marked tests:", tail[0] if tail else "(no output)")
        if r.returncode != 0:
            log(r.stdout[-4000:], r.stderr[-4000:])
            raise AssertionError(f"gpu-marked tests failed (rc {r.returncode})")


# ----------------------------------------------------------------------
# tracker: config-2 deployment
# ----------------------------------------------------------------------

def config2_data(n_halos, seed=0):
    """Config-2 workload: bench.py's orbit pool with ~7 %/snapshot
    membership churn; rows hold 10,000 members of an 11,112-slot pool,
    shifted so halos near the box edge straddle the periodic seam."""
    sys.path.insert(0, ROOT)
    import bench

    capacity = int(np.ceil(N_TRACKED / 0.9))
    orbits = bench.make_orbits(n_halos, capacity, N_SNAPS, seed=seed)
    ids, pos, vel, centers, n_valid = bench.make_churn_sequence(
        orbits, churn=CHURN)
    assert n_valid == N_TRACKED, n_valid
    shift = np.float32(80.0)
    pos = np.mod(pos[:, :, :n_valid] + shift, BOX).astype(np.float32)
    centers = np.mod(np.asarray(centers[0]) + shift, BOX).astype(np.float32)
    return ids[:, :, :n_valid], pos, vel[:, :, :n_valid], centers


def _oracle_halo(args):
    """Float64 oracle events of one halo over the whole sequence, both
    modes: ``[(peri_ids, peri_angles, apo_ids, apo_angles)] per
    snapshot``."""
    ids, pos, vel, center, box = args
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import OracleTracker

    trackers = [OracleTracker(m, box_size=box, angle_dtype=np.float64)
                for m in ("pericentric", "apocentric")]
    out = []
    for s in range(ids.shape[0]):
        evs = []
        for t in trackers:
            ev = t.step({0: dict(ids=ids[s], pos=pos[s], vel=vel[s],
                                 center=center, mass=np.ones(ids.shape[1]))})
            evs.extend(ev[0][:2])
        out.append(evs)
    return out


def oracle_events(ids, pos, vel, centers):
    """Oracle over every halo in worker processes that never import
    JAX (spawned, so they cannot touch the card)."""
    import multiprocessing as mp

    jobs = [(ids[:, h], pos[:, h], vel[:, h], centers[h], BOX)
            for h in range(ids.shape[1])]
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(len(jobs), max(1, (os.cpu_count() or 2) - 2))) as pool:
        per_halo = pool.map(_oracle_halo, jobs)
    return per_halo


def make_callbacks(ids, pos, vel, centers):
    n_halos = ids.shape[1]

    def regions(snapshot_number, halo_ids):
        return centers[halo_ids], np.full(len(halo_ids), 20.0)

    def load(snapshot_number, region_positions, region_radii):
        assert len(region_positions) == n_halos
        s = int(snapshot_number)
        n = ids.shape[2]
        return dict(
            ids=ids[s].reshape(-1), coordinates=pos[s].reshape(-1, 3),
            velocities=vel[s].reshape(-1, 3), masses=1.0,
            region_offsets=np.arange(n_halos) * n, box_size=BOX,
        )

    return regions, load


class MemorySavefiles:
    """Stands in for the HDF5 writer when h5py is absent: records what
    ``append_snapshot`` would write, with the same dataset names and
    storage dtypes."""

    def __init__(self):
        self.files = {}

    def initialize(self, savefile, mode, box_size, verbose=True):
        self.files[savefile] = {}

    def append(self, savefile, snapshot_number, mode, apsis_ids,
               apsis_offsets, apsis_angles, halo_ids, final_descendant_ids,
               region_radii, region_positions, bulk_velocities,
               verbose=True, angle_store_dtype=np.float16):
        from orbitanalysis_tpu.engine.io_hdf5 import apsis_tag

        g = {
            "region_offsets": np.asarray(apsis_offsets),
            apsis_tag(mode) + "_IDs": np.asarray(apsis_ids),
            "angles": np.asarray(apsis_angles, dtype=angle_store_dtype),
            "halo_IDs": np.asarray(halo_ids),
            "region_radii": np.asarray(region_radii),
            "region_positions": np.asarray(region_positions),
            "bulk_velocities": np.asarray(bulk_velocities),
        }
        if final_descendant_ids is not None:
            g["final_descendant_IDs"] = np.asarray(final_descendant_ids)
        self.files[savefile]["snapshot_%03d" % snapshot_number] = g


def savefile_store():
    """``None`` when h5py writes real savefiles; otherwise a
    :class:`MemorySavefiles` installed in place of the HDF5 writer."""
    from orbitanalysis_tpu.engine import io_hdf5

    try:
        import h5py  # noqa: F401
        log("savefiles: HDF5 via h5py")
        return None
    except ImportError:
        memory = MemorySavefiles()
        io_hdf5.initialize_savefile = memory.initialize
        io_hdf5.append_snapshot = memory.append
        log("savefiles: HDF5 writer NOT exercised — h5py is not installed "
            "on this machine; the tracker's savefile writes are captured "
            "in memory (callbacks, staging, steps and event fetch run "
            "unchanged)")
        return memory


def read_savefiles(memory, paths):
    return [memory.files[p] if memory else read_savefile(p)
            for p in paths]


def read_savefile(path):
    import h5py

    with h5py.File(path, "r") as hf:
        return {k: {d: hf[k][d][:] for d in hf[k]} for k in hf}


#: an event may differ between two engines only at a knife edge: a
#: particle whose float64 radial velocity at one of the two snapshots
#: is below this fraction of the halo's rms peculiar speed, so that the
#: engines' different float32 summation orders of the bulk velocity
#: (atomics on the GPU, psum across cards) can flip its sign
KNIFE_EDGE = 1e-5


def relative_radial_speed(data, s, h, pid):
    """|v_r| / rms |v - bulk| of particle ``pid`` of halo ``h`` at
    snapshot ``s``, in float64 (inf when not a member then)."""
    ids, pos, vel, centers = data
    k = np.flatnonzero(ids[s, h] == pid)
    if not len(k):
        return np.inf
    v = vel[s, h].astype(np.float64)
    dv = v - v.mean(0)
    rel = pos[s, h, k[0]].astype(np.float64) - centers[h]
    rel -= BOX * np.round(rel / BOX)
    vr = dv[k[0]] @ (rel / np.linalg.norm(rel))
    return abs(vr) / np.sqrt((dv * dv).sum(1).mean())


def engines_match(fa, fb, data, what):
    """Two engines' savefile contents agree: event sets per halo per
    snapshot identical except at knife-edge particles (see
    :data:`KNIFE_EDGE`), angles of common events within ANGLE_ATOL,
    bulk velocities to ~1 f32 ulp, everything else exact.  Returns
    ``(events, differing events, worst knife edge, max angle diff, max
    bulk diff)``."""
    assert sorted(fa) == sorted(fb), what
    n_events = n_diff = 0
    edge = d_ang = d_bulk = 0.0
    for k in fa:
        a, b = fa[k], fb[k]
        assert sorted(a) == sorted(b), (what, k)
        tag = next(ds for ds in a if ds.endswith("_IDs")
                   and ds.startswith(("peri", "apo")))
        for ds in a:
            if ds in ("region_offsets", tag, "angles"):
                continue
            if ds == "bulk_velocities":
                np.testing.assert_allclose(a[ds], b[ds], rtol=2e-6,
                                           atol=1e-6, err_msg=f"{what} {k}")
                d_bulk = max(d_bulk, float(np.abs(a[ds] - b[ds]).max()))
            else:
                assert np.array_equal(a[ds], b[ds]), (what, k, ds)
        s = int(k.split("_")[1])
        oa, ob = a["region_offsets"], b["region_offsets"]
        for h, halo in enumerate(a["halo_IDs"]):
            ia, ib = a[tag][oa[h]:oa[h + 1]], b[tag][ob[h]:ob[h + 1]]
            common, xa, xb = np.intersect1d(ia, ib, return_indices=True)
            n_events += len(ia)
            if len(common):
                diff = np.abs(
                    a["angles"][oa[h]:][xa].astype(np.float32)
                    - b["angles"][ob[h]:][xb].astype(np.float32))
                d_ang = max(d_ang, float(diff.max()))
            for pid in np.setxor1d(ia, ib):
                n_diff += 1
                e = min(relative_radial_speed(data, s - 1, int(halo), pid),
                        relative_radial_speed(data, s, int(halo), pid))
                log(f"  {what}: {tag} {pid} halo {halo} snapshot {s} "
                    f"differs; min |v_r|/rms = {e:.3e}")
                edge = max(edge, e)
    assert d_ang <= ANGLE_ATOL, (what, d_ang)
    assert edge < KNIFE_EDGE, (what, edge)
    return n_events, n_diff, edge, d_ang, d_bulk


def events_match_oracle(peri, apo, oracle, n_halos, what):
    """Savefile event sets == oracle event sets (IDs exact per halo per
    snapshot, both modes; angles within :data:`ANGLE_ATOL` of the
    float64 values); returns the largest angle difference."""
    worst = 0.0
    for mi, (tag, f) in enumerate((("pericenter", peri),
                                   ("apocenter", apo))):
        for s in range(1, N_SNAPS):
            g = f["snapshot_%03d" % s]
            offs = g["region_offsets"]
            ids = g[tag + "_IDs"]
            ang = g["angles"].astype(np.float64)
            assert len(offs) == n_halos + 1, (what, s)
            for h in range(n_halos):
                got = ids[offs[h]:offs[h + 1]]
                o_ids = oracle[h][s][2 * mi]
                o_ang = oracle[h][s][2 * mi + 1]
                assert np.array_equal(np.sort(got), np.sort(o_ids)), (
                    what, tag, s, h, len(got), len(o_ids))
                if len(got):
                    order_g = np.argsort(got)
                    order_o = np.argsort(o_ids)
                    a_g = ang[offs[h]:offs[h + 1]][order_g]
                    a_o = o_ang[order_o]
                    err = float(np.abs(a_g - a_o).max())
                    assert err <= ANGLE_ATOL, (what, tag, s, h, err)
                    worst = max(worst, err)
    return worst


def run_tracker(phase, outdir):
    from orbitanalysis_tpu import track_orbits
    from orbitanalysis_tpu.policy import join_engine

    log("auto engine for int32 IDs here:",
        join_engine(np.int32, np.float32))
    t0 = time.perf_counter()
    ids, pos, vel, centers = config2_data(N_HALOS)
    log(f"config-2 data: {N_HALOS} halos x {N_TRACKED} tracked x {N_SNAPS} "
        f"snapshots, box {BOX}, churn {CHURN} "
        f"({time.perf_counter() - t0:.3f} s to build)")
    t0 = time.perf_counter()
    oracle = oracle_events(ids, pos, vel, centers)
    log(f"float64 oracle: {time.perf_counter() - t0:.3f} s")

    memory = savefile_store()
    regions, load = make_callbacks(ids, pos, vel, centers)
    snap_nums = np.arange(N_SNAPS)
    branches = np.tile(np.arange(N_HALOS), (N_SNAPS, 1))
    results = {}
    for join in ("aligned", "general"):
        paths = (os.path.join(outdir, f"{join}_peri.h5"),
                 os.path.join(outdir, f"{join}_apo.h5"))
        walls = []
        for rep in range(2):   # first run compiles, second is warm
            t0 = time.perf_counter()
            track_orbits(snap_nums, branches, regions, load, paths,
                         mode="both", join_impl=join, verbose=False)
            walls.append(time.perf_counter() - t0)
        phase.compile_s += max(walls[0] - walls[1], 0.0)
        log(f"track_orbits join_impl={join!r} mode='both': first run "
            f"{walls[0]:.3f} s, warm run {walls[1]:.3f} s "
            f"({N_HALOS * N_TRACKED * (N_SNAPS - 1) / walls[1]:.6e} "
            "particle-snapshot updates/s, both catalogs, warm)")
        results[join] = read_savefiles(memory, paths)
        worst = events_match_oracle(*results[join], oracle, N_HALOS, join)
        check(f"{join} event sets == float64 oracle (max |angle| diff, "
              "rad)", worst, ANGLE_ATOL, True)
    for tag, fa, fg in zip(("peri", "apo"), results["aligned"],
                           results["general"]):
        res = engines_match(fa, fg, (ids, pos, vel, centers),
                            f"aligned vs general {tag}")
        check(f"aligned vs general {tag} savefile (events, differing "
              "events, worst knife edge, max |angle| diff, max |bulk| "
              "diff)", res, "no differing events; angles atol 4e-3, bulk "
              "rtol 2e-6 atol 1e-6", res[1] == 0)


# ----------------------------------------------------------------------
# PM forces at 256^3
# ----------------------------------------------------------------------

def numpy_pm(pos, mass, grid, box):
    """float64 NumPy PM of the package's scheme: CIC deposit by
    ``np.bincount``, the same Green's function through ``np.fft``,
    spectral gradient without the Nyquist planes, CIC interpolation.

    """
    h = box / grid
    x = pos.astype(np.float64) / h - 0.5
    i0 = np.floor(x)
    f = x - i0
    i0 = i0.astype(np.int64) % grid
    rho = np.zeros(grid ** 3)
    corners = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
               for dz in (0, 1)]
    flat, wts = [], []
    for dx, dy, dz in corners:
        w = ((f[:, 0] if dx else 1 - f[:, 0])
             * (f[:, 1] if dy else 1 - f[:, 1])
             * (f[:, 2] if dz else 1 - f[:, 2]))
        idx = (((i0[:, 0] + dx) % grid) * grid
               + (i0[:, 1] + dy) % grid) * grid + (i0[:, 2] + dz) % grid
        rho += np.bincount(idx, weights=w * mass, minlength=grid ** 3)
        flat.append(idx)
        wts.append(w)
    rho = rho.reshape(grid, grid, grid)
    rho_k = np.fft.rfftn(rho)
    kx = np.fft.fftfreq(grid)[:, None, None] * 2 * np.pi
    ky = np.fft.fftfreq(grid)[None, :, None] * 2 * np.pi
    kz = np.fft.rfftfreq(grid)[None, None, :] * 2 * np.pi
    k2 = kx * kx + ky * ky + kz * kz

    def nyquist_free(k):   # the gradient drops the Nyquist planes
        return np.where(np.abs(k) == np.pi, 0.0, k)

    with np.errstate(divide="ignore"):
        green = np.where(k2 > 0, -4 * np.pi / k2, 0.0)
    green = green * (h * h) / h ** 3
    phi_k = green * rho_k
    acc = np.zeros((len(pos), 3))
    for c, kvec in enumerate((kx, ky, kz)):
        field = np.fft.irfftn(-1j * nyquist_free(kvec) / h * phi_k,
                              s=(grid,) * 3, axes=(0, 1, 2))
        field = field.reshape(-1)
        for idx, w in zip(flat, wts):
            acc[:, c] += field[idx] * w
    return acc


def run_pm(phase):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.models.pm import pm_forces
    from orbitanalysis_tpu.policy import interpolation

    grid = PM_GRID
    # box in cell units: every float32 cell coordinate pos / h - 0.5 is
    # then exact, so the comparison measures the FFTs and the deposit
    # (with box = 100 the float32 rounding of the cell coordinates alone
    # is ~1.4e-5 of relative force at this grid — PERF.md)
    box = float(grid)
    n = grid ** 3
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0, np.float32)
    log(f"PM: {n} particles on a {grid}^3 grid, interpolation "
        f"{interpolation(grid)!r}")

    f = jax.jit(lambda p, m: pm_forces(p, m, grid, box))
    dpos, dmass = jnp.asarray(pos), jnp.asarray(mass)
    t0 = time.perf_counter()
    acc = np.asarray(jax.block_until_ready(f(dpos, dmass)))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(f(dpos, dmass))
    t_warm = time.perf_counter() - t0
    phase.compile_s += max(t_first - t_warm, 0.0)
    log(f"pm_forces: first call {t_first:.3f} s, warm {t_warm:.6f} s")
    t0 = time.perf_counter()
    ref = numpy_pm(pos, mass.astype(np.float64), grid, box)
    log(f"float64 NumPy PM: {time.perf_counter() - t0:.3f} s")
    assert np.isfinite(acc).all()
    rel = float(np.linalg.norm(acc - ref) / np.linalg.norm(ref))
    check("PM accelerations vs float64 NumPy PM (relative L2)", rel,
          1e-5, rel <= 1e-5)

    run_tracked_pm(phase, grid, box)


def halo_ics(n_halos, per_halo, box, seed=7):
    """Gaussian halos of unit-mass particles (G = 1) at random centres
    in a periodic box, with the virial velocity dispersion of a Gaussian
    sphere about a bulk velocity.  Every member lies well inside half a
    box of its centre, so no minimum image is ambiguous."""
    rng = np.random.default_rng(seed)
    r_s = box / 25.6
    sigma_v = np.sqrt(per_halo / (6 * np.sqrt(np.pi) * r_s))
    centres = rng.uniform(0, box, size=(n_halos, 1, 3))
    bulk = rng.normal(scale=sigma_v / 2, size=(n_halos, 1, 3))
    pos = centres + rng.normal(scale=r_s, size=(n_halos, per_halo, 3))
    vel = bulk + rng.normal(scale=sigma_v, size=(n_halos, per_halo, 3))
    pos = np.mod(pos, box).astype(np.float32).reshape(-1, 3)
    return pos, vel.astype(np.float32).reshape(-1, 3)


def frames64(pos, vel, n_halos, box):
    """Float64 region frames of ``_halo_frames`` with unit masses and
    ``members = arange(n).reshape(n_halos, -1)``: ``(rhat, v_r, radius,
    rms peculiar speed per halo)``."""
    pos = pos.astype(np.float64).reshape(n_halos, -1, 3)
    vel = vel.astype(np.float64).reshape(n_halos, -1, 3)

    def wrap(d):
        return d - box * np.round(d / box)

    anchor = pos[:, :1]
    centre = anchor + wrap(pos - anchor).mean(1, keepdims=True)
    dv = vel - vel.mean(1, keepdims=True)
    rel = wrap(pos - centre)
    radius = np.linalg.norm(rel, axis=-1)
    rhat = rel / radius[..., None]
    vr = (dv * rhat).sum(-1)
    rms = np.sqrt((dv * dv).sum(-1).mean(1, keepdims=True))
    return rhat, vr, radius, rms


#: an on-the-fly count may differ from the float64 detector only at a
#: particle whose float64 |v_r| at one of the three detections is below
#: this fraction of its halo's rms peculiar speed (float32 frames can
#: flip its sign), or at a sign flip where every angle increment since
#: the last apsis is below ANGLE_EDGE rad: the float32 dot product of
#: two unit vectors that close rounds to 1, its arccos is 0, and the
#: accumulated angle fails ``angle > angle_cut = 0``
VR_EDGE = 1e-4
ANGLE_EDGE = 2e-3


def detect64(states, n_halos, box):
    """Float64 detector over the states at detections 0, 1, 2 (seed,
    then every ``detect_every`` steps): per-particle pericentre and
    apocentre counts, the particles at a knife edge (see
    :data:`VR_EDGE`), and per-particle diagnostics (``vr_rms``: v_r /
    rms at each detection; ``radius``; ``angle``: accumulated angle at
    detections 1 and 2 per mode)."""
    frames = [frames64(p, v, n_halos, box) for p, v in states]
    edge = np.zeros(frames[0][1].shape, bool)
    for _, vr, _, rms in frames:
        edge |= np.abs(vr) < VR_EDGE * rms
    counts, angles = [], []
    for sign in (1, -1):             # pericentric, apocentric
        angle = np.zeros_like(edge, dtype=np.float64)
        step_max = np.zeros_like(angle)   # largest increment since apsis
        n = np.zeros(edge.shape, np.int32)
        acc = []
        for (rh0, vr0, _, _), (rh1, vr1, _, _) in zip(frames, frames[1:]):
            dtheta = np.arccos(np.clip((rh0 * rh1).sum(-1), -1.0, 1.0))
            angle = angle + dtheta
            step_max = np.maximum(step_max, dtheta)
            acc.append(angle.reshape(-1))
            flip = (sign * vr0 < 0) & (sign * vr1 > 0)
            n += flip & (angle > 0)
            edge |= flip & (step_max < ANGLE_EDGE)
            angle = np.where(flip, 0.0, angle)
            step_max = np.where(flip, 0.0, step_max)
        counts.append(n.reshape(-1))
        angles.append(acc)
    info = dict(
        vr_rms=[(vr / rms).reshape(-1) for _, vr, _, rms in frames],
        radius=[r.reshape(-1) for _, _, r, _ in frames],
        angle=angles,
    )
    return counts, edge.reshape(-1), frames[-1][1].reshape(-1), info


def counts_agree(got, want, edge, what, info, mode):
    """Per-particle counts equal except at knife-edge particles (each
    other difference is printed with its float64 state); returns
    ``(events, differing particles)``."""
    diff = got != want
    n_diff = int(diff.sum())
    off = np.flatnonzero(diff & ~edge)
    log(f"  {what}: {int(want.sum())} passages, {n_diff} particles "
        f"differ, {int(edge.sum())} at a knife edge, {len(off)} differ "
        "off the edge")
    for i in off[:20]:
        log(f"    particle {i}: got {got[i]} want {want[i]}; v_r/rms "
            f"{[float(v[i]) for v in info['vr_rms']]}, radius "
            f"{[float(r[i]) for r in info['radius']]}, angle "
            f"{[float(a[i]) for a in info['angle'][mode]]}")
    assert len(off) == 0, (what, len(off))
    return int(want.sum()), n_diff


def run_tracked_pm(phase, grid, box):
    """``simulate_with_tracking`` on the PM force, mode='both',
    detect_every=4: one 8-step call (timed), and the same run in two
    resumed 4-step calls whose states at each detection are fetched and
    run through the float64 detector :func:`detect64`."""
    import jax.numpy as jnp

    from orbitanalysis_tpu.models import NBodyState, OrbitNBodyConfig
    from orbitanalysis_tpu.models.nbody import simulate_with_tracking
    from orbitanalysis_tpu.models.pm import make_pm_force_fn

    n, H = grid ** 3, 64
    pos, vel = halo_ics(H, n // H, box)
    members = np.arange(n, dtype=np.int32).reshape(H, -1)
    mass = jnp.ones(n, jnp.float32)
    state = NBodyState(jnp.asarray(pos), jnp.asarray(vel), mass)
    force = make_pm_force_fn(grid)
    cfg = OrbitNBodyConfig(dt=2e-3, n_steps=8, detect_every=4, mode="both",
                           box_size=box, softening=0.0)
    walls = []
    for _ in range(2):   # first run compiles, second is warm
        t0 = time.perf_counter()
        st, trs, ev = simulate_with_tracking(state, members, cfg, force)
        fused = [np.asarray(t.counts).reshape(-1) for t in trs]
        walls.append(time.perf_counter() - t0)
    phase.compile_s += max(walls[0] - walls[1], 0.0)
    log(f"simulate_with_tracking {H} halos x {n // H} particles, 8 KDK "
        f"steps, detect_every=4, mode='both': first {walls[0]:.3f} s, "
        f"warm {walls[1]:.6f} s ({walls[1] / 8:.6f} s/step); events per "
        f"detection (peri, apo) {np.asarray(ev)[3::4].tolist()}")
    pos_fused = np.asarray(st.pos)
    assert np.isfinite(pos_fused).all()

    half = cfg._replace(n_steps=4)
    st4, trs4, _ = simulate_with_tracking(state, members, half, force)
    states = [(pos, vel), (np.asarray(st4.pos), np.asarray(st4.vel))]
    st8, trs8, _ = simulate_with_tracking(st4, members, half, force,
                                          track=trs4, step_offset=4)
    states.append((np.asarray(st8.pos), np.asarray(st8.vel)))
    dpos = float(np.abs(pos_fused - states[-1][0]).max())
    check("one 8-step call vs two resumed 4-step calls (max |pos diff|, "
          "cells)", dpos, 1e-3, dpos <= 1e-3)

    t0 = time.perf_counter()
    want, edge, vr64, info = detect64(states, H, box)
    log(f"float64 detector: {time.perf_counter() - t0:.3f} s")
    vr32 = np.asarray(trs8[0].vrad).reshape(-1)
    rel = float(np.linalg.norm(vr32 - vr64) / np.linalg.norm(vr64))
    check("detector v_r at step 8 vs float64 (relative L2)", rel, 1e-5,
          rel <= 1e-5)
    res = []
    for mode, (tag, tr, f, w) in enumerate(zip(("peri", "apo"), trs8,
                                               fused, want)):
        res.append(counts_agree(np.asarray(tr.counts).reshape(-1), w, edge,
                                f"resumed calls vs float64 {tag}", info,
                                mode))
        res.append(counts_agree(f, w, edge, f"one call vs float64 {tag}",
                                info, mode))
    check("on-the-fly counts vs float64 detector ((passages, differing "
          "particles) per run and mode)", res,
          f"differences only at knife edges (|v_r| < {VR_EDGE} rms, or "
          f"every angle increment < {ANGLE_EDGE} rad at a flip)", True)


def run_kepler(phase):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "config4_onthefly_e2e",
        os.path.join(ROOT, "benchmarks", "config4_onthefly_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    within1, missed4, missed1 = mod.run_oracle(
        argparse.Namespace(particles=16384))
    check("Kepler: fraction within +-1 of closed form at 4x cadence",
          within1, ">= 0.99", within1 >= 0.99)


def run_direct(phase):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.models.nbody import make_direct_force_fn
    from orbitanalysis_tpu.policy import direct_force_impl

    n, box = 16384, 10.0
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ref = np.zeros((n, 3))
    p64 = pos.astype(np.float64)
    for i0 in range(0, n, 512):
        d = p64[None, :, :] - p64[i0:i0 + 512, None, :]
        d -= box * np.round(d / box)
        d2 = np.maximum((d * d).sum(-1) + 0.01, 1e-18)
        ref[i0:i0 + 512] = ((mass[None, :] / d2 ** 1.5)[..., None]
                            * d).sum(1)
    force = make_direct_force_fn(use_pallas=True)
    f = jax.jit(lambda p, m: force(p, m, softening=0.1, box_size=box))
    t0 = time.perf_counter()
    got = np.asarray(jax.block_until_ready(f(jnp.asarray(pos),
                                             jnp.asarray(mass))))
    phase.compile_s += time.perf_counter() - t0
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    # f32 sums of 16384 nearly cancelling pair terms (uniform periodic
    # box): the same bound the plain-XLA blocked form meets
    check(f"direct forces ({direct_force_impl()}) at N={n} vs float64 "
          "(relative L2)", rel, 5e-4, rel <= 5e-4)


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

def run_four(outdir):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu import track_orbits
    from orbitanalysis_tpu.models.pm import pm_forces
    from orbitanalysis_tpu.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu.parallel import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 cards, JAX found {len(devs)}")
    memory = savefile_store()

    # record which cards the hash engine's carry lives on
    from orbitanalysis_tpu.engine import tracker as trk

    hash_devices = set()
    hash_step = trk._HashEngine.step

    def recording_step(self, *a):
        ev = hash_step(self, *a)
        hash_devices.update(d.id for d in self.carry.ids.sharding.device_set)
        return ev

    trk._HashEngine.step = recording_step

    with Phase("hash-tracker-4x"):
        n_h = 4 * N_HALOS
        ids, pos, vel, centers = config2_data(n_h, seed=1)
        regions, load = make_callbacks(ids, pos, vel, centers)
        snap_nums = np.arange(N_SNAPS)
        branches = np.tile(np.arange(n_h), (N_SNAPS, 1))
        mesh = make_mesh({"shards": 4}, devs[:4])
        out = {}
        for tag, kw in (("hash", dict(mesh=mesh)),
                        ("aligned", dict(join_impl="aligned"))):
            paths = (os.path.join(outdir, f"four_{tag}_peri.h5"),
                     os.path.join(outdir, f"four_{tag}_apo.h5"))
            t0 = time.perf_counter()
            track_orbits(snap_nums, branches, regions, load, paths,
                         mode="both", verbose=False, **kw)
            wall = time.perf_counter() - t0
            log(f"track_orbits {tag} (4x config 2, {n_h} halos, mode "
                f"'both'): {wall:.3f} s incl. compile")
            out[tag] = read_savefiles(memory, paths)
        log(f"hash engine carry on devices {sorted(hash_devices)}")
        assert hash_devices == {d.id for d in devs[:4]}, hash_devices
        for tag, fh, fa in zip(("peri", "apo"), out["hash"],
                               out["aligned"]):
            res = engines_match(fh, fa, (ids, pos, vel, centers),
                                f"hash vs aligned {tag}")
            check(f"hash-sharded (4 cards) vs one-card aligned {tag} "
                  "savefile (events, differing events, worst knife edge, "
                  "max |angle| diff, max |bulk| diff)", res,
                  f"differences only at knife edges < {KNIFE_EDGE}; "
                  "angles atol 4e-3, bulk rtol 2e-6 atol 1e-6", True)

    with Phase("slab-pm-4") as ph:
        grid, n = PM_GRID, PM_GRID ** 3 // 8
        rng = np.random.default_rng(6)
        pos = jnp.asarray(rng.uniform(0, BOX, size=(n, 3)).astype(
            np.float32))
        mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
        with jax.default_device(devs[0]):
            ref = np.asarray(jax.jit(
                lambda p, m: pm_forces(p, m, grid, BOX))(pos, mass))
        mesh = make_mesh({"x": 4}, devs[:4])
        f = make_slab_resident_pm_force_fn(mesh, grid)
        t0 = time.perf_counter()
        got_arr = jax.jit(lambda p, m: f(p, m, box_size=BOX))(pos, mass)
        got = np.asarray(got_arr)
        ph.compile_s += time.perf_counter() - t0
        used = sorted(d.id for d in got_arr.sharding.device_set)
        log(f"slab PM output sharded over devices {used}")
        assert used == sorted(d.id for d in devs[:4]), used
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        mx = float(np.abs(got - ref).max() / np.abs(ref).max())
        check("slab-resident PM (4 cards) vs single-device pm_forces "
              "(relative L2; max-abs / max|ref|)", (rel, mx), 1e-4,
              rel <= 1e-4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()

    card = card_line()
    import jax

    log("card:", card)
    log("jax", jax.__version__)
    if not args.four:
        run_gpu_tests()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX found {dev.platform!r} devices only")
    from orbitanalysis_tpu import native
    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    log("compile cache:", enable_compilation_cache())
    log("host staging:", "native C++ tier" if native.ensure() is not None
        else "NumPy fallback")
    outdir = os.path.join(ROOT, "chiprun_out", "chip_smoke")
    os.makedirs(outdir, exist_ok=True)

    if args.four:
        run_four(outdir)
    else:
        with Phase("tracker") as ph:
            run_tracker(ph, outdir)
        with Phase("pm") as ph:
            run_pm(ph)
        with Phase("kepler") as ph:
            run_kepler(ph)
        with Phase("direct") as ph:
            run_direct(ph)

    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
