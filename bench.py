"""Benchmark: particle-snapshot orbit updates/sec/card.

Times the framework's per-snapshot orbit step driven by the
``lax.scan`` sequence driver (:mod:`orbitanalysis_tpu.engine.scan`) on the
GPU — headline number on a ~7 %/snapshot membership-churn workload
through the stable-layout aligned engine (host staging absorbs the
join, the device runs elementwise detection plus the event compaction
every step), with the sorted merge-join engine and the
fixed-membership static path reported alongside — against
a clean-room NumPy implementation of the
reference algorithm's per-halo snapshot loop (the cost profile of
``/root/reference/orbitanalysis/track_orbits.py:247-351``: per-halo
recenter + bulk velocity + radial velocity, double-argsort ID join,
sign-flip detection, angle accumulate) measured on the same machine.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, ...}

Device metrics come only from a GPU: without one the script exits
non-zero before measuring anything.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Before numpy import: numpy madvises MADV_HUGEPAGE on large malloc'd
# blocks; under THP defrag=madvise each 2 MB first-touch fault can run
# direct compaction on a fragmented host — measured 13-21 ms/MB (vs
# 0.4-0.6 without), which dominated sequence generation and staging.
# The benchmark's host arrays are written once and streamed, so huge
# pages buy nothing here.
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np  # noqa: E402


_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:6.1f}s]", *a,
          file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def time_steady(fn, *args, repeats=5):
    """Seconds per call of an already-compiled ``fn(*args)``, each call
    ended by ``block_until_ready``.  Returns ``(median, stats)`` with
    the min, median and ``rel_spread = (max - min) / min`` of the
    samples."""
    import jax

    jax.block_until_ready(fn(*args))  # warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2]
    return med, {
        "samples": len(ts),
        "min": ts[0],
        "median": med,
        "rel_spread": (ts[-1] - ts[0]) / ts[0],
    }


# ----------------------------------------------------------------------
# synthetic benchmark data: smooth orbital motion, fixed membership
# ----------------------------------------------------------------------

INVALID_I32 = np.iinfo(np.int32).max


def make_orbits(n_halos, capacity, n_snaps, seed=0):
    """Full-pool orbital motion: ``(ids, pos, vel, centers)`` with
    ``pos``/``vel`` shaped ``[S, H, C, 3]`` — shared by the churn and
    static sequences so the trig-heavy generation runs once."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(20.0, 80.0, size=(n_halos, 3)).astype(np.float32)
    r0 = rng.uniform(0.5, 5.0, size=(n_halos, capacity)).astype(np.float32)
    omega = (1.0 / r0**1.5).astype(np.float32)
    phase0 = rng.uniform(0, 2 * np.pi, size=(n_halos, capacity)).astype(
        np.float32
    )
    axis_x = rng.normal(size=(n_halos, capacity, 3)).astype(np.float32)
    axis_x /= np.linalg.norm(axis_x, axis=-1, keepdims=True)
    tmp = rng.normal(size=(n_halos, capacity, 3)).astype(np.float32)
    tmp -= (tmp * axis_x).sum(-1, keepdims=True) * axis_x
    axis_y = (tmp / np.linalg.norm(tmp, axis=-1, keepdims=True)).astype(
        np.float32
    )

    ids = np.arange(n_halos * capacity, dtype=np.int32).reshape(
        n_halos, capacity
    )
    # shuffle within rows so the join's sort does real work
    for h in range(n_halos):
        ids[h] = ids[h][np.argsort(rng.random(capacity), kind="stable")]

    # eccentric-like orbits: radial breathing on top of the circular
    # motion gives every particle a well-defined v_r sign (pure circular
    # orbits have v_r ~ 0, so sign flips would be numerical noise),
    # with random phases so apsis events spread across snapshots
    ecc = rng.uniform(0.2, 0.5, size=(n_halos, capacity)).astype(np.float32)
    phase_r = rng.uniform(0, 2 * np.pi, size=(n_halos, capacity)).astype(
        np.float32
    )
    dt = np.float32(0.3)
    pos = np.empty((n_snaps, n_halos, capacity, 3), dtype=np.float32)
    vel = np.empty_like(pos)
    for s in range(n_snaps):
        ph = phase0 + omega * (s * dt)
        phr = phase_r + omega * (s * dt)
        r = r0 * (1.0 + ecc * np.sin(phr))
        rdot = r0 * ecc * omega * np.cos(phr)
        cph, sph = np.cos(ph), np.sin(ph)
        pos[s] = (
            center[:, None, :]
            + r[..., None] * (cph[..., None] * axis_x
                              + sph[..., None] * axis_y)
        )
        vel[s] = (
            rdot[..., None] * (cph[..., None] * axis_x
                               + sph[..., None] * axis_y)
            + (r * omega)[..., None] * (
                -sph[..., None] * axis_x + cph[..., None] * axis_y
            )
        )
    centers_seq = np.broadcast_to(center, (n_snaps, n_halos, 3))
    return ids, pos, vel, centers_seq, rng


def make_static_sequence(orbits):
    """Fixed membership — the static fast path.

    Returns ``(ids_seq, pos, vel, centers_seq, n_valid)``.
    """
    ids, pos, vel, centers_seq, _ = orbits
    n_snaps, n_halos, capacity = pos.shape[:3]
    ids_seq = np.broadcast_to(ids, (n_snaps, n_halos, capacity))
    return ids_seq, pos, vel, centers_seq, capacity


def make_churn_sequence(orbits, churn, return_members=False):
    """Membership churn over the shared orbit pool.

    Each row tracks ``n_valid`` of its ``capacity``-sized orbit pool;
    per snapshot, ``churn * n_valid`` members swap against the reserve
    (constant count), exercising the entered/departed handling the
    tracker runs on real data (the reference's dynamic sets,
    ``track_orbits.py:300-309``); padding slots carry the int32-max
    sentinel and load order is shuffled per snapshot, like real data.
    Vectorized over halo rows (the per-row loop version cost minutes of
    host time at the benchmark shape).  Returns
    ``(ids_seq, pos, vel, centers_seq, n_valid)``.
    """
    ids, pos, vel, centers_seq, rng = orbits
    n_snaps, n_halos, capacity = pos.shape[:3]
    n_valid = int(capacity * 0.9)
    k = min(int(round(churn * n_valid)), capacity - n_valid)
    ids_seq = np.full((n_snaps, n_halos, capacity), INVALID_I32, np.int32)
    pos_c = np.zeros_like(pos)
    vel_c = np.zeros_like(vel)
    # member[h, c]: is pool slot c currently tracked by row h
    member = np.zeros((n_halos, capacity), dtype=bool)
    init = np.argsort(rng.random((n_halos, capacity)), axis=1)[:, :n_valid]
    np.put_along_axis(member, init, True, axis=1)
    rows = np.arange(n_halos)[:, None]
    member_seq = (
        np.empty((n_snaps, n_halos, capacity), bool)
        if return_members else None
    )
    for s in range(n_snaps):
        if s > 0 and k > 0:
            # drop k random members, then add k random non-members
            keys = np.where(member, rng.random((n_halos, capacity)), np.inf)
            drop = np.argpartition(keys, k - 1, axis=1)[:, :k]
            member[rows, drop] = False
            keys = np.where(member, np.inf, rng.random((n_halos, capacity)))
            add = np.argpartition(keys, k - 1, axis=1)[:, :k]
            member[rows, add] = True
        if member_seq is not None:
            member_seq[s] = member
        # members of each row in random order
        keys = np.where(member, rng.random((n_halos, capacity)), np.inf)
        sel = np.argsort(keys, axis=1)[:, :n_valid]
        ids_seq[s, :, :n_valid] = np.take_along_axis(ids, sel, axis=1)
        pos_c[s, :, :n_valid] = np.take_along_axis(
            pos[s], sel[..., None], axis=1
        )
        vel_c[s, :, :n_valid] = np.take_along_axis(
            vel[s], sel[..., None], axis=1
        )
    if member_seq is not None:
        return ids_seq, pos_c, vel_c, centers_seq, n_valid, member_seq
    return ids_seq, pos_c, vel_c, centers_seq, n_valid


def make_churn_workload(n_halos, capacity, n_snaps, seed=0, churn=0.07,
                        cache=True):
    """Cached :func:`make_orbits` + :func:`make_churn_sequence` (the
    round-4 review's item 6: host sequence generation cost 54.6 s of
    every bench run on the 1-core sandbox).  The cache stores the
    orbit pool planes plus the per-snapshot member/selection indices
    (~2.8 GB at the bench shape) under ``.bench_cache/`` keyed by the
    generation parameters; the churned sequence rebuilds from them
    with vectorized gathers in ~2 s.

    Returns ``(orbits, (ids_seq, pos_c, vel_c, centers_seq, n_valid),
    member_seq)`` where ``orbits`` is the :func:`make_orbits` tuple
    (``rng`` slot ``None`` on a cache hit — it is consumed by the
    sequence generation and never reused by the bench).
    """
    cdir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_cache",
        f"seq_H{n_halos}_P{capacity}_S{n_snaps}_s{seed}_c{churn:g}_v3",
    )
    marker = os.path.join(cdir, "complete")
    if cache and os.path.exists(marker):
        # raw .npy per array: one straight read each (an .npz would
        # re-inflate through zipfile CRC at ~400 MB/s: measured 37 s
        # for this 5.4 GB set vs ~5 s raw / ~1 s warm).  NOT mmap:
        # lazily-faulted pages made the downstream staging pass 3.5x
        # slower (285 -> 1011 ms/snapshot) — the one-time eager read
        # is cheaper than paying page faults inside the timed loops.
        def mm(name):
            return np.load(os.path.join(cdir, name + ".npy"))

        ids, pos, vel = mm("ids"), mm("pos"), mm("vel")
        center = np.load(os.path.join(cdir, "center.npy"))
        ids_seq, pos_c, vel_c = mm("ids_seq"), mm("pos_c"), mm("vel_c")
        n_valid = int(np.load(os.path.join(cdir, "n_valid.npy")))
        member_seq = np.unpackbits(
            np.load(os.path.join(cdir, "member_bits.npy")),
            count=n_snaps * n_halos * capacity,
        ).astype(bool).reshape(n_snaps, n_halos, capacity)
        centers_seq = np.broadcast_to(center, (n_snaps, n_halos, 3))
        orbits = (ids, pos, vel, centers_seq, None)
        return orbits, (ids_seq, pos_c, vel_c, centers_seq, n_valid), (
            member_seq
        )
    orbits = make_orbits(n_halos, capacity, n_snaps, seed=seed)
    ids_seq, pos_c, vel_c, centers_seq, n_valid, member_seq = (
        make_churn_sequence(orbits, churn, return_members=True)
    )
    if cache:
        os.makedirs(cdir, exist_ok=True)
        arrays = dict(
            ids=orbits[0], pos=orbits[1], vel=orbits[2],
            center=np.ascontiguousarray(centers_seq[0]),
            ids_seq=ids_seq, pos_c=pos_c, vel_c=vel_c,
            member_bits=np.packbits(member_seq),
            n_valid=np.int64(n_valid),
        )
        for name, arr in arrays.items():
            np.save(os.path.join(cdir, name + ".npy"), arr)
        with open(marker, "w") as f:
            f.write("ok\n")
    return orbits, (ids_seq, pos_c, vel_c, centers_seq, n_valid), (
        member_seq
    )


def make_label_sequence(orbits, member_seq):
    """The SAME churn workload, in the device-resident representation:
    the orbit pool as a global particle array (position-stable by
    construction) plus a per-snapshot halo LABEL per particle — what
    the native integrator / hash record pools look like on device.
    ``member_seq [S, H, C]`` is :func:`make_churn_sequence`'s recorded
    membership history, so the two engines run literally the same
    member sets and their event totals are directly comparable.
    Returns ``(label_seq [S, N], pos [S, 3, N], vel [S, 3, N],
    centers [S, H, 3], n_valid_total)``.
    """
    ids, pos, vel, centers_seq, _rng = orbits
    n_snaps, n_halos, capacity = pos.shape[:3]
    home = np.repeat(np.arange(n_halos, dtype=np.int32), capacity)
    label_seq = np.where(
        member_seq.reshape(n_snaps, -1), home[None, :], -1
    ).astype(np.int32)
    pos_l = np.ascontiguousarray(
        np.moveaxis(pos.reshape(n_snaps, -1, 3), -1, 1)
    )
    vel_l = np.ascontiguousarray(
        np.moveaxis(vel.reshape(n_snaps, -1, 3), -1, 1)
    )
    n_valid_total = int(member_seq[0].sum())
    return label_seq, pos_l, vel_l, np.ascontiguousarray(centers_seq), (
        n_valid_total
    )


def make_sequence(n_halos, capacity, n_snaps, seed=0, churn=0.0):
    """[S]-stacked snapshot sequence; see ``make_orbits`` /
    ``make_churn_sequence``.  Returns
    ``(ids_seq, pos, vel, centers_seq, n_valid)``."""
    orbits = make_orbits(n_halos, capacity, n_snaps, seed=seed)
    if churn <= 0.0:
        return make_static_sequence(orbits)
    return make_churn_sequence(orbits, churn)


# ----------------------------------------------------------------------
# NumPy baseline: reference-style per-halo loop (clean-room)
# ----------------------------------------------------------------------

def numpy_baseline_updates_per_s(ids_seq, pos_seq, vel_seq, centers_seq,
                                 box=100.0):
    n_snaps, n_halos, _ = ids_seq.shape
    t0 = time.perf_counter()
    n_events = 0
    n_updates = 0
    prev = [None] * n_halos
    for s in range(n_snaps):
        for h in range(n_halos):
            valid = ids_seq[s, h] != INVALID_I32
            ids = ids_seq[s, h][valid]
            npart = len(ids)
            if s > 0:
                n_updates += npart
            rel = pos_seq[s, h][valid] - centers_seq[s, h]
            rel -= box * np.round(rel / box)
            bulk = vel_seq[s, h][valid].mean(0)
            vrel = vel_seq[s, h][valid] - bulk
            r = np.sqrt(np.einsum("ij,ij->i", rel, rel))
            rhat = rel / r[:, None]
            vr = np.einsum("ij,ij->i", vrel, rhat)
            if prev[h] is not None:
                ids0, vr0, rhat0, ang0 = prev[h]
                in_prev = np.isin(ids, ids0)
                matched = ids[in_prev]
                # positions of the matched set on both sides (the
                # double-argsort _myin1d shortcut is only valid when the
                # sets coincide, i.e. the static-membership case)
                ci = np.flatnonzero(in_prev)
                sorter = np.argsort(ids0)
                pi = sorter[np.searchsorted(ids0, matched, sorter=sorter)]
                flip = (vr0[pi] < 0) & (vr[ci] > 0)
                dth = np.arccos(
                    np.clip(
                        np.einsum("ij,ij->i", rhat0[pi], rhat[ci]), -1, 1
                    )
                )
                ang = np.zeros(npart, dtype=np.float32)
                ang[ci] = ang0[pi] + dth
                n_events += int(flip.sum())
                ang_new = ang
                ang_new[ci[flip]] = 0.0
            else:
                ang_new = np.zeros(npart, dtype=np.float32)
            prev[h] = (ids, vr, rhat, ang_new)
    dt = time.perf_counter() - t0
    return n_updates / dt, n_events


# ----------------------------------------------------------------------
# device-resident churn: the label-native detector (no staging at all)
# ----------------------------------------------------------------------

def device_label_updates_per_s(label_seq, pos_l, vel_l, centers_seq,
                               n_valid_total, box=100.0):
    """Device-resident churn through the label-native detector
    (:mod:`orbitanalysis_tpu.ops.label_step`): the pool is the stable
    layout, membership churn is an elementwise label change — no join,
    no staging, no host.
    This is what the native integrator / hash record pools pay for
    churn (round-2 review item 2; the reference's dynamic sets,
    ``track_orbits.py:300-309``).
    """
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        make_label_orbit_step,
    )

    n_snaps, n = label_seq.shape
    row_width = min(1 << 15, n)
    K = max(128, row_width // 16)
    R0 = n // row_width
    # pre-reshaped to the carry's [R, W] row planes (what
    # scan_label_events does once up front)
    d_label = jnp.asarray(label_seq.reshape(n_snaps, R0, row_width))
    d_pos = jnp.asarray(pos_l.reshape(n_snaps, 3, R0, row_width))
    d_vel = jnp.asarray(vel_l.reshape(n_snaps, 3, R0, row_width))
    d_cen = jnp.asarray(centers_seq)
    # octahedral-packed rhat carry: the 12 B/particle config-5 diet
    # (counts invariant by construction — vr signs never read the
    # carried rhat)
    carry0 = init_label_carry(n, rhat_packed=True)
    step = make_label_orbit_step(
        K, box_size=box, row_width=row_width, rhat_packed=True,
    )

    # Events reduce IN-SCAN (sum over count, index, angle — every
    # event output stays alive, including the compaction) so the scan
    # stacks three scalars per snapshot instead of the full LabelEvents
    # [S, R, K] planes.  A deployment consumes events as they are
    # produced (async D2H of the compacted lists).
    @jax.jit
    def fn(c, args):
        lab, pos, vel, cen = args

        def sbody(cc, xs):
            p, v, lb, cn = xs
            cc, ev = step(
                cc, (p, v, lb, cn, None, None, jnp.float32(0.0))
            )
            return cc, (
                jnp.sum(ev.count),
                jnp.max(ev.count),
                jnp.sum(ev.angle) + jnp.sum(ev.index.astype(jnp.float32)),
            )

        _, (cnt, cmx, snk) = jax.lax.scan(sbody, c, (pos, vel, lab, cen))
        return jnp.sum(cnt), jnp.max(cmx), jnp.sum(snk)

    args = (d_label, d_pos, d_vel, d_cen)
    out = fn(carry0, args)
    events = int(np.asarray(out[0]))
    assert int(np.asarray(out[1])) <= K, "label event capacity overflow"
    best, _ = time_steady(fn, carry0, args)
    updates = n_snaps * n_valid_total
    return updates / best, events, best


def sustained_device_resident_updates_per_s(
        n_halos, capacity, n_snaps, box=100.0, scans=8, seed=0):
    """Sustained throughput with NO host in the loop (round-3 review
    item 4): snapshots are synthesized ON DEVICE inside the scan body
    (eccentric orbital motion + membership churn, the same workload
    family as :func:`make_orbits`/:func:`make_churn_sequence`) and fed
    straight into the label-native detector — zero staging, zero H2D,
    zero D2H except the final event sums.  This is what a deployment
    whose particle state lives on device (the native integrator,
    hash-sharded record pools) pays per orbit update, with EVERY cost
    on the clock: the timing is plain wall over ``scans`` chained
    full-sequence scans in one dispatch.

    Membership churn is elementwise on device: particle ``i`` is a
    member of its home halo whenever ``(u_i + s*delta) mod 1 < 0.9``
    with ``u_i`` uniform per particle and ``delta = 0.035`` — a
    constant ~90% occupancy with ~7%/snapshot turnover (3.5% depart +
    3.5% enter), the headline's churn rate.

    Returns ``(updates_per_s, events, wall_s, updates)``.
    """
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        make_label_orbit_step,
    )

    H, P, S = n_halos, capacity, n_snaps
    N = H * P
    row_width = min(1 << 15, N)
    # Event capacity: the synthetic workload's per-row-step event
    # count is ~omega*dt/(2pi) per member ~ 2% -> ~670 events mean at
    # row_width 32768 with i.i.d. per-particle phases (plus entry
    # transients), so row_width//8 = 4096 is ~5x headroom.  The
    # round-4 bench crashed here: each chained scan restarted the
    # synthetic time at s=0, so the position jump at every scan
    # boundary flipped vr signs for ~25% of particles in one step
    # (~8000 events/row >> K); time is now continuous across the
    # chained scans (see s0 below), which both matches how a real
    # deployment's sequence behaves and keeps the event rate at the
    # workload's steady ~2%.
    K = max(128, row_width // 8)
    delta = jnp.float32(0.035)
    dt = jnp.float32(0.3)

    # per-particle orbit parameters, generated on device (one-time,
    # outside the timed region — a deployment's state is already there)
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 8)
    r0 = jax.random.uniform(ks[0], (N,), jnp.float32, 0.5, 5.0)
    omega = 1.0 / r0**1.5
    phase0 = jax.random.uniform(ks[1], (N,), jnp.float32, 0.0, 2 * np.pi)
    phase_r = jax.random.uniform(ks[2], (N,), jnp.float32, 0.0, 2 * np.pi)
    ecc = jax.random.uniform(ks[3], (N,), jnp.float32, 0.2, 0.5)
    ax = jax.random.normal(ks[4], (3, N), jnp.float32)
    ax = ax / jnp.sqrt(jnp.sum(ax * ax, axis=0, keepdims=True))
    tmp = jax.random.normal(ks[5], (3, N), jnp.float32)
    tmp = tmp - jnp.sum(tmp * ax, axis=0, keepdims=True) * ax
    ay = tmp / jnp.sqrt(jnp.sum(tmp * tmp, axis=0, keepdims=True))
    u = jax.random.uniform(ks[6], (N,), jnp.float32)
    centers = jax.random.uniform(ks[7], (H, 3), jnp.float32, 20.0, 80.0)
    home = (jnp.arange(N, dtype=jnp.int32) // P)
    cen_pp = centers.T[:, home]  # [3, N] static home-halo center

    step = make_label_orbit_step(K, box_size=box, row_width=row_width,
                                 rhat_packed=True)

    def synth(s):
        t = s.astype(jnp.float32) * dt
        ph = phase0 + omega * t
        phr = phase_r + omega * t
        r = r0 * (1.0 + ecc * jnp.sin(phr))
        rdot = r0 * ecc * omega * jnp.cos(phr)
        cph, sph = jnp.cos(ph), jnp.sin(ph)
        pos = jnp.stack([
            cen_pp[d] + r * (cph * ax[d] + sph * ay[d]) for d in range(3)
        ])
        vel = jnp.stack([
            rdot * (cph * ax[d] + sph * ay[d])
            + (r * omega) * (-sph * ax[d] + cph * ay[d])
            for d in range(3)
        ])
        member = jnp.mod(u + s.astype(jnp.float32) * delta, 1.0) < 0.9
        label = jnp.where(member, home, -1)
        return pos, vel, label, member

    def build(R):
        @jax.jit
        def fn(carry, _):
            def body(r, st):
                c, tot, upd, mx, sink = st
                s0 = r * jnp.int32(S)  # continuous time across scans

                def sbody(cc, s):
                    pos, vel, label, member = synth(s)
                    cc, ev = step(cc, (pos, vel, label, centers,
                                       None, None, jnp.float32(0.0)))
                    return cc, (jnp.sum(ev.count),
                                jnp.sum(member, dtype=jnp.int32),
                                jnp.max(ev.count),
                                jnp.sum(ev.angle))

                c, (cnt, nm, cmx, asum) = jax.lax.scan(
                    sbody, c, s0 + jnp.arange(S, dtype=jnp.int32))
                return (c, tot + jnp.sum(cnt), upd + jnp.sum(nm),
                        jnp.maximum(mx, jnp.max(cmx)),
                        sink + jnp.sum(asum))

            _, tot, upd, mx, sink = jax.lax.fori_loop(
                0, R, body,
                (carry, jnp.int32(0), jnp.int64(0)
                 if jax.config.jax_enable_x64 else jnp.int32(0),
                 jnp.int32(0), jnp.float32(0)))
            return tot, upd, mx, sink
        return fn

    carry0 = init_label_carry(N, rhat_packed=True)
    fn = build(scans)
    out = fn(carry0, None)  # compile + warm
    events = int(np.asarray(out[0]))
    assert int(np.asarray(out[2])) <= K, (
        "label event capacity overflow in sustained bench")
    updates = int(np.asarray(out[1]))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(carry0, None))
        best = min(best, time.perf_counter() - t0)
    return updates / best, events, best, updates


def label_packed_angle_error(orbits, member_seq, box=100.0):
    """Measured angle-accuracy bound of the recorded rhat-packed label
    configuration (round-4 advisor item: the headline label metric runs
    ``rhat_packed=True``, whose per-event angles carry 16-bit octahedral
    quantization — counts are invariant by construction, but the bench
    only checked counts).  Runs the same small churn workload through
    packed and unpacked carries; asserts event count/position equality
    and returns ``max |angle_packed - angle_unpacked|`` in radians.
    """
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        scan_label_events,
    )

    lab, pos, vel, cen, _ = make_label_sequence(orbits, member_seq)
    n = lab.shape[1]
    rw = min(1 << 15, n)
    K = max(128, rw // 16)
    args = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(lab),
            jnp.asarray(cen))
    evs = {}
    for packed in (False, True):
        c0 = init_label_carry(n, rhat_packed=packed, row_width=rw)

        @jax.jit
        def run(c, a, _packed=packed):
            _, ev = scan_label_events(
                c, a[0], a[1], a[2], a[3], K, box_size=box,
                row_width=rw, rhat_packed=_packed,
            )
            return ev.count, ev.index, ev.angle
        evs[packed] = tuple(np.asarray(x) for x in run(c0, args))
    (cf, idf, anf), (cp, idp, anp) = evs[False], evs[True]
    assert np.array_equal(cf, cp), "packed rhat changed event counts"
    assert np.array_equal(idf, idp), "packed rhat changed event positions"
    valid = idf >= 0
    return float(np.max(np.abs(anf[valid] - anp[valid]), initial=0.0))


# ----------------------------------------------------------------------
# sustained pipeline: staging on the critical path
# ----------------------------------------------------------------------

def sustained_pipeline_updates_per_s(ids_seq, pos_seq, vel_seq,
                                     centers_seq, n_valid, box=100.0,
                                     chunk_snaps=2, repeats=2):
    """End-to-end sustained rate with NOTHING pre-staged: per chunk of
    ``chunk_snaps`` snapshots, run host stable-layout staging (the
    native h-major incremental-table pass) -> host-to-device transfer
    -> the aligned scan, with a staging thread running one chunk ahead
    (the tracker's prefetch structure).

    Returns ``(updates_per_s, dict_of_phase_seconds, events)``.  This
    is the number the round-2 review asked for: the host staging that
    the marginal device metric excludes is ON the critical path here
    (the reference's host I/O boundary, ``track_orbits.py:121-122``).
    Persistent staging buffers are faulted in before timing — the
    tracker reuses its buffers in steady state, so warm buffers ARE
    the steady state being measured.
    """
    import queue
    import threading

    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu import native
    from orbitanalysis_tpu.engine.packing import StableLayout, align_packed
    from orbitanalysis_tpu.engine.scan import scan_events_aligned
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import init_aligned_carry

    n_snaps, n_halos, capacity = ids_seq.shape
    S0 = chunk_snaps
    assert n_snaps % S0 == 0
    n_chunks = n_snaps // S0
    K = max(128, capacity // 16)

    ids_c = np.ascontiguousarray(ids_seq)
    pos_c = np.ascontiguousarray(pos_seq, dtype=np.float32)
    vel_c = np.ascontiguousarray(vel_seq, dtype=np.float32)
    cen_c = np.ascontiguousarray(centers_seq, dtype=np.float32)

    # two chunk-sized staging buffer sets (double buffer), pre-faulted
    bufs = []
    for _ in range(2):
        b = dict(
            ids=np.zeros((S0, n_halos, capacity), np.int32),
            pos=np.zeros((S0, 3, n_halos, capacity), np.float32),
            vel=np.zeros((S0, 3, n_halos, capacity), np.float32),
            slot=np.zeros((S0, n_halos, capacity), np.int32),
        )
        for a in b.values():
            a[...] = 0
        bufs.append(b)

    INVALID = np.iinfo(np.int32).max

    @jax.jit
    def scan_chunk(carry, pos, vel, slot, nv, center):
        # the aligned engine's events and carry are positional — the
        # device never consumes real particle IDs, only validity.  The
        # staged slot channel is a per-row permutation with holes
        # numbered [n_valid, P), so validity (and a positional ID
        # plane) reconstructs from slot + per-row member counts and
        # the ids plane never crosses the host->device link (12% of
        # the transfer at this shape).
        from orbitanalysis_tpu.engine.packing import SLOT_MASK

        s_, h_, p_ = slot.shape
        iota = jax.lax.broadcasted_iota(jnp.int32, (s_, h_, p_), 2)
        valid = (slot & SLOT_MASK) < nv[:, :, None]
        ids = jnp.where(valid, iota, jnp.int32(INVALID))
        snaps = SnapshotBatch(
            ids=ids, pos=pos, vel=vel,
            center=center, mass=None, bulk_vel=None,
            hubble_drag=jnp.zeros(s_, np.float32), slot=slot,
        )
        carry, (cnt, eids, angles) = scan_events_aligned(
            carry, snaps, K, mode="pericentric", box_size=box,
            soa_batch=True,
        )
        return carry, (jnp.sum(cnt), jnp.max(cnt),
                       jnp.sum(angles) + jnp.sum(eids.astype(jnp.float32)))

    # the CPU backend zero-copies numpy arrays into jax.Arrays, so a
    # double-buffered staging thread would mutate what the "device" is
    # still reading; a GPU put copies (block_until_ready fences the
    # transfer), so only the CPU needs the defensive copy
    needs_copy = jax.devices()[0].platform != "gpu"

    def make_chunk_args(b, c):
        sl = slice(c * S0, (c + 1) * S0)

        def put(x):
            return jax.device_put(x.copy() if needs_copy else x)

        nv = (b["ids"] != INVALID).sum(axis=-1).astype(np.int32)
        return (put(b["pos"]), put(b["vel"]), put(b["slot"]),
                jnp.asarray(nv), jnp.asarray(cen_c[sl]))

    def stage_chunk(layout, b, c):
        sl = slice(c * S0, (c + 1) * S0)
        res = native.stable_align_seq_native(
            layout.layout, ids_c[sl], pos_c[sl], vel_c[sl], None,
            layout.invalid,
            out=(b["ids"], b["pos"], b["vel"], None, b["slot"]),
            soa=True,
        )
        if res is None:  # no native library: NumPy fallback
            for k in range(S0):
                align_packed(
                    layout, ids_c[sl][k], pos_c[sl][k], vel_c[sl][k],
                    None,
                    out=(b["ids"][k], b["pos"][k], b["vel"][k], None,
                         b["slot"][k]),
                    soa=True,
                )

    def run_once():
        layout = StableLayout(n_halos, capacity)
        carry = init_aligned_carry(n_halos, capacity)
        phases = {"stage": 0.0, "h2d": 0.0, "dispatch": 0.0, "drain": 0.0}
        staged_q = queue.Queue()
        free_q = queue.Queue()
        for b in range(2):
            free_q.put(b)

        def stager():
            # staging runs one chunk ahead on its own thread (ctypes
            # releases the GIL); strictly in order — the stable layout
            # is sequential by construction.  A buffer is reused only
            # after the main thread finished transferring it (free_q
            # token), else staging chunk c+2 races the put of chunk c.
            for c in range(n_chunks):
                b = free_q.get()
                t0 = time.perf_counter()
                stage_chunk(layout, bufs[b], c)
                phases["stage"] += time.perf_counter() - t0
                staged_q.put((c, b))

        th = threading.Thread(target=stager, daemon=True)
        t_all = time.perf_counter()
        th.start()
        outs = []
        for c in range(n_chunks):
            got, b = staged_q.get()
            assert got == c
            t0 = time.perf_counter()
            args = make_chunk_args(bufs[b], c)
            jax.block_until_ready(args)
            free_q.put(b)
            phases["h2d"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            carry, out = scan_chunk(carry, *args)
            outs.append(out)
            phases["dispatch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        tot = sum(int(np.asarray(o[0])) for o in outs)
        mx = max(int(np.asarray(o[1])) for o in outs)
        phases["drain"] += time.perf_counter() - t0
        th.join()
        wall = time.perf_counter() - t_all
        assert mx <= K, "event capacity overflow in sustained bench"
        return wall, phases, tot

    run_once()  # compile + warm
    best = None
    for _ in range(repeats):
        wall, phases, events = run_once()
        if best is None or wall < best[0]:
            best = (wall, phases, events)
    wall, phases, events = best
    updates = n_snaps * n_halos * n_valid
    return updates / wall, dict(phases, wall=wall), events


# ----------------------------------------------------------------------
# device path
# ----------------------------------------------------------------------

def device_updates_per_s(ids_seq, pos_seq, vel_seq, centers_seq,
                         n_valid=None, box=100.0, repeats=5,
                         engine="sorted", stats=False):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu.engine.scan import (
        scan_events_aligned,
        scan_events_sorted,
    )
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import (
        init_aligned_carry,
        init_sorted_carry,
        presort_snapshot,
    )

    n_snaps, n_halos, capacity = ids_seq.shape
    snaps = SnapshotBatch(
        ids=np.ascontiguousarray(ids_seq),
        pos=pos_seq,
        vel=vel_seq,
        center=np.ascontiguousarray(centers_seq),
        mass=None,
        bulk_vel=None,
        hubble_drag=np.zeros(n_snaps, dtype=np.float32),
    )
    # Staged layout contract (host side, like the padding/packing
    # itself; the tracker's prefetch thread overlaps it with device
    # compute):
    #   engine='sorted'  — rows ID-sorted with load slots riding a slot
    #       channel; the per-step device join is one merge sort plus
    #       one extraction sort.
    #   engine='aligned' — rows in persistent stable-layout positions
    #       (survivors keep their position, entrants reuse holes), so
    #       consecutive snapshots are element-wise aligned and the step
    #       runs NO device-side join at all.
    # Event output order is identical either way.
    t_stage = time.perf_counter()
    if engine == "aligned":
        staged = stage_batch_aligned(snaps, soa=True)
    else:
        staged = presort_snapshot(snaps, soa=True)
    t_stage = time.perf_counter() - t_stage
    log(f"  [{engine}] host staging: {t_stage:.2f} s total "
        f"({t_stage / n_snaps * 1e3:.0f} ms/snapshot; overlapped with "
        "device compute by the tracker's prefetch pipeline)")
    snaps = jax.tree.map(jnp.asarray, staged)
    carry0 = (
        init_aligned_carry(n_halos, capacity)
        if engine == "aligned"
        else init_sorted_carry(n_halos, capacity)
    )

    # On-device event compaction: the scan emits [S, H, K] event lists
    # + counts (what the savefile writer consumes) instead of full
    # [S, H, P] masks.  The first call doubles as the
    # event-count/overflow correctness pass.
    # event capacity: ample headroom over the per-halo event rate
    # (overflowing rows are detectable via cnt > K and re-run)
    K = max(128, capacity // 16)

    def run_one(c, s):
        if engine == "aligned":
            carry, (cnt, ids, angles) = scan_events_aligned(
                c, s, K, mode="pericentric", box_size=box, soa_batch=True,
            )
        else:
            carry, (cnt, ids, angles) = scan_events_sorted(
                c, s, K, mode="pericentric", box_size=box, soa_batch=True,
            )
        return carry, cnt, ids, angles

    # the event outputs are reduced to scalars so the compaction is
    # not dead code but the fetch stays cheap
    @jax.jit
    def fn(c, s):
        _, cnt, ids, angles = run_one(c, s)
        return (jnp.sum(cnt), jnp.max(cnt),
                jnp.sum(angles) + jnp.sum(ids.astype(jnp.float32)))

    out = fn(carry0, snaps)  # compile + correctness pass in one
    events = int(np.asarray(out[0]))
    assert int(np.asarray(out[1])) <= K, "event capacity overflow in bench"
    best, st = time_steady(fn, carry0, snaps, repeats=repeats)
    updates = n_snaps * n_halos * (n_valid or capacity)
    if stats:
        return updates / best, events, best, st
    return updates / best, events, best


def main():
    import jax

    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r} "
                 "devices only")
    enable_compilation_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    n_halos, capacity, n_snaps = 64, 32768, 48   # 100M updates / scan

    log(f"config: H={n_halos} P={capacity} S={n_snaps}")

    # headline: membership churn (~7 %/snapshot) — the honest tracking
    # workload (the reference's dynamic entered/departed sets,
    # track_orbits.py:300-309) — through the stable-layout aligned
    # engine: host staging pins every particle to a persistent row
    # position so the device runs no join at all
    t_gen = time.perf_counter()
    orbits, churn_seq, member_seq = make_churn_workload(
        n_halos, capacity, n_snaps
    )
    ids_c, pos_c, vel_c, centers_c, n_valid = churn_seq
    log(f"  sequence generation: {time.perf_counter() - t_gen:.1f} s "
        "(cached in .bench_cache/ after the first run)")
    churn_ups, churn_events, t_c, churn_stats = device_updates_per_s(
        ids_c, pos_c, vel_c, centers_c, n_valid=n_valid, engine="aligned",
        stats=True,
    )
    log(f"device churn (aligned engine): {churn_ups:.6e} updates/s "
        f"({churn_events} apsis events, {t_c:.6f} s/scan median; "
        f"median {churn_stats['median']*1e3:.1f} ms, rel spread "
        f"{churn_stats['rel_spread']:.3f} over {churn_stats['samples']} "
        "samples)")

    # sustained, staging on the critical path (round-2 review item 1):
    # nothing pre-staged — host stable-layout staging + host->device
    # transfer + the aligned scan, chunk-pipelined with a staging
    # thread.  The same churn workload as the headline.
    sus_ups, sus_phases, sus_events = sustained_pipeline_updates_per_s(
        ids_c, pos_c, vel_c, centers_c, n_valid
    )
    stage_ups = (
        n_snaps * n_halos * n_valid / sus_phases["stage"]
        if sus_phases["stage"] > 0 else float("inf")
    )
    log(f"sustained incl. staging: {sus_ups:.3e} updates/s "
        f"(wall {sus_phases['wall']:.2f} s: stage {sus_phases['stage']:.2f}"
        f" s [{stage_ups:.2e} upd/s staging-only], h2d "
        f"{sus_phases['h2d']:.2f} s, dispatch+drain "
        f"{sus_phases['dispatch'] + sus_phases['drain']:.2f} s; "
        f"{sus_events} events)")

    # device-resident churn, no staging at all: the label-native
    # detector (the pool is the stable layout; churn = label change,
    # elementwise) — what the native integrator / hash record pools
    # pay.  Same membership history as the headline, so event totals
    # are directly comparable.
    lab_seq, pos_l, vel_l, cen_l, nv_tot = make_label_sequence(
        orbits, member_seq
    )
    label_ups, label_events, t_l = device_label_updates_per_s(
        lab_seq, pos_l, vel_l, cen_l, nv_tot
    )
    log(f"device churn (label-native, device-resident): "
        f"{label_ups:.3e} updates/s ({label_events} apsis events, "
        f"{t_l:.3f} s/scan; aligned-engine events: {churn_events} — "
        "bulk frames are estimated per engine, so totals may differ "
        "by knife-edge crossings)")

    # sustained with NO host in the loop (round-3 review item 4):
    # snapshots synthesized on device inside the scan, label-native
    # detection, plain wall-clock over chained scans — every cost a
    # device-resident deployment pays is on the clock
    sdr_ups, sdr_events, sdr_wall, sdr_updates = (
        sustained_device_resident_updates_per_s(n_halos, capacity, n_snaps)
    )
    log(f"sustained device-resident (on-device synthesis + label "
        f"detection, wall incl. dispatch): {sdr_ups:.3e} updates/s "
        f"({sdr_updates} updates, {sdr_events} events, "
        f"{sdr_wall:.3f} s wall)")

    # secondary: the same churn through the sorted merge-join engine
    # (join_impl='sorted').  Secondary engines run a 12-snapshot slice;
    # the cross-engine event-stream equality is owned by
    # tests/test_aligned.py::test_scan_aligned_matches_scan_sorted
    s_sec = min(12, n_snaps)
    join_ups, join_events, t_j = device_updates_per_s(
        ids_c[:s_sec], pos_c[:s_sec], vel_c[:s_sec], centers_c[:s_sec],
        n_valid=n_valid, engine="sorted"
    )
    log(f"device churn (merge-join engine): {join_ups:.3e} updates/s "
        f"({join_events} apsis events over {s_sec} snaps, "
        f"{t_j:.3f} s/scan)")

    # secondary: fixed membership — the static fast path ceiling
    # (reuses the orbit pool: generation runs once)
    ids_seq, pos_seq, vel_seq, centers_seq, _ = make_static_sequence(orbits)
    static_ups, s_events, t_s = device_updates_per_s(
        ids_seq[:s_sec], pos_seq[:s_sec], vel_seq[:s_sec],
        centers_seq[:s_sec]
    )
    log(f"device static: {static_ups:.3e} updates/s "
        f"({s_events} apsis events, {t_s:.3f} s/scan)")

    # baseline on a size small enough to finish quickly, same workload
    bh, bp, bs = min(n_halos, 8), min(capacity, 4096), min(n_snaps, 6)
    b_orbits = make_orbits(bh, bp, bs, seed=1)
    bids, bpos, bvel, bcent, _bnv, b_mem = make_churn_sequence(
        b_orbits, churn=0.07, return_members=True
    )
    b_ups, b_events = numpy_baseline_updates_per_s(bids, bpos, bvel, bcent)
    log(f"numpy baseline (churn): {b_ups:.3e} updates/s ({b_events} events)")

    # angle-accuracy bound of the recorded rhat-packed configuration
    ang_err = label_packed_angle_error(b_orbits, b_mem)
    log(f"rhat-packed angle error bound: {ang_err:.2e} rad max vs the "
        "unpacked carry (event counts/positions identical)")

    print(json.dumps({
        "metric": "orbit_updates_per_sec_per_chip_churn",
        "value": round(churn_ups, 1),
        "unit": "particle-snapshot updates/s",
        "vs_baseline": round(churn_ups / b_ups, 2),
        "device": device,
        "churn_merge_join_updates_per_sec": round(join_ups, 1),
        "churn_label_device_resident_updates_per_sec": round(label_ups, 1),
        # measured max |angle| deviation of the rhat-packed carry the
        # label metric records (counts/positions identical; round-4
        # advisor item)
        "label_packed_angle_err_max_rad": round(ang_err, 6),
        # NO host in the loop: on-device snapshot synthesis + label-
        # native detection, wall-clock incl. the dispatch
        "sustained_device_resident_updates_per_sec": round(sdr_ups, 1),
        # run-to-run spread of the headline samples
        "headline_variance": {
            "median": round(n_snaps * n_halos * n_valid
                            / churn_stats["median"], 1),
            "rel_spread": round(churn_stats["rel_spread"], 4),
            "samples": churn_stats["samples"],
        },
        "static_updates_per_sec": round(static_ups, 1),
        # staging on the critical path (nothing pre-staged): host
        # stable-layout staging + H2D + aligned scan, chunk-pipelined
        "sustained_updates_per_sec_incl_staging": round(sus_ups, 1),
        "staging_updates_per_sec": round(stage_ups, 1),
        "sustained_phase_seconds": {
            k: round(v, 3) for k, v in sus_phases.items()
        },
    }))


if __name__ == "__main__":
    main()
