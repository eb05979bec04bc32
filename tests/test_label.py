"""Label-native detector (ops/label_step.py): the device-resident
stable-alignment path — the pool IS the layout, churn is a label change.

Tiers: unit tests for the frame-row and moment helpers and the region assigner,
then event-stream parity against the aligned engine on a churning pool
(the round-2 review's acceptance: device-resident churn with event
streams equal to the staged engines, reference semantics
``/root/reference/orbitanalysis/track_orbits.py:300-309``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu.ops.label_step import (
    assign_regions,
    init_label_carry,
    make_label_orbit_step,
    scan_label_events,
    take_rows_matmul,
    take_rows_select,
)


def test_take_rows_matmul_exact(rng):
    # full 24-bit mantissas across a wide exponent range: the bf16x3
    # split path must still be bit-exact
    table = (rng.normal(size=(7, 5))
             * np.exp2(rng.integers(-40, 40, size=(7, 5)))
             ).astype(np.float32)
    idx = rng.integers(-1, 7, size=512).astype(np.int32)
    want = np.where(idx[:, None] >= 0, table[np.maximum(idx, 0)], 0.0)
    for prec in ("bf16x3", "f32"):
        got = np.asarray(take_rows_matmul(
            jnp.asarray(table), jnp.asarray(idx), precision=prec))
        np.testing.assert_array_equal(got, want.astype(np.float32))
    got_s = np.asarray(take_rows_select(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got_s, want.astype(np.float32))


def test_split_bf16x3_exact(rng):
    """The truncation split reconstructs every normal f32 bit-exactly
    when re-summed hi-to-lo (the take_rows_matmul exactness basis)."""
    from orbitanalysis_tpu.ops.label_step import _split_bf16x3

    x = np.concatenate([
        (rng.normal(size=4096)
         * np.exp2(rng.integers(-100, 100, size=4096))),
        [0.0, -0.0, 1.0, -1.0, np.pi, 2.0**-126, -(2.0**127)],
    ]).astype(np.float32)
    p0, p1, p2 = jax.jit(_split_bf16x3)(jnp.asarray(x))
    back = ((np.asarray(p0, np.float32) + np.asarray(p1, np.float32))
            + np.asarray(p2, np.float32))
    np.testing.assert_array_equal(back, x)


def test_take_rows_matmul_chunked(rng):
    table = rng.normal(size=(4, 3)).astype(np.float32)
    idx = rng.integers(0, 4, size=1024).astype(np.int32)
    got = np.asarray(take_rows_matmul(
        jnp.asarray(table), jnp.asarray(idx), chunk=256))
    np.testing.assert_array_equal(got, table[idx])


def test_take_rows_soa_exact(rng):
    """SoA form: [C, N] out, bit-exact vs gather for both precisions,
    chunked and unchunked; the SoA segment moments match the AoS form
    to f32 reduction tolerance."""
    from orbitanalysis_tpu.ops.label_step import (
        _segment_moments_matmul,
        _segment_moments_soa,
        take_rows_soa,
    )

    table = (rng.normal(size=(7, 6))
             * np.exp2(rng.integers(-40, 40, size=(7, 6)))
             ).astype(np.float32)
    idx = rng.integers(-1, 7, size=1024).astype(np.int32)
    want = np.where(idx[:, None] >= 0, table[np.maximum(idx, 0)], 0.0).T
    for prec in ("f32", "bf16x3"):
        for chunk in (None, 256):
            got = np.asarray(take_rows_soa(
                jnp.asarray(table), jnp.asarray(idx), chunk=chunk,
                precision=prec))
            np.testing.assert_array_equal(got, want.astype(np.float32))

    vals = rng.normal(size=(4, 1024)).astype(np.float32)
    ref = np.asarray(_segment_moments_matmul(
        jnp.asarray(vals.T), jnp.asarray(idx), 7, precision="f32"))
    for prec in ("f32", "bf16x3"):
        for chunk in (None, 256):
            got = np.asarray(_segment_moments_soa(
                jnp.asarray(vals), jnp.asarray(idx), 7, chunk=chunk,
                precision=prec))
            np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("h", [7, 300])
def test_take_rows_gather_exact(rng, h):
    """The plain gather form of the frame rows: bit-exact vs the
    select reference (and a NumPy gather) at both halo-count regimes,
    -1 labels giving zero rows."""
    from orbitanalysis_tpu.ops.label_step import take_rows_gather

    n = 1024
    table = (rng.normal(size=(h, 6))
             * np.exp2(rng.integers(-40, 40, size=(h, 6)))
             ).astype(np.float32)
    idx = rng.integers(-1, h, size=n).astype(np.int32)
    want = np.where(idx[:, None] >= 0, table[np.maximum(idx, 0)], 0.0).T
    got = np.asarray(take_rows_gather(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    sel = np.asarray(take_rows_select(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, sel.T)


def test_assign_regions_matches_numpy(rng):
    box = 50.0
    centers = rng.uniform(0, box, size=(4, 3)).astype(np.float32)
    radii = rng.uniform(3.0, 8.0, size=4).astype(np.float32)
    pos = rng.uniform(0, box, size=(2048, 3)).astype(np.float32)
    got = np.asarray(assign_regions(
        jnp.asarray(pos), centers, radii, box_size=box))
    # NumPy oracle: nearest wrapped center within its radius
    d = pos[:, None, :] - centers[None, :, :]
    d -= box * np.round(d / box)
    d2 = (d ** 2).sum(-1)
    inside = d2 < radii[None, :] ** 2
    d2m = np.where(inside, d2, np.inf)
    want = np.where(inside.any(1), np.argmin(d2m, axis=1), -1)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def _churn_pool(rng, n_halos=3, per=256, n_snaps=8, box=80.0):
    """Pool of n_halos*per particles orbit-walking around their halo's
    center, with per-snapshot membership churn.  Returns (pos [S,3,N],
    vel [S,3,N], label [S,N], centers [S,H,3])."""
    n = n_halos * per
    home = np.repeat(np.arange(n_halos, dtype=np.int32), per)
    centers = rng.uniform(10, box - 10, size=(n_halos, 3)).astype(np.float32)
    member = rng.random(n) < 0.85
    pos = np.empty((n_snaps, 3, n), np.float32)
    vel = np.empty((n_snaps, 3, n), np.float32)
    label = np.empty((n_snaps, n), np.int32)
    x = centers[home] + rng.normal(scale=3.0, size=(n, 3))
    v = rng.normal(scale=1.0, size=(n, 3))
    for s in range(n_snaps):
        if s:
            flip = rng.random(n) < 0.08
            member = member ^ flip
            v += rng.normal(scale=0.6, size=(n, 3))
            x += v * 0.3
        pos[s] = (x % box).T.astype(np.float32)
        vel[s] = v.T.astype(np.float32)
        label[s] = np.where(member, home, -1)
    cen_seq = np.broadcast_to(centers, (n_snaps, n_halos, 3)).copy()
    return pos, vel, label, cen_seq


def test_take_rows_twolevel_exact(rng):
    """Two-level hi/lo split: bit-exact vs gather (both stages select
    exactly one nonzero product), including non-multiple-of-hl halo
    counts and the padded -1 column; moments match the direct form to
    f32 reduction tolerance."""
    from orbitanalysis_tpu.ops.label_step import (
        _segment_moments_matmul,
        _segment_moments_twolevel,
        take_rows_twolevel,
    )

    for h in (7, 300):
        table = (rng.normal(size=(h, 6))
                 * np.exp2(rng.integers(-40, 40, size=(h, 6)))
                 ).astype(np.float32)
        idx = rng.integers(-1, h, size=4096).astype(np.int32)
        want = np.where(
            idx[:, None] >= 0, table[np.maximum(idx, 0)], 0.0).T
        for chunk in (None, 1024):
            got = np.asarray(take_rows_twolevel(
                jnp.asarray(table), jnp.asarray(idx), chunk=chunk))
            np.testing.assert_array_equal(got, want.astype(np.float32))

        vals = rng.normal(size=(4, 4096)).astype(np.float32)
        ref = np.asarray(_segment_moments_matmul(
            jnp.asarray(vals.T), jnp.asarray(idx), h, precision="f32"))
        for chunk in (None, 1024):
            got = np.asarray(_segment_moments_twolevel(
                jnp.asarray(vals), jnp.asarray(idx), h, chunk=chunk))
            # different f32 reduction order than the direct dot
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "frames",
    ["select", "gather", "matmul", "matmul_bf16x3", "soa", "soa_bf16x3",
     "twolevel"])
def test_label_scan_matches_aligned_engine(rng, frames):
    """Event-stream parity: the label detector over the pool must emit
    exactly the aligned engine's events ((halo, id, f16 angle) sets per
    snapshot) on the same churn workload.  Explicit zero bulk
    velocities pin both engines to the same frame (bulk estimation
    itself is tested separately with a tolerance)."""
    from orbitanalysis_tpu.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu.engine.scan import scan_events_aligned
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import init_aligned_carry
    from orbitanalysis_tpu.utils.padding import invalid_id_for

    box = 80.0
    H, per, S = 3, 256, 8
    pos, vel, label, cen_seq = _churn_pool(rng, H, per, S, box)
    N = label.shape[1]
    INV = invalid_id_for(np.int32)

    # label side: one scan over the pool (pool index = particle id)
    carry = init_label_carry(N, row_width=256)
    _, ev = scan_label_events(
        carry, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(label),
        jnp.asarray(cen_seq), event_capacity=128, box_size=box,
        bulk_vel_seq=np.zeros((S, H, 3), np.float32),
        row_width=256, frames=frames,
    )
    ev = jax.tree.map(np.asarray, ev)

    # aligned side: padded per-halo load-order rows of the same data
    P = 256
    ids_rows = np.full((S, H, P), INV, np.int32)
    pos_rows = np.zeros((S, H, P, 3), np.float32)
    vel_rows = np.zeros((S, H, P, 3), np.float32)
    for s in range(S):
        for h in range(H):
            g = np.flatnonzero(label[s] == h)
            g = g[rng.permutation(len(g))]  # arbitrary load order
            ids_rows[s, h, :len(g)] = g
            pos_rows[s, h, :len(g)] = pos[s, :, g]
            vel_rows[s, h, :len(g)] = vel[s, :, g]
    batch = SnapshotBatch(
        ids=ids_rows, pos=pos_rows, vel=vel_rows,
        center=cen_seq.astype(np.float32), mass=None,
        bulk_vel=np.zeros((S, H, 3), np.float32),
        hubble_drag=np.zeros(S, np.float32),
    )
    staged = stage_batch_aligned(batch, soa=True)
    staged = jax.tree.map(jnp.asarray, staged)
    _, (cnt_a, pos_a, ang_a) = scan_events_aligned(
        init_aligned_carry(H, P), staged, event_capacity=128,
        box_size=box, soa_batch=True,
    )
    cnt_a, pos_a, ang_a = map(np.asarray, (cnt_a, pos_a, ang_a))
    staged_ids = np.asarray(staged.ids)

    for s in range(S):
        want = set()
        for h in range(H):
            k = cnt_a[s, h]
            gids = staged_ids[s][h, pos_a[s, h, :k]]
            for g, a in zip(gids, ang_a[s, h, :k]):
                want.add((h, int(g), np.float16(a).tobytes()))
        got = set()
        R = ev.count.shape[1]
        for r in range(R):
            k = ev.count[s, r]
            for g, a in zip(ev.index[s, r, :k], ev.angle[s, r, :k]):
                got.add((int(label[s][g]), int(g),
                         np.float16(a).tobytes()))
        assert got == want, (s, len(got), len(want),
                             got ^ want if len(got ^ want) < 10 else "...")


def test_label_bulk_estimation_close(rng):
    """In-step mass-weighted bulk estimation agrees with a NumPy segment mean to f32 reduction tolerance."""
    box = 80.0
    pos, vel, label, cen_seq = _churn_pool(rng)
    N = label.shape[1]
    mass = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    step = make_label_orbit_step(64, box_size=box, row_width=256)
    _, ev = step(
        init_label_carry(N, row_width=256),
        (jnp.asarray(pos[0]), jnp.asarray(vel[0]), jnp.asarray(label[0]),
         jnp.asarray(cen_seq[0]), None, jnp.asarray(mass),
         jnp.float32(0)),
    )
    bulk = np.asarray(ev.bulk_vel)
    for h in range(3):
        sel = label[0] == h
        want = (mass[sel][:, None] * vel[0][:, sel].T).sum(0) / mass[sel].sum()
        np.testing.assert_allclose(bulk[h], want, rtol=2e-6, atol=2e-6)


def test_label_mode_both_directions(rng):
    """Apocentric mode flips the sign condition (reference
    track_orbits.py:311-314): a radial out->in flip is an apocenter."""
    N, S = 256, 3
    label = np.zeros((S, N), np.int32)
    centers = np.zeros((S, 1, 3), np.float32)
    pos = np.zeros((S, 3, N), np.float32)
    vel = np.zeros((S, 3, N), np.float32)
    pos[:, 0, :] = 2.0
    vel[0, 0, :] = 1.0   # outward
    vel[1, 0, :] = -1.0  # inward -> apocenter at s=1
    vel[2, 0, :] = 1.0   # outward -> pericenter at s=2
    kw = dict(centers_seq=jnp.asarray(centers), event_capacity=N,
              bulk_vel_seq=np.zeros((S, 1, 3), np.float32), row_width=N)
    _, ev_a = scan_label_events(
        init_label_carry(N, row_width=N), jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), mode="apocentric", **kw)
    _, ev_p = scan_label_events(
        init_label_carry(N, row_width=N), jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), mode="pericentric", **kw)
    ca = np.asarray(ev_a.count).sum(axis=1)
    cp = np.asarray(ev_p.count).sum(axis=1)
    np.testing.assert_array_equal(ca, [0, N, 0])
    np.testing.assert_array_equal(cp, [0, 0, N])


@pytest.mark.slow  # 8-device shard_map: ~150 s
def test_sharded_label_step_matches_single():
    """Particle-sharded label step (shard_map over 'particles', psum'd
    bulk moments) equals the single-device step: carries exact on the
    integer planes, events the same (index, ~angle) sets."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from orbitanalysis_tpu.parallel import make_mesh
    from orbitanalysis_tpu.parallel.label_sharded import (
        make_sharded_label_step,
        shard_label_tree,
    )
    from orbitanalysis_tpu.ops.label_step import make_label_orbit_step

    rng = np.random.default_rng(3)
    box = 80.0
    H, per, S = 3, 1024, 4    # N = 3072 -> 384/shard (3 x 128)
    pos, vel, label, cen_seq = _churn_pool(rng, H, per, S, box)
    N = label.shape[1]
    mesh = make_mesh({"particles": 8})
    rw = N // 8

    step_s, _ = make_sharded_label_step(
        mesh, 64, H, box_size=box, row_width=rw)
    step_1 = make_label_orbit_step(64, box_size=box, row_width=rw)

    c_s = shard_label_tree(mesh, init_label_carry(N, row_width=rw))
    c_1 = init_label_carry(N, row_width=rw)
    for s in range(S):
        inputs = (jnp.asarray(pos[s]), jnp.asarray(vel[s]),
                  jnp.asarray(label[s]), jnp.asarray(cen_seq[s]),
                  None, jnp.float32(0))
        c_s, ev_s = step_s(c_s, inputs)
        c_1, ev_1 = step_1(
            c_1, (inputs[0], inputs[1], inputs[2], inputs[3], None,
                  None, inputs[5]))
        es, e1 = jax.tree.map(np.asarray, (ev_s, ev_1))
        np.testing.assert_allclose(es.bulk_vel, e1.bulk_vel,
                                   rtol=1e-5, atol=1e-5)
        got = {}
        for r in range(es.count.shape[0]):
            for i in range(es.count[r]):
                got[int(es.index[r, i])] = es.angle[r, i]
        want = {}
        for r in range(e1.count.shape[0]):
            for i in range(e1.count[r]):
                want[int(e1.index[r, i])] = e1.angle[r, i]
        assert got.keys() == want.keys(), s
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-3)
        cs, c1h = jax.tree.map(np.asarray, (c_s, c_1))
        np.testing.assert_array_equal(cs.lab_sv, c1h.lab_sv)


def test_label_rhat_packed_counts_exact(rng):
    """Octahedral rhat packing (the 1e8-per-chip carry diet): apsis
    COUNTS are unaffected by construction — radial-velocity signs are
    recomputed from positions every step and never read the carried
    rhat — and angles move only by the ~1e-4 rad/step quantization."""
    box = 80.0
    pos, vel, label, cen_seq = _churn_pool(rng)
    N = label.shape[1]
    S = label.shape[0]
    kw = dict(event_capacity=128, box_size=box, row_width=256,
              bulk_vel_seq=np.zeros((S, 3, 3), np.float32))
    _, ev_f = scan_label_events(
        init_label_carry(N, row_width=256), jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), jnp.asarray(cen_seq),
        **kw)
    _, ev_p = scan_label_events(
        init_label_carry(N, rhat_packed=True, row_width=256),
        jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), jnp.asarray(cen_seq),
        rhat_packed=True, **kw)
    ev_f, ev_p = jax.tree.map(np.asarray, (ev_f, ev_p))
    np.testing.assert_array_equal(ev_f.count, ev_p.count)
    for s in range(S):
        for r in range(ev_f.count.shape[1]):
            k = ev_f.count[s, r]
            of = np.argsort(ev_f.index[s, r, :k])
            op = np.argsort(ev_p.index[s, r, :k])
            np.testing.assert_array_equal(
                ev_f.index[s, r, :k][of], ev_p.index[s, r, :k][op])
            np.testing.assert_allclose(
                ev_f.angle[s, r, :k][of], ev_p.angle[s, r, :k][op],
                atol=5e-3,
            )


def test_aligned_rhat_packed_counts_exact(rng):
    """Same diet on the aligned native step's xla path."""
    from orbitanalysis_tpu.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu.engine.scan import scan_events_aligned
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu.ops.sorted_step import init_aligned_carry
    from orbitanalysis_tpu.utils.padding import invalid_id_for

    box = 80.0
    H, per, S = 3, 256, 8
    pos, vel, label, cen_seq = _churn_pool(rng, H, per, S, box)
    INV = invalid_id_for(np.int32)
    P = 256
    ids_rows = np.full((S, H, P), INV, np.int32)
    pos_rows = np.zeros((S, H, P, 3), np.float32)
    vel_rows = np.zeros((S, H, P, 3), np.float32)
    for s in range(S):
        for h in range(H):
            g = np.flatnonzero(label[s] == h)
            ids_rows[s, h, :len(g)] = g
            pos_rows[s, h, :len(g)] = pos[s, :, g]
            vel_rows[s, h, :len(g)] = vel[s, :, g]
    batch = SnapshotBatch(
        ids=ids_rows, pos=pos_rows, vel=vel_rows,
        center=cen_seq.astype(np.float32), mass=None, bulk_vel=None,
        hubble_drag=np.zeros(S, np.float32),
    )
    staged = jax.tree.map(
        jnp.asarray, stage_batch_aligned(batch, soa=True))
    _, (cnt_f, pos_f, ang_f) = scan_events_aligned(
        init_aligned_carry(H, P), staged, 128, box_size=box,
        soa_batch=True,
    )
    _, (cnt_p, pos_p, ang_p) = scan_events_aligned(
        init_aligned_carry(H, P, rhat_packed=True), staged, 128,
        box_size=box, soa_batch=True, rhat_packed=True,
    )
    cnt_f, cnt_p = np.asarray(cnt_f), np.asarray(cnt_p)
    np.testing.assert_array_equal(cnt_f, cnt_p)
    pos_f, pos_p = np.asarray(pos_f), np.asarray(pos_p)
    ang_f, ang_p = np.asarray(ang_f), np.asarray(ang_p)
    for s in range(S):
        for h in range(3):
            k = cnt_f[s, h]
            of, op = np.argsort(pos_f[s, h, :k]), np.argsort(pos_p[s, h, :k])
            np.testing.assert_array_equal(
                pos_f[s, h, :k][of], pos_p[s, h, :k][op])
            np.testing.assert_allclose(
                ang_f[s, h, :k][of], ang_p[s, h, :k][op], atol=5e-3)


def test_f16_bits_rne(rng):
    """The integer f32->f16 encoder of the payload words must match
    ``astype(float16)`` bit-for-bit for all finite non-negative inputs
    — normals, f16 subnormals, exact round-to-even halves — with
    out-of-range values clamping to the max finite f16 instead of
    inf."""
    from orbitanalysis_tpu.utils.numerics import f16_bits_rne

    xs = np.concatenate([
        np.float32([0.0, 5.96e-8, 6e-8, 6.097e-5, 6.104e-5,
                    65504.0, 65520.0, 7e4, 1e8, np.pi, 1e-3]),
        rng.uniform(0, 1e-4, 20000).astype(np.float32),
        rng.uniform(0, 200.0, 20000).astype(np.float32),
        # exact f16 values nudged by half an ulp -> ties-to-even
        (rng.uniform(0, 2**15, 10000).astype(np.float16)
         .astype(np.float32) * (1 + 2**-12)),
    ])
    got = np.asarray(f16_bits_rne(jnp.asarray(xs))).astype(np.uint16)
    with np.errstate(over="ignore"):  # 1e8 -> f16 inf, intentionally
        ref = xs.astype(np.float16).view(np.uint16)
    ref = np.where(ref == 0x7C00, np.uint16(0x7BFF), ref)
    np.testing.assert_array_equal(got, ref)


def _random_pool(rng, h, R=4, W=512, S=6):
    N = R * W
    pos = rng.uniform(0, 100, (S, 3, N)).astype(np.float32)
    vel = rng.normal(size=(S, 3, N)).astype(np.float32)
    lab = rng.integers(-1, h, (S, N)).astype(np.int32)
    cen = rng.uniform(20, 80, (S, h, 3)).astype(np.float32)
    for s in range(1, S):
        keep = rng.random(N) < 0.9
        lab[s] = np.where(keep, lab[s - 1], lab[s])
    return pos, vel, lab, cen


def _run_label_steps(frames, pos, vel, lab, cen, R, W, bulk=None,
                     mass=None):
    step = jax.jit(make_label_orbit_step(
        128, box_size=100.0, row_width=W, frames=frames))
    c = init_label_carry(R * W, row_width=W)
    evs = []
    for s in range(lab.shape[0]):
        c, ev = step(c, (
            pos[s].reshape(3, R, W), vel[s].reshape(3, R, W),
            lab[s].reshape(R, W), cen[s],
            None if bulk is None else bulk[s],
            None if mass is None else mass.reshape(R, W),
            jnp.float32(0.01)))
        evs.append(jax.tree.map(np.asarray, ev))
    return jax.tree.map(np.asarray, c), evs


def _assert_label_runs_equal(a, b):
    ca, cb = a[0], b[0]
    np.testing.assert_array_equal(ca.lab_sv, cb.lab_sv)
    np.testing.assert_array_equal(ca.packed, cb.packed)
    np.testing.assert_array_equal(ca.rhat, cb.rhat)
    for ea, eb in zip(a[1], b[1]):
        np.testing.assert_array_equal(ea.count, eb.count)
        np.testing.assert_array_equal(ea.index, eb.index)
        np.testing.assert_array_equal(ea.angle, eb.angle)


@pytest.mark.parametrize("h", [7, 300])
@pytest.mark.parametrize("frames", ["gather", "matmul", "twolevel"])
def test_label_frames_step_bit_parity(rng, frames, h):
    """Every frames form reproduces the 'select' reference's carries and
    events BIT-exactly (row selection is exact in all of them; with the
    bulk velocities given, nothing else differs) at both halo-count
    regimes."""
    R, W = 4, 512
    pos, vel, lab, cen = _random_pool(rng, h, R, W)
    bulk = rng.normal(scale=0.1, size=(lab.shape[0], h, 3)).astype(
        np.float32)
    ref = _run_label_steps("select", pos, vel, lab, cen, R, W, bulk=bulk)
    got = _run_label_steps(frames, pos, vel, lab, cen, R, W, bulk=bulk)
    _assert_label_runs_equal(ref, got)


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("h", [7, 300])
@pytest.mark.parametrize("frames", ["gather", "twolevel"])
def test_label_frames_moments(rng, frames, h, with_mass):
    """The in-step bulk velocities of each moments form agree with a
    float64 NumPy segment mean (mass-weighted or plain) to f32
    summation tolerance, at both halo-count regimes."""
    R, W = 2, 512
    N = R * W
    pos, vel, lab, cen = _random_pool(rng, h, R, W, S=1)
    mass = (rng.uniform(0.5, 2.0, N).astype(np.float32) if with_mass
            else None)
    _, evs = _run_label_steps(frames, pos, vel, lab, cen, R, W, mass=mass)
    bulk = evs[0].bulk_vel
    w = np.ones(N) if mass is None else mass.astype(np.float64)
    for hh in range(h):
        sel = lab[0] == hh
        if not sel.any():
            continue
        want = ((w[sel][:, None] * vel[0][:, sel].T.astype(np.float64))
                .sum(0) / w[sel].sum())
        np.testing.assert_allclose(bulk[hh], want, rtol=1e-5, atol=1e-5)


def test_label_dense_burst_parity(rng):
    """A dense event burst (every particle of halo 0 flips inward ->
    outward at once) must come out of the plain frames form exactly as
    from the select reference: full compaction rows, exact counts."""
    H, R, W, S = 5, 4, 1024, 6
    N = R * W
    pos, vel, lab, cen = _random_pool(rng, H, R, W, S)
    u = rng.normal(size=(N, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    lab[2] = lab[3] = 0
    pos[2] = (cen[2, 0] + 3.0 * u).T
    vel[2] = (-1.0 * u).T
    pos[3] = (cen[3, 0] + 2.5 * u).T
    vel[3] = (1.0 * u).T
    bulk = np.zeros((S, H, 3), np.float32)
    ref = _run_label_steps("select", pos, vel, lab, cen, R, W, bulk=bulk)
    got = _run_label_steps("gather", pos, vel, lab, cen, R, W, bulk=bulk)
    _assert_label_runs_equal(ref, got)
    assert max(int(e.count.max()) for e in got[1]) > 128, (
        "no dense burst: event counts never exceeded the capacity")


def test_gather_label_rhat_packed_counts_exact(rng):
    """Octahedral rhat packing on the plain gather frames form: counts
    exact, angles within the quantization tolerance."""
    box = 80.0
    pos, vel, label, cen_seq = _churn_pool(rng)
    N = label.shape[1]
    S = label.shape[0]
    kw = dict(event_capacity=128, box_size=box, row_width=256,
              bulk_vel_seq=np.zeros((S, 3, 3), np.float32),
              frames="gather")
    _, ev_f = scan_label_events(
        init_label_carry(N, row_width=256), jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), jnp.asarray(cen_seq),
        **kw)
    _, ev_p = scan_label_events(
        init_label_carry(N, rhat_packed=True, row_width=256),
        jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(label), jnp.asarray(cen_seq),
        rhat_packed=True, **kw)
    ev_f, ev_p = jax.tree.map(np.asarray, (ev_f, ev_p))
    np.testing.assert_array_equal(ev_f.count, ev_p.count)
    for s in range(S):
        for r in range(ev_f.count.shape[1]):
            k = ev_f.count[s, r]
            of = np.argsort(ev_f.index[s, r, :k])
            op = np.argsort(ev_p.index[s, r, :k])
            np.testing.assert_array_equal(
                ev_f.index[s, r, :k][of], ev_p.index[s, r, :k][op])
            np.testing.assert_allclose(
                ev_f.angle[s, r, :k][of], ev_p.angle[s, r, :k][op],
                atol=5e-3,
            )
