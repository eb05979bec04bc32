"""Compiled kernels on the card.  Skipped without a GPU; run with
``ORBIT_TPU_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu`` (one
phase of ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("box", [None, 10.0])
def test_triton_direct_forces_compiled(gpu, rng, box):
    """The Triton kernel compiled for the card (not interpreted) agrees
    with the plain-XLA blocked form, free and periodic, ragged N."""
    from orbitanalysis_tpu.ops.pallas_nbody import (
        direct_forces_blocked,
        direct_forces_triton,
    )

    n = 5000
    pos = jnp.asarray(rng.uniform(0, 10, (n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    a = np.asarray(direct_forces_triton(pos, mass, softening=0.1,
                                        box_size=box))
    b = np.asarray(direct_forces_blocked(pos, mass, softening=0.1,
                                         box_size=box))
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-5


def test_compaction_compiled(gpu, rng):
    """The XLA event compaction on the card: front-packed in position
    order, zero fill, true counts past K."""
    from orbitanalysis_tpu.ops.compact import compact_payload

    h, p, k = 8, 32768, 256
    sel = rng.random((h, p)) < 0.02
    pos = np.broadcast_to(np.arange(p, dtype=np.uint32), (h, p))
    pay = np.where(sel, ((pos + 1) << 15) | 5, np.uint32(0))
    got, cnt = compact_payload(jnp.asarray(pay), k)
    got, cnt = np.asarray(got), np.asarray(cnt)
    np.testing.assert_array_equal(cnt, sel.sum(1))
    for r in range(h):
        want = pay[r, sel[r]][:k]
        np.testing.assert_array_equal(got[r, :len(want)], want)
        assert not got[r, len(want):].any()


def test_label_gather_frames_compiled(gpu, rng):
    """The label step's plain gather frames on the card reproduce the
    select reference bit-exactly (explicit bulk velocities)."""
    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        make_label_orbit_step,
    )

    H, R, W = 64, 4, 4096
    N = R * W
    outs = {}
    pos = jnp.asarray(rng.uniform(0, 100, (2, 3, R, W)).astype(np.float32))
    vel = jnp.asarray(rng.normal(size=(2, 3, R, W)).astype(np.float32))
    lab = jnp.asarray(rng.integers(-1, H, (R, W)).astype(np.int32))
    cen = jnp.asarray(rng.uniform(20, 80, (H, 3)).astype(np.float32))
    bulk = jnp.zeros((H, 3), jnp.float32)
    for frames in ("select", "gather"):
        step = jax.jit(make_label_orbit_step(
            512, box_size=100.0, row_width=W, frames=frames))
        c = init_label_carry(N, row_width=W)
        for s in range(2):
            c, ev = step(c, (pos[s], vel[s], lab, cen, bulk, None,
                             jnp.float32(0.0)))
        outs[frames] = jax.tree.map(np.asarray, (c, ev))
    for a, b in zip(jax.tree.leaves(outs["select"]),
                    jax.tree.leaves(outs["gather"])):
        np.testing.assert_array_equal(a, b)
