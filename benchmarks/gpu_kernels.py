"""Per-kernel timings on the GPU behind each ``auto`` choice of
:mod:`orbitanalysis_tpu.policy`, and the hand-written kernel against
the plain version XLA compiles.

    python benchmarks/gpu_kernels.py [--only NAME ...]

Sections (each prints one JSON line per measurement, with the card's
name and power limit):

- ``compact``: the XLA event compaction at ``[64, 32768]``, K = P/8;
- ``frames``: one label-native step per ``frames`` form at N = 2**21,
  H = 64 and H = 1536;
- ``pm``: CIC deposit and each interpolation form at 256^3 particles
  on a 256^3 grid, and the whole force evaluation;
- ``direct``: the Triton direct-force kernel (several launch
  configurations) against the plain-XLA blocked form at N = 16384,
  65536, 262144, each against float64 NumPy on 2048 targets.

Times are medians of ``--reps`` calls after a warm-up, each call ended
by ``block_until_ready``.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


CARD = None


def emit(**kw):
    print(json.dumps(dict(kw, card=CARD)), flush=True)


def timed(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_compact(reps):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.compact import compact_angle

    H, P = 64, 32768
    K = P // 8
    rng = np.random.default_rng(0)
    sel = rng.random((H, P)) < 0.017
    ang = rng.uniform(0, 3, (H, P)).astype(np.float32)
    aw = jnp.asarray(ang.view(np.uint32) | (sel.astype(np.uint32) << 31))
    f = jax.jit(lambda x: compact_angle(x, K))
    t = timed(f, aw, reps=reps)
    nbytes = H * P * 4 + H * K * 4 + H * 4
    emit(section="compact", shape=[H, P], k=K, density=0.017, seconds=t,
         bytes=nbytes, gbytes_per_s=nbytes / t / 1e9)


def bench_frames(reps):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.label_step import (
        init_label_carry,
        make_label_orbit_step,
    )

    N, W = 1 << 21, 1 << 15
    R = N // W
    rng = np.random.default_rng(1)
    for H in (64, 1536):
        pos = jnp.asarray(rng.uniform(0, 100, (3, R, W)).astype(np.float32))
        vel = jnp.asarray(rng.normal(size=(3, R, W)).astype(np.float32))
        lab = jnp.asarray(rng.integers(-1, H, (R, W)).astype(np.int32))
        cen = jnp.asarray(rng.uniform(20, 80, (H, 3)).astype(np.float32))
        for frames in ("gather", "matmul", "twolevel"):
            step = jax.jit(make_label_orbit_step(
                W // 8, box_size=100.0, row_width=W, frames=frames,
                n_halos=H))
            c = init_label_carry(N, row_width=W)

            def f(c, step=step):
                return step(c, (pos, vel, lab, cen, None, None,
                                jnp.float32(0.0)))

            t = timed(f, c, reps=reps)
            emit(section="frames", n=N, halos=H, frames=frames,
                 step_seconds=t)


def bench_pm(reps):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.models.pm import (
        cic_deposit,
        cic_interpolate,
        cic_interpolate_cells,
        cic_interpolate_rows,
        pm_forces,
        pm_forces_grid,
    )

    grid, box = 256, 100.0
    n = grid ** 3
    rng = np.random.default_rng(2)
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)).astype(np.float32))
    mass = jnp.ones((n,), jnp.float32)
    dep = jax.jit(lambda p, m: cic_deposit(p, m, grid, box))
    emit(section="pm", part="deposit (scatter-add)", n=n, grid=grid,
         seconds=timed(dep, pos, mass, reps=reps))
    rho = dep(pos, mass)
    fft = jax.jit(lambda r: pm_forces_grid(r, grid, box))
    emit(section="pm", part="FFT solve", n=n, grid=grid,
         seconds=timed(fft, rho, reps=reps))
    field = fft(rho)
    for name, interp in (("scalar", cic_interpolate),
                         ("rows", cic_interpolate_rows),
                         ("cells", cic_interpolate_cells)):
        f = jax.jit(lambda fl, p, interp=interp: interp(fl, p, grid, box))
        emit(section="pm", part=f"interpolate {name}", n=n, grid=grid,
             seconds=timed(f, field, pos, reps=reps))
    for a in ("scalar", "rows", "cells"):
        f = jax.jit(lambda p, m, a=a: pm_forces(p, m, grid, box,
                                                assignment=a))
        emit(section="pm", part=f"force evaluation, {a}", n=n, grid=grid,
             seconds=timed(f, pos, mass, reps=reps))


def bench_direct(reps):
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.ops.pallas_nbody import (
        direct_forces_blocked,
        direct_forces_triton,
    )

    configs = [
        dict(tile_t=64, tile_s=128, num_warps=4, num_stages=2),
        dict(tile_t=32, tile_s=128, num_warps=4, num_stages=3),
        dict(tile_t=32, tile_s=64, num_warps=2, num_stages=2),
        dict(tile_t=16, tile_s=128, num_warps=4, num_stages=2),
        dict(tile_t=64, tile_s=64, num_warps=4, num_stages=2),
    ]
    rng = np.random.default_rng(3)
    for n in (16384, 65536, 262144):
        pos_h = rng.uniform(0, 10, (n, 3)).astype(np.float32)
        m_h = rng.uniform(0.5, 2.0, n).astype(np.float32)
        pos, m = jnp.asarray(pos_h), jnp.asarray(m_h)
        # float64 reference on the first 2048 targets
        p64 = pos_h.astype(np.float64)
        ref = np.zeros((2048, 3))
        for i0 in range(0, 2048, 256):
            d = p64[None, :, :] - p64[i0:i0 + 256, None, :]
            d2 = np.maximum((d * d).sum(-1) + 0.01, 1e-18)
            ref[i0:i0 + 256] = ((m_h[None, :] / d2 ** 1.5)[..., None]
                                * d).sum(1)
        r = 3 if n == 262144 else reps

        def err(a):
            a = np.asarray(a)[:2048]
            return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))

        for tile in (256, 512):
            f = jax.jit(lambda p, mm, tile=tile: direct_forces_blocked(
                p, mm, softening=0.1, tile=tile))
            emit(section="direct", impl="xla-blocked", n=n, tile=tile,
                 seconds=timed(f, pos, m, reps=r), rel_l2=err(f(pos, m)))
        for cfg in configs:
            f = jax.jit(lambda p, mm, cfg=cfg: direct_forces_triton(
                p, mm, softening=0.1, **cfg))
            emit(section="direct", impl="triton", n=n, **cfg,
                 seconds=timed(f, pos, m, reps=r), rel_l2=err(f(pos, m)))


SECTIONS = {"compact": bench_compact, "frames": bench_frames,
            "pm": bench_pm, "direct": bench_direct}


def main():
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(SECTIONS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"gpu_kernels.py measures the GPU; JAX found "
                 f"{dev.platform!r}")
    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    CARD = card()
    for name in args.only:
        SECTIONS[name](args.reps)


if __name__ == "__main__":
    main()
