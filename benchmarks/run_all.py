"""Full benchmark harness: per-component throughput on the local device.

Produces a markdown table (stdout) + JSON-lines (``--json FILE``) for:

- orbit step via the compact-event scan (the bench.py headline)
- NumPy reference-style baseline (clean-room, per-halo loop)
- direct N-body forces: Gram (jnp) vs the blocked form the policy picks
- PM solver at several grid sizes
- host packing: NumPy scatter vs native C++ packer

Usage: python benchmarks/run_all.py [--small] [--json out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # see bench.py

import numpy as np  # noqa: E402

sys.path.insert(0, ".")  # repo root (bench.py helpers)
import bench as headline  # noqa: E402


def timed(fn, repeats=3):
    import jax

    jax.block_until_ready(fn())  # warm-up / compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    platform = jax.devices()[0].platform
    small = args.small or platform != "gpu"
    rows = []

    def emit(name, value, unit, detail=""):
        rows.append(dict(name=name, value=value, unit=unit, detail=detail))
        print(f"| {name} | {value:.3e} | {unit} | {detail} |", flush=True)

    print(f"platform: {platform}\n")
    print("| benchmark | value | unit | detail |")
    print("|---|---|---|---|")

    # ---- headline: orbit step scan -----------------------------------
    H, P, S = (8, 2048, 8) if small else (64, 32768, 16)
    seq = headline.make_sequence(H, P, S)
    ups, events, t = headline.device_updates_per_s(*seq)
    emit("orbit step scan", ups, "updates/s", f"H={H} P={P} S={S}")

    b_ups, _ = headline.numpy_baseline_updates_per_s(
        *(a[: min(S, 6), : min(H, 8), : min(P, 4096)] if a.ndim > 2
          else a[: min(S, 6), : min(H, 8)] for a in seq[:4])
    )
    emit("numpy reference loop", b_ups, "updates/s", "clean-room baseline")

    # ---- N-body forces ----------------------------------------------
    from orbitanalysis_tpu.models.nbody import (
        direct_forces,
        make_direct_force_fn,
    )
    from orbitanalysis_tpu.policy import direct_force_impl

    n = 4096 if small else 16384
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    jf = jax.jit(lambda: jnp.sum(direct_forces(pos, mass, softening=0.1)))
    t_g = timed(jf)
    emit("direct forces (gram)", n * n / t_g, "pair/s", f"N={n}")
    blocked = make_direct_force_fn(use_pallas=True)
    pf = jax.jit(lambda: jnp.sum(blocked(pos, mass, softening=0.1)))
    t_p = timed(pf)
    emit(f"direct forces (blocked, {direct_force_impl()})", n * n / t_p,
         "pair/s", f"N={n}")

    # ---- PM solver --------------------------------------------------
    from orbitanalysis_tpu.models.pm import pm_forces

    n_pm = 100_000 if small else 1_000_000
    grid = 64 if small else 128
    box = 100.0
    posm = jnp.asarray(
        rng.uniform(0, box, size=(n_pm, 3)).astype(np.float32)
    )
    massm = jnp.ones((n_pm,), jnp.float32)
    pmf = jax.jit(
        lambda: jnp.sum(pm_forces(posm, massm, grid, box))
    )
    t_pm = timed(pmf)
    emit("pm solver", n_pm / t_pm, "particle/s", f"N={n_pm} grid={grid}^3")

    # ---- host packing -----------------------------------------------
    from orbitanalysis_tpu import native
    from orbitanalysis_tpu.utils.padding import _row_col

    n_blocks, avg = (20, 50_000) if small else (100, 500_000)
    lens = rng.integers(avg // 2, avg * 3 // 2, n_blocks)
    offsets = np.concatenate(([0], np.cumsum(lens)))[:-1]
    total = int(lens.sum())
    values = rng.normal(size=(total, 3)).astype(np.float32)
    rws = rng.permutation(n_blocks)
    cap = int(lens.max() * 1.1) // 128 * 128 + 128

    t0 = time.perf_counter()
    out = np.zeros((n_blocks, cap, 3), np.float32)
    rr, cc = _row_col(lens, rws)
    out[rr, cc] = values
    t_np = time.perf_counter() - t0
    emit("host pack (numpy)", total / t_np, "particle/s", f"{total/1e6:.0f}M")
    if native.ensure() is not None:
        t0 = time.perf_counter()
        native.pack_ragged_native(values, offsets, n_blocks, cap, rws, 0.0)
        t_na = time.perf_counter() - t0
        emit("host pack (native)", total / t_na, "particle/s",
             f"{t_np / t_na:.1f}x numpy")

    if args.json:
        with open(args.json, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
