"""A/B bench: general compact-event scan vs sorted-carry scan (rows
load-ordered and ID-presorted) at the headline bench shape on the GPU
(a toy shape elsewhere).  Usage:

    python benchmarks/sorted_vs_general.py [H P S]
"""

import os
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # see bench.py

import numpy as np  # noqa: E402

sys.path.insert(0, ".")
from bench import make_sequence  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.engine.scan import (
        scan_events_compact,
        scan_events_sorted,
    )
    from orbitanalysis_tpu.ops.apsis import SnapshotBatch, init_carry
    from orbitanalysis_tpu.ops.sorted_step import init_sorted_carry

    if len(sys.argv) > 3:
        H, P, S = map(int, sys.argv[1:4])
    elif jax.devices()[0].platform == "gpu":
        H, P, S = 64, 32768, 16
    else:
        H, P, S = 8, 2048, 8
    K = max(128, P // 4)
    print(f"platform={jax.devices()[0].platform} H={H} P={P} S={S} K={K}")

    ids_seq, pos_seq, vel_seq, centers_seq, _ = make_sequence(H, P, S)
    snaps = SnapshotBatch(
        ids=jnp.asarray(np.ascontiguousarray(ids_seq)),
        pos=jnp.asarray(pos_seq),
        vel=jnp.asarray(vel_seq),
        center=jnp.asarray(np.ascontiguousarray(centers_seq)),
        mass=None,
        bulk_vel=None,
        hubble_drag=jnp.zeros(S, dtype=jnp.float32),
    )

    def timeit(fn, c, batch, label, repeats=5):
        out = fn(c, batch)
        tot = (int(np.asarray(out[0])), int(np.asarray(out[1])),
               float(np.asarray(out[2])))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(c, batch))
            best = min(best, time.perf_counter() - t0)
        ups = S * H * P / best
        print(f"{label:28s} {best*1e3:9.2f} ms/scan  {ups:.3e} up/s "
              f"({tot[0]} events)")
        return best, tot

    def _summarize(cnt, ids, angles):
        # content checksum, not just totals: masked event-ID sum catches
        # wrong matches/ordering-of-content that count sums coincide on
        kiota = jnp.arange(ids.shape[-1])[None, None, :]
        mask = kiota < cnt[..., None]
        chk = jnp.sum(jnp.where(mask, ids, 0).astype(jnp.uint32))
        asum = jnp.sum(jnp.where(mask, angles, 0.0))
        return jnp.sum(cnt), chk, asum, jnp.max(cnt)

    def run_general(c, s):
        _, (cnt, ids, angles) = scan_events_compact(
            c, s, K, mode="pericentric", box_size=100.0
        )
        return _summarize(cnt, ids, angles)

    def run_sorted(c, s):
        _, (cnt, ids, angles) = scan_events_sorted(
            c, s, K, mode="pericentric", box_size=100.0
        )
        return _summarize(cnt, ids, angles)

    t_g, ev_g = timeit(jax.jit(run_general), init_carry(H, P), snaps,
                       "general")
    t_s, ev_s = timeit(jax.jit(run_sorted), init_sorted_carry(H, P),
                       snaps, "sorted-carry")
    assert ev_g[:2] == ev_s[:2] and abs(ev_g[2] - ev_s[2]) < 1.0, (ev_g, ev_s)
    print(f"speedup: {t_g / t_s:.3f}x")

    # staged ID-sorted rows (the tracker's sorted engine staging)
    from orbitanalysis_tpu.ops.sorted_step import presort_snapshot

    snaps_sorted = jax.tree.map(
        jnp.asarray, presort_snapshot(jax.tree.map(np.asarray, snaps))
    )
    t_ps, ev_ps = timeit(jax.jit(run_sorted), init_sorted_carry(H, P),
                         snaps_sorted, "sorted-carry, presorted")
    assert ev_g[:2] == ev_ps[:2] and abs(ev_g[2] - ev_ps[2]) < 1.0, (ev_g, ev_ps)
    print(f"  -> speedup vs general: {t_g / t_ps:.3f}x")


if __name__ == "__main__":
    main()
