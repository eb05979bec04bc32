"""Stable-layout staging throughput vs OpenMP worker count.

The aligned engine's host tier (``native/packing.cpp:stable_align5`` /
``stable_align_seq1``) is row-parallel OpenMP; this benchmark measures
its throughput at the headline bench shape for increasing thread
counts — the scaling curve the round-2 review asked for alongside the
sustained metric.  Each point runs in a subprocess so OMP_NUM_THREADS
binds before libgomp initializes.

On a one-core host the curve is flat by construction; on a multi-core
host the same binary scales over rows.

Usage: python benchmarks/staging_scale.py [--threads 1,2,4,8]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = """
import os, sys, time
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
import numpy as np
sys.path.insert(0, {repo!r})
from orbitanalysis_tpu.engine.packing import StableLayout
from orbitanalysis_tpu import native
assert native.ensure() is not None

H, P, S = 64, 32768, 8
rng = np.random.default_rng(0)
pool = np.arange(H * P, dtype=np.int32).reshape(H, P)
n_valid = int(P * 0.9)
k = int(round(0.07 * n_valid))
ids = np.full((S, H, P), np.iinfo(np.int32).max, np.int32)
member = np.zeros((H, P), bool)
init = np.argsort(rng.random((H, P)), axis=1)[:, :n_valid]
np.put_along_axis(member, init, True, axis=1)
rows = np.arange(H)[:, None]
for s in range(S):
    if s and k:
        keys = np.where(member, rng.random((H, P)), np.inf)
        member[rows, np.argpartition(keys, k - 1, axis=1)[:, :k]] = False
        keys = np.where(member, np.inf, rng.random((H, P)))
        member[rows, np.argpartition(keys, k - 1, axis=1)[:, :k]] = True
    keys = np.where(member, rng.random((H, P)), np.inf)
    sel = np.argsort(keys, axis=1)[:, :n_valid]
    ids[s, :, :n_valid] = np.take_along_axis(pool, sel, axis=1)
pos = rng.random((S, H, P, 3), np.float32)
vel = rng.random((S, H, P, 3), np.float32)

out = (
    np.zeros((S, H, P), np.int32), np.zeros((S, 3, H, P), np.float32),
    np.zeros((S, 3, H, P), np.float32), None,
    np.zeros((S, H, P), np.int32),
)
for a in out:
    if a is not None:
        a[...] = 0  # fault in
best = float("inf")
for _ in range(3):
    lay = StableLayout(H, P)
    t0 = time.perf_counter()
    res = native.stable_align_seq_native(
        lay.layout, ids, pos, vel, None, lay.invalid, out=out, soa=True)
    assert res is not None
    best = min(best, time.perf_counter() - t0)
print(S * H * P / best / 1e6)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="1,2,4,8")
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = {}
    for nt in (int(t) for t in args.threads.split(",")):
        env = dict(os.environ, OMP_NUM_THREADS=str(nt),
                   JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-c", _CHILD.format(repo=repo)],
            capture_output=True, text=True, env=env, timeout=600,
        )
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            raise SystemExit(1)
        results[nt] = float(out.stdout.strip().splitlines()[-1])
        print(f"OMP_NUM_THREADS={nt}: {results[nt]:.1f} M rows/s")
    print(json.dumps({
        "metric": "staging_rows_per_sec_vs_workers",
        "unit": "M rows/s",
        "nproc": os.cpu_count(),
        "curve": results,
    }))


if __name__ == "__main__":
    main()
