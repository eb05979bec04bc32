"""AOT memory probe for the config-4 on-the-fly run: lower + compile
``simulate_with_tracking`` for the ambient device at a target
(particles, grid) WITHOUT executing, and print XLA's memory analysis —
temp allocation is what runs out of memory, and compiling is far
cheaper than provoking the failure.

Run: python benchmarks/config4_memprobe.py --millions 33.5 --grid 512
     [--steps 32] [--interp rows]
"""

import argparse
import os
import sys

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np  # noqa: E402

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--millions", type=float, default=33.5)
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--detect-every", type=int, default=8)
    ap.add_argument("--interp", type=str, default="auto")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from orbitanalysis_tpu.models import NBodyState, OrbitNBodyConfig
    from orbitanalysis_tpu.models.nbody import (
        _tracked_run,
        init_track_state,
    )
    from orbitanalysis_tpu.models.pm import make_pm_force_fn

    n = int(args.millions * 1e6)
    P = 65536
    H = n // P
    n = H * P
    box = 100.0

    state = NBodyState(
        pos=jax.ShapeDtypeStruct((n, 3), jnp.float32),
        vel=jax.ShapeDtypeStruct((n, 3), jnp.float32),
        mass=jax.ShapeDtypeStruct((n,), jnp.float32),
    )
    members = jax.ShapeDtypeStruct((H, P), jnp.int32)
    force = make_pm_force_fn(args.grid, assignment=args.interp)
    cfg = OrbitNBodyConfig(
        n_steps=args.steps, detect_every=args.detect_every, dt=1e-3,
        mode="pericentric", box_size=box, softening=0.0, G=1.0,
    )
    print(
        f"lowering: {n/1e6:.1f}M particles, {args.grid}^3, "
        f"interp={args.interp}, {args.steps} steps on "
        f"{jax.default_backend()}", flush=True,
    )
    lowered = _tracked_run.lower(
        state, members, None, None, None,
        jax.ShapeDtypeStruct((), jnp.int32), force, cfg, True,
    )
    compiled = lowered.compile()
    m = compiled.memory_analysis()
    gb = 1 << 30
    print(
        f"argument {m.argument_size_in_bytes/gb:.2f} GiB | "
        f"output {m.output_size_in_bytes/gb:.2f} GiB | "
        f"temp {m.temp_size_in_bytes/gb:.2f} GiB | "
        f"total {(m.argument_size_in_bytes + m.output_size_in_bytes + m.temp_size_in_bytes)/gb:.2f} GiB",
        flush=True,
    )


if __name__ == "__main__":
    main()
