"""Distributed on-the-fly orbit tracking: slab-resident P3M forces +
fused apsis detection over a device mesh.

Runs on the devices JAX finds (every GPU of the host, for example):

    python examples/distributed_simulation.py

or, with no accelerator, on 8 virtual CPU devices:

    python examples/distributed_simulation.py --cpu-mesh

Add `jax.distributed.initialize()` (see
``orbitanalysis_tpu.parallel.multihost``) for multi-host runs.

The reference package has no counterpart for any of this — its
on-the-fly mode expects an external simulation code to call it
per-snapshot (``/root/reference/orbitanalysis/track_orbits_onthefly
.py``), while here the integrator, the force solver, and the
pericenter detector all run on-device with the particle axis sharded.
"""

import os
import sys

if "--cpu-mesh" in sys.argv[1:]:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np

from orbitanalysis_tpu.models import (
    NBodyState,
    OrbitNBodyConfig,
    simulate_with_tracking,
)
from orbitanalysis_tpu.models.pm_sharded import (
    make_slab_resident_pm_force_fn,
)
from orbitanalysis_tpu.parallel import make_mesh


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    # a cold collapsing cloud in a periodic box
    rng = np.random.default_rng(42)
    n, box, grid = 4096, 20.0, 8 * max(n_dev, 4)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 50.0 / n, np.float32)

    # grid-resident distributed P3M: per-device memory O(grid^3/n_dev),
    # short-range erfc correction on slab-local cells
    mesh = make_mesh({"x": n_dev})
    force = make_slab_resident_pm_force_fn(
        mesh, grid, deconvolve=True, p3m_sigma_cells=1.5
    )

    state = NBodyState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(mass))
    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(
        dt=0.05, n_steps=60, detect_every=4, box_size=box,
        softening=0.05,
    )
    state, track, events = simulate_with_tracking(
        state, members, cfg, force_fn=force
    )

    counts = np.asarray(track.counts)[0]
    print(f"steps: {cfg.n_steps} (detector every {cfg.detect_every})")
    print(f"pericenter passages: total {counts.sum()}, "
          f"max per particle {counts.max()}, "
          f"{(counts > 0).sum()}/{n} particles with >= 1")
    assert not np.isnan(np.asarray(state.pos)).any()
    print("positions finite; done")


if __name__ == "__main__":
    main()
