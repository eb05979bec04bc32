"""Backend policy: the one place where the program chooses an engine,
a kernel form or a setting from what it can observe — the platform
JAX runs on, the shapes, and the particle-ID width.

Every ``'auto'`` option in the package resolves here, so a change of
policy is one edit, and ``tests/test_policy.py`` pins what each
platform gets.  The GPU choices rest on measurements on an H100
(``PERF.md`` gives each number with the card's name and power limit);
the CPU choices keep the CPU test tier fast and are not performance
claims.
"""

from __future__ import annotations

import numpy as np


def platform() -> str:
    """The default backend's platform name (``'gpu'``, ``'cpu'``...)."""
    import jax

    return jax.default_backend()


def join_engine(id_dtype, angle_dtype, particles_axis: bool = False) -> str:
    """``track_orbits(join_impl='auto')``: ``'aligned'`` or
    ``'general'``.

    64-bit IDs take the aligned engine where it applies: its detection
    is positional, so the device streams a 32-bit position surrogate
    and no x64 mode is needed (the general engine would need 64-bit
    device IDs).  32-bit IDs take the general engine on every platform:
    at the config-2 deployment on an H100 its warm end-to-end wall is
    about half the aligned engine's, whose host-side stable-layout
    staging dominates there (PERF.md).
    """
    idt = np.dtype(id_dtype)
    if (
        not particles_axis
        and idt.itemsize == 8
        and np.issubdtype(idt, np.signedinteger)
        and np.dtype(angle_dtype) == np.float32
    ):
        return "aligned"
    return "general"


def interpolation(grid: int) -> str:
    """``pm_forces(assignment='auto')``: the plain 24-gather
    ``'scalar'`` form, measured fastest of the three at 256^3 on an
    H100 (PERF.md); the corner-table forms (``'rows'``, ``'cells'``)
    stay available as explicit choices."""
    del grid
    return "scalar"


#: Halo count from which the CPU takes the label step's two-level split.
TWOLEVEL_MIN_H = 256


def label_frames(n_halos: int, plat: str | None = None) -> str:
    """``make_label_orbit_step(frames='auto')``.  On the GPU the plain
    ``'gather'`` form (segment sum + table gather, O(N)) is measured
    fastest at both halo-count regimes (PERF.md).  The CPU keeps the
    one-hot matmul below ``TWOLEVEL_MIN_H`` halos and the two-level
    split above."""
    plat = platform() if plat is None else plat
    if plat == "gpu":
        return "gather"
    return "twolevel" if n_halos >= TWOLEVEL_MIN_H else "matmul"


def direct_force_impl(plat: str | None = None) -> str:
    """Blocked direct-force form: the Triton kernel where the platform
    compiles it (measured 2.3-4.5x the plain-XLA blocked form on an
    H100, PERF.md), the plain-XLA blocked form elsewhere."""
    plat = platform() if plat is None else plat
    return "triton" if plat == "gpu" else "xla"


def compile_cache_enabled(plat: str | None = None) -> bool:
    """Persistent compilation cache: on for the GPU.  XLA:CPU cache
    entries pin host machine features and can fault when loaded under
    another feature set, and CPU compiles are quick, so the CPU stays
    uncached."""
    plat = platform() if plat is None else plat
    return plat == "gpu"
