"""orbitanalysis_tpu — an accelerator-native orbit-tracking framework.

A ground-up re-design of the capabilities of ``s-balu/nbody-orbit-analysis``
(pericenter/apocenter detection for particles orbiting halos in cosmological
N-body simulations) for a GPU: JAX/XLA for the compute path, padded
static-shape state resident in device memory, host-staged stable
layouts or sort-merge joins for ID matching, ``lax.scan`` over the
snapshot time axis, and ``jax.sharding`` over device meshes for
scale-out.

Public API (mirrors and extends the reference surface,
``/root/reference/orbitanalysis/__init__.py``):

- :func:`track_orbits` — offline multi-snapshot orbit tracking
  (reference: ``track_orbits.py:9``).
- :func:`track_orbits_onthefly` — single snapshot-pair, on-the-fly mode
  (reference: ``track_orbits_onthefly.py:8``).
- :class:`Apsides` — postprocessing/collation of apsis catalogs
  (reference: ``postprocessing.py:8``).
- :class:`OrbitDecomposition` — per-halo orbit decomposition + plotting
  (the API used by the reference's ``example_script.py:76-95`` but absent
  from its package; provided here as a real implementation).
- :func:`get_central_particle_ids`, :func:`find_main_progenitors` —
  progenitor linking (reference: ``progenitors.py``).
"""

__version__ = "0.1.0"

from orbitanalysis_tpu.engine.tracker import track_orbits
from orbitanalysis_tpu.engine.onthefly import track_orbits as track_orbits_onthefly
from orbitanalysis_tpu.postprocessing import Apsides, OrbitDecomposition
from orbitanalysis_tpu.progenitors import (
    find_main_progenitors,
    get_central_particle_ids,
    get_central_particle_ids_device,
)
from orbitanalysis_tpu.utils.numerics import (
    hubble_parameter,
    myin1d,
    recenter_coordinates,
    vector_norm,
)

__all__ = [
    "track_orbits",
    "track_orbits_onthefly",
    "Apsides",
    "OrbitDecomposition",
    "get_central_particle_ids",
    "get_central_particle_ids_device",
    "find_main_progenitors",
    # reference utils surface (utils.py:4-39), for user analysis
    # scripts migrating from `from orbitanalysis.utils import ...`
    "myin1d",
    "vector_norm",
    "recenter_coordinates",
    "hubble_parameter",
    "__version__",
]
