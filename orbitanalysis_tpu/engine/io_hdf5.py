"""HDF5 persistence with the reference's exact savefile schema.

Output layout matches ``/root/reference/orbitanalysis/track_orbits.py:354-397``
dataset-for-dataset so downstream consumers of the reference's files can
read ours unchanged:

- root attrs: ``mode``, ``box_size`` (when periodic)
- one group ``snapshot_%03d`` per processed snapshot (after the first),
  holding ``region_offsets`` (cumulative apsis counts per halo),
  ``{peri|apo}center_IDs``, ``angles`` (float16), ``halo_IDs``,
  ``final_descendant_IDs`` (absent on the final snapshot),
  ``region_radii``, ``region_positions``, ``bulk_velocities``
- an optional ``<savefile>.checkpoint`` sidecar with the per-particle
  cumulative ``angles`` of the last written snapshot
  (``track_orbits.py:390-394``), used by resume.
"""

from __future__ import annotations

import os
import time

import numpy as np


def h5file(*args, **kwargs):
    """``h5py.File`` with h5py imported where a file is opened: the
    package and its device path need only jax and numpy."""
    import h5py

    return h5py.File(*args, **kwargs)


def apsis_tag(mode: str) -> str:
    """'pericentric' -> 'pericenter', 'apocentric' -> 'apocenter'
    (the reference's ``mode[:-3] + 'er'`` convention,
    ``track_orbits.py:380``)."""
    return mode[:-3] + "er"


def normalize_mode_savefiles(mode, savefile):
    """Validate ``(mode, savefile)`` and return ``(modes, savefiles)``
    lists — the shared contract of both tracking drivers:
    ``mode='both'`` takes a pair of distinct paths (pericentric first),
    a single mode takes one path."""
    if mode == "both":
        if isinstance(savefile, (str, bytes, os.PathLike)):
            raise ValueError(
                "mode='both' writes two reference-schema savefiles; "
                "pass savefile=(pericentric_path, apocentric_path)"
            )
        savefiles = [os.fspath(p) for p in savefile]
        if len(savefiles) != 2 or savefiles[0] == savefiles[1]:
            raise ValueError(
                "mode='both' needs two distinct savefile paths, "
                f"got {savefiles!r}"
            )
        return ["pericentric", "apocentric"], savefiles
    if mode in ("pericentric", "apocentric"):
        return [mode], [os.fspath(savefile)]
    raise ValueError(
        "Orbit detection mode not recognized. Please specify either "
        "'pericentric' or 'apocentric'."
    )


def initialize_savefile(savefile, mode, box_size, verbose=True):
    os.makedirs(os.path.dirname(os.path.abspath(savefile)), exist_ok=True)
    with h5file(savefile, "w") as hf:
        hf.attrs["mode"] = mode
        if box_size is not None:
            hf.attrs["box_size"] = box_size
    if verbose:
        print("Savefile initialized\n")


def append_snapshot(
    savefile,
    snapshot_number,
    mode,
    apsis_ids,
    apsis_offsets,
    apsis_angles,
    halo_ids,
    final_descendant_ids,
    region_radii,
    region_positions,
    bulk_velocities,
    verbose=True,
    angle_store_dtype=np.float16,
):
    if verbose:
        print("Saving to file...")
        t0 = time.time()
    with h5file(savefile, "r+") as hf:
        g = hf.create_group("snapshot_%03d" % snapshot_number)
        g.create_dataset("region_offsets", data=np.asarray(apsis_offsets))
        g.create_dataset(apsis_tag(mode) + "_IDs", data=np.asarray(apsis_ids))
        g.create_dataset(
            "angles", data=np.asarray(apsis_angles, dtype=angle_store_dtype)
        )
        g.create_dataset("halo_IDs", data=np.asarray(halo_ids))
        if final_descendant_ids is not None:
            g.create_dataset(
                "final_descendant_IDs", data=np.asarray(final_descendant_ids)
            )
        g.create_dataset("region_radii", data=np.asarray(region_radii))
        g.create_dataset("region_positions", data=np.asarray(region_positions))
        g.create_dataset("bulk_velocities", data=np.asarray(bulk_velocities))
    if verbose:
        print("Saved to file ({} s)\n".format(time.time() - t0))


def write_checkpoint(savefile, angles, snapshot_number,
                     angle_store_dtype=np.float16, layout_positions=None):
    """Angle sidecar (+ optional aligned-engine layout).

    ``layout_positions``: per-particle stable row position in load
    order, flat like ``angles`` — lets a resumed aligned engine rebuild
    its history-dependent :class:`~orbitanalysis_tpu.engine.packing.
    StableLayout` exactly, so resume stays bit-identical (a fresh
    layout would re-place particles and perturb the bulk-velocity
    reduction order by ~1 ulp).
    """
    with h5file(savefile + ".checkpoint", "w") as hf:
        hf.create_dataset("angles", data=np.asarray(angles, dtype=angle_store_dtype))
        if layout_positions is not None:
            hf.create_dataset(
                "layout_positions",
                data=np.asarray(layout_positions, dtype=np.int32),
            )
        hf.attrs["snapshot_number"] = int(snapshot_number)


def read_checkpoint(savefile, with_layout=False):
    with h5file(savefile + ".checkpoint", "r") as hf:
        angles = hf["angles"][:]
        snap = int(hf.attrs.get("snapshot_number", -1))
        if with_layout:
            layout = (
                hf["layout_positions"][:]
                if "layout_positions" in hf else None
            )
            return angles, snap, layout
        return angles, snap


def last_snapshot_number(savefile) -> int:
    """Resume anchor: number of the last written snapshot group
    (``track_orbits.py:93-99``)."""
    with h5file(savefile, "r") as hf:
        nums = sorted(
            int(k.split("_")[1])
            for k in hf.keys()
            if k.startswith("snapshot_")
        )
        if not nums:
            raise ValueError(f"no snapshot groups in {savefile}; cannot resume")
        return nums[-1]
