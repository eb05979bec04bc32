"""Postprocessing: apsis collation, orbit decomposition, plotting.

Two classes:

- :class:`Apsides` — reference-compatible collation of the tracking
  savefile into per-snapshot orbit-count catalogs
  (``/root/reference/orbitanalysis/postprocessing.py:8-240``).
- :class:`OrbitDecomposition` — the per-halo decomposition + plotting API
  that the reference's ``example_script.py:76-95`` *uses* but whose
  implementation is absent from the reference package (SURVEY.md
  "Inconsistencies" #1).  Implemented here for real: per-particle orbit
  counts for one halo at one snapshot, matched onto snapshot particle
  data, with position-space and phase-space scatter plots.

Deviations from the reference (documented improvements):

- collation iterates requested halos in their given order and writes
  blocks only for halos present at each snapshot, which matches the
  reference output whenever the requested IDs are sorted (the reference's
  offset bookkeeping silently assumes this; ``postprocessing.py:133-142``);
- ``save_final_apsis_counts`` stores integer counts (the reference
  allocates float64, ``postprocessing.py:224``).
"""

from __future__ import annotations

import time

import numpy as np

from orbitanalysis_tpu.engine.io_hdf5 import apsis_tag, h5file


def _match_order(a, b):
    """Indices into ``a`` of the values of ``b`` (all assumed present),
    in b's order — the reference's ``myin1d`` (``utils.py:4-11``), done as
    a single sort + binary search."""
    order = np.argsort(a, kind="stable")
    pos = np.searchsorted(a, b, sorter=order)
    return order[pos]


class Apsides:
    """Index and collate a tracking savefile (``postprocessing.py:8-28``)."""

    def __init__(self, filename):
        self.filename = filename
        with h5file(filename, "r") as hf:
            # sort numerically, not lexicographically: %03d group names
            # widen to 4+ digits at snapshot 1000+
            self.snapshot_numbers = np.sort(np.array(
                [
                    int(k.split("_")[1])
                    for k in hf.keys()
                    if k.startswith("snapshot_")
                ]
            ))
            final_key = "snapshot_%03d" % self.snapshot_numbers[-1]
            self.final_halo_ids = hf[final_key]["halo_IDs"][:]
            self.mode = hf.attrs["mode"]
            if isinstance(self.mode, bytes):
                self.mode = self.mode.decode()
            if "box_size" in hf.attrs:
                self.box_size = hf.attrs["box_size"]

    @property
    def _tag(self):
        return apsis_tag(self.mode)

    def collate_apsides(
        self,
        halo_ids=None,
        snapshot_number=None,
        angle_cut=np.pi / 4,
        save_final_counts=False,
        data_type=None,
        savefile=None,
        verbose=True,
        device=False,
    ):
        """Accumulate apsis IDs per halo across snapshots (with the
        subhalo-rejecting ``angle_cut``, ``postprocessing.py:121-128``) and
        write per-snapshot unique-ID + orbit-count catalogs
        (``postprocessing.py:133-162``).

        ``device=True`` runs the accumulation on the JAX device: one
        (halo, id) sort of all filtered events, then per-snapshot
        segment-sum increments keep the cumulative unique-ID counts
        resident — replacing the host path's per-halo ``np.append`` +
        ``np.unique`` per snapshot, whose cost grows quadratically with
        the accumulated catalog (full-box scale).  Output is identical.
        """
        t_start = time.time()

        if halo_ids is None:
            halo_ids = self.final_halo_ids
        else:
            halo_ids = np.asarray(halo_ids)
            missing = np.setdiff1d(halo_ids, self.final_halo_ids)
            if len(missing):
                self.missing_halo_ids = missing
                raise ValueError(
                    "The input halo ID list contains IDs of halos (at z=0) "
                    "that have not been processed."
                )

        if snapshot_number is None:
            sind = len(self.snapshot_numbers) - 1
        else:
            sind = int(
                np.argwhere(self.snapshot_numbers == snapshot_number).flatten()[0]
            )

        if device:
            self._collate_apsides_device(
                halo_ids, sind, angle_cut, data_type, savefile, verbose
            )
            if save_final_counts:
                self.save_final_apsis_counts(savefile, verbose=verbose)
            if verbose:
                print(
                    "{}s collated in {} s".format(
                        self._tag, round(time.time() - t_start, 3)
                    )
                )
            return

        n_req = len(halo_ids)
        accumulated = [None] * n_req  # lazily-typed per-halo ID accumulators

        for s in self.snapshot_numbers[: sind + 1]:
            with h5file(self.filename, "r") as hf:
                g = hf["snapshot_%03d" % s]
                region_positions = g["region_positions"][:]
                region_radii = g["region_radii"][:]
                bulk_velocities = g["bulk_velocities"][:]
                halo_ids_current = g["halo_IDs"][:]
                if s != self.snapshot_numbers[-1]:
                    halo_ids_final = g["final_descendant_IDs"][:]
                else:
                    halo_ids_final = halo_ids_current

                apsis_ids = g[self._tag + "_IDs"][:]
                angles = g["angles"][:]
                offsets = g["region_offsets"][:]

            if len(apsis_ids) == 0:
                continue
            if data_type is None:
                orbtype = apsis_ids.dtype
            else:
                orbtype = data_type
            for k in range(n_req):
                if accumulated[k] is None:
                    accumulated[k] = np.array([], dtype=orbtype)

            # requested halos present at this snapshot, in requested order
            present = np.isin(halo_ids, halo_ids_final)
            req_inds = np.where(present)[0]
            file_inds = _match_order(halo_ids_final, halo_ids[req_inds])

            for k, fi in zip(req_inds, file_inds):
                sl = slice(offsets[fi], offsets[fi + 1])
                ids_h = apsis_ids[sl]
                ang_h = angles[sl]
                accumulated[k] = np.append(
                    accumulated[k], ids_h[ang_h > angle_cut]
                )

            ids_unique, counts, lens = [], [], []
            for k in req_inds:
                u, c = np.unique(accumulated[k], return_counts=True)
                ids_unique.append(u)
                counts.append(c)
                lens.append(len(u))
            ids_unique = (
                np.concatenate(ids_unique) if ids_unique else
                np.array([], dtype=orbtype)
            )
            counts = (
                np.concatenate(counts) if counts else np.array([], dtype=np.int64)
            )
            halo_offsets = np.cumsum([0] + lens)[:-1]

            with h5file(savefile, "a") as hf:
                g = hf.create_group("snapshot_%03d" % s)
                g.create_dataset("particle_IDs", data=ids_unique)
                g.create_dataset(self._tag + "_counts", data=counts)
                g.create_dataset("halo_offsets", data=halo_offsets)
                if s != self.snapshot_numbers[-1]:
                    g.create_dataset(
                        "final_descendant_IDs", data=halo_ids_final[file_inds]
                    )
                g.create_dataset("halo_IDs", data=halo_ids_current[file_inds])
                g.create_dataset(
                    "halo_positions", data=region_positions[file_inds]
                )
                g.create_dataset(
                    "halo_velocities", data=bulk_velocities[file_inds]
                )
                g.create_dataset("region_radii", data=region_radii[file_inds])

            if verbose:
                print("Snapshot {} collated".format("%03d" % s))

        if save_final_counts:
            self.save_final_apsis_counts(savefile, verbose=verbose)

        if verbose:
            print(
                "{}s collated in {} s".format(
                    self._tag, round(time.time() - t_start, 3)
                )
            )

    def _collate_apsides_device(
        self, halo_ids, sind, angle_cut, data_type, savefile, verbose
    ):
        """Device-side collation core (see ``collate_apsides``).

        Pass 1 stages every filtered apsis event as flat ``(halo-index,
        particle-id, snapshot-index)`` arrays; the device then sorts by
        ``(halo, id)`` once and a per-snapshot ``segment_sum`` over the
        unique-pair segments maintains the cumulative counts.  The host
        only trims and writes each snapshot's catalog.
        """
        import functools

        import jax
        import jax.numpy as jnp

        n_req = len(halo_ids)
        snaps = self.snapshot_numbers[: sind + 1]
        final_snap = self.snapshot_numbers[-1]

        metas = []
        ev_id, ev_k, ev_s = [], [], []
        orbtype = None
        for si, s in enumerate(snaps):
            with h5file(self.filename, "r") as hf:
                g = hf["snapshot_%03d" % s]
                meta = dict(
                    s=s,
                    si=si,
                    region_positions=g["region_positions"][:],
                    region_radii=g["region_radii"][:],
                    bulk_velocities=g["bulk_velocities"][:],
                    halo_ids_current=g["halo_IDs"][:],
                )
                halo_ids_final = (
                    g["final_descendant_IDs"][:]
                    if s != final_snap
                    else meta["halo_ids_current"]
                )
                apsis_ids = g[self._tag + "_IDs"][:]
                angles = g["angles"][:]
                offsets = g["region_offsets"][:]
            if len(apsis_ids) and orbtype is None:
                orbtype = (
                    apsis_ids.dtype if data_type is None
                    else np.dtype(data_type)
                )
            present = np.isin(halo_ids, halo_ids_final)
            req_inds = np.where(present)[0]
            file_inds = _match_order(halo_ids_final, halo_ids[req_inds])
            meta.update(
                halo_ids_final=halo_ids_final,
                req_inds=req_inds,
                file_inds=file_inds,
                has_events=len(apsis_ids) > 0,
            )
            metas.append(meta)
            if len(apsis_ids) == 0:
                continue
            # vectorized pass 1 (round-2 review item 7): bucket every
            # event to its file halo via the offsets CSR, map file
            # halos to requested indices with an inverse table, and
            # filter by angle cut — three array ops per snapshot
            # instead of a Python loop over (halo, snapshot)
            lengths = np.diff(offsets)
            ev_file_ind = np.repeat(np.arange(len(lengths)), lengths)
            inv = np.full(len(lengths), -1, np.int32)
            inv[file_inds] = req_inds.astype(np.int32)
            ev_req = inv[ev_file_ind]
            keep = (ev_req >= 0) & (angles > angle_cut)
            if keep.any():
                ev_id.append(apsis_ids[keep].astype(np.int64))
                ev_k.append(ev_req[keep])
                ev_s.append(np.full(int(keep.sum()), si, np.int32))

        if ev_id:
            k_j, id_j, s_j = jax.lax.sort(
                (
                    jnp.asarray(np.concatenate(ev_k)),
                    jnp.asarray(np.concatenate(ev_id)),
                    jnp.asarray(np.concatenate(ev_s)),
                ),
                num_keys=2,
            )
            first = jnp.concatenate(
                [
                    jnp.ones(1, bool),
                    (k_j[1:] != k_j[:-1]) | (id_j[1:] != id_j[:-1]),
                ]
            )
            uidx = jnp.cumsum(first.astype(jnp.int32)) - 1
            first_h = np.asarray(first)
            k_u = np.asarray(k_j)[first_h]
            id_u = np.asarray(id_j)[first_h]
            n_unique = len(k_u)

            @functools.partial(jax.jit, static_argnames=("num",))
            def incr(counts, si, s_arr, uidx_arr, num):
                hit = (s_arr == si).astype(counts.dtype)
                return counts + jax.ops.segment_sum(
                    hit, uidx_arr, num_segments=num
                )

            counts_dev = jnp.zeros(n_unique, jnp.int32)
        else:
            k_u = np.zeros(0, np.int32)
            id_u = np.zeros(0, np.int64)
            counts_dev = None
        if orbtype is None:
            orbtype = id_u.dtype

        for meta in metas:
            if not meta["has_events"]:
                continue
            if counts_dev is not None:
                counts_dev = incr(
                    counts_dev, meta["si"], s_j, uidx, n_unique
                )
                counts_h = np.asarray(counts_dev)
            else:
                counts_h = np.zeros(0, np.int32)
            req_inds = meta["req_inds"]
            sel = counts_h > 0
            in_req = sel & np.isin(k_u, req_inds)
            ids_unique = id_u[in_req].astype(orbtype)
            counts_sel = counts_h[in_req].astype(np.int64)
            lens = np.bincount(k_u[in_req], minlength=n_req)[req_inds]
            halo_offsets = np.cumsum([0] + list(lens))[:-1]

            with h5file(savefile, "a") as hf:
                g = hf.create_group("snapshot_%03d" % meta["s"])
                g.create_dataset("particle_IDs", data=ids_unique)
                g.create_dataset(self._tag + "_counts", data=counts_sel)
                g.create_dataset("halo_offsets", data=halo_offsets)
                if meta["s"] != final_snap:
                    g.create_dataset(
                        "final_descendant_IDs",
                        data=meta["halo_ids_final"][meta["file_inds"]],
                    )
                g.create_dataset(
                    "halo_IDs",
                    data=meta["halo_ids_current"][meta["file_inds"]],
                )
                g.create_dataset(
                    "halo_positions",
                    data=meta["region_positions"][meta["file_inds"]],
                )
                g.create_dataset(
                    "halo_velocities",
                    data=meta["bulk_velocities"][meta["file_inds"]],
                )
                g.create_dataset(
                    "region_radii",
                    data=meta["region_radii"][meta["file_inds"]],
                )
            if verbose:
                print("Snapshot {} collated".format("%03d" % meta["s"]))

    def save_final_apsis_counts(
        self, collated_file, snapshot_numbers=None, verbose=True
    ):
        """Retroactively attach each particle's *final* orbit count to every
        earlier snapshot's catalog (``postprocessing.py:176-240``)."""
        with h5file(collated_file, "r+") as hf:
            nums_all = np.sort(np.array(
                [int(k.split("_")[-1]) for k in hf.keys()]
            ))
            skeys = np.array(["snapshot_%03d" % n for n in nums_all])
            gfin = hf[skeys[-1]]
            ids_final = gfin["particle_IDs"][:]
            counts_final = gfin[self._tag + "_counts"][:]
            # match in z=0 descendant space: when the collation stopped
            # mid-sequence the last group's halo_IDs are snapshot-local
            # progenitor IDs, but its final_descendant_IDs dataset (only
            # absent on the true final snapshot) gives the z=0 space the
            # earlier groups' final_descendant_IDs live in
            halo_ids = (
                gfin["final_descendant_IDs"][:]
                if "final_descendant_IDs" in gfin
                else gfin["halo_IDs"][:]
            )
            offsets_final = np.concatenate(
                (gfin["halo_offsets"][:], [len(ids_final)])
            )

            if snapshot_numbers is None:
                skeys_ = skeys[:-1]
            else:
                nums = np.array([int(k.split("_")[-1]) for k in skeys])
                skeys_ = skeys[np.isin(nums, snapshot_numbers)]

            for skey in skeys_:
                g = hf[skey]
                ids = g["particle_IDs"][:]
                desc_ids = g["final_descendant_IDs"][:]
                offsets = np.concatenate((g["halo_offsets"][:], [len(ids)]))
                hinds = _match_order(halo_ids, desc_ids)

                counts_retro = np.zeros(len(ids), dtype=counts_final.dtype)
                for h2, h1 in enumerate(hinds):
                    fsl = slice(offsets_final[h1], offsets_final[h1 + 1])
                    sl = slice(offsets[h2], offsets[h2 + 1])
                    fidx = _match_order(ids_final[fsl], ids[sl])
                    counts_retro[sl] = counts_final[fsl][fidx]

                g.create_dataset(self._tag + "_counts_final", data=counts_retro)
                if verbose:
                    print("Final counts saved for {} {}".format(*skey.split("_")))


class OrbitDecomposition:
    """Per-halo orbit decomposition with plotting.

    The working implementation of the API consumed by the reference's
    ``example_script.py:76-95``: collate one halo's apsis events up to a
    snapshot, attach orbit counts to the particles of a supplied snapshot
    region, and visualize in position and phase space.
    """

    def __init__(self, filename):
        self.filename = filename
        self.apsides = Apsides(filename)
        self.mode = self.apsides.mode
        # set by get_halo_decomposition_at_snapshot:
        self.particle_ids = None
        self.counts = None
        self.coordinates = None
        self.velocities = None
        self.radii = None
        self.radial_velocities = None
        self.region_radius = None
        self.halo_position = None
        self.halo_velocity = None

    @property
    def _tag(self):
        return apsis_tag(self.mode)

    def get_halo_decomposition_at_snapshot(
        self,
        halo_id,
        snapshot_number=None,
        snapshot_data=None,
        angle_cut=np.pi / 4,
    ):
        """Collate apsis counts for ``halo_id`` at ``snapshot_number``.

        If ``snapshot_data`` (the loader dict for this halo's region) is
        given, orbit counts are matched onto its particles — particles
        with no recorded apsis get count 0 — and region-frame radii and
        radial velocities are computed for phase-space plotting.
        """
        snaps = self.apsides.snapshot_numbers
        if snapshot_number is None:
            snapshot_number = snaps[-1]
        sind = int(np.argwhere(snaps == snapshot_number).flatten()[0])

        acc = []
        with h5file(self.filename, "r") as hf:
            for s in snaps[: sind + 1]:
                g = hf["snapshot_%03d" % s]
                hids_final = (
                    g["final_descendant_IDs"][:]
                    if s != snaps[-1]
                    else g["halo_IDs"][:]
                )
                loc = np.argwhere(hids_final == halo_id).flatten()
                if len(loc) == 0:
                    continue
                fi = int(loc[0])
                offsets = g["region_offsets"][:]
                sl = slice(offsets[fi], offsets[fi + 1])
                ids_h = g[self._tag + "_IDs"][sl]
                ang_h = g["angles"][sl]
                acc.append(ids_h[ang_h > angle_cut])

            g = hf["snapshot_%03d" % snapshot_number]
            hids_final = (
                g["final_descendant_IDs"][:]
                if snapshot_number != snaps[-1]
                else g["halo_IDs"][:]
            )
            fi = int(np.argwhere(hids_final == halo_id).flatten()[0])
            self.halo_position = g["region_positions"][fi]
            self.halo_velocity = g["bulk_velocities"][fi]
            self.region_radius = g["region_radii"][fi]
            box_size = hf.attrs.get("box_size")

        acc = (
            np.concatenate(acc) if acc else np.array([], dtype=np.int64)
        )
        ids_u, counts = np.unique(acc, return_counts=True)
        self.particle_ids = ids_u
        self.counts = counts

        if snapshot_data is not None:
            ids = np.asarray(snapshot_data["ids"])
            counts_all = np.zeros(len(ids), dtype=np.int64)
            present = np.isin(ids, ids_u)
            counts_all[present] = counts[_match_order(ids_u, ids[present])]
            self.particle_ids = ids
            self.counts = counts_all

            pos = np.asarray(snapshot_data["coordinates"], dtype=np.float64)
            vel = np.asarray(snapshot_data["velocities"], dtype=np.float64)
            rel = pos - self.halo_position
            if box_size is not None:
                # pure-NumPy minimum image: keeps the float64 precision
                # this method deliberately casts to (a JAX round-trip
                # would downcast to f32 with x64 disabled)
                rel = rel - box_size * np.round(rel / box_size)
            vrel = vel - self.halo_velocity
            r = np.sqrt((rel**2).sum(-1))
            with np.errstate(invalid="ignore"):
                rhat = np.where(
                    r[:, None] > 0, rel / np.maximum(r, 1e-300)[:, None], 0.0
                )
            self.coordinates = rel
            self.velocities = vrel
            self.radii = r
            self.radial_velocities = (vrel * rhat).sum(-1)
        return self

    def _select_counts(self, counts_to_plot):
        if counts_to_plot == "all":
            return np.unique(self.counts)
        return np.atleast_1d(np.asarray(counts_to_plot))

    def plot_position_space(
        self,
        projection="xy",
        colormap="rainbow_r",
        counts_to_plot="all",
        xlabel=None,
        ylabel=None,
        display=False,
        savefile=None,
        point_size=1.0,
    ):
        """Scatter the halo's particles in a 2D projection, colored by
        orbit count (the plot intended by ``example_script.py:88-91``)."""
        import matplotlib
        if not display:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self.coordinates is None:
            raise RuntimeError(
                "call get_halo_decomposition_at_snapshot(..., snapshot_data=...) first"
            )
        axes = {"x": 0, "y": 1, "z": 2}
        ax0, ax1 = axes[projection[0]], axes[projection[1]]
        scale = self.region_radius
        cvals = self._select_counts(counts_to_plot)

        fig, ax = plt.subplots(figsize=(6, 6))
        cmap = plt.get_cmap(colormap)
        for k, c in enumerate(cvals):
            sel = self.counts == c
            ax.scatter(
                self.coordinates[sel, ax0] / scale,
                self.coordinates[sel, ax1] / scale,
                s=point_size,
                color=cmap(k / max(len(cvals) - 1, 1)),
                label=f"n={c}",
            )
        ax.set_xlabel(xlabel or f"${projection[0]}/R$")
        ax.set_ylabel(ylabel or f"${projection[1]}/R$")
        ax.set_aspect("equal")
        ax.legend(markerscale=8, fontsize=8, loc="upper right")
        if savefile:
            fig.savefig(savefile, dpi=150, bbox_inches="tight")
        if display:
            plt.show()
        else:
            plt.close(fig)
        return fig

    def plot_phase_space(
        self,
        colormap="rainbow_r",
        counts_to_plot="all",
        radius_label=None,
        radial_velocity_label=None,
        logr=False,
        display=False,
        savefile=None,
        point_size=1.0,
    ):
        """r – v_r phase-space scatter colored by orbit count
        (``example_script.py:92-95``)."""
        import matplotlib
        if not display:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self.radii is None:
            raise RuntimeError(
                "call get_halo_decomposition_at_snapshot(..., snapshot_data=...) first"
            )
        cvals = self._select_counts(counts_to_plot)
        fig, ax = plt.subplots(figsize=(7, 5))
        cmap = plt.get_cmap(colormap)
        r = self.radii / self.region_radius
        for k, c in enumerate(cvals):
            sel = self.counts == c
            ax.scatter(
                r[sel],
                self.radial_velocities[sel],
                s=point_size,
                color=cmap(k / max(len(cvals) - 1, 1)),
                label=f"n={c}",
            )
        if logr:
            ax.set_xscale("log")
        ax.set_xlabel(radius_label or "$r/R$")
        ax.set_ylabel(radial_velocity_label or "$v_r$")
        ax.legend(markerscale=8, fontsize=8, loc="upper right")
        if savefile:
            fig.savefig(savefile, dpi=150, bbox_inches="tight")
        if display:
            plt.show()
        else:
            plt.close(fig)
        return fig
