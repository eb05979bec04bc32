"""Distributed particle-mesh Poisson solve: pencil-decomposed FFT.

Scales the PM force grid past one chip's HBM (1024^3 f32 force fields are
~13 GB; BASELINE configs [2]/[4] at full box).  The classic slab/pencil
scheme, expressed with ``shard_map`` + ``all_to_all`` over ICI:

  rho [X, Y, Z] sharded on X
    -> local rFFT over (Y, Z)                     (no communication)
    -> all_to_all: gather X, scatter Y            (one ICI collective)
    -> local FFT over X                           (now spectral in all axes)
    -> Green's function x i*k gradient (3 components)
    -> local iFFT over X
    -> all_to_all back: gather Y, scatter X
    -> local irFFT over (Y, Z)

The k-space multiply needs each shard's Y-offset, obtained from
``jax.lax.axis_index`` inside the mapped function.  Deposit and
interpolation stay host/local (they are O(N) and particle-sharded
separately); this module distributes the O(G^3 log G) solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orbitanalysis_tpu.models.pm import gradient_wavenumbers

try:  # moved out of experimental in newer jax (no check_rep kwarg)
    from jax import shard_map
    _SHARD_MAP_KW = {}
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
    _SHARD_MAP_KW = {"check_rep": False}


def make_sharded_pm_grid_solver(
    mesh: Mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    smoothing_cells: float | None = None,
):
    """Build ``solve(rho, box_size, G) -> force [3, G, G, G]`` with the
    FFT pipeline sharded over ``mesh``'s ``axis``.

    ``grid`` must be divisible by the axis size.  Input ``rho`` is
    ``[G, G, G]`` sharded on its first dimension (a replicated array is
    resharded automatically); outputs are sharded the same way.
    """
    n_dev = int(mesh.shape[axis])
    if grid % n_dev != 0:
        raise ValueError(f"grid {grid} not divisible by mesh axis {n_dev}")
    loc = grid // n_dev

    # spectral coordinates (cell units)
    kx_full = 2 * np.pi * np.fft.fftfreq(grid)
    ky_full = 2 * np.pi * np.fft.fftfreq(grid)
    kz_full = 2 * np.pi * np.fft.rfftfreq(grid)
    dx_full, dy_full, dz_full = (
        k.reshape(-1) for k in gradient_wavenumbers(grid))

    def local_solve(rho_l, box_size):
        """rho_l: [loc, G, Z->...] one X-slab; returns 3 force slabs."""
        i = jax.lax.axis_index(axis)
        h = box_size / grid

        rk = jnp.fft.rfftn(rho_l, axes=(1, 2))          # [loc, G, Z]
        # pencil transpose: X gathered, Y scattered -> [G, loc, Z]
        rk = jax.lax.all_to_all(
            rk, axis, split_axis=1, concat_axis=0, tiled=True
        )
        rk = jnp.fft.fft(rk, axis=0)                     # spectral in X

        kx = jnp.asarray(kx_full, jnp.float32)[:, None, None]
        ky_l = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(ky_full, jnp.float32), i * loc, loc
        )[None, :, None]
        kz = jnp.asarray(kz_full, jnp.float32)[None, None, :]
        k2 = kx * kx + ky_l * ky_l + kz * kz
        # gradient wavenumbers: zero on the Nyquist planes, as in
        # models.pm.gradient_wavenumbers
        dkx = jnp.asarray(dx_full, jnp.float32)[:, None, None]
        dky_l = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(dy_full, jnp.float32), i * loc, loc
        )[None, :, None]
        dkz = jnp.asarray(dz_full, jnp.float32)[None, None, :]

        green = jnp.where(
            k2 > 0, -4 * jnp.pi / jnp.maximum(k2, 1e-30), 0.0
        ) / h
        if smoothing_cells is not None:
            # Gaussian-split long range (P3M): sigma in cell units, so
            # k (cell units) * sigma_cells == k_phys * sigma_phys
            green = green * jnp.exp(
                -k2 * float(smoothing_cells) ** 2 / 2.0
            )
        if deconvolve:
            sinc = lambda t: jnp.sinc(t / (2 * jnp.pi))  # noqa: E731
            w = (sinc(kx) * sinc(ky_l) * sinc(kz)) ** 2
            green = green / jnp.maximum(w, 1e-4) ** 2
        phi_k = green.astype(jnp.complex64) * rk

        outs = []
        for kvec in (dkx, dky_l, dkz):
            fk = (-1j * kvec / h).astype(jnp.complex64) * phi_k
            fk = jnp.fft.ifft(fk, axis=0)                # back from X
            fk = jax.lax.all_to_all(
                fk, axis, split_axis=0, concat_axis=1, tiled=True
            )                                            # -> [loc, G, Z]
            outs.append(
                jnp.fft.irfftn(fk, s=(grid, grid), axes=(1, 2))
            )
        return jnp.stack(outs)                           # [3, loc, G, G]

    mapped = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(None, axis),
        **_SHARD_MAP_KW,
    )

    def solve(rho, box_size, G=1.0):
        rho = jax.device_put(rho, NamedSharding(mesh, P(axis)))
        out = mapped(rho.astype(jnp.float32),
                     jnp.asarray(box_size, jnp.float32))
        return G * out

    solve.local_solve = local_solve  # shared by the full force path
    solve.slab = loc
    return solve


def _cic_neighbors_slab(pos, grid, box_size, x0, loc):
    """CIC neighbors against an X-slab ``[x0, x0+loc)`` with one halo
    plane: local x index in ``[0, loc]`` (``loc`` = the halo), y/z
    periodic.  Callers guarantee each particle's base cell lies in the
    slab (they were routed by owner); anything else lands out of bounds
    and is dropped by the scatter/gather mode."""
    h = box_size / grid
    x = pos / h - 0.5
    i0 = jnp.floor(x)
    f = x - i0
    i0 = i0.astype(jnp.int32)
    ix0 = jnp.mod(i0[:, 0], grid) - x0          # [0, loc) for routed
    idxs, ws = [], []
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - f[:, 0], f[:, 0])
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - f[:, 1], f[:, 1])
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - f[:, 2], f[:, 2])
                idxs.append(jnp.stack([
                    ix0 + dx,                    # may be loc (halo plane)
                    jnp.mod(i0[:, 1] + dy, grid),
                    jnp.mod(i0[:, 2] + dz, grid),
                ], axis=-1))
                ws.append(wx * wy * wz)
    return jnp.stack(idxs), jnp.stack(ws)


def make_slab_resident_pm_force_fn(
    mesh: Mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    bucket_factor: float = 4.0,
    p3m_sigma_cells: float | None = None,
    p3m_cutoff_sigmas: float = 3.5,
    p3m_cell_factor: float = 4.0,
    assignment: str = "auto",
):
    """Fully grid-resident distributed PM: per-device memory is
    ``O(grid^3 / n_dev)`` — the configuration for 1024^3-2048^3 meshes
    that cannot be materialized on one card (a 2048^3 f32 field with its
    FFT workspace outgrows one 80 GB card).

    Pipeline inside one ``shard_map`` over ``axis``:

      1. each device computes its particles' owner slab and routes them
         with one fixed-capacity ``all_to_all`` (sort by owner, scatter
         into ``[n_dev, cap]`` buckets, zero-mass padding);
      2. CIC deposit onto the local X-slab ``[loc+1, G, G]`` (one halo
         plane), halo summed into the +1 neighbor via ``ppermute``;
      3. pencil FFT solve on the slab (``local_solve``) — the only
         O(G^3)-work stage, already distributed;
      4. the neighbor's first force plane is fetched via ``ppermute``
         (reverse direction) so interpolation sees ``[3, loc+1, G, G]``;
      5. forces ride the ``all_to_all`` back and are unsorted to the
         original particle order.

    ``bucket_factor`` scales the per-destination bucket capacity
    ``cap = bucket_factor * n_local / n_dev`` (rounded up to 128).
    Particles overflowing a bucket are dropped from the solve and
    receive **NaN** force (fail-loud: the NaN reaches their positions
    on the next integrator step) — size buckets generously for
    clustered configurations, checking with ``slab_occupancy(pos)``
    which returns the per-slab particle counts for a chosen factor.

    ``p3m_sigma_cells`` switches the solver to distributed **P3M**
    (pass ``deconvolve=True`` with it — see
    :func:`orbitanalysis_tpu.models.p3m.make_p3m_force_fn`): the PM
    long range is Gaussian-smoothed and the erfc short-range pair
    correction is computed on a slab-local cell grid whose boundary
    cell planes are exchanged via ``ppermute`` — per-device memory and
    pair work both stay ``O(1/n_dev)``.  Each device's slab must be at
    least one cutoff wide (``box / n_dev >= cutoff_sigmas * sigma``).
    """
    from orbitanalysis_tpu.models.pm import (  # noqa: F401 (doc xref)
        _CORNERS,
        _use_rows,
        cic_deposit,
        folded_row_interpolate,
    )

    rows_interp = _use_rows(assignment)

    solver = make_sharded_pm_grid_solver(
        mesh, grid, axis=axis, deconvolve=deconvolve,
        smoothing_cells=p3m_sigma_cells,
    )
    loc = solver.slab
    n_dev = int(mesh.shape[axis])

    def local_force(pos_l, mass_l, box_size, softening):
        i = jax.lax.axis_index(axis)
        n_l = pos_l.shape[0]
        cap = max(128, int(np.ceil(bucket_factor * n_l / n_dev / 128)) * 128)
        h = box_size / grid

        # ---- 1. route particles to their slab owner ----
        cell_x = jnp.mod(
            jnp.floor(pos_l[:, 0] / h - 0.5).astype(jnp.int32), grid
        )
        owner = cell_x // loc                               # [n_l]
        srt = jax.lax.sort(
            (owner, pos_l[:, 0], pos_l[:, 1], pos_l[:, 2], mass_l,
             jnp.arange(n_l, dtype=jnp.int32)),
            dimension=0, num_keys=1,
        )
        owner_s, px, py, pz, m_s, idx_s = srt
        counts = jnp.zeros(n_dev, jnp.int32).at[owner_s].add(
            1, mode="drop"
        )
        starts = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
        )
        rank = jnp.arange(n_l, dtype=jnp.int32) - starts[owner_s]
        slot = owner_s * cap + rank                          # target bucket
        ok = rank < cap                                      # overflow drop
        slot = jnp.where(ok, slot, n_dev * cap)              # OOB -> dropped

        def to_buckets(v, fill=0.0):
            return jnp.full(n_dev * cap, fill, v.dtype).at[slot].set(
                v, mode="drop"
            )

        bx, by, bz = to_buckets(px), to_buckets(py), to_buckets(pz)
        bm = to_buckets(m_s)                                  # pad mass = 0
        # exchange: segment j of the local buffer -> device j
        bx, by, bz, bm = (
            jax.lax.all_to_all(
                v.reshape(n_dev, cap), axis, split_axis=0, concat_axis=0,
                tiled=True,
            ).reshape(n_dev * cap)
            for v in (bx, by, bz, bm)
        )
        pos_r = jnp.stack([bx, by, bz], axis=-1)             # routed

        # ---- 2. slab deposit with one halo plane ----
        idx, w = _cic_neighbors_slab(pos_r, grid, box_size, i * loc, loc)
        rho_ext = jnp.zeros((loc + 1, grid, grid), jnp.float32)
        flat = (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2]
        rho_ext = rho_ext.reshape(-1).at[flat.reshape(-1)].add(
            (w * bm[None, :]).reshape(-1), mode="drop"
        ).reshape(loc + 1, grid, grid)
        halo = jax.lax.ppermute(
            rho_ext[loc], axis,
            [(d, (d + 1) % n_dev) for d in range(n_dev)],
        )
        rho_slab = rho_ext[:loc].at[0].add(halo)

        # ---- 3. pencil FFT solve on the slab ----
        force_slab = solver.local_solve(rho_slab, box_size)  # [3, loc, G, G]

        # ---- 4. extend with the neighbor's first plane, interpolate ----
        nxt = jax.lax.ppermute(
            force_slab[:, 0], axis,
            [(d, (d - 1) % n_dev) for d in range(n_dev)],
        )
        field_ext = jnp.concatenate(
            [force_slab, nxt[:, None]], axis=1
        )                                                    # [3, loc+1, G, G]
        if rows_interp:
            # folded corner-table row gather over the LOCAL slab (one
            # gather per particle instead of 24 — see models/pm.py):
            # corner (dx, dy, dz)'s value at local cell (lx, y, z)
            # lives at field_ext[comp, lx+dx, y+dy, z+dz]; y/z rolls
            # are box-periodic, the x shift reads the halo plane.
            n_loc_cells = loc * grid * grid
            fold = 16
            while n_loc_cells % fold:
                fold //= 2
            table = jnp.zeros(
                (n_loc_cells // fold, 24 * fold), jnp.float32
            )
            for comp in range(3):
                for ci, (dx, dy, dz) in enumerate(_CORNERS):
                    col = jnp.roll(
                        field_ext[comp], (-dy, -dz), axis=(1, 2)
                    )[dx:loc + dx].reshape(n_loc_cells // fold, fold)
                    table = jax.lax.dynamic_update_slice(
                        table, col, (0, (comp * 8 + ci) * fold)
                    )
            # flat[0] is exactly each particle's base local cell (the
            # dx=dy=dz=0 corner); out-of-slab lanes (bucket padding,
            # overflow) clamp in the gather — finite garbage in lanes
            # the return path masks (ok / NaN) anyway, where the
            # scalar path produced masked zeros
            acc_r = folded_row_interpolate(
                table, flat[0], w.T, fold
            )                                                # [n_dev*cap, 3]
        else:
            fflat = field_ext.reshape(3, -1)
            acc_r = []
            for c in range(3):
                vals = jnp.take(
                    fflat[c], flat, mode="fill", fill_value=0.0
                )
                acc_r.append(jnp.sum(vals * w, axis=0))
            acc_r = jnp.stack(acc_r, axis=-1)                # [n_dev*cap, 3]

        if p3m_sigma_cells is not None:
            # ---- P3M short range on a slab-local cell grid ----
            from orbitanalysis_tpu.models.p3m import short_range_pair_block

            sigma = p3m_sigma_cells * h
            r_cut = p3m_cutoff_sigmas * sigma
            nr = n_dev * cap
            # global SR cell count: divisible by n_dev, cell >= r_cut.
            # STATIC shapes require a static c_dims: bound r_cut by the
            # worst case over traced box... box_size is traced, so pick
            # c_dims from the PM geometry instead: cells of `sr_cells`
            # PM cells each.
            sr_cells = int(np.ceil(p3m_cutoff_sigmas * p3m_sigma_cells))
            c_dims = grid // sr_cells
            c_dims = max(n_dev, (c_dims // n_dev) * n_dev)
            if grid / c_dims < p3m_cutoff_sigmas * p3m_sigma_cells:
                raise ValueError(
                    f"P3M cell grid {c_dims} too fine for the cutoff "
                    f"({p3m_cutoff_sigmas}x{p3m_sigma_cells} PM cells) "
                    f"with {n_dev} devices; reduce devices or sigma"
                )
            c_loc = c_dims // n_dev
            mean = nr / (c_loc * c_dims * c_dims)
            cap_sr = max(8, int(np.ceil(p3m_cell_factor * mean / 8)) * 8)

            # slab-aligned binning: the x bin derives from the EXACT
            # routing formula (same floor/mod arithmetic), so every
            # routed real particle is guaranteed local — a separate
            # float path would disagree at slab boundaries.  SR x-cells
            # are sr_cells PM cells wide (the slab's last one absorbs
            # any remainder: larger is fine, every cell stays >= r_cut).
            pm_cell = jnp.mod(
                jnp.floor(bx / h - 0.5).astype(jnp.int32), grid
            )
            local_pm = pm_cell - i * loc
            lx = jnp.minimum(local_pm // sr_cells, c_loc - 1)
            gy = jnp.minimum(
                (by / box_size * c_dims).astype(jnp.int32), c_dims - 1
            )
            gz = jnp.minimum(
                (bz / box_size * c_dims).astype(jnp.int32), c_dims - 1
            )
            lcid = (lx * c_dims + gy) * c_dims + gz
            # zero-mass entries (bucket padding, and the documented
            # zero-mass count-padding convention) are excluded from the
            # short range: they would otherwise flood one cell's
            # capacity; they receive the long-range force only
            in_slab = (local_pm >= 0) & (local_pm < loc) & (bm > 0)
            c3l = c_loc * c_dims * c_dims
            order_sr = jax.lax.sort(
                (jnp.where(in_slab, lcid, c3l),
                 jnp.arange(nr, dtype=jnp.int32)),
                dimension=0, num_keys=1,
            )[1]
            lcid_s = jnp.take(
                jnp.where(in_slab, lcid, c3l), order_sr, axis=0
            )
            counts_sr = jnp.zeros(c3l, jnp.int32).at[lcid_s].add(
                1, mode="drop"
            )
            starts_sr = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(counts_sr)[:-1]]
            )
            rank_sr = (
                jnp.arange(nr, dtype=jnp.int32)
                - jnp.take(starts_sr, jnp.clip(lcid_s, 0, c3l - 1))
            )
            ok_sr = (rank_sr < cap_sr) & (lcid_s < c3l)
            dest_sr = jnp.where(
                ok_sr, lcid_s * cap_sr + rank_sr, c3l * cap_sr
            )
            pos_rt = jnp.stack([bx, by, bz], axis=-1)

            def to_cells(v):
                return jnp.zeros(
                    (c3l * cap_sr,) + v.shape[1:], v.dtype
                ).at[dest_sr].set(
                    jnp.take(v, order_sr, axis=0), mode="drop"
                )

            cpos = to_cells(pos_rt).reshape(c3l, cap_sr, 3)
            cmass = to_cells(bm).reshape(c3l, cap_sr)

            # extend the slab with neighbour boundary cell planes
            gp = cpos.reshape(c_loc, c_dims, c_dims, cap_sr, 3)
            gm = cmass.reshape(c_loc, c_dims, c_dims, cap_sr)
            fwd = [(d, (d + 1) % n_dev) for d in range(n_dev)]
            bwd = [(d, (d - 1) % n_dev) for d in range(n_dev)]
            left_p = jax.lax.ppermute(gp[c_loc - 1], axis, fwd)
            left_m = jax.lax.ppermute(gm[c_loc - 1], axis, fwd)
            right_p = jax.lax.ppermute(gp[0], axis, bwd)
            right_m = jax.lax.ppermute(gm[0], axis, bwd)
            ext_p = jnp.concatenate(
                [left_p[None], gp, right_p[None]], axis=0
            )
            ext_m = jnp.concatenate(
                [left_m[None], gm, right_m[None]], axis=0
            )

            yz_offsets = sorted({
                (dy % c_dims, dz % c_dims)
                for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            })
            # x offsets dedup'd like p3m's roll offsets: for tiny global
            # cell counts the left/right halo planes alias the same
            # source cells and would double-count
            x_offsets = (
                (-1, 0, 1) if c_dims >= 3 else (0, 1) if c_dims == 2
                else (0,)
            )
            acc_sr = jnp.zeros((c3l, cap_sr, 3), jnp.float32)
            for dx in x_offsets:
                sx_p = ext_p[1 + dx: 1 + dx + c_loc]
                sx_m = ext_m[1 + dx: 1 + dx + c_loc]
                for dy, dz in yz_offsets:
                    src_p = jnp.roll(
                        sx_p, (dy, dz), axis=(1, 2)
                    ).reshape(c3l, cap_sr, 3)
                    src_m = jnp.roll(
                        sx_m, (dy, dz), axis=(1, 2)
                    ).reshape(c3l, cap_sr)
                    acc_sr = acc_sr + short_range_pair_block(
                        cpos, src_p, src_m, box_size, sigma, r_cut,
                        softening,
                    )
            acc_sr_flat = acc_sr.reshape(c3l * cap_sr, 3)
            bm_s = jnp.take(bm, order_sr, axis=0)
            sr_sorted = jnp.where(
                ok_sr[:, None],
                jnp.take(acc_sr_flat,
                         jnp.where(ok_sr, dest_sr, 0), axis=0),
                # cell overflow for a REAL particle: fail loud (NaN);
                # zero-mass padding just contributes no short range
                jnp.where(bm_s[:, None] > 0, jnp.nan, 0.0),
            )
            acc_r = acc_r + jnp.zeros((nr, 3), jnp.float32).at[
                order_sr
            ].set(sr_sorted)

        # ---- 5. route forces back, restore original order ----
        acc_b = jax.lax.all_to_all(
            acc_r.reshape(n_dev, cap, 3), axis, split_axis=0,
            concat_axis=0, tiled=True,
        ).reshape(n_dev * cap, 3)
        # overflowed particles were dropped from the solve: return NaN
        # (loud, propagates into positions immediately) rather than a
        # silently-wrong zero force
        acc_sorted = jnp.where(
            ok[:, None],
            jnp.take(acc_b, jnp.where(ok, slot, 0), axis=0, mode="fill",
                     fill_value=0.0),
            jnp.nan,
        )
        return jnp.zeros((n_l, 3), jnp.float32).at[idx_s].set(
            acc_sorted, mode="drop"
        )

    mapped = shard_map(
        local_force,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        **_SHARD_MAP_KW,
    )

    def force(pos, mass, box_size=None, G=1.0, softening=0.0, **_):
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        n = pos.shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f"particle count {n} not divisible by mesh axis {n_dev}; "
                "pad with zero-mass particles"
            )
        pos = jax.device_put(pos, NamedSharding(mesh, P(axis)))
        mass = jax.device_put(mass, NamedSharding(mesh, P(axis)))
        return G * mapped(
            pos.astype(jnp.float32), mass.astype(jnp.float32),
            jnp.asarray(box_size, jnp.float32),
            jnp.asarray(softening, jnp.float32),
        )

    def slab_occupancy(pos, box_size):
        """Per-slab particle counts (host helper for bucket sizing)."""
        h = float(box_size) / grid
        cx = np.mod(np.floor(np.asarray(pos)[:, 0] / h - 0.5), grid)
        return np.bincount(
            (cx // loc).astype(np.int64), minlength=n_dev
        )

    force.slab_occupancy = slab_occupancy
    force.slab = loc
    return force


def make_sharded_pm_force_fn(
    mesh: Mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    assignment: str = "auto",
):
    """Fully distributed PM forces: particles AND the FFT sharded over
    one mesh axis.

    Pipeline inside one ``shard_map``: each shard CIC-deposits its own
    particles onto a full local mesh, a ``psum`` combines the meshes,
    each shard solves its X-slab through the pencil FFT, the force slabs
    are ``all_gather``-ed, and each shard CIC-interpolates its own
    particles.  Per-device memory is O(grid^3) (the mesh), while the
    particle arrays stay sharded — the configuration for 1e8+ particles
    on moderate grids.

    Returns ``force(pos, mass, box_size=..., G=...)`` with ``pos``/
    ``mass`` sharded (or automatically placed) on ``axis``; particle
    count must divide the axis size.
    """
    from orbitanalysis_tpu.models.pm import (
        cic_deposit,
        select_interpolator,
    )

    cic_interpolate = select_interpolator(assignment)

    solver = make_sharded_pm_grid_solver(
        mesh, grid, axis=axis, deconvolve=deconvolve
    )
    loc = solver.slab
    n_dev = int(mesh.shape[axis])

    def local_force(pos_l, mass_l, box_size):
        i = jax.lax.axis_index(axis)
        rho = cic_deposit(pos_l, mass_l, grid, box_size)
        rho = jax.lax.psum(rho, axis)                 # full mesh, all shards
        slab = jax.lax.dynamic_slice_in_dim(rho, i * loc, loc, axis=0)
        force_slab = solver.local_solve(slab, box_size)  # [3, loc, G, G]
        field = jax.lax.all_gather(
            force_slab, axis, axis=1, tiled=True
        )                                              # [3, G, G, G]
        return cic_interpolate(field, pos_l, grid, box_size)

    mapped = shard_map(
        local_force,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=P(axis),
        **_SHARD_MAP_KW,
    )

    def force(pos, mass, box_size=None, G=1.0, **_):
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        n = pos.shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f"particle count {n} not divisible by mesh axis {n_dev}; "
                "pad with zero-mass particles"
            )
        pos = jax.device_put(pos, NamedSharding(mesh, P(axis)))
        mass = jax.device_put(mass, NamedSharding(mesh, P(axis)))
        return G * mapped(
            pos.astype(jnp.float32), mass.astype(jnp.float32),
            jnp.asarray(box_size, jnp.float32),
        )

    return force
