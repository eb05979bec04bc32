"""P3M gravity: Gaussian-split PM long range + cell-binned short range.

Plain PM force errors grow below a few mesh cells (the assignment/
interpolation window smears the source).  The classic particle-
particle-particle-mesh correction splits the potential with a Gaussian
of scale ``sigma``:

  long range   exp(-k^2 sigma^2 / 2) applied to the PM Green's function
               (``pm_forces_grid(smoothing=sigma)``) — smooth on the
               mesh scale, so the mesh resolves it accurately;
  short range  pairwise erfc-complement force, nonzero only within
               ``r_cut = cutoff_sigmas * sigma``:
               |F| = m_i m_j [ erfc(u)/r^2 + sqrt(2/pi) e^{-u^2}/(sigma r) ],
               u = r / (sqrt(2) sigma).

Short-range structure (no gathers, no neighbour lists):
particles are binned on device into a ``[C, C, C, cap]`` cell grid with
cell size >= r_cut (sort by cell id + rank scatter, zero-mass padding);
each cell then interacts with its 27 neighbour blocks obtained by
``jnp.roll`` over the cell grid — a static 27-iteration Python loop of
dense ``[cells, cap, cap]`` pair batches that XLA fuses and tiles.
Periodicity is exact: rolls wrap cells, and the minimum image is
applied per pair.

The reference package has no force solver at all (its on-the-fly mode
assumes an external simulation, ``/root/reference/orbitanalysis/
track_orbits_onthefly.py``); this module belongs to the native
integrator tier that replaces it (BASELINE configs[3]).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from orbitanalysis_tpu.models.pm import cic_deposit, pm_forces_grid, \
    select_interpolator


def _bin_particles(pos, mass, c_dims, box_size, cap):
    """Scatter particles into a padded ``[C^3, cap]`` cell layout.

    Returns ``(cell_pos [C3, cap, 3], cell_mass [C3, cap], slot
    [N] flat destination of each particle, ok [N])``.  Overflowing
    particles (rank >= cap) get ``ok=False`` and are dropped from the
    binned layout (their short-range force is NaN-flagged by the
    caller).
    """
    n = pos.shape[0]
    c3 = c_dims ** 3
    cell = box_size / c_dims
    idx = jnp.clip(
        jnp.floor(pos / cell).astype(jnp.int32), 0, c_dims - 1
    )
    cid = (idx[:, 0] * c_dims + idx[:, 1]) * c_dims + idx[:, 2]
    order = jnp.argsort(cid)
    cid_s = cid[order]
    counts = jnp.zeros(c3, jnp.int32).at[cid_s].add(1)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cid_s]
    ok_s = rank < cap
    dest_s = jnp.where(ok_s, cid_s * cap + rank, c3 * cap)
    cell_pos = jnp.zeros((c3 * cap, 3), pos.dtype).at[dest_s].set(
        pos[order], mode="drop"
    ).reshape(c3, cap, 3)
    cell_mass = jnp.zeros((c3 * cap,), mass.dtype).at[dest_s].set(
        mass[order], mode="drop"
    ).reshape(c3, cap)
    # per-particle destination in original order (for force gather-back)
    dest = jnp.zeros(n, jnp.int32).at[order].set(dest_s)
    ok = jnp.zeros(n, bool).at[order].set(ok_s)
    return cell_pos, cell_mass, dest, ok


def short_range_pair_block(tgt_pos, src_pos, src_mass, box_size,
                           sigma, r_cut, softening):
    """Erfc-correction acceleration of one target/source cell batch.

    ``tgt_pos [B, T, 3]``, ``src_pos [B, S, 3]``, ``src_mass [B, S]``
    -> ``acc [B, T, 3]``.  Self/padded pairs (r2 == 0) and pairs past
    ``r_cut`` contribute zero; the minimum image is applied per pair.
    """
    inv_s = 1.0 / (math.sqrt(2.0) * sigma)
    pref = math.sqrt(2.0 / math.pi) / sigma
    eps2 = softening * softening

    d = tgt_pos[:, :, None, :] - src_pos[:, None, :, :]
    d = d - box_size * jnp.round(d / box_size)
    r2 = jnp.sum(d * d, axis=-1)
    # guarded radius: self/padded pairs (r2 == 0, possibly eps2 == 0
    # too) must yield finite garbage, not NaN — a NaN survives the
    # zero mask (0 * nan = nan)
    r = jnp.sqrt(jnp.maximum(r2 + eps2, 1e-30))
    u = r * inv_s
    # pair magnitude / r (so F_vec = -mag_over_r * d)
    mag = jax.lax.erfc(u) / (r * r) + pref * jnp.exp(-u * u) / r
    w = (
        (r2 < r_cut * r_cut)
        & (r2 > 0)                  # drop self/padded pairs
    ).astype(tgt_pos.dtype) * src_mass[:, None, :]
    # an elementwise sum, not a contraction: a float32 dot_general may
    # run in TF32 on the GPU (about three decimal digits)
    return -jnp.sum((w * mag / r)[..., None] * d, axis=2)


def _short_range_forces(cell_pos, cell_mass, c_dims, box_size,
                        sigma, r_cut, softening, G):
    """Erfc-correction pair forces, 27 neighbour-cell roll batches.

    ``cell_pos``/``cell_mass``: the padded cell layout.  Returns
    ``acc [C3, cap, 3]`` for the binned particles.
    """
    c3, cap, _ = cell_pos.shape
    grid_pos = cell_pos.reshape(c_dims, c_dims, c_dims, cap, 3)
    grid_mass = cell_mass.reshape(c_dims, c_dims, c_dims, cap)

    # neighbour offsets dedup'd mod the grid: for c_dims < 3 several of
    # the 27 rolls alias the same source cells and would double-count
    offsets = sorted({
        (dx % c_dims, dy % c_dims, dz % c_dims)
        for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    })
    acc = jnp.zeros((c3, cap, 3), cell_pos.dtype)
    for dx, dy, dz in offsets:
        src_p = jnp.roll(
            grid_pos, (dx, dy, dz), axis=(0, 1, 2)
        ).reshape(c3, cap, 3)
        src_m = jnp.roll(
            grid_mass, (dx, dy, dz), axis=(0, 1, 2)
        ).reshape(c3, cap)
        acc = acc + short_range_pair_block(
            cell_pos, src_p, src_m, box_size, sigma, r_cut, softening
        )
    return G * acc


def make_p3m_force_fn(
    grid: int,
    sigma_cells: float = 1.5,
    cutoff_sigmas: float = 3.5,
    cell_cap: int | None = None,
    deconvolve: bool = True,
    assignment: str = "auto",
):
    """A P3M ``force_fn(pos, mass, box_size=..., G=..., softening=...)``
    for :func:`orbitanalysis_tpu.models.nbody.simulate_with_tracking`.

    ``sigma_cells``: Gaussian split scale in PM-cell units (1-1.5 is
    standard); ``cutoff_sigmas``: short-range cutoff in units of sigma
    (3.5 leaves an erfc tail < 5e-4).  ``cell_cap``: particle capacity
    per short-range cell; default sizes for ~4x the uniform mean.
    Overflowing cells mark their dropped particles with NaN forces
    (fail-loud, like the slab-resident PM).

    Unlike plain PM (where double-CIC compensation over-sharpens, see
    :mod:`orbitanalysis_tpu.models.pm`), ``deconvolve=True`` is correct
    here: the split field is smooth on the mesh scale, so dividing out
    the assignment+interpolation windows just removes their bias.
    Measured vs an Ewald oracle (400 particles, grid=32): median force
    error 1.1%, 95th pct 3.1% — vs 13% / 64% for plain PM.
    """
    interp = select_interpolator(assignment)

    def force(pos, mass, box_size=None, G=1.0, softening=0.0, **_):
        if box_size is None:
            raise ValueError("P3M forces require a periodic box_size")
        n = pos.shape[0]
        h = box_size / grid
        sigma = sigma_cells * h
        r_cut = cutoff_sigmas * sigma
        if r_cut > box_size / 2:
            # the erfc short range sees only the minimum image per pair
            # while the smoothed k-space long range sums all periodic
            # images — the Ewald split stops cancelling exactly
            raise ValueError(
                f"P3M short-range cutoff {r_cut:.3g} exceeds half the "
                f"box ({box_size / 2:.3g}); raise `grid` or lower "
                "`sigma_cells`/`cutoff_sigmas` (same constraint as the "
                "distributed slab-width check)"
            )
        c_dims = max(int(box_size / r_cut), 1)
        cell = box_size / c_dims  # >= r_cut
        if cell_cap is None:
            mean = n / c_dims ** 3
            cap = max(8, int(math.ceil(4.0 * mean / 8.0)) * 8)
        else:
            cap = cell_cap

        rho = cic_deposit(pos, mass, grid, box_size)
        field = pm_forces_grid(
            rho, grid, box_size, G=G, deconvolve=deconvolve,
            smoothing=sigma,
        )
        acc = interp(field, pos, grid, box_size)

        # short range: erfc pair correction within r_cut
        cell_pos, cell_mass, dest, ok = _bin_particles(
            pos, mass, c_dims, box_size, cap
        )
        acc_sr = _short_range_forces(
            cell_pos, cell_mass, c_dims, box_size, sigma, r_cut,
            softening, G,
        ).reshape(c_dims ** 3 * cap, 3)
        acc = acc + jnp.where(
            ok[:, None],
            jnp.take(acc_sr, jnp.where(ok, dest, 0), axis=0),
            jnp.nan,  # cell-capacity overflow: fail loud
        )
        return acc

    return force
