"""Particle-mesh (PM) gravity solver: FFT Poisson on the accelerator.

Scales the on-the-fly integrator to full-box particle counts
(BASELINE.json configs[2]/[4]: 512^3 boxes) where direct summation is
infeasible.  The classic PM pipeline, built on XLA-native ops:

  CIC deposit -> 3D real FFT -> Green's function [* deconvolution]
  -> spectral gradient -> inverse FFTs -> CIC interpolation

Deconvolution default: OFF.  Measured two-body force errors on a 64^3
mesh: undeconvolved +1.7% at 6 cells, -0.4% at 10 cells (image-free
separations), while double-CIC-window compensation *over*-sharpens
(+16%/+10%) because the spectral-gradient force with CIC assignment is
already nearly unbiased above ~4 cells.  ``deconvolve=True`` remains
available for power-spectrum-oriented uses.

``jnp.fft.rfftn`` lowers to the platform FFT (cuFFT on the GPU); the
deposit is one scatter-add and the interpolation a gather, both O(N)
(vs the O(N^2) pair sum).  Three interpolation forms exist —
:func:`cic_interpolate` (24 scalar gathers), :func:`cic_interpolate_rows`
(one 24-wide row gather from a pre-expanded corner table) and
:func:`cic_interpolate_cells` (a supercell-halo table, ~4x less table
memory); :func:`orbitanalysis_tpu.policy.interpolation` picks among
them from measurements (PERF.md).

References: standard PM formulation (Hockney & Eastwood); the reference
repo has no force solver at all — its on-the-fly mode assumes an external
simulation code (``/root/reference/orbitanalysis/track_orbits_onthefly.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PMConfig(NamedTuple):
    grid: int           # cells per dimension
    box_size: float
    G: float = 1.0
    deconvolve: bool = False  # compensate the CIC assignment window twice


def _cic_base(pos, grid, box_size):
    """Base (floor) cell index and +1-neighbor fractions per particle.

    Returns ``(i0 [N, 3] int32 in [0, grid), f [N, 3] float)``.
    """
    h = box_size / grid
    x = pos / h - 0.5               # cell-centered coordinates
    i0 = jnp.floor(x)
    f = x - i0                       # fraction toward the +1 neighbor
    return jnp.mod(i0.astype(jnp.int32), grid), f


def _corner_weights(f):
    """[N, 8] trilinear weights, corner order (dx, dy, dz) lexicographic
    (dz minor) — matches :func:`_cic_neighbors`'s loop order."""
    wx = jnp.stack([1.0 - f[:, 0], f[:, 0]], axis=1)      # [N, 2]
    wy = jnp.stack([1.0 - f[:, 1], f[:, 1]], axis=1)
    wz = jnp.stack([1.0 - f[:, 2], f[:, 2]], axis=1)
    w = (
        wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    )
    return w.reshape(-1, 8)


_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _cic_neighbors(pos, grid, box_size):
    """CIC cell indices and weights: 8 neighbors per particle.

    Returns ``(idx [8, N, 3] int32, w [8, N])``.
    """
    h = box_size / grid
    x = pos / h - 0.5               # cell-centered coordinates
    i0 = jnp.floor(x)
    f = x - i0                       # fraction toward the +1 neighbor
    i0 = i0.astype(jnp.int32)

    idxs, ws = [], []
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - f[:, 0], f[:, 0])
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - f[:, 1], f[:, 1])
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - f[:, 2], f[:, 2])
                idxs.append(
                    jnp.stack(
                        [
                            jnp.mod(i0[:, 0] + dx, grid),
                            jnp.mod(i0[:, 1] + dy, grid),
                            jnp.mod(i0[:, 2] + dz, grid),
                        ],
                        axis=-1,
                    )
                )
                ws.append(wx * wy * wz)
    return jnp.stack(idxs), jnp.stack(ws)


def cic_deposit(pos, mass, grid, box_size):
    """Cloud-in-cell mass deposit onto a periodic ``[grid]^3`` mesh.

    ``mass`` may be a scalar (equal-mass species, the reference's
    ``masses`` float form, ``/root/reference/orbitanalysis/track_orbits.py:44``)
    or a ``[N]`` array.
    """
    idx, w = _cic_neighbors(pos, grid, box_size)
    m = jnp.broadcast_to(
        jnp.asarray(mass, pos.dtype).reshape(-1), (pos.shape[0],)
    )
    rho = jnp.zeros((grid, grid, grid), pos.dtype)
    flat = (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2]
    rho = rho.reshape(-1).at[flat.reshape(-1)].add(
        (w * m[None, :]).reshape(-1)
    )
    return rho.reshape(grid, grid, grid)


def cic_interpolate(field3, pos, grid, box_size):
    """Interpolate a ``[3, grid, grid, grid]`` vector field to particles."""
    idx, w = _cic_neighbors(pos, grid, box_size)
    flat = (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2]  # [8, N]
    out = []
    for c in range(3):
        vals = field3[c].reshape(-1)[flat]          # [8, N]
        out.append(jnp.sum(vals * w, axis=0))
    return jnp.stack(out, axis=-1)                  # [N, 3]


def cic_deposit_rows(pos, mass, grid, box_size):
    """CIC deposit as one [N, 8] row scatter-add (the 8 trilinear
    weights land as corner channels at the *base* cell; dense periodic
    rolls shift each channel onto its corner afterwards).

    Both forms push the same 8N adds through the scatter, and the
    ``[grid^3, 8]`` accumulator costs 8x the grid's memory, so
    :func:`pm_forces` never selects it.  Numerically the same adds as
    :func:`cic_deposit` modulo f32 reassociation.
    """
    i0, f = _cic_base(pos, grid, box_size)
    w = _corner_weights(f) * mass[:, None]                    # [N, 8]
    base = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]     # [N]
    r8 = jnp.zeros((grid * grid * grid, 8), pos.dtype).at[base].add(w)
    r8 = r8.reshape(grid, grid, grid, 8)
    rho = jnp.zeros((grid, grid, grid), pos.dtype)
    for c, (dx, dy, dz) in enumerate(_CORNERS):
        rho = rho + jnp.roll(r8[..., c], (dx, dy, dz), axis=(0, 1, 2))
    return rho


# particles per lax.map chunk in cic_interpolate_rows: bounds the
# gathered-values transient to chunk * 24 * fold * 4 B (~0.8 GB at the
# defaults) — XLA won't fuse a gather through the reshape that follows
# it, so the transient is real
_ROWS_CHUNK = 1 << 19


#: corner-table bytes above which ``table_dtype='auto'`` drops to
#: bfloat16: the table is 24 x grid^3 x itemsize (f32: 1.6 GB at 256^3
#: but 12.9 GB at 512^3).  bf16 halves it for ~4e-3 relative force
#: error, far below the CIC assignment error at these grids.
_TABLE_BF16_BYTES = 3 << 30


def cic_interpolate_rows(field3, pos, grid, box_size, fold=16,
                         table_dtype="auto"):
    """CIC interpolation with one row gather per particle instead of
    24 scalar gathers.

    ``table_dtype``: dtype of the pre-expanded corner table —
    ``'auto'`` keeps float32 until the table would exceed
    ``_TABLE_BF16_BYTES``, then stores bfloat16 (~4e-3 relative force
    error; products and sums stay f32).  Pass
    ``jnp.float32``/``jnp.bfloat16`` to force either.

    The force field is pre-expanded into a corner table holding all 24
    values a particle needs (3 components x 8 corners, built with dense
    periodic rolls) and each particle issues a single row gather at its
    base cell.  ``fold=16`` cells share a table row (``[grid^3/16,
    384]``) and the particle selects its cell's 24-channel block with a
    one-hot multiply (elementwise, fuses); particles stream through
    ``lax.map`` chunks that bound the gathered transient.
    """
    g3 = grid * grid * grid
    while g3 % fold:
        fold //= 2
    if table_dtype == "auto":
        table_dtype = (
            jnp.bfloat16 if g3 * 24 * 4 > _TABLE_BF16_BYTES
            else jnp.float32
        )
    table_dtype = jnp.dtype(table_dtype)
    i0, f = _cic_base(pos, grid, box_size)
    w = _corner_weights(f)                                    # [N, 8]
    base = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]     # [N]
    # table[r, (comp*8 + corner) * fold + s] = field3[comp] at cell
    # r*fold + s shifted by the corner offset.  Built column-block by
    # column-block with dynamic_update_slice so only one rolled grid
    # (g3 floats) is live alongside the table, not all 24 at once.
    table = jnp.zeros((g3 // fold, 24 * fold), table_dtype)
    for comp in range(3):
        for c, (dx, dy, dz) in enumerate(_CORNERS):
            col = jnp.roll(
                field3[comp], (-dx, -dy, -dz), axis=(0, 1, 2)
            ).reshape(g3 // fold, fold).astype(table_dtype)
            table = jax.lax.dynamic_update_slice(
                table, col, (0, (comp * 8 + c) * fold)
            )

    return folded_row_interpolate(table, base, w, fold)


def folded_row_interpolate(table, base, w8, fold):
    """Gather-and-reduce half of the folded row interpolation, shared
    with the slab-resident distributed PM.

    ``table``: ``[n_cells/fold, 24*fold]`` corner table with channel
    layout ``(comp*8 + corner) * fold + (cell % fold)``; ``base``:
    ``[N]`` flat cell indices (out-of-range clamps — callers mask those
    lanes downstream); ``w8``: ``[N, 8]`` trilinear corner weights in
    (dx, dy, dz)-lexicographic order.  Streams particles through
    ``lax.map`` chunks (XLA won't fuse the gather through the reshape
    that follows it, so the per-chunk transient is real).
    """
    n = base.shape[0]
    if n == 0:
        return jnp.zeros((0, 3), jnp.float32)
    chunk = min(_ROWS_CHUNK, n)
    n_pad = -n % chunk
    if n_pad:
        base = jnp.concatenate([base, jnp.zeros(n_pad, base.dtype)])
        w8 = jnp.concatenate([w8, jnp.zeros((n_pad, 8), w8.dtype)])

    def one_chunk(args):
        bc, wc = args
        # gathered rows upcast to f32 before the weighted reduce: a
        # bfloat16 table costs precision only in the stored values,
        # never in the products/sums
        vals = table[bc // fold].reshape(-1, 3, 8, fold).astype(
            jnp.float32)
        oh = (
            jax.lax.broadcasted_iota(jnp.int32, (bc.shape[0], fold), 1)
            == (bc % fold)[:, None]
        )
        prod = (
            vals
            * oh[:, None, None, :].astype(vals.dtype)
            * wc[:, None, :, None]
        )
        return jnp.sum(prod, axis=(2, 3))           # [chunk, 3]

    out = jax.lax.map(
        one_chunk,
        (base.reshape(-1, chunk), w8.reshape(-1, chunk, 8)),
    ).reshape(-1, 3)
    return out[:n]


@functools.partial(
    jax.jit, static_argnames=("grid", "deconvolve", "smoothing")
)
def pm_forces_grid(rho, grid, box_size, G=1.0, deconvolve=False,
                   smoothing=None):
    """Force field ``[3, G, G, G]`` from a deposited density mesh.

    ``smoothing`` (physical length sigma) multiplies the Green's
    function by ``exp(-k_phys^2 sigma^2 / 2)`` — the Gaussian-split
    long-range part of an Ewald/P3M decomposition
    (:mod:`orbitanalysis_tpu.models.p3m` supplies the matching
    short-range erfc pair correction).
    """
    box_size = jnp.asarray(box_size, rho.dtype)
    rho_k = jnp.fft.rfftn(rho)

    kx = jnp.fft.fftfreq(grid)[:, None, None] * (2 * jnp.pi)
    ky = jnp.fft.fftfreq(grid)[None, :, None] * (2 * jnp.pi)
    kz = jnp.fft.rfftfreq(grid)[None, None, :] * (2 * jnp.pi)
    k2 = kx * kx + ky * ky + kz * kz              # (cell units)

    h = box_size / grid
    # Green's function: phi_k = -4 pi G rho_k / k_phys^2, k_phys = k / h
    green = jnp.where(k2 > 0, -4 * jnp.pi / jnp.maximum(k2, 1e-30), 0.0)
    green = green * (h * h) / (h ** 3)  # k->physical + mass->density
    if smoothing is not None:
        green = green * jnp.exp(
            -k2 * (float(smoothing) / h) ** 2 / 2.0
        )
    if deconvolve:
        # divide out the CIC window squared: W = prod sinc^2(k_i/2)
        sinc = lambda t: jnp.sinc(t / (2 * jnp.pi))  # noqa: E731
        wx, wy, wz = sinc(kx), sinc(ky), sinc(kz)
        w2 = (wx * wy * wz) ** 2
        green = green / jnp.maximum(w2, 1e-4) ** 2
    phi_k = green * rho_k * G

    forces = []
    for kvec in gradient_wavenumbers(grid, jnp):
        fk = -1j * kvec / h * phi_k               # physical gradient
        forces.append(jnp.fft.irfftn(fk, s=(grid, grid, grid)))
    return jnp.stack(forces)


def gradient_wavenumbers(grid: int, xp=np):
    """``(kx, ky, kz)`` (cell units, broadcastable to the ``rfftn``
    half-spectrum) of the spectral gradient, zero on the Nyquist
    planes: an odd derivative of a real field has no Hermitian-
    consistent value there, and inverse real transforms treat such
    input differently from one FFT library to the next (cuFFT and
    pocketfft disagree by ~2 % of the force at 256^3), so the standard
    choice — drop the Nyquist mode of the gradient — makes the result
    well defined."""
    def deriv(freq):
        return xp.where(xp.abs(freq) == 0.5, 0.0, freq) * (2 * np.pi)

    return (deriv(xp.fft.fftfreq(grid))[:, None, None],
            deriv(xp.fft.fftfreq(grid))[None, :, None],
            deriv(xp.fft.rfftfreq(grid))[None, None, :])


#: particles per lax.map chunk in cic_interpolate_cells: the gathered
#: [chunk, 3*(B+1)^3] f32 transient is ~0.4 GB at the default
_CELLS_CHUNK = 1 << 18


def cic_interpolate_cells(field3, pos, grid, box_size, block=4,
                          table_dtype="auto"):
    """CIC interpolation via a supercell-halo corner table — the
    memory diet for the 512^3 full-box anchor.

    :func:`cic_interpolate_rows`'s 24-channel table stores every force
    value 8 times (once per neighbor whose stencil touches it): 6.4 GB
    bf16 at 512^3.  This form packs ``block^3`` cells per table row
    with a one-cell halo — ``[grid^3/block^3, 3*(block+1)^3]``,
    redundancy ``((B+1)/B)^3`` ~ 1.95x instead of 8x, **1.6 GB** at the
    default ``block=4`` — for the same ONE gathered row per particle.
    The particle then selects its 24 stencil values from the halo'd row
    with three separable exact one-hot contractions.

    Selection is exact, so with an f32 table the result is bit-identical
    to :func:`cic_interpolate`; ``table_dtype='auto'`` drops the table
    to bf16 above ``_TABLE_BF16_BYTES`` (same policy + error class as
    the rows form: values quantized, products/sums f32).
    """
    b = block
    while grid % b:
        b //= 2
    bb = b + 1
    s = grid // b
    g3 = grid * grid * grid
    if table_dtype == "auto":
        table_dtype = (
            jnp.bfloat16 if g3 * 3 * bb ** 3 // b ** 3 * 4
            > _TABLE_BF16_BYTES else jnp.float32
        )
    table_dtype = jnp.dtype(table_dtype)

    # table[(sx*S + sy)*S + sz, comp*bb^3 + (i*bb + j)*bb + k]
    #   = field3[comp][(b*sx + i) % g, (b*sy + j) % g, (b*sz + k) % g]
    # built channel by channel from strided plane-takes (reads S planes
    # per take, never a full rolled grid)
    ar = jnp.arange(s, dtype=jnp.int32) * b
    table = jnp.zeros((s * s * s, 3 * bb ** 3), table_dtype)
    for comp in range(3):
        fx = field3[comp]
        for i in range(bb):
            fxi = jnp.take(fx, (ar + i) % grid, axis=0)     # [S, g, g]
            for j in range(bb):
                fxj = jnp.take(fxi, (ar + j) % grid, axis=1)
                for k in range(bb):
                    col = jnp.take(
                        fxj, (ar + k) % grid, axis=2
                    ).reshape(s * s * s, 1).astype(table_dtype)
                    table = jax.lax.dynamic_update_slice(
                        table, col,
                        (0, comp * bb ** 3 + (i * bb + j) * bb + k),
                    )

    i0, f = _cic_base(pos, grid, box_size)
    w8 = _corner_weights(f)                                   # [N, 8]
    sc = i0 // b
    row = (sc[:, 0] * s + sc[:, 1]) * s + sc[:, 2]            # [N]
    cin = (i0 - sc * b).astype(jnp.int32)                     # [N, 3]

    n = row.shape[0]
    chunk = min(_CELLS_CHUNK, n)
    n_pad = -n % chunk
    if n_pad:
        row = jnp.concatenate([row, jnp.zeros(n_pad, row.dtype)])
        cin = jnp.concatenate(
            [cin, jnp.zeros((n_pad, 3), cin.dtype)])
        w8 = jnp.concatenate([w8, jnp.zeros((n_pad, 8), w8.dtype)])

    def one_chunk(args):
        rc, cc, wc = args
        c = rc.shape[0]
        vals = table[rc].reshape(c, 3, bb, bb, bb).astype(jnp.float32)
        iot = jax.lax.broadcasted_iota(jnp.int32, (c, bb), 1)

        def oh(coord, d):
            return (iot == (coord + d)[:, None]).astype(jnp.float32)

        # separable exact selection: contract z, then y, then x
        az = [jnp.sum(vals * oh(cc[:, 2], dz)[:, None, None, None, :],
                      axis=-1) for dz in (0, 1)]     # [c, 3, bb, bb]
        ay = [[jnp.sum(az[dz] * oh(cc[:, 1], dy)[:, None, None, :],
                       axis=-1) for dz in (0, 1)]
              for dy in (0, 1)]                      # [c, 3, bb]
        corners = [
            jnp.sum(ay[dy][dz] * oh(cc[:, 0], dx)[:, None, :], axis=-1)
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
        ]                                            # 8 x [c, 3]
        vals8 = jnp.stack(corners, axis=-1)          # [c, 3, 8]
        return jnp.sum(vals8 * wc[:, None, :], axis=-1)

    out = jax.lax.map(
        one_chunk,
        (row.reshape(-1, chunk), cin.reshape(-1, chunk, 3),
         w8.reshape(-1, chunk, 8)),
    ).reshape(-1, 3)
    return out[:n]


def _interp_choice(assignment: str, grid: int) -> str:
    if assignment == "auto":
        from orbitanalysis_tpu.policy import interpolation

        return interpolation(grid)
    if assignment not in ("rows", "scalar", "cells"):
        raise ValueError(
            f"assignment must be 'auto', 'rows', 'cells' or 'scalar', "
            f"got {assignment!r}"
        )
    return assignment


def _use_rows(assignment: str) -> bool:
    """Binary rows-vs-scalar form of the policy, kept for the sharded
    PM (its per-slab tables never reach the 24-channel blowup that
    motivates the supercell form)."""
    return _interp_choice(
        assignment if assignment != "cells" else "rows", 0
    ) != "scalar"


def select_interpolator(assignment: str, grid: int = 0):
    """The one place the ``assignment`` string is resolved (validated
    eagerly, at construction time).  ``grid`` informs the ``'auto'``
    choice; callers that interpolate slab-sized sub-grids may omit it."""
    choice = _interp_choice(assignment, grid)
    return {
        "rows": cic_interpolate_rows,
        "cells": cic_interpolate_cells,
        "scalar": cic_interpolate,
    }[choice]


def pm_forces(
    pos: jnp.ndarray,
    mass: jnp.ndarray,
    grid: int,
    box_size: float,
    G: float = 1.0,
    deconvolve: bool = False,
    assignment: str = "auto",
    **_,
) -> jnp.ndarray:
    """PM accelerations for all particles (signature-compatible with
    :func:`orbitanalysis_tpu.models.nbody.direct_forces` given a config
    closure over ``grid``).

    ``assignment`` selects the interpolation form: ``'rows'`` = the
    folded row gather (:func:`cic_interpolate_rows`), ``'cells'`` = the
    supercell-halo table (:func:`cic_interpolate_cells`, 4x less table
    memory), ``'scalar'`` = the classic 24-gather form, ``'auto'`` =
    :func:`orbitanalysis_tpu.policy.interpolation`.  The deposit is the
    scatter-add :func:`cic_deposit`.
    """
    interp = select_interpolator(assignment, grid)
    rho = cic_deposit(pos, mass, grid, box_size)
    field = pm_forces_grid(
        rho, grid, box_size, G=G, deconvolve=deconvolve
    )
    return interp(field, pos, grid, box_size)


def make_pm_force_fn(grid: int, deconvolve: bool = False,
                     assignment: str = "auto"):
    """A ``force_fn(pos, mass, box_size=..., G=..., **ignored)`` for
    :func:`orbitanalysis_tpu.models.nbody.simulate_with_tracking`."""

    def force(pos, mass, box_size=None, G=1.0, **_):
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        return pm_forces(pos, mass, grid, box_size, G=G,
                         deconvolve=deconvolve, assignment=assignment)

    return force
