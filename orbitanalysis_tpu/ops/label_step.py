"""Label-native orbit detection over a position-stable particle pool.

Device-resident pipelines — the native integrator
(:mod:`orbitanalysis_tpu.models.nbody`) and the hash-sharded record
pools (:mod:`orbitanalysis_tpu.parallel.hash_sharded`) — hold their
particles in a GLOBAL array whose positions never change: position i
is particle i for the whole run.  That array is a stable layout by
construction, so the aligned engine's central trick (detection needs
layout stability, not ID identity — ``ops/sorted_step.py``) applies
with no staging at all: membership churn against halo regions is just
a per-particle halo *label* change, and the whole reference detection
semantics (``/root/reference/orbitanalysis/track_orbits.py:293-351``:
entered/departed handling, radial-velocity sign flips, angle
accumulate/reset) becomes elementwise over ``[N]`` planes:

- entered  (reference ``setdiff1d`` bookkeeping, ``:300-309``)
    = ``label != prev_label`` — the FRESH condition, elementwise;
- departed = the same comparison seen from the previous label;
- the ID join disappears — there is nothing to match because nothing
  moves.

The two non-elementwise needs — per-particle halo center / bulk
velocity rows (a tiny-table lookup) and the per-halo velocity moments
behind the bulk velocities (the reference's mass-weighted moving-center
frame, ``track_orbits.py:267-284``) — come in several forms, chosen by
``frames`` (:func:`orbitanalysis_tpu.policy.label_frames` resolves
``'auto'``):

- ``'gather'``: a table gather for the rows and ``segment_sum`` for the
  moments — O(N) work;
- ``'matmul'`` / ``'soa'`` (and ``*_bf16x3``): one-hot matmuls,
  ``onehot(label) [N, H] @ table [H, C]``, chunked to bound the
  one-hot — O(H·N) work, exact in f32 (each output row sums exactly one
  table row);
- ``'twolevel'``: a hi/lo split of the label that cuts the one-hot
  work to ``(H/32 + 6*32)*N`` for large halo counts;
- ``'select'``: an H-pass select scan, the bit-exact reference.

Every form selects rows bit-exactly, so frame math is identical across
them; moments differ only in f32 summation order.

Events come back positional (the aligned engine's single-payload
contract, :func:`orbitanalysis_tpu.ops.compact.compact_payload`): the
global pool index identifies the particle, and the label plane maps it
to a halo.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "LabelCarry",
    "LabelEvents",
    "assign_regions",
    "init_label_carry",
    "make_label_orbit_step",
    "scan_label_events",
    "take_rows_gather",
    "take_rows_matmul",
]


class LabelCarry(NamedTuple):
    """Per-particle detector state over the global pool, held as 2D
    ``[R, row_width]`` row planes (``rhat`` is ``[3, R, row_width]``,
    or ``[R, row_width]`` uint32 when octahedral-packed): particle
    ``i`` lives at row ``i // row_width``, lane ``i % row_width``.

    The row shape is exactly what the positional event compaction
    consumes (one compaction row per plane row), so the payload path
    needs no reshape.

    ``lab_sv``: previous halo label in bits 0-27 offset by +1 (0 =
    untracked; labels are < 2**27) with the radial-velocity sign bits
    in bits 28-29 (bit 28 = inward, bit 29 = outward, the
    :func:`orbitanalysis_tpu.ops.sorted_step._vr_bits` convention
    shifted) — one i32 plane instead of an i32 + a sub-word u8.
    ``packed``: f32 angle
    accumulator in bits 0-30, matched flag in bit 31 — the aligned
    engine's carry contract.
    """

    lab_sv: jnp.ndarray  # [R, W] int32: (label + 1) | vrb << 28
    rhat: jnp.ndarray    # [3, R, W] f32, or [R, W] u32 oct-packed
    packed: jnp.ndarray  # [R, W] uint32


class LabelEvents(NamedTuple):
    """Positional events per compaction row (see
    :func:`make_label_orbit_step` for the row geometry): ``count[r]``
    events in row ``r``, front-packed global pool indices and
    f16-quantized angles; entries past the count are invalid/-0."""

    count: jnp.ndarray   # [R] int32
    index: jnp.ndarray   # [R, K] int32 global pool index (invalid: -1)
    angle: jnp.ndarray   # [R, K] float32 (f16-exact)
    bulk_vel: jnp.ndarray  # [H, 3] the frame bulk velocities used


def init_label_carry(n: int, rhat_packed: bool = False,
                     row_width: int = 1 << 15) -> LabelCarry:
    """All-untracked carry over ``R = n // row_width`` row planes
    (``row_width`` must match the step's — row geometry is part of the
    carry layout; see :class:`LabelCarry`).  ``rhat_packed=True``
    stores the radial unit vectors octahedral-compressed (uint32
    instead of 3 x f32: the carry drops from 20 to 12 B/particle — the
    1e8-particles-per-chip diet).  Counts are unaffected by
    construction (radial-velocity signs never read the carried rhat);
    accumulated angles move by the ~1e-4 rad quantization per step."""
    w = min(int(row_width), n)
    if n % w:
        raise ValueError(
            f"pool size {n} must be a multiple of row_width {w}")
    r = n // w
    return LabelCarry(
        lab_sv=jnp.zeros((r, w), jnp.int32),  # label -1, no sign bits
        rhat=(jnp.zeros((r, w), jnp.uint32) if rhat_packed
              else jnp.zeros((3, r, w), jnp.float32)),
        packed=jnp.zeros((r, w), jnp.uint32),
    )


def _auto_chunk(n: int, h: int, chunk):
    """Chunk size + pad for the chunked one-hot passes.

    Single-chunk when the implied one-hot stays under ~1 GB: without
    a ``lax.map``/``scan`` boundary XLA fuses the iota-compare into the
    dot's operand and the dot output into its consumers; chunk only to
    bound worst-case transient memory.  When ``n`` is not a chunk multiple
    the PLANES ARE PADDED to the next multiple (``pad`` tail entries:
    idx −1 → zero one-hot column, values 0) instead of collapsing to a
    single ``n``-sized chunk — a single chunk at the scales these
    paths target materializes an ``[n, H]``-scale transient and OOMs
    (round-3 advisor finding).  Returns ``(chunk, pad)``.
    """
    if chunk is None:
        chunk = n if n * h * 4 <= (1 << 30) else 1 << 17
    chunk = min(int(chunk), n)
    return chunk, (-n) % chunk


def _pad_tail(pad: int, idx: jnp.ndarray, *planes):
    """Append ``pad`` inert entries (idx −1, values 0) to ``[N]``/
    ``[C, N]`` planes so chunked passes divide evenly.  Returns
    ``(idx,) + planes`` padded along the last axis."""
    if not pad:
        return (idx,) + planes
    idx = jnp.concatenate(
        [idx, jnp.full((pad,), -1, idx.dtype)])
    return (idx,) + tuple(
        jnp.concatenate(
            [p, jnp.zeros(p.shape[:-1] + (pad,), p.dtype)], axis=-1)
        for p in planes
    )


def _split_bf16x3(x: jnp.ndarray):
    """Exact 3-piece bf16 decomposition of f32 ``x``: returns
    ``(p0, p1, p2)`` bf16 with ``p0 + p1 + p2 == x`` (as reals, and
    bit-exactly when re-summed hi-to-lo in f32).

    Truncation split: bf16 is the top 16 bits of the f32 word, so
    masking the low half yields an exactly-representable piece, the
    residual subtraction is exact (the piece's mantissa is a prefix of
    ``x``'s), and f32's 24 significant bits drain in <= 3 pieces of 8.
    Exact for ``|x| >~ 2**-110`` (below that the low pieces, ~2**-17
    smaller than ``x``, dip under bf16's 2**-133 subnormal floor and
    round — irrelevant for physical positions/velocities/masses).
    This turns a ``Precision.HIGHEST`` f32 dot into ONE native bf16
    dot while keeping one-hot selection bit-exact.
    """

    def trunc(v):
        return jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(v, jnp.uint32)
            & jnp.uint32(0xFFFF0000),
            jnp.float32,
        )

    p0 = trunc(x)
    r1 = x - p0
    p1 = trunc(r1)
    p2 = r1 - p1
    return (p0.astype(jnp.bfloat16), p1.astype(jnp.bfloat16),
            p2.astype(jnp.bfloat16))


def take_rows_matmul(table: jnp.ndarray, idx: jnp.ndarray,
                     chunk=None, precision: str = "f32") -> jnp.ndarray:
    """``table[idx]`` for a small table, as (optionally chunked)
    one-hot matmuls.

    ``table``: ``[H, C]`` f32; ``idx``: ``[N]`` int32 in ``[-1, H)``
    (-1 rows return zeros).  Exact in f32: each output row is a sum
    with exactly one nonzero product; ``2 N H C`` flops.

    ``precision='f32'`` (default) is the ``Precision.HIGHEST`` f32
    dot.  ``'bf16x3'`` runs ONE native bf16 dot over the exactly-split
    table (:func:`_split_bf16x3`) — also bit-exact.
    """
    h, c = table.shape
    n = idx.shape[0]
    chunk, pad = _auto_chunk(n, h, chunk)
    table = table.astype(jnp.float32)
    if precision == "bf16x3":
        cat = jnp.concatenate(_split_bf16x3(table), axis=1)  # [H, 3C]

    def body(ix):
        eq = ix[:, None] == jnp.arange(h, dtype=jnp.int32)[None, :]
        if precision == "bf16x3":
            out3 = jnp.dot(eq.astype(jnp.bfloat16), cat,
                           preferred_element_type=jnp.float32)
            return (out3[:, :c] + out3[:, c:2 * c]) + out3[:, 2 * c:]
        return jnp.dot(eq.astype(table.dtype), table,
                       precision=jax.lax.Precision.HIGHEST)

    if n == chunk:
        return body(idx)
    (idx,) = _pad_tail(pad, idx)
    out = jax.lax.map(body, idx.reshape((n + pad) // chunk, chunk))
    return out.reshape(n + pad, c)[:n]


def take_rows_select(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx]`` via a ``lax.scan`` of per-row selects — exact
    (no matmul rounding), O(H) elementwise passes over ``[N]``: the
    bit-exact alternative to :func:`take_rows_matmul` for small ``H``.
    """
    h, c = table.shape
    n = idx.shape[0]

    def body(carry, hrow):
        out, h_idx = carry
        row, = hrow
        out = jnp.where((idx == h_idx)[:, None], row[None, :], out)
        return (out, h_idx + 1), None

    (out, _), _ = jax.lax.scan(
        body, (jnp.zeros((n, c), table.dtype), jnp.int32(0)), (table,)
    )
    return out


def _onehot_hn(idx: jnp.ndarray, h: int) -> jnp.ndarray:
    """``[H, N]`` bool one-hot of ``idx [N]`` (-1 -> zero column)."""
    return idx[None, :] == jnp.arange(h, dtype=jnp.int32)[:, None]


# two-level split width
_TWOLEVEL_HL = 32


def take_rows_twolevel(table: jnp.ndarray, idx: jnp.ndarray,
                       chunk=None, hl: int = _TWOLEVEL_HL) -> jnp.ndarray:
    """``table[idx].T`` (SoA ``[C, N]``) via a two-level hi/lo label
    split — the large-``H`` form of :func:`take_rows_soa`.

    One-hot work drops from ``H*N`` to ``(H/hl)*N`` in a dot plus a
    ``C*hl*N`` elementwise contraction: ``partial[(c, lo), n] =
    table[hi(n)*hl + lo, c]`` comes from a ``[C*hl, H/hl]`` re-tiled
    table dot with ``onehot(idx // hl)``, then the low one-hot
    contracts elementwise.  Bit-exact (both stages select exactly one
    nonzero product per output).
    """
    h, c = table.shape
    n = idx.shape[0]
    hh = -(-h // hl)
    pad_h = hh * hl - h
    table = table.astype(jnp.float32)
    if pad_h:
        table = jnp.concatenate(
            [table, jnp.zeros((pad_h, c), jnp.float32)])
    # L[c*hl + lo, hi] = table[hi*hl + lo, c]
    L = jnp.transpose(table.reshape(hh, hl, c), (2, 1, 0)).reshape(
        c * hl, hh)
    chunk, pad = _auto_chunk(n, c * hl, chunk)

    def body(ix):
        m = ix.shape[0]
        hi = ix // hl  # -1 -> -1 (floor div): zero oh_hi column
        oh_hi = _onehot_hn(hi, hh)
        partial = jax.lax.dot_general(
            L, oh_hi.astype(jnp.float32),
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [c*hl, m]
        lo = ix - hi * hl
        oh_lo = _onehot_hn(lo, hl)
        return jnp.sum(
            partial.reshape(c, hl, m)
            * oh_lo.astype(jnp.float32)[None],
            axis=1,
        )  # [c, m]

    if n == chunk:
        return body(idx)
    (idx,) = _pad_tail(pad, idx)
    out = jax.lax.map(body, idx.reshape((n + pad) // chunk, chunk))
    return jnp.moveaxis(out, 0, 1).reshape(c, n + pad)[:, :n]


def _frame_geometry(p3, v3, cpp, bpp, hubble_drag, box_size):
    """Radial geometry in plane-wise (unstacked) form: ``p3``/``v3``/
    ``cpp``/``bpp`` are 3-tuples of ``[...]`` f32 planes (position,
    velocity, per-particle center, per-particle bulk velocity).
    Returns ``(rhat 3-tuple, vr)`` — the reference's region-frame
    radial quantities (``track_orbits.py:276-288``: ``v_phys = v -
    v_bulk + H·r/(1+z)``, ``vr = r̂·v_phys``).

    Plane-wise on purpose: XLA fuses the elementwise chain identically
    either way, and the plane form never asks for stacked temporaries.
    """
    rel = []
    for d in range(3):
        rd = p3[d] - cpp[d]
        if box_size is not None:
            rd = rd - box_size * jnp.round(rd / box_size)
        rel.append(rd)
    r2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
    r = jnp.sqrt(r2)
    inv_r = jnp.where(r > 0, 1.0 / jnp.maximum(r, 1e-30), 0.0)
    rhat = tuple(rd * inv_r for rd in rel)
    vr = sum(
        rhat[d] * (v3[d] - bpp[d] + hubble_drag * rel[d])
        for d in range(3)
    )
    return rhat, vr


def _frame_detect_twolevel(table, lab, pos, vel, hubble_drag,
                           box_size, chunk=None,
                           hl: int = _TWOLEVEL_HL):
    """Fused frame-rows + radial geometry for large halo counts: one
    chunked pass selects ``table[label]`` via the two-level hi/lo
    split (:func:`take_rows_twolevel`) and immediately consumes the
    rows into :func:`_frame_geometry`, so the ``[6, N]`` frame-row
    array never exists in HBM.  Returns ``(rhat 3-tuple, vr)``, each
    plane ``[N]`` f32.  Bit-exact row selection; geometry identical to
    the unfused form.
    """
    h, c = table.shape
    n = lab.shape[0]
    hh = -(-h // hl)
    pad_h = hh * hl - h
    table = table.astype(jnp.float32)
    if pad_h:
        table = jnp.concatenate(
            [table, jnp.zeros((pad_h, c), jnp.float32)])
    L = jnp.transpose(table.reshape(hh, hl, c), (2, 1, 0)).reshape(
        c * hl, hh)
    chunk, pad = _auto_chunk(n, c * hl, chunk)

    def body(xs):
        ix = xs[0]
        m = ix.shape[0]
        hi = ix // hl  # -1 -> -1 (floor div): zero oh_hi column
        oh_hi = _onehot_hn(hi, hh)
        partial = jax.lax.dot_general(
            L, oh_hi.astype(jnp.float32),
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [c*hl, m]
        lo = ix - hi * hl
        oh_lo = _onehot_hn(lo, hl)
        rows = jnp.sum(
            partial.reshape(c, hl, m)
            * oh_lo.astype(jnp.float32)[None],
            axis=1,
        )  # [c, m]
        rhat, vr = _frame_geometry(
            xs[1:4], xs[4:7],
            (rows[0], rows[1], rows[2]),
            (rows[3], rows[4], rows[5]),
            hubble_drag, box_size,
        )
        return rhat + (vr,)

    planes = (lab,) + tuple(pos[d] for d in range(3)) + tuple(
        vel[d] for d in range(3))
    if n == chunk:
        out = body(planes)
        return out[:3], out[3]
    planes = _pad_tail(pad, planes[0], *planes[1:])
    k = (n + pad) // chunk
    out = jax.lax.map(
        body, tuple(p.reshape(k, chunk) for p in planes))
    rhx, rhy, rhz, vr = (o.reshape(n + pad)[:n] for o in out)
    return (rhx, rhy, rhz), vr


def _segment_moments_twolevel(values: jnp.ndarray, idx: jnp.ndarray,
                              n_halos: int, chunk=None,
                              hl: int = _TWOLEVEL_HL) -> jnp.ndarray:
    """Per-halo sums ``[H, C]`` of SoA ``values [C, N]`` grouped by
    ``idx`` via the two-level split: the low one-hot multiplies into
    the values as a fused ``[C*hl, N]`` dot operand, the high one-hot
    is the dot's other side — ``H*N`` one-hot work becomes
    ``(C*hl + H/hl)*N``.  Same f32-accumulation tolerance class as the
    direct forms (different reduction order)."""
    h = n_halos
    c, n = values.shape
    hh = -(-h // hl)
    values = values.astype(jnp.float32)
    chunk, pad = _auto_chunk(n, c * hl, chunk)

    def dot_chunk(ix, val):
        hi = ix // hl
        lo = ix - hi * hl
        oh_hi = _onehot_hn(hi, hh)
        oh_lo = _onehot_hn(lo, hl)
        # y[(c, lo), n] = val[c, n] * oh_lo[lo, n] (fused dot operand)
        y = (val[:, None, :] * oh_lo.astype(jnp.float32)[None]
             ).reshape(c * hl, ix.shape[0])
        return jax.lax.dot_general(
            y, oh_hi.astype(jnp.float32),
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [c*hl, hh]

    if n == chunk:
        mom2 = dot_chunk(idx, values)
    else:
        padded = _pad_tail(pad, idx, values)
        idx, values = padded[0], padded[1]
        k = (n + pad) // chunk

        def body(acc, xs):
            # re-stack the chunk from per-plane slices — stacking the
            # full [C, N] into chunk-major order would materialize a
            # transposed copy of the whole array
            return acc + dot_chunk(xs[0], jnp.stack(xs[1:])), None

        mom2, _ = jax.lax.scan(
            body, jnp.zeros((c * hl, hh), jnp.float32),
            (idx.reshape(k, chunk),)
            + tuple(values[i].reshape(k, chunk) for i in range(c)),
        )
    mom = jnp.transpose(mom2.reshape(c, hl, hh), (2, 1, 0)).reshape(
        hh * hl, c)
    return mom[:h]


def take_rows_soa(table: jnp.ndarray, idx: jnp.ndarray,
                  chunk=None, precision: str = "f32") -> jnp.ndarray:
    """``table[idx].T`` — the SoA form of :func:`take_rows_matmul`:
    ``[C, N]`` out of ``table [H, C]`` + ``idx [N]`` via
    ``table.T @ onehot [H, N]``, so the frame planes come out in the
    ``[3, N]`` layout the detector consumes with no transpose and no
    lane-padded ``[N, C]`` intermediate.  Bit-exact for both
    precisions (one-hot selection; 'bf16x3' re-sums the exact split
    hi-to-lo)."""
    h, c = table.shape
    n = idx.shape[0]
    chunk, pad = _auto_chunk(n, h, chunk)
    tt = table.astype(jnp.float32).T  # [C, H]
    if precision == "bf16x3":
        cat = jnp.concatenate(_split_bf16x3(tt), axis=0)  # [3C, H]

    def body(ix):
        oh = _onehot_hn(ix, h)
        if precision == "bf16x3":
            out3 = jax.lax.dot_general(
                cat, oh.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # [3C, n]
            return (out3[:c] + out3[c:2 * c]) + out3[2 * c:]
        return jax.lax.dot_general(
            tt, oh.astype(jnp.float32),
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, n]

    if n == chunk:
        return body(idx)
    (idx,) = _pad_tail(pad, idx)
    out = jax.lax.map(
        body, idx.reshape((n + pad) // chunk, chunk))  # [k, C, c]
    return jnp.moveaxis(out, 0, 1).reshape(c, n + pad)[:, :n]


def _segment_moments_soa(values: jnp.ndarray, idx: jnp.ndarray,
                         n_halos: int, chunk=None,
                         precision: str = "f32") -> jnp.ndarray:
    """Per-halo sums ``[H, C]`` of SoA ``values [C, N]`` grouped by
    ``idx [N]`` (-1 ignored): ``values @ onehot^T`` with the particle
    axis contracted in its native lane layout (no ``[N, C]``
    intermediate)."""
    h = n_halos
    c, n = values.shape
    values = values.astype(jnp.float32)
    chunk, pad = _auto_chunk(n, h, chunk)

    def dot_n(ix, val):
        oh = _onehot_hn(ix, h)
        if precision == "bf16x3":
            cat = jnp.concatenate(_split_bf16x3(val), axis=0)  # [3C, n]
            out3 = jax.lax.dot_general(
                cat, oh.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # [3C, H]
            return (out3[:c] + out3[c:2 * c]) + out3[2 * c:]
        return jax.lax.dot_general(
            val, oh.astype(jnp.float32),
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, H]

    if n == chunk:
        return dot_n(idx, values).T

    idx, values = _pad_tail(pad, idx, values)
    k = (n + pad) // chunk

    def body(acc, xs):
        ix, val = xs
        return acc + dot_n(ix, val), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((c, h), jnp.float32),
        (idx.reshape(k, chunk),
         jnp.moveaxis(values.reshape(c, k, chunk), 1, 0)),
    )
    return acc.T


def _segment_moments_matmul(values: jnp.ndarray, idx: jnp.ndarray,
                            n_halos: int, chunk=None,
                            precision: str = "f32") -> jnp.ndarray:
    """Per-halo sums of ``values [N, C]`` grouped by ``idx [N]``
    (-1 ignored), as chunked ``onehot^T @ values`` dots.

    f32 accumulation in halo-major chunk order — deterministic, and
    within one ulp of a NumPy segment sum (the aligned engine's
    bulk-velocity tolerance class, ``tests/test_engine.py``).
    ``precision='f32'`` (the default) is the ``Precision.HIGHEST`` f32
    dot.  ``'bf16x3'`` splits
    ``values`` exactly into 3 bf16 planes (:func:`_split_bf16x3`) and
    runs ONE native bf16 dot over the ``[N, 3C]`` concat — each
    per-halo piece sum is a 0/1-weighted f32-accumulated reduction, so
    the only change vs the f32 dot is the (already tolerance-classed)
    accumulation order.
    """
    h = n_halos
    n, c = values.shape
    values = values.astype(jnp.float32)
    chunk, pad = _auto_chunk(n, h, chunk)

    def dot_t(ix, val):
        eq = ix[:, None] == jnp.arange(h, dtype=jnp.int32)[None, :]
        if precision == "bf16x3":
            cat = jnp.concatenate(_split_bf16x3(val), axis=1)  # [n, 3C]
            out3 = jnp.dot(eq.astype(jnp.bfloat16).T, cat,
                           preferred_element_type=jnp.float32)
            return (out3[:, :c] + out3[:, c:2 * c]) + out3[:, 2 * c:]
        return jnp.dot(eq.astype(val.dtype).T, val,
                       precision=jax.lax.Precision.HIGHEST)

    if n == chunk:
        return dot_t(idx, values)

    if pad:
        idx = jnp.concatenate([idx, jnp.full((pad,), -1, idx.dtype)])
        values = jnp.concatenate(
            [values, jnp.zeros((pad, c), values.dtype)], axis=0)
    k = (n + pad) // chunk

    def body(acc, xs):
        ix, val = xs
        return acc + dot_t(ix, val), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((h, c), jnp.float32),
        (idx.reshape(k, chunk),
         values.reshape(k, chunk, c)),
    )
    return acc


def assign_regions(pos, centers, radii, box_size=None,
                   soa: bool = False) -> jnp.ndarray:
    """Halo label per particle: index of the nearest center whose
    region (periodic-wrapped distance < radius) contains it, else -1.

    The reference selects region members by brute-force radius test per
    halo (``/root/reference/example_script.py:50-58``); this is the
    same predicate resolved to a single owner (nearest center wins on
    overlap), streamed over the halo axis so nothing ``[N, H]``-sized
    materializes.
    """
    pos = jnp.asarray(pos)
    x = pos if soa else jnp.moveaxis(pos, -1, 0)  # [3, N]
    n = x.shape[1]
    centers = jnp.asarray(centers, jnp.float32)
    radii = jnp.asarray(radii, jnp.float32)

    def body(carry, hc):
        best_d2, best_h, h_idx = carry
        c, r = hc
        d = x - c[:, None]
        if box_size is not None:
            d = d - box_size * jnp.round(d / box_size)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        hit = (d2 < r * r) & (d2 < best_d2)
        return (
            jnp.where(hit, d2, best_d2),
            jnp.where(hit, h_idx, best_h),
            h_idx + 1,
        ), None

    (_, label, _), _ = jax.lax.scan(
        body,
        (jnp.full((n,), jnp.inf, jnp.float32),
         jnp.full((n,), -1, jnp.int32), jnp.int32(0)),
        (centers, radii),
    )
    return label


def take_rows_gather(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx].T`` (SoA ``[C, N]``) as a plain gather; -1 rows
    return zeros.  O(N) work, bit-exact."""
    rows = jnp.take(table.astype(jnp.float32).T, jnp.maximum(idx, 0),
                    axis=1)                                  # [C, N]
    return jnp.where((idx >= 0)[None, :], rows, 0.0)


def _segment_moments_gather(values: jnp.ndarray, idx: jnp.ndarray,
                            n_halos: int) -> jnp.ndarray:
    """Per-halo sums ``[H, C]`` of SoA ``values [C, N]`` grouped by
    ``idx [N]`` (-1 ignored) as one ``segment_sum`` — O(N) work; f32
    summation order is the backend's (the direct forms' tolerance
    class)."""
    return jax.ops.segment_sum(
        values.astype(jnp.float32).T, idx, num_segments=n_halos)


FRAMES_IMPLS = ("auto", "gather", "matmul", "matmul_bf16x3", "soa",
                "soa_bf16x3", "twolevel", "select")


def make_label_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    n_halos: Optional[int] = None,
    chunk=None,
    row_width: int = 1 << 15,
    frames: str = "auto",
    rhat_packed: bool = False,
):
    """Churn-proof detector over a position-stable pool — the aligned
    engine's step with the stable layout provided by the pool itself
    (no staging, no join): everything is elementwise ``[N]`` planes
    except the per-halo frames (``frames``, see the module docstring).

    The returned ``step(carry, inputs) -> (carry, LabelEvents)`` takes
    ``inputs = (pos [3, N], vel [3, N], label [N], centers [H, 3],
    bulk_vel [H, 3] or None, mass [N] or None, hubble_drag scalar)``.
    Apsis semantics are the reference's (sign flip between consecutive
    steps while the particle stays in the same halo's region; a label
    change is region entry: state restarts like
    ``track_orbits.py:300-309``'s entered set).

    Events are positional over compaction rows of ``row_width``
    entries (``N`` must be a multiple; the single-payload encoding
    addresses ``pos + 1 <= 2**17 - 1`` per row): global pool index =
    ``row * row_width + position``.  ``event_capacity`` is per row.
    """
    from orbitanalysis_tpu.ops.compact import (
        compact_payload,
        decode_payload,
    )
    from orbitanalysis_tpu.policy import label_frames
    from orbitanalysis_tpu.utils.numerics import (
        acos_f32,
        oct_decode,
        oct_encode,
    )

    if frames not in FRAMES_IMPLS:
        raise ValueError(f"unknown frames impl {frames!r}")
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    pericentric = mode == "pericentric"
    K = int(event_capacity)
    if row_width > (1 << 17) - 128:
        raise ValueError("row_width exceeds the positional payload budget")

    def step(carry: LabelCarry, inputs):
        pos, vel, label, centers, bulk_vel, mass, hubble_drag = inputs
        # canonicalize to the carry's 2D [R, W] row planes; 1D callers
        # pay one reshape per plane here, sequence drivers
        # (scan_label_events) reshape once up front
        if label.ndim == 1:
            n = label.shape[0]
            w_ = min(row_width, n)
            if n % w_:
                raise ValueError(
                    f"pool size {n} must be a multiple of row_width "
                    f"{w_}"
                )
            r_ = n // w_
            label = label.reshape(r_, w_)
            pos = jnp.reshape(pos, (3, r_, w_))
            vel = jnp.reshape(vel, (3, r_, w_))
            if mass is not None:
                mass = jnp.reshape(mass, (r_, w_))
        R, W = label.shape
        n = R * W
        h = centers.shape[0] if n_halos is None else n_halos
        valid = label >= 0
        lab_m = jnp.where(valid, label, -1)
        lab_f = lab_m.reshape(n)
        impl = label_frames(h) if frames == "auto" else frames

        # per-halo moments [H, 4] = [m·vx, m·vy, m·vz, m]; bulk = m·v
        # sums / m sum
        if bulk_vel is None:
            vel_f = jnp.reshape(vel, (3, n))
            w = (jnp.ones((n,), jnp.float32) if mass is None
                 else jnp.reshape(mass, (n,)))
            w = jnp.where(lab_f >= 0, w, 0.0)
            soa_vals = jnp.concatenate([vel_f * w[None], w[None, :]],
                                       axis=0)
            if impl == "gather":
                mom = _segment_moments_gather(soa_vals, lab_f, h)
            elif impl == "twolevel":
                mom = _segment_moments_twolevel(
                    soa_vals, lab_f, h, chunk=chunk)
            elif impl in ("soa", "soa_bf16x3"):
                mom = _segment_moments_soa(
                    soa_vals, lab_f, h, chunk=chunk,
                    precision=("bf16x3" if impl == "soa_bf16x3"
                               else "f32"),
                )
            else:
                mom = _segment_moments_matmul(
                    jnp.stack([vel_f[0] * w, vel_f[1] * w,
                               vel_f[2] * w, w], axis=-1),
                    lab_f, h, chunk=chunk,
                    precision=("bf16x3" if impl == "matmul_bf16x3"
                               else "f32"),
                )
            bulk = mom[:, :3] / jnp.maximum(mom[:, 3:4], 1e-30)
        else:
            bulk = jnp.asarray(bulk_vel, jnp.float32)

        # per-particle center & bulk rows from the combined [H, 6] table
        table = jnp.concatenate([centers.astype(jnp.float32), bulk],
                                axis=-1)
        p3 = tuple(jnp.reshape(pos[d], (n,)) for d in range(3))
        v3 = tuple(jnp.reshape(vel[d], (n,)) for d in range(3))
        if impl == "twolevel":
            # rows selection + geometry fused in one chunked pass — no
            # [6, N] temporaries
            rhat_f, vr_f = _frame_detect_twolevel(
                table, lab_f, p3, v3, hubble_drag, box_size, chunk=chunk,
            )
        else:
            if impl == "gather":
                rows_soa = take_rows_gather(table, lab_f)
            elif impl in ("soa", "soa_bf16x3"):
                rows_soa = take_rows_soa(
                    table, lab_f, chunk=chunk,
                    precision=("bf16x3" if impl == "soa_bf16x3"
                               else "f32"),
                )
            elif impl == "select":
                rows_soa = take_rows_select(table, lab_f).T
            else:
                rows_soa = take_rows_matmul(
                    table, lab_f, chunk=chunk,
                    precision=("bf16x3" if impl == "matmul_bf16x3"
                               else "f32"),
                ).T
            rhat_f, vr_f = _frame_geometry(
                p3, v3, tuple(rows_soa[:3]), tuple(rows_soa[3:]),
                hubble_drag, box_size,
            )
        rhat = tuple(x.reshape(R, W) for x in rhat_f)
        vr = vr_f.reshape(R, W)
        vrb = ((vr < 0).astype(jnp.int32)
               | ((vr > 0).astype(jnp.int32) << 1))

        # FRESH: entered this halo (or just became tracked) — the
        # reference's region-entry reset (track_orbits.py:330-351)
        prev_label = (carry.lab_sv & 0x0FFFFFFF) - 1
        prev_vrb = carry.lab_sv >> 28
        fresh = label != prev_label
        matched = valid & ~fresh & ((carry.packed >> 31) > 0)

        prev_rhat = (
            oct_decode(carry.rhat) if rhat_packed else carry.rhat
        )
        cosang = jnp.clip(
            prev_rhat[0] * rhat[0]
            + prev_rhat[1] * rhat[1]
            + prev_rhat[2] * rhat[2],
            -1.0, 1.0,
        )
        dtheta = jnp.where(matched, acos_f32(cosang), 0.0)
        pang = jax.lax.bitcast_convert_type(
            carry.packed & jnp.uint32(0x7FFFFFFF), jnp.float32
        )
        if pericentric:
            flip = ((prev_vrb & 1) > 0) & ((vrb & 2) > 0)
        else:
            flip = ((prev_vrb & 2) > 0) & ((vrb & 1) > 0)
        apsis = matched & flip
        angle_acc = jnp.where(matched, pang + dtheta, 0.0)
        packed = jax.lax.bitcast_convert_type(
            jnp.where(apsis | ~valid, 0.0, angle_acc), jnp.uint32
        ) | (valid.astype(jnp.uint32) << 31)

        # positional single-payload event extraction (aligned
        # contract); the planes already ARE the [R, W] compaction rows
        pos_iota = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
        ang15 = jax.lax.bitcast_convert_type(
            angle_acc.astype(jnp.float16), jnp.uint16
        ).astype(jnp.uint32)
        payload = jnp.where(
            apsis,
            ((pos_iota + 1).astype(jnp.uint32) << 15) | ang15,
            jnp.uint32(0),
        )
        evpay, count = compact_payload(payload, K)
        ev_pos, ev_ang = decode_payload(evpay)
        kw = ev_pos.shape[1]
        kiota = jax.lax.broadcasted_iota(jnp.int32, (R, kw), 1)
        ev_ok = kiota < count[:, None]
        new_carry = LabelCarry(
            lab_sv=jnp.where(
                valid, (label + 1) | (vrb << 28), jnp.int32(0)
            ),
            rhat=oct_encode(rhat) if rhat_packed else jnp.stack(rhat),
            packed=packed,
        )
        return new_carry, LabelEvents(
            count=count,
            index=jnp.where(
                ev_ok,
                ev_pos + jnp.arange(R, dtype=jnp.int32)[:, None] * W,
                -1,
            ),
            angle=jnp.where(ev_ok, ev_ang, 0.0),
            bulk_vel=bulk,
        )

    return step


def scan_label_events(carry, pos_seq, vel_seq, label_seq, centers_seq,
                      event_capacity: int, mode: str = "pericentric",
                      box_size=None, mass=None, bulk_vel_seq=None,
                      hubble_drag=0.0, row_width: int = 1 << 15,
                      frames: str = "auto", rhat_packed: bool = False):
    """``lax.scan`` of :func:`make_label_orbit_step` over an
    ``[S]``-stacked device-resident sequence: ``pos_seq``/``vel_seq``
    ``[S, 3, N]``, ``label_seq`` ``[S, N]``, ``centers_seq``
    ``[S, H, 3]``.  Returns ``(carry, LabelEvents stacked [S, ...])``.

    The sequences are reshaped to the carry's 2D ``[R, row_width]``
    row planes ONCE here, outside the scan, so the per-step relayout
    the 1D step entry would pay never recurs.
    """
    step = make_label_orbit_step(
        event_capacity, mode=mode, box_size=box_size,
        row_width=row_width, frames=frames, rhat_packed=rhat_packed,
    )
    S = label_seq.shape[0]
    label_seq = jnp.asarray(label_seq)
    if label_seq.ndim == 2:
        n = label_seq.shape[1]
        w_ = min(int(row_width), n)
        if n % w_:
            raise ValueError(
                f"pool size {n} must be a multiple of row_width {w_}")
        r_ = n // w_
        label_seq = label_seq.reshape(S, r_, w_)
        pos_seq = jnp.reshape(jnp.asarray(pos_seq), (S, 3, r_, w_))
        vel_seq = jnp.reshape(jnp.asarray(vel_seq), (S, 3, r_, w_))
        if mass is not None:
            mass = jnp.reshape(jnp.asarray(mass), (r_, w_))
    drag = jnp.broadcast_to(
        jnp.asarray(hubble_drag, jnp.float32), (S,)
    )
    use_bulk = bulk_vel_seq is not None
    bulks = (jnp.zeros((S, 1, 3), jnp.float32) if not use_bulk
             else jnp.asarray(bulk_vel_seq, jnp.float32))

    def body(c, xs):
        s_pos, s_vel, s_label, s_cen, s_bulk, s_drag = xs
        return step(c, (s_pos, s_vel, s_label, s_cen,
                        s_bulk if use_bulk else None, mass, s_drag))

    return jax.lax.scan(
        body, carry,
        (pos_seq, vel_seq, label_seq, centers_seq, bulks, drag),
    )
