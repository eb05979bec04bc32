"""Small numeric utilities shared by host and device code.

Pure-functional JAX counterparts of the reference's ``utils.py`` kernels
(``/root/reference/orbitanalysis/utils.py:4-39``).  These work under ``jit``
and on NumPy arrays alike (the jnp ops accept NumPy inputs), and — unlike
the reference's ``recenter_coordinates`` (``utils.py:31-32``) — never mutate
their inputs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def periodic_displacement(dx, box_size):
    """Minimum-image displacement in a periodic box.

    Maps each component of ``dx`` into ``[-L/2, L/2]`` (branch-free; the
    reference does the same with two conditional shifts per dim,
    ``utils.py:30-32``).  ``box_size`` may be a scalar or a length-3 vector.
    """
    box = jnp.asarray(box_size, dtype=jnp.result_type(dx))
    return dx - box * jnp.round(dx / box)


def recenter_coordinates(position, box_size):
    """Reference-compatible alias: wrap ``position`` into ``[-L/2, L/2]``.

    Pure version of ``utils.py:24-33`` (no in-place mutation).
    """
    return periodic_displacement(position, box_size)


def vector_norm(vectors, return_norm=True, return_unit_vectors=False):
    """Row-wise Euclidean norms and/or unit vectors (``utils.py:14-21``)."""
    vmags = jnp.sqrt(jnp.sum(vectors * vectors, axis=-1))
    if return_norm and return_unit_vectors:
        return vmags, vectors / vmags[..., None]
    if return_norm:
        return vmags
    if return_unit_vectors:
        return vectors / vmags[..., None]
    raise ValueError("must request the norm and/or the unit vectors")


def hubble_parameter(z, H0, Omega_m, Omega_L, Omega_k=0.0):
    """H(z) for a flat-or-curved FLRW cosmology (``utils.py:36-39``)."""
    zp1 = 1.0 + np.asarray(z, dtype=np.float64)
    return H0 * np.sqrt(Omega_m * zp1**3 + Omega_k * zp1**2 + Omega_L)


def myin1d(a, b, kind=None):
    """Indices into ``a`` of the values of ``b``, in ``b``'s order —
    the reference's join helper, re-exported for user analysis scripts
    that call it directly (``/root/reference/orbitanalysis/utils.py:4-11``;
    the engines themselves use sort-merge joins and positional events
    instead).

    Like the reference, every value of ``b`` must be present in ``a``
    and ``a`` must not contain duplicates of those values.  Runs in
    NumPy (host-side bookkeeping; it is not a device kernel).  This
    implementation replaces the reference's ``in1d`` + double-argsort
    with one ``argsort`` + ``searchsorted`` (O((n+m) log n) and no
    boolean scan over ``a``), returning identical results.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    sorter = np.argsort(a, kind="stable")
    return sorter[np.searchsorted(a, b, sorter=sorter)]


def acos_f32(x):
    """float32 arccos to ~2 ulp as a fixed polynomial, so every engine
    (and every backend) computes bit-identical apsis angles.

    Cephes ``asinf`` minimax polynomial with the standard range split:
    ``|x| <= 0.5`` via ``pi/2 - asin(x)``, else
    ``2*asin(sqrt((1-|x|)/2))`` reflected for negative ``x``.
    """
    def asin_poly(v, w):
        p = jnp.float32(4.2163199048e-2)
        p = p * w + jnp.float32(2.4181311049e-2)
        p = p * w + jnp.float32(4.5470025998e-2)
        p = p * w + jnp.float32(7.4953002686e-2)
        p = p * w + jnp.float32(1.6666752422e-1)
        return p * w * v + v

    pi = jnp.float32(np.pi)
    ax = jnp.abs(x)
    t = jnp.float32(0.5) * (jnp.float32(1.0) - ax)
    sq = jnp.sqrt(t)
    big_pos = jnp.float32(2.0) * asin_poly(sq, t)
    acos_big = jnp.where(x < 0, pi - big_pos, big_pos)
    acos_small = jnp.float32(np.pi / 2) - asin_poly(x, x * x)
    return jnp.where(ax > 0.5, acos_big, acos_small)


def f16_bits_rne(x):
    """IEEE f32 -> f16 bit pattern (round-to-nearest-even) for finite
    ``x >= 0``, as uint32, in integer arithmetic.  Matches
    ``bitcast(x.astype(float16), uint16)`` exactly for every finite
    non-negative f32, including f16 subnormals; values above the f16
    range clamp to 0x7BFF (65504.0) instead of inf so the positional
    payload's 15-bit angle field never aliases the position bits."""
    import jax

    u = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = u >> 23  # biased f32 exponent (sign bit 0)
    # normal f16 (e >= 113): fold RNE into one add — carries propagate
    # from the mantissa into the exponent exactly as IEEE requires
    rn = u + 0x0FFF + ((u >> 13) & 1)
    h_norm = (rn - 0x38000000) >> 13
    h_norm = jnp.minimum(h_norm, 0x7BFF)
    # subnormal f16 (e < 113, i.e. x < 2**-14): the f16 subnormal
    # lattice is m * 2**-24, m in [0, 1024), so the bit pattern is
    # RNE(x * 2**24) — an exact power-of-two scale plus round-half-even.
    # x = 2**-14 scales to exactly 1024 = 0x400, the first normal
    # encoding, so the lattice is seamless at the boundary.  Lanes with
    # e >= 113 (including inf/NaN) are zeroed BEFORE the scale so every
    # f32 -> i32 conversion is in range (their result is discarded).
    h_sub = jnp.round(
        jnp.where(e >= 113, jnp.float32(0.0), x) * jnp.float32(16777216.0)
    ).astype(jnp.int32)
    h = jnp.where(e >= 113, h_norm, h_sub)
    return h.astype(jnp.uint32)


def oct_encode(rhat):
    """Octahedral-map unit-vector compression: ``[3, ...]`` f32 ->
    ``[...]`` uint32 (16 bits per octahedral coordinate; measured
    angular error ~1e-4 rad mean, ~7e-4 max at fold edges — the same
    order as the savefile's f16 angle resolution).

    The carry memory diet for billion-particle tracking: the radial
    unit vector is 12 of ~24 carried bytes/particle, and it feeds ONLY
    the angle accumulator (``arccos(r_prev . r_cur)``) — radial-
    velocity signs, hence apsis COUNTS, are recomputed from positions
    every step and cannot be affected by this quantization.
    Zero vectors encode to the +z pole (consumers mask invalid slots).
    """
    x, y, z = rhat[0], rhat[1], rhat[2]
    s = jnp.maximum(jnp.abs(x) + jnp.abs(y) + jnp.abs(z), 1e-30)
    px, py = x / s, y / s
    fx = (1.0 - jnp.abs(py)) * jnp.where(px >= 0, 1.0, -1.0)
    fy = (1.0 - jnp.abs(px)) * jnp.where(py >= 0, 1.0, -1.0)
    px = jnp.where(z < 0, fx, px)
    py = jnp.where(z < 0, fy, py)
    qx = jnp.clip(
        jnp.round((px * 0.5 + 0.5) * 65535.0), 0, 65535
    ).astype(jnp.uint32)
    qy = jnp.clip(
        jnp.round((py * 0.5 + 0.5) * 65535.0), 0, 65535
    ).astype(jnp.uint32)
    return qx | (qy << 16)


def oct_decode(packed):
    """Inverse of :func:`oct_encode`: uint32 -> normalized ``[3, ...]``."""
    qx = (packed & jnp.uint32(0xFFFF)).astype(jnp.float32)
    qy = (packed >> 16).astype(jnp.float32)
    px = qx * (2.0 / 65535.0) - 1.0
    py = qy * (2.0 / 65535.0) - 1.0
    z = 1.0 - jnp.abs(px) - jnp.abs(py)
    t = jnp.maximum(-z, 0.0)
    x = px - jnp.where(px >= 0, t, -t)
    y = py - jnp.where(py >= 0, t, -t)
    inv = 1.0 / jnp.maximum(jnp.sqrt(x * x + y * y + z * z), 1e-30)
    return jnp.stack([x * inv, y * inv, z * inv])
