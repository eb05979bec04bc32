"""Blocked direct-summation N-body forces in O(N) memory.

The Gram form in :func:`orbitanalysis_tpu.models.nbody.direct_forces`
materializes the full ``[N, N]`` pair matrix, which caps N at a few
tens of thousands.  Two blocked forms replace it beyond that:

- :func:`direct_forces_triton` — a Pallas kernel through Triton: one
  program per target tile loops over source tiles loaded from global
  memory (masked at the ragged end) and keeps ``[T, S]`` acceleration
  accumulators in registers, reduced once at the end.  O(N^2)
  arithmetic, O(N) memory.
- :func:`direct_forces_blocked` — the same tiling in plain XLA:
  ``lax.map`` over target tiles, each a fused ``[T, N]`` pair
  reduction.

Both take positions ``[N, 3]`` and masses ``[N]``; masked (or padded)
sources carry zero mass, so they contribute nothing.  Self-interaction
vanishes because the displacement is exactly zero; ``d^2`` is clamped
below by ``max(softening^2, tiny)`` so the zero-softening self pair is
finite.  ``box_size`` enables per-pair minimum-image wrapping.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_TINY = 1e-18


def _wrap(d, box):
    if box is None:
        return d
    # floor(x + 0.5) instead of round(): the Triton lowering has floor
    return d - box * jnp.floor(d * (1.0 / box) + 0.5)


def _pair_terms(xt, yt, zt, xs, ys, zs, ms, eps2, box):
    """Per-pair acceleration terms ``[T, S]`` of targets ``[T]`` from
    sources ``[S]``."""
    dx = _wrap(xs[None, :] - xt[:, None], box)     # [T, S]
    dy = _wrap(ys[None, :] - yt[:, None], box)
    dz = _wrap(zs[None, :] - zt[:, None], box)
    d2 = jnp.maximum(dx * dx + dy * dy + dz * dz + eps2, _TINY)
    inv = jax.lax.rsqrt(d2)
    w = ms[None, :] * (inv * inv * inv)            # m / d^3
    return w * dx, w * dy, w * dz


def _force_kernel(x_ref, y_ref, z_ref, m_ref, ax_ref, ay_ref, az_ref, *,
                  n, tile_t, tile_s, eps2, box):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    t = pl.program_id(0) * tile_t + jnp.arange(tile_t, dtype=jnp.int32)
    tmask = t < n
    xt = plgpu.load(x_ref.at[t], mask=tmask, other=0.0)
    yt = plgpu.load(y_ref.at[t], mask=tmask, other=0.0)
    zt = plgpu.load(z_ref.at[t], mask=tmask, other=0.0)

    # [T, S] accumulators summed once at the end: no cross-thread
    # reduction inside the source loop
    def body(j, acc):
        s = j * tile_s + jnp.arange(tile_s, dtype=jnp.int32)
        smask = s < n
        xs = plgpu.load(x_ref.at[s], mask=smask, other=0.0)
        ys = plgpu.load(y_ref.at[s], mask=smask, other=0.0)
        zs = plgpu.load(z_ref.at[s], mask=smask, other=0.0)
        ms = plgpu.load(m_ref.at[s], mask=smask, other=0.0)
        tx, ty, tz = _pair_terms(xt, yt, zt, xs, ys, zs, ms, eps2, box)
        return acc[0] + tx, acc[1] + ty, acc[2] + tz

    zero = jnp.zeros((tile_t, tile_s), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(
        0, pl.cdiv(n, tile_s), body, (zero, zero, zero))
    plgpu.store(ax_ref.at[t], jnp.sum(ax, axis=1), mask=tmask)
    plgpu.store(ay_ref.at[t], jnp.sum(ay, axis=1), mask=tmask)
    plgpu.store(az_ref.at[t], jnp.sum(az, axis=1), mask=tmask)


#: Triton launch configuration (target rows per program, source tile
#: width, warps, pipeline stages) — the fastest of the configurations
#: measured on an H100 at N = 16384-262144 (PERF.md).
TRITON_CONFIG = dict(tile_t=16, tile_s=128, num_warps=4, num_stages=2)


@functools.partial(
    jax.jit,
    static_argnames=("softening", "G", "box_size", "interpret", "tile_t",
                     "tile_s", "num_warps", "num_stages"),
)
def direct_forces_triton(pos, mass, softening: float = 0.05, G: float = 1.0,
                         box_size: float | None = None,
                         interpret: bool = False,
                         tile_t: int = TRITON_CONFIG["tile_t"],
                         tile_s: int = TRITON_CONFIG["tile_s"],
                         num_warps: int = TRITON_CONFIG["num_warps"],
                         num_stages: int = TRITON_CONFIG["num_stages"]):
    """Blocked direct-summation acceleration ``[N, 3]`` through a
    Pallas Triton kernel (``interpret=True`` runs it on the CPU)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = pos.shape[0]
    soa = jnp.moveaxis(pos.astype(jnp.float32), -1, 0)        # [3, N]
    kernel = functools.partial(
        _force_kernel, n=n, tile_t=tile_t, tile_s=tile_s,
        eps2=float(softening * softening),
        box=None if box_size is None else float(box_size),
    )
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    ax, ay, az = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, tile_t),),
        out_shape=(out, out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="direct_forces",
    )(soa[0], soa[1], soa[2], mass.astype(jnp.float32))
    return G * jnp.stack([ax, ay, az], axis=-1)


@functools.partial(
    jax.jit, static_argnames=("softening", "G", "box_size", "tile")
)
def direct_forces_blocked(pos, mass, softening: float = 0.05, G: float = 1.0,
                          box_size: float | None = None, tile: int = 256):
    """The plain-XLA blocked form of :func:`direct_forces_triton`:
    ``lax.map`` over target tiles, each one fused ``[tile, N]`` pair
    reduction (zero-mass padding of the ragged last tile)."""
    n = pos.shape[0]
    n_pad = -n % tile
    soa = jnp.moveaxis(pos.astype(jnp.float32), -1, 0)        # [3, N]
    tgt = jnp.pad(soa, ((0, 0), (0, n_pad))).reshape(3, -1, tile)
    m = mass.astype(jnp.float32)
    eps2 = float(softening * softening)
    box = None if box_size is None else float(box_size)

    def one_tile(t):
        terms = _pair_terms(t[0], t[1], t[2], soa[0], soa[1], soa[2], m,
                            eps2, box)
        return jnp.stack([jnp.sum(x, axis=1) for x in terms], axis=-1)

    acc = jax.lax.map(one_tile, jnp.moveaxis(tgt, 1, 0))     # [k, T, 3]
    return G * acc.reshape(-1, 3)[:n]
