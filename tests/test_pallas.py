"""Blocked direct forces: the Triton kernel (in interpret mode here; the
compiled kernel runs on the GPU in ``chip_smoke.py``) and the plain-XLA
blocked form, against the Gram form and a float64 NumPy pair sum."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu.models.nbody import direct_forces
from orbitanalysis_tpu.ops.pallas_nbody import (
    direct_forces_blocked,
    direct_forces_triton,
)

IMPLS = {
    # small tiles keep the interpreter quick and make N ragged
    "triton": functools.partial(direct_forces_triton, interpret=True,
                                tile_t=32, tile_s=64),
    "xla": functools.partial(direct_forces_blocked, tile=128),
}


def _numpy_forces(pos, mass, softening, box=None):
    """float64 pair sum with the same softening and clamp."""
    p = pos.astype(np.float64)
    d = p[None, :, :] - p[:, None, :]
    if box is not None:
        d -= box * np.round(d / box)
    d2 = np.maximum((d ** 2).sum(-1) + softening ** 2, 1e-18)
    w = mass.astype(np.float64)[None, :] / d2 ** 1.5
    return (w[..., None] * d).sum(1)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("n", [257, 1000])
def test_blocked_forces_match_gram(rng, n, impl):
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a1 = np.asarray(IMPLS[impl](jnp.asarray(pos), jnp.asarray(mass),
                                softening=0.1))
    a2 = np.asarray(direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                  softening=0.1))
    rel = np.abs(a1 - a2) / (
        np.linalg.norm(a2, axis=1, keepdims=True) + 1e-3
    )
    assert rel.max() < 1e-3
    ref = _numpy_forces(pos, mass, 0.1)
    assert np.linalg.norm(a1 - ref) / np.linalg.norm(ref) < 1e-5


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_blocked_forces_zero_mass_padding_invariance(rng, impl):
    """Appending zero-mass particles must not change existing forces."""
    n = 300
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    f = IMPLS[impl]
    a1 = np.asarray(f(jnp.asarray(pos), jnp.asarray(mass), softening=0.1))
    pos2 = np.concatenate([pos, rng.normal(size=(50, 3)).astype(np.float32)])
    mass2 = np.concatenate([mass, np.zeros(50, np.float32)])
    a2 = np.asarray(f(jnp.asarray(pos2), jnp.asarray(mass2),
                      softening=0.1))[:n]
    assert np.allclose(a1, a2, atol=1e-5)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_blocked_forces_periodic(rng, impl):
    n, box = 400, 10.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a1 = np.asarray(IMPLS[impl](jnp.asarray(pos), jnp.asarray(mass),
                                softening=0.2, box_size=box))
    a2 = np.asarray(direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                  softening=0.2, box_size=box))
    rel = np.abs(a1 - a2) / (
        np.linalg.norm(a2, axis=1, keepdims=True) + 1e-3
    )
    assert rel.max() < 1e-3
    ref = _numpy_forces(pos, mass, 0.2, box=box)
    assert np.linalg.norm(a1 - ref) / np.linalg.norm(ref) < 1e-5


def test_direct_force_fn_uses_policy_form(rng):
    """``make_direct_force_fn(use_pallas=True)`` runs the blocked form
    the policy names for this platform (the plain-XLA form off the GPU
    — never the interpreter) and matches the Gram form."""
    from orbitanalysis_tpu.models.nbody import make_direct_force_fn
    from orbitanalysis_tpu.policy import direct_force_impl

    assert direct_force_impl("cpu") == "xla"
    assert direct_force_impl("gpu") == "triton"
    n = 200
    pos = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    a1 = np.asarray(make_direct_force_fn(use_pallas=True)(
        pos, mass, softening=0.1))
    a2 = np.asarray(direct_forces(pos, mass, softening=0.1))
    np.testing.assert_allclose(a1, a2, rtol=1e-4, atol=1e-4)
