"""Particle-mesh solver: deposit/interp consistency, inverse-square law
at resolved separations, momentum conservation, and PM-driven tracking."""

import jax.numpy as jnp
import numpy as np
import pytest

from orbitanalysis_tpu.models.pm import (
    cic_deposit,
    cic_deposit_rows,
    cic_interpolate,
    cic_interpolate_cells,
    cic_interpolate_rows,
    make_pm_force_fn,
    pm_forces,
)


def test_cic_rows_forms_match_scalar_forms(rng):
    """The corner-table row deposit/interp must agree with the classic
    8-scatter/24-gather forms everywhere, including cell boundaries and
    the periodic wrap seam."""
    n, grid, box = 4096, 16, 10.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    h = box / grid
    pos[:12] = np.array([
        [0.0, 0.0, 0.0],
        [box - 1e-4, box - 1e-4, box - 1e-4],
        [box / 2, 0.0, box - 0.01],
        [h / 2, h / 2, h / 2],          # exact cell center
        [h, h, h],                      # exact cell boundary
        [box - h / 2, 5.0, 5.0],        # wrap seam (x)
        [5.0, box - h / 2, 5.0],
        [5.0, 5.0, box - h / 2],
        [0.001, box - 0.001, 5.0],
        [2 * h, 3 * h, 4 * h],
        [box / 2, box / 2, box / 2],
        [1e-6, 1e-6, box / 2],
    ], np.float32)
    pos = jnp.asarray(pos)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))

    r_scalar = np.asarray(cic_deposit(pos, mass, grid, box))
    r_rows = np.asarray(cic_deposit_rows(pos, mass, grid, box))
    np.testing.assert_allclose(r_rows, r_scalar, rtol=2e-5, atol=2e-5)
    assert np.isclose(float(r_rows.sum()), float(mass.sum()), rtol=1e-5)

    field = jnp.asarray(rng.normal(size=(3, grid, grid, grid))
                        .astype(np.float32))
    a_scalar = np.asarray(cic_interpolate(field, pos, grid, box))
    a_rows = np.asarray(cic_interpolate_rows(field, pos, grid, box))
    np.testing.assert_allclose(a_rows, a_scalar, rtol=2e-5, atol=2e-5)

    f_scalar = np.asarray(pm_forces(pos, mass, grid, box,
                                    assignment="scalar"))
    f_rows = np.asarray(pm_forces(pos, mass, grid, box, assignment="rows"))
    scale = np.abs(f_scalar).max()
    np.testing.assert_allclose(f_rows, f_scalar, atol=1e-4 * scale)


def test_cic_cells_matches_scalar_exactly(rng):
    """The supercell-halo interpolation (the 512^3 table diet,
    assignment='cells') is an EXACT re-selection: with an f32 table it
    must reproduce the classic 24-gather form bit-for-bit, for every
    block size including non-divisor fallbacks, at cell boundaries and
    the wrap seam."""
    n, grid, box = 4096, 16, 10.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    h = box / grid
    pos[:8] = np.array([
        [0.0, 0.0, 0.0],
        [box - 1e-4, box - 1e-4, box - 1e-4],
        [h / 2, h / 2, h / 2],
        [h, h, h],
        [box - h / 2, 5.0, 5.0],
        [5.0, box - h / 2, 5.0],
        [5.0, 5.0, box - h / 2],
        [2 * h, 3 * h, 4 * h],
    ], np.float32)
    pos = jnp.asarray(pos)
    field = jnp.asarray(rng.normal(size=(3, grid, grid, grid))
                        .astype(np.float32))
    a_scalar = np.asarray(cic_interpolate(field, pos, grid, box))
    for block in (4, 2, 1, 3):   # 3 does not divide 16 -> falls to 1
        a_cells = np.asarray(cic_interpolate_cells(
            field, pos, grid, box, block=block,
            table_dtype=jnp.float32))
        np.testing.assert_allclose(
            a_cells, a_scalar, rtol=2e-6, atol=2e-6)
    # bf16 table: stored-value precision only
    a16 = np.asarray(cic_interpolate_cells(
        field, pos, grid, box, table_dtype=jnp.bfloat16))
    scale = np.abs(a_scalar).max()
    np.testing.assert_allclose(a16, a_scalar, atol=8e-3 * scale)
    # the pm_forces policy string routes here
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    f_scalar = np.asarray(pm_forces(pos, mass, grid, box,
                                    assignment="scalar"))
    f_cells = np.asarray(pm_forces(pos, mass, grid, box,
                                   assignment="cells"))
    np.testing.assert_allclose(
        f_cells, f_scalar, atol=1e-4 * np.abs(f_scalar).max())


def test_cic_rows_bf16_table_close(rng):
    """A bfloat16 corner table (the 512^3 memory diet,
    cic_interpolate_rows(table_dtype=bfloat16)) costs only stored-value
    precision: interpolated accelerations stay within bf16 relative
    tolerance of the f32 form, and the f32 default is unchanged."""
    import jax.numpy as jnp

    n, grid, box = 4096, 16, 10.0
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    field = jnp.asarray(rng.normal(size=(3, grid, grid, grid))
                        .astype(np.float32))
    a32 = np.asarray(cic_interpolate_rows(
        field, pos, grid, box, table_dtype=jnp.float32))
    a_auto = np.asarray(cic_interpolate_rows(field, pos, grid, box))
    np.testing.assert_array_equal(a_auto, a32)  # auto keeps f32 here
    a16 = np.asarray(cic_interpolate_rows(
        field, pos, grid, box, table_dtype=jnp.bfloat16))
    assert a16.dtype == np.float32
    scale = np.abs(a32).max()
    np.testing.assert_allclose(a16, a32, atol=8e-3 * scale)


def test_cic_deposit_conserves_mass(rng):
    n, grid, box = 500, 32, 50.0
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    rho = cic_deposit(pos, mass, grid, box)
    assert np.isclose(float(rho.sum()), float(mass.sum()), rtol=1e-5)


def test_cic_interpolate_constant_field(rng):
    n, grid, box = 200, 16, 10.0
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    field = jnp.stack([
        jnp.full((grid,) * 3, 1.5),
        jnp.full((grid,) * 3, -2.0),
        jnp.full((grid,) * 3, 0.25),
    ])
    vals = np.asarray(cic_interpolate(field, pos, grid, box))
    assert np.allclose(vals, np.array([1.5, -2.0, 0.25]), atol=1e-5)


def test_pm_inverse_square_two_body():
    """Force between two particles at resolved separation matches
    -G m / r^2 to PM accuracy (a few percent)."""
    grid, box = 64, 100.0
    h = box / grid
    # Separations chosen image-free (r << box/2, so the periodic images
    # contribute <1%); undeconvolved CIC+spectral-gradient PM is percent-
    # level above ~6 cells
    for r, tol in ((6 * h, 0.05), (8 * h, 0.04), (10 * h, 0.03)):
        pos = jnp.asarray(np.array(
            [[50.0, 50.0, 50.0], [50.0 + r, 50.0, 50.0]], np.float32
        ))
        mass = jnp.asarray(np.array([1.0, 1.0], np.float32))
        acc = np.asarray(pm_forces(pos, mass, grid, box, G=1.0))
        expect = 1.0 / r**2
        # particle 0 pulled toward +x, particle 1 toward -x
        assert acc[0, 0] == pytest.approx(expect, rel=tol), r
        assert acc[1, 0] == pytest.approx(-expect, rel=tol), r
        # transverse components negligible
        assert np.abs(acc[:, 1:]).max() < 0.05 * expect


def test_pm_momentum_conservation(rng):
    n, grid, box = 300, 32, 50.0
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    acc = np.asarray(pm_forces(pos, mass, grid, box))
    total = (np.asarray(mass)[:, None] * acc).sum(0)
    scale = np.abs(np.asarray(mass)[:, None] * acc).sum(0).max()
    assert np.abs(total).max() < 1e-3 * scale


def test_pm_driven_tracking_runs():
    """simulate_with_tracking with the PM force on a periodic box."""
    from orbitanalysis_tpu.models.nbody import (
        NBodyState, OrbitNBodyConfig, simulate_with_tracking,
    )

    rng = np.random.default_rng(4)
    n, grid, box = 256, 32, 50.0
    # cold clump + orbiting shell around the box center
    center = np.full(3, box / 2, np.float32)
    pos = center + rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    state = NBodyState(
        pos=jnp.asarray(np.mod(pos, box)),
        vel=jnp.asarray(vel),
        mass=jnp.full((n,), 1.0 / n, jnp.float32),
    )
    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(
        dt=0.1, n_steps=50, detect_every=5, mode="pericentric",
        box_size=box, softening=0.0,
    )
    final, track, events = simulate_with_tracking(
        state, members, cfg, force_fn=make_pm_force_fn(grid)
    )
    assert np.isfinite(np.asarray(final.pos)).all()
    assert np.isfinite(np.asarray(track.angles)).all()
    assert np.asarray(track.counts).min() >= 0


@pytest.mark.slow
def test_sharded_pm_grid_matches_single_device(rng):
    """Pencil-decomposed FFT solve == single-device solve on the
    virtual CPU mesh (2/4/8-way)."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.pm import cic_deposit, pm_forces_grid
    from orbitanalysis_tpu.models.pm_sharded import (
        make_sharded_pm_grid_solver,
    )
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 2000
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    rho = cic_deposit(pos, mass, grid, box)
    ref = np.asarray(pm_forces_grid(rho, grid, box))
    for d in (2, 4, 8):
        solve = make_sharded_pm_grid_solver(make_mesh({"x": d}), grid)
        got = np.asarray(solve(rho, box))
        assert np.abs(got - ref).max() < 1e-4 * (np.abs(ref).max() + 1e-12)

    with _pytest.raises(ValueError):
        make_sharded_pm_grid_solver(make_mesh({"x": 8}), grid=36)


@pytest.mark.slow
def test_sharded_pm_force_path_matches_single_device(rng):
    """Particle-sharded deposit -> pencil solve -> interp == the
    single-device pm_forces, including through the fused integrator."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.nbody import (
        NBodyState, OrbitNBodyConfig, simulate_with_tracking,
    )
    from orbitanalysis_tpu.models.pm_sharded import make_sharded_pm_force_fn
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 2048
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    ref = np.asarray(pm_forces(pos, mass, grid, box))
    f8 = make_sharded_pm_force_fn(make_mesh({"x": 8}), grid)
    got = np.asarray(f8(pos, mass, box_size=box))
    assert np.abs(got - ref).max() < 1e-4 * (np.abs(ref).max() + 1e-12)

    st = NBodyState(
        pos, jnp.asarray(rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)),
        mass,
    )
    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(dt=0.1, n_steps=8, detect_every=2, box_size=box)
    _, tr, _ = simulate_with_tracking(st, members, cfg, force_fn=f8)
    _, tr2, _ = simulate_with_tracking(
        st, members, cfg, force_fn=make_pm_force_fn(grid)
    )
    assert np.array_equal(np.asarray(tr.counts), np.asarray(tr2.counts))

    with _pytest.raises(ValueError):
        f8(pos[:100], mass[:100], box_size=box)  # 100 % 8 != 0


def test_slab_resident_pm_matches_single_device(rng):
    """Grid-resident distributed PM (particle routing + slab deposit +
    halo exchange + slab interp) == single-device pm_forces."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 4096
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    ref = np.asarray(pm_forces(pos, mass, grid, box))
    for d in (2, 8):
        f = make_slab_resident_pm_force_fn(make_mesh({"x": d}), grid)
        got = np.asarray(jax.jit(
            lambda p, m: f(p, m, box_size=box)
        )(pos, mass))
        assert np.abs(got - ref).max() < 2e-4 * (np.abs(ref).max() + 1e-12), d

    # occupancy helper covers every slab; uniform data stays within the
    # default bucket factor
    f8 = make_slab_resident_pm_force_fn(make_mesh({"x": 8}), grid)
    occ = f8.slab_occupancy(np.asarray(pos), box)
    assert occ.sum() == n and len(occ) == 8


@pytest.mark.slow
def test_slab_resident_pm_through_integrator(rng):
    """Fused integrator counts identical with the slab-resident force."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.nbody import (
        NBodyState, OrbitNBodyConfig, simulate_with_tracking,
    )
    from orbitanalysis_tpu.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 2048
    pos = jnp.asarray(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    st = NBodyState(
        pos, jnp.asarray(rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)),
        mass,
    )
    members = jnp.arange(n, dtype=jnp.int32).reshape(1, n)
    cfg = OrbitNBodyConfig(dt=0.1, n_steps=8, detect_every=2, box_size=box)
    f8 = make_slab_resident_pm_force_fn(make_mesh({"x": 8}), grid)
    _, tr, _ = simulate_with_tracking(st, members, cfg, force_fn=f8)
    _, tr2, _ = simulate_with_tracking(
        st, members, cfg, force_fn=make_pm_force_fn(grid)
    )
    assert np.array_equal(np.asarray(tr.counts), np.asarray(tr2.counts))


@pytest.mark.slow
def test_slab_resident_pm_overflow_is_loud(rng):
    """Bucket overflow must surface as NaN forces, never silent zeros."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 2048
    # all particles in one thin X-slab: every bucket but one overflows
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    pos[:, 0] = rng.uniform(0, box / 16, size=n)
    mass = np.ones(n, np.float32)
    f = make_slab_resident_pm_force_fn(
        make_mesh({"x": 8}), grid, bucket_factor=1.0
    )
    acc = np.asarray(f(jnp.asarray(pos), jnp.asarray(mass), box_size=box))
    assert np.isnan(acc).any(), "overflow must produce NaN forces"


def test_slab_resident_rows_interp_matches_scalar(rng):
    """The slab's folded row-gather interpolation (assignment='rows')
    must match the scalar slab path AND single-device pm_forces,
    including particles whose +x corner reads the ppermute'd halo
    plane."""
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 (virtual) devices")

    from orbitanalysis_tpu.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu.parallel.mesh import make_mesh

    grid, box, n = 32, 50.0, 4096
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    # pin some particles just inside slab upper boundaries (loc=4 cells
    # per slab at d=8) so dx=1 reads the halo plane
    h = box / grid
    pos[:64, 0] = (np.arange(64) % 8) * (box / 8) + 3.9 * h
    pos = jnp.asarray(pos)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
    ref = np.asarray(pm_forces(pos, mass, grid, box, assignment="scalar"))
    mesh = make_mesh({"x": 8})
    f_rows = make_slab_resident_pm_force_fn(mesh, grid, assignment="rows")
    f_scal = make_slab_resident_pm_force_fn(mesh, grid,
                                            assignment="scalar")
    got_r = np.asarray(jax.jit(lambda p, m: f_rows(p, m, box_size=box))(
        pos, mass))
    got_s = np.asarray(jax.jit(lambda p, m: f_scal(p, m, box_size=box))(
        pos, mass))
    scale = np.abs(ref).max() + 1e-12
    assert np.abs(got_r - got_s).max() < 1e-5 * scale
    assert np.abs(got_r - ref).max() < 2e-4 * scale


def test_rows_interpolation_empty_particles():
    """Zero particles must yield an empty (0, 3) result, like the
    scalar form (regression: ZeroDivisionError in the chunking)."""
    grid, box = 8, 4.0
    pos = jnp.zeros((0, 3), jnp.float32)
    field = jnp.zeros((3, grid, grid, grid), jnp.float32)
    out = np.asarray(cic_interpolate_rows(field, pos, grid, box))
    assert out.shape == (0, 3)
    mass = jnp.zeros((0,), jnp.float32)
    f = np.asarray(pm_forces(pos, mass, grid, box, assignment="rows"))
    assert f.shape == (0, 3)


def _bincount_cic(pos, mass, grid, box):
    """float64 CIC deposit by np.bincount (an independent reference)."""
    h = box / grid
    x = pos.astype(np.float64) / h - 0.5
    i0 = np.floor(x)
    f = x - i0
    i0 = i0.astype(np.int64)
    rho = np.zeros(grid ** 3)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                idx = ((((i0[:, 0] + dx) % grid) * grid
                        + (i0[:, 1] + dy) % grid) * grid
                       + (i0[:, 2] + dz) % grid)
                rho += np.bincount(idx, weights=w * mass,
                                   minlength=grid ** 3)
    return rho.reshape(grid, grid, grid)


@pytest.mark.parametrize("grid", [8, 16, 33])
def test_cic_deposit_matches_bincount(rng, grid):
    """The scatter-add deposit equals a float64 np.bincount CIC, with a
    third of the particles within half a cell of the box faces (their
    clouds straddle the periodic wrap seam)."""
    box, n = 40.0, 3000
    pos = rng.uniform(0, box, size=(n, 3))
    seam = rng.random(n) < 0.33
    h = box / grid
    pos[seam] = np.where(
        rng.random((seam.sum(), 3)) < 0.5,
        rng.uniform(0, 0.5 * h, (seam.sum(), 3)),
        rng.uniform(box - 0.5 * h, box, (seam.sum(), 3)),
    )
    pos = np.mod(pos, box).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    got = np.asarray(cic_deposit(jnp.asarray(pos), jnp.asarray(mass),
                                 grid, box))
    want = _bincount_cic(pos, mass.astype(np.float64), grid, box)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.sum(), mass.astype(np.float64).sum(),
                               rtol=1e-5)


def test_gradient_drops_nyquist_planes():
    """The spectral gradient is zero on the Nyquist planes (even grids)
    and equal to 2*pi*freq elsewhere."""
    from orbitanalysis_tpu.models.pm import gradient_wavenumbers

    kx, ky, kz = gradient_wavenumbers(8)
    assert kx.shape == (8, 1, 1) and kz.shape == (1, 1, 5)
    assert kx[4, 0, 0] == 0 and ky[0, 4, 0] == 0 and kz[0, 0, 4] == 0
    np.testing.assert_allclose(kx[1, 0, 0], 2 * np.pi / 8)
    np.testing.assert_allclose(kx[7, 0, 0], -2 * np.pi / 8)
    kx9, _, kz9 = gradient_wavenumbers(9)   # odd grids have no Nyquist
    assert (kx9 != 0).sum() == 8 and (kz9 != 0).sum() == 4
