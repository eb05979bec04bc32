"""Offline multi-snapshot orbit tracking — the primary entry point.

Accelerator-native re-design of the reference driver
(``/root/reference/orbitanalysis/track_orbits.py:9-244``).  The user-facing
contract is kept: the same ``regions`` / ``load_snapshot_data`` callback
pair (``track_orbits.py:27-61``), the same savefile schema, the same
checkpoint/resume semantics.  What changed is everything between the
callbacks and the file:

- all halos advance together in one fused jit'd device step
  (:mod:`orbitanalysis_tpu.ops.apsis`) instead of a per-halo process pool
  (``track_orbits.py:189-194``);
- per-particle state (ids, r_hat, v_r, angles — the reference's ``*_prev``
  arrays, ``track_orbits.py:234-240``) stays resident on device between
  snapshots; the host only ships the next snapshot in and compact event
  masks out;
- ragged regions are capacity-padded to a static ``[n_halos, capacity]``
  layout (grown and re-jitted on overflow);
- a device mesh can be supplied to shard the halo axis
  (:mod:`orbitanalysis_tpu.parallel`).

``npool`` is accepted for drop-in API compatibility and ignored — halo
parallelism is the device mesh now.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbitanalysis_tpu.engine import io_hdf5
from orbitanalysis_tpu.engine.packing import (
    SLOT_MASK,
    PackedSnapshot,
    StableLayout,
    pack_snapshot,
    pack_snapshot_aligned,
    required_capacity,
)
from orbitanalysis_tpu.ops.apsis import (
    Carry,
    SnapshotBatch,
    init_carry,
    make_orbit_step,
    make_static_orbit_step,
)
from orbitanalysis_tpu.ops.sorted_step import (
    MAX_ROW_CAPACITY,
    AlignedCarry,
    SortedCarry,
    decode_aligned_carry,
    init_aligned_carry,
    init_sorted_carry,
    make_aligned_native_step,
    make_sorted_orbit_step,
)
from orbitanalysis_tpu.utils.metrics import Metrics, phase_timer, trace
from orbitanalysis_tpu.utils.numerics import hubble_parameter
from orbitanalysis_tpu.utils.padding import (
    invalid_id_for,
    pack_ragged,
    round_up,
    round_up_pow2,
    unpack_mask,
)


def _normalize_inputs(snapshot_numbers, main_branches):
    main_branches = np.asarray(main_branches)
    if main_branches.ndim == 1:
        main_branches = main_branches[:, None]
    snapshot_numbers = np.asarray(snapshot_numbers)
    if len(main_branches) != len(snapshot_numbers):
        raise ValueError(
            "Number of halo main branch nodes does not equal the number of "
            "snapshot numbers supplied. Must have len(main_branches) == "
            "len(snapshot_numbers)."
        )
    order = np.argsort(snapshot_numbers)
    return snapshot_numbers[order], main_branches[order]


def _fetch_host(x):
    """``np.asarray`` that also handles multi-process-sharded arrays.

    In a multi-host mesh run every process owns only its halo-row
    shards; the savefile is single-writer (reference semantics,
    ``track_orbits.py:366-397``), so device results are gathered to
    every host (XLA all-gather over ICI/DCN via ``process_allgather``)
    and process 0 writes.  Collective: every process must call this at
    the same point — all fetch sites in the tracker do.
    """
    import jax as _jax

    if isinstance(x, _jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@functools.partial(jax.jit, static_argnames=("kf",))
def _slice_cols(x, kf):
    """Column-prefix slice as an SPMD program (eager slicing of a
    non-addressable global array is not allowed)."""
    return x[:, :kf]


def _call_regions(regions, snapshot_number, halo_ids):
    """Accept both 2- and 3-tuple ``regions`` returns (the reference is
    internally inconsistent here — docstring/example return 2 values,
    the engine unpacks 3; ``track_orbits.py:27-34`` vs ``:118-119``)."""
    out = regions(snapshot_number, halo_ids)
    if len(out) == 3:
        positions, radii, bulk_vels = out
    else:
        positions, radii = out
        bulk_vels = None
    return (
        np.atleast_2d(np.asarray(positions)),
        np.atleast_1d(np.asarray(radii)),
        None if bulk_vels is None else np.atleast_2d(np.asarray(bulk_vels)),
    )


def _load_item(regions, load_snapshot_data, halo_ids, snapshot_number):
    """Run both user callbacks for one snapshot; ``None`` payload means
    nothing to process (no live branches / empty load)."""
    rows = np.argwhere(np.asarray(halo_ids) != -1).flatten()
    if len(rows) == 0:
        return rows, None
    region_positions, region_radii, region_bulk_vels = _call_regions(
        regions, snapshot_number, halo_ids[rows]
    )
    snapshot = load_snapshot_data(
        snapshot_number, region_positions, region_radii
    )
    return rows, (region_positions, region_radii, region_bulk_vels, snapshot)


class _SnapshotFeed:
    """Snapshot ingestion, optionally prefetched on a background thread.

    The reference loads each snapshot synchronously inside the time loop
    (``track_orbits.py:118-122``); here the callback I/O for snapshot
    s+1 runs while the host packs/writes snapshot s and the device
    computes it — the load latency drops off the critical path.  Calls
    into the user callbacks stay strictly sequential (one at a time, in
    snapshot order, from a single thread), so no new thread-safety
    demands are placed on them.  A loader exception is re-delivered at
    the iteration that requested the snapshot, exactly like the
    synchronous path, and halts prefetching.
    """

    def __init__(self, items, regions, load_snapshot_data, depth: int):
        self._items = items
        self._regions = regions
        self._load = load_snapshot_data
        self._depth = depth
        self._queue = None
        self._stop = None
        self._thread = None
        self._next = 0
        if depth > 0 and len(items) > 1:
            import queue
            import threading

            self._queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="orbit-snapshot-prefetch", daemon=True
            )
            self._thread.start()

    def _run(self):
        for halo_ids, snapshot_number in self._items:
            if self._stop.is_set():
                return
            try:
                out = (None, _load_item(self._regions, self._load,
                                        halo_ids, snapshot_number))
            except BaseException as exc:  # re-raised on the main thread
                out = (exc, None)
            while not self._stop.is_set():
                try:
                    self._queue.put(out, timeout=0.1)
                    break
                except Exception:  # queue.Full
                    continue
            if out[0] is not None:
                return

    def get(self, index: int):
        """Blocking fetch of item ``index`` (must be called in order)."""
        assert index == self._next, "feed consumed out of order"
        self._next += 1
        if self._thread is None:
            halo_ids, snapshot_number = self._items[index]
            return _load_item(self._regions, self._load,
                              halo_ids, snapshot_number)
        exc, payload = self._queue.get()
        if exc is not None:
            self.close()
            raise exc
        return payload

    def close(self):
        if self._thread is not None:
            self._stop.set()
            # unblock a put() stuck on a full queue, then reap
            try:
                while True:
                    self._queue.get_nowait()
            except Exception:
                pass
            self._thread.join(timeout=5)
            self._thread = None


class _DeviceEngine:
    """Owns the device carry + the jitted step instances (one per shape /
    input-structure combination)."""

    def __init__(self, n_halos, capacity, mode, box_size, id_dtype, angle_dtype,
                 sharding=None, event_capacity=None, join="general"):
        self.n_halos = n_halos
        self.capacity = capacity
        # on-device event compaction: hosts fetch [H, K] event lists
        # instead of [H, P] masks; K sized for the rare-event regime with
        # a full-mask fallback on overflow.  The sorted engine sizes its
        # event buffer to the full capacity (overflow-free) and fetches
        # count-bounded slices instead.
        self.event_capacity = min(
            event_capacity
            if event_capacity is not None
            else max(128, round_up(capacity // 16, 128)),
            capacity,
        )
        self.mode = mode
        self.box_size = box_size
        self.id_dtype = id_dtype
        self.angle_dtype = angle_dtype
        self.invalid = invalid_id_for(id_dtype)
        # Wide (64-bit) IDs on the aligned engine ride a 32-bit
        # *position surrogate* on device: the stable layout makes
        # detection purely positional, so the device never needs the
        # real ID — the tracker stages iota-at-valid-positions as the
        # ID channel and maps event positions back through the staged
        # (host-side) wide-ID table at write time.  No x64, no 64-bit
        # device sorts; full flagship throughput for Gadget uint64 IDs.
        self.surrogate = (
            join == "aligned" and np.dtype(id_dtype).itemsize == 8
        )
        self._dev_id_dtype = np.int32 if self.surrogate else id_dtype
        self._dev_invalid = invalid_id_for(self._dev_id_dtype)
        self.sharding = sharding
        self.join = join
        if (
            join in ("sorted", "aligned")
            and sharding is not None
            and "particles" in sharding.axis_names
        ):
            raise ValueError(
                f"join_impl={join!r} shards the halo axis only (the step "
                "needs whole particle rows per device); use a mesh "
                "without a 'particles' axis or join_impl='general'"
            )
        self._steps = {}
        if join == "aligned":
            # carry-native: 32-bit IDs / f32 angles enforced at step
            # construction; the channels are packed formats
            self.carry = self._place(init_aligned_carry(n_halos, capacity))
        else:
            init = init_sorted_carry if join == "sorted" else init_carry
            self.carry = self._place(init(
                n_halos, capacity, id_dtype=id_dtype,
                angle_dtype=angle_dtype,
            ))

    def _place(self, tree):
        if self.sharding is None:
            return tree
        from orbitanalysis_tpu.parallel.sharding import shard_tree
        return shard_tree(tree, self.sharding)

    def _step_fn(self, has_mass, has_bulk, static=False):
        key = (self.capacity, self.event_capacity, has_mass, has_bulk,
               static)
        if key not in self._steps:
            if self.join == "sorted":
                # event buffer sized to capacity so it can never
                # overflow (hosts fetch count-bounded slices); events
                # come back in previous-snapshot load order
                kw = dict(
                    mode=self.mode,
                    box_size=self.box_size,
                    id_dtype=self.id_dtype,
                    angle_dtype=self.angle_dtype,
                )
                if self.sharding is not None:
                    # the mesh path is an explicit halo-axis shard_map
                    from orbitanalysis_tpu.parallel.sorted_sharded import (
                        make_sharded_sorted_step,
                    )
                    raw = make_sharded_sorted_step(
                        self.sharding, self.capacity, **kw
                    )
                else:
                    raw = make_sorted_orbit_step(self.capacity, **kw)
            elif self.join == "aligned":
                # stable-layout staging: no device-side join at all.
                # The event buffer is BOUNDED (self.event_capacity,
                # default capacity//16), and overflow is lossless: the
                # step also emits the full pre-compaction payload
                # plane, from which the writer recovers every event
                # exactly and then grows the event capacity for
                # subsequent snapshots.
                kw = dict(
                    mode=self.mode,
                    box_size=self.box_size,
                    id_dtype=self._dev_id_dtype,
                    angle_dtype=self.angle_dtype,
                    emit_payload=True,
                )
                if self.sharding is not None:
                    from orbitanalysis_tpu.parallel.sorted_sharded import (
                        make_sharded_aligned_step,
                    )
                    raw = make_sharded_aligned_step(
                        self.sharding, self.event_capacity, **kw
                    )
                else:
                    raw = make_aligned_native_step(
                        self.event_capacity, **kw
                    )
            else:
                make = make_static_orbit_step if static else make_orbit_step
                raw = make(
                    mode=self.mode,
                    box_size=self.box_size,
                    id_dtype=self.id_dtype,
                    angle_dtype=self.angle_dtype,
                    event_capacity=self.event_capacity,
                )
            self._steps[key] = jax.jit(raw, donate_argnums=(0,))
        return self._steps[key]

    def grow(self, new_capacity):
        """Re-pad the carry's particle axis (rare; triggers a re-jit)."""
        if self.join in ("sorted", "aligned"):
            # power-of-two rows: growth re-jits at few distinct shapes
            new_capacity = max(round_up_pow2(new_capacity), 128)
            if new_capacity > MAX_ROW_CAPACITY:
                raise ValueError(
                    f"region growth needs capacity {new_capacity}, beyond "
                    f"the {self.join} engine's per-row ceiling "
                    f"({MAX_ROW_CAPACITY}); re-run with "
                    "join_impl='general' (resume=True continues from the "
                    "savefile)"
                )
        else:
            new_capacity = round_up(new_capacity, 128)
        pad = new_capacity - self.capacity
        if pad <= 0:
            return
        c = jax.tree.map(_fetch_host, self.carry)
        if self.join == "aligned":
            # native channels pad directly: sentinel keys, appended
            # slot numbers (keeps each row's slot permutation), zero
            # rhat/angle planes
            h = c.key.shape[0]
            inv_key = (
                np.uint32(self._dev_invalid) << np.uint32(1)
            ) | np.uint32(1)
            grown = AlignedCarry(
                key=np.pad(np.asarray(c.key), ((0, 0), (0, pad)),
                           constant_values=inv_key),
                sv=np.concatenate(
                    [
                        np.asarray(c.sv),
                        np.broadcast_to(
                            np.arange(self.capacity, new_capacity,
                                      dtype=np.int32),
                            (h, pad),
                        ),
                    ],
                    axis=1,
                ),
                rhat=np.pad(np.asarray(c.rhat),
                            ((0, 0), (0, 0), (0, pad))),
                packed=np.pad(np.asarray(c.packed), ((0, 0), (0, pad))),
            )
        elif self.join == "sorted":
            # appended sentinel slots keep each row's slot permutation
            # (and, for the sorted engine, its ID-sortedness)
            h = c.ids.shape[0]
            grown = SortedCarry(
                ids=np.pad(c.ids, ((0, 0), (0, pad)),
                           constant_values=self.invalid),
                slot=np.concatenate(
                    [
                        np.asarray(c.slot),
                        np.broadcast_to(
                            np.arange(self.capacity, new_capacity,
                                      dtype=np.int32),
                            (h, pad),
                        ),
                    ],
                    axis=1,
                ),
                vrb=np.pad(c.vrb, ((0, 0), (0, pad))),
                rhat=np.pad(c.rhat, ((0, 0), (0, 0), (0, pad))),
                angles=np.pad(c.angles, ((0, 0), (0, pad))),
            )
        else:
            grown = Carry(
                ids=np.pad(c.ids, ((0, 0), (0, pad)),
                           constant_values=self.invalid),
                rhat=np.pad(c.rhat, ((0, 0), (0, 0), (0, pad))),
                vrad=np.pad(c.vrad, ((0, 0), (0, pad))),
                angles=np.pad(c.angles, ((0, 0), (0, pad))),
            )
        self.capacity = new_capacity
        # jitted executables for the old capacity are unreachable now
        self._steps.clear()
        self.carry = self._place(grown)

    def grow_events(self, needed: int):
        """Grow the per-halo event-list capacity to the next power of
        two covering ``needed`` (clamped to the particle capacity) and
        drop the jitted steps so the next dispatch re-jits at the new
        width.  The carry is untouched — event capacity is not part of
        the carry layout — so unlike particle-capacity growth this
        costs one compile and nothing else.  Called by the writer
        after it recovers an overflowed snapshot's events from the
        step's full payload plane (no snapshot is ever reprocessed;
        the reference has no static event bound at all,
        ``track_orbits.py:199-217``)."""
        new_k = min(max(round_up_pow2(int(needed)), 128), self.capacity)
        if new_k <= self.event_capacity:
            return
        self.event_capacity = new_k
        self._steps.clear()

    def to_general(self, new_capacity: int, layout_ids=None):
        """Convert this sorted/aligned engine into a fresh general
        engine at ``new_capacity`` (the ``grow_impl='general'`` growth
        path).  The carry is scattered back from its device layout
        (ID-sorted / stable-position) to load-slot layout via the slot
        permutation; the radial-velocity sign bits become ±1.0
        placeholders (detection only ever compares signs,
        ``track_orbits.py:311-314``, so results are unchanged).
        ``layout_ids`` (surrogate engines only): the ``[H, P]``
        stable-position table of real wide IDs — the device carry holds
        position surrogates, so the real IDs come from the host layout.
        Returns ``(general_engine, carry_ids_in_load_order)``.
        """
        assert self.join in ("sorted", "aligned")
        new_capacity = round_up(new_capacity, 128)
        c = jax.tree.map(_fetch_host, self.carry)
        if self.join == "aligned":
            c = decode_aligned_carry(c)
            # the aligned carry is positional (keys hold row positions,
            # never particle IDs) — the real IDs come from the host's
            # staged stable-position table
            if layout_ids is None:
                raise ValueError(
                    "the aligned engine's carry is positional: "
                    "to_general needs the stable layout's ID table "
                    "(layout_ids=)"
                )
            ids_s = np.asarray(layout_ids)
        else:
            ids_s = np.asarray(c.ids)
        slot = np.asarray(c.slot)
        h, p = ids_s.shape
        rhat_s = np.asarray(c.rhat)
        ang_s = np.asarray(c.angles)
        vrb = np.asarray(c.vrb)
        vr_s = (
            ((vrb >> 1) & 1).astype(rhat_s.dtype)
            - (vrb & 1).astype(rhat_s.dtype)
        )
        ids_l = np.full((h, new_capacity), self.invalid, dtype=ids_s.dtype)
        vr_l = np.zeros((h, new_capacity), dtype=rhat_s.dtype)
        ang_l = np.zeros((h, new_capacity), dtype=ang_s.dtype)
        rhat_l = np.zeros((3, h, new_capacity), dtype=rhat_s.dtype)
        np.put_along_axis(ids_l, slot, ids_s, axis=-1)
        np.put_along_axis(vr_l, slot, vr_s, axis=-1)
        np.put_along_axis(ang_l, slot, ang_s, axis=-1)
        np.put_along_axis(
            rhat_l, np.broadcast_to(slot[None], rhat_s.shape), rhat_s,
            axis=-1,
        )
        out = _DeviceEngine(
            self.n_halos, new_capacity, self.mode, self.box_size,
            self.id_dtype, self.angle_dtype, sharding=self.sharding,
            event_capacity=self.event_capacity, join="general",
        )
        out.carry = out._place(
            Carry(ids=jnp.asarray(ids_l), rhat=jnp.asarray(rhat_l),
                  vrad=jnp.asarray(vr_l), angles=jnp.asarray(ang_l))
        )
        return out, ids_l

    def step(self, packed: PackedSnapshot, hubble_drag: float,
             static: bool = False):
        batch = SnapshotBatch(
            ids=packed.ids,
            pos=packed.pos,
            vel=packed.vel,
            center=packed.center,
            mass=packed.mass,
            bulk_vel=packed.bulk_vel,
            hubble_drag=jnp.float32(hubble_drag),
            slot=packed.slot,
        )
        batch = self._place(batch)
        fn = self._step_fn(
            packed.mass is not None,
            packed.bulk_vel is not None,
            static=static and self.join not in ("sorted", "aligned"),
        )
        self.carry, events = fn(self.carry, batch)
        return events

    def set_angles(self, angles_padded: np.ndarray, order=None):
        """Replace the carry's angle state (resume).  ``order`` maps the
        device layout to load slots (``PackedSnapshot.slot``, masked of
        staging flag bits) when the carry is ID-sorted or
        stable-position."""
        if order is not None:
            angles_padded = np.take_along_axis(
                np.asarray(angles_padded), np.asarray(order), axis=-1
            )
        if self.join == "aligned":
            ang = np.ascontiguousarray(angles_padded, dtype=np.float32)
            packed = ang.view(np.uint32) | (
                np.asarray(_fetch_host(self.carry.packed))
                & np.uint32(0x80000000)
            )
            self.carry = self.carry._replace(
                packed=self._place(jnp.asarray(packed))
            )
            return
        self.carry = self.carry._replace(
            angles=self._place(
                jnp.asarray(angles_padded, dtype=self.angle_dtype))
        )

    def angles_host(self) -> np.ndarray:
        """Per-particle angle accumulators on host, in the carry's
        device layout (checkpointing)."""
        if self.join == "aligned":
            packed = np.asarray(_fetch_host(self.carry.packed))
            return (packed & np.uint32(0x7FFFFFFF)).view(np.float32)
        return _fetch_host(self.carry.angles)


class _HashEngine:
    """Hash-sharded particle-pool engine (full-box scale): flat
    (halo, id) records sharded by ``id % n_shards`` over the mesh's
    'shards' axis — see :mod:`orbitanalysis_tpu.parallel.hash_sharded`.
    The churn join is shard-local; per-step collectives are only the
    psum'd bulk-velocity moments."""

    join = "hash"

    def __init__(self, mesh, n_halos, mode, box_size, cap, angle_dtype,
                 id_dtype=np.int32):
        from orbitanalysis_tpu.parallel.hash_sharded import (
            WideIdMap,
            init_hash_carry,
            make_hash_sharded_step,
        )

        self.mesh = mesh
        self.n_shards = int(mesh.shape["shards"])
        self.n_halos = n_halos
        self.mode = mode
        self.box_size = box_size
        self.angle_dtype = angle_dtype
        self.capacity = cap
        self.event_capacity = cap  # event lists span the shard: no overflow
        self.invalid = invalid_id_for(np.int32)
        # wide (64-bit) IDs ride dense int32 handles on device; events
        # unmap to real IDs at write time (loader contract
        # track_orbits.py:44-47).  Handles are persistent, so routing
        # by handle % n_shards is stable across snapshots.
        self.id_map = (
            WideIdMap() if np.dtype(id_dtype).itemsize == 8 else None
        )
        self._make = make_hash_sharded_step
        self._init = init_hash_carry
        self._build()
        self.carry = init_hash_carry(self.n_shards, cap, n_halos)

    def _build(self):
        self._step = jax.jit(self._make(
            self.mesh, self.n_halos, self.capacity, mode=self.mode,
            box_size=self.box_size, angle_dtype=self.angle_dtype,
        ))

    def route(self, flat):
        from orbitanalysis_tpu.parallel.hash_sharded import route_flat

        if self.id_map is not None:
            # map once here (persistent handles) so the bucket-size
            # check below sees the same keys route_flat will shard on
            flat = dict(flat, ids=self.id_map.map(flat["ids"]))
        ids = np.asarray(flat["ids"], dtype=np.int64)
        if ids.size:
            largest = int(np.bincount(
                (ids % self.n_shards).astype(np.int64),
                minlength=self.n_shards,
            ).max())
            if largest > self.capacity:
                self.grow(largest)
        return route_flat(flat, self.n_shards, self.capacity)

    def grow(self, needed):
        self.grow_to(round_up(int(np.ceil(needed * 1.2)), 128))

    def grow_to(self, new_cap):
        """Re-pad the per-shard record capacity to exactly ``new_cap``
        (lockstep growth across mode='both' engine pairs)."""
        pad = new_cap - self.capacity
        if pad <= 0:
            return
        c = jax.tree.map(_fetch_host, self.carry)
        self.carry = type(c)(
            halo=np.pad(c.halo, ((0, 0), (0, pad)),
                        constant_values=self.n_halos),
            ids=np.pad(c.ids, ((0, 0), (0, pad)),
                       constant_values=self.invalid),
            slot=np.pad(c.slot, ((0, 0), (0, pad))),
            vrad=np.pad(c.vrad, ((0, 0), (0, pad))),
            rhat=np.pad(c.rhat, ((0, 0), (0, pad), (0, 0))),
            angles=np.pad(c.angles, ((0, 0), (0, pad))),
        )
        self.capacity = new_cap
        self.event_capacity = new_cap
        self._build()

    def step(self, batch, centers_full, bulk_full, hubble_drag):
        self.carry, events = self._step(
            self.carry, batch, jnp.asarray(centers_full),
            None if bulk_full is None else jnp.asarray(bulk_full),
            jnp.float32(hubble_drag),
        )
        return events

    def capture_angles(self):
        """Host copies of (slot, valid, angles) for the checkpoint."""
        c = self.carry
        return (
            _fetch_host(c.slot),
            _fetch_host(c.ids) != self.invalid,
            _fetch_host(c.angles),
        )

    def angles_to_load_order(self, captured, n_particles):
        slot, valid, angles = captured
        flat = np.zeros(n_particles, dtype=angles.dtype)
        flat[slot[valid]] = angles[valid]
        return flat

    def set_angles_flat(self, ck_angles):
        """Resume: replace carry angles from the (load-order) sidecar."""
        ck = np.asarray(ck_angles, dtype=np.float32)
        if ck.size == 0:
            return  # empty resume snapshot: carry angles stay zero
        slot = _fetch_host(self.carry.slot)
        valid = _fetch_host(self.carry.ids) != self.invalid
        new = np.where(
            valid, ck[np.minimum(slot, len(ck) - 1)], 0.0
        ).astype(np.float32)
        self.carry = self.carry._replace(angles=jnp.asarray(new))


def track_orbits(
    snapshot_numbers,
    main_branches,
    regions,
    load_snapshot_data,
    savefile,
    mode: str = "pericentric",
    checkpoint: bool = False,
    resume: bool = False,
    verbose: bool = True,
    capacity: Optional[int] = None,
    headroom: float = 1.3,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    mesh=None,
    event_capacity: Optional[int] = None,
    metrics: Optional[Metrics] = None,
    profile_dir: Optional[str] = None,
    join_impl: str = "auto",
    prefetch: int = 1,
    grow_impl: str = "auto",
    npool=None,  # noqa: ARG001 — accepted for reference API compat, unused
):
    """Track pericentric/apocentric passages over a snapshot sequence.

    Parameters mirror the reference driver (``track_orbits.py:9-71``).

    snapshot_numbers : (S,) int array-like
        Snapshot numbers to process, any order (sorted ascending
        internally; ``main_branches`` is reordered with them).
    main_branches : (S, n_halos) int array-like
        Per-snapshot progenitor halo IDs of each tracked branch, aligned
        with ``snapshot_numbers``.  Entry ``-1`` means the branch has no
        progenitor at that snapshot (halo not yet born): the row is
        skipped and its per-particle state starts fresh when the branch
        first appears.  The last row holds the final descendant IDs
        recorded in the savefile.
    regions : callable
        ``regions(snapshot_number, halo_ids) -> (positions, radii)`` or
        ``-> (positions, radii, bulk_velocities)``.  ``halo_ids`` is the
        ``main_branches`` row with ``-1`` entries removed; returns the
        region centers ``(n, 3)``, radii ``(n,)``, and optionally
        catalog bulk velocities ``(n, 3)`` (if omitted, the bulk
        velocity is the mass-weighted mean of each region's particles).
    load_snapshot_data : callable
        ``load_snapshot_data(snapshot_number, region_positions,
        region_radii) -> dict``.  Must return the particles inside each
        requested region, block-concatenated **in request order**, as:

        - ``ids (N,) int`` — unique non-negative particle IDs;
        - ``coordinates (N, 3)``, ``velocities (N, 3)`` — comoving
          positions and peculiar velocities;
        - ``masses`` — ``(N,)`` array or scalar (scalar/equal-mass means
          the plain mean is used for bulk velocities);
        - ``region_offsets (n,) int`` — start index of each region's
          block (block ``i`` spans ``offsets[i]:offsets[i+1]``);
        - optional ``box_size`` (enables periodic wrapping),
          ``redshift``, ``H0``, ``Omega_m``, ``Omega_L``, ``Omega_k``
          (all present ⇒ the Hubble-flow term ``H·r/(1+z)`` is added to
          radial velocities, matching the reference's offline mode).

        Blocks must cover exactly the requested regions — returning all
        halos when a subset was requested corrupts the packing.
    savefile : str
        Output HDF5 path (reference schema: one ``snapshot_%03d`` group
        per processed snapshot).
    mode : {'pericentric', 'apocentric', 'both'}
        ``'both'`` produces the pericenter AND apocenter catalogs in a
        single pass: ``savefile`` must then be a pair
        ``(pericentric_path, apocentric_path)`` and each output file is
        byte-identical to the corresponding single-mode run's.  The
        host pipeline (callback I/O, packing, host->device transfer,
        savefile writes) — the dominant cost of real runs — is paid
        once instead of twice; the second catalog costs only one extra
        device detection step per snapshot, since the two detectors
        share the staged batch and differ only in the sign-flip
        condition and their angle accumulators
        (``track_orbits.py:311-314``; the reference needs two full runs
        for BASELINE config 3's peri+apo catalogs).

    Additions over the reference:

    capacity : int, optional
        Particle-axis capacity per halo row. Default: sized from the first
        snapshot with ``headroom``, rounded up to a multiple of 128.
    headroom : float
        Over-allocation factor for region growth across snapshots.
    id_dtype, angle_dtype
        Dtypes for particle IDs and the cumulative angle state.
        ``angle_dtype=np.float16`` reproduces the reference's float16 angle
        carry (``track_orbits.py:351``) bit-for-bit at the cost of
        accumulated rounding error; the default float32 is more accurate.
        ``id_dtype=np.int64`` handles IDs beyond the int32 range (e.g.
        Gadget uint64 IDs remapped to int64, >1290^3-particle runs): on
        the aligned engine the wide IDs stay host-side and the device
        streams a 32-bit *position surrogate* (the stable layout makes
        detection positional), so no x64 mode and no 64-bit device
        arithmetic is needed and throughput matches the 32-bit path;
        savefiles carry the real int64 IDs.  The general engine with
        int64 requires ``jax.enable_x64``.
    mesh : jax.sharding.Mesh, optional
        Shard over this mesh.  Axis name 'halos' shards the halo axis
        (whole rows per device, zero collectives; optionally with a
        'particles' axis on the general engine).  Axis name 'shards'
        selects the hash-sharded particle-pool engine instead
        (:mod:`orbitanalysis_tpu.parallel.hash_sharded`): the flat
        (halo, id) record pool is distributed by ``id % n_shards``, the
        churn join stays shard-local, and per-step collectives reduce
        to psum'd bulk-velocity moments — the full-box scaling path.
    event_capacity : int, optional
        Per-halo on-device event-compaction width (default: capacity/16,
        min 128).  Hosts fetch [n_halos, event_capacity] event lists per
        snapshot instead of full masks; overflow falls back to the mask.
    metrics : Metrics, optional
        Structured per-snapshot records (phase timings, event counts).
    profile_dir : str, optional
        Capture a ``jax.profiler`` trace of the whole run into this
        directory (view in TensorBoard/Perfetto).
    join_impl : {'auto', 'general', 'sorted', 'aligned'}
        Snapshot-join implementation (savefile output is identical).
        ``'general'`` joins prev and cur by ID with sort-merges on
        device.  ``'sorted'`` packs halo rows ID-sorted on the host and
        keeps the carry ID-sorted, so one merge sort plus one extraction
        sort do the join.  ``'aligned'`` goes further: the host staging
        pipeline assigns every particle a *persistent* row position
        (:class:`~orbitanalysis_tpu.engine.packing.StableLayout` —
        survivors keep their position, entrants reuse departures'
        holes), so consecutive snapshots are element-wise aligned by
        construction and the device runs **no join at all**, with the
        alignment bookkeeping folded into the host pack phase that the
        prefetch pipeline overlaps with device compute.  With ``mesh``
        both run halo-sharded via ``shard_map`` (halo axis only).
        ``'auto'`` asks :func:`orbitanalysis_tpu.policy.join_engine`
        (platform, ID width, angle dtype, mesh axes).
    prefetch : int
        Snapshots to load ahead on a background thread (queue depth).
        The callbacks are still invoked one at a time in snapshot
        order; their I/O just overlaps the previous snapshot's pack /
        device step / savefile write.  ``0`` loads synchronously.
    grow_impl : {'auto', 'keep', 'general'}
        What a mid-run capacity overflow does to a sorted/aligned
        engine: ``'keep'`` (and ``'auto'``) re-jit the same engine at
        the grown capacity; ``'general'`` converts the carry to the
        general engine.
    """
    # mode='both': one ingest pass, two catalogs — load/pack/H2D once
    # per snapshot and run both detectors on the staged batch.  Two
    # separate reference-mode runs pay the (dominant, transfer-bound)
    # host pipeline twice for identical staging; the detectors differ
    # only in the sign-flip condition and their angle accumulators
    # (track_orbits.py:311-314), so the second catalog costs one extra
    # device step.
    modes, savefiles = io_hdf5.normalize_mode_savefiles(mode, savefile)
    savefile = savefiles[0]  # layout leader (checkpoint layout source)
    # re-jits (capacity growth, restarts, resume) hit disk instead of
    # compiling again
    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from orbitanalysis_tpu.parallel import multihost

    # single-writer savefile semantics across processes (reference:
    # one process owns the file, track_orbits.py:366-397); non-primary
    # processes still participate in every device fetch (collectives)
    primary = multihost.is_primary()
    snapshot_numbers, main_branches = _normalize_inputs(
        snapshot_numbers, main_branches
    )
    n_halos = main_branches.shape[1]
    final_branch = main_branches[-1]
    final_snapshot = snapshot_numbers[-1]

    if resume:
        if verbose:
            print("Resuming from file...\n")
        resume_snaps = [io_hdf5.last_snapshot_number(f) for f in savefiles]
        resume_snap = resume_snaps[0]
        if any(s != resume_snap for s in resume_snaps):
            raise ValueError(
                "mode='both' resume needs both savefiles at the same "
                f"snapshot; got {dict(zip(savefiles, resume_snaps))} — "
                "delete the trailing snapshot group(s) of the file that "
                "ran ahead and re-run"
            )
        sind = int(np.argwhere(snapshot_numbers == resume_snap).flatten()[0])
        snapshot_numbers = snapshot_numbers[sind:]
        main_branches = main_branches[sind:]

    sharding = None
    n_rows = n_halos
    hash_mesh = mesh is not None and "shards" in mesh.axis_names
    if mesh is not None and not hash_mesh:
        from orbitanalysis_tpu.parallel.sharding import halo_sharding
        sharding = halo_sharding(mesh)
        # pad the halo axis so it divides evenly over the mesh
        n_rows = round_up(n_halos, int(mesh.shape["halos"]))

    if join_impl not in ("auto", "general", "sorted", "aligned"):
        raise ValueError(f"unknown join_impl: {join_impl!r}")
    if grow_impl not in ("auto", "keep", "general"):
        raise ValueError(f"unknown grow_impl: {grow_impl!r}")
    join_was_auto = join_impl == "auto"
    if hash_mesh:
        # a 'shards' mesh axis selects the hash-sharded particle-pool
        # engine (parallel/hash_sharded.py): full-box scale, join
        # shard-local under churn
        if join_impl in ("sorted", "aligned"):
            raise ValueError(
                "a 'shards' mesh runs the hash-sharded engine; "
                f"join_impl={join_impl!r} does not apply — use 'auto'"
            )
        join_impl = "hash"
    elif join_impl == "auto":
        from orbitanalysis_tpu.policy import join_engine

        join_impl = join_engine(
            id_dtype, angle_dtype,
            particles_axis=mesh is not None
            and "particles" in mesh.axis_names,
        )

    tstart = time.time()
    # one engine per detection mode: identical staging/layout, the
    # detectors differ only in the sign-flip condition and their angle
    # accumulators (mode='both' amortizes the host pipeline over both)
    engines: list = []
    engine: Optional[_DeviceEngine] = None  # layout leader = engines[0]
    box_size = None
    prev_ids_host = None       # [H, P] packed ids of last processed snapshot
    prev_slot_host = None      # [H, P] staged load slots of the same
    prev_rows = None           # active halo rows of last processed snapshot
    stable_layout: Optional[StableLayout] = None  # join_impl='aligned'
    resume_layout_flat = None  # checkpointed stable positions (aligned)
    if resume and join_impl == "aligned":
        # the aligned engine's layout is history-dependent; restore it
        # from the sidecar so the resumed run reproduces the crashed
        # run's positions bit-for-bit (older sidecars without the
        # dataset fall back to a fresh layout: ~1-ulp bulk-velocity
        # drift, events still oracle-correct)
        try:
            _, _, resume_layout_flat = io_hdf5.read_checkpoint(
                savefile, with_layout=True
            )
        except OSError:
            resume_layout_flat = None  # seed branch raises the real error
    started = False

    # Software pipeline: the step for snapshot s is *dispatched* (JAX
    # dispatch is async) and its event fetch + HDF5 write deferred into a
    # ``pending`` record flushed while snapshot s+1 is loading/packing/
    # computing — host I/O overlaps device compute.
    pending = None

    def flush_pending():
        nonlocal pending
        if pending is None:
            return
        p, phases = pending, pending["phases"]
        pending = None
        if p["save"]:
          n_events_by_mode = {}
          bulk_vel = None  # mode-independent: fetched once, reused
          for events, ev_engine, mname, fname in zip(
              p["events_list"], engines, modes, savefiles
          ):
            with phase_timer(phases, "fetch"):
                ev_count = _fetch_host(
                    events.count
                    if engine.join in ("sorted", "aligned", "hash")
                    else events.ev_count
                )
                if bulk_vel is None:
                    bulk_vel = _fetch_host(events.bulk_vel)
            if verbose:
                # pipelined: the elapsed time spans dispatch of this
                # snapshot's step through the next snapshot's load/pack
                # (the flush runs while the next step computes)
                print(
                    "Finished {} detection for snapshot {} "
                    "(dispatch-to-write {} s)\n".format(
                        io_hdf5.apsis_tag(mname),
                        "%03d" % p["snapshot_number"],
                        time.time() - p["t0"],
                    )
                )

            saved_rows = p["saved_rows"]
            K = engine.event_capacity
            if engine.join == "hash":
                # per-shard event lists -> reference per-halo order
                # (events ride halo row + prev global load slot)
                from orbitanalysis_tpu.parallel.hash_sharded import (
                    events_to_reference_order,
                )

                with phase_timer(phases, "fetch"):
                    eh = _fetch_host(events.halo)
                    ei = _fetch_host(events.ids)
                    es = _fetch_host(events.slots)
                    ea = _fetch_host(events.angles)
                offs_all, ids_flat, ang_flat = events_to_reference_order(
                    ev_count, eh, ei, es, ea, n_rows
                )
                lens = np.diff(offs_all)[saved_rows]
                if len(saved_rows):
                    sel = np.concatenate([
                        np.arange(offs_all[r], offs_all[r + 1])
                        for r in saved_rows
                    ]).astype(np.int64)
                else:
                    sel = np.zeros(0, np.int64)
                apsis_ids_flat = ids_flat[sel]
                if engine.id_map is not None:
                    # device handles -> real wide IDs for the savefile
                    apsis_ids_flat = engine.id_map.unmap(apsis_ids_flat)
                apsis_angles_flat = ang_flat[sel]
                apsis_offsets = np.concatenate(([0], np.cumsum(lens)))
            elif engine.join == "aligned":
                # positional events: the device returns stable-layout
                # row positions + f16-exact angles only (one u32 payload
                # word through the compaction); particle IDs and
                # reference ordering come from the host's staged tables
                # — the current snapshot's ID table (an event position's
                # tenant is unchanged since the previous snapshot) and
                # the PREVIOUS snapshot's load slots (the reference
                # emits apsides in prev-snapshot region load order,
                # track_orbits.py:300-314)
                counts = ev_count[saved_rows]
                width = events.ids.shape[1]
                if int(counts.max(initial=0)) > width:
                    # The compaction truncated events past the
                    # buffer width while the counts (a full-row sum)
                    # kept them.  Nothing is lost: the step also emits
                    # the full pre-compaction payload plane
                    # (emit_payload=True) — decode EVERY event from it
                    # for this snapshot, then grow the event capacity
                    # (power of two) so subsequent steps re-jit with
                    # headroom.  The reference has no static event
                    # bound at all (track_orbits.py:199-217); an
                    # unattended run must not die on an event spike.
                    kf = round_up(int(counts.max()), 256)
                    with phase_timer(phases, "fetch"):
                        pay = events.payload
                        if isinstance(pay, tuple):
                            # wide-row pair format: pos + 1 where an
                            # event fired, f16 bits alongside
                            posw = np.asarray(
                                _fetch_host(pay[0]))[saved_rows]
                            angw = np.asarray(
                                _fetch_host(pay[1]))[saved_rows]
                        else:
                            # angle-word format: apsis flag in bit 31,
                            # f32 angle bits below (position = column)
                            pw = np.asarray(
                                _fetch_host(pay))[saved_rows]
                            posw = np.where(
                                pw >> np.uint32(31),
                                np.arange(
                                    pw.shape[1], dtype=np.uint32
                                )[None, :] + 1,
                                np.uint32(0),
                            )
                            # clamp like the device's f16_bits_rne:
                            # past the f16 range it gives 0x7BFF, not inf
                            angw = (
                                np.minimum(
                                    (pw & np.uint32(0x7FFFFFFF))
                                    .view(np.float32),
                                    np.float32(65504.0),
                                )
                                .astype(np.float16)
                                .view(np.uint16)
                            )
                    nsr = posw.shape[0]
                    ev_pos = np.zeros((nsr, kf), np.int32)
                    ang_bits = np.zeros((nsr, kf), np.uint16)
                    for r in range(nsr):
                        nz = np.flatnonzero(posw[r])
                        ev_pos[r, :len(nz)] = (
                            posw[r, nz].astype(np.int64) - 1
                        )
                        ang_bits[r, :len(nz)] = angw[r, nz].astype(
                            np.uint16
                        )
                    ev_angles = ang_bits.view(np.float16).astype(
                        events.angles.dtype
                    )
                    if verbose:
                        print(
                            "Event buffer overflow on snapshot "
                            f"{'%03d' % p['snapshot_number']} (max "
                            f"{int(counts.max())} apsides/halo > "
                            f"{width}): recovered all events from the "
                            "payload plane; growing event capacity to "
                            f"{min(max(round_up_pow2(int(counts.max())), 128), ev_engine.capacity)}\n"
                        )
                    ev_engine.grow_events(int(counts.max()))
                else:
                    kf = min(
                        round_up(max(int(counts.max(initial=0)), 1), 256),
                        width,
                    )
                    with phase_timer(phases, "fetch"):
                        ev_pos = _fetch_host(
                            _slice_cols(events.ids, kf))[saved_rows]
                        ev_angles = _fetch_host(
                            _slice_cols(events.angles, kf))[saved_rows]
                sel = np.arange(kf)[None, :] < counts[:, None]
                prev_slot = p["prev_packed_slot"][saved_rows]
                pos_idx = np.clip(
                    ev_pos.astype(np.int64), 0, prev_slot.shape[1] - 1
                )
                ev_slots = np.take_along_axis(prev_slot, pos_idx, axis=-1)
                slot_key = np.where(sel, ev_slots, np.iinfo(np.int32).max)
                order = np.argsort(slot_key, axis=-1, kind="stable")
                ev_pos = np.take_along_axis(ev_pos, order, axis=-1)
                ev_angles = np.take_along_axis(ev_angles, order, axis=-1)
                id_tab = p["packed_ids"][saved_rows]
                ev_ids = np.take_along_axis(
                    id_tab,
                    np.clip(ev_pos.astype(np.int64), 0,
                            id_tab.shape[1] - 1),
                    axis=-1,
                )
                apsis_offsets = np.concatenate(([0], np.cumsum(counts)))
                apsis_ids_flat = ev_ids[sel]
                apsis_angles_flat = ev_angles[sel]
            elif engine.join == "sorted":
                # overflow-free: the event buffer spans the whole
                # capacity, already in reference (prev load-slot) order;
                # fetch a count-bounded slice (rounded to limit distinct
                # slice shapes)
                counts = ev_count[saved_rows]
                width = events.ids.shape[1]
                kf = min(round_up(max(int(counts.max(initial=0)), 1), 256),
                         width)
                with phase_timer(phases, "fetch"):
                    ev_ids = _fetch_host(
                        _slice_cols(events.ids, kf))[saved_rows]
                    ev_angles = _fetch_host(
                        _slice_cols(events.angles, kf))[saved_rows]
                sel = np.arange(kf)[None, :] < counts[:, None]
                apsis_offsets = np.concatenate(([0], np.cumsum(counts)))
                apsis_ids_flat = ev_ids[sel]
                apsis_angles_flat = ev_angles[sel]
            elif int(ev_count[saved_rows].max(initial=0)) > K:
                # event-capacity overflow: fetch the full masks (rare)
                with phase_timer(phases, "fetch"):
                    apsis = _fetch_host(events.apsis)
                    apsis_angle = _fetch_host(events.apsis_angle)
                apsis_offsets, apsis_ids_flat, apsis_angles_flat = (
                    unpack_mask(
                        apsis, p["layout_ids"], apsis_angle, rows=saved_rows
                    )
                )
            else:
                with phase_timer(phases, "fetch"):
                    ev_ids = _fetch_host(events.ev_ids)[saved_rows]
                    ev_angles = _fetch_host(events.ev_angles)[saved_rows]
                counts = ev_count[saved_rows]
                sel = np.arange(K)[None, :] < counts[:, None]
                apsis_offsets = np.concatenate(([0], np.cumsum(counts)))
                apsis_ids_flat = ev_ids[sel]
                apsis_angles_flat = ev_angles[sel]

            with phase_timer(phases, "save"):
                if primary:  # single-writer, reference semantics
                    io_hdf5.append_snapshot(
                        fname,
                        p["snapshot_number"],
                        mname,
                        apsis_ids=apsis_ids_flat,
                        apsis_offsets=apsis_offsets,
                        apsis_angles=apsis_angles_flat,
                        halo_ids=p["halo_ids_saved"],
                        final_descendant_ids=p["final_desc"],
                        region_radii=p["region_radii_saved"],
                        region_positions=p["region_positions_saved"],
                        bulk_velocities=bulk_vel[saved_rows],
                        verbose=verbose,
                    )
            n_events_by_mode[mname] = int(len(apsis_ids_flat))
          if metrics is not None:
                extra = (
                    {
                        "n_events_" + io_hdf5.apsis_tag(m): n
                        for m, n in n_events_by_mode.items()
                    }
                    if len(modes) > 1
                    else {}
                )
                metrics.log(
                    snapshot=int(p["snapshot_number"]),
                    n_halos_active=int(len(p["rows"])),
                    n_particles=int(p["n_particles"]),
                    n_events=int(sum(n_events_by_mode.values())),
                    capacity=int(engine.capacity),
                    event_capacity=int(engine.event_capacity),
                    **extra,
                    **phases,
                )
        if checkpoint:
            # carry angles were fetched before the *next* dispatch could
            # donate them (see angles_host below); final drain fetches
            # here.  The angle accumulators differ per mode (each resets
            # at its own apsides), so every savefile gets its engine's
            # angles; the layout datasets are staging-derived and
            # identical across modes (computed once below).
            angles_list = p.get("angles_host")
            layout_flat = None
            if engine.join == "hash":
                if angles_list is None:
                    angles_list = [e.capture_angles() for e in engines]
                if not primary:
                    return
                angles_per_file = [
                    e.angles_to_load_order(cap, p["n_particles"])
                    for e, cap in zip(engines, angles_list)
                ]
            else:
                if angles_list is None:
                    angles_list = [e.angles_host() for e in engines]
                if not primary:
                    return
                valid = p["packed_ids"] != engine.invalid
                slot = None
                if engine.join in ("sorted", "aligned"):
                    # carry follows the device layout (ID-sorted /
                    # stable-position); scatter back to load order so
                    # the checkpoint matches the reference layout
                    slot = np.asarray(p["packed_slot"])
                    v_load = np.zeros(valid.shape, dtype=bool)
                    np.put_along_axis(v_load, slot, valid, axis=-1)
                    if engine.join == "aligned":
                        # stable position of each load-order entry —
                        # lets resume rebuild the history-dependent
                        # layout exactly (see write_checkpoint)
                        pos_of = np.zeros(slot.shape, dtype=np.int32)
                        np.put_along_axis(
                            pos_of, slot,
                            np.broadcast_to(
                                np.arange(
                                    slot.shape[-1], dtype=np.int32
                                ),
                                slot.shape,
                            ),
                            axis=-1,
                        )
                        _, layout_flat = unpack_mask(
                            v_load, pos_of, rows=p["rows"]
                        )
                angles_per_file = []
                for angles_dev in angles_list:
                    v = valid
                    if slot is not None:
                        a_load = np.zeros_like(angles_dev)
                        np.put_along_axis(
                            a_load, slot, angles_dev, axis=-1
                        )
                        angles_dev, v = a_load, v_load
                    _, angles_flat = unpack_mask(
                        v, angles_dev, rows=p["rows"]
                    )
                    angles_per_file.append(angles_flat)
            for fname, angles_flat in zip(savefiles, angles_per_file):
                io_hdf5.write_checkpoint(
                    fname, angles_flat, p["snapshot_number"],
                    angle_store_dtype=angles_flat.dtype,
                    layout_positions=layout_flat,
                )

    items = list(zip(main_branches, snapshot_numbers))
    feed = _SnapshotFeed(
        items, regions, load_snapshot_data, depth=max(int(prefetch), 0)
    )
    try:
      with trace(profile_dir):
       for i, (halo_ids, snapshot_number) in enumerate(items):
        if verbose:
            print("-" * 30, "\n")
            print("Snapshot {}\n".format("%03d" % snapshot_number))
        phases = {}

        # blocking fetch from the prefetch pipeline: the recorded
        # 'load' phase is the residual wait, near zero when the
        # background load finished while the previous step computed
        with phase_timer(phases, "load"):
            rows, payload = feed.get(i)
        if payload is None:
            continue
        region_positions, region_radii, region_bulk_vels, snapshot = payload
        if len(snapshot["coordinates"]) == 0:
            continue

        if "redshift" in snapshot:
            missing = [
                k for k in ("H0", "Omega_m", "Omega_L") if k not in snapshot
            ]
            if missing:
                raise KeyError(
                    "loader dict has 'redshift' (enables the Hubble-flow "
                    f"term) but lacks {missing}; supply the full cosmology "
                    "or omit 'redshift'"
                )
            Hz = hubble_parameter(
                snapshot["redshift"],
                snapshot["H0"],
                snapshot["Omega_m"],
                snapshot["Omega_L"],
                snapshot.get("Omega_k", 0),
            )
            hubble_drag = float(Hz / (1.0 + snapshot["redshift"]))
        else:
            hubble_drag = 0.0

        offsets = np.asarray(snapshot["region_offsets"], dtype=np.int64)
        lengths = np.diff(np.concatenate((offsets, [len(snapshot["ids"])])))

        if engine is None:
            box_size = snapshot.get("box_size")
            if join_impl == "hash":
                n_shards = int(mesh.shape["shards"])
                cap = capacity or round_up(
                    int(np.ceil(
                        len(snapshot["ids"]) / n_shards * headroom
                    )) + 1, 128,
                )
                engines = [
                    _HashEngine(
                        mesh, n_rows, m, box_size, cap, angle_dtype,
                        id_dtype=id_dtype,
                    )
                    for m in modes
                ]
                engine = engines[0]
                if not resume and primary:
                    for fname, m in zip(savefiles, modes):
                        io_hdf5.initialize_savefile(
                            fname, m, box_size, verbose
                        )
        if engine is None:
            cap = capacity or required_capacity(lengths, headroom)
            if join_impl in ("sorted", "aligned"):
                cap = max(round_up_pow2(cap), 128)
                if (
                    resume_layout_flat is not None
                    and resume_layout_flat.size
                ):
                    # the crashed run may have grown past what the seed
                    # snapshot alone requires; its checkpointed
                    # positions must stay addressable
                    cap = max(cap, round_up_pow2(
                        int(resume_layout_flat.max()) + 1
                    ))
                if cap > MAX_ROW_CAPACITY:
                    # the packed slot field addresses 2**24 row entries
                    if join_was_auto and np.dtype(id_dtype).itemsize == 4:
                        join_impl = "general"
                        cap = capacity or required_capacity(
                            lengths, headroom
                        )
                    else:
                        raise ValueError(
                            f"join_impl={join_impl!r} supports per-halo "
                            f"capacities up to {MAX_ROW_CAPACITY} "
                            f"(needed {cap}); use join_impl='general'"
                        )
            engines = [
                _DeviceEngine(
                    n_rows, cap, m, box_size, id_dtype, angle_dtype,
                    sharding=sharding, event_capacity=event_capacity,
                    join=join_impl,
                )
                for m in modes
            ]
            engine = engines[0]
            if join_impl == "aligned":
                stable_layout = StableLayout(
                    n_rows, engine.capacity, id_dtype=id_dtype
                )
            if not resume and primary:
                for fname, m in zip(savefiles, modes):
                    io_hdf5.initialize_savefile(fname, m, box_size, verbose)
        if engine.join != "hash" and lengths.size and (
            int(lengths.max()) > engine.capacity
        ):
            # growth re-pads device state: drain the pipeline first so
            # pending full-mask fallbacks keep their original shapes
            flush_pending()
            new_cap = required_capacity(lengths, headroom)
            to_general = (engine.join in ("sorted", "aligned")
                          and grow_impl == "general")
            if to_general and engine.surrogate:
                raise ValueError(
                    "wide (64-bit) particle IDs ride a 32-bit device "
                    "surrogate on the aligned engine; the general "
                    "engine would need 64-bit device IDs (x64). Grow "
                    "in place instead: grow_impl='keep'"
                )
            if to_general:
                if verbose:
                    print(
                        f"Growing particle capacity {engine.capacity} -> "
                        f"{new_cap}; switching to the general join "
                        "engine\n"
                    )
                converted = [
                    e.to_general(
                        new_cap,
                        layout_ids=(
                            prev_ids_host
                            if e.join == "aligned" else None
                        ),
                    )
                    for e in engines
                ]
                engines = [e for e, _ in converted]
                engine = engines[0]
                prev_ids_host = converted[0][1]
                join_impl = "general"
                stable_layout = None
            else:
                if verbose:
                    print(
                        f"Growing particle capacity {engine.capacity} -> "
                        f"{new_cap} (recompiles the step)\n"
                    )
                for e in engines:
                    e.grow(new_cap)
                if stable_layout is not None:
                    stable_layout.grow(engine.capacity)
                if prev_ids_host is not None:
                    prev_ids_host = np.pad(
                        prev_ids_host,
                        ((0, 0),
                         (0, engine.capacity - prev_ids_host.shape[1])),
                        constant_values=engine.invalid,
                    )
                if prev_slot_host is not None:
                    # padded positions are all FRESH next step, so no
                    # event can reference them; pad values are inert
                    prev_slot_host = np.pad(
                        prev_slot_host,
                        ((0, 0),
                         (0, engine.capacity - prev_slot_host.shape[1])),
                    )

        if engine.join == "hash":
            with phase_timer(phases, "pack"):
                halo_col = np.repeat(rows.astype(np.int32), lengths)
                flat = dict(
                    halo=halo_col,
                    ids=snapshot["ids"],
                    pos=snapshot["coordinates"],
                    vel=snapshot["velocities"],
                )
                m = snapshot.get("masses")
                if (
                    isinstance(m, np.ndarray)
                    and np.ndim(m) == 1
                    and len(m) == len(snapshot["ids"])
                ):
                    flat["mass"] = m
                batch = engine.route(flat)  # grows the shard cap if needed
                for e in engines[1:]:       # lockstep shard capacities
                    if e.capacity < engine.capacity:
                        e.grow_to(engine.capacity)
                if len(engines) > 1:
                    # stage the routed blocks on the mesh once; both
                    # detectors' shard_maps consume the same placement
                    # (otherwise the dominant full-box payload crosses
                    # the host->device link once per mode)
                    from jax.sharding import (
                        NamedSharding,
                        PartitionSpec,
                    )

                    shard0 = NamedSharding(mesh, PartitionSpec("shards"))
                    batch = jax.tree.map(
                        lambda x: jax.device_put(x, shard0), batch
                    )
                centers_full = np.zeros((n_rows, 3), np.float32)
                centers_full[rows] = region_positions
                bulk_full = None
                if region_bulk_vels is not None:
                    bulk_full = np.zeros((n_rows, 3), np.float32)
                    bulk_full[rows] = region_bulk_vels
            packed = None
            packed_ids_host = packed_slot_host = None
            t0 = time.time()
            if checkpoint and pending is not None:
                pending["angles_host"] = [
                    e.capture_angles() for e in engines
                ]
            layout_ids = None
            with phase_timer(phases, "step"):
                events_list = [
                    e.step(batch, centers_full, bulk_full, hubble_drag)
                    for e in engines
                ]
        else:
            with phase_timer(phases, "pack"):
                if join_impl == "aligned":
                    restore = None
                    if not started and resume_layout_flat is not None:
                        restore = pack_ragged(
                            resume_layout_flat.astype(np.int32),
                            offsets, n_rows, engine.capacity, rows=rows,
                            fill=-1,
                        )
                    packed = pack_snapshot_aligned(
                        snapshot, rows, n_rows, stable_layout,
                        region_positions, region_bulk_vels,
                        id_dtype=id_dtype, restore_dest=restore,
                    )
                else:
                    packed = pack_snapshot(
                        snapshot, rows, n_rows, engine.capacity,
                        region_positions, region_bulk_vels,
                        id_dtype=id_dtype,
                        sort_ids=(join_impl == "sorted"),
                    )

            t0 = time.time()
            packed_ids_host = packed.ids   # host bookkeeping copies
            packed_slot_host = packed.slot
            if join_impl == "aligned" and packed_slot_host is not None:
                # strip the staging FRESH flags: host bookkeeping uses
                # the slot channel as scatter/gather indices
                packed_slot_host = packed_slot_host & SLOT_MASK
            if engine.surrogate:
                # wide IDs stay host-side: the device ID channel is the
                # position surrogate (iota at occupied positions) — the
                # aligned step only needs validity; FRESH rides the
                # staged slot bit 27 and events map back through
                # packed_ids_host at write time
                iota = np.broadcast_to(
                    np.arange(engine.capacity, dtype=np.int32),
                    packed.ids.shape,
                )
                packed = packed._replace(ids=np.where(
                    packed.ids != engine.invalid, iota,
                    np.int32(engine._dev_invalid),
                ))
            # static-membership fast path: identical ID layout to the
            # previous snapshot means the sort-merge join is unnecessary
            # (general engine only — the sorted engine branches on
            # device, the aligned engine never joins at all)
            static = (
                join_impl not in ("sorted", "aligned")
                and prev_ids_host is not None
                and bool(np.array_equal(packed_ids_host, prev_ids_host))
            )
            if checkpoint and pending is not None:
                # the next dispatch donates the carry, so materialize the
                # pending snapshot's angles now (syncs on its step only)
                pending["angles_host"] = [
                    e.angles_host() for e in engines
                ]
            layout_ids = prev_ids_host  # the dispatched step's prev layout
            if len(engines) > 1 and sharding is None:
                # stage the batch on device once; both detectors read it
                packed = jax.tree.map(jnp.asarray, packed)
            with phase_timer(phases, "step"):
                events_list = [
                    e.step(packed, hubble_drag, static=static)
                    for e in engines
                ]

        if not started:
            # First processed snapshot: seeds the carry; nothing to save
            # (reference: `i > istart` gate, track_orbits.py:160,212).
            if resume:
              for e, fname in zip(engines, savefiles):
                ck_angles, ck_snap = io_hdf5.read_checkpoint(fname)
                if ck_snap >= 0 and ck_snap != snapshot_number:
                    raise ValueError(
                        f"checkpoint sidecar holds angles for snapshot "
                        f"{ck_snap} but the savefile resumes at snapshot "
                        f"{snapshot_number}; the run likely crashed "
                        "between the savefile append and the checkpoint "
                        "write — delete the last savefile group or the "
                        "checkpoint and re-run"
                    )
                if e.join == "hash":
                    e.set_angles_flat(
                        np.asarray(ck_angles, dtype=angle_dtype)
                    )
                else:
                    angles_padded = pack_ragged(
                        np.asarray(ck_angles, dtype=angle_dtype),
                        offsets, n_rows, e.capacity, rows=rows,
                        fill=0.0,
                    )
                    e.set_angles(
                        angles_padded,
                        order=packed_slot_host
                        if join_impl in ("sorted", "aligned")
                        else None,
                    )
            started = True
            new_pending = dict(
                save=False, phases=phases, rows=rows,
                packed_ids=packed_ids_host,
                packed_slot=packed_slot_host,
                n_particles=len(snapshot["ids"]),
                snapshot_number=snapshot_number,
            )
        else:
            saved_rows = np.intersect1d(rows, prev_rows)
            radii_full = np.zeros(
                n_rows, dtype=np.asarray(region_radii).dtype
            )
            radii_full[rows] = region_radii
            pos_full = np.zeros((n_rows, 3), dtype=region_positions.dtype)
            pos_full[rows] = region_positions
            new_pending = dict(
                save=True,
                phases=phases,
                events_list=events_list,
                t0=t0,
                rows=rows,
                saved_rows=saved_rows,
                layout_ids=layout_ids,
                packed_ids=packed_ids_host,
                packed_slot=packed_slot_host,
                prev_packed_slot=prev_slot_host,
                snapshot_number=snapshot_number,
                n_particles=len(snapshot["ids"]),
                halo_ids_saved=halo_ids[saved_rows],
                final_desc=(
                    final_branch[saved_rows]
                    if snapshot_number != final_snapshot
                    else None
                ),
                region_radii_saved=radii_full[saved_rows],
                region_positions_saved=pos_full[saved_rows],
            )

        # flush the previous snapshot's I/O while this step computes
        flush_pending()
        pending = new_pending

        prev_ids_host = packed_ids_host
        prev_slot_host = packed_slot_host
        prev_rows = rows

       flush_pending()
    finally:
        feed.close()

    if verbose:
        print(
            "Finished {} detection for all snapshots in {} s\n".format(
                " and ".join(io_hdf5.apsis_tag(m) for m in modes),
                time.time() - tstart,
            )
        )
