"""Clean-room NumPy oracle for orbit tracking.

A deliberately simple, obviously-correct re-derivation of the reference
algorithm (from SURVEY.md §2/§3, *not* a copy of the reference code): a
per-halo dictionary of particle state, updated one snapshot at a time.
Used as the golden model for the device engines' unit/integration tests.

Semantics mirrored:
- periodic recenter to [-L/2, L/2]
- bulk velocity: catalog value if given, else mass-weighted mean if masses
  given, else plain mean
- physical velocity: v - v_bulk + hubble_drag * r_rel  (hubble_drag =
  H(z)/(1+z); pass 0 to disable, as the on-the-fly mode does)
- pericenter: vr_prev < 0 and vr_now > 0 (apocenter reversed), only for
  particles present in both snapshots
- angle advance arccos(rhat_prev . rhat_now) accumulated since last apsis
  or region entry; recorded at an apsis, then reset to 0
- optional float16 angle carry to mimic the reference bit-for-bit
"""

from __future__ import annotations

import numpy as np


def wrap(dx, box):
    if box is None:
        return dx
    box = np.asarray(box, dtype=float)
    return dx - box * np.round(dx / box)


class OracleTracker:
    def __init__(self, mode="pericentric", box_size=None, angle_dtype=np.float32):
        assert mode in ("pericentric", "apocentric")
        self.mode = mode
        self.box = box_size
        self.angle_dtype = angle_dtype
        # halo_key -> insertion-ordered dict: id -> [vr, rhat(3,), angle]
        self.state = {}

    def _frame(self, center, bulk_vel, pos, vel, mass, hubble_drag):
        rel = wrap(np.asarray(pos, float) - np.asarray(center, float), self.box)
        vel = np.asarray(vel, float)
        if bulk_vel is None:
            if mass is not None:
                m = np.asarray(mass, float)
                bulk_vel = (m[:, None] * vel).sum(0) / m.sum()
            else:
                bulk_vel = vel.mean(0)
        vrel = vel - np.asarray(bulk_vel, float) + hubble_drag * rel
        r = np.sqrt((rel * rel).sum(-1))
        with np.errstate(invalid="ignore", divide="ignore"):
            rhat = np.where(r[:, None] > 0, rel / np.maximum(r, 1e-300)[:, None], 0.0)
        vr = (vrel * rhat).sum(-1)
        return r, rhat, vr, np.asarray(bulk_vel, float)

    def step(self, halos):
        """Process one snapshot.

        ``halos``: dict halo_key -> dict with keys ids, pos, vel and
        optional mass, bulk_vel, plus center; hubble_drag passed per halo.
        Returns dict halo_key -> (apsis_ids, apsis_angles, had_prev).
        """
        events = {}
        new_state = {}
        for key, h in halos.items():
            ids = np.asarray(h["ids"])
            r, rhat, vr, bulk = self._frame(
                h["center"], h.get("bulk_vel"), h["pos"], h["vel"],
                h.get("mass"), h.get("hubble_drag", 0.0),
            )
            prev = self.state.get(key)
            apsis_ids, apsis_angles = [], []
            cur_angles = {int(i): 0.0 for i in ids}
            if prev is not None:
                cur_index = {int(i): k for k, i in enumerate(ids)}
                for pid, (vr0, rhat0, ang0) in prev.items():
                    k = cur_index.get(pid)
                    if k is None:
                        continue  # departed
                    dth = np.arccos(np.clip(np.dot(rhat0, rhat[k]), -1, 1))
                    ang = self.angle_dtype(ang0 + dth)
                    if self.mode == "pericentric":
                        hit = vr0 < 0 and vr[k] > 0
                    else:
                        hit = vr0 > 0 and vr[k] < 0
                    if hit:
                        apsis_ids.append(pid)
                        apsis_angles.append(ang)
                        ang = self.angle_dtype(0.0)
                    cur_angles[pid] = ang
            new_state[key] = {
                int(i): (vr[k], rhat[k].copy(), cur_angles[int(i)])
                for k, i in enumerate(ids)
            }
            events[key] = (
                np.array(apsis_ids, dtype=ids.dtype),
                np.array(apsis_angles, dtype=np.float64),
                prev is not None,
            )
        self.state = new_state
        return events
