"""Corner-span LiDAR scan oracle (independent numpy re-derivation of the
reference algorithm, lidar_model.py:37-108).

The reference scans by iterating every grid cell inside the sensor's square
range window; for each *occupied* cell it computes the angular span of the
cell's 9 corner/edge/center points relative to the car yaw and min-updates
every beam whose angle falls inside that span with the distance to the cell
center.  The framework instead marches K samples per beam
(multi_purpose_mpc_tpu/ops/lidar.py) — the data-parallel shape — so this oracle
exists to *bound the divergence* between the two algorithms on real scenes
(VERDICT round-1, Missing #2).

Faithfulness notes:
  * the sensor sits at the center of the car's cell (lidar_model.py:54-56);
  * hit range = distance between cell centers, in meters (:91-108);
  * cells whose span straddles +-pi hit the reference's wrap branch
    (:96-99), whose chained comparison ``max <= beam <= min`` is vacuously
    false — those cells update no beams.  They lie behind the sensor, outside
    a 180-degree FoV, so for the shipped FoV the branch is unreachable; we
    replicate it anyway (faithful > intended here, it cannot matter).
  * quirk Q7 — the reference's per-corner wrap for ``cell_angle < -pi``
    (:79-80, ``-np.mod(pi + a, 2pi) + pi``) MIRRORS the angle: a true
    relative bearing of +0.54 rad becomes -0.54 rad.  The branch is live
    whenever |car psi| > pi/2 - FoV/2 puts the atan2 seam (world bearing
    +-pi) inside the FoV cone; there the reference hallucinates the
    obstacle at the mirrored beam and misses it at the true beam (measured:
    Real_Track pose (-13.35, -3.33, psi 2.69), cell 3.74 m out at bearing
    +0.541 updates beam -0.541).  Per the quirks policy (SURVEY.md section 7)
    this oracle implements the INTENDED semantics — a proper wrap into
    (-pi, pi] — which the span test then makes exactly equivalent to
    ray-square intersection, matching ``ops/lidar.scan``'s two modes.
"""

from __future__ import annotations

import math

import numpy as np


def beam_angles(fov_deg: float, resolution_deg: float) -> np.ndarray:
    n = int(fov_deg / resolution_deg + 1)
    return np.linspace(-math.pi / 360 * fov_deg, math.pi / 360 * fov_deg, n)


def scan_oracle(occ: np.ndarray, origin, resolution: float,
                car_x: float, car_y: float, car_psi: float,
                fov_deg: float, max_range: float,
                resolution_deg: float) -> np.ndarray:
    """Corner-span scan; returns per-beam ranges in meters (max_range = miss).

    ``occ`` follows the framework convention (1 = free, 0 = occupied),
    ``occ[y, x]`` indexing.
    """
    angles = beam_angles(fov_deg, resolution_deg)
    ranges = np.full(angles.shape, max_range, dtype=np.float64)

    h, w = occ.shape
    x = int(np.floor((car_x - origin[0]) / resolution))
    y = int(np.floor((car_y - origin[1]) / resolution))
    xc = x + 0.5
    yc = y + 0.5
    range_px = int(max_range / resolution)

    for i in range(x - range_px, x + range_px + 1):
        if not (0 <= i < w):
            continue
        for j in range(y - range_px, y + range_px + 1):
            if not (0 <= j < h):
                continue
            if occ[j, i] != 0:
                continue
            xt = i + 0.5
            yt = j + 0.5
            cell_angles = []
            for k in (-1, 0, 1):
                for l in (-1, 0, 1):
                    dy = yt + l / 2 - yc
                    dx = xt + k / 2 - xc
                    a = math.atan2(dy, dx) - car_psi
                    # intended wrap into (-pi, pi] (see quirk Q7 above; the
                    # reference's own branch mirrors angles below -pi)
                    a = -((math.pi - a) % (2 * math.pi)) + math.pi
                    cell_angles.append(a)
            amin = min(cell_angles)
            amax = max(cell_angles)
            dist_px = math.hypot(xc - xt, yc - yt)

            if amin < -math.pi / 2 and amax > math.pi / 2:
                hit = (amax <= angles) & (angles <= amin)  # vacuous (see module doc)
            else:
                hit = (amin <= angles) & (angles <= amax)
            upd = hit & (dist_px * resolution < ranges)
            ranges[upd] = dist_px * resolution
    return ranges
