"""Reference-path inspection demo (the reference_path.py __main__ port).

Builds either track, runs the dynamic constraint update over the whole path,
computes a speed profile, and renders it — the reference's de-facto L1+L2
integration test (reference_path.py:651-740).

    python examples/show_reference_path.py --scenario sim_track --out /tmp/path.png
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from multi_purpose_mpc_tpu import Map, Obstacle, ReferencePath
from multi_purpose_mpc_tpu.config import SIM_TRACK_OBSTACLES
from multi_purpose_mpc_tpu.utils import viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", choices=["sim_track", "real_track"],
                   default="sim_track")
    p.add_argument("--out", default="/tmp/reference_path.png")
    args = p.parse_args()

    if args.scenario == "sim_track":
        m = Map(file_path=os.path.join(REPO, "assets/maps/sim_map.png"),
                origin=[-1, -2], resolution=0.005)
        wp_x = [-0.75, -0.25, -0.25, 0.25, 0.25, 1.25, 1.25, 0.75, 0.75,
                1.25, 1.25, -0.75, -0.75, -0.25]
        wp_y = [-1.5, -1.5, -0.5, -0.5, -1.5, -1.5, -1, -1, -0.5, -0.5,
                0, 0, -1.5, -1.5]
        rp = ReferencePath(m, wp_x, wp_y, 0.05, smoothing_distance=5,
                           max_width=0.15, circular=True)
        m.add_obstacles([Obstacle(*o) for o in SIM_TRACK_OBSTACLES[:8]])
        sm = 0.01
    else:
        m = Map(file_path=os.path.join(REPO, "assets/maps/real_map.png"),
                origin=(-30.0, -24.0), resolution=0.06)
        wp_x = [-1.62, -6.04, -6.6, -5.36, -2.0, 5.9, 11.9, 7.3, 0.0, -1.62]
        wp_y = [3.24, -1.4, -3.0, -5.36, -6.65, 3.5, 10.9, 14.5, 5.2, 3.24]
        rp = ReferencePath(m, wp_x, wp_y, 0.2, smoothing_distance=5,
                           max_width=2.0, circular=True)
        m.add_boundary([((-0.02, -2.72), (1.5, 1.0)),
                        ((4.43, 3.07), (1.5, 1.0)),
                        ((4.43, 3.07), (7.5, 6.93)),
                        ((7.28, 13.37), (-3.32, -0.12))])
        sm = 0.01

    # dynamic constraints over the WHOLE path (reference_path.py:730-732)
    ub, lb, cells = rp.update_path_constraints(0, rp.n_waypoints, 0.1, sm)
    rp.compute_speed_profile({"a_min": -0.1, "a_max": 0.5, "v_min": 0,
                              "v_max": 1.0, "ay_max": 4.0})
    print(f"n_waypoints={rp.n_waypoints} length={rp.length:.2f} m "
          f"corridor width min={float((ub - lb).min()):.3f} "
          f"max={float((ub - lb).max()):.3f}")

    fig, ax = plt.subplots(figsize=(7, 7))
    rp.show(ax=ax)
    bu = np.asarray([c[0] for c in cells])
    bl = np.asarray([c[1] for c in cells])
    viz.plot_corridor(ax, bu, bl)
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"saved -> {args.out}")


if __name__ == "__main__":
    main()
