"""Reference-mirroring object API (drop-in layer over the functional core).

Users of the reference drive four classes — ``Map``, ``ReferencePath``,
``BicycleModel``, ``MPC`` (plus ``Obstacle`` and ``LidarModel``); see
README.md:72's two-call loop::

    u = mpc.get_control()
    car.drive(u)

This module provides the same classes with the same constructor signatures
and methods (reference: map.py:45, reference_path.py:66,
spatial_bicycle_models.py:322, MPC.py:15, lidar_model.py:14).  Each is a thin
host-side wrapper owning device arrays and calling the jitted functional
core; the hot loop (``get_control`` + ``drive``) runs one fused
``mpc_step``+``drive`` program per call.  For real throughput use
:mod:`multi_purpose_mpc_tpu.simulation` (the ``lax.scan`` rollout) — the OO
layer trades throughput for API familiarity, while still running every FLOP
on the accelerator.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from multi_purpose_mpc_tpu.config import (
    LidarConfig,
    MapConfig,
    MPCConfig,
    ModelConfig,
    PathConfig,
    SolverConfig,
    SpeedProfileConstraints,
)
from multi_purpose_mpc_tpu.models import bicycle as bike
from multi_purpose_mpc_tpu.models.bicycle import CarState, init_car_state
from multi_purpose_mpc_tpu.mpc import mpc_step, predict_world_positions
from multi_purpose_mpc_tpu.ops import constraints as cons
from multi_purpose_mpc_tpu.ops import grid as grid_ops
from multi_purpose_mpc_tpu.ops import lidar as lidar_ops
from multi_purpose_mpc_tpu.ops.path import PathData, build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.utils import maps as maps_util
from multi_purpose_mpc_tpu.utils import viz


class Obstacle:
    """Circular obstacle (reference: map.py:16-37)."""

    def __init__(self, cx: float, cy: float, radius: float):
        self.cx = cx
        self.cy = cy
        self.radius = radius

    def show(self, ax=None):
        import matplotlib.pyplot as plt

        viz.plot_obstacles(ax or plt.gca(), [(self.cx, self.cy, self.radius)])


class Map:
    """Occupancy-grid map (reference: map.py:44-155).

    ``data`` is the binary numpy grid (1=free, 0=occupied) like the
    reference's; the device-side :class:`GridMap` twin is kept in sync and is
    what the jitted control loop reads.
    """

    def __init__(self, file_path: str, origin, resolution: float,
                 threshold_occupied: int = 100):
        self.file_path = file_path
        self.origin = origin
        self.resolution = resolution
        self.threshold_occupied = threshold_occupied

        data = maps_util.load_map_image(file_path, threshold_occupied)
        self.data = data
        self.height, self.width = data.shape
        self.obstacles: list[Obstacle] = []
        self.boundaries: list = []
        self._grid = grid_ops.make_grid_map(data.astype(np.float32), origin,
                                            resolution)

    @property
    def grid(self) -> grid_ops.GridMap:
        return self._grid

    def w2m(self, x: float, y: float):
        """World -> pixel (reference: map.py:77-88), float64 host math."""
        dx = int(np.floor((x - self.origin[0]) / self.resolution))
        dy = int(np.floor((y - self.origin[1]) / self.resolution))
        return dx, dy

    def m2w(self, dx: int, dy: int):
        """Pixel -> world cell center (reference: map.py:90-101)."""
        x = (dx + 0.5) * self.resolution + self.origin[0]
        y = (dy + 0.5) * self.resolution + self.origin[1]
        return x, y

    def add_obstacles(self, obstacles: Sequence[Obstacle]) -> None:
        """Rasterize circular obstacles (reference: map.py:116-137)."""
        self.obstacles.extend(obstacles)
        obs = [(o.cx, o.cy, o.radius) for o in obstacles]
        self._grid = maps_util.add_obstacles_host(self._grid, self.origin,
                                                  self.resolution, obs)
        self.data = np.asarray(self._grid.occ).astype(np.int8)

    def add_boundary(self, boundaries: Sequence) -> None:
        """Rasterize line boundaries (reference: map.py:139-155)."""
        self.boundaries.extend(boundaries)
        starts = [b[0] for b in boundaries]
        ends = [b[1] for b in boundaries]
        self._grid = grid_ops.add_boundary(self._grid, starts, ends)
        self.data = np.asarray(self._grid.occ).astype(np.int8)


class Waypoint:
    """Read/write view over one row of the struct-of-arrays path
    (reference Waypoint object: reference_path.py:20-57)."""

    __slots__ = ("_rp", "_i")

    def __init__(self, rp: "ReferencePath", i: int):
        object.__setattr__(self, "_rp", rp)
        object.__setattr__(self, "_i", i)

    def _np(self, field):
        return np.asarray(getattr(self._rp.path_data, field))

    @property
    def x(self):
        return float(self._np("x")[self._i])

    @property
    def y(self):
        return float(self._np("y")[self._i])

    @property
    def psi(self):
        return float(self._np("psi")[self._i])

    @property
    def kappa(self):
        return float(self._np("kappa")[self._i])

    @property
    def v_ref(self):
        return float(self._np("v_ref")[self._i])

    @property
    def lb(self):
        return float(self._np("lb")[self._i])

    @property
    def ub(self):
        return float(self._np("ub")[self._i])

    @property
    def static_border_cells(self):
        bu = self._np("border_ub")[self._i]
        bl = self._np("border_lb")[self._i]
        return (tuple(bu.tolist()), tuple(bl.tolist()))

    @property
    def dynamic_border_cells(self):
        cells = self._rp._dynamic_border_cells
        if cells is None:
            return self.static_border_cells
        bu, bl = cells[self._i]
        return (tuple(bu), tuple(bl))

    def __sub__(self, other: "Waypoint") -> float:
        """Euclidean distance (reference: reference_path.py:50-57)."""
        return math.hypot(self.x - other.x, self.y - other.y)


class ReferencePath:
    """Reference path (reference: reference_path.py:65-648)."""

    def __init__(self, map: Map, wp_x, wp_y, resolution: float,
                 smoothing_distance: int, max_width: float, circular: bool):
        self.map = map
        self.eps = 1e-12
        self.resolution = resolution
        self.smoothing_distance = smoothing_distance
        self.circular = circular

        cfg = PathConfig(wp_x=tuple(wp_x), wp_y=tuple(wp_y),
                         resolution=resolution,
                         smoothing_distance=smoothing_distance,
                         max_width=max_width, circular=circular)
        self.path_data: PathData = build_reference_path(map.grid, cfg)
        self.n_waypoints = self.path_data.n_wp
        self.length = float(self.path_data.length)
        self.segment_lengths = np.asarray(self.path_data.seg_len).tolist()
        self._dynamic_border_cells = None

    @property
    def waypoints(self):
        return [Waypoint(self, i) for i in range(self.n_waypoints)]

    def get_waypoint(self, wp_id: int) -> Waypoint:
        """Circular indexing; clamps at the end of non-circular paths
        instead of exiting (reference_path.py:356-371, SURVEY.md Q4)."""
        if wp_id >= self.n_waypoints:
            if self.circular:
                wp_id = wp_id % self.n_waypoints
            else:
                wp_id = self.n_waypoints - 1
        return Waypoint(self, wp_id)

    def compute_speed_profile(self, Constraints) -> None:
        """Curvature-limited speed profile (reference_path.py:289-354).
        ``Constraints``: SpeedProfileConstraints or the reference's dict."""
        if isinstance(Constraints, dict):
            Constraints = SpeedProfileConstraints(
                a_min=Constraints["a_min"], a_max=Constraints["a_max"],
                v_min=Constraints["v_min"], v_max=Constraints["v_max"],
                ay_max=Constraints["ay_max"])
        self.path_data = compute_speed_profile(self.path_data, Constraints)

    def update_path_constraints(self, wp_id: int, N: int, min_width: float,
                                safety_margin: float):
        """Dynamic corridor (reference_path.py:522-648).  Returns
        (ub, lb, border_cells) like the reference."""
        cor = cons.update_path_constraints(self.map.grid, self.path_data,
                                           jnp.asarray(wp_id, jnp.int32), N,
                                           min_width, safety_margin)
        ub = np.asarray(cor.ub)
        lb = np.asarray(cor.lb)
        bu = np.asarray(cor.border_ub)
        bl = np.asarray(cor.border_lb)
        cells = [((bu[i][0], bu[i][1]), (bl[i][0], bl[i][1])) for i in range(N)]
        # mirror the reference's side effect of storing dynamic border cells
        # on waypoints (reference_path.py:646) for show()
        if self._dynamic_border_cells is None:
            self._dynamic_border_cells = {}
        for k in range(N):
            idx = (wp_id + k) % self.n_waypoints
            self._dynamic_border_cells[idx] = (tuple(bu[k]), tuple(bl[k]))
        return ub, lb, cells

    def show(self, display_drivable_area: bool = True, ax=None):
        """Render map + path + borders + dynamic corridor
        (reference_path.py:373-464)."""
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        viz.plot_map(ax, self.map.grid)
        viz.plot_path(ax, self.path_data, display_drivable_area)
        # dynamic corridor (orange): per-waypoint border cells written by
        # update_path_constraints, static borders where never updated — the
        # reference draws these lines through every waypoint's
        # dynamic_border_cells (reference_path.py:445-460, which initialize
        # to the static cells at construction, reference_path.py:47-48)
        if display_drivable_area and self._dynamic_border_cells is not None:
            bu = np.asarray(self.path_data.border_ub).copy()
            bl = np.asarray(self.path_data.border_lb).copy()
            for idx, (u, l) in self._dynamic_border_cells.items():
                bu[idx] = u
                bl[idx] = l
            viz.plot_corridor(ax, bu, bl)
        viz.plot_obstacles(ax, [(o.cx, o.cy, o.radius) for o in self.map.obstacles])
        return ax


class TemporalState:
    """(x, y, psi) view (reference: spatial_bicycle_models.py:25-46)."""

    def __init__(self, x=0.0, y=0.0, psi=0.0):
        self.x = x
        self.y = y
        self.psi = psi


class SimpleSpatialState:
    """(e_y, e_psi, t) view (reference: spatial_bicycle_models.py:94-109)."""

    def __init__(self, e_y=0.0, e_psi=0.0, t=0.0):
        self.e_y = e_y
        self.e_psi = e_psi
        self.t = t

    def __getitem__(self, i):
        return [self.e_y, self.e_psi, self.t][i]

    def __len__(self):
        return 3


class BicycleModel:
    """Spatial kinematic bicycle (reference: spatial_bicycle_models.py:322-417).

    Owns the per-lane :class:`CarState` pytree; ``drive`` runs the jitted
    nonlinear plant step on device.
    """

    def __init__(self, reference_path: ReferencePath, length: float,
                 width: float, Ts: float):
        self.reference_path = reference_path
        self.length = length
        self.width = width
        self.Ts = Ts
        self.n_states = 3
        self.eps = 1e-12
        self.safety_margin = width / math.sqrt(2.0)
        self._model_cfg = ModelConfig(length=length, width=width, Ts=Ts)
        self._N = 30  # replaced when an MPC attaches
        self._state: CarState = init_car_state(reference_path.path_data, self._N)

    # --- state views -------------------------------------------------
    @property
    def state(self) -> CarState:
        return self._state

    @property
    def temporal_state(self) -> TemporalState:
        s = self._state
        return TemporalState(float(s.x), float(s.y), float(s.psi))

    @property
    def spatial_state(self) -> SimpleSpatialState:
        s = self._state
        return SimpleSpatialState(float(s.e_y), float(s.e_psi), 0.0)

    @property
    def s(self) -> float:
        return float(self._state.s)

    @property
    def wp_id(self) -> int:
        return int(self._state.wp_id)

    @property
    def current_waypoint(self) -> Waypoint:
        return Waypoint(self.reference_path, self.wp_id)

    # --- reference methods --------------------------------------------
    def t2s(self, reference_waypoint: Waypoint, reference_state):
        e_y, e_psi = bike.t2s(self.reference_path.path_data,
                              jnp.asarray(reference_waypoint._i),
                              jnp.asarray(reference_state.x),
                              jnp.asarray(reference_state.y),
                              jnp.asarray(reference_state.psi))
        return SimpleSpatialState(float(e_y), float(e_psi), 0.0)

    def s2t(self, reference_waypoint: Waypoint, reference_state):
        x, y, psi = bike.s2t(self.reference_path.path_data,
                             jnp.asarray(reference_waypoint._i),
                             jnp.asarray(reference_state[0]),
                             jnp.asarray(reference_state[1]))
        return TemporalState(float(x), float(y), float(psi))

    def get_current_waypoint(self) -> None:
        wp = bike.locate_waypoint(self.reference_path.path_data,
                                  self._state.s)
        self._state = self._state.replace(wp_id=wp)

    def set_pose(self, x: float, y: float, psi: float,
                 s: Optional[float] = None) -> None:
        """Inject an external pose estimate (the ROS-adaptation seam: the
        real car's pose came from a localization topic, README.md:76).

        Re-localizes on the path and refreshes the spatial state; ``s`` can
        be given directly when the estimator tracks arc length itself.
        """
        st = self._state.replace(x=jnp.float32(x), y=jnp.float32(y),
                                 psi=jnp.float32(psi))
        if s is not None:
            st = st.replace(s=jnp.float32(s))
        else:
            pd = self.reference_path.path_data
            # nearest waypoint by euclidean distance, then arc length there
            d2 = (pd.x - x) ** 2 + (pd.y - y) ** 2
            wp = jnp.argmin(d2).astype(jnp.int32)
            st = st.replace(s=pd.cum_len[wp], wp_id=wp)
        wp = bike.locate_waypoint(self.reference_path.path_data, st.s)
        e_y, e_psi = bike.t2s(self.reference_path.path_data, wp,
                              st.x, st.y, st.psi)
        self._state = st.replace(wp_id=wp, e_y=e_y, e_psi=e_psi)

    def drive(self, u) -> None:
        """Apply [v, delta] for one Ts (reference:
        spatial_bicycle_models.py:221-244)."""
        v, delta = float(u[0]), float(u[1])
        self._state = _drive_jit(self._state, self.reference_path.path_data,
                                 jnp.float32(v), jnp.float32(delta),
                                 self._model_cfg)

    def show(self, ax=None):
        import matplotlib.pyplot as plt

        s = self._state
        viz.plot_car(ax or plt.gca(), float(s.x), float(s.y), float(s.psi),
                     self.length, self.width)


@functools.partial(jax.jit, static_argnames=("model",))
def _drive_jit(state: CarState, path: PathData, v, delta, model: ModelConfig):
    return bike.drive(state, path, v, delta, model.length, model.Ts)


@functools.partial(jax.jit, static_argnames=("cfg", "model"))
def _control_jit(state: CarState, path: PathData, grid, cfg: MPCConfig,
                 model: ModelConfig):
    return mpc_step(state, path, grid, cfg, model)


def _diag(M, n):
    """Extract a cost diagonal from ndarray / scipy-sparse-like input."""
    M = np.asarray(M.todense()) if hasattr(M, "todense") else np.asarray(M)
    if M.ndim == 2:
        M = np.diagonal(M)
    return tuple(float(v) for v in M.reshape(-1)[:n])


class MPC:
    """LTV-MPC controller (reference: MPC.py:14-257)."""

    def __init__(self, model: BicycleModel, N: int, Q, R, QN,
                 StateConstraints: dict, InputConstraints: dict,
                 ay_max: float, solver: Optional[SolverConfig] = None):
        self.model = model
        self.N = N
        self.nx = 3
        self.nu = 2

        umin = np.asarray(InputConstraints["umin"], np.float64)
        umax = np.asarray(InputConstraints["umax"], np.float64)
        xmin = np.asarray(StateConstraints["xmin"], np.float64)
        xmax = np.asarray(StateConstraints["xmax"], np.float64)
        delta_max = math.atan(float(umax[1]) * model.length)

        self.config = MPCConfig(
            N=N, Q=_diag(Q, 3), R=_diag(R, 2), QN=_diag(QN, 3),
            v_max=float(umax[0]), v_min=float(umin[0]), delta_max=delta_max,
            ay_max=ay_max, xmin=tuple(xmin.tolist()), xmax=tuple(xmax.tolist()),
            solver=solver or SolverConfig())
        # size the model's cached control sequence + solver carry for this
        # horizon
        from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry

        model._N = N
        model._state = model._state.replace(u_seq=jnp.zeros((N * 2,)),
                                            solver=init_solver_carry(N))

        self.current_prediction = None
        self.current_control = np.zeros(self.nu * N)
        self.infeasibility_counter = 0

    def get_control(self):
        """One control step; returns np.array([v, delta])
        (reference: MPC.py:161-222)."""
        out = _control_jit(self.model._state, self.model.reference_path.path_data,
                           self.model.reference_path.map.grid, self.config,
                           self.model._model_cfg)
        self.model._state = out.state
        self.infeasibility_counter = int(out.state.infeasibility_count)
        useq = np.asarray(out.state.u_seq).reshape(self.N, 2)
        ctrl = useq.copy()
        ctrl[:, 1] = np.arctan(ctrl[:, 1] * self.model.length)
        self.current_control = ctrl.reshape(-1)
        xp, yp = predict_world_positions(self.model.reference_path.path_data,
                                         out.state.wp_id, out.X_pred)
        self.current_prediction = (np.asarray(xp), np.asarray(yp))
        if bool(out.state.failed):
            # reference exits the process here (MPC.py:218-220); we surface a
            # catchable error and keep the fleet semantics in the array path
            raise RuntimeError("No control signal computed! "
                               f"({self.N - 1} consecutive infeasible QPs)")
        return np.array([float(out.v), float(out.delta)])

    def update_prediction(self, spatial_state_prediction=None):
        return self.current_prediction

    def show_prediction(self, ax=None):
        import matplotlib.pyplot as plt

        if self.current_prediction is not None:
            viz.plot_prediction(ax or plt.gca(), *self.current_prediction)


class LidarModel:
    """Lidar sensor (reference: lidar_model.py:10-129)."""

    def __init__(self, FoV: float, range: float, resolution: float,
                 conservative: bool = False):
        """``conservative=True`` selects the exact corner-span scan semantics
        of the reference (lidar_model.py:75-108) — every beam an occupied
        cell's angular span touches is updated; the default fast mode
        point-samples each ray (see ops/lidar.scan)."""
        self.FoV = FoV
        self.range = range
        self.resolution = resolution
        self.conservative = conservative
        self.config = LidarConfig(FoV=FoV, range=range, resolution=resolution)
        self.n_measurements = self.config.n_beams
        angles = np.asarray(lidar_ops.beam_angles(self.config))
        self.measurements = np.stack(
            [angles, np.full_like(angles, range)], axis=0)
        self._last_scan = None

    def scan(self, car, map: Map):
        """Update ``measurements`` from the car pose (lidar_model.py:37-112).
        ``car`` needs x/y/psi attributes (TemporalState or BicycleModel)."""
        pose = car.temporal_state if hasattr(car, "temporal_state") else car
        out = _scan_jit(map.grid, jnp.float32(pose.x), jnp.float32(pose.y),
                        jnp.float32(pose.psi), self.config, self.conservative)
        self._last_scan = out
        self.measurements = np.asarray(lidar_ops.measurements(out))
        return self.measurements

    def update_map(self, car, map: Map, clear_free: bool = False) -> None:
        """Write the last scan back into the map (online map update)."""
        if self._last_scan is None:
            return
        pose = car.temporal_state if hasattr(car, "temporal_state") else car
        map._grid = lidar_ops.update_grid_from_scan(
            map.grid, jnp.float32(pose.x), jnp.float32(pose.y),
            jnp.float32(pose.psi), self._last_scan, self.config,
            clear_free=clear_free)
        map.data = np.asarray(map._grid.occ).astype(np.int8)

    def plot_scan(self, car, ax=None):
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        pose = car.temporal_state if hasattr(car, "temporal_state") else car
        ang = self.measurements[0] + pose.psi
        ex = pose.x + self.measurements[1] * np.cos(ang)
        ey = pose.y + self.measurements[1] * np.sin(ang)
        for i in range(self.n_measurements):
            ax.plot((pose.x, ex[i]), (pose.y, ey[i]), c="#5DADE2", lw=0.5)


@functools.partial(jax.jit, static_argnames=("cfg", "conservative"))
def _scan_jit(grid, x, y, psi, cfg: LidarConfig, conservative: bool = False):
    return lidar_ops.scan(grid, x, y, psi, cfg, conservative=conservative)
