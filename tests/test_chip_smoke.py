"""Host-side checks of chip_smoke.py: its refusal without a GPU and the
helpers its gates rest on (per-lane equality, map-difference reach, the
knife-edge test of failed lanes)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from multi_purpose_mpc_tpu.config import SimConfig
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lanes_equal_marks_each_lane():
    class Run:
        def __init__(self, s, x):
            self.final_state = {"s": s, "m": np.zeros((4, 2))}
            self.log = {"x": x}

    s = np.arange(4.0)
    x = np.arange(12.0).reshape(3, 4)
    x2 = x.copy()
    x2[1, 2] += 1e-7
    s2 = s.copy()
    s2[0] = -s2[0] - 1.0
    same = cs.lanes_equal(Run(s, x), Run(s2, x2))
    np.testing.assert_array_equal(same, [False, True, False, True])


def test_cell_reach(sim_track):
    grid = sim_track["grid"]
    res, (ox, oy) = float(grid.resolution), np.asarray(grid.origin)
    # centres of cells (row 100, col 200) and (row 100, col 400)
    cx = lambda col: (col + 0.5) * res + ox
    cy = (100 + 0.5) * res + oy
    reach = cs.cell_reach(grid, np.array([100, 100]), np.array([200, 400]),
                          np.array([cx(200), 5.0]), np.array([cy, 0.0]))
    np.testing.assert_allclose(reach, cx(400) - cx(200), rtol=1e-6)


def test_ulp_copies(sim_track, monkeypatch):
    monkeypatch.setattr(cs, "FLEET", 16)
    path, cfg = sim_track["path"], sim_track["mpc_cfg"]
    e_y = np.array([0.02, -0.013], np.float32)
    fleet = init_fleet(path, cfg.N, 2, e_y0=jnp.asarray(e_y),
                       wp_id0=jnp.array([87, 12], jnp.int32))
    copies = cs.ulp_copies(path, cfg, fleet, 1)
    e = np.asarray(copies.e_y)
    assert e[8] == e_y[1]
    np.testing.assert_array_equal(np.abs(np.diff(e)),
                                  abs(np.spacing(e_y[1])))
    assert (np.asarray(copies.wp_id) == 12).all()


def test_knife_edge_lanes(sim_track, monkeypatch):
    """A lane failed by one solver where no ulp-perturbed copy fails under
    the other raises; no failed lane passes with zero exemptions."""
    monkeypatch.setattr(cs, "FLEET", 8)
    grid, path = sim_track["grid"], sim_track["path"]
    model, cfg = sim_track["model_cfg"], sim_track["mpc_cfg"]
    from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile

    path = compute_speed_profile(path, sim_track["speed_cfg"])
    fleet = init_fleet(path, cfg.N, 8,
                       e_y0=jnp.linspace(-0.02, 0.02, 8, dtype=jnp.float32))
    sim = SimConfig(max_steps=3)
    res = simulate_fleet(grid, path, cfg, model, sim, fleet)
    assert cs.knife_edge_lanes(grid, path, model, sim, fleet, {
        "platform": (cfg, res), "xla": (cfg, res)}) == 0
    fake = res._replace(final_state=res.final_state.replace(
        failed=res.final_state.failed.at[3].set(True)))
    with pytest.raises(AssertionError, match="one solver only"):
        cs.knife_edge_lanes(grid, path, model, sim, fleet, {
            "platform": (cfg, fake), "xla": (cfg, res)})
