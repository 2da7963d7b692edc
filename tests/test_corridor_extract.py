"""Fleet-scale dynamic-grid scanline extraction: all backends must agree
with the in-place gather semantics of ops/constraints.free_segments
(reference_path.py:466-520), bitwise — the values are 0/1 occupancies at
static per-waypoint sample coordinates."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.ops.constraints import (update_path_constraints,
                                                   select_corridor,
                                                   SegmentCandidates)
from multi_purpose_mpc_tpu.ops.corridor_extract import (
    build_scanline_table, extract_occ_gather, extract_occ_onehot,
    fleet_dynamic_segments, horizon_tables)
from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index


@pytest.fixture(scope="module")
def setup(sim_track):
    grid = sim_track["grid"]
    path = sim_track["path"]
    cfg = sim_track["mpc_cfg"]
    model = sim_track["model_cfg"]
    table = build_scanline_table(grid, path, cfg.n_scan_samples)

    B = 4
    rng = np.random.default_rng(0)
    wp = jnp.asarray(rng.integers(0, path.n_wp, B), jnp.int32)
    idx = jax.vmap(lambda w: gather_waypoint_index(path, w + 1,
                                                   jnp.arange(cfg.N)))(wp)
    # per-lane grids salted with random extra obstacles
    occ_b = np.broadcast_to(np.asarray(grid.occ),
                            (B,) + grid.occ.shape).copy()
    for b in range(B):
        occ_b[b, rng.integers(0, 500, 30), rng.integers(0, 500, 30)] = 0.0
    return dict(grid=grid, path=path, cfg=cfg, model=model, table=table,
                wp=wp, idx=idx, occ_b=jnp.asarray(occ_b))


def test_table_matches_inline_sampling(setup):
    """Static table px/py/cx/cy == what sample_line computes inline."""
    from multi_purpose_mpc_tpu.ops.grid import m2w
    from multi_purpose_mpc_tpu.ops.rays import sample_line

    grid, path, t = setup["grid"], setup["path"], setup["table"]
    s = jax.vmap(lambda a, b: sample_line(grid, a[0], a[1], b[0], b[1],
                                          t.px.shape[1]))(path.border_ub,
                                                          path.border_lb)
    np.testing.assert_array_equal(np.asarray(t.px),
                                  np.clip(np.asarray(s.px), 0, 499))
    np.testing.assert_array_equal(np.asarray(t.py),
                                  np.clip(np.asarray(s.py), 0, 499))
    cx, cy = m2w(grid, s.px, s.py)
    np.testing.assert_array_equal(np.asarray(t.cx), np.asarray(cx))
    np.testing.assert_array_equal(np.asarray(t.cy), np.asarray(cy))


def test_extraction_backends_agree(setup):
    """onehot == gather bitwise on per-lane grids, directly and through the
    dispatching extract_occ."""
    from multi_purpose_mpc_tpu.ops.corridor_extract import extract_occ

    t, idx, occ_b = setup["table"], setup["idx"], setup["occ_b"]
    px, py, _, _, _ = horizon_tables(t, idx)
    v_g = extract_occ_gather(occ_b, px, py)
    v_o = extract_occ_onehot(occ_b, px, py)
    np.testing.assert_array_equal(np.asarray(v_g), np.asarray(v_o))
    np.testing.assert_array_equal(
        np.asarray(extract_occ(occ_b, px, py, backend="onehot")),
        np.asarray(v_g))
    with pytest.raises(ValueError):
        extract_occ(occ_b, px, py, backend="pallas")


def test_extraction_backends_agree_shared(setup):
    """onehot == gather bitwise on one shared grid (odd chunking too)."""
    t, idx, grid = setup["table"], setup["idx"], setup["grid"]
    px, py, _, _, _ = horizon_tables(t, idx)
    v_g = extract_occ_gather(grid.occ, px, py)
    np.testing.assert_array_equal(np.asarray(v_g),
                                  np.asarray(extract_occ_onehot(grid.occ,
                                                                px, py)))
    np.testing.assert_array_equal(
        np.asarray(v_g),
        np.asarray(extract_occ_onehot(grid.occ, px, py, chunk=7)))


def test_fleet_corridor_matches_per_lane_reference(setup):
    """Table extraction + shared segment logic + selection == the per-lane
    update_path_constraints pipeline, bitwise, on per-lane dynamic grids."""
    grid, path, cfg, model = (setup["grid"], setup["path"], setup["cfg"],
                              setup["model"])
    t, wp, idx, occ_b = (setup["table"], setup["wp"], setup["idx"],
                         setup["occ_b"])
    sm = model.safety_margin
    segs = fleet_dynamic_segments(occ_b, t, idx, 2.0 * sm, cfg.max_segments,
                                  backend="gather")
    cor_new = jax.vmap(lambda i, u, l, v: select_corridor(
        path, i, SegmentCandidates(ub_xy=u, lb_xy=l, valid=v), sm))(
            idx, segs.ub_xy, segs.lb_xy, segs.valid)
    cor_ref = jax.vmap(lambda o, w: update_path_constraints(
        grid.replace(occ=o), path, w + 1, cfg.N, 2.0 * sm, sm,
        cfg.n_scan_samples, cfg.max_segments), in_axes=(0, 0))(occ_b, wp)
    np.testing.assert_array_equal(np.asarray(cor_new.ub),
                                  np.asarray(cor_ref.ub))
    np.testing.assert_array_equal(np.asarray(cor_new.lb),
                                  np.asarray(cor_ref.lb))
