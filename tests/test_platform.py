"""Platform plumbing: the backend choice, the PNG decoder, the pytree
dataclass helper and the compile-cache helper."""

import dataclasses
import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.backends import Backends, select_backends

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = os.path.join(REPO, "assets", "maps")


def test_backends_cpu():
    assert select_backends("cpu") == Backends(
        solver="xla", extract="gather", scan="march", writeback="scatter")
    assert select_backends("cpu", extract="onehot", scan="cells",
                           writeback="dense") == Backends(
        solver="xla", extract="onehot", scan="cells", writeback="dense")


def test_backends_gpu():
    assert select_backends("gpu") == Backends(
        solver="kernel", extract="gather", scan="march", writeback="scatter")
    assert select_backends("gpu", solver="xla").solver == "xla"


def test_backends_reject_kernel_off_gpu(sim_track):
    """An explicit kernel request where it cannot compile raises — at the
    selector and through the public fleet entry point — instead of
    quietly running the reference solver or interpret mode."""
    from multi_purpose_mpc_tpu.config import SimConfig
    from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet

    with pytest.raises(ValueError, match="kernel"):
        select_backends("cpu", solver="kernel")
    with pytest.raises(ValueError, match="unknown"):
        select_backends("gpu", solver="pallas")
    path = compute_speed_profile(sim_track["path"], sim_track["speed_cfg"])
    cfg = dataclasses.replace(sim_track["mpc_cfg"], solver_backend="kernel")
    with pytest.raises(ValueError, match="kernel"):
        simulate_fleet(sim_track["grid"], path, cfg, sim_track["model_cfg"],
                       SimConfig(max_steps=2), init_fleet(path, cfg.N, 2))


@pytest.mark.parametrize("name,shape,red_sha256", [
    ("sim_map.png", (500, 500, 3),
     "4dfb6a09430cc0ce98bfb3f10ab76acd6f846d632bbd8e85997147f17824434b"),
    ("real_map.png", (767, 867, 4),
     "05705d2f099a4e1caa6abd7f391d8a6d7d858667688593751901c001dbe49ae7"),
])
def test_png_decoder_matches_recorded_digest(name, shape, red_sha256):
    """Decoded pixels equal those of the image library the loader used
    before (digest of the red channel it binarizes, recorded once)."""
    from multi_purpose_mpc_tpu.utils.png import read_png

    img = read_png(os.path.join(MAPS, name))
    assert img.shape == shape and img.dtype == np.uint8
    red = np.ascontiguousarray(img[..., 0])
    assert hashlib.sha256(red.tobytes()).hexdigest() == red_sha256


def test_png_map_facts():
    """Known Sim_Track facts after preprocessing: 500x500, free ~0.4315."""
    from multi_purpose_mpc_tpu.config import sim_track_preset
    from multi_purpose_mpc_tpu.utils.maps import load_grid_map

    grid = load_grid_map(sim_track_preset(asset_dir=MAPS)[0])
    assert grid.occ.shape == (500, 500)
    assert abs(float(np.asarray(grid.occ).mean()) - 0.4315) < 5e-4


def test_png_decoder_rejects_other_files(tmp_path):
    from multi_purpose_mpc_tpu.utils.png import read_png

    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="PNG"):
        read_png(str(bad))


def test_pytree_dataclass():
    """Leaves vs static fields, ``replace``, frozen, and a jit round trip
    in which the static field stays a Python value."""
    from multi_purpose_mpc_tpu.utils import pytree

    @pytree.dataclass
    class Thing:
        a: jnp.ndarray
        b: jnp.ndarray
        tag: int = pytree.field(static=True, default=3)

    t = Thing(a=jnp.ones(2), b=jnp.zeros(3))
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2
    t2 = t.replace(a=jnp.full(2, 5.0))
    assert float(t2.a[0]) == 5.0 and t2.tag == 3 and float(t.a[0]) == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.a = jnp.zeros(2)

    @jax.jit
    def f(x):
        assert isinstance(x.tag, int)  # static: not traced
        return x.replace(b=x.b + x.tag)

    out = f(t)
    assert isinstance(out, Thing) and out.tag == 3
    np.testing.assert_array_equal(np.asarray(out.b), np.full(3, 3.0))
    # a different static value is a different pytree structure
    assert jax.tree_util.tree_structure(t.replace(tag=4)) != treedef


@pytest.fixture
def _restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   _restore_cache_config):
    from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            _restore_cache_config):
    from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
