"""The port's loader of the native host library (`tpusph_torch/utils/
native.py`) against the JAX package's and against the numpy rasters: the
library is host code, every caller's numpy path must give the same bytes."""

import os
import sys

import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import random_positions as jrandom_positions
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.init import random_positions
from tpusph_torch.utils import cuda_build, native
from tpusph_torch.viz import render
from tpusph_torch.viz.project import project_pixels_packed

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import LIBRARY, jax_native  # noqa: E402,F401

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="no g++: native library unavailable")


def _positions(seed: int, n: int = 5000) -> np.ndarray:
    """Inside and outside the box, so that the raster's clipping runs."""
    return np.random.default_rng(seed).uniform(-1, 11, size=(n, 3)).astype(np.float32)


def test_library_is_built_in_the_port_s_directory():
    path = native.library_path()
    assert path.exists() and path.parent == cuda_build.BUILD_DIR
    assert os.path.join("native", "build") not in str(path)  # not the JAX package's cache
    assert native.get_lib().sph_native_abi_version() == native.ABI_VERSION == 2
    assert native.get_lib() is native.get_lib()


@pytest.mark.parametrize("seed", [1, 2])
def test_native_raster_is_the_numpy_raster(seed):
    pos = _positions(seed)
    got = native.render_frame_native(pos)
    assert got.shape == (render.HEIGHT, render.WIDTH, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, render._render_frame_numpy(pos))
    np.testing.assert_array_equal(render.render_frame(pos), got)
    assert (got[..., 2] == 255).sum() > (got[..., 0] == 255).sum() > 0  # points and wireframe


@pytest.mark.parametrize("seed", [3, 4])
def test_native_packed_raster_is_the_numpy_raster(seed):
    pos = _positions(seed)
    packed = project_pixels_packed(torch.from_numpy(pos)).numpy()
    got = native.render_packed_native(packed)
    np.testing.assert_array_equal(got, render._render_frame_packed_numpy(packed))
    np.testing.assert_array_equal(render.render_frame_packed(packed), got)
    np.testing.assert_array_equal(got, render._render_frame_numpy(pos))


def test_rasters_without_the_library(monkeypatch):
    """With no library (no compiler) every caller takes its numpy path and
    gives the same bytes."""
    pos = _positions(5)
    packed = project_pixels_packed(torch.from_numpy(pos)).numpy()
    with_lib = render.render_frame(pos), render.render_frame_packed(packed)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.render_frame_native(pos) is None and native.render_packed_native(packed) is None
    assert native.reference_random_positions(4, 10.0, 1) is None
    np.testing.assert_array_equal(render.render_frame(pos), with_lib[0])
    np.testing.assert_array_equal(render.render_frame_packed(packed), with_lib[1])
    cfg = tdefault(64)
    assert torch.equal(random_positions(cfg, 3, reference_rng=True), random_positions(cfg, 3))


@pytest.mark.parametrize("seed", [1, 7])
def test_reference_random_positions_match_tpusph(seed, jax_native):
    got = native.reference_random_positions(1000, 10.0, seed)
    want = jax_native.reference_random_positions(1000, 10.0, seed)
    assert want is not None, f"tpusph could not build or load {LIBRARY}"
    assert got.dtype == np.float32 and got.shape == (1000, 3)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1.0 and got.max() <= 9.0


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_reference_rng_init_matches_tpusph(seed, jax_native):
    """`random_positions(..., reference_rng=True)` bit for bit; seed 0 is
    raised to 1, glibc's default, in both packages."""
    assert jax_native.get_lib() is not None, f"tpusph could not build or load {LIBRARY}"
    got = random_positions(tdefault(777), seed, reference_rng=True)
    want = jrandom_positions(jdefault(777), seed, reference_rng=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if seed == 0:
        assert torch.equal(got, random_positions(tdefault(777), 1, reference_rng=True))
