"""The port's synthetic scenes (``codenerf_tpu_torch/data/synthetic.py``)
against the JAX package's numpy path (``codenerf_tpu/data/synthetic.py``)
on the CPU. Both packages draw with numpy and render in f64 numpy, so the
bar is bit-equality: images, poses, focals, near/far and every generation
parameter, for spheres and chairs, with and without the surface pattern,
with ``params_only``; a cache entry written by either package read back
by the other; ``write_srn_layout`` trees byte-identical and read back by
the port's ``SRNDataset``."""

import filecmp
import os

import numpy as np
import pytest

from codenerf_tpu.data import synthetic as j_syn
from codenerf_tpu_torch.data import synthetic as t_syn
from codenerf_tpu_torch.data.srn import SRNDataset


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
@pytest.mark.parametrize("pattern", [False, True])
def test_scene_bit_equal(geometry, pattern):
    kw = dict(n_objects=3, n_views=4, H=16, W=16, seed=11,
              geometry=geometry, pattern=pattern)
    want = j_syn.synthetic_scene(**kw)
    got = t_syn.synthetic_scene(**kw)
    _assert_same(got, want)
    # Not vacuous: the objects are drawn, not background alone.
    assert (got["images"] < 255).mean() > 0.05


def test_scene_bit_equal_non_square():
    """A non-square view with its own focal and camera distance."""
    kw = dict(n_objects=2, n_views=3, H=12, W=20, focal=17.5,
              cam_distance=3.3, seed=4, pattern=True)
    _assert_same(t_syn.synthetic_scene(**kw), j_syn.synthetic_scene(**kw))


@pytest.mark.parametrize("geometry", ["sphere", "chair"])
def test_params_only_bit_equal(geometry):
    """Poses and generation parameters alone, the same draws as the
    rendering call's."""
    kw = dict(n_objects=5, n_views=6, H=16, W=16, seed=2, pattern=True,
              geometry=geometry)
    got = t_syn.synthetic_scene(params_only=True, **kw)
    _assert_same(got, j_syn.synthetic_scene(params_only=True, **kw))
    full = t_syn.synthetic_scene(**kw)
    for k, v in got.items():
        np.testing.assert_array_equal(full[k], v)


def test_other_backends_raise():
    """The port spells its device backend ``device``: the JAX package's
    ``jax`` raises a ``ValueError`` that names it, with no quiet
    fallback to another backend."""
    with pytest.raises(ValueError, match="'device'"):
        t_syn.synthetic_scene(n_objects=1, n_views=1, backend="jax")
    with pytest.raises(ValueError, match="geometry"):
        t_syn.synthetic_scene(geometry="torus")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_entries_interchange(tmp_path, writer):
    """An entry written by one package is found under the same key by the
    other and loads back bit-equal to a fresh scene."""
    kw = dict(n_objects=2, n_views=3, H=16, W=16, seed=7, pattern=True,
              geometry="chair")
    first, second = ((j_syn, t_syn) if writer == "jax" else (t_syn, j_syn))
    first.synthetic_scene_cached(str(tmp_path), **kw)
    entries = os.listdir(tmp_path)
    loaded = second.synthetic_scene_cached(str(tmp_path), **kw)
    assert os.listdir(tmp_path) == entries and len(entries) == 1
    fresh = j_syn.synthetic_scene(**kw)
    assert set(loaded) == set(fresh)
    for k, v in fresh.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
        else:
            assert loaded[k] == v, k


def test_srn_layout_byte_identical(tmp_path):
    """Both writers produce the same files, byte for byte, and the port's
    loader reads back the scene's images and poses."""
    scene = j_syn.synthetic_scene(n_objects=2, n_views=3, H=16, W=16,
                                  seed=5, pattern=True)
    j_dir = j_syn.write_srn_layout(str(tmp_path / "jax"), scene)
    t_dir = t_syn.write_srn_layout(str(tmp_path / "port"), scene)
    files = []
    for root, _, names in os.walk(j_dir):
        files += [os.path.relpath(os.path.join(root, n), j_dir)
                  for n in names]
    t_files = []
    for root, _, names in os.walk(t_dir):
        t_files += [os.path.relpath(os.path.join(root, n), t_dir)
                    for n in names]
    assert sorted(files) == sorted(t_files) and len(files) == 2 * (1 + 6)
    match, mismatch, errors = filecmp.cmpfiles(j_dir, t_dir, files,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(files)
    ds = SRNDataset(cat="srn_cars", splits="cars_train",
                    data_dir=str(tmp_path / "port"))
    assert ds.ids == ["obj0000", "obj0001"]
    np.testing.assert_array_equal(ds.images, scene["images"])
    np.testing.assert_allclose(ds.poses, scene["poses"], atol=1e-6)
    np.testing.assert_array_equal(ds.focals, scene["focals"])
