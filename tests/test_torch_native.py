"""The port's native ray sampler (``codenerf_tpu_torch/data/native.py``,
built from ``native/ray_sampler.cpp`` with ``g++``) and the pipeline's
``native`` and ``auto`` backends, against the JAX package's binding of
the same source (``codenerf_tpu/data/native.py``) on the CPU.

The counterparts of ``tests/test_native.py``'s eleven tests (the batch
contract, gathers, determinism, thread counts, crop bounds, uniformity,
``rays_of_view`` against the numpy path, the compact layout, the
pipeline backends, error codes), then bit-equality with the JAX package:
both layouts on the same seed and step at 1, 4 and 8 threads, and the
pipelines' ``prefetch`` streams. The two backends draw from different
streams by design, so the native batches are held to the JAX package's
native batches, not to the numpy backend's."""

import numpy as np
import pytest

from codenerf_tpu.data import native as j_native
from codenerf_tpu.data.pipeline import RayBatchPipeline as JPipeline
from codenerf_tpu_torch.data import native
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.data.synthetic import synthetic_scene


def _scene(n=3, v=4, H=16, W=16, seed=0):
    return synthetic_scene(n_objects=n, n_views=v, H=H, W=W, seed=seed)


def _args(s):
    return s["images"], s["poses"], s["focals"]


def _assert_same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_builds_into_the_port_build_dir():
    assert native.native_available(), native.build_error()
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_kernels")


def test_sample_contract_and_gather_correctness():
    s = _scene()
    b = native.sample_batch(*_args(s), batch=512, seed=7, step=1,
                            v0=0, v1=16, u0=0, u1=16)
    assert b["obj"].shape == (512,) and b["obj"].dtype == np.int32
    assert b["uv"].shape == (512, 2) and b["c2w"].shape == (512, 3, 4)
    assert set(np.unique(b["obj"])) <= set(range(3))
    np.testing.assert_array_equal(b["focal"], s["focals"][b["obj"]])
    for i in range(0, 512, 37):
        o = b["obj"][i]
        u, v = b["uv"][i].astype(int)
        candidates = s["images"][o, :, v, u].astype(np.float32) / 255.0
        assert np.any(np.all(np.abs(candidates - b["rgb"][i]) < 1e-6,
                             axis=-1))
        assert np.all(np.abs(s["poses"][o, :, :3, :] - b["c2w"][i]) < 1e-6,
                      axis=(1, 2)).any()


def test_determinism_and_step_variation():
    s = _scene()
    a1 = native.sample_batch(*_args(s), 256, 7, 5, 0, 16, 0, 16)
    a2 = native.sample_batch(*_args(s), 256, 7, 5, 0, 16, 0, 16)
    b = native.sample_batch(*_args(s), 256, 7, 6, 0, 16, 0, 16)
    _assert_same(a1, a2)
    assert not np.array_equal(a1["uv"], b["uv"])


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_thread_count_invariance_and_jax_bits(threads):
    """Each ray is a pure function of (seed, step, index): the same bits
    at any thread count, and the JAX package's bits."""
    s = _scene(H=32, W=32)
    got = native.sample_batch(*_args(s), 8192, 3, 9, 0, 32, 0, 32,
                              n_threads=threads)
    _assert_same(got, native.sample_batch(*_args(s), 8192, 3, 9, 0, 32, 0,
                                          32, n_threads=1))
    _assert_same(got, j_native.sample_batch(*_args(s), 8192, 3, 9, 0, 32, 0,
                                            32, n_threads=threads))


def test_crop_bounds_respected():
    s = _scene(H=32, W=32)
    b = native.sample_batch(*_args(s), 4096, 1, 1, 8, 24, 8, 24)
    assert b["uv"][:, 0].min() >= 8 and b["uv"][:, 0].max() < 24
    assert b["uv"][:, 1].min() >= 8 and b["uv"][:, 1].max() < 24


def test_sampling_is_roughly_uniform():
    s = _scene(n=4, v=4, H=16, W=16)
    b = native.sample_batch(*_args(s), 40000, 11, 2, 0, 16, 0, 16)
    counts = np.bincount(b["obj"], minlength=4)
    assert (np.abs(counts / 40000 - 0.25) < 0.02).all()
    u_hist = np.bincount(b["uv"][:, 0].astype(int), minlength=16)
    assert (np.abs(u_hist / 40000 - 1 / 16) < 0.01).all()


@pytest.mark.parametrize("crop", [False, True])
def test_rays_of_view_matches_numpy_path(crop):
    """Against the port pipeline's numpy ``rays_of_view`` (rgb within an
    ulp: ``x * (1/255)`` against ``x / 255``), and the JAX binding's bits."""
    s = _scene()
    pipe = RayBatchPipeline(*_args(s))
    ref = pipe.rays_of_view(1, 2, crop=crop)
    nat = native.rays_of_view(*_args(s), 1, 2, *pipe._pixel_bounds(crop))
    assert list(nat) == list(ref)
    for k in ref:
        if k == "rgb":
            np.testing.assert_allclose(nat[k], ref[k], atol=1e-6)
        else:
            np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
    _assert_same(nat, j_native.rays_of_view(*_args(s), 1, 2,
                                            *pipe._pixel_bounds(crop)))
    _assert_same(ref, JPipeline(*_args(s)).rays_of_view(1, 2, crop=crop))


def test_pipeline_native_backend():
    s = _scene()
    pipe = RayBatchPipeline(*_args(s), seed=5, backend="native")
    assert pipe.backend == "native"
    b = pipe.sample(128, crop=True)
    assert b["rgb"].shape == (128, 3)
    H, W = pipe.H, pipe.W
    assert b["uv"][:, 0].min() >= W // 4 and b["uv"][:, 0].max() < W - W // 4
    assert b["uv"][:, 1].min() >= H // 4 and b["uv"][:, 1].max() < H - H // 4
    b2 = pipe.sample(128, crop=True)
    assert not np.array_equal(b["uv"], b2["uv"])
    # The pipeline's own steps are the JAX pipeline's: 1, 2, ...
    jpipe = JPipeline(*_args(s), seed=5, backend="native")
    _assert_same(b, jpipe.sample(128, crop=True))
    _assert_same(b2, jpipe.sample(128, crop=True))


def test_compact_matches_full_layout():
    s = _scene(H=32, W=32)
    full = native.sample_batch(*_args(s), 2048, 13, 4, 0, 32, 0, 32)
    comp = native.sample_batch_compact(*_args(s), 2048, 13, 4, 0, 32, 0, 32)
    assert comp["uv"].dtype == np.int16 and comp["rgb"].dtype == np.uint8
    np.testing.assert_array_equal(full["obj"], comp["obj"])
    np.testing.assert_array_equal(full["uv"].astype(np.int16), comp["uv"])
    np.testing.assert_allclose(comp["rgb"].astype(np.float32) / 255.0,
                               full["rgb"], atol=1e-7)
    o, v = comp["obj"], comp["view"]
    np.testing.assert_array_equal(s["poses"][o, v, :3, :], full["c2w"])
    np.testing.assert_array_equal(
        s["images"][o, v, comp["uv"][:, 1], comp["uv"][:, 0]], comp["rgb"])


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_compact_thread_count_invariance_and_jax_bits(threads):
    s = _scene(H=32, W=32)
    got = native.sample_batch_compact(*_args(s), 8192, 3, 9, 0, 32, 0, 32,
                                      n_threads=threads)
    _assert_same(got, native.sample_batch_compact(
        *_args(s), 8192, 3, 9, 0, 32, 0, 32, n_threads=1))
    _assert_same(got, j_native.sample_batch_compact(
        *_args(s), 8192, 3, 9, 0, 32, 0, 32, n_threads=threads))


def test_pipeline_native_compact_backend():
    s = _scene()
    pipe = RayBatchPipeline(*_args(s), seed=5, backend="native")
    b = pipe.sample(128, compact=True)
    assert set(b) == {"obj", "view", "uv", "rgb"}
    assert b["rgb"].dtype == np.uint8
    _assert_same(b, JPipeline(*_args(s), seed=5, backend="native").sample(
        128, compact=True))


def test_error_codes():
    """The library's codes, raised as the JAX binding raises them."""
    s = _scene()
    for fn in (native.sample_batch, native.sample_batch_compact):
        with pytest.raises(RuntimeError, match="code 2"):
            fn(*_args(s), 16, 0, 0, 0, 99, 0, 16)       # v1 > H
        with pytest.raises(RuntimeError, match="code 2"):
            fn(*_args(s), 16, 0, 0, 4, 4, 0, 16)        # empty rows
        with pytest.raises(RuntimeError, match="code 1"):
            fn(*_args(s), 0, 0, 0, 0, 16, 0, 16)        # no rays
    with pytest.raises(RuntimeError, match="code 1"):
        native.rays_of_view(*_args(s), 3, 0, 0, 16, 0, 16)   # obj >= N
    with pytest.raises(RuntimeError, match="code 2"):
        native.rays_of_view(*_args(s), 0, 0, 0, 16, 0, 17)   # u1 > W
    with pytest.raises(ValueError, match="poses"):
        native.sample_batch(s["images"], s["poses"][:, :2], s["focals"],
                            16, 0, 0, 0, 16, 0, 16)
    with pytest.raises(ValueError, match="focals"):
        native.sample_batch(s["images"], s["poses"],
                            s["focals"].astype(np.float64), 16, 0, 0, 0, 16,
                            0, 16)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seed,step", [(0, 1), (7, 5), (2 ** 40 + 3, 2 ** 33)])
def test_batches_bit_equal_to_jax(compact, seed, step):
    s = _scene(n=5, v=6, H=24, W=20, seed=4)
    fn, jfn = ((native.sample_batch_compact, j_native.sample_batch_compact)
               if compact else (native.sample_batch, j_native.sample_batch))
    for bounds in ((0, 24, 0, 20), (6, 18, 5, 15)):
        _assert_same(fn(*_args(s), 5000, seed, step, *bounds),
                     jfn(*_args(s), 5000, seed, step, *bounds))


@pytest.mark.parametrize("compact", [False, True])
def test_prefetch_streams_bit_equal_to_jax(compact):
    """Two prefetch streams of each pipeline, three batches each, the
    second on the crop: the same bits (steps ``(stream << 32) | i``); a
    stream resumed with ``skip`` continues where it was."""
    s = _scene(n=4, v=5, H=16, W=16, seed=9)
    port = RayBatchPipeline(*_args(s), seed=3, backend="native")
    jax_ = JPipeline(*_args(s), seed=3, backend="native")
    for crop in (False, True):
        it, jit = (p.prefetch(300, crop=crop, compact=compact)
                   for p in (port, jax_))
        got = [next(it) for _ in range(3)]
        want = [next(jit) for _ in range(3)]
        it.close()
        jit.close()
        for g, w in zip(got, want):
            _assert_same(g, w)
        assert not np.array_equal(got[0]["uv"], got[1]["uv"])
    resumed = port.prefetch(300, crop=True, compact=compact, stream_id=1,
                            skip=2)
    _assert_same(next(resumed), got[2])
    resumed.close()


def test_auto_backend_takes_native():
    s = _scene()
    pipe = RayBatchPipeline(*_args(s), seed=5, backend="auto")
    assert pipe.backend == "native"
    assert JPipeline(*_args(s), seed=5, backend="auto").backend == "native"
    with pytest.raises(ValueError, match="backend"):
        RayBatchPipeline(*_args(s), backend="cuda")


def test_without_the_library(monkeypatch):
    """Where the source cannot be built, ``native`` raises with the
    reason, ``auto`` takes numpy and the wrappers raise."""
    s = _scene()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++ did not run: test")
    with pytest.raises(RuntimeError, match="g\\+\\+ did not run"):
        RayBatchPipeline(*_args(s), backend="native")
    assert RayBatchPipeline(*_args(s), backend="auto").backend == "numpy"
    with pytest.raises(RuntimeError, match="could not be built"):
        native.sample_batch(*_args(s), 16, 0, 0, 0, 16, 0, 16)
