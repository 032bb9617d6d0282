"""The served render's two stages: ``renderer.prepare_image`` (everything
before the first forward launch) and ``finish_image``, and
``serving.RenderServer``'s prepare lock, which lets one request prepare
while another render holds the render lock. On the CPU the kernel route
is forced (``renderer.kernel_route``), so that ``render_rays_kernels``
runs the kernels' plain versions:

- for a coarse, a shared-hierarchical and a separate-fine model,
  deterministic and seeded, over one launch group and over two, and with
  an occupancy grid, ``finish_image(prepare_image(...))`` and
  ``render_image`` equal bit for bit the kernel route run in one stage
  (:func:`_one_stage`, the sequence ``render_image`` made before the
  split); every route prepares its rays ahead, and on the kernel route
  with a grid the two stages equal ``render_rays_kernels``;
- cloning a prepared record shares no tensor's storage with it, and the
  staleness key (``ops/fused_train._weights_key``) without versions
  ignores in-place writes, with them it does not;
- eight concurrent HTTP clients get PNGs byte-identical to the same
  requests sent one at a time, deterministic and seeded;
- a request prepares while the test holds the render lock, and while
  another render holds it with its launches enqueued, which
  ``overlapped`` counts; the request completes once the lock is let go,
  and ``overlapped <= requests``;
- under the benchmark's ``portbench.kinds.serve.instrument`` every render
  passes through the wrapped lock, and a wrapper put in
  ``renderer.render_image``'s place sees every served image.

On the card (skipped elsewhere): a 128 x 128 prepare of each served
configuration (``portbench/configs``) makes no stream synchronisation;
a deterministic prepare, one CUDA graph's replay, renders what the eager
prepare renders, bit for bit; every tensor of the record a replay
returns is its own allocation, which the next replay leaves unchanged;
and the images a server returns to 8 threads equal the ones it renders
one at a time.
"""

import io
import json
import os
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from codenerf_tpu_torch import renderer, serving
from codenerf_tpu_torch.config import (NetConfig, RenderConfig,
                                       hparams_from_dict)
from codenerf_tpu_torch.core.rays import camera_rays
from codenerf_tpu_torch.core.render import composite_weights
from codenerf_tpu_torch.core.sampling import union_sorted_zvals
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.ops.composite import composite_fwd
from codenerf_tpu_torch.render_orbit import orbit_pose

torch.set_num_threads(2)     # keep xdist workers apart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = NetConfig(W=64, shape_blocks=2, texture_blocks=1, num_xyz_freq=6,
                num_dir_freq=2, latent_dim=32)
CASES = {
    "coarse": (RenderConfig(n_samples=16, near=0.8, far=1.8), False),
    "shared": (RenderConfig(n_samples=8, n_importance=16, near=0.8,
                            far=1.8), False),
    "separate": (RenderConfig(n_samples=8, n_importance=16, near=0.8,
                              far=1.8, share_fine_weights=False), True),
}


def _nets(separate: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    model = CodeNeRF(NET, generator=g).requires_grad_(False)
    fine = (CodeNeRF(NET, generator=g).requires_grad_(False) if separate
            else None)
    codes = torch.randn(4, NET.latent_dim, generator=g) * 0.5
    return model, fine, codes


def _one_stage(model, rcfg, H, W, focal, c2w, s, t, gen, fine, chunk,
               occ=None):
    """The kernel route of ``render_image`` as it ran in one stage: the
    rays, the networks' operands, then each launch group's depths, ray
    operands and launches."""
    chunk, _, n_padded = renderer.chunk_plan(H * W, chunk)
    ray_o, viewdir = camera_rays(H, W, focal, c2w)
    ray_o = renderer.pad_rays(ray_o, n_padded)
    viewdir = renderer.pad_rays(viewdir, n_padded)
    cfg, R = model.cfg, n_padded
    hier = rcfg.n_importance > 0
    net = renderer.fine_network(model, rcfg, fine) if hier else model
    group = chunk * max(1, renderer.KERNEL_RAYS // chunk)
    codes = s.reshape(1, -1), t.reshape(1, -1)

    def rows(p):
        return p.expand(min(group, R), -1, -1).contiguous()

    trunk = fused_train.trunk_operands(net, cfg)
    sproj, tproj = map(rows, fused_mlp.code_operands(net, cfg, *codes))
    trunk_c = fused_train.trunk_operands(model, cfg)
    sproj_c = rows(fused_mlp.code_operands(model, cfg, *codes)[0])
    parts = []
    for start in range(0, R, group):
        ro, vd = ray_o[start:start + group], viewdir[start:start + group]
        n = ro.shape[0]
        z, u = renderer._draws(rcfg, ro, vd, gen, occ, chunk)
        ro8, vd8, vc = fused_mlp.ray_operands(net, cfg, ro, vd)
        if hier:
            sig = fused_mlp.sigma_fwd(cfg, z.shape[1], n, ro8, vd8, z,
                                      sproj_c[:n], None, None, trunk_c)
            z = union_sorted_zvals(z, renderer.fine_zvals(
                rcfg, z, composite_weights(sig, z), gen, u))
        sig, r, g, b = fused_mlp.planes_fwd(cfg, z.shape[1], n, ro8, vd8, z,
                                            sproj[:n], tproj[:n], vc, trunk)
        parts.append(composite_fwd(sig, r, g, b, z, rcfg.white_bg)[:, :3])
    return torch.cat(parts)[:H * W].reshape(H, W, 3)


@pytest.fixture
def kernels(monkeypatch):
    monkeypatch.setattr(renderer, "kernel_route", lambda *a, **k: True)


def _grid(model, codes, rcfg):
    """An occupancy grid (``G = 8``) of ``model``'s density at the codes,
    carved to a sphere inside the sampled slab."""
    from codenerf_tpu_torch.core.occupancy import build_occupancy_grid

    return build_occupancy_grid(model, codes[0], codes[1], G=8, radius=1.0,
                                mask_radius=0.6)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("seeded", [False, True], ids=["det", "seeded"])
@pytest.mark.parametrize("case", list(CASES) + ["occupancy"])
def test_two_stages_equal_one(kernels, monkeypatch, case, seeded, groups):
    rcfg, separate = CASES.get(case, CASES["coarse"])
    model, fine, codes = _nets(separate)
    occ = _grid(model, codes, rcfg) if case == "occupancy" else None
    H = W = 16
    chunk = 64                     # 4 chunks of the 256 rays
    monkeypatch.setattr(renderer, "KERNEL_RAYS", 256 // groups)
    c2w = orbit_pose(0.9, 0.3, 1.3)
    args = (model, rcfg, H, W, 17.6, c2w, codes[0], codes[1])

    def gen():
        return torch.Generator().manual_seed(5) if seeded else None

    want = _one_stage(*args, gen(), fine, chunk, occ)
    prep = renderer.prepare_image(*args, gen(), chunk=chunk, occ_grid=occ,
                                  fine_model=fine)
    assert prep.kernels and prep.first is not None
    got = renderer.finish_image(prep)
    whole = renderer.render_image(*args, gen(), chunk=chunk, occ_grid=occ,
                                  fine_model=fine)
    assert torch.equal(got, want)
    assert torch.equal(whole, want)


def test_nothing_prepared_ahead_off_the_kernel_route(monkeypatch):
    """Every route prepares ahead: on the plain route ``prepare_image``
    returns the padded rays and ``finish_image`` equals ``render_image``;
    on the kernel route with a real occupancy grid the two stages equal
    ``render_rays_kernels`` in one stage, bit for bit."""
    rcfg, _ = CASES["coarse"]
    model, _, codes = _nets(False)
    c2w = orbit_pose(0.2, 0.3, 1.3)
    args = (model, rcfg, 8, 8, 8.8, c2w, codes[0], codes[1])
    prep = renderer.prepare_image(*args, chunk=16)
    ray_o, viewdir = camera_rays(8, 8, 8.8, c2w)
    assert not prep.kernels and prep.sproj is None and prep.first is None
    assert torch.equal(prep.ray_o, ray_o) and torch.equal(prep.viewdir,
                                                          viewdir)
    assert torch.equal(renderer.finish_image(prep),
                       renderer.render_image(*args, chunk=16))
    # whole chunks of the planned size (69 x 69: 2 of 2,432 rays, which a
    # second chunk_plan of the planned chunk would not give)
    odd = renderer.prepare_image(model, rcfg, 69, 69, 75.9, c2w, *codes[:2])
    assert odd.ray_o.shape[0] == renderer.chunk_plan(69 * 69)[2] == 4864
    monkeypatch.setattr(renderer, "kernel_route", lambda *a, **k: True)
    occ = _grid(model, codes, rcfg)
    assert occ.occ.any() and not occ.occ.all()
    prep = renderer.prepare_image(*args, chunk=16, occ_grid=occ)
    assert prep.kernels and prep.first is not None
    want = renderer.render_rays_kernels(model, rcfg, ray_o, viewdir,
                                        codes[0], codes[1], None, occ, 16)
    assert torch.equal(renderer.finish_image(prep), want.reshape(8, 8, 3))


def _tensors(x):
    """Every tensor in ``x``, through tuples and lists."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def test_cloned_record_shares_no_storage(kernels):
    """``renderer._cloned`` of a prepared record (separate fine network,
    so every field is set) copies each tensor into storage of its own,
    bit for bit, and keeps everything else as it is."""
    rcfg, _ = CASES["separate"]
    model, fine, codes = _nets(True)
    prep = renderer.prepare_image(model, rcfg, 8, 8, 8.8,
                                  orbit_pose(0.2, 0.3, 1.3), codes[0],
                                  codes[1], chunk=16, fine_model=fine)
    copy = renderer._cloned(prep)
    assert type(copy) is renderer.PreparedImage
    assert type(copy.trunk) is type(prep.trunk)
    old, new = _tensors(prep), _tensors(copy)
    assert len(old) == len(new) > 10
    ptrs = {t.untyped_storage().data_ptr() for t in old}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in new}
    assert all(torch.equal(a, b) for a, b in zip(old, new))
    assert all(a is b for a, b in zip(prep, copy) if not isinstance(
        a, (tuple, list)) and not torch.is_tensor(a))


def test_graph_staleness_and_pose_packing():
    """A prepare graph's key (``fused_train._weights_key`` with None for
    each version) depends on each parameter's tensor and address, not on
    its values; the trunk cache's key (with versions) on its in-place
    writes too. The pose goes up as c2w's values then the focal,
    float32."""
    model, _, _ = _nets(False)
    key = fused_train._weights_key(model)
    graph_key = [(ref, ptr, None) for ref, ptr, _ in key]
    with torch.no_grad():
        model.sigma.weight.mul_(2.0)                  # values: still holds
    assert fused_train._key_holds(graph_key, model)
    assert not fused_train._key_holds(key, model)
    key = fused_train._weights_key(model)
    model.sigma.weight = torch.nn.Parameter(model.sigma.weight.clone())
    assert not fused_train._key_holds(graph_key, model)
    assert not fused_train._key_holds(key, model)
    c2w = orbit_pose(0.3, 0.2, 1.3)
    got = renderer._pose_host(c2w, 140.8)
    assert got.dtype == np.float32 and got.shape == (17,)
    assert np.array_equal(got[:16], c2w.astype(np.float32).reshape(-1))
    assert got[16] == np.float32(140.8)


def _server(case: str = "separate"):
    rcfg, separate = CASES[case]
    model, fine, codes = _nets(separate)
    hp = type("Hp", (), {"render": rcfg, "compute_dtype": "bfloat16"})()
    srv = serving.RenderServer({"model": model, "fine_model": fine,
                                "shape_codes": codes[:2],
                                "texture_codes": codes[2:]}, hp)
    srv.start_background()
    return srv


def _post(srv, req: dict) -> bytes:
    r = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/render", data=json.dumps(req).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.status == 200
        return resp.read()


def _requests(n: int, size: int = 16):
    return [{"obj": i % 2, "azimuth": 0.4 * i, "elevation": 0.2 + 0.02 * i,
             "H": size, "W": size, "deterministic": i % 3 != 0,
             "seed": 1000 + i} for i in range(n)]


@pytest.mark.parametrize("case", ["coarse", "separate"])
def test_concurrent_clients_get_the_same_pngs(kernels, case):
    srv = _server(case)
    try:
        reqs = _requests(16)
        alone = [_post(srv, r) for r in reqs]
        with ThreadPoolExecutor(8) as pool:
            together = list(pool.map(lambda r: _post(srv, r), reqs))
        t = srv.timings()
    finally:
        srv.shutdown()
    assert together == alone
    assert t["requests"] == 32 and t["overlapped"] <= t["requests"]
    assert set(t["prepare_ms"]) == {"p50", "p95", "max"}
    assert 0 < t["prepare_ms"]["p50"] <= t["prepare_ms"]["max"]


def _until(cond, timeout: float = 60.0) -> bool:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.005)
    return True


def _started(srv, req, out: list) -> threading.Thread:
    th = threading.Thread(target=lambda: out.append(_post(srv, req)),
                          daemon=True)
    th.start()
    return th


def test_prepare_runs_while_the_render_lock_is_held(kernels, monkeypatch):
    srv = _server()
    try:
        reqs = _requests(3)
        # the test holds the render lock itself
        n0, out = len(srv._times["prepare_ms"]), []
        with srv._lock:
            th = _started(srv, reqs[0], out)
            assert _until(lambda: len(srv._times["prepare_ms"]) == n0 + 1)
            time.sleep(0.05)
            assert th.is_alive() and not out
        th.join(60)
        assert not th.is_alive() and len(out) == 1
        # another render holds it, its launches enqueued: its read-back
        # waits on the test
        read_back, entered, gate = (serving._read_back, threading.Event(),
                                    threading.Event())

        def held(img):
            if not entered.is_set():
                entered.set()
                assert gate.wait(60)
            return read_back(img)
        monkeypatch.setattr(serving, "_read_back", held)
        before, out = srv.timings(), []
        first = _started(srv, reqs[1], out)
        assert entered.wait(60)
        n0 = len(srv._times["prepare_ms"])
        second = _started(srv, reqs[2], out)
        assert _until(lambda: len(srv._times["prepare_ms"]) == n0 + 1)
        assert second.is_alive() and not out
        gate.set()
        first.join(60)
        second.join(60)
        assert not (first.is_alive() or second.is_alive()) and len(out) == 2
        t = srv.timings()
    finally:
        srv.shutdown()
    assert t["requests"] - before["requests"] == 2
    assert t["overlapped"] - before["overlapped"] == 1
    assert t["overlapped"] <= t["requests"]


class _CountingLock:
    """A lock that counts its acquisitions."""

    def __init__(self, lock):
        self.lock, self.acquired = lock, 0

    def acquire(self):
        self.lock.acquire()
        self.acquired += 1

    def release(self):
        self.lock.release()


def test_the_benchmark_lock_wrapper_sees_every_render(kernels):
    from portbench.kinds.serve import instrument

    srv = _server()
    try:
        lock = instrument(srv)
        lock.lock = counting = _CountingLock(lock.lock)
        reqs = _requests(12)
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda r: _post(srv, r), reqs))
        t, held = srv.timings(), sum(srv._times["render_ms"])
    finally:
        srv.shutdown()
    assert counting.acquired == t["requests"] == len(reqs)
    assert lock.held_s >= held > 0


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_a_wrapper_of_render_image_sees_every_served_image(monkeypatch,
                                                           route):
    """The server finishes each render through ``renderer.render_image``
    (of the record it prepared), looked up at each request: a wrapper put
    in its place, as the benchmark's fault checks put one, sees every
    request, and what it returns is what is served."""
    if route == "kernels":
        monkeypatch.setattr(renderer, "kernel_route", lambda *a, **k: True)
    render, seen = renderer.render_image, []

    def inverted(*args, **kw):
        seen.append(kw["prepared"])
        return 1.0 - render(*args, **kw)
    srv = _server("coarse")
    try:
        reqs = _requests(4)
        plain = [_post(srv, r) for r in reqs]
        monkeypatch.setattr(renderer, "render_image", inverted)
        wrapped = [_post(srv, r) for r in reqs]
    finally:
        srv.shutdown()
    assert len(seen) == len(reqs)
    assert all(p.kernels == (route == "kernels") for p in seen)
    for a, b in zip(plain, wrapped):
        a, b = (np.asarray(Image.open(io.BytesIO(x)), dtype=np.int32)
                for x in (a, b))
        assert np.abs(a + b - 255).max() <= 1


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel route runs only there")
    return torch.device("cuda")


def _served(name: str, dev):
    """A server over random networks of ``portbench/configs/<name>.json``
    (a separate fine network where it has ``N_importance``)."""
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        hp = hparams_from_dict(json.load(f)["hparams"])
    g = torch.Generator().manual_seed(0)
    model = CodeNeRF(hp.net, generator=g).requires_grad_(False).to(dev)
    fine = None
    if hp.render.n_importance > 0 and not hp.render.share_fine_weights:
        fine = CodeNeRF(hp.net, generator=g).requires_grad_(False).to(dev)
    codes = torch.randn(4, hp.net.latent_dim, generator=g) * 0.5
    return serving.RenderServer({"model": model, "fine_model": fine,
                                 "shape_codes": codes[:2],
                                 "texture_codes": codes[2:]}, hp)


@pytest.mark.parametrize("name", ["car_fused", "car_nerf_hier"])
def test_card_prepare_does_not_synchronise(card, name):
    srv = _served(name, card)
    try:
        args = (srv.model, srv.hp.render, 128, 128, 140.8,
                orbit_pose(0.9, 0.3, 1.3), srv.shape_codes[0],
                srv.texture_codes[0])
        kw = dict(fine_model=srv.fine_model)
        renderer.render_image(*args, **kw)           # builds and packs
        torch.cuda.synchronize()
        for seeded in (False, True):
            torch.cuda.set_sync_debug_mode("error")
            try:
                gen = (torch.Generator(device=card).manual_seed(3) if seeded
                       else None)
                prep = renderer.prepare_image(*args, gen, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert prep.first is not None
            gen2 = (torch.Generator(device=card).manual_seed(3) if seeded
                    else None)
            assert torch.equal(renderer.finish_image(prep),
                               renderer.render_image(*args, gen2, **kw))
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", ["car_fused", "car_nerf_hier"])
def test_card_graph_prepare_equals_eager(card, name):
    """A deterministic prepare from host inputs replays a CUDA graph; its
    renders equal, bit for bit, the eager prepare's (a pose already on
    the card takes the eager path), over poses and objects in turn."""
    srv = _served(name, card)
    try:
        for i in range(4):
            c2w = orbit_pose(0.5 + i, 0.2 + 0.1 * i, 1.3)
            got = []
            for pose in (c2w, torch.from_numpy(c2w.astype(np.float32)).to(
                    card)):
                got.append(renderer.render_image(
                    srv.model, srv.hp.render, 128, 128, 140.8, pose,
                    srv.shape_codes[i % 2], srv.texture_codes[i % 2],
                    fine_model=srv.fine_model))
            assert torch.equal(got[0], got[1]), i
        graphs = renderer._PREPARE_GRAPHS[srv.model]
        assert len(graphs) == 1 and None not in graphs.values()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", ["car_fused", "car_nerf_hier"])
def test_card_graph_records_are_copies(card, name):
    """Every tensor of the record a graph replay returns is an allocation
    of its own, apart from the graph's outputs, so that the next replay
    leaves the first record unchanged."""
    srv = _served(name, card)
    try:
        args = (srv.model, srv.hp.render, 128, 128, 140.8)
        codes = srv.shape_codes[0], srv.texture_codes[0]
        kw = dict(fine_model=srv.fine_model)
        renderer.render_image(*args, orbit_pose(0.9, 0.3, 1.3), *codes,
                              **kw)                 # captures the graph
        first = renderer.prepare_image(*args, orbit_pose(0.5, 0.2, 1.3),
                                       *codes, **kw)
        (graph,) = renderer._PREPARE_GRAPHS[srv.model].values()
        before = [t.clone() for t in _tensors(first)]
        renderer.prepare_image(*args, orbit_pose(2.5, 0.4, 1.3),
                               srv.shape_codes[1], srv.texture_codes[1],
                               **kw)
        torch.cuda.synchronize()
        ptrs = {t.untyped_storage().data_ptr()
                for t in _tensors(graph.out)}
        mine = [t for t in _tensors(first) if t.device.type == "cuda"]
        assert mine and not ptrs & {t.untyped_storage().data_ptr()
                                    for t in mine}
        assert all(torch.equal(a, b)
                   for a, b in zip(before, _tensors(first)))
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", ["car_fused", "car_nerf_hier"])
def test_card_threads_get_the_same_images(card, name):
    srv = _served(name, card)
    srv.start_background()
    try:
        reqs = _requests(16, size=128)
        alone = [_post(srv, r) for r in reqs]
        with ThreadPoolExecutor(8) as pool:
            together = list(pool.map(lambda r: _post(srv, r), reqs))
        t = srv.timings()
    finally:
        srv.shutdown()
    decode = [np.asarray(Image.open(io.BytesIO(b))) for b in alone]
    assert all(d.shape == (128, 128, 3) for d in decode)
    assert together == alone
    assert t["overlapped"] <= t["requests"] == 32
