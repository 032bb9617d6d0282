"""The port's render service (``codenerf_tpu_torch/serving.py``) against
the JAX package's (``codenerf_tpu/serving.py``) on the same weights
(``models/codenerf.params_from_jax``; W=64, 2 + 1 blocks, 16 samples),
both on 127.0.0.1 in background threads on the CPU:

- deterministic renders by object and by raw codes, with an orbit camera
  and with a ``c2w``: the served PNGs decoded to uint8 agree within 1
  level on more than 99% of the pixels (the plain bf16 model rounds at
  different points in XLA and PyTorch: ``tests/test_torch_hier.py``'s
  2e-3 render bar is half a level, and a pixel near a rounding edge of
  the ×255 clip can fall either way);
- the error paths and status codes (400 for a bad object, missing codes,
  a malformed camera or body; 404 for another path), ``/healthz`` and
  ``/stats`` (the JAX server's fields);
- non-deterministic renders drawn from a seeded ``torch.Generator``: the
  same seed the same image, another seed another;
- the occupancy grid cache: one build per object, raw codes cached by
  digest up to 32 entries, the oldest evicted first; the two refusals (no
  grid extent, ``shared_jitter``) with the JAX server's errors;
- ``python -m codenerf_tpu_torch.serve`` as a subprocess: start, one
  request, shutdown.
"""

import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from codenerf_tpu import serving as j_serving
from codenerf_tpu.config import hparams_from_dict as j_hparams_from_dict
from codenerf_tpu.models.codenerf import init_codenerf
from codenerf_tpu.models.codes import init_codes
from codenerf_tpu_torch import serving
from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.render_orbit import orbit_pose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 64, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}
CFG = {"net_hyperparams": NET, "N_samples": 16, "near": 0.8, "far": 1.8}


def _weights(cfg=CFG):
    jhp, hp = j_hparams_from_dict(cfg), hparams_from_dict(cfg)
    jparams = init_codenerf(jax.random.PRNGKey(0), jhp.net)
    model = CodeNeRF(hp.net).requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    codes = np.array(init_codes(jax.random.PRNGKey(1), 6, 32))
    jtr = {"params": jparams, "shape_codes": jnp.asarray(codes[:3]),
           "texture_codes": jnp.asarray(codes[3:])}
    tr = {"model": model, "shape_codes": torch.from_numpy(codes[:3]),
          "texture_codes": torch.from_numpy(codes[3:]), "fine_model": None}
    return jhp, hp, jtr, tr


@pytest.fixture(scope="module")
def servers():
    jhp, hp, jtr, tr = _weights()
    jsrv = j_serving.RenderServer(jtr, jhp)
    srv = serving.RenderServer(tr, hp)
    jsrv.start_background()
    srv.start_background()
    yield jsrv, srv
    jsrv.shutdown()
    srv.shutdown()


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _post(srv, body, path="/render"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(_url(srv, path), data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _get(srv, path):
    try:
        with urllib.request.urlopen(_url(srv, path), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(data):
    return np.asarray(Image.open(io.BytesIO(data)))


REQUESTS = {
    "by_object": {"obj": 1, "H": 16, "W": 16, "azimuth": 0.8},
    "raw_codes_orbit": {"azimuth": 2.5, "elevation": 0.2, "radius": 1.4,
                        "H": 16, "W": 12},
    "c2w": {"obj": 2, "H": 12, "W": 16, "focal": 15.0,
            "c2w": orbit_pose(4.0, 0.5, 1.2).tolist()},
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_served_renders_match_jax(servers, name):
    jsrv, srv = servers
    req = dict(REQUESTS[name])
    if "obj" not in req:
        codes = np.array(init_codes(jax.random.PRNGKey(7), 2, 32))
        req.update(shape_code=codes[0].tolist(),
                   texture_code=codes[1].tolist())
    (js, jct, jdata), (s, ct, data) = _post(jsrv, req), _post(srv, req)
    assert (js, jct) == (s, ct) == (200, "image/png")
    want, got = _png(jdata), _png(data)
    assert got.shape == want.shape == (req["H"], req["W"], 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99, (
        diff.max(), (diff == 0).mean())


def test_render_is_the_clipped_direct_render(servers):
    """A served image is ``renderer.render_image`` of the same camera and
    codes, clipped ×255, uint8 for uint8."""
    from codenerf_tpu_torch.renderer import render_image

    _, srv = servers
    status, _, data = _post(srv, REQUESTS["by_object"])
    img = render_image(srv.model, srv.hp.render, 16, 16, 17.6,
                       torch.from_numpy(orbit_pose(0.8, 0.3, 1.3)),
                       srv.shape_codes[1], srv.texture_codes[1]).numpy()
    want = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    assert status == 200
    np.testing.assert_array_equal(_png(data), want)


ERRORS = {
    "obj_out_of_range": ({"obj": 3}, 400),
    "obj_negative": ({"obj": -1}, 400),
    "no_codes": ({"H": 8}, 400),
    "half_the_codes": ({"shape_code": [0.0] * 32}, 400),
    "c2w_shape": ({"obj": 0, "c2w": [[1.0, 0.0], [0.0, 1.0]]}, 400),
    "obj_not_a_number": ({"obj": "x"}, 400),
    "bad_json": (b"{not json", 400),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_error_paths_match_jax(servers, name):
    jsrv, srv = servers
    body, code = ERRORS[name]
    (js, jct, jdata), (s, ct, data) = _post(jsrv, body), _post(srv, body)
    assert js == s == code
    assert jct == ct == "application/json"
    assert "error" in json.loads(data)


def test_unknown_paths_and_wrong_code_length(servers):
    jsrv, srv = servers
    for x in (jsrv, srv):
        assert _post(x, {"obj": 0}, path="/nope")[0] == 404
        assert _get(x, "/nope") == (404, {"error": "unknown path"})
    # raw codes of the wrong length: a 400 here (the JAX server fails
    # inside its renderer instead)
    status, _, data = _post(srv, {"shape_code": [0.0] * 5,
                                  "texture_code": [0.0] * 5})
    assert status == 400 and "32 values" in json.loads(data)["error"]


def test_healthz_and_stats(servers):
    jsrv, srv = servers
    status, health = _get(srv, "/healthz")
    assert status == 200
    assert health == {"status": "ok", "device": "cpu", "n_objects": 3}
    assert _get(jsrv, "/healthz")[1]["n_objects"] == 3
    fresh = serving.RenderServer(_weights()[3], hparams_from_dict(CFG))
    try:
        empty = fresh.stats()
        assert empty["requests"] == 0 and empty["compiled_sizes"] == []
        for _ in range(3):
            fresh.render({"obj": 0, "H": 8, "W": 8})
        fresh.render({"obj": 0, "H": 8, "W": 6, "deterministic": False})
        st = fresh.stats()
        assert st["requests"] == 4
        assert st["compiled_sizes"] == [[8, 8, True], [8, 6, False]]
        lat = st["latency_ms"]
        assert set(lat) == {"p50", "p95", "max"}
        assert 0 < lat["p50"] <= lat["p95"] <= lat["max"]
        js = _get(jsrv, "/stats")[1]
        assert set(js) == set(st) and set(js["latency_ms"]) == set(lat)
    finally:
        fresh.shutdown()


def test_nondeterministic_renders_follow_the_seed(servers):
    _, srv = servers
    req = {"obj": 0, "H": 12, "W": 12, "deterministic": False}
    a = srv.render(dict(req, seed=3))
    b = srv.render(dict(req, seed=3))
    c = srv.render(dict(req, seed=4))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_occupancy_grid_cache(monkeypatch):
    from codenerf_tpu_torch.core import occupancy

    builds = []
    real = occupancy.build_occupancy_grid

    def counted(*args, **kw):
        builds.append(kw["G"])
        return real(*args, **kw)

    monkeypatch.setattr(occupancy, "build_occupancy_grid", counted)
    _, hp, _, tr = _weights()
    srv = serving.RenderServer(tr, hp, use_occupancy=True, occ_grid_size=8,
                               occ_radius=1.2)
    try:
        for obj in (0, 0, 1, 0, 1):
            assert srv.render({"obj": obj, "H": 8, "W": 8}).shape == (8, 8, 3)
        assert builds == [8, 8] and set(srv._occ_grids) == {0, 1}
        rng = np.random.default_rng(0)
        raw = [rng.normal(size=(2, 32)).astype(np.float32).tolist()
               for _ in range(33)]

        def render_raw(k):
            return srv.render({"shape_code": raw[k][0],
                               "texture_code": raw[k][1], "H": 4, "W": 4})

        render_raw(0)
        render_raw(0)
        assert len(builds) == 3            # the same codes: one build
        for k in range(1, 33):
            render_raw(k)
        digests = [k for k in srv._occ_grids if isinstance(k, str)]
        assert len(builds) == 35 and len(digests) == 32
        render_raw(0)                      # evicted first: built again
        assert len(builds) == 36
        render_raw(32)                     # still cached
        assert len(builds) == 36
        assert {0, 1} <= set(srv._occ_grids)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("extra,occ_radius,words", [
    ({}, None, "use_occupancy needs a grid extent"),
    ({"shared_jitter": True, "bound_sphere_radius": 1.2}, None,
     "use_occupancy requires per-ray sampling"),
    ({"shared_jitter": True}, 1.2, "use_occupancy requires per-ray")])
def test_occupancy_refusals_match_jax(extra, occ_radius, words):
    jhp, hp, jtr, tr = _weights({**CFG, **extra})
    for make, t, h in ((j_serving.RenderServer, jtr, jhp),
                       (serving.RenderServer, tr, hp)):
        with pytest.raises(ValueError, match=words):
            make(t, h, use_occupancy=True, occ_radius=occ_radius)


def test_serve_cli(tmp_path):
    """``python -m codenerf_tpu_torch.serve`` on a run directory holding a
    reference ``models.pth``: start (with a warm-up render), one request,
    shutdown."""
    from codenerf_tpu_torch.utils.checkpoint import save_reference_checkpoint

    _, hp, _, tr = _weights()
    os.makedirs(tmp_path / "exps" / "run")
    save_reference_checkpoint(str(tmp_path / "exps" / "run" / "models.pth"),
                              tr["model"], tr["shape_codes"],
                              tr["texture_codes"])
    jsonfile = str(tmp_path / "tiny.json")
    with open(jsonfile, "w") as f:
        json.dump(CFG, f)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "codenerf_tpu_torch.serve", "--saved_dir",
         "run", "--jsonfile", jsonfile, "--exps_root",
         str(tmp_path / "exps"), "--port", "0", "--warmup", "8x8",
         "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                break
        assert lines and lines[-1].startswith("serving 3 objects on http://"), \
            "".join(lines)
        assert any("warmup" in x for x in lines)
        url = lines[-1].split()[4]
        req = urllib.request.Request(
            url + "/render", data=json.dumps({"obj": 2, "H": 8,
                                              "W": 8}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            assert _png(r.read()).shape == (8, 8, 3)
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            assert json.loads(r.read())["requests"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
