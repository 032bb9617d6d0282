"""A run that fails under a ``model`` axis leaves a resumable step: the
port's counterpart of ``tests/test_crash_resume.py`` (the JAX trainer
saves on any failure) on two spawned ``gloo`` ranks at ``(data=1,
model=2)``, on the autodiff route at ``test_torch_tensor_parallel.py``'s
sizes (W=256, 2+1 blocks, latent 256 so that the code tables are sharded
too, 24 samples, 64 rays a step on a 16×16 scene, one thread a rank).

- **Both ranks fail at step 7.** Each writes its own slices with no
  collective; the set at step 7 is complete. A resume in the same layout
  and one in one process both restore step 7, and running on to 12 gives
  the bits of an uninterrupted run to 12 (every rank runs one process's
  arithmetic, ``parallel/mesh.py``). ``load_run`` reads the crashed run.
- **Only rank 1 fails**, in its update of step 7, after the step's
  collectives: rank 0 finishes step 7 and then waits in step 8's gather
  for a peer that never comes, until the mesh's short timeout
  (``make_mesh(timeout=...)``) raises and it saves its slices at step 8.
  Neither step has a complete set, so the resume takes the newest
  complete checkpoint, the whole one at step 5, and logs which.

Spawned workers re-import this module, so it imports no JAX.
"""

import datetime
import logging
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_sharding import B, NET, _scene, cfg_dict, whole

TIMEOUT_S = 5


def _hp(**extra):
    from codenerf_tpu_torch.config import hparams_from_dict

    return hparams_from_dict(cfg_dict(
        fused=False, net_hyperparams=dict(NET, latent_dim=256), **extra))


def _trainer(name, out, mesh, **extra):
    from codenerf_tpu_torch.training.trainer import Trainer

    return Trainer(name, _hp(**extra), batch_size=B, dataset=_scene(),
                   exps_root=out, check_iter=0, device="cpu", mesh=mesh)


def _run_main(rank, out, timeout_s, fn):
    from codenerf_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    pm.init_from_env("cpu", init_method=f"file://{out}/pg")
    try:
        timeout = (None if timeout_s is None
                   else datetime.timedelta(seconds=timeout_s))
        res = fn(rank, pm.make_mesh(data=1, model=2, timeout=timeout), out)
        np.save(os.path.join(out, f"rank{rank}.npy"), res, allow_pickle=True)
    finally:
        dist.destroy_process_group()


def _spawn(fn, out, timeout_s=None) -> list:
    mp.spawn(_run_main, args=(out, timeout_s, fn), nprocs=2, join=True)
    return [np.load(os.path.join(out, f"rank{r}.npy"),
                    allow_pickle=True).item() for r in range(2)]


def _copy_ckpt(out, src, dst):
    shutil.copytree(os.path.join(out, src, "ckpt"),
                    os.path.join(out, dst, "ckpt"))


# ------------------------------------------------------------- the ranks
def _both_fail(rank, mesh, out):
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    res = {}
    full = _trainer("full", out, mesh)
    full.training(iters_crop=3, iters_all=12, log_every=1)
    res["full12"] = whole(full.state)

    tr = _trainer("crash", out, mesh)
    step_fn = tr._train_step

    def failing(state, batch, *extras):
        if state.step == 7:
            raise RuntimeError("simulated device failure")
        return step_fn(state, batch, *extras)

    tr._train_step = failing
    try:
        tr.training(iters_crop=3, iters_all=12, log_every=1)
    except RuntimeError as e:
        res["error"] = str(e)
    dist.barrier()
    res["files"] = sorted(os.listdir(tr.ckpt_dir))
    if rank == 0:
        for dst in ("crash_one", "crash_read"):
            _copy_ckpt(out, "crash", dst)
    dist.barrier()

    again = _trainer("crash", out, mesh)
    res["resumed"] = (again.resume(), again.state.step)
    res["resumed7"] = whole(again.state)
    again.training(iters_crop=3, iters_all=12, log_every=1)
    res["resumed12"] = whole(again.state)
    dist.barrier()
    if rank == 0:
        one = _trainer("crash_one", out, None)
        res["one_resumed"] = (one.resume(), one.state.step)
        one.training(iters_crop=3, iters_all=12, log_every=1)
        res["one12"] = whole(one.state)
        model, _, sc, tc = ckpt.load_run(os.path.join(out, "crash_read"),
                                         _hp(), "cpu")
        res["load_run"] = {"shape_codes": sc.numpy(),
                           "texture_codes": tc.numpy(),
                           **{f"model.{n}": p.numpy() for n, p in
                              model.state_dict().items()}}
        res["latest"] = ckpt.latest_step(
            os.path.join(out, "crash_read", "ckpt"))
    dist.barrier()
    return res


def _rank1_fails(rank, mesh, out):
    res = {}
    tr = _trainer("partial", out, mesh, check_points=5)
    flag = os.path.join(out, "rank0_done")
    if rank == 1:
        opt = tr.state.optimizer
        real_step = opt.step

        def failing(*args, **kw):
            if tr.state.step == 7:
                raise RuntimeError("simulated failure in the update")
            return real_step(*args, **kw)

        opt.step = failing
    t0 = time.perf_counter()
    try:
        tr.training(iters_crop=3, iters_all=12, log_every=1)
    except RuntimeError as e:
        res["error"] = str(e)
    res["seconds"] = time.perf_counter() - t0
    res["step"] = tr.state.step
    if rank == 0:
        open(flag, "w").close()
    else:
        # Stay up until rank 0's collective has timed out, so that it
        # waits on a live peer that never joins.
        while not os.path.exists(flag):
            time.sleep(0.1)
    return res


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def both_fail(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("both_fail"))
    return out, _spawn(_both_fail, out)


@pytest.fixture(scope="module")
def rank1_fails(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rank1_fails"))
    return out, _spawn(_rank1_fails, out, timeout_s=TIMEOUT_S)


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=f"{what}: {n}")


# --------------------------------------------------------------------- tests
def test_both_ranks_fail_leave_a_complete_slice_set(both_fail):
    """Both ranks raise at step 7: the error propagates and each rank has
    written its slice file of step 7, and nothing else."""
    _, res = both_fail
    for r in res:
        assert r["error"] == "simulated device failure"
        assert r["files"] == ["step_00000007.rank0of2.model2.pt",
                              "step_00000007.rank1of2.model2.pt"]


def test_resume_in_the_same_layout_repeats_the_uninterrupted_run(both_fail):
    """A resume at ``(data=1, model=2)`` restores step 7 and runs on to 12
    with the uninterrupted run's bits, on both ranks."""
    _, res = both_fail
    for r in res:
        assert r["resumed"] == (True, 7)
        _assert_same(r["resumed12"], res[0]["full12"], "resumed at model=2")


def test_resume_in_one_process_repeats_the_uninterrupted_run(both_fail):
    """The same slices resumed in one process: step 7, and at step 12 the
    bits of the uninterrupted ``model = 2`` run."""
    _, res = both_fail
    assert res[0]["one_resumed"] == (True, 7)
    _assert_same(res[0]["one12"], res[0]["full12"], "resumed in one process")


def test_load_run_reads_the_crashed_run(both_fail):
    """``load_run`` (the optimize and pose CLIs' reader) stitches the
    crashed run's slices: the networks and tables of step 7, whole."""
    _, res = both_fail
    assert res[0]["latest"] == 7
    _assert_same(res[0]["load_run"], res[0]["resumed7"], "load_run")


def test_stitched_checkpoint_restores_the_moments(both_fail):
    """The stitched step-7 checkpoint restored into one process carries
    whole AdamW moments: their blocks in the sharded leaves' dimension,
    the sizes of the whole parameters."""
    from codenerf_tpu_torch.training.state import (create_train_state,
                                                   named_trainables)
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    out, res = both_fail
    state = create_train_state(_hp(), 3, "cpu")
    ckpt.restore_checkpoint(os.path.join(out, "crash_read", "ckpt"), state)
    assert state.step == 7
    for n, p in named_trainables(state).items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      res[0]["resumed7"][n], err_msg=n)
        st = state.optimizer.state[p]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape, n
        assert float(st["exp_avg_sq"].sum()) > 0, n


def test_a_rank_waiting_on_a_dead_peer_times_out_and_saves(rank1_fails):
    """Only rank 1 fails, in step 7's update: rank 0 finishes step 7, its
    step-8 gather times out under the mesh's timeout and it saves its
    slices at step 8; rank 1 saved at step 7."""
    out, res = rank1_fails
    assert res[1]["error"] == "simulated failure in the update"
    assert res[1]["step"] == 7
    assert res[0]["step"] == 8
    assert "error" in res[0] and res[0]["seconds"] >= TIMEOUT_S
    files = sorted(os.listdir(os.path.join(out, "partial", "ckpt")))
    assert files == ["step_00000005.pt", "step_00000007.rank1of2.model2.pt",
                     "step_00000008.rank0of2.model2.pt"]


def test_resume_falls_back_to_the_newest_complete_checkpoint(rank1_fails,
                                                             caplog):
    """No complete set at step 7 or 8: the resume takes the whole
    checkpoint of step 5 and logs that it passed the two sets over."""
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    out, _ = rank1_fails
    ckpt_dir = os.path.join(out, "partial", "ckpt")
    assert ckpt.latest_step(ckpt_dir) == 5
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tr = _trainer("partial", out, None, check_points=5)
        with caplog.at_level(logging.WARNING):
            assert tr.resume()
    finally:
        torch.set_num_threads(n)
    assert tr.state.step == 5
    note = " ".join(r.getMessage() for r in caplog.records)
    assert "newest complete checkpoint is step 5 (whole)" in note
    assert "step 8: slices of ranks" in note and "step 7:" in note
