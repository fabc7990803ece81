"""The port's mesh over torch.distributed (acas2d_tpu_torch/parallel/mesh.py),
the counterpart of acas2d_tpu/parallel/mesh.py, and its launcher.

`multihost_init` is a no-op without a launcher.  Two gloo ranks on the CPU
(`parallel.launch.run_ranks`, run as `python -m tests.test_torch_mesh
worker DIR`) split an env batch by rows and put it back together, and
reduce, gather and broadcast as the learner needs; a run whose rank fails
ends, rather than leaving its peer waiting in a collective.  The rank's
seed fold wraps as JAX's int32 add does."""

import os
import sys
import time

import numpy as np
import pytest
import torch

from acas2d_tpu_torch.parallel import launch, mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120          # every spawned run ends within this, or is killed


def _worker(out: str) -> None:
    from acas2d_tpu_torch.config import DEFAULT_PARAMS
    from acas2d_tpu_torch.envs import vector

    mesh = mesh_lib.multihost_init("cpu")
    r = mesh.rank
    es, obs = vector.reset_batch(8, DEFAULT_PARAMS,
                                 torch.Generator().manual_seed(3),
                                 torch.float32, "cpu")
    mine = mesh_lib.shard_env_state((es, obs), mesh)
    back = mesh_lib.gather_env_state(mine, mesh)
    flat = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64) * (r + 1)
    x = torch.full((1, 2), float(r), dtype=torch.float32) + 0.5
    torch.save({
        "rank": r, "size": mesh.size, "rows": mesh_lib.env_rows(8, mesh),
        "mine": mine, "back": back, "whole": (es, obs),
        "sum": mesh_lib.all_reduce_sum(flat, mesh),
        "mean": mesh_lib.all_reduce_mean(flat, mesh),
        "gathered": mesh_lib.all_gather_rows(x, mesh),
        "int": mesh_lib.all_gather_rows(torch.tensor([r], dtype=torch.int32),
                                        mesh),
        "bcast": mesh_lib.broadcast(torch.full((3,), float(r)), mesh),
        "obj": mesh_lib.broadcast_object({"from": r, "t": torch.ones(2) * r},
                                         mesh),
        "again": mesh_lib.multihost_init("cpu").rank,
    }, os.path.join(out, f"{r}.pt"))


def _failing_worker() -> None:
    mesh = mesh_lib.multihost_init("cpu")
    if mesh.rank == 1:
        raise SystemExit(3)
    mesh_lib.all_reduce_sum(torch.ones(1), mesh)      # waits for rank 1


def test_multihost_init_is_a_noop_without_a_launcher(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = mesh_lib.multihost_init("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    x = torch.arange(4.0)
    assert mesh_lib.all_reduce_mean(x, mesh) is x
    assert mesh_lib.all_gather_rows(x, mesh) is x
    assert mesh_lib.shard_env_state(x, mesh) is x
    assert mesh_lib.broadcast_object(7, mesh) == 7
    assert mesh_lib.fold_seed(5, mesh) == 5


def test_iterations_replay_on_the_card_alone():
    """K iterations a call replay a captured graph on the card for a
    process alone, with or without its mesh of one, and run eagerly on the
    CPU (gloo's K eager steps: tests/test_torch_sharded_driver.py)."""
    from acas2d_tpu_torch.ppo import learner

    alone = mesh_lib.Mesh(0, 1, None, torch.device("cpu"))
    for mesh in (None, alone):
        assert mesh_lib.backend_of(mesh) is None
        assert learner.replays(torch.device("cuda"), mesh)
        assert not learner.replays(torch.device("cpu"), mesh)


def test_env_rows_split_a_batch_and_refuse_a_remainder():
    ranks = [mesh_lib.Mesh(r, 4, object(), torch.device("cpu"))
             for r in range(4)]
    assert [mesh_lib.env_rows(8, m) for m in ranks] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.env_rows(6, ranks[0])


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1, 2 ** 31 - 7000])
def test_fold_seed_wraps_as_jax_int32(seed):
    """seed + rank * 7919 in int32 (JAX learner.py:190-193), on the host and
    on a (1,) int32 tensor, which keeps its dtype."""
    for r in range(4):
        m = mesh_lib.Mesh(r, 4, object(), torch.device("cpu"))
        with np.errstate(over="ignore"):
            want = int(np.int32(seed) + np.int32(r) * np.int32(7919))
        assert mesh_lib.fold_seed(seed, m) == want
        t = mesh_lib.fold_seed(torch.tensor([seed], dtype=torch.int32), m)
        assert t.dtype == torch.int32 and int(t[0]) == want


def test_initial_params_do_not_depend_on_the_thread_count():
    """A rank of a launch (OMP_NUM_THREADS=1) starts from the same policy
    as a process that trains alone on every core: the orthogonal init's QR
    rounds by the thread count, so it runs on one."""
    from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten

    n = torch.get_num_threads()
    try:
        params = []
        for threads in (1, 4):
            torch.set_num_threads(threads)
            params.append(flatten(ActorCritic(
                generator=torch.Generator().manual_seed(13))))
            assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(n)
    assert torch.equal(params[0], params[1])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    launch.check_ranks(launch.run_ranks(
        ["-m", "tests.test_torch_mesh", "worker", out], 2, JOIN_S, cwd=ROOT))
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
            for r in range(2)]


def test_two_ranks_split_the_batch_and_put_it_back(two_ranks):
    for r, got in enumerate(two_ranks):
        assert (got["rank"], got["size"], got["again"]) == (r, 2, r)
        assert got["rows"] == slice(4 * r, 4 * r + 4)
        es, obs = got["whole"]
        mine_es, mine_obs = got["mine"]
        back_es, back_obs = got["back"]
        assert torch.equal(mine_obs, obs[4 * r:4 * r + 4])
        assert torch.equal(back_obs, obs)
        for f in ("px", "tx", "steps", "outcome"):
            assert torch.equal(getattr(mine_es, f),
                               getattr(es, f)[4 * r:4 * r + 4]), f
            assert torch.equal(getattr(back_es, f), getattr(es, f)), f


def test_two_ranks_reduce_gather_and_broadcast(two_ranks):
    for got in two_ranks:
        want = torch.tensor([3.0, 6.0, 9.0], dtype=torch.float64)
        assert torch.equal(got["sum"], want)
        assert torch.equal(got["mean"], want / 2)
        assert torch.equal(got["gathered"], torch.tensor([[0.5, 0.5],
                                                          [1.5, 1.5]]))
        assert got["int"].tolist() == [0, 1]
        assert got["bcast"].tolist() == [0.0, 0.0, 0.0]
        assert got["obj"]["from"] == 0 and torch.equal(got["obj"]["t"],
                                                       torch.zeros(2))


def test_a_failed_rank_ends_the_run():
    """Rank 1 exits while rank 0 waits in a collective: the run ends within
    the launcher's grace, every rank's code reported, none left running."""
    t0 = time.monotonic()
    res = launch.run_ranks(["-m", "tests.test_torch_mesh", "fail"], 2,
                           JOIN_S, cwd=ROOT)
    assert time.monotonic() - t0 < JOIN_S - 30
    assert res[1].returncode == 3
    assert res[0].returncode != 0
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        launch.check_ranks(res)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
    else:
        _failing_worker()
