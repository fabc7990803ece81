"""The benchmark's `ranks` driver (benchmark/drive_ranks.py) and the
program's collective spans and counters (parallel/mesh.py,
ppo/learner.py), on the CPU under gloo.

One run of the driver at a tiny shape for the file: 2 ranks (this process
rank 0, one child), 512 envs x 16 steps, minibatch 1,024, 10 epochs, 2
iterations a call, a traced slice of one call and the controls.  Its
numbers are held to the cell's own limits against the reference's
iteration of the whole batch (benchmark/reference/sharded.py), the
half-minibatch and reward faults fail them, and the program's counters
over the slice are the collectives its iterations hold: 80 minibatch
all-reduces, one of the episode sums and one all-gather of the batch an
iteration, counted only while the slice's profiler records.

`python tests/test_torch_sharded_bench.py card OUT` is the rank of a card
test (tests/test_torch_cuda.py): a replayed call over NCCL against eager
steps, and the replays' counters against the capture's tally.
"""

import dataclasses
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from acas2d_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from acas2d_tpu_torch.utils import profiling  # noqa: E402

CELL = "solo32k_x4.train"
W = 2
TINY = dict(n_envs=512, n_steps=16, minibatch_size=1024, iters_per_call=2)
SEED = 2 ** 33 + 5          # past 32 signed bits, as the driver's are
ROWS = 512 * 16             # a batch
STEPS = 10 * ROWS // 1024   # minibatch steps an iteration
N_PARAMS = 9603


@pytest.fixture(scope="module")
def bench():
    """One traced run of the cell at the tiny shape with its controls:
    (cell, record, result, program counters, collective spans, TALLY's
    growth)."""
    from benchmark import run, spec
    cell = spec.load_cell(CELL)
    cell.chips = W
    cell.config.update(TINY)
    cell.traffic.update(warm_seconds=0.0, trace_calls=1, trace_seconds=0.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' (OMP_NUM_THREADS=1)
    profiling.clear()
    ran = dict(mesh_lib.TALLY)
    try:
        rec = run.measure(cell, SEED, 0.3, True, torch.device("cpu"),
                          time.perf_counter(), True)
        out = run.result(cell, rec, True, {})
        counters = profiling.counters()
        spans = [s for s in profiling.spans()
                 if s.name.startswith("collective.")]
    finally:
        torch.set_num_threads(n)
        profiling.clear()
    grown = {k: v - ran.get(k, 0) for k, v in mesh_lib.TALLY.items()}
    return cell, rec, out, counters, spans, grown


def test_the_shards_add_up_to_the_whole_batch(bench):
    cell, rec, out, *_ = bench
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert rec["numbers"]["launch_gap"] == 0.0
    assert rec["call_vs_steps"] == 0.0


@pytest.mark.parametrize("fault", ["half", "reward", "tf32"])
def test_a_planted_fault_fails_the_limits(bench, fault):
    """The reference with half of each minibatch, or every reward + 1,
    against the sound reference, fails a limit (launch_gap, which no
    reference has, left aside); on the CPU the TF32 control computes in
    float32 and passes."""
    cell, rec = bench[:2]
    nums = rec["controls"][fault]
    over = [k for k, lim in cell.limits.items()
            if k != "launch_gap" and not nums[k] <= lim]
    assert bool(over) == (fault != "tf32"), nums


def test_the_record_counts_every_rank_and_the_slice_rank0(bench):
    _, rec, *_ = bench
    work, tr = rec["work"], rec["trace"].work
    assert work["env_steps"] == work["iterations"] * ROWS
    assert work["world"] == tr["world"] == W
    assert (tr["n_envs"], tr["minibatch"]) == (512 // W, 1024 // W)
    assert tr["launches_grads"] == tr["iterations"] * STEPS
    assert tr["launches_rollout"] == tr["iterations"] * 16 // 16


def test_the_counters_are_the_iterations_collectives(bench):
    """K eager steps a call: each iteration all-reduces its minibatch
    steps' gradients and the episode sums, and gathers the batch once."""
    _, rec, out, counters, *_ = bench
    n = rec["trace"].work["iterations"]
    assert out["metrics"]["collective.calls"]["value"] == STEPS + 2
    assert counters["collective.all_reduce"] == n * (STEPS + 1)
    assert counters["collective.all_gather"] == n
    assert counters["collective.all_gather.bytes"] == n * ROWS * 13 * 4
    per_step = (counters["collective.all_reduce.bytes"] - n * 6 * 4) \
        / (n * STEPS)
    # the gradients and the loss statistics, float32
    assert per_step % 4 == 0 and N_PARAMS * 4 < per_step < (N_PARAMS + 16) * 4
    assert "collective.busbw_pct" not in out["metrics"]   # no NCCL kernels


def test_counted_only_while_the_profiler_records(bench):
    """The set-up's collectives (the inputs, the readings' gathers, the
    calls before the slice) run but are not recorded; the recorded ones
    lie inside the slice."""
    _, rec, _, counters, spans, grown = bench
    for kind in ("all_reduce", "all_gather"):
        name = f"collective.{kind}"
        assert 0 < counters[name] < grown[name]
    tr = rec["trace"]
    assert spans and all(tr.t0 <= s.start_ns / 1e3 and s.end_ns / 1e3
                         <= tr.t1 for s in spans)
    assert {s.name for s in spans} == {"collective.all_reduce",
                                       "collective.all_gather"}


def test_nothing_counted_without_a_group():
    """A mesh of one process runs no collective and counts none."""
    one = mesh_lib.Mesh(0, 1, None, torch.device("cpu"))
    before = dict(mesh_lib.TALLY)
    x = torch.ones(3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert mesh_lib.all_reduce_sum(x, one) is x
        assert mesh_lib.all_gather_rows(x, one) is x
    assert dict(mesh_lib.TALLY) == before
    assert not any(k.startswith("collective.")
                   for k in profiling.counters())


# ------------------------------------------------------- rank of a card test

CARD = dict(n_envs=4 * 1024, n_steps=32, fused_chunk=16,
            minibatch_size=4096, n_epochs=2, total_timesteps=4 * 1024 * 32,
            fused_rollout=True, fused_update=True)
CARD_K = 3


def _copy(state):
    g = torch.Generator()
    g.set_state(state.generator.get_state())
    return state.replace(
        params=state.params.clone(), opt_state=dataclasses.replace(
            state.opt_state, mu=state.opt_state.mu.clone(),
            nu=state.opt_state.nu.clone()),
        env_state=mesh_lib.map_tensors(state.env_state, torch.clone),
        obs=state.obs.clone(), generator=g)


def card_rank(out: str) -> None:
    """One rank of the card test: from one sharded state, CARD_K eager
    steps and one replayed call of CARD_K over NCCL; then a second call
    under the profiler, whose counters rank 0 writes beside the capture's
    tally and the comparison."""
    from acas2d_tpu_torch.config import DEFAULT_PARAMS
    from acas2d_tpu_torch.ppo import learner
    from acas2d_tpu_torch.ppo.config import PPOConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.multihost_init("cuda", timeout_s=60)
    cfg = PPOConfig(**CARD, seed=5)
    dev = mesh.device
    whole = learner.init_train_state(cfg, DEFAULT_PARAMS, dev)
    state = learner.shard_state(whole, mesh)
    step = learner.make_train_step(cfg, DEFAULT_PARAMS, dev, mesh=mesh)
    eager, rows = _copy(state), []
    for _ in range(CARD_K):
        eager, m = step(eager)
        rows.append(m)
    loop = learner.make_train_loop(cfg, DEFAULT_PARAMS, CARD_K, dev,
                                   mesh=mesh)
    replayed, metrics = loop(_copy(state))
    same = all(torch.equal(a, b) for a, b in zip(
        learner._state_leaves(eager), learner._state_leaves(replayed)))
    same = same and all(torch.equal(torch.stack([r[k] for r in rows]),
                                    metrics[k]) for k in metrics)
    tally = {k: v for k, v in next(iter(loop._graphs.values()))
             .tallied.items() if k.startswith("collective.")}
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        loop(replayed)
        torch.cuda.synchronize()
    counted = {k: v for k, v in profiling.counters().items()
               if k.startswith("collective.")}
    if mesh.rank == 0:
        with open(os.path.join(out, "card.json"), "w") as f:
            json.dump({"same": same, "tally": tally, "counted": counted,
                       "steps": cfg.n_epochs * cfg.n_minibatches,
                       "batch_bytes": cfg.batch_size * 13 * 4}, f)


if __name__ == "__main__":
    if sys.argv[1] == "card":
        card_rank(sys.argv[2])
