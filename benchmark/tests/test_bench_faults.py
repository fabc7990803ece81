"""The check catches a broken timed path: a run of each cell at a tiny size
on the CPU, with the cell's own limits, with one fault planted in the
program underneath, comes out not correct.  The faults: a step that
returns its state unchanged; half of each minibatch (or of the envs) left
out, the mean taken over the rest; an answer altered where it is produced
(a reward in the rollout, an eval's return, an env rollout's sums).  The
exchange between chips does not exist in these one-chip cells."""

import pytest
import torch

from benchmark import run
from conftest import measure, tiny


def _train_faults(monkeypatch, fault, pop):
    from acas2d_tpu_torch.ppo import learner, population
    if fault == "unchanged":
        real = learner.ppo_update_members

        def stuck(params, opt_state, *a, **k):
            return (params, opt_state) + real(params, opt_state, *a, **k)[2:]
        monkeypatch.setattr(learner, "ppo_update_members", stuck)
    elif fault == "half":
        real = learner.ppo_minibatch_grads_members

        def half(params, mb, **k):
            return real(params, mb[:, :mb.shape[1] // 2], **k)
        monkeypatch.setattr(learner, "ppo_minibatch_grads_members", half)
    elif fault == "altered":
        mod, name = ((population, "fused_policy_rollout_members") if pop
                     else (learner, "fused_policy_rollout"))
        real = getattr(mod, name)

        def altered(*a, **k):
            final, bufs = real(*a, **k)
            bufs["rewards"] = bufs["rewards"] + 1.0
            return final, bufs
        monkeypatch.setattr(mod, name, altered)
    elif fault == "eval":
        real = learner.eval_metrics

        def wrong(ep):
            m = real(ep)
            m["eval_return_mean"] = m["eval_return_mean"] + 1.0
            return m
        monkeypatch.setattr(learner, "eval_metrics", wrong)


@pytest.mark.parametrize("name,fault", [
    ("pop32.train", "unchanged"), ("pop32.train", "half"),
    ("pop32.train", "altered"), ("solo_tpu.train", "unchanged"),
    ("solo_tpu.train", "half"), ("solo_tpu.train", "altered"),
    ("pop32.attempt", "eval")])
def test_training_fault_fails(monkeypatch, name, fault):
    cell = tiny(name)
    _train_faults(monkeypatch, fault, cell.config["population"] > 0)
    rec = measure(cell)
    assert run.result(cell, rec, False, {})["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_env_fault_fails(monkeypatch, fault):
    from acas2d_tpu_torch.ops import env_rollout
    real = env_rollout.fused_rollout

    def broken(state, seed, T, *a, **k):
        st, stats = real(state, seed, T, *a, **k)
        if fault == "unchanged":
            st = dict(state)
        elif fault == "half":
            n = state["px"].shape[0] // 2
            st = {key: torch.cat([v[:n], state[key][n:]])
                  for key, v in st.items()}
        else:
            stats = dict(stats, reward_sum=stats["reward_sum"] + 1.0)
        return st, stats
    monkeypatch.setattr(env_rollout, "fused_rollout", broken)
    cell = tiny("envstep.obs")
    rec = measure(cell)
    assert run.result(cell, rec, False, {})["correct"] is False


@pytest.mark.parametrize("name", ["pop32.attempt", "solo_tpu.train",
                                  "envstep.obs"])
def test_sound_run_passes(name):
    cell = tiny(name)
    assert run.result(cell, measure(cell), False, {})["correct"] is True
