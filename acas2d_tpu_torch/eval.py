"""Greedy-policy evaluation driver of the PyTorch port.

Evaluates a policy on episodes spawned from the reference's Mersenne
stream, as the JAX driver `eval.py` does: a portable params artifact
(`--params-npz`, flat npz of the flax tree, the JAX package's
`utils/params_io.py` format), or a checkpoint of a port training run
(`--run DIR`: its latest, `--step N`, or `--best`, the best in-training
eval's).  `--exact` steps the environment in float64 (the policy runs in
float32, as there).  Prints one line per episode on stderr and a JSON
summary on stdout, and writes the episodes' telemetry CSV with the
reference's schema (`--out`, default `<run or .>/eval_<episodes>.csv`, as
the JAX driver's).

    python -m acas2d_tpu_torch.eval \\
        --params-npz artifacts/ppo_tpu_e_polished_best.npz --exact \\
        --episodes 100 --out runs/eval_100.csv
    python -m acas2d_tpu_torch.eval --run runs/ppo/<run-name> --best --exact

The episodes are played once, by the greedy telemetry rollout
(`envs/telemetry.py`), as the JAX driver plays them: the CSV holds their
records, and the summary is taken from the records' Outcome, Total Reward
and Time Steps.

Rendering, as the JAX driver's: `--render-every N` writes a full-HUD PNG
frame every N steps of the `--render-episodes` (default episode 1) into
`--render-dir` (default `<run or .>/frames`); `--view` replays the
episodes (default all) in one window at `--view-fps`.  Both draw from one
frame source (`episode_frames`) on the host, from the records of the
episodes already played on the device: the render path never touches the
step loop.  They need matplotlib; a render flag without it, or a bad
`--render-episodes`, fails before any episode is played.

    python -m acas2d_tpu_torch.eval --params-npz artifacts/ppo_ref_s8_best.npz \\
        --episodes 2 --render-every 100 --render-episodes 1,2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import telemetry
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, apply_flat,
                                                  flatten)
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils import episode_csv
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.params_io import from_jax_params, load_params_npz


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run", default=None,
                     help="a training run dir; its checkpoints/ is read")
    src.add_argument("--params-npz", default=None,
                     help="portable params artifact (flat npz of the flax "
                          "tree)")
    p.add_argument("--step", type=int, default=None,
                   help="with --run: the checkpoint of this global step "
                        "(default the latest)")
    p.add_argument("--best", action="store_true",
                   help="with --run: the best in-training eval's checkpoint")
    p.add_argument("--episodes", type=int, default=100)    # TEST_EPISODES
    p.add_argument("--out", default=None,
                   help="the episode CSV (default <run or .>/eval_<episodes>"
                        ".csv)")
    p.add_argument("--exact", action="store_true",
                   help="float64 environment stepping")
    p.add_argument("--skip-episodes", type=int, default=2,
                   help="Mersenne spawns consumed before the first episode "
                        "(the reference's gym.make + check_env)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    p.add_argument("--render-every", type=int, default=0, metavar="N",
                   help="dump a full-HUD PNG frame every N steps of the "
                        "rendered episodes (the reference renders live "
                        "during eval, testing_main.py:80; here frames are "
                        "written offline, never on the device step path)")
    p.add_argument("--view", action="store_true",
                   help="live on-screen replay of the eval episodes: every "
                        "step rendered into one interactive window at the "
                        "reference's FPS cap (testing_main.py:80 + "
                        "game.py:316-431; pacing = clock.tick(FPS), "
                        "environment.py:31).  Episodes roll on the device "
                        "first, then replay.  Uses the same frame source "
                        "as --render-every")
    p.add_argument("--view-fps", type=float, default=100.0,
                   help="--view frame-rate cap (reference: FPS=100, "
                        "settings.py:17)")
    p.add_argument("--render-episodes", default=None,
                   help="comma-separated 1-based episode numbers to render "
                        "(with --render-every / --view; default: episode 1 "
                        "for --render-every, ALL episodes for --view — the "
                        "reference replays every eval episode)")
    p.add_argument("--render-dir", default=None,
                   help="frame output dir (default <run or .>/frames)")
    args = p.parse_args(argv)
    if args.params_npz and (args.best or args.step is not None):
        p.error("--best and --step select a checkpoint of --run")
    if args.best and args.step is not None:
        p.error("--best and --step are exclusive")
    return args


def load_params(args) -> torch.Tensor:
    """The (N_PARAMS,) params of --params-npz (float32) or of a --run
    checkpoint, in the run's dtype (its iteration goes to stderr, as JAX
    eval.py prints it)."""
    if args.params_npz:
        model = ActorCritic()
        model.load_state_dict(
            from_jax_params(load_params_npz(args.params_npz)))
        return flatten(model)
    ckpt = CheckpointManager(os.path.join(args.run, "checkpoints"))
    raw = ckpt.restore_raw(step=args.step, best=args.best)
    if raw["params"].dim() != 1:
        raise ValueError(f"{args.run} is a population run; evaluate its "
                         f"selected_best.npz with --params-npz")
    print(f"loaded checkpoint (iteration {int(raw['iteration'])})",
          file=sys.stderr)
    return raw["params"]


class RenderError(ValueError):
    """A render flag that cannot be served (checked before any episode is
    played)."""


def render_selection(args) -> List[int]:
    """The 1-based episodes the render flags select, [] without a render
    flag (JAX eval.py:171-192): episode 1 for --render-every, all of them
    whenever --view is on.  Raises RenderError for a bad selection, and
    when matplotlib, which draws the frames, is missing."""
    if not (args.render_every > 0 or args.view):
        return []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise RenderError("--render-every and --view draw with matplotlib, "
                          "which is not installed") from None
    B = args.episodes
    spec = args.render_episodes or (
        ",".join(str(i) for i in range(1, B + 1)) if args.view else "1")
    try:
        eps = [int(e) for e in spec.split(",")]
    except ValueError:
        raise RenderError(f"--render-episodes {spec!r} is not a "
                          "comma-separated list of integers") from None
    bad = [e for e in eps if not 1 <= e <= B]
    if bad:
        raise RenderError(f"--render-episodes {bad} out of range 1..{B} "
                          "(--episodes)")
    return eps


def play(params: torch.Tensor, env_state, obs: torch.Tensor):
    """The greedy telemetry rollout of max_steps steps from a reset batch,
    on the host: initial_telemetry's numpy dict and a numpy Telemetry
    (T, B, ...).  The policy is the float32 clip(mean, -1, 1), in the
    env's dtype."""
    P = DEFAULT_PARAMS
    dtype = env_state.px.dtype
    model = ActorCritic(device=params.device)

    def policy(o):
        mean = apply_flat(model, params, o.to(params.dtype))[0][:, 0]
        return torch.clamp(mean, -1.0, 1.0).to(dtype)

    init = telemetry.initial_telemetry(env_state, P)
    _, tel = telemetry.rollout_telemetry_policy(env_state, obs, P.max_steps,
                                                policy, P)
    return {k: v.cpu().numpy() for k, v in init.items()}, tel.numpy()


def telemetry_episodes(params: torch.Tensor, env_state, obs: torch.Tensor
                       ) -> List[Dict]:
    """The reference's per-episode records (`episode_csv.episode_records`)
    of the greedy policy from a reset batch (`play`), each episode cut at
    its first done (JAX eval.py:221-243)."""
    init, tel = play(params, env_state, obs)
    return episode_csv.batch_records(init, tel,
                                     env_state.num_traffic.cpu().numpy())


def episode_frames(tel_b, n_traffic, tv_row, tpsi_row, params, every: int,
                   episode: int):
    """The ONE frame source shared by --render-every (PNG dump) and --view
    (live replay): yields (t, RGB frame) for every `every`-th step of one
    completed episode (`tel_b`, its numpy records), always including the
    final step.  Mirrors the reference's per-step view() during eval
    (testing_main.py:80, game.py:316-431)."""
    from acas2d_tpu_torch.render import render_frame

    k = episode_csv.episode_length(tel_b.done)
    total = 0.0
    trail = []
    for t in range(k):
        total += float(tel_b.reward[t])
        trail.append((float(tel_b.px[t]), float(tel_b.py[t])))
        if t % every and t != k - 1:
            continue
        yield t, render_frame(
            tel_b.px[t], tel_b.py[t], tel_b.psi[t],
            np.atleast_1d(tel_b.tx[t]), np.atleast_1d(tel_b.ty[t]),
            n_traffic, params, trail=trail,
            tv=tv_row, tpsi=tpsi_row,
            a_lat=float(tel_b.a_lat[t]),
            # steps counter as displayed live: observe() has run once at
            # reset and once per step (game.py:197)
            steps=t + 2, episode=episode, total_reward=total)


def view_episodes(episode_frame_iters, fps: float = 100.0,
                  caption: str = "ACAS-2D") -> int:
    """Live replay window: one persistent interactive figure updated in
    place (the pygame.display.update equivalent), paced to the reference's
    FPS cap — draw, then sleep off the remainder of the 1/fps budget
    (clock.tick semantics: a cap, not a guarantee).  Caption and (where
    the backend allows) the compass window icon mirror game.py:14-15.
    Returns the number of frames shown."""
    import time

    import matplotlib.pyplot as plt

    plt.ion()
    fig, ax = plt.subplots(figsize=(10, 6.25))
    ax.set_axis_off()
    try:
        fig.canvas.manager.set_window_title(caption)
    except Exception:
        pass
    try:    # TkAgg only: the reference's compass logo as the window icon
        import tkinter
        from acas2d_tpu_torch.utils.reference import reference_path
        icon = tkinter.PhotoImage(
            file=reference_path("gym_ACAS2D", "png", "004-compass.png"))
        fig.canvas.manager.window.iconphoto(False, icon)
    except Exception:
        pass
    im = None
    budget = 1.0 / max(fps, 1e-6)
    shown = 0
    for episode, frames in episode_frame_iters:
        for t, frame in frames:
            t0 = time.perf_counter()
            if im is None:
                im = ax.imshow(frame)
            else:
                im.set_data(frame)
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
            left = budget - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)
            shown += 1
    plt.close(fig)
    return shown


def render_episodes(args, render_eps: List[int], tel, num_traffic,
                    env_state, say) -> None:
    """The frames of the played episodes `render_eps` (1-based) that the
    render flags ask for, from their host records `tel`: PNGs every
    --render-every steps, then the --view replay."""
    tv, tpsi = env_state.tv.cpu().numpy(), env_state.tpsi.cpu().numpy()

    def frames(e, every):
        b = e - 1
        return episode_frames(tel.env(b), int(num_traffic[b]), tv[b, :1],
                              tpsi[b, :1], DEFAULT_PARAMS, every, e)

    if args.render_every > 0:
        import matplotlib.image as mpimg
        frames_dir = args.render_dir or os.path.join(args.run or ".",
                                                      "frames")
        for e in render_eps:
            ep_dir = os.path.join(frames_dir, f"episode_{e:03d}")
            os.makedirs(ep_dir, exist_ok=True)
            n_frames = 0
            for t, frame in frames(e, args.render_every):
                mpimg.imsave(os.path.join(ep_dir, f"step_{t:04d}.png"), frame)
                n_frames += 1
            say(f"wrote {n_frames} frames to {ep_dir}")
    if args.view:
        # after the CSV: a closed window / Ctrl-C must not lose the eval
        try:
            shown = view_episodes(((e, frames(e, 1)) for e in render_eps),
                                  fps=args.view_fps)
            say(f"replayed {len(render_eps)} episode(s), {shown} frames")
        except KeyboardInterrupt:
            say("view interrupted")


def run(args, log=None) -> Dict[str, float]:
    """Evaluate and write the episode CSV (and the frames the render flags
    ask for); returns the summary.  One line per episode goes to `log` (a
    text stream) when given.  Raises RenderError before anything is
    played when the render flags cannot be served."""
    render_eps = render_selection(args)
    device = resolve_device(args.device)
    params = load_params(args).to(device)
    spawner = MersenneSpawner(DEFAULT_PARAMS, seed=args.seed,
                              skip_episodes=args.skip_episodes)
    dtype = torch.float64 if args.exact else torch.float32
    env_state, obs = learner.mersenne_reset(DEFAULT_PARAMS, spawner,
                                            args.episodes, dtype, device)
    init, tel = play(params, env_state, obs)
    nt = env_state.num_traffic.cpu().numpy()
    episodes = episode_csv.batch_records(init, tel, nt)
    out = args.out or os.path.join(args.run or ".",
                                   f"eval_{args.episodes}.csv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    episode_csv.write_csv(out, episodes, episode_csv.FULL_COLUMNS)
    ret = np.array([e["Total Reward"] for e in episodes], np.float64)
    length = np.array([e["Time Steps"] - 1 for e in episodes])
    outcome = [e["Outcome"] for e in episodes]

    def say(msg):
        if log is not None:
            print(msg, file=log)

    for b in range(args.episodes):
        say(f"Episode {b + 1:<3}: Time steps: {int(length[b]):<7} - "
            f"Outcome: {outcome[b]:<10} - Total Reward = {float(ret[b])}")
    say(f"wrote {out}")

    if render_eps:
        render_episodes(args, render_eps, tel, nt, env_state, say)
    return {
        "episodes": args.episodes,
        "mean_reward": float(np.mean(ret)),
        "std_reward": float(np.std(ret)),
        # the sample std; artifacts/*.json records the std this way
        "std_reward_ddof1": float(np.std(ret, ddof=1)),
        "goals": outcome.count("Goal"),
        "collisions": outcome.count("Collision"),
        "timeouts": outcome.count("Timeout"),
        "mean_length": float(np.mean(length)),
        "device": str(device),
        "dtype": str(dtype).replace("torch.", ""),
    }


def main(argv=None) -> int:
    try:
        summary = run(parse_args(argv), log=sys.stderr)
    except RenderError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
