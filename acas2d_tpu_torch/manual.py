"""Interactive manual-play driver of the PyTorch port (JAX `manual.py`).

The reference's manual mode is a pygame loop with arrow-key teleportation
and a crashing `bounce` call (manual_main.py:99).  This headless rebuild
drives the real environment dynamics (lateral-acceleration control, not
teleports) from the terminal, on the port's `LegacyACAS2DEnv`:

    python -m acas2d_tpu_torch.manual                 # interactive: a/d steer, s straight
    python -m acas2d_tpu_torch.manual --frames out/   # also dump a PNG frame every step

Keys:  a = full left (-1)   d = full right (+1)   s = zero
       j/l = soft left/right (-/+ 0.25)   q = quit, r = reset
Hold a key then Enter (line mode) or use --raw for unbuffered keys.
The env steps on `--device` (default cuda); frames and the live view
(`--view`, which needs a display; without $DISPLAY it switches to
`--frames manual_frames/`) are drawn with matplotlib on the host.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

KEY_ACTIONS = {"a": -1.0, "d": 1.0, "s": 0.0, "j": -0.25, "l": 0.25}

_VIEW_STATE = {}


def _show_frame(frame):
    """Live viewer: one persistent interactive matplotlib window updated
    in place (the reference's pygame.display.update equivalent)."""
    import matplotlib.pyplot as plt
    if "im" not in _VIEW_STATE:
        plt.ion()
        fig, ax = plt.subplots(figsize=(10, 6.25))
        ax.set_axis_off()
        _VIEW_STATE["fig"] = fig
        _VIEW_STATE["im"] = ax.imshow(frame)
        fig.show()
    else:
        _VIEW_STATE["im"].set_data(frame)
    _VIEW_STATE["fig"].canvas.draw_idle()
    _VIEW_STATE["fig"].canvas.flush_events()


def _save_frame(frame, frames_dir: str, t: int):
    """One frame as a PNG (PIL), or as .npy where PIL is missing."""
    os.makedirs(frames_dir, exist_ok=True)
    try:
        from PIL import Image
        Image.fromarray(frame).save(os.path.join(frames_dir, f"f{t:05d}.png"))
    except ImportError:
        np.save(os.path.join(frames_dir, f"f{t:05d}.npy"), frame)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", default=None,
                    help="directory to dump PNG frames into")
    ap.add_argument("--raw", action="store_true",
                    help="unbuffered single-key input (POSIX tty)")
    ap.add_argument("--view", action="store_true",
                    help="live matplotlib window with the full reference "
                         "HUD (needs a display; on headless machines use "
                         "--frames and view the PNGs)")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.view and not os.environ.get("DISPLAY"):
        print("--view needs a display ($DISPLAY unset); falling back to "
              "--frames manual_frames/", file=sys.stderr)
        args.view = False
        args.frames = args.frames or "manual_frames"
    if args.frames or args.view:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("error: --frames and --view draw with matplotlib, which "
                  "is not installed", file=sys.stderr)
            return 2

    from acas2d_tpu_torch.config import DEFAULT_PARAMS, OUTCOME_NAMES
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv

    P = DEFAULT_PARAMS
    env = LegacyACAS2DEnv(P, device=args.device)
    env._backend.seed(args.seed)
    obs = env.reset()
    action = 0.0
    t = 0
    total = 0.0

    def read_key():
        if args.raw and sys.stdin.isatty():
            import termios
            import tty
            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setraw(fd)
                return sys.stdin.read(1)
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)
        line = sys.stdin.readline()
        return line.strip()[:1] if line else "q"

    print("a/d full left/right, j/l soft, s straight, r reset, q quit")
    while True:
        s = env._backend.game_state
        print(f"t={t:4d} pos=({float(s.px):7.1f},{float(s.py):7.1f}) "
              f"psi={float(s.ppsi):6.1f} act={action:+.2f} R={total:8.2f}",
              end=" > ", flush=True)
        k = read_key()
        if k == "q":
            return 0
        if k == "r":
            obs, action, t, total = env.reset(), 0.0, 0, 0.0
            print("\n-- reset --")
            continue
        if k in KEY_ACTIONS:
            action = KEY_ACTIONS[k]
        obs, reward, done, _ = env.step(np.array([action]))
        total += reward
        t += 1
        if args.frames or args.view:
            from acas2d_tpu_torch.render import render_frame
            s = env._backend.game_state
            frame = render_frame(float(s.px), float(s.py), float(s.ppsi),
                                 np.asarray(s.tx), np.asarray(s.ty),
                                 int(s.num_traffic), P,
                                 tv=np.asarray(s.tv), tpsi=np.asarray(s.tpsi),
                                 a_lat=float(s.pa_lat), steps=int(s.steps),
                                 episode=1, total_reward=total)
            if args.view:
                _show_frame(frame)
            if args.frames:
                _save_frame(frame, args.frames, t)
        if done:
            print(f"\n== {OUTCOME_NAMES[env.outcome]} at t={t}, "
                  f"total reward {total:.2f} ==")
            obs, action, t, total = env.reset(), 0.0, 0, 0.0


if __name__ == "__main__":
    sys.exit(main())
