"""Host-side rendering: offline trajectory replay, decoupled from training.

Counterpart of `acas2d_tpu/render.py` in the PyTorch port; the frames are
drawn by the same matplotlib calls, so they are the JAX package's pixel for
pixel.  matplotlib is imported only inside the functions that draw (the
card's machine has none).  The HUD's quantities come from the port's
scalar oracle (`oracle.py`) and its `ops/rewards.py`, on float64 scalars.

The reference renders with pygame inside the step loop (game.py:316-431),
throttling the whole engine; here rendering is a pure host-side consumer of
recorded trajectories (the SURVEY.md §7 'optional host-side replay' design).
Matplotlib (Agg) draws the same scene elements the reference's view() does:
sky-blue airspace, player/traffic markers with red collision-radius circles,
yellow goal-radius circle, and HUD text.  Outputs PNG frames, episode
overview plots, or rgb_array frames for the gymnasium wrapper.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from acas2d_tpu_torch import oracle
from acas2d_tpu_torch.config import EnvParams, DEFAULT_PARAMS, OUTCOME_NAMES
from acas2d_tpu_torch.ops import rewards as R
from acas2d_tpu_torch.utils import episode_csv

SKY = (60 / 255, 150 / 255, 220 / 255)      # settings.py:23 SKY_RGB
RED = (1.0, 0.0, 0.0)
YELLOW = (1.0, 1.0, 0.0)
GREEN = (0.0, 1.0, 0.0)

# Sprite assets (settings.py:51-54): the reference blits the player/
# traffic/goal PNGs axis-aligned at (x - AIRCRAFT_SIZE/2, y - SIZE/2)
# with NO rotation (game.py:17-19 loads them once, game.py:327-338 blits
# raw; the compass is only the window icon, game.py:15).  When the
# reference checkout (or any directory with the same png/ layout) is
# available the replays composite the same sprites; geometric markers
# remain the fallback so rendering never depends on the assets.
_SPRITE_FILES = {"player": "001-plane.png", "traffic": "002-travelling.png",
                 "goal": "003-army.png"}
_sprite_cache: Optional[dict] = None


def load_sprites(refresh: bool = False) -> Optional[dict]:
    """The reference's three scene sprites as float RGBA arrays, or None
    when unavailable.  Looks under $ACAS2D_REFERENCE_DIR/gym_ACAS2D/png
    (utils/reference.py).  Cached after the first successful load."""
    global _sprite_cache
    if _sprite_cache is not None and not refresh:
        return _sprite_cache or None
    from acas2d_tpu_torch.utils.reference import reference_path
    import matplotlib.image as mimg
    sprites = {}
    for key, fname in _SPRITE_FILES.items():
        path = reference_path("gym_ACAS2D", "png", fname)
        if not os.path.exists(path):
            _sprite_cache = {}
            return None
        sprites[key] = mimg.imread(path)
    _sprite_cache = sprites
    return sprites


def _blit(ax, img, x: float, y: float, size: float):
    """Axis-aligned sprite blit centered like the reference's
    (x - size/2, y - size/2) screen placement (game.py:327-338), on the
    y-down world axes."""
    half = size / 2
    # imshow autoscales the axes to include its extent; preserve the
    # airspace limits set by _new_axes (and any caller adjustments)
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    ax.imshow(img, extent=(x - half, x + half, y + half, y - half),
              zorder=3, interpolation="bilinear")
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)


def _new_axes(params: EnvParams, dpi=80):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(
        figsize=(params.width / 160, params.height / 160), dpi=dpi)
    ax.set_xlim(0, params.width)
    ax.set_ylim(params.height, 0)            # screen coords: y down
    ax.set_aspect("equal")
    ax.set_facecolor(SKY)
    return fig, ax


def _draw_scene(ax, px, py, tx, ty, num_traffic, params: EnvParams,
                sprites: Optional[dict] = None):
    """Scene composition mirroring view() (game.py:324-348): sprites (when
    the reference assets are available) or geometric markers, plus the
    collision/goal radius circles the reference always draws on top."""
    import matplotlib.patches as mpatches
    if sprites is None:
        sprites = load_sprites()
    size = params.aircraft_size
    ax.add_patch(mpatches.Circle((params.goal_x, params.goal_y),
                                 params.goal_radius, fill=False,
                                 color=YELLOW, lw=1.5))
    if sprites:
        _blit(ax, sprites["goal"], params.goal_x, params.goal_y, size)
        _blit(ax, sprites["player"], px, py, size)
    else:
        ax.plot([params.goal_x], [params.goal_y], marker="*", ms=14,
                color=YELLOW)
        ax.plot([px], [py], marker="^", ms=8, color="white")
    ax.add_patch(mpatches.Circle((px, py), params.collision_radius,
                                 fill=False, color=RED, lw=1.0))
    for n in range(num_traffic):
        ax.add_patch(mpatches.Circle((tx[n], ty[n]), params.collision_radius,
                                     fill=False, color=RED, lw=1.0))
        if sprites:
            _blit(ax, sprites["traffic"], tx[n], ty[n], size)
        else:
            ax.plot([tx[n]], [ty[n]], marker="v", ms=8, color="black")


def hud_quantities(px, py, psi, tx, ty, tv, tpsi, a_lat,
                   steps: int = 0, episode: int = 0,
                   total_reward: float = 0.0,
                   params: EnvParams = DEFAULT_PARAMS) -> dict:
    """All 15 live quantities of the reference HUD (game.py:350-428),
    computed host-side from scalar state via the NumPy oracle (identical
    float semantics to the reference, incl. the bug_compat kinematics the
    display path uses: closing_speed/distance_closest_approach quirks).

    Keys/rounding match the reference's on-screen labels; step_reward is the
    display-only step_reward_6 (polarized plan deviation, game.py:421-428).
    """
    p = params
    tx0, ty0, tv0, tpsi0 = (float(tx[0]), float(ty[0]), float(tv[0]),
                            float(tpsi[0]))
    d_goal = oracle.distance(px, py, p.goal_x, p.goal_y)
    h_goal = oracle.relative_angle(px, py, p.goal_x, p.goal_y)
    d_dev = d_goal * np.sin(np.radians(h_goal))
    v_closing = oracle.closing_speed(px, py, p.airspeed, psi, a_lat,
                                     tx0, ty0, tv0, tpsi0, 0.0, p)
    d_cpa = oracle.distance_closest_approach(
        px, py, p.airspeed, psi, tx0, ty0, tv0, tpsi0, p.bug_compat)
    r6 = float(R.step_reward_6(*(torch.tensor(float(v), dtype=torch.float64)
                                 for v in (v_closing, psi, h_goal, d_cpa,
                                           d_goal, d_dev)),
                               p.safe_distance, p.d_dev_max_reward,
                               p.d_goal_max_reward))
    return {
        # top-left block (game.py:351-368)
        "pos": f"pos: ({round(px, 1)}, {round(py, 1)})",
        "v_air": f"v_air: {round(p.airspeed, 1)}",
        "psi": f"psi: {round(psi, 1)}",
        "psi_dot": f"psi_dot: {round(a_lat / (p.airspeed * p.dt), 1)}",
        "a_lat": f"a_lat: {round(a_lat, 1)}",
        "a_lat_norm": f"a_lat_norm: {round(a_lat / p.acc_lat_limit, 3)}",
        # bottom-left metrics block (game.py:371-397)
        "d_goal": f"Distance to goal: {round(d_goal, 1)}",
        "min_separation": ("Min. Separation: "
                           f"{round(oracle.distance(px, py, tx0, ty0), 1)}"),
        "rel_angle_traffic": ("Rel. angle to traffic: "
                              f"{round(oracle.relative_angle(px, py, tx0, ty0), 1)}"),
        "v_closing": f"Closing Speed: {round(v_closing, 1)}",
        "d_cpa": f"Closest approach: {round(d_cpa, 1)}",
        "delta_heading": ("Delta heading: "
                          f"{round(oracle.delta_heading(psi, h_goal), 1)}"),
        "d_dev": f"Plan deviation: {round(d_dev, 1)}",
        # bottom-center (game.py:400-403)
        "steps": f"Steps: {int(steps)}",
        "episode": f"Episode: {int(episode)}",
        # bottom-right reward block (game.py:406-428)
        "total_reward": f"Total reward: {round(total_reward, 1)}",
        "r_heading": ("Step heading reward: "
                      f"{round(oracle.heading_reward(psi, h_goal), 3)}"),
        "r_cpa": ("Step closest approach reward: "
                  f"{round(oracle.closest_approach_reward(v_closing, d_cpa, p), 3)}"),
        "r_goal_dist": ("Step goal distance reward: "
                        f"{round(oracle.goal_distance_reward(d_goal, p), 3)}"),
        "r_plan_dev": ("Step plan deviation reward: "
                       f"{round(oracle.plan_deviation_reward(d_dev, p), 3)}"),
        "r_step": f"Step reward: {round(r6, 3)}",
    }


# (label-key, x, y) placements mirroring the reference's blit coordinates
# (game.py:350-428; y measured in screen pixels, y-down axes).
_HUD_LAYOUT = [
    ("pos", 20, 20), ("v_air", 20, 40), ("psi", 20, 60),
    ("psi_dot", 20, 80), ("a_lat", 20, 100), ("a_lat_norm", 20, 120),
    ("d_goal", 20, -20), ("min_separation", 20, -40),
    ("rel_angle_traffic", 20, -60), ("v_closing", 20, -80),
    ("d_cpa", 20, -100), ("delta_heading", 20, -120), ("d_dev", 20, -140),
    ("steps", 0.5, -20), ("episode", 0.5, -40),
    ("total_reward", -300, -20), ("r_step", -300, -40),
    ("r_plan_dev", -300, -60), ("r_goal_dist", -300, -80),
    ("r_cpa", -300, -100), ("r_heading", -300, -120),
]


def draw_hud(ax, hud: dict, params: EnvParams):
    """Place HUD text in the reference's four screen regions."""
    for key, x, y in _HUD_LAYOUT:
        if key not in hud:
            continue
        xx = params.width / 2 - 50 if x == 0.5 else (
            params.width + x if x < 0 else x)
        yy = params.height + y if y < 0 else y
        ax.text(xx, yy, hud[key], fontsize=7, color="black",
                family="monospace")


def render_frame(px, py, psi, tx, ty, num_traffic,
                 params: EnvParams = DEFAULT_PARAMS,
                 trail: Optional[Sequence[Tuple[float, float]]] = None,
                 tv=None, tpsi=None, a_lat: float = 0.0,
                 steps: int = 0, episode: int = 0,
                 total_reward: float = 0.0) -> np.ndarray:
    """One live frame as an HxWx3 uint8 array (gymnasium rgb_array mode).

    With traffic kinematics (tv/tpsi) provided, draws the reference's full
    15-quantity HUD (game.py:350-428); otherwise a minimal position line.
    """
    fig, ax = _new_axes(params)
    if trail:
        t = np.asarray(trail)
        ax.plot(t[:, 0], t[:, 1], color="white", lw=0.8, alpha=0.7)
    _draw_scene(ax, px, py, tx, ty, num_traffic, params)
    if tv is not None and tpsi is not None and num_traffic > 0:
        hud = hud_quantities(float(px), float(py), float(psi),
                             np.atleast_1d(tx), np.atleast_1d(ty),
                             np.atleast_1d(tv), np.atleast_1d(tpsi),
                             float(a_lat), steps, episode, total_reward,
                             params)
        draw_hud(ax, hud, params)
    else:
        ax.text(20, 40, f"pos: ({px:.1f}, {py:.1f})  psi: {psi:.1f}",
                fontsize=8, color="black")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    import matplotlib.pyplot as plt
    plt.close(fig)
    return buf


def plot_episode(path: Sequence[Tuple[float, float]],
                 traffic_paths: Sequence[Sequence[Tuple[float, float]]],
                 params: EnvParams = DEFAULT_PARAMS,
                 outcome: Optional[int] = None,
                 title: str = "", out_png: Optional[str] = None):
    """Whole-episode trajectory overview (the notebooks' scatter plots)."""
    import matplotlib.pyplot as plt
    fig, ax = _new_axes(params)
    p = np.asarray(path)
    ax.plot(p[:, 0], p[:, 1], color="white", lw=1.2, label="player")
    for n, tp in enumerate(traffic_paths):
        tp = np.asarray(tp)
        ax.plot(tp[:, 0], tp[:, 1], color="black", lw=1.0,
                label="traffic" if n == 0 else None)
    _draw_scene(ax, p[-1, 0], p[-1, 1],
                [np.asarray(tp)[-1, 0] for tp in traffic_paths],
                [np.asarray(tp)[-1, 1] for tp in traffic_paths],
                len(traffic_paths), params)
    label = OUTCOME_NAMES.get(outcome, "") if outcome else ""
    ax.set_title(f"{title} {label}".strip())
    ax.legend(loc="lower left", fontsize=8)
    if out_png:
        os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
        fig.savefig(out_png, bbox_inches="tight")
        plt.close(fig)
        return out_png
    return fig


def render_run_csv(csv_path: str, out_dir: str,
                   episodes: Optional[List[int]] = None,
                   params: EnvParams = DEFAULT_PARAMS) -> List[str]:
    """Replay episodes from a driver CSV (baseline.py / eval.py output or
    the reference's own logs) into per-episode PNGs."""
    rows = {row["Episode"]: row for row in episode_csv.read_csv(csv_path)}
    outs = []
    idxs = episodes if episodes is not None else range(1, len(rows) + 1)
    name_to_code = {v: k for k, v in OUTCOME_NAMES.items()}
    for e in idxs:
        row = rows[e]
        path = row["Path"]
        tps = row["Traffic Paths"]
        out_png = os.path.join(out_dir, f"episode_{e:03d}.png")
        plot_episode(path, tps, params,
                     outcome=name_to_code.get(row["Outcome"]),
                     title=f"Episode {e}", out_png=out_png)
        outs.append(out_png)
    return outs
