"""Elementwise geometry/kinematics ops of the ACAS-2D engine (torch).

Counterpart of `acas2d_tpu/ops/kinematics.py:33-134`: every function is an
elementwise tensor expression that broadcasts over any batch shape.
Headings are kept in degrees modulo 360 (screen coordinates: y down,
clockwise from +x) as the reference stores them.

`bug_compat=True` (the default) reproduces three reference behaviours:
  (a) `distance_closest_approach` uses single-argument arctan
      (kinematics.py:47);
  (b) `closing_speed` computes psi_dot without the /dt that the integrator
      applies (kinematics.py:57,67);
  (c) `closing_speed` uses aircraft 1's airspeed for aircraft 2's
      y-velocity (kinematics.py:74).
Floating-point op order matches the reference, so float64 results agree
with the oracle to the last few ulps (tests/test_torch_env.py).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
RAD_TO_DEG = 180.0 / math.pi


def deg_to_rad(psi_deg):
    """Degrees -> radians with the reference's op order ((psi/360)*2*pi)."""
    return (psi_deg / 360.0) * 2 * math.pi


def distance(x1, y1, x2, y2):
    """Euclidean distance (kinematics.py:7-13)."""
    dx = x1 - x2
    dy = y1 - y2
    return torch.sqrt(dx * dx + dy * dy)


def relative_angle(x1, y1, x2, y2):
    """Bearing 1->2 in degrees in [0,360) (kinematics.py:16-22)."""
    rads = torch.remainder(torch.atan2(y2 - y1, x2 - x1), TWO_PI)
    return rads * RAD_TO_DEG


def integrate(x, y, v, psi, a_lat, dt):
    """Euler step of the degree-space unicycle model (aircraft.py:16-26):
    psi += (a_lat/(v*dt))*dt, then advance along the new heading."""
    psi_dot = a_lat / (v * dt)
    psi = torch.remainder(psi + (psi_dot * dt), 360)
    psi_rad = deg_to_rad(psi)
    x = x + (v * torch.cos(psi_rad) * dt)
    y = y + (v * torch.sin(psi_rad) * dt)
    return x, y, psi


def distance_closest_approach(x1, y1, v1, psi1, x2, y2, v2, psi2,
                              bug_compat: bool = True):
    """Signed distance at closest point of approach (kinematics.py:40-49)."""
    d = distance(x1, y1, x2, y2)
    a_rel_rad = deg_to_rad(relative_angle(x1, y1, x2, y2))
    psi1_rad = deg_to_rad(psi1)
    psi2_rad = deg_to_rad(psi2)
    v12x = v1 * torch.cos(psi1_rad) - v2 * torch.cos(psi2_rad)
    v12y = v1 * torch.sin(psi1_rad) - v2 * torch.sin(psi2_rad)
    if bug_compat:
        # v12x == 0, v12y != 0 keeps the IEEE arctan(+-inf) = +-pi/2; the
        # 0/0 corner (where the reference raises) is defined as h_rel = 0.
        denom = torch.where((v12x == 0) & (v12y == 0), 1.0, v12x)
        h_rel_rad = torch.atan(v12y / denom)
    else:
        h_rel_rad = torch.atan2(v12y, v12x)
    return d * torch.sin(a_rel_rad - h_rel_rad)


def closing_speed(x1, y1, v1, psi1, a_lat1, x2, y2, v2, psi2, a_lat2, dt,
                  bug_compat: bool = True):
    """Closing speed via one-step lookahead (kinematics.py:52-79).
    Positive means separating (the reward code relies on this sign)."""
    if bug_compat:
        psi_dot_1 = a_lat1 / v1          # missing /dt vs aircraft.py:20
        psi_dot_2 = a_lat2 / v2
    else:
        psi_dot_1 = a_lat1 / (v1 * dt)
        psi_dot_2 = a_lat2 / (v2 * dt)
    psi_rad_1 = deg_to_rad(torch.remainder(psi1 + (psi_dot_1 * dt), 360))
    psi_rad_2 = deg_to_rad(torch.remainder(psi2 + (psi_dot_2 * dt), 360))

    vx1 = v1 * torch.cos(psi_rad_1) * dt
    vy1 = v1 * torch.sin(psi_rad_1) * dt
    nx1 = x1 + vx1
    ny1 = y1 + vy1

    vx2 = v2 * torch.cos(psi_rad_2) * dt
    vy2_speed = v1 if bug_compat else v2   # kinematics.py:74 typo
    vy2 = vy2_speed * torch.sin(psi_rad_2) * dt
    ny2_vy = v2 * torch.sin(psi_rad_2) * dt  # position update uses v2
    nx2 = x2 + vx2
    ny2 = y2 + ny2_vy

    num = (vx1 - vx2) * (nx1 - nx2) + (vy1 - vy2) * (ny1 - ny2)
    # Coincident predicted positions (a reference ZeroDivisionError corner):
    # num is 0 there too, so c = 0.
    d_next = distance(nx1, ny1, nx2, ny2)
    return (num / torch.where(d_next == 0, 1.0, d_next)) / dt


def delta_heading(psi, phi):
    """Smallest angular difference in degrees (kinematics.py:82-83)."""
    a = torch.abs(psi - phi)
    return torch.minimum(a, 360.0 - a)
