"""Analytic reference-trajectory families (pure functions of time).

The ten families, their default parameters and the fifteen named
configurations mirror ``/root/reference/src/px4/trajectory_definitions.py``
(formulas at :48-470, configs at :472-560) — including its quirks (the
circle's ``z = -center[2]`` flip at :103, the sine wave's ``z = -center[2]``
at :341, simplified accelerations on square/spiral/waypoint/cloverleaf).

Differences from the reference:

* every family accepts scalar **or batched** ``t`` and broadcasts — a whole
  horizon or a 1k-trajectory sweep evaluates as one fused XLA program
  (the reference loops Python calls per tick);
* the piecewise families (square, spiral, waypoint) are branch-free
  (``jnp.select`` / modular arithmetic) so they trace under ``jit``/``vmap``;
* each returns a ``(pos, vel, acc)`` tuple of ``(..., 3)`` arrays.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import jax.numpy as jnp

Array = jnp.ndarray
Traj = Tuple[Array, Array, Array]

_DEF_CENTER = (0.0, 0.0, -2.0)


def _pack(x, y, z, vx, vy, vz, ax, ay, az) -> Traj:
    comps = [jnp.asarray(c, dtype=jnp.result_type(float)) for c in (x, y, z, vx, vy, vz, ax, ay, az)]
    shape = jnp.broadcast_shapes(*(c.shape for c in comps))
    comps = [jnp.broadcast_to(c, shape) for c in comps]

    def arr(a, b, c):
        return jnp.stack([a, b, c], axis=-1)

    return arr(*comps[0:3]), arr(*comps[3:6]), arr(*comps[6:9])


def figure_8_trajectory(t, scale=3.0, period=20.0, center=_DEF_CENTER) -> Traj:
    """Gerono figure-8 (``trajectory_definitions.py:48-79``)."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi / period
    x = center[0] + scale * jnp.sin(w * t)
    y = center[1] + scale * jnp.sin(2.0 * w * t) / 2.0
    z = center[2]
    vx = scale * w * jnp.cos(w * t)
    vy = scale * w * jnp.cos(2.0 * w * t)
    ax = -scale * w**2 * jnp.sin(w * t)
    ay = -2.0 * scale * w**2 * jnp.sin(2.0 * w * t)
    return _pack(x, y, z, vx, vy, 0.0, ax, ay, 0.0)


def circular_trajectory(t, radius=2.5, period=15.0, center=_DEF_CENTER) -> Traj:
    """XY circle; note the reference's ``z = -center[2]`` (:103)."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi / period
    x = center[0] + radius * jnp.cos(w * t)
    y = center[1] + radius * jnp.sin(w * t)
    z = -center[2]
    vx = -radius * w * jnp.sin(w * t)
    vy = radius * w * jnp.cos(w * t)
    ax = -radius * w**2 * jnp.cos(w * t)
    ay = -radius * w**2 * jnp.sin(w * t)
    return _pack(x, y, z, vx, vy, 0.0, ax, ay, 0.0)


def square_trajectory(t, side_length=4.0, period=24.0, center=_DEF_CENTER) -> Traj:
    """Axis-aligned square, branch-free version of :113-165."""
    t = jnp.asarray(t)
    cycle = (t % period) / period
    half = side_length / 2.0
    edge_speed = 2.0 * half / (period / 4.0)

    p0 = cycle * 4.0
    p1 = (cycle - 0.25) * 4.0
    p2 = (cycle - 0.5) * 4.0
    p3 = (cycle - 0.75) * 4.0

    conds = [cycle < 0.25, cycle < 0.5, cycle < 0.75]
    x = jnp.select(
        conds,
        [center[0] + half * (2 * p0 - 1), center[0] + half, center[0] + half * (1 - 2 * p2)],
        center[0] - half,
    )
    y = jnp.select(
        conds,
        [center[1] - half, center[1] + half * (2 * p1 - 1), center[1] + half],
        center[1] + half * (1 - 2 * p3),
    )
    vx = jnp.select(conds, [edge_speed + 0 * t, 0 * t, -edge_speed + 0 * t], 0 * t)
    vy = jnp.select(conds, [0 * t, edge_speed + 0 * t, 0 * t], -edge_speed + 0 * t)
    return _pack(x, y, center[2], vx, vy, 0.0, 0.0, 0.0, 0.0)


def lemniscate_trajectory(t, scale=3.0, period=25.0, center=_DEF_CENTER) -> Traj:
    """Gerono lemniscate (:167-199)."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi / period
    c, s = jnp.cos(w * t), jnp.sin(w * t)
    x = center[0] + scale * c
    y = center[1] + scale * s * c
    vx = -scale * w * s
    vy = scale * w * (c**2 - s**2)
    ax = -scale * w**2 * c
    ay = -4.0 * scale * w**2 * s * c
    return _pack(x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def spiral_trajectory(
    t, max_radius=3.0, period=20.0, num_turns=2.0, center=_DEF_CENTER
) -> Traj:
    """Expanding/contracting spiral, branch-free version of :201-242."""
    t = jnp.asarray(t)
    cycle = (t % period) / period
    angle = 2.0 * jnp.pi * num_turns * cycle
    radius = jnp.where(
        cycle < 0.5, max_radius * 2.0 * cycle, max_radius * (2.0 - 2.0 * cycle)
    )
    w = 2.0 * jnp.pi * num_turns / period
    x = center[0] + radius * jnp.cos(angle)
    y = center[1] + radius * jnp.sin(angle)
    vx = -radius * w * jnp.sin(angle)
    vy = radius * w * jnp.cos(angle)
    ax = -radius * w**2 * jnp.cos(angle)
    ay = -radius * w**2 * jnp.sin(angle)
    return _pack(x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def waypoint_trajectory(
    t,
    waypoints: Sequence[Tuple[float, float]] | None = None,
    segment_time: float = 8.0,
    center=_DEF_CENTER,
) -> Traj:
    """Piecewise-linear waypoint path, branch-free version of :244-288."""
    if waypoints is None:
        waypoints = [(2, 2), (-2, 2), (-2, -2), (2, -2)]
    wps = jnp.asarray(waypoints, dtype=jnp.result_type(float))
    n = wps.shape[0]
    t = jnp.asarray(t)

    total = n * segment_time
    cycle = t % total
    seg = jnp.floor(cycle / segment_time).astype(jnp.int32)
    prog = (cycle % segment_time) / segment_time

    cur = wps[seg % n]
    nxt = wps[(seg + 1) % n]
    xy = cur + (nxt - cur) * prog[..., None]
    vxy = (nxt - cur) / segment_time
    return _pack(
        center[0] + xy[..., 0],
        center[1] + xy[..., 1],
        center[2],
        vxy[..., 0],
        vxy[..., 1],
        0.0,
        0.0,
        0.0,
        0.0,
    )


def hover_trajectory(t, position=_DEF_CENTER) -> Traj:
    """Static hover (:290-302)."""
    t = jnp.asarray(t)
    return _pack(position[0], position[1] + 0 * t, position[2], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def sine_wave_trajectory(
    t, amplitude=2.0, frequency=0.1, axis="xy", center=_DEF_CENTER
) -> Traj:
    """Sine wave along an axis (:304-352); ``axis`` is static config."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi * frequency
    z = -center[2]  # reference flips z here (:341)
    if axis == "x":
        x, y = center[0] + amplitude * jnp.sin(w * t), center[1] + 0 * t
        vx, vy = amplitude * w * jnp.cos(w * t), 0 * t
        ax, ay = -amplitude * w**2 * jnp.sin(w * t), 0 * t
    elif axis == "y":
        x, y = center[0] + 0 * t, center[1] + amplitude * jnp.sin(w * t)
        vx, vy = 0 * t, amplitude * w * jnp.cos(w * t)
        ax, ay = 0 * t, -amplitude * w**2 * jnp.sin(w * t)
    else:
        phase = jnp.pi / 4 if axis == "xy" else jnp.pi / 3
        x = center[0] + amplitude * jnp.sin(w * t)
        y = center[1] + amplitude * jnp.sin(w * t + phase)
        vx = amplitude * w * jnp.cos(w * t)
        vy = amplitude * w * jnp.cos(w * t + phase)
        ax = -amplitude * w**2 * jnp.sin(w * t)
        ay = -amplitude * w**2 * jnp.sin(w * t + phase)
    return _pack(x, y, z, vx, vy, 0.0, ax, ay, 0.0)


def oval_trajectory(t, a=3.0, b=1.5, period=18.0, center=_DEF_CENTER) -> Traj:
    """Ellipse (:354-385)."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi / period
    x = center[0] + a * jnp.cos(w * t)
    y = center[1] + b * jnp.sin(w * t)
    vx = -a * w * jnp.sin(w * t)
    vy = b * w * jnp.cos(w * t)
    ax = -a * w**2 * jnp.cos(w * t)
    ay = -b * w**2 * jnp.sin(w * t)
    return _pack(x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


def cloverleaf_trajectory(t, scale=2.5, period=30.0, center=_DEF_CENTER) -> Traj:
    """Four-leaf clover with the reference's simplified derivatives (:387-424)."""
    t = jnp.asarray(t)
    w = 2.0 * jnp.pi / period
    c, s = jnp.cos(w * t), jnp.sin(w * t)
    r = scale * jnp.abs(jnp.cos(2.0 * w * t))
    x = center[0] + r * c
    y = center[1] + r * s
    vx = -scale * w * s * jnp.abs(jnp.cos(2.0 * w * t))
    vy = scale * w * c * jnp.abs(jnp.cos(2.0 * w * t))
    ax = -scale * w**2 * c * jnp.abs(jnp.cos(2.0 * w * t))
    ay = -scale * w**2 * s * jnp.abs(jnp.cos(2.0 * w * t))
    return _pack(x, y, center[2], vx, vy, 0.0, ax, ay, 0.0)


_FAMILIES: dict[str, Callable[..., Traj]] = {
    "figure_8": figure_8_trajectory,
    "circle": circular_trajectory,
    "square": square_trajectory,
    "lemniscate": lemniscate_trajectory,
    "spiral": spiral_trajectory,
    "waypoint_path": waypoint_trajectory,
    "hover": hover_trajectory,
    "sine_wave": sine_wave_trajectory,
    "oval": oval_trajectory,
    "cloverleaf": cloverleaf_trajectory,
}


def available_trajectories() -> list[str]:
    return list(_FAMILIES)


# Named configurations, verbatim from ``trajectory_definitions.py:472-545``.
TRAJECTORY_CONFIGS = {
    "easy_circle": {"name": "circle", "params": {"radius": 6.0, "period": 60.0}},
    "fast_circle": {"name": "circle", "params": {"radius": 6.5, "period": 12.0}},
    "large_circle": {"name": "circle", "params": {"radius": 10.0, "period": 25.0}},
    "slow_figure8": {"name": "figure_8", "params": {"scale": 5.5, "period": 30.0}},
    "fast_figure8": {"name": "figure_8", "params": {"scale": 3.0, "period": 15.0}},
    "tight_figure8": {"name": "figure_8", "params": {"scale": 1.5, "period": 20.0}},
    "gentle_spiral": {
        "name": "spiral",
        "params": {"max_radius": 2.5, "period": 25.0, "num_turns": 1.5},
    },
    "aggressive_spiral": {
        "name": "spiral",
        "params": {"max_radius": 3.5, "period": 18.0, "num_turns": 3.0},
    },
    "square_path": {"name": "square", "params": {"side_length": 10.0, "period": 20.0}},
    "waypoint_square": {
        "name": "waypoint_path",
        "params": {"waypoints": [(3, 3), (-3, 3), (-3, -3), (3, -3)], "segment_time": 6.0},
    },
    "diamond_waypoints": {
        "name": "waypoint_path",
        "params": {"waypoints": [(0, 3), (3, 0), (0, -3), (-3, 0)], "segment_time": 7.0},
    },
    "hover_test": {"name": "hover", "params": {"position": (0.0, 0.0, -2.0)}},
    "sine_wave_x": {
        "name": "sine_wave",
        "params": {"amplitude": 2.5, "frequency": 0.08, "axis": "x"},
    },
    "oval_race": {"name": "oval", "params": {"a": 3.5, "b": 2.0, "period": 22.0}},
    "clover_pattern": {"name": "cloverleaf", "params": {"scale": 2.8, "period": 35.0}},
}


def get_trajectory_function(config_name: str = "slow_figure8") -> Callable[[Array], Traj]:
    """Factory mirroring ``trajectory_definitions.py:548-570``; returns a
    jit/vmap-safe ``t -> (pos, vel, acc)`` closure."""
    if config_name not in TRAJECTORY_CONFIGS:
        raise ValueError(
            f"Unknown trajectory config: {config_name}. "
            f"Available: {list(TRAJECTORY_CONFIGS)}"
        )
    cfg = TRAJECTORY_CONFIGS[config_name]
    fn = _FAMILIES[cfg["name"]]
    return functools.partial(fn, **cfg["params"])
