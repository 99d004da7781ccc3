"""Streaming/animated flight visualization.

The live-visualization role of the reference
(``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/results_visualizer.py:17-30``
— a matplotlib window redrawn per control step while the sim runs — and the
animated demo window of ``demo_system.py``). This rebuild runs whole
flights as one fused ``lax.scan``, so there is no per-tick Python hook to
draw from; the streaming counterpart is an ANIMATED REPLAY of the rollout's
stacked outputs: the same panels the reference draws live (3D-ish trajectory
trace, position vs reference, error, thrust), advancing tick by tick.

Headless-safe: ``animate_flight`` renders to a GIF (Pillow writer, no
ffmpeg dependency) or MP4 (when ffmpeg exists); ``fly --animate out.gif``
is the CLI surface. For an attached display, ``show=True`` plays the
animation in a window instead (the reference's live-window experience).
"""

from __future__ import annotations

import numpy as np


def animate_flight(
    log: dict,
    save_path: str | None = None,
    dt: float = 0.02,
    fps: int = 25,
    stride: int = 8,
    trail: int = 400,
    title: str = "flight",
    show: bool = False,
) -> str | None:
    """Animated replay of a rollout.

    ``log`` needs ``state (T, >=6)`` and ``pos_ref (T, 3)`` (any rollout /
    flight-log dict works); ``thrust (T,)`` populates the thrust panel when
    present. ``stride`` = sim ticks per frame (default 8 -> 6.25x real time
    at 50 Hz); ``trail`` = ticks of trajectory tail drawn behind the
    vehicle. Returns the save path (or None when only shown).
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    state = np.asarray(log["state"], np.float64)
    pos_ref = np.asarray(log["pos_ref"], np.float64)
    T = state.shape[0]
    if T < 2:
        raise ValueError(f"need at least 2 ticks to animate, got {T}")
    stride = min(max(1, int(stride)), T - 1)   # always >= 1 frame
    t = np.arange(T) * dt
    pos = state[:, 0:3]
    err = np.linalg.norm(pos - pos_ref, axis=1)
    thrust = np.asarray(log["thrust"], np.float64) if "thrust" in log else None

    frames = range(1, T, stride)

    fig = plt.figure(figsize=(13, 8))
    fig.suptitle(f"Flight replay — {title}")
    ax_xy = fig.add_subplot(2, 2, 1)
    ax_z = fig.add_subplot(2, 2, 2)
    ax_e = fig.add_subplot(2, 2, 3)
    ax_u = fig.add_subplot(2, 2, 4)

    pad = 0.5
    ax_xy.set_xlim(min(pos[:, 0].min(), pos_ref[:, 0].min()) - pad,
                   max(pos[:, 0].max(), pos_ref[:, 0].max()) + pad)
    ax_xy.set_ylim(min(pos[:, 1].min(), pos_ref[:, 1].min()) - pad,
                   max(pos[:, 1].max(), pos_ref[:, 1].max()) + pad)
    ax_xy.set_xlabel("x [m]"); ax_xy.set_ylabel("y [m]")
    ax_xy.set_title("XY trajectory")
    ax_xy.plot(pos_ref[:, 0], pos_ref[:, 1], "b--", lw=0.8, label="reference")
    (ln_trail,) = ax_xy.plot([], [], "r-", lw=1.5, label="actual")
    (pt_vehicle,) = ax_xy.plot([], [], "ko", ms=6)
    ax_xy.legend(loc="upper right", fontsize=8)

    ax_z.set_xlim(0, t[-1]); ax_z.set_xlabel("t [s]"); ax_z.set_ylabel("z [m]")
    ax_z.set_title("Altitude")
    ax_z.plot(t, pos_ref[:, 2], "b--", lw=0.8)
    (ln_z,) = ax_z.plot([], [], "r-", lw=1.2)
    zmin = min(pos[:, 2].min(), pos_ref[:, 2].min()) - pad
    zmax = max(pos[:, 2].max(), pos_ref[:, 2].max()) + pad
    ax_z.set_ylim(zmin, zmax)

    ax_e.set_xlim(0, t[-1]); ax_e.set_ylim(0, max(err.max() * 1.1, 1e-3))
    ax_e.set_xlabel("t [s]"); ax_e.set_ylabel("|pos err| [m]")
    ax_e.set_title("Position error")
    (ln_e,) = ax_e.plot([], [], "m-", lw=1.2)
    txt = ax_e.text(0.02, 0.92, "", transform=ax_e.transAxes, fontsize=9)

    if thrust is not None:
        ax_u.set_xlim(0, t[-1]); ax_u.set_ylim(0, 1.25)
        ax_u.set_xlabel("t [s]"); ax_u.set_ylabel("thrust [norm]")
        ax_u.set_title("Thrust (saturation bands at 0.11 / 0.99)")
        ax_u.axhline(0.99, color="r", ls=":", lw=0.8)
        ax_u.axhline(0.11, color="r", ls=":", lw=0.8)
        (ln_u,) = ax_u.plot([], [], "g-", lw=1.0)
    else:
        ax_u.axis("off")
        ln_u = None

    def update(k):
        lo = max(0, k - trail)
        ln_trail.set_data(pos[lo:k, 0], pos[lo:k, 1])
        pt_vehicle.set_data([pos[k - 1, 0]], [pos[k - 1, 1]])
        ln_z.set_data(t[:k], pos[:k, 2])
        ln_e.set_data(t[:k], err[:k])
        txt.set_text(f"t = {t[k - 1]:5.1f} s   err = {err[k - 1]:.3f} m")
        arts = [ln_trail, pt_vehicle, ln_z, ln_e, txt]
        if ln_u is not None:
            ln_u.set_data(t[:k], thrust[:k])
            arts.append(ln_u)
        return arts

    anim = manim.FuncAnimation(fig, update, frames=frames, blit=True,
                               interval=1000 / fps)
    if show:
        plt.show()
        plt.close(fig)
        return None
    if save_path is None:
        raise ValueError("save_path required when show=False")
    if save_path.endswith(".mp4"):
        try:
            writer = manim.FFMpegWriter(fps=fps)
            anim.save(save_path, writer=writer)
        except (FileNotFoundError, RuntimeError):
            # no ffmpeg in the image -> fall back to GIF alongside
            save_path = save_path[:-4] + ".gif"
            anim.save(save_path, writer=manim.PillowWriter(fps=fps))
    else:
        anim.save(save_path, writer=manim.PillowWriter(fps=fps))
    plt.close(fig)
    return save_path
