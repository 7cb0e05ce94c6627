"""Maze / trajectory plots (port of eval/visualize.py; host-side matplotlib).

Occupancy imshow with trajectory / keypoint overlays, wall polygons and a
per-sample grid. Every function takes numpy arrays and writes a PNG (or
returns the figure). matplotlib (and PIL for the sampler's GIF) is imported
only when a plot is asked for: a machine without it raises an ImportError
that names the package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs the matplotlib package, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, out_path: Optional[str], dpi: int = 120):
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=dpi)
        plt.close(fig)
        return out_path
    return fig


def plot_occupancy_trajectories(
    occ: np.ndarray,                      # [H, W] or [1, H, W]
    trajectories: Sequence[np.ndarray],   # each [T, >=2] in [0,1] coords
    labels: Optional[Sequence[str]] = None,
    keypoints: Optional[np.ndarray] = None,   # [K, 2]
    start_goal: Optional[np.ndarray] = None,  # [4]
    out_path: Optional[str] = None,
    flip_y: bool = False,
    title: Optional[str] = None,
):
    plt = _pyplot()
    occ = np.asarray(occ)
    if occ.ndim == 3:
        occ = occ[0]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(occ, cmap="gray_r", origin="upper",
              extent=(0, 1, 1, 0) if not flip_y else (0, 1, 0, 1))
    colors = plt.cm.tab10.colors
    for i, traj in enumerate(trajectories):
        traj = np.asarray(traj)
        y = traj[:, 1] if not flip_y else 1.0 - traj[:, 1]
        label = labels[i] if labels and i < len(labels) else None
        ax.plot(traj[:, 0], y, "-", color=colors[i % 10], lw=1.5, label=label)
        ax.plot(traj[0, 0], y[0], "o", color=colors[i % 10], ms=5)
    if keypoints is not None:
        kp = np.asarray(keypoints)
        ky = kp[:, 1] if not flip_y else 1.0 - kp[:, 1]
        ax.plot(kp[:, 0], ky, "k^", ms=6, label="keypoints")
    if start_goal is not None:
        sg = np.asarray(start_goal)
        sy = sg[1] if not flip_y else 1.0 - sg[1]
        gy = sg[3] if not flip_y else 1.0 - sg[3]
        ax.plot(sg[0], sy, "g*", ms=14, label="start")
        ax.plot(sg[2], gy, "r*", ms=14, label="goal")
    if labels or keypoints is not None or start_goal is not None:
        ax.legend(loc="upper right", fontsize=7)
    if title:
        ax.set_title(title, fontsize=9)
    ax.set_xlim(0, 1)
    ax.set_ylim((1, 0) if not flip_y else (0, 1))
    return _finish(plt, fig, out_path)


def plot_wall_polygons(
    walls: Sequence[Tuple[float, float, float, float]],  # (x0, y0, x1, y1) boxes
    trajectories: Sequence[np.ndarray],
    labels: Optional[Sequence[str]] = None,
    bounds: Tuple[Tuple[float, float], Tuple[float, float]] = ((0, 1), (0, 1)),
    out_path: Optional[str] = None,
    title: Optional[str] = None,
):
    """World-coordinate wall boxes + trajectories."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    for (x0, y0, x1, y1) in walls:
        ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                   facecolor="0.3", edgecolor="none"))
    colors = plt.cm.tab10.colors
    for i, traj in enumerate(trajectories):
        traj = np.asarray(traj)
        label = labels[i] if labels and i < len(labels) else None
        ax.plot(traj[:, 0], traj[:, 1], "-", color=colors[i % 10], lw=1.5, label=label)
    if labels:
        ax.legend(loc="upper right", fontsize=7)
    ax.set_xlim(*bounds[0])
    ax.set_ylim(*bounds[1])
    ax.set_aspect("equal")
    if title:
        ax.set_title(title, fontsize=9)
    return _finish(plt, fig, out_path)


def save_sample_grid(occ_batch: np.ndarray, trajs_by_variant: dict, out_path: str,
                     start_goal: Optional[np.ndarray] = None, max_samples: int = 8):
    """Grid of per-sample panels, one column per variant."""
    plt = _pyplot()
    names = list(trajs_by_variant.keys())
    n = min(max_samples, occ_batch.shape[0])
    fig, axes = plt.subplots(n, len(names), figsize=(3 * len(names), 3 * n), squeeze=False)
    for r in range(n):
        occ = occ_batch[r]
        if occ.ndim == 3:
            occ = occ[0]
        for c, name in enumerate(names):
            ax = axes[r][c]
            ax.imshow(occ, cmap="gray_r", origin="upper", extent=(0, 1, 1, 0))
            traj = np.asarray(trajs_by_variant[name][r])
            ax.plot(traj[:, 0], traj[:, 1], "-", lw=1.2)
            if start_goal is not None:
                sg = start_goal[r]
                ax.plot(sg[0], sg[1], "g*", ms=10)
                ax.plot(sg[2], sg[3], "r*", ms=10)
            if r == 0:
                ax.set_title(name, fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
    return _finish(plt, fig, out_path, dpi=110)
