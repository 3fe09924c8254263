"""Visualization: trajectory, map and ESDF rendering.

The port's copy of neoplanner_tpu/utils/viz.py (numpy and matplotlib; the
reference's RViz layer: the marker builders of visualizer.py:12-89, the
ESDF heatmap node esdf_vis_node.py:19-50 and the flown-path publisher):
matplotlib figures and ASCII renders that work headless. Arrays are numpy;
pass tensors through ``.cpu().numpy()``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def ascii_map(occupancy: np.ndarray, paths: Sequence[np.ndarray] = (),
              origin=(0.0, 0.0), resolution: float = 0.1,
              markers: Sequence[tuple] = (), col_step: int = 4,
              row_step: int = 8) -> str:
    """Render an occupancy grid + paths as text ('#' obstacle, 'o' path)."""
    occ = np.asarray(occupancy)
    h, w = occ.shape
    grid = [[("#" if occ[r, c] else ".") for c in range(0, w, col_step)]
            for r in range(0, h, row_step)]

    def put(x, y, ch):
        c = int((x - origin[0]) / resolution) // col_step
        r = int((y - origin[1]) / resolution) // row_step
        if 0 <= r < len(grid) and 0 <= c < len(grid[0]):
            grid[r][c] = ch

    for path in paths:
        for p in np.asarray(path):
            put(p[0], p[1], "o")
    for x, y, ch in markers:
        put(x, y, ch)
    return "\n".join("".join(row) for row in grid)


def plot_mission(occupancy: np.ndarray, origin, resolution: float,
                 flown_path: Optional[np.ndarray] = None,
                 planned_path: Optional[np.ndarray] = None,
                 planned_vel: Optional[np.ndarray] = None,
                 wpts: Optional[np.ndarray] = None,
                 goal: Optional[np.ndarray] = None,
                 esdf: Optional[np.ndarray] = None,
                 save_path: Optional[str] = None):
    """Matplotlib mission figure: occupancy (+ optional ESDF heatmap), the
    velocity-colored planned path (visualizer.py:27-44 uses the jet colormap;
    same here), waypoint markers, the flown path, and the goal."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    occ = np.asarray(occupancy)
    h, w = occ.shape
    extent = (origin[0], origin[0] + w * resolution,
              origin[1], origin[1] + h * resolution)

    fig, ax = plt.subplots(figsize=(10, 6))
    if esdf is not None:
        ax.imshow(np.asarray(esdf), origin="lower", extent=extent,
                  cmap="Blues_r", alpha=0.6)
    ax.imshow(np.ma.masked_where(occ == 0, occ), origin="lower", extent=extent,
              cmap="gray_r", vmin=0, vmax=1.2, interpolation="nearest")

    if planned_path is not None:
        pp_arr = np.asarray(planned_path)
        if planned_vel is not None:
            sc = ax.scatter(pp_arr[:, 0], pp_arr[:, 1],
                            c=np.asarray(planned_vel), cmap="jet", s=6,
                            label="planned (|v|)")
            fig.colorbar(sc, ax=ax, label="speed [m/s]")
        else:
            ax.plot(pp_arr[:, 0], pp_arr[:, 1], "c-", label="planned")
    if flown_path is not None:
        fp = np.asarray(flown_path)
        ax.plot(fp[:, 0], fp[:, 1], "m-", lw=2, label="flown")
    if wpts is not None:
        wp = np.asarray(wpts)
        ax.plot(wp[0], wp[1], "go", ms=10, mfc="none", label="waypoints")
    if goal is not None:
        g = np.asarray(goal)
        ax.plot(g[0], g[1], "r*", ms=16, label="goal")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def esdf_heatmap(esdf: np.ndarray, origin, resolution: float,
                 save_path: Optional[str] = None):
    """ESDF heatmap figure (esdf_vis_node.py:19-50 republished this as an
    OccupancyGrid scaled 0-100; here it is just a figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.asarray(esdf)
    h, w = d.shape
    extent = (origin[0], origin[0] + w * resolution,
              origin[1], origin[1] + h * resolution)
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(np.clip(d, 0, np.percentile(d, 99)), origin="lower",
                   extent=extent, cmap="viridis")
    fig.colorbar(im, ax=ax, label="distance [m]")
    ax.set_aspect("equal")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig
