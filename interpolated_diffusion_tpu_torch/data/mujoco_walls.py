"""Wall polygons from MuJoCo geom arrays (own copy of the JAX package's
data/mujoco_walls.py; numpy only, vectorised).

The geometry runs on stacked [N, ...] geom arrays in one shot and the entry
point takes plain numpy arrays, so wall polygons come from any MuJoCo model
the moment a MuJoCo stack can read it (neither machine this port runs on has
one); `walls_from_env` pulls the arrays from a live mujoco / mujoco_py model.

Semantics:
- candidates are box geoms whose name contains a wall-ish keyword (wall /
  block / maze / obstacle) and no floor-ish one; if none match, every box
  geom that is not floor-named;
- each wall is its box's 4 bottom corners rotated by the geom quaternion and
  translated to world, projected to the xy plane ([4, 2] polygon);
- floor rejection: boxes thinner than 5 % of the tallest candidate go, and
  boxes with a footprint over 6x the median (ground planes).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

GEOM_BOX = 6  # mjtGeom.mjGEOM_BOX

_WALL_WORDS = ("wall", "block", "maze", "obstacle")
_FLOOR_WORDS = ("floor", "ground", "plane", "base")


def quats_to_rotmats(q: np.ndarray) -> np.ndarray:
    """Batched unit-quaternion [N, 4] (w,x,y,z) -> rotation matrices [N, 3, 3]."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def walls_from_geom_arrays(
    geom_type: np.ndarray,        # [N] int
    geom_size: np.ndarray,        # [N, >=3] half-extents
    geom_pos: np.ndarray,         # [N, 3]
    geom_quat: np.ndarray,        # [N, 4] (w, x, y, z)
    names: Optional[Sequence[Optional[str]]] = None,
    thin_frac: float = 0.05,
    area_factor: float = 6.0,
) -> Optional[List[np.ndarray]]:
    """Extract wall footprint polygons ([4, 2] xy, one per wall) or None."""
    geom_type = np.asarray(geom_type).astype(np.int64).reshape(-1)
    n = geom_type.shape[0]
    if n == 0:
        return None
    geom_size = np.asarray(geom_size, np.float32).reshape(n, -1)
    geom_pos = np.asarray(geom_pos, np.float32).reshape(n, -1)[:, :3]
    geom_quat = np.asarray(geom_quat, np.float32).reshape(n, -1)[:, :4]
    if geom_size.shape[1] < 3:
        return None

    lowered = ["" if names is None or i >= len(names) or names[i] is None
               else str(names[i]).lower() for i in range(n)]
    is_wall_name = np.array(
        [any(w in s for w in _WALL_WORDS) and not any(f in s for f in _FLOOR_WORDS)
         for s in lowered], dtype=bool)
    is_floor_name = np.array([any(f in s for f in _FLOOR_WORDS) for s in lowered],
                             dtype=bool)
    is_box = geom_type == GEOM_BOX

    cand = is_wall_name & is_box
    if not cand.any():
        cand = is_box & ~is_floor_name
    cand &= (geom_size[:, 0] > 0) & (geom_size[:, 1] > 0)
    if not cand.any():
        return None

    idx = np.nonzero(cand)[0]
    sx, sy, sz = (geom_size[idx, i] for i in range(3))

    # bottom-face corners in geom frame, all geoms at once: [M, 4, 3]
    signs = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float32)
    corners = np.zeros((idx.size, 4, 3), np.float32)
    corners[:, :, 0] = sx[:, None] * signs[None, :, 0]
    corners[:, :, 1] = sy[:, None] * signs[None, :, 1]
    rot = quats_to_rotmats(geom_quat[idx])                     # [M, 3, 3]
    world = np.einsum("mij,mcj->mci", rot, corners) + geom_pos[idx][:, None]
    polys = world[:, :, :2]                                    # [M, 4, 2]

    keep = np.ones(idx.size, bool)
    if sz.max() > 0:
        thin = sz < thin_frac * sz.max()
        if not thin.all():
            keep &= ~thin
    areas = 4.0 * sx * sy
    med = float(np.median(areas[keep])) if keep.any() else 0.0
    if med > 0:
        big = areas > area_factor * med
        if (keep & ~big).any():
            keep &= ~big
    if not keep.any():
        return None
    return [polys[i] for i in np.nonzero(keep)[0]]


def walls_from_env(env) -> Optional[List[np.ndarray]]:
    """Pull geom arrays from a live gym/MuJoCo env and extract wall polygons.

    Requires a mujoco or mujoco_py stack (absent here); the array math above
    is the tested surface. Mirrors the reference's env/model attribute walk
    (dataset.py:106-124) without importing mujoco itself.
    """
    model = None
    for holder in (env, getattr(env, "unwrapped", None)):
        if holder is None:
            continue
        sim = getattr(holder, "sim", None)
        if sim is not None and getattr(sim, "model", None) is not None:
            model = sim.model
            break
        if getattr(holder, "model", None) is not None:
            model = holder.model
            break
    if model is None:
        return None
    req = ("geom_type", "geom_size", "geom_pos", "geom_quat")
    if any(getattr(model, a, None) is None for a in req):
        return None
    n = int(model.ngeom)
    names: List[Optional[str]] = []
    for i in range(n):
        name = None
        try:
            name = model.geom_names[i]
        except Exception:
            try:
                import mujoco

                name = mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_GEOM, i)
            except Exception:
                name = None
        names.append(name.decode() if isinstance(name, bytes) else name)
    return walls_from_geom_arrays(
        model.geom_type, model.geom_size, model.geom_pos, model.geom_quat, names
    )


def walls_to_boxes(walls: Sequence[np.ndarray]) -> np.ndarray:
    """Axis-aligned (x0, y0, x1, y1) bounding boxes [N, 4] for eval/visualize
    (eval/visualize.py draws walls as boxes)."""
    out = np.stack([
        np.concatenate([poly.min(axis=0), poly.max(axis=0)]) for poly in walls
    ]).astype(np.float32)
    return out
