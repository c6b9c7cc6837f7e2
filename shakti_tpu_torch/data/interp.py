"""Gridded-dataset -> mesh-node interpolation (host-side numpy).

The port's copy of the numpy path of shakti_tpu/data/interp.py: bilinear
interpolation on a rectilinear grid, clamped to the grid hull (the
reference subsets with a generous buffer so the mesh never leaves the
data, model_setup.py:34-37,93-106).
"""

from __future__ import annotations

import numpy as np


class GridInterpolator:
    """Bilinear interpolator on a rectilinear (x, y) grid.

    f has shape (ny, nx) with f[j, i] the value at (x[i], y[j]).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, f: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        f = np.asarray(f, dtype=np.float64)
        if f.shape != (y.size, x.size):
            raise ValueError(f"f shape {f.shape} != (ny={y.size}, nx={x.size})")
        # normalize to ascending axes
        if x.size >= 2 and x[1] < x[0]:
            x, f = x[::-1], f[:, ::-1]
        if y.size >= 2 and y[1] < y[0]:
            y, f = y[::-1], f[::-1, :]
        self.x, self.y, self.f = x, y, f

    def __call__(self, px, py):
        px = np.clip(np.asarray(px, dtype=np.float64), self.x[0], self.x[-1])
        py = np.clip(np.asarray(py, dtype=np.float64), self.y[0], self.y[-1])
        i = np.clip(np.searchsorted(self.x, px) - 1, 0, self.x.size - 2)
        j = np.clip(np.searchsorted(self.y, py) - 1, 0, self.y.size - 2)
        x0, x1 = self.x[i], self.x[i + 1]
        y0, y1 = self.y[j], self.y[j + 1]
        tx = np.where(x1 > x0, (px - x0) / np.where(x1 == x0, 1.0, x1 - x0), 0.0)
        ty = np.where(y1 > y0, (py - y0) / np.where(y1 == y0, 1.0, y1 - y0), 0.0)
        f00 = self.f[j, i]
        f10 = self.f[j, i + 1]
        f01 = self.f[j + 1, i]
        f11 = self.f[j + 1, i + 1]
        return ((1 - tx) * (1 - ty) * f00 + tx * (1 - ty) * f10
                + (1 - tx) * ty * f01 + tx * ty * f11)


def subset_grid(x, y, f, bounds):
    """Crop (x, y, f) to [xmin, xmax, ymin, ymax] like the reference's
    interp_data subsetting (model_setup.py:76-81)."""
    xmin, xmax, ymin, ymax = bounds
    xi = (x >= xmin) & (x <= xmax)
    yi = (y >= ymin) & (y <= ymax)
    return x[xi], y[yi], f[np.ix_(yi, xi)]
