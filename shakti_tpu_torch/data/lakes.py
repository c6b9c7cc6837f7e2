"""Subglacial lake inventory adapter: the port's copy of
shakti_tpu/data/lakes.py.

Framework-native replacement for the reference's `load_lakes.py` (which
loads the Siegfried & Fricker 2018 HDF5 outlines into a geopandas frame at
import time from a hard-coded absolute path — reference load_lakes.py:19).
Differences by design:

  * plain-numpy data model: an inventory is a dict
    ``{name: {"outline": (k, 2) float array [km, NaN rows delimit
    multi-polygons], "area_km2": float, "cite": str}}`` — the core framework
    consumes arrays, not GeoDataFrames (SURVEY §2b last row);
  * loading is lazy and path-parameterized (no import-time IO);
  * heavy geo deps (h5py, pyproj) are optional: HDF5 loading requires h5py;
    areas fall back to planar polygon area when pyproj is unavailable
    (good to ~1% at Antarctic latitudes in polar stereographic).
"""

from __future__ import annotations

import os

import numpy as np


def _planar_area_km2(outline_km: np.ndarray) -> float:
    """Shoelace area over NaN-delimited rings (km^2, planar approximation)."""
    total = 0.0
    rings = np.split(outline_km,
                     np.where(np.isnan(outline_km[:, 0]))[0]) if \
        np.isnan(outline_km[:, 0]).any() else [outline_km]
    for ring in rings:
        ring = ring[~np.isnan(ring[:, 0])]
        if ring.shape[0] < 3:
            continue
        x, y = ring[:, 0], ring[:, 1]
        total += 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return float(total)


def load_inventory_hdf5(path: str, geodesic_areas: bool = False) -> dict:
    """Load a Siegfried & Fricker 2018-format outline HDF5 into an inventory
    dict (reference load_lakes.py:35-75 re-provided without geopandas).

    Outlines keep the file's km units; multi-polygon lakes keep their
    NaN-row delimiters (handled downstream by
    shakti_tpu_torch.mesh.geometry.points_in_polygon).
    """
    import h5py  # optional dependency, only needed for real data

    inv = {}
    with h5py.File(path, "r") as h5f:
        for lake in h5f.keys():
            x = h5f[lake]["x"][:] / 1e3
            y = h5f[lake]["y"][:] / 1e3
            outline = np.stack((x, y), axis=2).reshape(x.shape[1], 2)
            cite = h5f[lake].attrs.get("citation")
            cite = cite[0].decode("UTF-8") if cite is not None else ""
            area = _planar_area_km2(outline)
            if geodesic_areas:
                try:
                    area = _geodesic_area_km2(outline, h5f.attrs.get("proj_crs"))
                except Exception:
                    pass
            inv[lake] = {"outline": outline, "area_km2": area, "cite": cite}
    return inv


def _geodesic_area_km2(outline_km: np.ndarray, crs_xy) -> float:
    """Geodesic area via pyproj (the reference's method, load_lakes.py:29-32)."""
    from pyproj import CRS, Transformer

    crs_ll = "EPSG:4326"
    xy_to_ll = Transformer.from_crs(crs_xy, crs_ll, always_xy=True)
    geod = CRS(crs_ll).get_geod()
    total = 0.0
    rings = np.split(outline_km, np.where(np.isnan(outline_km[:, 0]))[0]) if \
        np.isnan(outline_km[:, 0]).any() else [outline_km]
    for ring in rings:
        ring = ring[~np.isnan(ring[:, 0])]
        if ring.shape[0] < 3:
            continue
        lon, lat = xy_to_ll.transform(ring[:, 0] * 1e3, ring[:, 1] * 1e3)
        total += abs(geod.polygon_area_perimeter(lon, lat)[0]) / 1e6
    return float(total)


def load_inventory_npz(path: str) -> dict:
    """Load an inventory from a portable .npz (arrays ``<name>__outline``
    plus optional ``<name>__area``): the dependency-free interchange format
    used by tests and synthetic setups."""
    z = np.load(path, allow_pickle=False)
    inv = {}
    for key in z.files:
        if key.endswith("__outline"):
            name = key[: -len("__outline")]
            outline = z[key]
            area = float(z[name + "__area"]) if name + "__area" in z.files \
                else 0.0
            if area == 0.0:
                area = _planar_area_km2(outline)
            inv[name] = {"outline": outline, "area_km2": area, "cite": ""}
    return inv


def save_inventory_npz(path: str, inv: dict):
    arrays = {}
    for name, rec in inv.items():
        arrays[name + "__outline"] = np.asarray(rec["outline"], dtype=np.float64)
        arrays[name + "__area"] = np.float64(rec.get("area_km2", 0.0))
    np.savez(path, **arrays)


def load_inventory(path: str | None = None) -> dict:
    """Dispatch on extension; path defaults to $SHAKTI_LAKE_INVENTORY."""
    path = path or os.environ.get("SHAKTI_LAKE_INVENTORY")
    if not path:
        raise FileNotFoundError(
            "no lake inventory: pass a path or set SHAKTI_LAKE_INVENTORY")
    if path.endswith((".h5", ".hdf5")):
        return load_inventory_hdf5(path)
    if path.endswith(".npz"):
        return load_inventory_npz(path)
    raise ValueError(f"unknown inventory format: {path}")


def outline_m(inv: dict, name: str) -> np.ndarray:
    """Lake outline scaled km -> m (the reference's
    `.scale(xfact=1e3, yfact=1e3)`, setup_cooke2.py:35)."""
    return np.asarray(inv[name]["outline"], dtype=np.float64) * 1e3
