"""Minimal GeoTIFF reader/writer (optional-dep gated, like data/netcdf.py):
the port's copy of shakti_tpu/data/geotiff.py.

The reference's mesh pipeline round-trips the normalized background
potential through a uint8 GeoTIFF (reference notebooks/create_mesh.ipynb
cells 8-10: rasterio `from_bounds` transform + EPSG:3031, read back by
topotoolbox's `read_tif` in cell 11).  rasterio/GDAL is not a framework
dependency; this module reads and writes the single-band GeoTIFFs that
workflow needs through PIL (baked in), decoding the two GeoTIFF tags that
carry georeferencing:

  * 33550 ModelPixelScaleTag  (sx, sy, sz)
  * 33922 ModelTiepointTag    (i, j, k, x, y, z): raster (i, j) -> model
    (x, y); with the pixel scale this is the affine `from_bounds`
    transform for axis-aligned rasters (the only kind the workflow uses —
    a rotated ModelTransformationTag raises).
  * 34735 GeoKeyDirectoryTag  -> EPSG code (ProjectedCSTypeGeoKey 3072 or
    GeographicTypeGeoKey 2048), informational.

Returned coordinates are pixel-CENTER x/y axes, matching what
`mesh/basin.basin_mesh` and `data/interp.GridInterpolator` consume.
"""

from __future__ import annotations

import numpy as np

_SCALE, _TIEPOINT, _TRANSFORM, _GEOKEYS = 33550, 33922, 34264, 34735


def _require_pil():
    try:
        from PIL import Image
        from PIL.TiffImagePlugin import ImageFileDirectory_v2
    except ImportError as e:  # pragma: no cover - PIL is baked in here
        raise ImportError(
            "GeoTIFF support needs Pillow (PIL); install it or pass arrays "
            "directly to mesh/basin.basin_mesh") from e
    return Image, ImageFileDirectory_v2


def read_geotiff(path: str):
    """Read a single-band GeoTIFF.

    Returns ``(x, y, data, meta)``: pixel-center coordinate axes
    (x ascending as stored; y per row order, typically descending for
    north-up rasters), the (ny, nx) array, and ``meta`` with ``epsg``
    (int or None), ``pixel_scale`` (dx, dy) and ``origin`` (x0, y0 of the
    raster's outer corner).
    """
    Image, _ = _require_pil()
    with Image.open(path) as img:
        n_frames = getattr(img, "n_frames", 1)
        if n_frames != 1:
            raise ValueError(f"{path}: expected a single-band GeoTIFF, "
                             f"got {n_frames} frames")
        tags = dict(img.tag_v2) if hasattr(img, "tag_v2") else {}
        data = np.asarray(img)
    if data.ndim != 2:
        raise ValueError(f"{path}: expected one band, got shape "
                         f"{data.shape}")
    if _TRANSFORM in tags:
        m = np.asarray(tags[_TRANSFORM], dtype=np.float64)
        if m.size == 16 and (m[1] != 0.0 or m[4] != 0.0):
            raise ValueError(f"{path}: rotated ModelTransformationTag not "
                             "supported (axis-aligned rasters only)")
        dx, dy = m[0], -m[5]
        x0, y0 = m[3], m[7]
    elif _SCALE in tags and _TIEPOINT in tags:
        sx, sy = (float(v) for v in tags[_SCALE][:2])
        tp = np.asarray(tags[_TIEPOINT], dtype=np.float64)
        i, j, _, X, Y, _ = tp[:6]
        dx, dy = sx, sy
        x0, y0 = X - i * dx, Y + j * dy
    else:
        raise ValueError(f"{path}: no GeoTIFF georeferencing tags "
                         "(ModelPixelScale+ModelTiepoint or "
                         "ModelTransformation)")
    ny, nx = data.shape
    # pixel-center axes; GeoTIFF y decreases down rows (north-up)
    x = x0 + dx * (np.arange(nx) + 0.5)
    y = y0 - dy * (np.arange(ny) + 0.5)
    epsg = None
    if _GEOKEYS in tags:
        keys = np.asarray(tags[_GEOKEYS], dtype=np.int64).reshape(-1, 4)
        for kid, loc, cnt, val in keys[1:]:
            if kid in (3072, 2048) and loc == 0:
                epsg = int(val)
    return x, y, data, {"epsg": epsg, "pixel_scale": (dx, dy),
                        "origin": (x0, y0)}


def write_geotiff(path: str, data: np.ndarray, west: float, north: float,
                  dx: float, dy: float, epsg: int | None = 3031):
    """Write a single-band GeoTIFF (uncompressed, strip TIFF via PIL).

    ``west``/``north`` are the raster's outer top-left corner, ``dx``/
    ``dy`` positive pixel sizes — the same convention as rasterio's
    ``from_bounds(west, south, east, north, w, h)`` transform the
    reference builds (create_mesh.ipynb cell 9).  uint8/uint16/int32/
    float32/float64 single-band data supported (the reference writes
    uint8, cell 8).
    """
    Image, IFD = _require_pil()
    data = np.ascontiguousarray(data)
    img = Image.fromarray(data)
    ifd = IFD()
    from PIL.TiffImagePlugin import TiffTags
    ifd.tagtype[_SCALE] = TiffTags.DOUBLE
    ifd[_SCALE] = (float(dx), float(dy), 0.0)
    ifd.tagtype[_TIEPOINT] = TiffTags.DOUBLE
    ifd[_TIEPOINT] = (0.0, 0.0, 0.0, float(west), float(north), 0.0)
    if epsg is not None:
        ifd.tagtype[_GEOKEYS] = TiffTags.SHORT
        # header (version 1.1.0, 2 keys) + ModelType=Projected(1) + EPSG
        ifd[_GEOKEYS] = (1, 1, 0, 2,
                         1024, 0, 1, 1,
                         3072, 0, 1, int(epsg))
    img.save(path, format="TIFF", tiffinfo=ifd)


def quantize_potential(potential: np.ndarray) -> np.ndarray:
    """uint8-normalize a potential grid exactly as the reference does
    before its GeoTIFF round-trip (create_mesh.ipynb cell 8):
    (p - min) / (max - min) * 255, truncated to uint8."""
    p = np.asarray(potential, dtype=np.float64)
    rng = p.max() - p.min()
    if rng == 0.0:
        return np.zeros(p.shape, np.uint8)
    return ((p - p.min()) / rng * 255).astype(np.uint8)
