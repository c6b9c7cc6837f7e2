"""Thin netCDF grid-reading adapters (optional dependency: netCDF4): the
port's copy of shakti_tpu/data/netcdf.py.

The reference reads three Antarctic datasets directly in its setup module
(reference setups/setup_cooke2.py:39-62: BedMachine bed, ICESat-2 ATL14
surface, AQ1 geothermal flux).  These helpers reproduce those access
patterns as small functions returning plain (x, y, field) numpy arrays with
ascending-y orientation, keeping the heavy dependency optional and out of
the core framework (SURVEY §2b last row: data adapters live at the edge).
"""

from __future__ import annotations

import numpy as np


def read_grid(path: str, var: str, xvar: str = "x", yvar: str = "y",
              flip_y: str = "auto", expect_range=None, dataset: str = ""):
    """Read (x, y, f) from a netCDF file; ensures ascending x and y.

    Prefers the netCDF4 library; falls back to h5py (netCDF-4 files ARE
    HDF5 files, so BedMachine/ATL14/AQ1-format data stay readable in
    environments without netCDF4 — only netCDF-3 classic files need the
    real library).

    ``flip_y='auto'`` flips rows when the y axis is descending (BedMachine's
    convention — reference setup_cooke2.py:40-42 does np.flipud by hand).

    Contract checks (first contact with a real archive must fail loudly
    and fixably, not silently build a garbage model): axes 1-D and strictly
    monotonic, field 2-D with shape (len(y), len(x)) — a transposed field
    is auto-corrected when unambiguous — and, when ``expect_range`` is
    given, the finite values must overlap it.
    """
    x, y, f = _read_vars(path, var, xvar, yvar)
    tag = f"{dataset or var} ({path})"
    if x.ndim != 1 or y.ndim != 1 or x.size < 2 or y.size < 2:
        raise ValueError(
            f"{tag}: coordinate variables '{xvar}'/'{yvar}' must be 1-D "
            f"axes with >= 2 points (got shapes {x.shape}/{y.shape}); "
            "pass the correct xvar/yvar names for this product")
    if f.ndim != 2:
        raise ValueError(
            f"{tag}: variable '{var}' must be a 2-D grid (got shape "
            f"{f.shape}); for products with a leading time/band axis, "
            "select the slice before interpolation")
    if f.shape == (x.size, y.size) and x.size != y.size:
        f = f.T        # stored (x, y): unambiguous transpose, fix silently
    if f.shape != (y.size, x.size):
        raise ValueError(
            f"{tag}: grid shape {f.shape} does not match axes "
            f"(len(y), len(x)) = ({y.size}, {x.size}); check that "
            f"'{xvar}'/'{yvar}' are the axes of '{var}'")
    dx, dy = np.diff(x), np.diff(y)
    if not ((dx > 0).all() or (dx < 0).all()) \
            or not ((dy > 0).all() or (dy < 0).all()):
        raise ValueError(
            f"{tag}: coordinate axes must be strictly monotonic "
            "(found non-monotonic values — is this a curvilinear grid?)")
    if x[1] < x[0]:
        x, f = x[::-1], f[:, ::-1]
    if flip_y == "auto" and y[1] < y[0]:
        y, f = y[::-1], np.flipud(f)
    if expect_range is not None:
        finite = f[np.isfinite(f)]
        lo, hi = expect_range
        if finite.size == 0:
            raise ValueError(f"{tag}: variable '{var}' has no finite values")
        med = float(np.median(finite))
        if not (lo <= med <= hi):
            raise ValueError(
                f"{tag}: median of '{var}' is {med:.4g}, outside the "
                f"plausible range [{lo:.4g}, {hi:.4g}] for this product — "
                "wrong variable, wrong units, or an unexpected file layout")
    return x, y, f


def _read_vars(path: str, var: str, xvar: str, yvar: str):
    try:
        from netCDF4 import Dataset  # optional dependency
    except ImportError:
        return _read_vars_h5(path, var, xvar, yvar)
    ds = Dataset(path)
    try:
        raw = ds[var][:]
        # masked cells -> NaN (matching the h5py fallback's semantics).
        # Convert to float BEFORE filling: filling NaN into a masked
        # integer-typed variable (e.g. BedMachine's int8 'mask') raises.
        f = (raw.astype(np.float64).filled(np.nan)
             if hasattr(raw, "filled")
             else np.asarray(raw, dtype=np.float64))
        x = np.asarray(ds[xvar][:]).astype(np.float64)
        y = np.asarray(ds[yvar][:]).astype(np.float64)
    finally:
        ds.close()
    return x, y, f


def _read_vars_h5(path: str, var: str, xvar: str, yvar: str):
    """netCDF-4 (= HDF5) fallback reader.

    Applies CF packing the way netCDF4's auto-maskandscale would:
    raw * scale_factor + add_offset, with _FillValue/missing_value cells
    set to NaN BEFORE unpacking (Antarctic gridded products commonly store
    packed int16 — returning raw packed integers would silently build a
    garbage model)."""
    import h5py  # optional dependency

    def unpack(ds):
        raw = np.asarray(ds[()], dtype=np.float64)
        fill = ds.attrs.get("_FillValue", ds.attrs.get("missing_value"))
        if fill is not None:
            raw = np.where(raw == np.float64(np.ravel(fill)[0]), np.nan, raw)
        scale = ds.attrs.get("scale_factor")
        offset = ds.attrs.get("add_offset")
        if scale is not None:
            raw = raw * np.float64(np.ravel(scale)[0])
        if offset is not None:
            raw = raw + np.float64(np.ravel(offset)[0])
        return raw

    with h5py.File(path, "r") as h5:
        f = unpack(h5[var])
        x = unpack(h5[xvar]).reshape(-1)
        y = unpack(h5[yvar]).reshape(-1)
    return x, y, f


def read_bedmachine(path: str):
    """BedMachine Antarctica bed elevation (reference setup_cooke2.py:39-44).

    Expected product: MEaSUREs BedMachine Antarctica v2/v3
    (nsidc-0756, `BedMachineAntarctica*.nc`): variable ``bed`` [m, EPSG:3031
    polar-stereographic meters on axes ``x``/``y``, y descending].  The
    median Antarctic bed elevation is O(-100..500 m); a median outside
    [-3000, 3000] m indicates the wrong variable (e.g. the int8 ``mask``)
    or units."""
    return read_grid(path, "bed", expect_range=(-3000.0, 3000.0),
                     dataset="BedMachine bed")


def read_atl14(path: str):
    """ICESat-2 ATL14 surface height (reference setup_cooke2.py:48-53).

    Expected product: ATL14 Antarctic gridded land-ice height
    (`ATL14_*.nc`): variable ``h`` [m above WGS84 ellipsoid] on polar-
    stereographic ``x``/``y``.  Plausible median 0..4500 m."""
    return read_grid(path, "h", expect_range=(-200.0, 4500.0),
                     dataset="ATL14 surface")


def read_aq1(path: str):
    """AQ1 geothermal heat flux (reference setup_cooke2.py:57-62):
    'Q' on axes 'X'/'Y'.

    Expected product: AQ1 Antarctic geothermal heat flux (Stal et al.
    2021): variable ``Q`` on axes ``X``/``Y``.  The framework's G field is
    W/m^2 (typical Antarctic values 0.04-0.12); AQ1 distributions commonly
    store mW/m^2 (values ~40-120).  The reference loads Q without
    conversion, which is only consistent if its file stores W/m^2 — to be
    robust to either convention we detect the unit from the magnitude and
    rescale mW/m^2 -> W/m^2.  A median outside both plausible bands is
    rejected."""
    x, y, q = read_grid(path, "Q", xvar="X", yvar="Y", dataset="AQ1 GHF")
    finite = q[np.isfinite(q)]
    if finite.size == 0:
        raise ValueError(f"AQ1 GHF ({path}): no finite values in 'Q'")
    med = float(np.median(np.abs(finite)))
    if 1.0 < med <= 500.0:          # mW/m^2
        q = q * 1e-3
    elif not (1e-3 <= med <= 1.0):
        raise ValueError(
            f"AQ1 GHF ({path}): median |Q| = {med:.4g} matches neither "
            "W/m^2 (~0.04-0.12) nor mW/m^2 (~40-120) — wrong variable or "
            "units")
    return x, y, q
