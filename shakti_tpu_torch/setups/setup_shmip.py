"""SHMIP suites A-F on the port: the twin of setups/setup_shmip.py (same
cases, constants, arguments and arrays), built on shakti_tpu_torch's
ModelSetup.

SHMIP (de Fleurian et al. 2018, J. Glaciol., the Subglacial Hydrology Model
Intercomparison Project) run with the SHAKTI physics.  Suite A: the
land-terminating 'sqrt' ice-sheet margin on a 100 km x 20 km rectangle,
flat bed, surface

    z_s(x) = 6 (sqrt(x + 5000) - sqrt(5000)) + 1   [m]

with a steady uniform distributed water input over six decades (A1..A6);
the zero-water-pressure margin condition at x = 0 maps to the SHAKTI
outflow Dirichlet N = rho_i g H(0).  Suites B/C add moulins (C: diurnal),
D a seasonal degree-day input, E/F the valley glacier; the comments below
document each suite and its deviations."""

import os

import numpy as np

from shakti_tpu_torch.api.model import ModelSetup
from shakti_tpu_torch.mesh.generate import polygon_mesh, rectangle_mesh
from shakti_tpu_torch.params import DEFAULT_PARAMS as P

# SHMIP table 2: suite A steady distributed inputs [m/s]
CASES_A = {
    "A1": 7.93e-11,
    "A2": 1.59e-9,
    "A3": 5.79e-9,
    "A4": 2.5e-8,
    "A5": 4.5e-8,
    "A6": 5.79e-7,
}

# Suite B: surface melt delivered through moulins (de Fleurian et al. 2018
# table 2): n moulins with equal rates summing to the A5-equivalent total
# (4.5e-8 m/s x 100 km x 20 km = 90 m^3/s), on top of the A1 distributed
# basal-melt background.  SHMIP's published moulin coordinate files are not
# redistributable here, so positions are seeded-uniform over the interior
# (documented deviation; the intercomparison metrics used below — global
# conservation, many-moulins -> distributed-limit convergence — are
# position-robust).
CASES_B = {"B1": 1, "B2": 10, "B3": 20, "B4": 50, "B5": 100}
B_TOTAL_M3S = 4.5e-8 * 100e3 * 20e3          # = A5 total, 90 m^3/s

# Suite C: diurnal forcing of the B5 moulin input,
# inputs(t) = inputs * max(0, 1 + Ra sin(2 pi t / day)), with relative
# amplitudes Ra (de Fleurian et al. 2018 §3.1.3).
CASES_C = {"C1": 0.25, "C2": 0.5, "C3": 1.0, "C4": 2.0}
DAY_S = 86400.0

# Suite D: seasonally varying distributed input on the suite-A topography —
# A1 basal background + a degree-day runoff model with sea-level temperature
# T_0(t) = -16 cos(2 pi t/yr) - 5 + dT degC, lapse 0.0075 K/m, DDF
# 0.01 m/(K day), with temperature offsets dT (de Fleurian et al. 2018
# §3.1.4).  Implemented via the framework's degree_day forcing
# (solve/timestep.make_forcing carries the published constants as defaults).
CASES_D = {"D1": -4.0, "D2": -2.0, "D3": 0.0, "D4": 2.0, "D5": 4.0}

# Suite E: valley ('bench') glacier, 6 km long, steady distributed input,
# with the bed-topography parameter `para` deepening a mid-glacier trough
# (E1 = no overdeepening ... E5 = strongly overdeepened); the glacier
# FOOTPRINT is para-independent by construction (de Fleurian et al. 2018
# §3.2: surface and width fixed, only the bed varies).
CASES_E = {"E1": 0.05, "E2": 0.0, "E3": -0.1, "E4": -0.5, "E5": -0.7}
E_INPUT = 1.158e-6          # [m/s] suite-E steady distributed input
VALLEY_LEN = 6e3
PARA_BENCH = 0.05
VALLEY_B_CAP = 0.5          # [m] valley sheet-gap cap (see initialize)

# Suite F: the suite-D seasonal runoff model applied to the E1 valley
# geometry (same dT ladder), on the A1 basal background.
CASES_F = {"F1": -4.0, "F2": -2.0, "F3": 0.0, "F4": 2.0, "F5": 4.0}


def surface(x):
    return 6.0 * (np.sqrt(x + 5000.0) - np.sqrt(5000.0)) + 1.0


def valley_surface(x):
    """SHMIP valley-glacier surface: 1 m terminus at x=0 rising to ~610 m
    at the 6 km head (de Fleurian et al. 2018 §3.2)."""
    return (100.0 * (x + 200.0) ** 0.25 + x / 60.0 - (2e10) ** 0.25 + 1.0)


def _valley_f(x, para):
    s6 = valley_surface(VALLEY_LEN)
    return ((s6 - para * VALLEY_LEN) / VALLEY_LEN ** 2) * x ** 2 + para * x


def valley_bed(x, y, para):
    """SHMIP valley bed: center-line profile f(x, para) + cross-valley wall
    g(y) h(x, para); para < PARA_BENCH carves a mid-glacier overdeepening
    while the ice surface and outline stay fixed."""
    s = valley_surface(x)
    g = 0.5e-6 * np.abs(y) ** 3
    h = ((-4.5 * x / VALLEY_LEN + 5.0) * (s - _valley_f(x, para))
         / (s - _valley_f(x, PARA_BENCH) + 1e-12))
    return _valley_f(x, para) + g * h


def valley_half_width(x):
    """Glacier half-width where thickness -> 0: g(y) h = s - f, which is
    para-independent (the suite-E design)."""
    s = valley_surface(x)
    thick = np.maximum(s - _valley_f(x, PARA_BENCH), 0.0)
    shape = np.maximum(-4.5 * x / VALLEY_LEN + 5.0, 1e-12)
    return (thick / (0.5e-6 * shape)) ** (1.0 / 3.0)


def valley_outline(n: int = 80, x_head_frac: float = 0.985,
                   min_half_width: float = 40.0):
    """Closed outline polygon of the valley footprint.  The analytic width
    pinches to zero exactly at the head; the outline stops at
    ``x_head_frac`` of the length with a ``min_half_width`` floor so the
    mesh has no cusp (documented meshing regularization)."""
    x = np.linspace(0.0, x_head_frac * VALLEY_LEN, n)
    w = np.maximum(valley_half_width(x), min_half_width)
    top = np.column_stack([x, w])
    bot = np.column_stack([x[::-1], -w[::-1]])
    return np.vstack([top, bot])


def moulin_positions(n: int, lx: float, ly: float, seed: int = 7):
    """Seeded-uniform moulin coordinates over the interior (margin strip
    x < 10 km excluded: SHMIP moulins sit in the ablation zone, and a
    moulin on the Dirichlet margin would short-circuit the outflow BC)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1 * lx, 0.95 * lx, size=n)
    y = rng.uniform(0.05 * ly, 0.95 * ly, size=n)
    return np.column_stack([x, y])


def initialize(case: str = "A3", *, nx=100, ny=20, days=365.0, nt_per_day=4,
               results_name=None, seed=0, resolution=75.0):
    known = (set(CASES_A) | set(CASES_B) | set(CASES_C) | set(CASES_D)
             | set(CASES_E) | set(CASES_F))
    if case not in known:
        raise ValueError(f"unknown SHMIP case '{case}' (suites A-F)")
    valley = case in CASES_E or case in CASES_F
    if valley:
        # suite E/F: valley footprint mesh at ``resolution`` m
        nodes, cells = polygon_mesh(valley_outline(), resolution,
                                    jitter=0.2, seed=seed)
    else:
        lx, ly = 100e3, 20e3
        nodes, cells = rectangle_mesh(nx, ny, lx, ly)
    md = ModelSetup(nodes, cells)
    md.setup_name = f"setup_shmip_{case}"
    md.setup_file = os.path.abspath(__file__)
    md.results_name = results_name

    if valley:
        para = CASES_E[case] if case in CASES_E else PARA_BENCH
        md.z_b = valley_bed(md.x, md.y, para)
        md.z_s = np.maximum(valley_surface(md.x), md.z_b + 1.0)
        # Sheet-gap regularization for the valley: SHMIP prescribes p_w=0
        # at the ~1 m terminus, so N ~ 9 kPa there and creep closure is
        # negligible against dissipation opening — the melt-opening sheet
        # grows without bound (measured: capped only at the ice column,
        # the gap reaches 45-210 m and every E4/E5/F run diverges in the
        # year-2 winter reorganization; see SHMIP.md).  The sheet
        # approximation is meaningless at such gaps: cap at
        # min(ice column, VALLEY_B_CAP) — with it, every E and F case
        # integrates stably through multi-year seasonal cycles.
        H = np.maximum(md.z_s - md.z_b, 0.0)
        md.b_cap = np.maximum(np.minimum(H, VALLEY_B_CAP), 1e-3)
    else:
        md.z_b = np.zeros(md.x.size)
        md.z_s = surface(md.x)
    md.G = np.full(md.x.size, 0.05)
    if case in CASES_A:
        md.inputs = np.full(md.x.size, CASES_A[case])
    elif case in CASES_E:
        md.inputs = np.full(md.x.size, E_INPUT)
    elif case in CASES_D or case in CASES_F:
        # seasonal degree-day runoff (published constants, see make_forcing)
        # on the A1 basal background
        md.inputs = np.full(md.x.size, CASES_A["A1"])
        dT = CASES_D[case] if case in CASES_D else CASES_F[case]
        md.degree_day = {"dT": dT}
    else:
        # suites B/C: A1 distributed background + equal-rate moulins
        # (md.add_moulin lumps each discharge onto the nearest node)
        n_moulin = CASES_B[case] if case in CASES_B else CASES_B["B5"]
        md.inputs = np.full(md.x.size, CASES_A["A1"])
        for xy in moulin_positions(n_moulin, lx, ly):
            md.add_moulin(xy, B_TOTAL_M3S / n_moulin)
        if case in CASES_C:
            md.seasonal_inputs = (CASES_C[case], DAY_S, 0.0)
    md.storage_on = False

    # margin at x = 0: zero water pressure -> N = overburden of the ~1 m
    # terminus (SHMIP boundary condition mapped to SHAKTI variables)
    z_s0 = valley_surface(0.0) if valley else surface(0.0)
    md.N_bdry = P.rho_i * P.g * (z_s0 - 0.0)
    md.OutflowBoundary = lambda p: p[:, 0] < (resolution * 0.25 if valley
                                              else 1e-6)
    md.outflow_on = True

    rng = np.random.default_rng(seed)
    md.b_init = 0.01 + rng.normal(scale=1e-3, size=md.x.size)
    md.N_init = np.full(md.x.size, 1e5)

    t_final = (days / 365.0) * 3.154e7
    md.timesteps = np.linspace(0.0, t_final, int(days * nt_per_day))
    md.nt_save = nt_per_day
    md.nt_check = 50 * md.nt_save
    return md
