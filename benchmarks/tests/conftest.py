"""The benchmark's own tests: on the CPU at small sizes, and, marked
``card``, on the card.  Run from the repository root:

    python -m pytest benchmarks/tests -q            # the CPU ones; card skips
    python -m pytest benchmarks/tests -q -m card    # on a machine with a card
"""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips "
                            "without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.device("cuda")


def write_msh(path, nodes, cells):
    """An ASCII gmsh MSH 4.1 file of a triangle mesh, one block each."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n")
        n, c = len(nodes), len(cells)
        f.write(f"1 {n} 1 {n}\n2 1 0 {n}\n")
        f.writelines(f"{k + 1}\n" for k in range(n))
        f.writelines(f"{float(x)!r} {float(y)!r} 0\n" for x, y in nodes)
        f.write(f"$EndNodes\n$Elements\n1 {c} 1 {c}\n2 1 2 {c}\n")
        f.writelines(f"{k + 1} {a + 1} {b + 1} {d + 1}\n"
                     for k, (a, b, d) in enumerate(cells))
        f.write("$EndElements\n")


@pytest.fixture(scope="session")
def small_assets(tmp_path_factory):
    """The catchment that the port's setups/setup_cooke2 builds without a
    mesh directory (a jittered 50 x 50 square mesh of 100 km, 2,601 nodes
    at Cook_E2's 2 km, and its elliptic lake at the centre), as (mesh
    file, outline file)."""
    from shakti_tpu_torch.mesh.generate import rectangle_mesh
    side = 100e3
    nodes, cells = rectangle_mesh(50, 50, side, side, jitter=0.25, seed=0)
    out = tmp_path_factory.mktemp("small_cooke2")
    write_msh(out / "mesh.msh", nodes, cells)
    th = np.linspace(0, 2 * np.pi, 181)
    np.save(out / "lake.npy", np.stack([0.5 * side + 11e3 * np.cos(th),
                                        0.5 * side + 9e3 * np.sin(th)], 1))
    return out / "mesh.msh", out / "lake.npy"
