"""Minimal gmsh `.msh` reader (pure Python, host-side).

The port's copy of shakti_tpu/mesh/msh_io.py:read_msh and its readers (the
writer is not needed here).  Supports MSH 4.1 and legacy 2.2, ASCII and
binary.  Extracts 2-D triangle meshes: returns (nodes (n, 2) float64,
cells (c, 3) int32) with nodes renumbered densely in file order.
"""

from __future__ import annotations

import struct

import numpy as np


def read_msh(path: str):
    with open(path, "rb") as f:
        data = f.read()

    k = data.find(b"$MeshFormat")
    if k < 0:
        raise ValueError(f"{path}: not a gmsh .msh file (no $MeshFormat)")
    eol = data.index(b"\n", k)
    hdr = data[eol + 1:data.index(b"\n", eol + 1)].split()
    version = float(hdr[0])
    binary = int(hdr[1]) == 1
    data_size = int(hdr[2])

    if binary:
        if data_size != 8:
            raise ValueError(f"{path}: unsupported binary data-size "
                             f"{data_size} (expected 8)")
        # endianness probe: the int 1 written right after the format line
        probe = data[data.index(b"\n", eol + 1) + 1:][:4]
        if struct.unpack("<i", probe)[0] == 1:
            en = "<"
        elif struct.unpack(">i", probe)[0] == 1:
            en = ">"
        else:
            raise ValueError(f"{path}: bad binary endianness probe")
        if 4.0 <= version < 4.1:
            # MSH 4.0 has a different Nodes/Elements layout (2-value
            # size_t section headers, swapped entityTag/dim ints,
            # interleaved node records) — routing it through the 4.1
            # parser would yield garbage coordinates, not an error
            raise ValueError(f"{path}: MSH {version} not supported "
                             "(re-export with gmsh >= 4.1, or ASCII 2.2)")
        if version >= 4.1:
            nodes, tags, off = _read_nodes_v4_bin(data, en)
            cells_raw = _read_elements_v4_bin(data, en, off)
        else:
            nodes, tags, off = _read_nodes_v2_bin(data, en)
            cells_raw = _read_elements_v2_bin(data, en, off)
    else:
        lines = data.decode("latin-1").splitlines()
        if 4.0 <= version < 4.1:
            raise ValueError(f"{path}: MSH {version} not supported "
                             "(re-export with gmsh >= 4.1, or ASCII 2.2)")
        if version >= 4.1:
            nodes, tags = _read_nodes_v4(lines)
            cells_raw = _read_elements_v4(lines)
        else:
            nodes, tags = _read_nodes_v2(lines)
            cells_raw = _read_elements_v2(lines)

    # renumber: gmsh node tags are arbitrary
    remap = {t: k for k, t in enumerate(tags)}
    cells = np.asarray([[remap[a], remap[b], remap[c]] for a, b, c in cells_raw],
                       dtype=np.int32)
    if cells.size == 0:
        raise ValueError(f"{path}: no triangle elements found")
    return np.asarray(nodes, dtype=np.float64)[:, :2], cells


# ---------------------------------------------------------------- binary

def _bin_section(data: bytes, name: str, start: int = 0) -> int:
    """Byte offset just past the '$<name>' marker line.

    The marker must begin a line (preceded by a newline, or sit at the
    file start) and occupy that line alone (\\r tolerated), and the scan
    begins at ``start``: raw binary payload of an earlier section (e.g.
    $Entities doubles, or node coordinates when locating $Elements) can
    coincidentally contain the marker bytes, so callers pass the end
    offset of the previous section."""
    marker = b"$" + name.encode()
    k = start
    while True:
        k = data.find(marker, k)
        if k < 0:
            raise ValueError(f"missing ${name} section")
        if k == 0 or data[k - 1:k] == b"\n":
            eol = data.find(b"\n", k)
            if eol > 0 and data[k:eol].rstrip(b"\r") == marker:
                return eol + 1
        k += 1


class _Cursor:
    """Sequential binary reads from a bytes buffer."""

    def __init__(self, data: bytes, off: int, en: str):
        self.d, self.o, self.en = data, off, en

    def ints(self, n):
        v = np.frombuffer(self.d, dtype=self.en + "i4", count=n,
                          offset=self.o)
        self.o += 4 * n
        return v.astype(np.int64)

    def size_ts(self, n):
        v = np.frombuffer(self.d, dtype=self.en + "u8", count=n,
                          offset=self.o)
        self.o += 8 * n
        return v.astype(np.int64)

    def doubles(self, n):
        v = np.frombuffer(self.d, dtype=self.en + "f8", count=n,
                          offset=self.o)
        self.o += 8 * n
        return v


def _read_nodes_v4_bin(data, en):
    c = _Cursor(data, _bin_section(data, "Nodes"), en)
    n_blocks, n_nodes, _, _ = c.size_ts(4)
    tags, coords = [], []
    for _ in range(n_blocks):
        _, _, parametric = c.ints(3)
        (n_in_block,) = c.size_ts(1)
        tags.extend(c.size_ts(n_in_block).tolist())
        if parametric:
            raise ValueError("parametric node blocks not supported")
        xyz = c.doubles(3 * n_in_block).reshape(n_in_block, 3)
        coords.extend(xyz.tolist())
    return coords, tags, c.o


_V4_NODES_PER_TYPE = {1: 2, 2: 3, 3: 4, 4: 4, 15: 1}


def _read_elements_v4_bin(data, en, start=0):
    c = _Cursor(data, _bin_section(data, "Elements", start), en)
    n_blocks, *_ = c.size_ts(4)
    tris = []
    for _ in range(n_blocks):
        _, _, etype = c.ints(3)
        (n_in_block,) = c.size_ts(1)
        etype = int(etype)
        if etype not in _V4_NODES_PER_TYPE:
            raise ValueError(f"unsupported element type {etype} in binary "
                             ".msh (extend _V4_NODES_PER_TYPE)")
        nn = _V4_NODES_PER_TYPE[etype]
        rec = c.size_ts((1 + nn) * n_in_block).reshape(n_in_block, 1 + nn)
        if etype == 2:
            tris.extend(map(tuple, rec[:, 1:4].tolist()))
    return tris


def _read_nodes_v2_bin(data, en):
    off = _bin_section(data, "Nodes")
    eol = data.index(b"\n", off)
    n = int(data[off:eol])
    # v2.2 binary node record: int tag + 3 doubles, packed per node
    rec = np.frombuffer(data, dtype=np.dtype([("tag", en + "i4"),
                                              ("xyz", en + "f8", (3,))]),
                        count=n, offset=eol + 1)
    return (rec["xyz"].tolist(), rec["tag"].astype(np.int64).tolist(),
            eol + 1 + rec.nbytes)


def _read_elements_v2_bin(data, en, start=0):
    off = _bin_section(data, "Elements", start)
    eol = data.index(b"\n", off)
    n = int(data[off:eol])
    c = _Cursor(data, eol + 1, en)
    tris, seen = [], 0
    while seen < n:
        etype, n_follow, n_etags = (int(v) for v in c.ints(3))
        if etype not in _V4_NODES_PER_TYPE:
            raise ValueError(f"unsupported element type {etype} in binary "
                             ".msh v2.2")
        nn = _V4_NODES_PER_TYPE[etype]
        rec = c.ints((1 + n_etags + nn) * n_follow).reshape(
            n_follow, 1 + n_etags + nn)
        if etype == 2:
            tris.extend(map(tuple, rec[:, 1 + n_etags:].tolist()))
        seen += n_follow
    return tris


# ----------------------------------------------------------------- ASCII

def _find(lines, name):
    for k, ln in enumerate(lines):
        if ln.strip() == f"${name}":
            return k + 1
    raise ValueError(f"missing ${name} section")


def _read_nodes_v4(lines):
    k = _find(lines, "Nodes")
    n_blocks, n_nodes, *_ = (int(v) for v in lines[k].split())
    k += 1
    tags, coords = [], []
    for _ in range(n_blocks):
        _, _, _, n_in_block = (int(v) for v in lines[k].split())
        k += 1
        btags = [int(lines[k + j]) for j in range(n_in_block)]
        k += n_in_block
        for j in range(n_in_block):
            xyz = [float(v) for v in lines[k + j].split()]
            coords.append(xyz[:3])
        k += n_in_block
        tags.extend(btags)
    return coords, tags


def _read_elements_v4(lines):
    k = _find(lines, "Elements")
    n_blocks, *_ = (int(v) for v in lines[k].split())
    k += 1
    tris = []
    for _ in range(n_blocks):
        _, _, etype, n_in_block = (int(v) for v in lines[k].split())
        k += 1
        if etype == 2:  # 3-node triangle
            for j in range(n_in_block):
                parts = lines[k + j].split()
                tris.append((int(parts[1]), int(parts[2]), int(parts[3])))
        k += n_in_block
    return tris


def _read_nodes_v2(lines):
    k = _find(lines, "Nodes")
    n = int(lines[k])
    tags, coords = [], []
    for j in range(n):
        parts = lines[k + 1 + j].split()
        tags.append(int(parts[0]))
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return coords, tags


def _read_elements_v2(lines):
    k = _find(lines, "Elements")
    n = int(lines[k])
    tris = []
    for j in range(n):
        parts = [int(v) for v in lines[k + 1 + j].split()]
        etype, ntags = parts[1], parts[2]
        if etype == 2:
            tris.append(tuple(parts[3 + ntags: 6 + ntags]))
    return tris
