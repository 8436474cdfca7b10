"""Sorbate population histogram + OpenDX volumetric output.

Rebuild of the reference's histogram/dxwrite pair (SURVEY.md §2
"Histogram" / "OpenDX writer", src/main/histogram.c + src/io/dxwrite.c
[M]): sorbate centers of mass are binned into a 3-D grid over the cell at
every corrtime; the accumulated counts are written as an OpenDX ``.dx``
scalar field (VMD/PyMOL-compatible), which is how MPMC users visualize
sorption density.

Bins are fractional-coordinate boxes (exact for triclinic cells); the .dx
grid vectors are the cell vectors divided by the bin counts.
"""
from __future__ import annotations

import numpy as np


class PopulationHistogram:
    def __init__(self, box, resolution: float = 0.7):
        """``resolution``: target bin edge length in A (the grid dims are
        ceil(|cell vector| / resolution) per axis)."""
        self.box = np.asarray(box, np.float64)
        lengths = np.linalg.norm(self.box, axis=1)
        self.dims = np.maximum(
            np.ceil(lengths / resolution).astype(int), 1)
        self.counts = np.zeros(tuple(self.dims), np.float64)
        self.n_frames = 0
        self._inv = np.linalg.inv(self.box)

    def add(self, coms_cart):
        """Bin cartesian COM positions (any count, shape [M,3])."""
        coms_cart = np.asarray(coms_cart, np.float64).reshape(-1, 3)
        if len(coms_cart) == 0:
            self.n_frames += 1
            return
        frac = coms_cart @ self._inv
        frac -= np.floor(frac)
        idx = np.minimum((frac * self.dims).astype(int), self.dims - 1)
        np.add.at(self.counts, (idx[:, 0], idx[:, 1], idx[:, 2]), 1.0)
        self.n_frames += 1

    def write_dx(self, path: str, normalize: bool = True):
        """Write the accumulated grid in OpenDX scalar-field format."""
        nx, ny, nz = (int(d) for d in self.dims)
        d0 = self.box[0] / nx
        d1 = self.box[1] / ny
        d2 = self.box[2] / nz
        data = self.counts / max(self.n_frames, 1) if normalize \
            else self.counts
        with open(path, "w") as f:
            f.write(f"object 1 class gridpositions counts {nx} {ny} {nz}\n")
            f.write("origin 0.0 0.0 0.0\n")
            for d in (d0, d1, d2):
                f.write(f"delta {d[0]:.6f} {d[1]:.6f} {d[2]:.6f}\n")
            f.write(f"object 2 class gridconnections counts {nx} {ny} "
                    f"{nz}\n")
            f.write(f"object 3 class array type double rank 0 items "
                    f"{nx * ny * nz} data follows\n")
            flat = data.reshape(-1)      # x fastest-varying last (C order)
            for i in range(0, len(flat), 3):
                f.write(" ".join(f"{v:.6e}" for v in flat[i:i + 3]) + "\n")
            f.write('attribute "dep" string "positions"\n')
            f.write('object "sorbate density" class field\n')
            f.write('component "positions" value 1\n')
            f.write('component "connections" value 2\n')
            f.write('component "data" value 3\n')


def read_dx(path: str):
    """Minimal .dx reader (round-trip testing)."""
    dims = None
    data = []
    reading = False
    with open(path) as f:
        for line in f:
            if line.startswith("object 1"):
                dims = tuple(int(x) for x in line.split()[-3:])
            elif "data follows" in line:
                reading = True
            elif line.startswith("attribute"):
                reading = False
            elif reading:
                data.extend(float(x) for x in line.split())
    return np.asarray(data).reshape(dims)
