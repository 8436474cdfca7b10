"""Post-hoc analysis of a run's outputs (port of mpmc_tpu/analyze.py).

Frame analyzers read an MPMC PQR trajectory one frame at a time through
the port's native reader (io/native.py::stream_frames_arrays), select
atoms on the host from the packed names and flags, and do the pair work
in float64 PyTorch on a device: g(r) (``rdf``), COM density grids
(``density``), per-frame loadings, COM clusters, mean-square
displacement, orientational autocorrelation, the Debye S(q), Widom
insertion of a Lennard-Jones site or a rigid charged template, the
geometric pore-size distribution and the Shrake-Rupley accessible
surface area.  They run on the current CUDA device unless the caller
passes ``device="cpu"`` (``--cpu`` on the command line), and raise
without one.  Each [rows, columns] pass is chunked under ``BUDGET``
bytes; histograms count pairs as integers and apply weights after, so a
card and the CPU bin alike.  Minimum images copy the reference's
fractional rounding: fr = d binv, fr -= round(fr) (half to even), d = fr
b, with the box and its inverse built on the host in numpy.

Seeded sample points (widom, widom_mol, pore, asa) are drawn with numpy's
``default_rng(seed)`` as the reference's numpy route draws them; the
reference's native route draws other points from the same seed.

Host statistics are numpy: Flyvbjerg-Petersen blocking, the fluctuation
Qst and Clausius-Clapeyron Qst(loading), isotherm fits and binary IAST,
MBAR over PT temperature or fugacity ladders and over separate GCMC runs
(the JSONL streams of io/output.py and the campaign's point_NNN.jsonl),
and the TMMC collection matrix (``tmmc_*``).

Command line: ``python -m mpmc_tpu_torch.analyze <subcommand> ...`` with
the reference's 18 subcommands, flags and output formats, and ``--cpu``
on the frame subcommands.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import warnings

import numpy as np
import torch

from mpmc_tpu_torch.config import resolve_device
from mpmc_tpu_torch.io import native, pqr

F64 = torch.float64
#: bytes of float64 temporaries one chunk of a [rows, columns] pass may hold
BUDGET = 256 << 20


# ---------------------------------------------------------------------------
# frames, selection, boxes (host)
# ---------------------------------------------------------------------------

def _match(name: str, pat: str) -> bool:
    # case-insensitive: PQR names are uppercased on output while users
    # type species as given in their decks ("Ar" vs "AR")
    return pat == "*" or name.upper() == pat.upper()


def _flag_ok(flag: str, sel: str) -> bool:
    if sel in ("", "*"):
        return True
    return (flag.upper().startswith("F")) == (sel.upper() == "F")


def _frame_box(frame, box):
    fb = frame["box"] if isinstance(frame, dict) else frame.box
    if fb is not None:
        return np.asarray(fb, np.float64)
    if box is None:
        raise ValueError("frame has no CRYST cell and no box= given")
    return np.asarray(box, np.float64)


def _half_min_width(b):
    """Half the minimum perpendicular cell width of a 3x3 row basis —
    the min-image validity cap."""
    b = np.asarray(b, np.float64)
    vol = abs(np.linalg.det(b))
    widths = [vol / np.linalg.norm(np.cross(b[(k + 1) % 3],
                                            b[(k + 2) % 3]))
              for k in range(3)]
    return 0.5 * min(widths)


class _Frame:
    """One frame of stream_frames_arrays with vectorized selections:
    names and molecule names as upper-case fixed-width byte arrays (the
    reader keeps a name's first NAME_LEN - 1 characters)."""

    def __init__(self, arr, box=None):
        self.num = arr["num"]
        self.ids = arr["ids"]
        self._cell = (arr, box)
        w = f"S{native.NAME_LEN}"
        self.names = np.char.upper(np.frombuffer(arr["names"], w))
        self.mol_names = np.char.upper(np.frombuffer(arr["mol_names"], w))
        self.frozen = np.frombuffer(arr["flags"], "S1") == b"F"

    @functools.cached_property
    def b(self):
        """The frame's cell (its CRYST1 record, else the caller's box)."""
        return _frame_box(*self._cell)

    @functools.cached_property
    def binv(self):
        return np.linalg.inv(self.b)

    @staticmethod
    def _pat(arr, pat):
        if pat == "*":
            return np.ones(arr.shape, bool)
        return arr == pat.upper().encode()[:native.NAME_LEN - 1]

    def flag(self, sel):
        if sel in ("", "*"):
            return np.ones(self.frozen.shape, bool)
        return self.frozen == (sel.upper() == "F")

    def atoms(self, name="*", flag="*"):
        return self._pat(self.names, name) & self.flag(flag)

    def molecule_atoms(self, mol_name="*", flag="*"):
        return self._pat(self.mol_names, mol_name) & self.flag(flag)


def _frames(path, box=None):
    """_Frame after _Frame of the trajectory, one in memory at a time."""
    for arr in native.stream_frames_arrays(path):
        yield _Frame(arr, box)


def _dev(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float64), dtype=F64,
                           device=device)


def _rows(cols, planes=12):
    """Rows of a chunk of a [rows, cols] pass that keeps ``planes`` float64
    temporaries of that shape under BUDGET."""
    return max(1, BUDGET // (8 * planes * max(int(cols), 1)))


def _min_image(dx, dy, dz, b, binv):
    """Minimum-image displacement components: the reference's
    fr = d @ binv; fr -= round(fr); d = fr @ b, component by component
    with the box and inverse as host floats."""
    fx = dx * binv[0][0] + dy * binv[1][0] + dz * binv[2][0]
    fy = dx * binv[0][1] + dy * binv[1][1] + dz * binv[2][1]
    fz = dx * binv[0][2] + dy * binv[1][2] + dz * binv[2][2]
    fx = fx - torch.round(fx)
    fy = fy - torch.round(fy)
    fz = fz - torch.round(fz)
    return (fx * b[0][0] + fy * b[1][0] + fz * b[2][0],
            fx * b[0][1] + fy * b[1][1] + fz * b[2][1],
            fx * b[0][2] + fy * b[1][2] + fz * b[2][2])


def _pair_r2(p, q, b, binv):
    """Squared minimum-image distances [len(p), len(q)] between rows of
    two [.., 3] tensors."""
    dx = p[:, None, 0] - q[None, :, 0]
    dy = p[:, None, 1] - q[None, :, 1]
    dz = p[:, None, 2] - q[None, :, 2]
    dx, dy, dz = _min_image(dx, dy, dz, b, binv)
    return dx * dx + dy * dy + dz * dz


def _host_lists(b, binv):
    return np.asarray(b, np.float64).tolist(), \
        np.asarray(binv, np.float64).tolist()


class _Molecules:
    """The selected atoms of a frame grouped by mol_id, molecules in
    order of first appearance, atoms of a molecule in frame order."""

    def __init__(self, mids):
        mids = np.asarray(mids, np.int64)
        uniq, first, inv = np.unique(mids, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        self.mol = rank[inv.reshape(-1)]          # molecule of each atom
        self.ids = uniq[order]                    # mol_id of each molecule
        self.count = np.bincount(self.mol, minlength=order.size)
        srt = np.argsort(self.mol, kind="stable")
        start = np.cumsum(self.count) - self.count
        self.slot = np.empty(mids.size, np.int64)
        self.slot[srt] = np.arange(mids.size) - start[self.mol[srt]]

    def __len__(self):
        return self.ids.size

    def table(self, n_atoms=None):
        """[M, K] atom index of each molecule's k-th atom, -1 past its
        last."""
        k = int(self.count.max()) if self.count.size else 0
        t = np.full((len(self), k), -1, np.int64)
        t[self.mol, self.slot] = np.arange(self.mol.size)
        return t


def _coms(xyzm, mols, b, binv):
    """Molecule COMs [M, 3] on xyzm's device: mass-weighted, minimum-image
    unwrapped about each molecule's first atom (the centroid when
    massless), summed atom by atom in frame order as the reference
    sums."""
    t = mols.table()
    dev = xyzm.device
    m_count = len(mols)
    if m_count == 0:
        return torch.zeros((0, 3), dtype=F64, device=dev)
    idx = torch.as_tensor(np.maximum(t, 0), device=dev)
    has = torch.as_tensor(t >= 0, device=dev)
    r0 = xyzm[idx[:, 0], :3]
    sx = torch.zeros(m_count, dtype=F64, device=dev)
    sy, sz, ms = sx.clone(), sx.clone(), sx.clone()
    dxs, dys, dzs = sx.clone(), sx.clone(), sx.clone()
    for k in range(t.shape[1]):
        a = xyzm[idx[:, k]]
        hk = has[:, k]
        dx, dy, dz = _min_image(a[:, 0] - r0[:, 0], a[:, 1] - r0[:, 1],
                                a[:, 2] - r0[:, 2], b, binv)
        zero = torch.zeros_like(dx)
        dx, dy, dz = (torch.where(hk, dx, zero), torch.where(hk, dy, zero),
                      torch.where(hk, dz, zero))
        m = torch.where(hk, a[:, 3], zero)
        sx, sy, sz = sx + m * dx, sy + m * dy, sz + m * dz
        dxs, dys, dzs = dxs + dx, dys + dy, dzs + dz
        ms = ms + m
    n = torch.as_tensor(mols.count.astype(np.float64), device=dev)
    heavy = ms > 0
    msafe = torch.where(heavy, ms, torch.ones_like(ms))
    off = torch.stack([torch.where(heavy, sx / msafe, dxs / n),
                       torch.where(heavy, sy / msafe, dys / n),
                       torch.where(heavy, sz / msafe, dzs / n)], -1)
    return r0 + off


def _frame_coms(fr, sel, dev, order_by_id=False):
    """(_Molecules, COMs [M, 3]) of the atoms ``sel`` of frame ``fr``:
    one [n, 4] (xyz, mass) tensor to the device."""
    rows = np.flatnonzero(sel)
    mols = _Molecules(fr.ids[rows, 1])
    if order_by_id and len(mols):
        perm = np.argsort(mols.ids, kind="stable")
        rank = np.empty_like(perm)
        rank[perm] = np.arange(perm.size)
        mols.mol = rank[mols.mol]
        mols.ids = mols.ids[perm]
        mols.count = mols.count[perm]
    xyzm = _dev(fr.num[rows][:, :4], dev)
    b, binv = _host_lists(fr.b, fr.binv)
    return mols, _coms(xyzm, mols, b, binv)


# ---------------------------------------------------------------------------
# frame analyzers (device)
# ---------------------------------------------------------------------------

def _near_edge(x, scale, tol=1e-9):
    """Count of entries of x (a distance in bin units) within ``tol`` Å of
    a bin edge, ``scale`` Å per bin unit."""
    return int(((x - torch.round(x)).abs() * scale < tol).sum())


def rdf_counts(path, name_a="*", name_b="*", flag_a="*", flag_b="*",
               box=None, rmax=10.0, nbins=200, device=None):
    """(pair counts [nbins] int64, ideal pair-density sum, pairs within
    1e-9 Å of a bin edge, n_frames): ordered pairs (i in A, j in B,
    i != j) binned by minimum-image distance r < rmax into
    min(int(r / dr), nbins - 1), and the per-frame sum of (|A| |B| -
    |A and B|) / V that normalizes them."""
    dev = resolve_device(device)
    dr = rmax / nbins
    hist = torch.zeros(nbins, dtype=torch.int64, device=dev)
    norm, near, n_frames = 0.0, 0, 0
    for fr in _frames(path, box):
        n_frames += 1
        vol = abs(np.linalg.det(fr.b))
        sa = fr.atoms(name_a, flag_a)
        sb = fr.atoms(name_b, flag_b)
        ia, ib = np.flatnonzero(sa), np.flatnonzero(sb)
        overlap = int(np.count_nonzero(sa & sb))
        if ia.size and ib.size:
            b, binv = _host_lists(fr.b, fr.binv)
            rows = np.union1d(ia, ib)
            xyz = _dev(fr.num[rows, :3], dev)
            pa = xyz[torch.as_tensor(np.searchsorted(rows, ia), device=dev)]
            pb = xyz[torch.as_tensor(np.searchsorted(rows, ib), device=dev)]
            ta = torch.as_tensor(ia, device=dev)
            tb = torch.as_tensor(ib, device=dev)
            step = _rows(ib.size)
            for i0 in range(0, ia.size, step):
                r = torch.sqrt(_pair_r2(pa[i0:i0 + step], pb, b, binv))
                ok = (r < rmax) & (ta[i0:i0 + step, None] != tb[None, :])
                x = r[ok] / dr
                near += _near_edge(x, dr)
                k = torch.clamp(x.to(torch.int64), max=nbins - 1)
                hist += torch.bincount(k, minlength=nbins)
        norm += (ia.size * ib.size - overlap) / vol
    return hist.cpu().numpy(), norm, near, n_frames


def rdf(path, name_a="*", name_b="*", flag_a="*", flag_b="*", box=None,
        rmax=10.0, nbins=200, device=None):
    """(r_centers, g): g(r) of A-B pairs over a trajectory, normalized by
    the per-frame ideal-gas pair density (varying N and V normalize
    right)."""
    hist, norm, _, _ = rdf_counts(path, name_a, name_b, flag_a, flag_b,
                                  box=box, rmax=rmax, nbins=nbins,
                                  device=device)
    dr = rmax / nbins
    edges = np.arange(nbins + 1) * dr
    vshell = 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)
    with np.errstate(invalid="ignore"):
        gr = (hist.astype(np.float64) / (norm * vshell) if norm > 0
              else np.zeros(nbins))
    r = (np.arange(nbins) + 0.5) * dr
    return r, gr


def density_grid(path, mol_name="*", flag="M", dims=(32, 32, 32),
                 box=None, device=None):
    """(COM counts [nx, ny, nz] int64, n_frames, COMs within 1e-9 Å of a
    bin plane): each selected molecule's COM (minimum-image unwrapped
    about its first atom; centroid when massless) binned on the
    fractional grid."""
    dev = resolve_device(device)
    nd = [int(d) for d in dims]
    grid = torch.zeros(nd[0] * nd[1] * nd[2], dtype=torch.int64, device=dev)
    n_frames = near = 0
    for fr in _frames(path, box):
        n_frames += 1
        _, com = _frame_coms(fr, fr.molecule_atoms(mol_name, flag), dev)
        if com.shape[0] == 0:
            continue
        binv = fr.binv.tolist()
        flat = torch.zeros(com.shape[0], dtype=torch.int64, device=dev)
        for a in range(3):
            fa = (com[:, 0] * binv[0][a] + com[:, 1] * binv[1][a]
                  + com[:, 2] * binv[2][a])
            x = (fa - torch.floor(fa)) * nd[a]
            near += _near_edge(x, float(np.linalg.norm(fr.b[a])) / nd[a])
            flat = flat * nd[a] + torch.clamp(x.to(torch.int64), 0,
                                              nd[a] - 1)
        grid += torch.bincount(flat, minlength=grid.numel())
    return grid.cpu().numpy().reshape(nd), n_frames, near


def density(path, mol_name="*", flag="M", resolution=0.7, box=None,
            device=None):
    """(per-frame-averaged COM density grid, dims, box); the grid dims
    follow PopulationHistogram (ceil(|cell vector| / resolution)) of the
    first frame's cell, or ``box`` (3x3) when the frames carry none."""
    if box is None:
        box = pqr.read_first_frame(path).box
        if box is None:
            raise ValueError("no CRYST cell in trajectory; pass box=")
    box = np.asarray(box, np.float64)
    lengths = np.linalg.norm(box, axis=1)
    dims = tuple(int(d) for d in
                 np.maximum(np.ceil(lengths / resolution), 1))
    grid, n_frames, _ = density_grid(path, mol_name, flag, dims, box=box,
                                     device=device)
    return grid / max(n_frames, 1), dims, box


def loading(path, mol_name="*", flag="M", device=None):
    """Per-frame count of selected molecules (a GCMC loading series)."""
    dev = resolve_device(device)
    out = []
    for fr in _frames(path):
        mids = torch.as_tensor(fr.ids[fr.molecule_atoms(mol_name, flag), 1],
                               device=dev)
        out.append(torch.unique(mids).numel())
    return np.asarray(out, np.float64)


def _components(adj):
    """Connected-component label (its least member) of each node of a
    symmetric boolean adjacency matrix, by min-label propagation with
    pointer jumping."""
    n = adj.shape[0]
    lab = torch.arange(n, device=adj.device)
    big = torch.full_like(lab, n)
    while True:
        nb = torch.where(adj, lab[None, :], big[None, :]).min(1).values
        new = torch.minimum(lab, nb)
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def cluster(path, mol_name="*", flag="M", rc=4.0, box=None, max_size=64,
            device=None):
    """(series [n_frames, 3], size histogram [max_size]): per frame the
    selected molecules whose COMs lie within rc (minimum image) form
    connected components; the series holds the cluster count, the mean
    size and the largest cluster's fraction, the histogram counts
    cluster sizes s in bin min(s, max_size) - 1 over all frames."""
    dev = resolve_device(device)
    series = []
    hist = np.zeros(int(max_size))
    for fr in _frames(path, box):
        mols, com = _frame_coms(fr, fr.molecule_atoms(mol_name, flag), dev,
                                order_by_id=True)
        n_m = len(mols)
        if n_m == 0:
            series.append((0.0, 0.0, 0.0))
            continue
        b, binv = _host_lists(fr.b, fr.binv)
        step = _rows(n_m)
        adj = torch.cat([_pair_r2(com[i0:i0 + step], com, b, binv) < rc * rc
                         for i0 in range(0, n_m, step)])
        sizes = torch.bincount(_components(adj), minlength=n_m)
        sl = sizes[sizes > 0].cpu().numpy()
        for s in sl:
            hist[min(int(s), int(max_size)) - 1] += 1
        series.append((float(len(sl)), n_m / len(sl), int(sl.max()) / n_m))
    return np.asarray(series, np.float64).reshape(-1, 3), hist


class _Segments:
    """Per-molecule series over frames that close when the molecule is
    absent from a frame (GCMC): rows appended frame by frame, each with
    its segment id (host integers)."""

    def __init__(self):
        self.open = {}            # mol_id -> (segment, row in last frame)
        self.seg_of_row = []
        self.rows = []            # device tensors, one per frame
        self.n_seg = 0

    def frame(self, mids):
        """Close the segments of molecules not in ``mids``; returns (the
        segment of each of ``mids``, the last frame's row of each that
        continues (-1 for a new one))."""
        keep = set(int(m) for m in mids)
        for m in [m for m in self.open if m not in keep]:
            del self.open[m]
        seg, prev = [], []
        for m in mids:
            m = int(m)
            if m in self.open:
                s, r = self.open[m]
            else:
                s, r = self.n_seg, -1
                self.n_seg += 1
            seg.append(s)
            prev.append(r)
        self.open = {int(m): (s, k) for k, (m, s) in
                     enumerate(zip(mids, seg))}
        return np.asarray(seg, np.int64), np.asarray(prev, np.int64)

    def add(self, rows, seg):
        self.rows.append(rows)
        self.seg_of_row.append(seg)

    def lags(self):
        """(rows sorted by segment then time [R, k], segment ids) for the
        lag loops: rows i and i + t of one segment are t frames apart."""
        seg = (np.concatenate(self.seg_of_row) if self.seg_of_row
               else np.zeros(0, np.int64))
        perm = np.argsort(seg, kind="stable")
        u = torch.cat(self.rows) if self.rows else None
        if u is not None:
            u = u[torch.as_tensor(perm, device=u.device)]
        return u, seg[perm]


def msd(path, mol_name="*", flag="M", box=None, max_lag=0, device=None):
    """(msd [L+1], counts [L+1]) of selected molecules' COMs vs frame
    lag: COM series unwrapped by minimum-image increments, segments
    closed on disappearance (GCMC), every time origin."""
    dev = resolve_device(device)
    segs = _Segments()
    last_com = last_unw = None
    n_frames = 0
    for fr in _frames(path, box):
        n_frames += 1
        mols, com = _frame_coms(fr, fr.molecule_atoms(mol_name, flag), dev)
        seg, prev = segs.frame(mols.ids)
        unw = com.clone()
        cont = np.flatnonzero(prev >= 0)
        if cont.size:
            b, binv = _host_lists(fr.b, fr.binv)
            c = torch.as_tensor(cont, device=dev)
            p = torch.as_tensor(prev[cont], device=dev)
            d = com[c] - last_com[p]
            sx, sy, sz = _min_image(d[:, 0], d[:, 1], d[:, 2], b, binv)
            unw[c] = last_unw[p] + torch.stack([sx, sy, sz], -1)
        segs.add(unw, seg)
        last_com, last_unw = com, unw
    if max_lag <= 0:
        max_lag = max(n_frames - 1, 1)
    out = np.zeros(max_lag + 1)
    cnt = np.zeros(max_lag + 1, np.int64)
    u, sg = segs.lags()
    for t in range(1, min(max_lag, sg.size - 1) + 1):
        same = np.flatnonzero(sg[t:] == sg[:-t])
        if same.size == 0:
            continue
        i = torch.as_tensor(same, device=dev)
        d = u[i + t] - u[i]
        out[t] = float((d * d).sum())
        cnt[t] = same.size
    with np.errstate(invalid="ignore"):
        out[1:] = np.where(cnt[1:] > 0, out[1:] / np.maximum(cnt[1:], 1),
                           0.0)
    return out, cnt


def orientation(path, mol_name="*", flag="M", axis_name="*", box=None,
                max_lag=0, device=None):
    """(c1, c2, counts) [L+1]: orientational autocorrelation of molecular
    axes (the normalized minimum-image vector between the first two atoms
    of a molecule whose name matches ``axis_name``) vs frame lag, with
    P1 and P2; segments close when a molecule or its axis is absent."""
    dev = resolve_device(device)
    segs = _Segments()
    n_frames = 0
    for fr in _frames(path, box):
        n_frames += 1
        sel = fr.molecule_atoms(mol_name, flag)
        pick = np.flatnonzero(sel & fr.atoms(axis_name))
        mols = _Molecules(fr.ids[pick, 1])
        two = np.flatnonzero(mols.count >= 2)
        mids = np.zeros(0, np.int64)
        axes = torch.zeros((0, 3), dtype=F64, device=dev)
        if two.size:
            t = mols.table()[two]
            xyz = _dev(fr.num[pick, :3], dev)
            i0 = torch.as_tensor(t[:, 0], device=dev)
            i1 = torch.as_tensor(t[:, 1], device=dev)
            d = xyz[i1] - xyz[i0]
            b, binv = _host_lists(fr.b, fr.binv)
            dx, dy, dz = _min_image(d[:, 0], d[:, 1], d[:, 2], b, binv)
            n = torch.sqrt(dx * dx + dy * dy + dz * dz)
            ok = (n > 0).cpu().numpy()
            keep = torch.as_tensor(np.flatnonzero(ok), device=dev)
            axes = torch.stack([dx, dy, dz], -1)[keep] / n[keep, None]
            mids = mols.ids[two][ok]
        seg, _ = segs.frame(mids)
        segs.add(axes, seg)
    if max_lag <= 0:
        max_lag = max(n_frames - 1, 1)
    c1 = np.zeros(max_lag + 1)
    c2 = np.zeros(max_lag + 1)
    cnt = np.zeros(max_lag + 1, np.int64)
    u, sg = segs.lags()
    for t in range(0, min(max_lag, sg.size - 1) + 1):
        same = (np.arange(sg.size) if t == 0
                else np.flatnonzero(sg[t:] == sg[:-t]))
        if same.size == 0:
            continue
        i = torch.as_tensor(same, device=dev)
        dot = (u[i + t] * u[i]).sum(-1)
        c1[t] = float(dot.sum())
        c2[t] = float((1.5 * dot * dot - 0.5).sum())
        cnt[t] = same.size
    nz = cnt > 0
    c1[nz] /= cnt[nz]
    c2[nz] /= cnt[nz]
    return c1, c2, cnt


def sq_hist(path, name="*", flag="*", box=None, dr_bin=0.005, device=None):
    """(weighted pair histogram, integer pair counts summed over frames,
    n_frames, pairs within 1e-9 Å of a bin edge): minimum-image pair
    distances (i < j) binned at dr_bin, each frame's counts weighted by
    2 / N_f."""
    dev = resolve_device(device)
    hist = np.zeros(0)
    total = np.zeros(0, np.int64)
    n_frames = near = 0
    for fr in _frames(path, box):
        n_frames += 1
        rows = np.flatnonzero(fr.atoms(name, flag))
        n = rows.size
        if n < 2:
            continue
        b, binv = _host_lists(fr.b, fr.binv)
        p = _dev(fr.num[rows, :3], dev)
        counts = torch.zeros(1, dtype=torch.int64, device=dev)
        step = _rows(n)
        for i0 in range(0, n - 1, step):
            i1 = min(i0 + step, n - 1)
            r = torch.sqrt(_pair_r2(p[i0:i1], p[i0 + 1:], b, binv))
            j = torch.arange(i0 + 1, n, device=dev)
            upper = j[None, :] > torch.arange(i0, i1, device=dev)[:, None]
            x = r[upper] / dr_bin
            near += _near_edge(x, dr_bin)
            c = torch.bincount(x.to(torch.int64))
            if c.numel() > counts.numel():
                counts = torch.cat([counts, counts.new_zeros(
                    c.numel() - counts.numel())])
            counts[:c.numel()] += c
        c = counts.cpu().numpy()
        if c.size > hist.size:
            hist = np.concatenate([hist, np.zeros(c.size - hist.size)])
            total = np.concatenate([total, np.zeros(c.size - total.size,
                                                    np.int64)])
        hist[:c.size] += c * (2.0 / n)
        total[:c.size] += c
    return hist, total, n_frames, near


def sq(path, q, name="*", flag="*", box=None, dr_bin=0.005, device=None):
    """(S(q) [nq], n_frames): the Debye structure factor from bin-center
    sinc sums of sq_hist's histogram, frames averaged evenly."""
    q = np.asarray(q, np.float64).reshape(-1)
    if np.any(q <= 0):
        raise ValueError("q values must be > 0")
    hist, _, n_frames, _ = sq_hist(path, name, flag, box=box,
                                   dr_bin=dr_bin, device=device)
    r_c = (np.arange(hist.size) + 0.5) * dr_bin
    x = q[:, None] * r_c[None, :]
    s = (hist[None, :] * np.sin(x) / x).sum(axis=1)
    return (1.0 + s / max(n_frames, 1)
            if n_frames > 0 else np.ones_like(q)), n_frames


# ---------------------------------------------------------------------------
# insertion analyzers (device)
# ---------------------------------------------------------------------------

def _quat_rotate(q, v):
    """Rotate rows of v [S,3] by unit quaternion q (w,x,y,z): v + w t +
    qv x t, t = 2 qv x v."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    qv = q[1:]
    t = 2.0 * np.cross(qv, v)
    return v + q[0] * t + np.cross(qv, t)


def widom_means(path, eps, sig, temperature, frac_pos, box=None, rc=10.0,
                device=None):
    """(mean exp(-bU), mean U exp(-bU), n_frames): a single-site LJ ghost,
    Lorentz-Berthelot mixed with each frame atom of eps > 0, at the
    fractional points ``frac_pos`` (the same every frame), minimum image
    within rc; frames averaged evenly."""
    dev = resolve_device(device)
    beta = 1.0 / float(temperature)
    fp = np.asarray(frac_pos, np.float64)
    sum_e = sum_ue = 0.0
    n_frames = 0
    for fr in _frames(path, box):
        n_frames += 1
        cols = np.flatnonzero(fr.num[:, 6] > 0.0)
        p = _dev(fp @ fr.b, dev)
        if cols.size:
            b, binv = _host_lists(fr.b, fr.binv)
            a = _dev(fr.num[cols][:, [0, 1, 2, 6, 7]], dev)
            s = 0.5 * (sig + a[:, 4])
            ss = (s * s)[None, :]
            e4 = (4.0 * torch.sqrt(eps * a[:, 3]))[None, :]
            us = []
            step = _rows(cols.size)
            for i0 in range(0, len(fp), step):
                r2 = _pair_r2(p[i0:i0 + step], a, b, binv)
                ok = r2 < rc * rc
                s6 = (ss / torch.clamp(r2, min=1e-12)) ** 3
                u = torch.where(ok, e4 * s6 * (s6 - 1.0),
                                torch.zeros_like(r2))
                us.append(u.sum(-1))
            u = torch.cat(us)
        else:
            u = torch.zeros(len(fp), dtype=F64, device=dev)
        w = torch.exp(-beta * u)
        sum_e += float(w.mean())
        sum_ue += float((u * w).mean())
    n = max(n_frames, 1)
    return sum_e / n, sum_ue / n, n_frames


def widom_mol_means(path, site_xyz, site_eps, site_sig, site_q,
                    temperature, posquat, box=None, rc=10.0, device=None):
    """(mean exp(-bU), mean U exp(-bU), n_frames) of a rigid multi-site
    ghost: template sites rotated by each trial's quaternion about a COM
    at its fractional point, LB-mixed LJ (both eps > 0) plus cutoff
    Coulomb (both charges nonzero) within rc, minimum image; frame atoms
    with eps > 0 or a charge."""
    from mpmc_tpu_torch.constants import KE
    dev = resolve_device(device)
    beta = 1.0 / float(temperature)
    xyz = np.asarray(site_xyz, np.float64).reshape(-1, 3)
    n_s = xyz.shape[0]
    eps_s = np.asarray(site_eps, np.float64).ravel()
    sig_s = np.asarray(site_sig, np.float64).ravel()
    q_s = np.asarray(site_q, np.float64).ravel()
    pq = np.asarray(posquat, np.float64).reshape(-1, 7)
    n_t = pq.shape[0]
    offs = np.stack([_quat_rotate(row[3:], xyz) for row in pq])  # [T,S,3]
    site = _dev(np.stack([np.tile(eps_s, n_t), np.tile(sig_s, n_t),
                          np.tile(q_s, n_t)], -1), dev)           # [T*S,3]
    sum_e = sum_ue = 0.0
    n_frames = 0
    for fr in _frames(path, box):
        n_frames += 1
        cols = np.flatnonzero((fr.num[:, 6] > 0.0) | (fr.num[:, 4] != 0.0))
        if cols.size:
            rot = (offs + (pq[:, :3] @ fr.b)[:, None, :]).reshape(-1, 3)
            p = _dev(rot, dev)
            b, binv = _host_lists(fr.b, fr.binv)
            a = _dev(fr.num[cols][:, [0, 1, 2, 4, 6, 7]], dev)
            a_q, a_eps, a_sig = a[None, :, 3], a[None, :, 4], a[None, :, 5]
            step = max(n_s, _rows(cols.size, planes=16) // n_s * n_s)
            parts = []
            for i0 in range(0, n_t * n_s, step):
                sl = slice(i0, i0 + step)
                r2 = torch.clamp(_pair_r2(p[sl], a, b, binv), min=1e-12)
                ok = r2 < rc * rc
                se = site[sl, 0:1]
                lj_ok = ok & (a_eps > 0) & (se > 0)
                s_mix = 0.5 * (site[sl, 1:2] + a_sig)
                s6 = (s_mix * s_mix / r2) ** 3
                e_mix = torch.sqrt(se * a_eps)
                zero = torch.zeros_like(r2)
                lj = torch.where(lj_ok, 4.0 * e_mix * s6 * (s6 - 1.0), zero)
                qs = site[sl, 2:3]
                es_ok = ok & (a_q != 0) & (qs != 0)
                es = torch.where(es_ok, KE * qs * a_q / torch.sqrt(r2), zero)
                parts.append((lj.sum(-1), es.sum(-1)))
            lj = torch.cat([x for x, _ in parts]).reshape(n_t, n_s).sum(-1)
            es = torch.cat([y for _, y in parts]).reshape(n_t, n_s).sum(-1)
            u = 0.0 + lj + es
        else:
            u = torch.zeros(n_t, dtype=F64, device=dev)
        w = torch.exp(-beta * u)
        sum_e += float(w.sum()) / n_t
        sum_ue += float((u * w).sum()) / n_t
    n = max(n_frames, 1)
    return sum_e / n, sum_ue / n, n_frames


def template_sites(insert_pqr):
    """(site_xyz [S,3] about the mass-weighted COM, eps, sig, charge)
    from an insertion-template PQR (the GCMC insert_input deck)."""
    frame = pqr.read_first_frame(insert_pqr)
    if not frame.atoms:
        raise ValueError(f"{insert_pqr}: empty template")
    xyz = np.stack([np.asarray(a.xyz, np.float64) for a in frame.atoms])
    m = np.array([a.mass for a in frame.atoms])
    com = (m[:, None] * xyz).sum(0) / m.sum() if m.sum() > 0 \
        else xyz.mean(0)
    return (xyz - com,
            np.array([a.eps for a in frame.atoms]),
            np.array([a.sig for a in frame.atoms]),
            np.array([a.charge for a in frame.atoms]))


def _widom_post(out, path, temperature, box):
    """(mean e, mean U e, n_frames) -> {boltzmann, mu_ex, u0,
    kh_mol_kg_atm, n_frames} (single-site and template paths report
    alike); the framework mass and cell from the first frame only."""
    from mpmc_tpu_torch.constants import ATM2K_A3
    e_mean, ue_mean, n_frames = out
    frame0 = pqr.read_first_frame(path)
    fw_mass = sum(a.mass for a in frame0.atoms if _flag_ok(a.flag, "F"))
    u0 = ue_mean / e_mean if e_mean > 0 else float("nan")
    mu_ex = (-temperature * float(np.log(e_mean)) if e_mean > 0
             else float("inf"))
    kh = float("nan")
    if fw_mass > 0 and e_mean > 0:
        b = _frame_box(frame0, box)
        vol = abs(np.linalg.det(b))
        # Henry's law: <N> = (f/kT) V <exp(-bU)>, f in atm; K_H [mol /
        # (kg_framework atm)] = 1000 ATM2K_A3 V <e> / (T m_frame[amu])
        kh = 1e3 * ATM2K_A3 * vol * e_mean / (temperature * fw_mass)
    return {"boltzmann": e_mean, "mu_ex": mu_ex, "u0": u0,
            "kh_mol_kg_atm": kh, "n_frames": n_frames}


def random_posquat(n_try, seed=0):
    """[n_try, 7] fractional point + uniform unit quaternion per trial
    from numpy's default_rng(seed) (the reference's numpy route)."""
    u = np.random.default_rng(seed).uniform(0.0, 1.0, (int(n_try), 6))
    quat = np.stack([
        np.sqrt(u[:, 3]) * np.cos(2 * np.pi * u[:, 5]),
        np.sqrt(1 - u[:, 3]) * np.sin(2 * np.pi * u[:, 4]),
        np.sqrt(1 - u[:, 3]) * np.cos(2 * np.pi * u[:, 4]),
        np.sqrt(u[:, 3]) * np.sin(2 * np.pi * u[:, 5])], -1)
    return np.concatenate([u[:, :3], quat], -1)


def widom_mol(path, insert_pqr, temperature, n_try=2000, seed=0, box=None,
              rc=10.0, posquat=None, device=None):
    """Rigid multi-site Widom insertion over a trajectory with a template
    from an insert_input-style PQR: LB-mixed LJ + plain-cutoff Coulomb.
    Returns the same dict as widom()."""
    sx, se, ss, sq2 = template_sites(insert_pqr)
    if posquat is None:
        posquat = random_posquat(n_try, seed)
    out = widom_mol_means(path, sx, se, ss, sq2, temperature, posquat,
                          box=box, rc=rc, device=device)
    return _widom_post(out, path, temperature, box)


def widom(path, eps, sig, temperature, n_try=2000, seed=0, box=None,
          rc=10.0, frac_pos=None, device=None):
    """Widom insertion of one LJ site over a trajectory: {boltzmann =
    <exp(-U/kT)>, mu_ex = -kT ln<exp(-U/kT)> [K], u0 = <U e>/<e> [K],
    kh_mol_kg_atm (per framework mass), n_frames}."""
    if frac_pos is None:
        frac_pos = np.random.default_rng(seed).uniform(0.0, 1.0,
                                                       (int(n_try), 3))
    out = widom_means(path, eps, sig, temperature, frac_pos, box=box, rc=rc,
                      device=device)
    return _widom_post(out, path, temperature, box)


# ---------------------------------------------------------------------------
# geometry analyzers (device, first frame)
# ---------------------------------------------------------------------------

def _first_frame(path, box, name, flag):
    """(box, inverse, hard-sphere positions [na, 3] and radii sigma/2 of
    the selected sig > 0 atoms, selected mass) of the first frame."""
    frame = pqr.read_first_frame(path)
    b = _frame_box(frame, box)
    sel = [a for a in frame.atoms
           if a.sig > 0.0 and _match(a.name, name)
           and _flag_ok(a.flag, flag)]
    mass = sum(a.mass for a in frame.atoms
               if _match(a.name, name) and _flag_ok(a.flag, flag))
    pa = (np.stack([np.asarray(a.xyz, np.float64) for a in sel]) if sel
          else np.zeros((0, 3)))
    rad = np.array([0.5 * a.sig for a in sel])
    return b, np.linalg.inv(b), pa, rad, mass


def _d_surf(p, pa, rad, b, binv, cap):
    """Surface distance of points p [n, 3] to the hard spheres (pa, rad),
    minimum image, clamped above by cap."""
    if pa.shape[0] == 0:
        return torch.full((p.shape[0],), cap, dtype=F64, device=p.device)
    out = []
    step = _rows(pa.shape[0])
    for i0 in range(0, p.shape[0], step):
        r = torch.sqrt(_pair_r2(p[i0:i0 + step], pa, b, binv)) - rad[None, :]
        out.append(r.min(1).values)
    return torch.clamp(torch.cat(out), max=cap)


def pore_samples(path, name="*", flag="F", frac_pts=None, frac_ctr=None,
                 box=None, device=None):
    """(d_surf, r_pore) at the fractional sample points of the first
    frame: the surface distance (least minimum-image distance to a
    selected sig > 0 atom less sigma/2, capped at half the least
    perpendicular width) and the Gelb-Gubbins pore radius (the largest
    d_surf of a candidate center whose sphere covers the point; never
    below d_surf)."""
    dev = resolve_device(device)
    b, binv, pa, rad, _ = _first_frame(path, box, name, flag)
    cap = _half_min_width(b)
    bl, bil = _host_lists(b, binv)
    pa_t, rad_t = _dev(pa, dev), _dev(rad, dev)
    p = _dev(np.asarray(frac_pts, np.float64) @ b, dev)
    dp = _d_surf(p, pa_t, rad_t, bl, bil, cap)
    r_out = dp.clone()
    if frac_ctr is not None and len(frac_ctr):
        c = _dev(np.asarray(frac_ctr, np.float64) @ b, dev)
        cd = _d_surf(c, pa_t, rad_t, bl, bil, cap)
        cd2 = (cd * cd)[None, :]
        step = _rows(c.shape[0])
        ninf = torch.tensor(-math.inf, dtype=F64, device=dev)
        for k0 in range(0, p.shape[0], step):
            covered = _pair_r2(p[k0:k0 + step], c, bl, bil) <= cd2
            best = torch.where(covered, cd[None, :], ninf).max(1).values
            blk = r_out[k0:k0 + step]
            r_out[k0:k0 + step] = torch.where((blk >= 0.0) & (best > blk),
                                              best, blk)
    return dp.cpu().numpy(), r_out.cpu().numpy()


def pore(path, name="*", flag="F", probe_sigma=0.0, n_points=20000,
         n_centers=2000, seed=0, box=None, frac_pts=None, frac_ctr=None,
         nbins=60, device=None):
    """Geometric pore characterization of a structure (first frame): atoms
    are hard spheres of radius sigma/2, the probe's radius probe_sigma/2.
    Returns {void_fraction (probe centers fit: d_surf >= r_probe),
    coverable_fraction (r_pore >= r_probe), psd_r, psd (density over the
    coverable void), psd_cumulative, d_max, cap, volume, n_points}."""
    rng = np.random.default_rng(seed)
    if frac_pts is None:
        frac_pts = rng.uniform(0.0, 1.0, (int(n_points), 3))
    if frac_ctr is None:
        frac_ctr = rng.uniform(0.0, 1.0, (int(n_centers), 3))
    d, r = pore_samples(path, name, flag, frac_pts=frac_pts,
                        frac_ctr=frac_ctr, box=box, device=device)
    b = _frame_box(pqr.read_first_frame(path), box)
    cap = _half_min_width(b)
    r_probe = 0.5 * float(probe_sigma)
    void = float(np.mean(d >= r_probe))
    coverable = float(np.mean(r >= r_probe))
    rv = r[r >= r_probe]
    hist, edges = np.histogram(rv, bins=nbins,
                               range=(r_probe, max(cap, r_probe + 1e-9)),
                               density=rv.size > 0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    cum = (np.array([np.mean(rv >= e) for e in edges[:-1]])
           if rv.size else np.zeros(nbins))
    return {"void_fraction": void, "coverable_fraction": coverable,
            "psd_r": centers, "psd": hist, "psd_cumulative": cum,
            "d_max": float(d.max()) if len(d) else 0.0,
            "cap": cap, "volume": float(abs(np.linalg.det(b))),
            "n_points": int(len(d))}


def _asa_counts(b, binv, pa, R, unit_pts, which, dev):
    """Accessible points of the spheres of atoms ``which``: of the points
    R_i u on atom i's inflated sphere, those inside no OTHER atom's
    (minimum image); (atom, point) rows in chunks."""
    u = _dev(unit_pts, dev)
    bl, bil = _host_lists(b, binv)
    pa_t, R_t = _dev(pa, dev), _dev(R, dev)
    R2 = (R_t * R_t)[None, :]
    n_u = u.shape[0]
    w = torch.as_tensor(which, device=dev)
    counts = torch.zeros(which.size, dtype=torch.int64, device=dev)
    step = _rows(pa.shape[0])
    for r0 in range(0, which.size * n_u, step):
        r = torch.arange(r0, min(r0 + step, which.size * n_u), device=dev)
        k = r // n_u
        atom = w[k]
        p = pa_t[atom] + R_t[atom, None] * u[r % n_u]
        blocked = _pair_r2(p, pa_t, bl, bil) < R2
        blocked[torch.arange(r.numel(), device=dev), atom] = False
        counts += torch.bincount(k[~blocked.any(1)], minlength=which.size)
    return counts.cpu().numpy()


def asa_counts(path, name="*", flag="F", probe_sigma=0.0, unit_pts=None,
               box=None, atoms=None, device=None):
    """(accessible points of each selected sig > 0 atom [na] int64,
    inflated radii [na]) of the first frame: of the points R_i u on atom
    i's sphere of radius R_i = (sigma_i + probe_sigma)/2, those inside no
    OTHER selected atom's inflated sphere (minimum image).  ``atoms``
    restricts the spheres tested (every atom still blocks)."""
    dev = resolve_device(device)
    b, binv, pa, rad, _ = _first_frame(path, box, name, flag)
    R = rad + 0.5 * probe_sigma
    which = (np.arange(pa.shape[0]) if atoms is None
             else np.asarray(atoms, np.int64))
    return _asa_counts(b, binv, pa, R, unit_pts, which, dev), R[which]


def asa_area(path, name="*", flag="F", probe_sigma=0.0, unit_pts=None,
             box=None, device=None):
    """(area [Å²], cell volume [Å³], selected mass [amu]): Shrake-Rupley
    accessible surface area of the first frame, sum over atoms of
    4 pi R_i² × (accessible share of its points)."""
    dev = resolve_device(device)
    b, binv, pa, rad, mass = _first_frame(path, box, name, flag)
    R = rad + 0.5 * probe_sigma
    counts = _asa_counts(b, binv, pa, R, unit_pts, np.arange(pa.shape[0]),
                         dev)
    n_u = np.asarray(unit_pts).shape[0]
    area = 0.0
    for c, r in zip(counts, R):
        area += 4.0 * np.pi * r ** 2 * (int(c) / n_u)
    return area, abs(np.linalg.det(b)), mass


def sphere_points(n_sphere, seed=0):
    """[n_sphere, 3] unit vectors from numpy's default_rng(seed) normals
    (the reference's numpy route)."""
    v = np.random.default_rng(seed).normal(size=(int(n_sphere), 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def asa(path, name="*", flag="F", probe_sigma=0.0, n_sphere=512, seed=0,
        box=None, unit_pts=None, device=None):
    """Accessible surface area of a structure (first frame): {area_A2,
    area_m2_g (per selected mass), area_m2_cm3 (per cell volume),
    volume_A3, mass_amu}."""
    if unit_pts is None:
        unit_pts = sphere_points(n_sphere, seed)
    area, vol, mass = asa_area(path, name, flag, probe_sigma=probe_sigma,
                               unit_pts=unit_pts, box=box, device=device)
    # amu -> g: 1.66053906660e-24; A^2 -> m^2: 1e-20; A^3 -> cm^3: 1e-24
    m2_g = area * 1e-20 / (mass * 1.66053906660e-24) if mass > 0 \
        else float("nan")
    m2_cm3 = area / vol * 1e4 if vol > 0 else float("nan")
    return {"area_A2": area, "area_m2_g": m2_g, "area_m2_cm3": m2_cm3,
            "volume_A3": vol, "mass_amu": mass}


# ---------------------------------------------------------------------------
# host statistics (numpy)
# ---------------------------------------------------------------------------

def blocking(series):
    """Flyvbjerg-Petersen blocking analysis of a scalar MC series.

    Returns (block_sizes, sem, sem_err, tau_int): the standard error of
    the mean at doubling block sizes with its own one-sigma uncertainty
    sem/sqrt(2(n_blocks-1)), and tau_int = (sem_plateau/sem_1)^2 read at
    the largest level that still has >= 32 blocks (>= 8 for short
    series)."""
    x = np.asarray(series, np.float64).ravel()
    if x.size < 4:
        raise ValueError("blocking needs >= 4 samples")
    sizes, sems, errs = [], [], []
    block = 1
    while x.size >= 4:
        n = x.size
        var = x.var(ddof=1)
        sem = float(np.sqrt(var / n))
        sizes.append(block)
        sems.append(sem)
        errs.append(sem / np.sqrt(2.0 * (n - 1)))
        x = 0.5 * (x[0:2 * (n // 2):2] + x[1:2 * (n // 2):2])
        block *= 2
    sems = np.asarray(sems)
    n0 = len(np.asarray(series).ravel())
    eligible = ([i for i, b in enumerate(sizes) if n0 // b >= 32]
                or [i for i, b in enumerate(sizes) if n0 // b >= 8]
                or [len(sizes) - 1])
    plateau = max(eligible)
    tau = float((sems[plateau] / sems[0]) ** 2) if sems[0] > 0 else 1.0
    return (np.asarray(sizes), sems, np.asarray(errs), tau)


def qst(n_series, u_series, temperature, n_blocks=10):
    """Isosteric heat from stored (N, U) samples by the GCMC fluctuation
    formula Qst = kT - (<UN> - <U><N>) / (<N^2> - <N>^2) [K], with a
    leave-one-block-out jackknife error over ``n_blocks`` contiguous
    blocks.  Returns {qst, qst_sem, n_mean, n_sem (blocking), samples}."""
    n = np.asarray(n_series, np.float64).ravel()
    u = np.asarray(u_series, np.float64).ravel()
    if n.size != u.size:
        raise ValueError("N and U series must be the same length")
    if n.size < 2 * n_blocks:
        raise ValueError(f"need >= {2 * n_blocks} samples for "
                         f"{n_blocks}-block jackknife")
    if float(np.var(n)) == 0.0:
        raise ValueError("var(N) = 0 — not a GCMC series (fixed N?)")

    def ratio(nn, uu):
        return ((uu * nn).mean() - uu.mean() * nn.mean()) / \
            max(float((nn * nn).mean() - nn.mean() ** 2), 1e-300)

    q_full = temperature - ratio(n, u)
    edges = np.linspace(0, n.size, n_blocks + 1).astype(int)
    loo = []
    for k in range(n_blocks):
        keep = np.r_[0:edges[k], edges[k + 1]:n.size]
        loo.append(temperature - ratio(n[keep], u[keep]))
    loo = np.asarray(loo)
    q_sem = float(np.sqrt((n_blocks - 1) / n_blocks
                          * np.sum((loo - loo.mean()) ** 2)))
    _, sems, _, tau = blocking(n)
    return {"qst": float(q_full), "qst_sem": q_sem,
            "n_mean": float(n.mean()),
            "n_sem": float(sems[0] * np.sqrt(tau)),
            "samples": int(n.size)}


def qst_clausius_clapeyron(p1, q1, t1, p2, q2, t2, n_loadings=20):
    """Qst(loading) [K] from two isotherms at T1 != T2 (Clausius-
    Clapeyron at equal loading: -ln(P2/P1) / (1/T2 - 1/T1)), each
    interpolated in (loading, ln P) over the overlap of their loading
    ranges.  Returns (loadings, qst_K)."""
    p1 = np.asarray(p1, np.float64).ravel()
    q1 = np.asarray(q1, np.float64).ravel()
    p2 = np.asarray(p2, np.float64).ravel()
    q2 = np.asarray(q2, np.float64).ravel()
    if t1 == t2:
        raise ValueError("isotherms must differ in temperature")
    for p, q in ((p1, q1), (p2, q2)):
        if p.size != q.size or p.size < 2:
            raise ValueError("each isotherm needs >= 2 (P, loading) "
                             "points")
        if np.any(p <= 0):
            raise ValueError("pressures must be > 0")
        if np.any(np.diff(q) <= 0):
            raise ValueError("loadings must be strictly increasing "
                             "with P (sort / de-noise first)")
    lo = max(q1.min(), q2.min())
    hi = min(q1.max(), q2.max())
    if not hi > lo:
        raise ValueError("isotherm loading ranges do not overlap")
    theta = np.linspace(lo, hi, int(n_loadings))
    lnp1 = np.interp(theta, q1, np.log(p1))
    lnp2 = np.interp(theta, q2, np.log(p2))
    return theta, -(lnp2 - lnp1) / (1.0 / t2 - 1.0 / t1)


_ISO_MODELS = {
    # loading(P; params) — P in the user's pressure unit, params > 0
    "langmuir": (("qm", "k"),
                 lambda p, qm, k: qm * k * p / (1.0 + k * p)),
    "dsl": (("qm1", "k1", "qm2", "k2"),
            lambda p, qm1, k1, qm2, k2: qm1 * k1 * p / (1.0 + k1 * p)
            + qm2 * k2 * p / (1.0 + k2 * p)),
    "toth": (("qm", "k", "t"),
             lambda p, qm, k, t: qm * k * p
             / (1.0 + (k * p) ** t) ** (1.0 / t)),
}


def isotherm_fit(pressures, loadings, model="langmuir", sem=None):
    """Fit langmuir (q = qm K P / (1 + K P)), dsl (two Langmuir sites) or
    toth (q = qm K P / (1 + (K P)^t)^(1/t)) to (P, loading) points, every
    parameter positive (fit in log space), residuals weighted by 1/sem
    when ``sem`` is given.  Returns {model, params, rmse, henry (dq/dP at
    P -> 0), converged}."""
    from scipy.optimize import least_squares
    p = np.asarray(pressures, np.float64).ravel()
    y = np.asarray(loadings, np.float64).ravel()
    if p.size != y.size or p.size < 2:
        raise ValueError("need matching P/loading arrays, >= 2 points")
    if np.any(p <= 0):
        raise ValueError("pressures must be > 0")
    if model not in _ISO_MODELS:
        raise ValueError(f"unknown model {model!r}; "
                         f"choose from {sorted(_ISO_MODELS)}")
    names, fn = _ISO_MODELS[model]
    if p.size < len(names):
        raise ValueError(f"{model} needs >= {len(names)} points")
    w = np.ones_like(y)
    if sem is not None:
        s = np.asarray(sem, np.float64).ravel()
        if not np.all(np.isfinite(s)) or np.any(s <= 0):
            raise ValueError(
                "sem column has non-finite or non-positive entries "
                "(single-chain campaigns write inf) — fix them or fit "
                "unweighted (omit the sem column)")
        w = 1.0 / np.maximum(s, 1e-12)
    qm0 = max(float(y.max()) * 1.5, 1e-6)
    k0 = 1.0 / float(np.median(p))
    starts = {"langmuir": [qm0, k0], "toth": [qm0, k0, 0.7],
              "dsl": [qm0 * 0.6, k0 * 3.0, qm0 * 0.6, k0 / 3.0]}[model]

    def resid(logx):
        return w * (fn(p, *np.exp(logx)) - y)

    fit = least_squares(resid, np.log(np.asarray(starts)), method="lm",
                        max_nfev=20000)
    prm = np.exp(fit.x)
    pred = fn(p, *prm)
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    henry = prm[0] * prm[1]
    if model == "dsl":
        henry += prm[2] * prm[3]
    return {"model": model, "params": dict(zip(names, prm.tolist())),
            "rmse": rmse, "henry": float(henry),
            "converged": bool(fit.success)}


def _spreading_pressure(model, params, p):
    """Reduced spreading pressure pi(p) = integral_0^p q(p')/p' dp' of a
    fitted isotherm (closed form for langmuir and dsl)."""
    if p <= 0:
        return 0.0
    if model == "langmuir":
        return params["qm"] * np.log1p(params["k"] * p)
    if model == "dsl":
        return (params["qm1"] * np.log1p(params["k1"] * p)
                + params["qm2"] * np.log1p(params["k2"] * p))
    from scipy.integrate import quad
    names, fn = _ISO_MODELS[model]
    prm = [params[k] for k in names]
    val, _ = quad(lambda x: fn(x, *prm) / x, 0.0, p, limit=200)
    return float(val)


def iast_binary(fit1, fit2, y1, p_total):
    """Binary IAST (Myers & Prausnitz 1965) from two fitted pure
    isotherms (isotherm_fit outputs) at gas mole fraction ``y1`` and
    total pressure ``p_total``: pi_1(P y1/x1) = pi_2(P y2/x2) solved for
    x1 by bisection, 1/q_T = x1/q1° + x2/q2°.  Returns {x1, q1, q2,
    q_total, selectivity (x1/x2)/(y1/y2)}."""
    if not 0.0 < y1 < 1.0:
        raise ValueError("y1 must be in (0, 1)")
    if p_total <= 0:
        raise ValueError("p_total must be > 0")
    y2 = 1.0 - y1
    m1, pr1 = fit1["model"], fit1["params"]
    m2, pr2 = fit2["model"], fit2["params"]
    names1, fn1 = _ISO_MODELS[m1]
    names2, fn2 = _ISO_MODELS[m2]

    def diff(x1):
        return (_spreading_pressure(m1, pr1, p_total * y1 / x1)
                - _spreading_pressure(m2, pr2,
                                      p_total * y2 / (1.0 - x1)))

    # diff is monotone decreasing in x1: bisect on (0, 1)
    lo, hi = 1e-12, 1.0 - 1e-12
    flo, fhi = diff(lo), diff(hi)
    if not (flo > 0 > fhi or flo < 0 < fhi):
        raise ValueError("IAST bisection bracket failed (degenerate "
                         "isotherms?)")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        fm = diff(mid)
        if (fm > 0) == (flo > 0):
            lo, flo = mid, fm
        else:
            hi, fhi = mid, fm
    x1 = 0.5 * (lo + hi)
    x2 = 1.0 - x1
    q1_0 = fn1(p_total * y1 / x1, *[pr1[k] for k in names1])
    q2_0 = fn2(p_total * y2 / x2, *[pr2[k] for k in names2])
    q_t = 1.0 / (x1 / q1_0 + x2 / q2_0)
    return {"x1": float(x1), "q1": float(x1 * q_t),
            "q2": float(x2 * q_t), "q_total": float(q_t),
            "selectivity": float((x1 / x2) / (y1 / y2))}


def _read_series(path, column):
    """A scalar column from an energy CSV (header row) or a JSONL
    observable stream."""
    vals = []
    with open(path) as f:
        first = f.readline()
        if first.lstrip().startswith("{"):
            for line in [first] + f.readlines():
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if column in rec:
                    vals.append(float(rec[column]))
        else:
            cols = [c.strip() for c in first.strip().split(",")]
            if column not in cols:
                raise ValueError(f"column {column!r} not in {cols}")
            k = cols.index(column)
            for line in f:
                t = line.strip().split(",")
                if len(t) > k and t[k]:
                    vals.append(float(t[k]))
    if not vals:
        raise ValueError(f"no values for column {column!r} in {path}")
    return np.asarray(vals)


# ---------------------------------------------------------------------------
# MBAR (numpy)
# ---------------------------------------------------------------------------

def _logsumexp(a, axis=None):
    """log(sum(exp(a))) along axis, max-shifted for stability."""
    a = np.asarray(a, np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None \
        else float(out.reshape(()))


def _mbar_core(u_kn, n_k, tol=1e-10, max_iter=50000):
    """Self-consistent MBAR (Shirts & Chodera 2008, eqs. 11-13) over a
    reduced-potential matrix ``u_kn`` [K states, Ntot pooled samples].
    Returns (f [K] with f[0] = 0, log_denom [Ntot], converged, iters)."""
    u_kn = np.asarray(u_kn, np.float64)
    n_k = np.asarray(n_k, np.float64).ravel()
    log_n = np.log(n_k)
    f = np.zeros(u_kn.shape[0])
    delta = np.inf
    for it in range(max_iter):
        log_denom = _logsumexp((log_n + f)[:, None] - u_kn, axis=0)
        f_new = -_logsumexp(-u_kn - log_denom[None, :], axis=1)
        f_new = f_new - f_new[0]
        delta = float(np.max(np.abs(f_new - f)))
        f = f_new
        if delta < tol:
            break
    log_denom = _logsumexp((log_n + f)[:, None] - u_kn, axis=0)
    return f, log_denom, delta < tol, it + 1


def mbar_fit(betas, u_by_state, tol=1e-10, max_iter=50000):
    """MBAR over K canonical states at inverse temperatures ``betas`` from
    potential-energy samples ``u_by_state`` (K arrays, U in K; a
    temperature-independent potential, so not FH/FK ladders).  Returns
    the dict mbar_reweight reads: f (f[0] = 0), the pooled samples and
    their log-denominators."""
    betas = np.asarray(betas, np.float64).ravel()
    u_list = [np.asarray(u, np.float64).ravel() for u in u_by_state]
    if len(u_list) != betas.size:
        raise ValueError("betas and u_by_state lengths differ")
    if any(len(u) == 0 for u in u_list):
        raise ValueError("every state needs at least one sample")
    n_k = np.array([len(u) for u in u_list], np.float64)
    u_all = np.concatenate(u_list)
    bu = betas[:, None] * u_all[None, :]
    f, log_denom, converged, its = _mbar_core(bu, n_k, tol=tol,
                                              max_iter=max_iter)
    return {"betas": betas, "f": f, "u_all": u_all,
            "log_denom": log_denom, "n_k": n_k,
            "converged": converged, "iterations": its}


def mbar_reweight(fit, beta, a_vals=None):
    """MBAR samples reweighted to inverse temperature ``beta``: {u_mean,
    u_var, a_mean (with ``a_vals`` aligned to fit['u_all']), ess (Kish),
    logZ}."""
    u = fit["u_all"]
    logw = -float(beta) * u - fit["log_denom"]
    lz = _logsumexp(logw)
    w = np.exp(logw - lz)
    u_mean = float(np.sum(w * u))
    out = {"u_mean": u_mean,
           "u_var": float(np.sum(w * (u - u_mean) ** 2)),
           "ess": float(1.0 / np.sum(w * w)), "logZ": lz}
    if a_vals is not None:
        out["a_mean"] = float(np.sum(w * np.asarray(a_vals,
                                                    np.float64).ravel()))
    return out


def _read_ladder(path):
    """(temps [B,K], energy [B,K], n [B,K], fug [B,K] or None) from the PT
    ladder records of a JSONL stream (io/output.py::log_ladder); fug only
    for fixed-T fugacity ladders."""
    temps, us, ns, fs = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "pt_temps" not in rec:
                continue
            temps.append(rec["pt_temps"])
            us.append(rec["pt_energy"])
            ns.append(rec.get("pt_N", [0.0] * len(rec["pt_temps"])))
            if "pt_fug" in rec:
                fs.append(rec["pt_fug"])
    if not temps:
        raise ValueError(f"no pt_temps ladder records in {path} "
                         "(run the PT driver with --jsonl)")
    if fs and len(fs) != len(temps):
        raise ValueError(f"{path}: only some ladder records carry "
                         "pt_fug — mixed-run stream?")
    return (np.asarray(temps, np.float64), np.asarray(us, np.float64),
            np.asarray(ns, np.float64),
            np.asarray(fs, np.float64) if fs else None)


def pt_mbar(jsonl_path, t_grid=None, skip=0.0, n_t=50):
    """Continuous-temperature curves from one NVT parallel-tempering run:
    the ladder records grouped by the temperature they were recorded at,
    K-state MBAR, reweighted to ``t_grid`` (default n_t points over the
    ladder).  Returns {t_grid, u_mean, cv_kb ((<U²>-<U>²)/T²), n_mean,
    ess, ladder_t, delta_f, converged, samples_per_state}."""
    temps, us, ns, fugs = _read_ladder(jsonl_path)
    if fugs is not None:
        raise ValueError("this stream is a fixed-T fugacity-ladder run "
                         "(pt_fug records) — use pt_gcmc_mbar / the "
                         "gcmc-mbar --ladder CLI")
    b0 = int(min(max(skip, 0.0), 0.9) * temps.shape[0])
    temps, us, ns = temps[b0:], us[b0:], ns[b0:]
    ladder = np.unique(np.round(temps.ravel(), 9))
    if ladder.size > temps.shape[1]:
        raise ValueError("ladder temperatures drift across blocks — "
                         "annealing runs cannot be reweighted")
    u_by, n_by = [], []
    for t in ladder:
        sel = np.abs(temps - t) < 1e-8
        u_by.append(us[sel])
        n_by.append(ns[sel])
    fit = mbar_fit(1.0 / ladder, u_by)
    n_all = np.concatenate(n_by)
    if t_grid is None:
        t_grid = np.linspace(ladder[0], ladder[-1], int(n_t))
    t_grid = np.asarray(t_grid, np.float64).ravel()
    u_mean = np.empty_like(t_grid)
    cv = np.empty_like(t_grid)
    n_mean = np.empty_like(t_grid)
    ess = np.empty_like(t_grid)
    for i, t in enumerate(t_grid):
        r = mbar_reweight(fit, 1.0 / t, a_vals=n_all)
        u_mean[i] = r["u_mean"]
        cv[i] = r["u_var"] / (t * t)
        n_mean[i] = r["a_mean"]
        ess[i] = r["ess"]
    return {"t_grid": t_grid, "u_mean": u_mean, "cv_kb": cv,
            "n_mean": n_mean, "ess": ess, "ladder_t": ladder,
            "delta_f": fit["f"], "converged": fit["converged"],
            "samples_per_state": fit["n_k"].astype(int).tolist()}


def _gc_curves(temperature, u_all, nt_all, log_denom, f_grid, y=None,
               ns_all=None):
    """Grand-canonical reweighting over a total-fugacity grid: target
    reduced potential beta U - sum_s N_s ln(y_s F) (one sorbate with N =
    nt_all when y / ns_all are omitted).  Returns per grid point n_mean,
    u_mean, var_n, the fluctuation qst [kJ/mol], ess and (with ns_all)
    per-species loadings."""
    beta = 1.0 / float(temperature)
    f_grid = np.asarray(f_grid, np.float64).ravel()
    n_mean = np.empty_like(f_grid)
    u_mean = np.empty_like(f_grid)
    var_n = np.empty_like(f_grid)
    qst_ = np.empty_like(f_grid)
    ess = np.empty_like(f_grid)
    per_species = (np.empty((ns_all.shape[0], f_grid.size))
                   if ns_all is not None else None)
    for i, ft in enumerate(f_grid):
        if ns_all is not None and y is not None:
            u_t = beta * u_all - np.log(y * ft) @ ns_all
        else:
            u_t = beta * u_all - np.log(ft) * nt_all
        logw = -u_t - log_denom
        logw -= _logsumexp(logw)
        w = np.exp(logw)
        nm_ = float(np.sum(w * nt_all))
        um_ = float(np.sum(w * u_all))
        vn_ = float(np.sum(w * (nt_all - nm_) ** 2))
        cov = float(np.sum(w * (u_all - um_) * (nt_all - nm_)))
        n_mean[i], u_mean[i], var_n[i] = nm_, um_, vn_
        qst_[i] = ((temperature - cov / vn_) * 8.314462618e-3
                   if vn_ > 0 else float("nan"))
        ess[i] = float(1.0 / np.sum(w * w))
        if per_species is not None:
            for s_i in range(ns_all.shape[0]):
                per_species[s_i, i] = float(np.sum(w * ns_all[s_i]))
    return {"n_mean": n_mean, "u_mean": u_mean, "var_n": var_n,
            "qst_kj_mol": qst_, "ess": ess, "per_species": per_species}


def pt_gcmc_mbar(jsonl_path, f_grid=None, skip=0.0, n_f=50):
    """Continuous-pressure isotherm and Qst(f) from one fixed-T
    fugacity-ladder PT run: grand-canonical MBAR over the rungs (u_k =
    beta U - N ln f_k), reweighted to ``f_grid`` (default n_f geometric
    points over the ladder).  Returns {f_grid, n_mean, u_mean, var_n,
    qst_kj_mol, ess, ladder_f, delta_f, converged, iterations,
    samples_per_state, temperature}."""
    temps, us, ns, fugs = _read_ladder(jsonl_path)
    if fugs is None:
        raise ValueError(f"{jsonl_path}: no pt_fug ladder records — "
                         "this is not a pt_fugacity run (temperature "
                         "ladders reweight with pt_mbar)")
    t0_ = temps.ravel()
    if np.max(np.abs(t0_ - t0_[0])) > 1e-9 * abs(t0_[0]):
        raise ValueError("fugacity-ladder records carry varying "
                         "temperatures — cannot reweight")
    temperature = float(t0_[0])
    b0 = int(min(max(skip, 0.0), 0.9) * fugs.shape[0])
    us, ns, fugs = us[b0:], ns[b0:], fugs[b0:]
    ladder = np.unique(np.round(fugs.ravel(), 12))
    if ladder.size > fugs.shape[1]:
        raise ValueError("ladder fugacities drift across blocks — "
                         "cannot group samples by rung")
    u_by, n_by = [], []
    for fv in ladder:
        sel = np.abs(fugs - fv) < 1e-10 * max(fv, 1.0)
        u_by.append(us[sel])
        n_by.append(ns[sel])
    beta = 1.0 / temperature
    u_all = np.concatenate(u_by)
    n_all = np.concatenate(n_by)
    n_k = np.asarray([len(u) for u in u_by], np.float64)
    u_kn = (beta * u_all[None, :]
            - np.log(ladder)[:, None] * n_all[None, :])
    f, log_denom, converged, its = _mbar_core(u_kn, n_k)
    if f_grid is None:
        f_grid = np.geomspace(ladder[0], ladder[-1], int(n_f))
    f_grid = np.asarray(f_grid, np.float64).ravel()
    curves = _gc_curves(temperature, u_all, n_all, log_denom, f_grid)
    return {"f_grid": f_grid, "n_mean": curves["n_mean"],
            "u_mean": curves["u_mean"], "var_n": curves["var_n"],
            "qst_kj_mol": curves["qst_kj_mol"], "ess": curves["ess"],
            "ladder_f": ladder, "delta_f": f, "converged": converged,
            "iterations": its,
            "samples_per_state": n_k.astype(int).tolist(),
            "temperature": temperature}


def _read_gc_run(path):
    """(run_meta, U [n], N [n], {species: N_s [n]}) of one GCMC run's
    JSONL stream (io/output.py::log_meta header, per-corrtime records)."""
    meta = None
    us, ns = [], []
    nsp = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "run_meta" in rec:
                meta = rec["run_meta"]
                continue
            if "pt_temps" in rec:
                continue
            if "energy_total" in rec and "N" in rec:
                us.append(float(rec["energy_total"]))
                ns.append(float(rec["N"]))
                for k, v in rec.items():
                    if k.startswith("N_"):
                        nsp.setdefault(k[2:], []).append(float(v))
    if meta is None:
        raise ValueError(
            f"{path}: no run_meta header record — re-run with --jsonl "
            "(io/output.py writes the header), or pass states explicitly "
            "via gcmc_mbar(..., fugacities=)")
    if not us:
        raise ValueError(f"{path}: no observable block records")
    return (meta, np.asarray(us, np.float64), np.asarray(ns, np.float64),
            {k: np.asarray(v, np.float64) for k, v in nsp.items()})


def gcmc_mbar(paths, skip=0.0, f_grid=None, n_f=50, fugacities=None,
              temperature=None):
    """Continuous-fugacity isotherm from K GCMC runs at one temperature
    (a campaign's point streams, or separate runs) by grand-canonical
    MBAR: u_k(x) = beta U(x) - sum_s N_s(x) ln f_ks, mixtures along the
    first run's composition ray.  States come from each stream's
    run_meta (override with ``fugacities`` [K][S] and ``temperature``);
    ``skip`` drops an equilibration fraction of each run.  Returns
    {f_grid, n_mean, u_mean, var_n, qst_kj_mol, ess, n_species,
    ladder_f, delta_f, converged, iterations, samples_per_state,
    temperature, composition, composition_matched}."""
    if len(paths) < 2:
        raise ValueError("gcmc_mbar needs >= 2 runs (states) to bridge")
    runs = [_read_gc_run(p) for p in paths]
    metas = [r[0] for r in runs]
    if temperature is None:
        temps = [m.get("temperature") for m in metas]
        if any(t is None for t in temps):
            raise ValueError("a run_meta lacks temperature — pass "
                             "temperature= explicitly")
        temperature = float(temps[0])
        if max(abs(t - temperature) for t in temps) > 1e-6 * temperature:
            raise ValueError(f"runs are at different temperatures "
                             f"{temps} — GC reweighting needs one T "
                             "(use pt_mbar for T ladders)")
    for m in metas:
        if m.get("ensemble", "uvt") != "uvt":
            raise ValueError(f"ensemble {m.get('ensemble')!r} run in "
                             "the input — gcmc_mbar reweights uVT runs")
    beta = 1.0 / float(temperature)
    species = metas[0].get("species", [])
    if fugacities is not None:
        fug = np.asarray(fugacities, np.float64)
        if fug.ndim == 1:
            fug = fug[:, None]
        if not species:
            species = [f"sp{j}" for j in range(fug.shape[1])]
    else:
        try:
            fug = np.asarray([m["fugacities"] for m in metas],
                             np.float64)
        except KeyError:
            raise ValueError("a run_meta lacks fugacities — pass "
                             "fugacities= explicitly")
        for m in metas:
            if m.get("species", species) != species:
                raise ValueError("runs have different species lists")
    sorb = [j for j in range(fug.shape[1]) if fug[:, j].max() > 0.0]
    if not sorb:
        raise ValueError("no species has a nonzero fugacity")
    u_parts, n_parts = [], []
    nsp_parts = {species[j]: [] for j in sorb}
    n_k = []
    for meta, us, ns, nsp in runs:
        k0 = int(min(max(skip, 0.0), 0.9) * len(us))
        us, ns = us[k0:], ns[k0:]
        u_parts.append(us)
        n_parts.append(ns)
        n_k.append(len(us))
        for j in sorb:
            nm = species[j]
            if nm in nsp:
                nsp_parts[nm].append(np.asarray(nsp[nm][k0:]))
            elif len(sorb) == 1:
                nsp_parts[nm].append(ns)
            else:
                raise ValueError(f"run lacks per-species N_{nm} "
                                 "records needed for a mixture")
    u_all = np.concatenate(u_parts)
    ns_cand = {species[j]: np.concatenate(nsp_parts[species[j]])
               for j in sorb}
    # a constant N_s (a frozen framework listed with f = P) only adds a
    # state constant to u_kn but would shift the grand potentials
    sorb = [j for j in sorb if ns_cand[species[j]].var() > 0.0]
    if not sorb:
        raise ValueError("no sorbate's loading varies across the "
                         "pooled samples — nothing to reweight")
    if (fug[:, sorb] <= 0.0).any():
        raise ValueError("a sorbate has fugacity 0 in one run — that "
                         "state forbids the others' samples (ln f "
                         "diverges); drop the run or the species")
    ns_all = np.stack([ns_cand[species[j]] for j in sorb])   # [S, Ntot]
    n_k = np.asarray(n_k, np.float64)
    lnf = np.log(fug[:, sorb])                    # [K, S]
    u_kn = beta * u_all[None, :] - lnf @ ns_all   # [K, Ntot]
    f, log_denom, converged, its = _mbar_core(u_kn, n_k)
    f_tot_ladder = fug[:, sorb].sum(axis=1)
    y = fug[0, sorb] / f_tot_ladder[0]
    comp = fug[:, sorb] / f_tot_ladder[:, None]
    comp_ok = bool(np.max(np.abs(comp - y[None, :])) < 1e-6)
    if f_grid is None:
        f_grid = np.geomspace(f_tot_ladder.min(), f_tot_ladder.max(),
                              int(n_f))
    f_grid = np.asarray(f_grid, np.float64).ravel()
    nt_all = ns_all.sum(axis=0)
    curves = _gc_curves(float(temperature), u_all, nt_all, log_denom,
                        f_grid, y=y, ns_all=ns_all)
    n_species = {species[j]: curves["per_species"][s_i]
                 for s_i, j in enumerate(sorb)}
    return {"f_grid": f_grid, "n_mean": curves["n_mean"],
            "u_mean": curves["u_mean"], "var_n": curves["var_n"],
            "qst_kj_mol": curves["qst_kj_mol"], "ess": curves["ess"],
            "n_species": n_species, "ladder_f": f_tot_ladder,
            "delta_f": f, "converged": converged, "iterations": its,
            "samples_per_state": n_k.astype(int).tolist(),
            "temperature": float(temperature),
            "composition": {species[j]: float(y[s_i])
                            for s_i, j in enumerate(sorb)},
            "composition_matched": comp_ok}


# ---------------------------------------------------------------------------
# transition-matrix Monte Carlo (numpy)
# ---------------------------------------------------------------------------

def tmmc_lnpi(c):
    """Macrostate log-probabilities lnΠ(N) from a TMMC collection matrix
    ``c`` [K, 4] (n_ins, Σa_ins, n_del, Σa_del per N).

    Detailed balance gives lnΠ(N+1) - lnΠ(N) = ln ā_ins(N) - ln
    ā_del(N+1), ā the mean acceptance probability of the attempts from
    N (insert and delete are proposed with equal probability, so the
    selection cancels).  On the ideal gas the links are exact after any
    number of steps.  Under the polar delayed acceptance an entry is the
    estimator 1{stage-1 accept} min(1, a2), exact only in expectation.
    The links are followed over one contiguous window where both have
    data; outside it lnΠ is NaN.  Of several disconnected windows (summed
    matrices of independent runs) the one with the most attempts is
    followed, with a warning.  Returns lnΠ normalized to max 0; raises
    ValueError without any link."""
    c = np.asarray(c, np.float64)
    a_up = np.where(c[:, 0] > 0, c[:, 1] / np.maximum(c[:, 0], 1.0), 0.0)
    a_dn = np.where(c[:, 2] > 0, c[:, 3] / np.maximum(c[:, 2], 1.0), 0.0)
    K = c.shape[0]
    lnpi = np.full(K, np.nan)
    linked = [a_up[i] > 0 and a_dn[i + 1] > 0 for i in range(K - 1)]
    if not any(linked):
        raise ValueError("collection matrix has no connected N→N+1 link "
                         "(no insert/delete statistics yet)")
    frags, i = [], 0              # maximal runs of links: rows i..j
    while i < K - 1:
        if linked[i]:
            j = i
            while j < K - 1 and linked[j]:
                j += 1
            frags.append((i, j))
            i = j
        i += 1
    if len(frags) > 1:
        warnings.warn(
            f"TMMC collection has {len(frags)} disconnected N-windows "
            f"({', '.join(f'{a}..{b}' for a, b in frags)}); following the "
            "best-sampled one — extend runs to bridge the gaps",
            stacklevel=2)
    i0, i1 = max(frags, key=lambda ab: c[ab[0]:ab[1] + 1, [0, 2]].sum())
    lnpi[i0] = 0.0
    for i in range(i0, i1):
        lnpi[i + 1] = lnpi[i] + np.log(a_up[i]) - np.log(a_dn[i + 1])
    return lnpi - np.nanmax(lnpi)


def tmmc_eta(c):
    """Flat-histogram bias η(N) = -lnΠ(N) of ``tmmc_bias``, the rows
    outside the resolved window set to the nearest resolved value; None
    while no link is resolved."""
    try:
        lnpi = tmmc_lnpi(c)
    except ValueError:
        return None
    eta = -lnpi
    idx = np.flatnonzero(np.isfinite(eta))
    eta[:idx[0]] = eta[idx[0]]
    eta[idx[-1] + 1:] = eta[idx[-1]]
    return np.nan_to_num(eta, nan=float(np.nanmax(eta)))


def tmmc_reweight(lnpi, f_sim, f_target):
    """(⟨N⟩, var N, edge mass) of the macrostate distribution reweighted
    from the sampled fugacity ``f_sim`` to ``f_target``: lnΠ'(N) = lnΠ(N)
    + N ln(f_target / f_sim).  The edge mass is the probability on the two
    outermost resolved macrostates (large: the target leaks out of the
    sampled window)."""
    lnpi = np.asarray(lnpi, np.float64)
    ok = np.isfinite(lnpi)
    n = np.flatnonzero(ok).astype(np.float64)
    w = lnpi[ok] + n * (np.log(f_target) - np.log(f_sim))
    w -= w.max()
    p = np.exp(w)
    p /= p.sum()
    mean = float((n * p).sum())
    var = float((((n - mean) ** 2) * p).sum())
    return mean, var, float(p[0] + p[-1])


def tmmc_load(paths):
    """(summed matrix, the first file's metadata) of same-state TMMC files
    (write_tmmc); files at another temperature, fugacity or volume, or of
    another size, raise ValueError."""
    metas, cs = [], []
    for p in paths:
        with open(p) as f:
            rec = json.load(f)
        if rec.get("format") != "mpmc_tpu.tmmc.v1":
            raise ValueError(f"{p}: not a mpmc_tpu tmmc file")
        metas.append(rec)
        cs.append(np.asarray(rec["c"], np.float64))
    m0 = metas[0]
    for p, m in zip(paths[1:], metas[1:]):
        for k in ("temperature", "fugacities_atm", "volume_a3",
                  "f_sim_atm"):
            if k not in m0:
                continue
            if not np.allclose(m.get(k, m0[k]), m0[k], rtol=1e-10):
                raise ValueError(
                    f"{p}: {k}={m[k]} differs from {paths[0]}'s "
                    f"{m0[k]} — collection matrices only sum at the "
                    "same thermodynamic state")
        if m["c"] and len(m["c"]) != len(m0["c"]):
            raise ValueError(f"{p}: matrix size mismatch")
    return sum(cs), m0


def tmmc_isotherm(c, f_sim, f_targets):
    """[(f, ⟨N⟩, var N, edge mass)] at each target fugacity, from one
    collection matrix."""
    lnpi = tmmc_lnpi(c)
    return [(float(f),) + tmmc_reweight(lnpi, f_sim, f)
            for f in f_targets]


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def _write_csv(path, header, rows):
    out = sys.stdout if path == "-" else open(path, "w")
    try:
        out.write(header + "\n")
        for row in rows:
            out.write(",".join(str(v) for v in row) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m mpmc_tpu_torch.analyze",
        description="analysis of a run's outputs: PQR trajectories "
                    "(frame subcommands, on the CUDA device unless "
                    "--cpu), energy CSV / JSONL streams, TMMC matrices")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("rdf", help="radial distribution function")
    pr.add_argument("traj")
    pr.add_argument("--a", default="*", help="atom name selection A")
    pr.add_argument("--b", default="*", help="atom name selection B")
    pr.add_argument("--flag-a", default="*", choices=["*", "M", "F"])
    pr.add_argument("--flag-b", default="*", choices=["*", "M", "F"])
    pr.add_argument("--rmax", type=float, default=10.0)
    pr.add_argument("--bins", type=int, default=200)
    pr.add_argument("--out", default="-", help="CSV path (default stdout)")
    pd = sub.add_parser("density", help="sorbate COM density -> OpenDX")
    pd.add_argument("traj")
    pd.add_argument("--mol", default="*", help="molecule name selection")
    pd.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pd.add_argument("--resolution", type=float, default=0.7,
                    help="target bin edge length (A)")
    pd.add_argument("--out", required=True, help=".dx output path")
    pm = sub.add_parser("msd", help="COM mean-square displacement")
    pm.add_argument("traj")
    pm.add_argument("--mol", default="*", help="molecule name selection")
    pm.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pm.add_argument("--max-lag", type=int, default=0,
                    help="largest frame lag (default: n_frames-1)")
    pm.add_argument("--out", default="-", help="CSV path (default stdout)")
    pl = sub.add_parser("loading", help="per-frame molecule counts")
    pl.add_argument("traj")
    pl.add_argument("--mol", default="*", help="molecule name selection")
    pl.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pl.add_argument("--out", default="-", help="CSV path (default stdout)")
    pcl = sub.add_parser("cluster",
                         help="sorbate COM cluster statistics per frame "
                              "(connected components under a min-image "
                              "cutoff)")
    pcl.add_argument("traj")
    pcl.add_argument("--mol", default="*", help="molecule name selection")
    pcl.add_argument("--flag", default="M", choices=["*", "M", "F"])
    pcl.add_argument("--rc", type=float, default=4.0,
                     help="COM bonding cutoff (A)")
    pcl.add_argument("--max-size", type=int, default=64,
                     help="histogram bins (size >= max-size pools in the "
                          "last bin)")
    pcl.add_argument("--out", default="-", help="CSV path (default stdout)")
    pb = sub.add_parser("blocking",
                        help="Flyvbjerg-Petersen error analysis of an "
                             "energy-CSV / JSONL observable column")
    pb.add_argument("series", help="energy CSV or --jsonl stream path")
    pb.add_argument("--column", default="energy_total")
    pb.add_argument("--out", default="-", help="CSV path (default stdout)")
    po = sub.add_parser("orient",
                        help="orientational autocorrelation C1/C2 of "
                             "molecular axes")
    po.add_argument("traj")
    po.add_argument("--mol", default="*", help="molecule name selection")
    po.add_argument("--flag", default="M", choices=["*", "M", "F"])
    po.add_argument("--axis", default="*",
                    help="atom-name pattern: axis = first two matching "
                         "atoms per molecule")
    po.add_argument("--max-lag", type=int, default=0,
                    help="largest frame lag (default: n_frames-1)")
    po.add_argument("--out", default="-", help="CSV path (default stdout)")
    ps = sub.add_parser("sq", help="Debye static structure factor S(q)")
    ps.add_argument("traj")
    ps.add_argument("--a", default="*", help="atom name selection")
    ps.add_argument("--flag", default="*", choices=["*", "M", "F"])
    ps.add_argument("--qmin", type=float, default=0.2, help="1/A")
    ps.add_argument("--qmax", type=float, default=12.0, help="1/A")
    ps.add_argument("--nq", type=int, default=200)
    ps.add_argument("--dr-bin", type=float, default=0.005,
                    help="internal pair-distance bin width (A)")
    ps.add_argument("--out", default="-", help="CSV path (default stdout)")
    pq = sub.add_parser("qst",
                        help="isosteric heat from a stored (N, U) "
                             "corrtime series (fluctuation formula)")
    pq.add_argument("series", help="energy CSV or JSONL stream path")
    pq.add_argument("--temperature", "-T", type=float, required=True)
    pq.add_argument("--n-column", default="N")
    pq.add_argument("--u-column", default="energy_total")
    pq.add_argument("--skip", type=float, default=0.0,
                    help="equilibration fraction to drop (0-0.9)")
    pq.add_argument("--blocks", type=int, default=10,
                    help="jackknife block count")
    pc = sub.add_parser("qst-cc",
                        help="Qst(loading) from two isotherm CSVs at "
                             "different temperatures (Clausius-Clapeyron)")
    pc.add_argument("csv1")
    pc.add_argument("csv2")
    pc.add_argument("--t1", type=float, required=True)
    pc.add_argument("--t2", type=float, required=True)
    pc.add_argument("--p-column", default="pressure_atm")
    pc.add_argument("--q-column", default="n_mean")
    pc.add_argument("--n-loadings", type=int, default=20)
    pc.add_argument("--out", default="-", help="CSV path (default stdout)")
    pi = sub.add_parser("isofit",
                        help="fit an isotherm model to P,loading points")
    pi.add_argument("csv", help="CSV with pressure + loading columns "
                                "(campaign output works directly)")
    pi.add_argument("--model", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pi.add_argument("--p-column", default="pressure_atm",
                    help="the campaign's write_csv column names are the "
                         "defaults")
    pi.add_argument("--q-column", default="n_mean")
    pi.add_argument("--sem-column", default="",
                    help="optional per-point 1-sigma column for weighted "
                         "residuals (campaign: n_sem)")
    pa = sub.add_parser("iast",
                        help="binary IAST mixture prediction from two "
                             "pure-component isotherm CSVs")
    pa.add_argument("csv1", help="pure isotherm of component 1")
    pa.add_argument("csv2", help="pure isotherm of component 2")
    pa.add_argument("--y1", type=float, required=True,
                    help="gas-phase mole fraction of component 1")
    pa.add_argument("--pressures", type=float, nargs="+", required=True,
                    help="total pressures to predict at")
    pa.add_argument("--model1", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pa.add_argument("--model2", default="langmuir",
                    choices=sorted(_ISO_MODELS))
    pa.add_argument("--p-column", default="pressure_atm")
    pa.add_argument("--q-column", default="n_mean")
    pa.add_argument("--out", default="-", help="CSV path (default stdout)")
    pw = sub.add_parser("widom", help="Widom test-particle insertion "
                                      "(single LJ site, or a rigid "
                                      "multi-site charged template)")
    pw.add_argument("traj")
    pw.add_argument("--eps", type=float, help="single-site LJ epsilon (K)")
    pw.add_argument("--sig", type=float, help="single-site LJ sigma (A)")
    pw.add_argument("--insert-pqr",
                    help="insertion-template PQR (insert_input deck): "
                         "rigid multi-site LJ + cutoff-Coulomb ghost with "
                         "random orientations")
    pw.add_argument("--temperature", "-T", type=float, required=True)
    pw.add_argument("--tries", type=int, default=2000,
                    help="insertions per frame")
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--rc", type=float, default=10.0, help="cutoff (A)")
    pmb = sub.add_parser("mbar",
                         help="continuous-T observables from one NVT "
                              "parallel-tempering run (MBAR reweighting "
                              "of the JSONL ladder records)")
    pmb.add_argument("jsonl", help="PT run --jsonl stream (needs the "
                                   "pt_temps ladder records)")
    pmb.add_argument("--skip", type=float, default=0.0,
                     help="equilibration fraction to drop (0-0.9)")
    pmb.add_argument("--nt", type=int, default=50,
                     help="temperature grid points")
    pmb.add_argument("--tmin", type=float, default=0.0,
                     help="grid start (default: ladder min)")
    pmb.add_argument("--tmax", type=float, default=0.0,
                     help="grid end (default: ladder max)")
    pmb.add_argument("--out", default="-", help="CSV path (default stdout)")
    pgc = sub.add_parser("gcmc-mbar",
                         help="continuous-fugacity isotherm + Qst from K "
                              "separate GCMC runs at one T (grand-"
                              "canonical MBAR over the runs' JSONL "
                              "streams)")
    pgc.add_argument("jsonl", nargs="+",
                     help=">=2 GCMC run --jsonl streams (run_meta headers "
                          "define each state), or ONE pt_fugacity ladder "
                          "stream with --ladder")
    pgc.add_argument("--ladder", action="store_true",
                     help="input is one fixed-T fugacity-ladder PT run "
                          "(pt_fugacity on): reweight its pt_fug ladder "
                          "records instead of separate runs")
    pgc.add_argument("--skip", type=float, default=0.0,
                     help="equilibration fraction to drop (0-0.9)")
    pgc.add_argument("--nf", type=int, default=50,
                     help="fugacity grid points (geometric)")
    pgc.add_argument("--fmin", type=float, default=0.0,
                     help="grid start (atm; default: ladder min)")
    pgc.add_argument("--fmax", type=float, default=0.0,
                     help="grid end (atm; default: ladder max)")
    pgc.add_argument("--out", default="-", help="CSV path (default stdout)")
    pp2 = sub.add_parser("pore",
                         help="geometric void fraction + pore-size "
                              "distribution (first frame)")
    pp2.add_argument("structure", help="PQR structure / trajectory (first "
                                       "frame is used)")
    pp2.add_argument("--name", default="*", help="atom name selection")
    pp2.add_argument("--flag", default="F", choices=["*", "M", "F"])
    pp2.add_argument("--probe", type=float, default=0.0,
                     help="probe LJ sigma (A); probe radius = sigma/2")
    pp2.add_argument("--points", type=int, default=20000,
                     help="volume sample points")
    pp2.add_argument("--centers", type=int, default=2000,
                     help="Gelb-Gubbins candidate sphere centers")
    pp2.add_argument("--bins", type=int, default=60)
    pp2.add_argument("--seed", type=int, default=0)
    pp2.add_argument("--out", default="-",
                     help="PSD CSV path (default stdout)")
    ptm = sub.add_parser("tmmc",
                         help="transition-matrix lnΠ(N) + reweighted "
                              "continuous-fugacity isotherm from one "
                              "GCMC run (tmmc on)")
    ptm.add_argument("files", nargs="+",
                     help="tmmc.json collection files (tmmc_output; "
                          "same-state files are summed)")
    ptm.add_argument("--fugacities", default="",
                     help="comma list of target fugacities (atm); "
                          "default: geometric grid spanning "
                          "fmin x..fmax x the run fugacity")
    ptm.add_argument("--nf", type=int, default=21,
                     help="grid points for the default geometric grid")
    ptm.add_argument("--fmin-ratio", type=float, default=0.1)
    ptm.add_argument("--fmax-ratio", type=float, default=10.0)
    ptm.add_argument("--out", default="-",
                     help="isotherm CSV path (default stdout)")
    ptm.add_argument("--lnpi-out", default=None,
                     help="also write the lnΠ(N) curve as CSV")
    pa2 = sub.add_parser("asa",
                         help="accessible surface area (Shrake-Rupley, "
                              "first frame)")
    pa2.add_argument("structure", help="PQR structure / trajectory (first "
                                       "frame is used)")
    pa2.add_argument("--name", default="*", help="atom name selection")
    pa2.add_argument("--flag", default="F", choices=["*", "M", "F"])
    pa2.add_argument("--probe", type=float, default=3.64,
                     help="probe LJ sigma (A; default ~N2)")
    pa2.add_argument("--sphere-points", type=int, default=512)
    pa2.add_argument("--seed", type=int, default=0)
    for p in (pr, pd, pm, pl, pw, po, ps, pp2, pa2, pcl):
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (default: the CUDA device)")
        p.add_argument("--no-native", action="store_true",
                       help="accepted for the reference's command lines; "
                            "the port has one route (seeded points as the "
                            "reference's numpy route draws them)")
    return ap


def _frame_cmd(args, dev):
    """The frame subcommands (trajectory or structure in, on ``dev``)."""
    if args.cmd == "rdf":
        r, g = rdf(args.traj, args.a, args.b, args.flag_a, args.flag_b,
                   rmax=args.rmax, nbins=args.bins, device=dev)
        _write_csv(args.out, "r,g",
                   ((f"{ri:.6f}", f"{gi:.8f}") for ri, gi in zip(r, g)))
    elif args.cmd == "msd":
        m, c = msd(args.traj, args.mol, args.flag, max_lag=args.max_lag,
                   device=dev)
        _write_csv(args.out, "lag,msd,samples",
                   ((t, f"{m[t]:.8f}", int(c[t])) for t in range(len(m))))
    elif args.cmd == "loading":
        counts = loading(args.traj, args.mol, args.flag, device=dev)
        _write_csv(args.out, "frame,n",
                   ((i, f"{v:g}") for i, v in enumerate(counts)))
    elif args.cmd == "orient":
        c1, c2, cnt = orientation(args.traj, args.mol, args.flag,
                                  args.axis, max_lag=args.max_lag,
                                  device=dev)
        _write_csv(args.out, "lag,c1,c2,samples",
                   ((t, f"{c1[t]:.8f}", f"{c2[t]:.8f}", int(cnt[t]))
                    for t in range(len(c1))))
    elif args.cmd == "sq":
        qv = np.linspace(args.qmin, args.qmax, args.nq)
        s, _ = sq(args.traj, qv, args.a, args.flag, dr_bin=args.dr_bin,
                  device=dev)
        _write_csv(args.out, "q,sq",
                   ((f"{qi:.6f}", f"{si:.8f}") for qi, si in zip(qv, s)))
    elif args.cmd == "cluster":
        series, hist = cluster(args.traj, args.mol, args.flag, rc=args.rc,
                               max_size=args.max_size, device=dev)
        _write_csv(args.out, "frame,n_clusters,mean_size,largest_fraction",
                   ((i, f"{r[0]:g}", f"{r[1]:.6g}", f"{r[2]:.6g}")
                    for i, r in enumerate(series)))
        nz = np.nonzero(hist)[0]
        if nz.size:
            print("pooled cluster-size histogram (size: count):")
            for s in nz:
                tag = f"{s + 1}" if s + 1 < args.max_size \
                    else f">={args.max_size}"
                print(f"  {tag}: {int(hist[s])}")
        if len(series):
            print(f"frames: {len(series)}  "
                  f"<clusters/frame>: {series[:, 0].mean():.3f}  "
                  f"<largest fraction>: {series[:, 2].mean():.4f}")
    elif args.cmd == "pore":
        res = pore(args.structure, args.name, args.flag,
                   probe_sigma=args.probe, n_points=args.points,
                   n_centers=args.centers, seed=args.seed, nbins=args.bins,
                   device=dev)
        print(f"void fraction (probe centers): {res['void_fraction']:.6g}")
        print(f"coverable fraction:            "
              f"{res['coverable_fraction']:.6g}")
        print(f"void volume (A^3):             "
              f"{res['void_fraction'] * res['volume']:.6g} "
              f"of {res['volume']:.6g}")
        print(f"largest included sphere r >=   {res['d_max']:.4g} A "
              f"(cap {res['cap']:.4g})")
        _write_csv(args.out, "r,psd,cumulative",
                   ((f"{r:.6f}", f"{p:.8g}", f"{c:.8g}")
                    for r, p, c in zip(res["psd_r"], res["psd"],
                                       res["psd_cumulative"])))
    elif args.cmd == "asa":
        res = asa(args.structure, args.name, args.flag,
                  probe_sigma=args.probe, n_sphere=args.sphere_points,
                  seed=args.seed, device=dev)
        print(f"accessible area: {res['area_A2']:.6g} A^2")
        print(f"                 {res['area_m2_g']:.6g} m^2/g")
        print(f"                 {res['area_m2_cm3']:.6g} m^2/cm^3")
        print(f"selection mass:  {res['mass_amu']:.6g} amu; cell "
              f"volume {res['volume_A3']:.6g} A^3")
    elif args.cmd == "widom":
        if args.insert_pqr:
            res = widom_mol(args.traj, args.insert_pqr, args.temperature,
                            n_try=args.tries, seed=args.seed, rc=args.rc,
                            device=dev)
        elif args.eps is None or args.sig is None:
            raise SystemExit("widom needs --eps and --sig, or "
                             "--insert-pqr")
        else:
            res = widom(args.traj, args.eps, args.sig, args.temperature,
                        n_try=args.tries, seed=args.seed, rc=args.rc,
                        device=dev)
        print(f"frames:            {res['n_frames']}")
        print(f"<exp(-U/kT)>:      {res['boltzmann']:.6e}")
        print(f"mu_excess (K):     {res['mu_ex']:.4f}")
        print(f"<U>_0 (K):         {res['u0']:.4f}")
        print(f"K_H (mol/kg/atm):  {res['kh_mol_kg_atm']:.6e}")
    else:
        from mpmc_tpu_torch.utils.histogram import PopulationHistogram
        grid, dims, box = density(args.traj, args.mol, args.flag,
                                  resolution=args.resolution, device=dev)
        h = PopulationHistogram.__new__(PopulationHistogram)
        h.box = box
        h.dims = np.asarray(dims)
        h.counts = grid
        h.n_frames = 1          # grid is already per-frame averaged
        h.write_dx(args.out)
        print(f"wrote {args.out}: dims {dims}, "
              f"total density {grid.sum():.3f} molecules/frame")


def _tmmc_main(args):
    c, meta = tmmc_load(args.files)
    # only the insert species' fugacity reweights N; files without the
    # field fall back to the sum of the fugacities
    if "f_sim_atm" in meta:
        f_sim = float(meta["f_sim_atm"])
    else:
        f_sim = float(sum(meta["fugacities_atm"]))
        if len([f for f in meta["fugacities_atm"] if f > 0]) > 1:
            print("WARNING: tmmc file without f_sim_atm and several "
                  "positive fugacities — using their sum")
    if f_sim <= 0:
        raise SystemExit("run metadata has no positive fugacity")
    if args.fugacities:
        targets = [float(v) for v in args.fugacities.split(",")]
    else:
        targets = np.geomspace(args.fmin_ratio * f_sim,
                               args.fmax_ratio * f_sim, args.nf)
    lnpi = tmmc_lnpi(c)
    ok = np.isfinite(lnpi)
    n_att = int(c[:, 0].sum() + c[:, 2].sum())
    print(f"collection: {n_att:d} insert/delete attempts, resolved window "
          f"N = {np.flatnonzero(ok).min()}..{np.flatnonzero(ok).max()} of "
          f"0..{len(lnpi) - 1}  (T={meta['temperature']:g} K, "
          f"f_sim={f_sim:g} atm)")
    rows = tmmc_isotherm(c, f_sim, targets)
    for f, n, v, edge in rows:
        if edge > 1e-6:
            print(f"WARNING: f={f:g} atm puts {edge:.2e} probability mass "
                  "at the window edge — extend the run or sample nearer "
                  "this fugacity")
    _write_csv(args.out, "f_atm,n_mean,var_n,edge_mass",
                ((f"{f:.6g}", f"{n:.8g}", f"{v:.8g}", f"{e:.3g}")
                 for f, n, v, e in rows))
    if args.lnpi_out:
        _write_csv(args.lnpi_out, "n,lnpi",
                    ((i, f"{lnpi[i]:.8g}") for i in np.flatnonzero(ok)))


def _host_cmd(args):
    """The host subcommands (series, isotherms, ladders, TMMC files)."""
    if args.cmd == "qst":
        def col(path, name, alias):
            # JSONL streams use N/energy_total; the energy_output CSV
            # (io/output.py) writes n_molecules/total
            try:
                return _read_series(path, name)
            except ValueError:
                return _read_series(path, alias)
        nn = col(args.series, args.n_column, "n_molecules")
        uu = col(args.series, args.u_column, "total")
        k0 = int(min(max(args.skip, 0.0), 0.9) * len(nn))
        res = qst(nn[k0:], uu[k0:], args.temperature, n_blocks=args.blocks)
        print(f"samples:   {res['samples']} (skipped {k0})")
        print(f"<N>:       {res['n_mean']:.6g} +/- {res['n_sem']:.3g}")
        print(f"Qst (K):   {res['qst']:.6g} +/- {res['qst_sem']:.3g}")
        print(f"Qst (kJ/mol): {res['qst'] * 8.314462618e-3:.6g} "
              f"+/- {res['qst_sem'] * 8.314462618e-3:.3g}")
    elif args.cmd == "qst-cc":
        th, qk = qst_clausius_clapeyron(
            _read_series(args.csv1, args.p_column),
            _read_series(args.csv1, args.q_column), args.t1,
            _read_series(args.csv2, args.p_column),
            _read_series(args.csv2, args.q_column), args.t2,
            n_loadings=args.n_loadings)
        _write_csv(args.out, "loading,qst_K,qst_kJ_mol",
                   ((f"{t:.6g}", f"{q:.6g}", f"{q * 8.314462618e-3:.6g}")
                    for t, q in zip(th, qk)))
    elif args.cmd == "iast":
        f1 = isotherm_fit(_read_series(args.csv1, args.p_column),
                          _read_series(args.csv1, args.q_column),
                          model=args.model1)
        f2 = isotherm_fit(_read_series(args.csv2, args.p_column),
                          _read_series(args.csv2, args.q_column),
                          model=args.model2)
        rows = []
        for pt in args.pressures:
            r = iast_binary(f1, f2, args.y1, pt)
            rows.append((f"{pt:g}", f"{r['q1']:.6g}", f"{r['q2']:.6g}",
                         f"{r['q_total']:.6g}", f"{r['selectivity']:.6g}"))
        _write_csv(args.out, "p_total,q1,q2,q_total,selectivity", rows)
    elif args.cmd == "isofit":
        pp = _read_series(args.csv, args.p_column)
        qq = _read_series(args.csv, args.q_column)
        se = (_read_series(args.csv, args.sem_column)
              if args.sem_column else None)
        res = isotherm_fit(pp, qq, model=args.model, sem=se)
        print(f"model:     {res['model']}  (converged: {res['converged']})")
        for k, v in res["params"].items():
            print(f"  {k:>4s} = {v:.8g}")
        print(f"rmse:      {res['rmse']:.6g}")
        print(f"henry dq/dP (P->0): {res['henry']:.6g}")
    elif args.cmd == "blocking":
        s = _read_series(args.series, args.column)
        sizes, sems, errs, tau = blocking(s)
        _write_csv(args.out, "block_size,sem,sem_err",
                   ((int(b), f"{m:.8g}", f"{e:.8g}")
                    for b, m, e in zip(sizes, sems, errs)))
        print(f"samples: {len(s)}  mean: {s.mean():.8g}  "
              f"tau_int: {tau:.2f}  "
              f"sem(plateau): {sems[0] * np.sqrt(tau):.6g}")
    elif args.cmd == "tmmc":
        _tmmc_main(args)
    elif args.cmd == "gcmc-mbar":
        grid = (np.geomspace(args.fmin, args.fmax, args.nf)
                if args.fmax > 0 else None)
        if args.ladder:
            if len(args.jsonl) != 1:
                raise SystemExit("--ladder takes exactly one pt_fugacity "
                                 "run stream")
            res = pt_gcmc_mbar(args.jsonl[0], skip=args.skip, n_f=args.nf,
                               f_grid=grid)
            res["n_species"] = {}
            res["composition_matched"] = True
        else:
            res = gcmc_mbar(args.jsonl, skip=args.skip, n_f=args.nf,
                            f_grid=grid)
        lf = res["ladder_f"]
        print(f"ladder: {lf.size} states at T={res['temperature']:g}, "
              "f_total = " + " ".join(f"{v:g}" for v in lf)
              + f"  (samples/state: {res['samples_per_state']}, "
              f"converged: {res['converged']})")
        if not res["composition_matched"]:
            print("WARNING: run compositions differ — the grid follows "
                  "the FIRST run's composition ray")
        print("delta_f (dimensionless grand potential, vs state 0): "
              + " ".join(f"{v:.4f}" for v in res["delta_f"]))
        sp_names = sorted(res["n_species"])
        hdr = "f_atm,n_mean,u_mean,var_n,qst_kJ_mol,ess" + "".join(
            f",n_{nm}" for nm in sp_names)
        _write_csv(args.out, hdr,
                   ((f"{ft:.6g}", f"{n:.8g}", f"{u:.8g}", f"{v:.8g}",
                     f"{q:.6g}", f"{e:.6g}",
                     *(f"{res['n_species'][nm][i]:.8g}" for nm in sp_names))
                    for i, (ft, n, u, v, q, e) in enumerate(zip(
                        res["f_grid"], res["n_mean"], res["u_mean"],
                        res["var_n"], res["qst_kj_mol"], res["ess"]))))
    elif args.cmd == "mbar":
        res = pt_mbar(args.jsonl, skip=args.skip, n_t=args.nt,
                      t_grid=(np.linspace(args.tmin, args.tmax, args.nt)
                              if args.tmax > 0 else None))
        lt = res["ladder_t"]
        print(f"ladder: {lt.size} states, T = "
              + " ".join(f"{t:g}" for t in lt)
              + f"  (samples/state: {res['samples_per_state']}, "
              f"converged: {res['converged']})")
        print("delta_f (dimensionless, vs coldest): "
              + " ".join(f"{v:.4f}" for v in res["delta_f"]))
        _write_csv(args.out, "T,u_mean,cv_kb,n_mean,ess",
                   ((f"{t:.6g}", f"{u:.8g}", f"{c:.8g}", f"{n:.8g}",
                     f"{e:.6g}")
                    for t, u, c, n, e in zip(res["t_grid"], res["u_mean"],
                                             res["cv_kb"], res["n_mean"],
                                             res["ess"])))


def main(argv=None):
    args = _parser().parse_args(argv)
    if hasattr(args, "cpu"):
        _frame_cmd(args, "cpu" if args.cpu else resolve_device())
    else:
        _host_cmd(args)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:   # `... | head` closed stdout mid-CSV
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
