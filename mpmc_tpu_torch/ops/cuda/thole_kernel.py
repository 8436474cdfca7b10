"""Wrappers and plain versions of B5, the Thole field kernel
(csrc/thole_kernel.cu).

B5 replaces mpmc_tpu/ops/pallas/thole_kernel.py::_kernel (through
``_field``, via ``charge_field`` and ``dipole_field``).  Over the pairs
j != i whose sites are both ``site_ok`` and whose minimum-image distance
is inside rc, with dr = r_i - r_j:

- ``charge_field``: E_i = sum_j q_j d1 dr / r^3 over j of another
  molecule — the damped static field of the permanent charges;
- ``dipole_field``: E_i = sum_j [3 d2 (dr.mu_j) dr / r^5 - d1 mu_j / r^3]
  (intramolecular pairs included) — the CG matvec (T mu).

d1, d2 are the Thole screening factors (``damping``); a pair at
r^2 <= 1e-12 is evaluated at r^2 = 1.  Rows that are not ok come out as
exact zeros.  The plain versions follow the reference's jnp path (square
root and division); the kernel takes its reciprocals from one rsqrt per
pair, as the Pallas kernel does, within phase 4c's tolerances.

``visit`` (optional): an [NI, NJ] int32 table over tiles of TI rows x TJ
columns (``grid_shape``); a tile marked 0 is skipped whole.  Every pair
of a skipped tile must lie outside rc (thole.cull_visit builds such a
table), so the result equals the dense one.

On the card the kernel walks a work list of tiles (``work_list``: every
tile, or the visited ones) on a grid of as many CTAs as the card holds at
once, and writes each listed tile's double partials to a slot of a
scratch buffer (TI x 3 doubles a slot, one slot per listed tile: 3 KiB x
NI x NJ dense, about 22 MB at N = 10.8k and 1.9 GB at 100k; 3 KiB x W
culled); the last CTA to finish a row tile adds its slots in column-tile
order (csrc/thole_kernel.cu).  ``plan`` gathers what a call needs besides
the sites — the scalar header, the work list and its length W (read on
the host once, to size the slots) — so that a caller making many calls
with the same box, rc and table (the SCF's CG iterations) builds them
once; a plan serves only calls with the very tensors it was built from
(``check_plan``).  The scratch buffer and the row tiles' tickets are kept
per device (``scratch``) and grow to the largest call.  Calls share them
in stream order: the port launches every kernel on one stream.

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; anything else raises.  There is no fallback
from the kernel to the plain version.  ``charge_field.launches`` and
``dipole_field.launches`` count the kernel launches of each mode, and
nothing else.  The kernel is templated on float and double.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mpmc_tpu_torch.ops import pbc as pbc_ops
from mpmc_tpu_torch.ops.cuda.pair_kernel import (_check, _ptr, _raise_on,
                                                 _stream, _suffix)

TI = 128          # rows per tile (the kernel's TI)
TJ = 128          # columns per tile (the kernel's TJ)
PLAIN_ROWS = 256  # row chunk of the plain versions ([256, N] temporaries)
_DAMP = {"none": 0, "exponential": 1, "linear": 2}


def grid_shape(n_real, ti=TI, tj=TJ):
    """(n_pad, NI, NJ): the padded site count and the tile grid — the
    shape contract between a ``visit`` table and the kernel."""
    t = max(ti, tj)
    n_pad = max(-(-n_real // t), 1) * t
    return n_pad, n_pad // ti, n_pad // tj


def damping(r, lam, kind):
    """(d1, d2): charge-dipole and dipole-dipole Thole screening factors —
    exponential (Thole's model 3, width ``lam`` in 1/A), linear (model 1,
    lambda3 = 4u^3 - 3u^4, lambda5 = u^4 for u = r/lam < 1) or none."""
    if kind == "none":
        one = torch.ones_like(r)
        return one, one
    if kind == "exponential":
        x = lam * r
        e = torch.exp(-x)
        p1 = 1.0 + x + 0.5 * x * x
        return 1.0 - e * p1, 1.0 - e * (p1 + x * x * x / 6.0)
    if kind == "linear":
        u = torch.clamp(r / lam, max=1.0)
        u3 = u * u * u
        return 4.0 * u3 - 3.0 * u3 * u, u3 * u
    raise ValueError(f"polar_damp_type {kind} not supported")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _field_plain(mode, pos, box, src, site_ok, mol_id, rc, lam, damp_kind,
                 visit=None):
    """Plain B5: row blocks of dense [B, N] masks; ``visit`` masks the
    pairs of skipped tiles."""
    n = pos.shape[0]
    box_inv = torch.linalg.inv(box)
    cols = torch.arange(n, device=pos.device)
    out = []
    for i0 in range(0, n, PLAIN_ROWS):
        rows = cols[i0:i0 + PLAIN_ROWS]
        dr = pbc_ops.min_image(pos[rows][:, None, :] - pos[None, :, :], box,
                               box_inv)                 # r_i - r_j
        r2 = torch.sum(dr * dr, -1)
        ok = (site_ok[rows][:, None] & site_ok[None, :]
              & (rows[:, None] != cols[None, :]) & (r2 < rc * rc))
        if mode == "charge":
            ok = ok & (mol_id[rows][:, None] != mol_id[None, :])
        if visit is not None:
            ok = ok & (visit[(rows // TI)[:, None], (cols // TJ)[None, :]]
                       != 0)
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        d1, d2 = damping(r, lam, damp_kind)
        zero = torch.zeros_like(r2)
        if mode == "charge":
            coef = torch.where(ok, src[None, :] * d1 / (r2s * r), zero)
            out.append(torch.einsum("bn,bnk->bk", coef, dr))
        else:
            inv_r3 = 1.0 / (r2s * r)
            mdotr = torch.einsum("nk,bnk->bn", src, dr)
            c1 = torch.where(ok, 3.0 * d2 * mdotr * inv_r3 / r2s, zero)
            c2 = torch.where(ok, d1 * inv_r3, zero)
            out.append(torch.einsum("bn,bnk->bk", c1, dr) - c2 @ src)
    if not out:
        return torch.zeros((0, 3), dtype=pos.dtype, device=pos.device)
    return torch.cat(out)


def charge_field_plain(pos, box, site_ok, charge, mol_id, rc, lam,
                       damp_kind, ortho=False, visit=None):
    """Plain B5, charge mode (module docstring).  ``ortho`` is accepted
    for the kernel's signature: the general minimum image gives the same
    displacements in a diagonal cell."""
    return _field_plain("charge", pos, box, charge, site_ok, mol_id, rc,
                        lam, damp_kind, visit)


def dipole_field_plain(pos, box, site_ok, mu, mol_id, rc, lam, damp_kind,
                       ortho=False, visit=None):
    """Plain B5, dipole mode (module docstring)."""
    return _field_plain("dipole", pos, box, mu, site_ok, mol_id, rc, lam,
                        damp_kind, visit)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def scalars(box, rc, lam):
    """The kernel's scalar header [rc, lam, box (9), box^-1 (9)] on the
    box's device (no host round trip: inv_ex skips inv's error check, a
    host sync)."""
    rc = torch.as_tensor(rc, dtype=box.dtype, device=box.device)
    lam = torch.full((1,), float(lam), dtype=box.dtype, device=box.device)
    return torch.cat([rc.reshape(1), lam, box.reshape(-1),
                      torch.linalg.inv_ex(box)[0].reshape(-1)]).contiguous()


def work_list(visit):
    """The kernel's work list of an [NI, NJ] visit table, built on the
    table's device with no host sync: int32 [W, rowoff[0..NI],
    tiles[0..NI*NJ)] — W visited tiles (I * NJ + J), row-major, row tile
    I's at list positions rowoff[I] .. rowoff[I + 1] - 1 in column order;
    the entries past W are 0.  The dense list (every tile) is implicit:
    the kernel takes no list."""
    ni, nj = visit.shape
    hit = visit.reshape(-1) != 0
    count = torch.cumsum(hit, 0, dtype=torch.int32)
    tiles = torch.nonzero_static(hit, size=ni * nj, fill_value=0)
    return torch.cat([count[-1:], count.new_zeros(1),
                      count.reshape(ni, nj)[:, -1],
                      tiles.reshape(-1).to(torch.int32)])


class FieldPlan(NamedTuple):
    """What a B5 call needs besides the sites: ``n`` sites, the scalar
    header ``scal``, the work list ``wl`` (None: every tile) and its
    length ``slots``; and the box, rc, damping width and visit table it
    was built from."""
    n: int
    scal: torch.Tensor
    wl: Optional[torch.Tensor]
    slots: int
    box: torch.Tensor
    rc: object
    lam: object
    visit: Optional[torch.Tensor]


def plan(box, rc, lam, n, visit=None):
    """The FieldPlan of calls on ``n`` sites with this box, rc, damping
    width and visit table (module docstring).  A culled plan reads its
    list's length W on the host: one sync."""
    _, ni, nj = grid_shape(n)
    if visit is None:
        return FieldPlan(n, scalars(box, rc, lam), None, ni * nj, box, rc,
                         lam, None)
    if tuple(visit.shape) != (ni, nj):
        raise ValueError(f"visit: shape {tuple(visit.shape)}, {n} sites "
                         f"take ({ni}, {nj})")
    wl = work_list(visit)
    return FieldPlan(n, scalars(box, rc, lam), wl, int(wl[0]), box, rc, lam,
                     visit)


def _same(a, b):
    """The same tensor, or equal numbers."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return a is b
    return a == b


def check_plan(fplan, box, rc, lam, n, visit):
    """Raise unless ``fplan`` was built by ``plan`` for this call: the
    same box, rc and visit tensors (or equal numbers), damping width and
    site count.  The kernel reads the header and the list from the plan
    alone, so a plan of another table or cell would skip pairs inside
    rc."""
    if not (fplan.n == n and _same(fplan.box, box) and _same(fplan.rc, rc)
            and _same(fplan.lam, lam) and _same(fplan.visit, visit)):
        raise ValueError("plan: built for another call (box, rc, lam, "
                         "site count or visit table)")


_config: dict = {}
_scratch: dict = {}


def card_config(device, dtype, mode):
    """The CTAs the card holds at once of the kernel instance, queried
    once per device, type and mode."""
    key = (device, dtype, mode)
    if key not in _config:
        from mpmc_tpu_torch.ops.cuda import _build
        lib = _build.library("thole_kernel")
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            err = getattr(lib, "thole_config_" + _suffix(dtype))(
                int(mode == "dipole"), out)
        _raise_on(err, "thole_config")
        if out[0] <= 0:
            raise RuntimeError("thole_kernel: no CTA fits on the card")
        _config[key] = out[0]
    return _config[key]


def scratch(device, n_part, n_ticket):
    """(part, ticket): the device's double partial slots (>= ``n_part``)
    and int32 row-tile tickets (>= ``n_ticket``, zero between launches),
    grown to the largest call and kept."""
    have = _scratch.get(device)
    if (have is None or have[0].numel() < n_part
            or have[1].numel() < n_ticket):
        n_part = max(n_part, 0 if have is None else have[0].numel())
        n_ticket = max(n_ticket, 0 if have is None else have[1].numel())
        have = (torch.empty(n_part, dtype=torch.float64, device=device),
                torch.zeros(n_ticket, dtype=torch.int32, device=device))
        _scratch[device] = have
    return have


def _launch(mode, pos, box, src, site_ok, mol_id, rc, lam, damp_kind,
            ortho, visit, fplan):
    n = pos.shape[0]
    dt, dev = pos.dtype, pos.device
    _check("pos", pos, dt, (n, 3))
    _check("src", src, dt, (n,) if mode == "charge" else (n, 3), dev)
    _check("site_ok", site_ok, torch.bool, (n,), dev)
    _check("mol_id", mol_id, torch.int32, (n,), dev)
    _check("box", box, dt, (3, 3), dev)
    if damp_kind not in _DAMP:
        raise ValueError(f"polar_damp_type {damp_kind} not supported")
    n_pad, ni, nj = grid_shape(n)
    if visit is not None:
        _check("visit", visit, torch.int32, (ni, nj), dev)
    out = torch.empty((n, 3), dtype=dt, device=dev)
    if n == 0:
        return out, None
    if fplan is None:
        fplan = plan(box, rc, lam, n, visit)
    else:
        check_plan(fplan, box, rc, lam, n, visit)
    blocks = card_config(dev, dt, mode)
    part, ticket = scratch(dev, max(fplan.slots, 1) * TI * 3, ni)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library("thole_kernel"), "thole_field_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(src), _ptr(site_ok), _ptr(mol_id),
             _ptr(fplan.scal),
             _ptr(fplan.wl) if fplan.wl is not None else None, n, ni, nj,
             int(mode == "dipole"), _DAMP[damp_kind], int(ortho),
             min(blocks, ni * nj), _ptr(part), _ptr(ticket), _ptr(out),
             _stream(dev))
    return out, err


def charge_field(pos, box, site_ok, charge, mol_id, rc, lam, damp_kind,
                 ortho=False, visit=None, plan=None):
    """B5 charge mode: the damped intermolecular static field [N, 3]
    (module docstring).  ``mol_id`` int32 on the card, ``site_ok`` bool,
    ``rc`` a 0-d tensor, ``lam`` the damping width; ``plan`` (optional,
    the card's: the plain version ignores it) from ``plan`` with the same
    box, rc, lam, site count and ``visit``."""
    if pos.device.type == "cpu":
        return charge_field_plain(pos, box, site_ok, charge, mol_id, rc, lam,
                                  damp_kind, ortho=ortho, visit=visit)
    if pos.device.type != "cuda":
        raise ValueError(f"charge_field: no kernel for {pos.device}")
    out, err = _launch("charge", pos, box, charge, site_ok, mol_id, rc, lam,
                       damp_kind, ortho, visit, plan)
    if err is not None:
        charge_field.launches += 1
        _raise_on(err, "charge_field")
    return out


charge_field.launches = 0


def dipole_field(pos, box, site_ok, mu, mol_id, rc, lam, damp_kind,
                 ortho=False, visit=None, plan=None):
    """B5 dipole mode: the matvec (T mu) [N, 3] (module docstring);
    ``mu`` [N, 3], zero where a site is not ok; ``plan`` as for
    ``charge_field``."""
    if pos.device.type == "cpu":
        return dipole_field_plain(pos, box, site_ok, mu, mol_id, rc, lam,
                                  damp_kind, ortho=ortho, visit=visit)
    if pos.device.type != "cuda":
        raise ValueError(f"dipole_field: no kernel for {pos.device}")
    out, err = _launch("dipole", pos, box, mu, site_ok, mol_id, rc, lam,
                       damp_kind, ortho, visit, plan)
    if err is not None:
        dipole_field.launches += 1
        _raise_on(err, "dipole_field")
    return out


dipole_field.launches = 0


def reset_counts():
    """Zero both modes' launch counters."""
    charge_field.launches = 0
    dipole_field.launches = 0
