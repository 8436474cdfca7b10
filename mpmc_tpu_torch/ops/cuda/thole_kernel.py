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

Over a chain axis (the reference vmaps B5 over the chains of its
batched polar step): ``charge_field_chains`` / ``dipole_field_chains``
take the sites of C chains, pos [C, N, 3], site_ok, mol_id [C, N] (each
chain's own site order: the culled solve sorts each chain apart) and src
[C, N] or [C, N, 3], with the damping shared and the box and rc shared
([3, 3], 0-d) or one per chain ([C, 3, 3], [C]: the NPT chains, each in
its own box; the kernel then reads a [C, 20] scalar header, a row per
chain), an optional visit table per chain [C, NI, NJ] and an optional host
list ``active`` of the chains to compute (the others come out as zeros: a
chain whose CG has stopped costs nothing).  One launch walks the (chain,
row tile, column tile) items of the listed chains; slots are kept per
listed item and tickets per (chain, row tile), so each chain's field is
bit for bit the single-chain launch on that chain's tensors (in that
chain's box, with a header per chain).  The single-chain wrappers launch
the same kernel at C = 1.  ``plan_chains`` reads each chain's
visited-tile count once (one sync), so the plan of an active subset
(``subplan``) needs none.

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; anything else raises.  There is no fallback
from the kernel to the plain version.  ``charge_field.launches``,
``dipole_field.launches``, ``charge_field_chains.launches`` and
``dipole_field_chains.launches`` count the kernel launches of each
wrapper, and nothing else.  The kernel is templated on float and double.
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
    """Plain B5: row blocks of dense [..., B, N] masks (a leading chain
    axis on every per-site tensor and on ``visit``, or none; ``box``
    [3, 3] and ``rc`` 0-d shared, or [C, 3, 3] and [C] per chain);
    ``visit`` masks the pairs of skipped tiles."""
    n = pos.shape[-2]
    box_inv = torch.linalg.inv(box)
    rc = torch.as_tensor(rc)
    if rc.ndim:
        rc = rc.reshape(rc.shape + (1, 1))
    cols = torch.arange(n, device=pos.device)
    out = []
    for i0 in range(0, n, PLAIN_ROWS):
        rows = cols[i0:i0 + PLAIN_ROWS]
        dr = pbc_ops.min_image(pos[..., rows, None, :]
                               - pos[..., None, :, :], box, box_inv)
        r2 = torch.sum(dr * dr, -1)                       # r_i - r_j
        ok = (site_ok[..., rows, None] & site_ok[..., None, :]
              & (rows[:, None] != cols[None, :]) & (r2 < rc * rc))
        if mode == "charge":
            ok = ok & (mol_id[..., rows, None] != mol_id[..., None, :])
        if visit is not None:
            ok = ok & (visit[..., (rows // TI)[:, None],
                             (cols // TJ)[None, :]] != 0)
        r2s = torch.where(r2 > 1e-12, r2, torch.ones_like(r2))
        r = torch.sqrt(r2s)
        d1, d2 = damping(r, lam, damp_kind)
        zero = torch.zeros_like(r2)
        if mode == "charge":
            coef = torch.where(ok, src[..., None, :] * d1 / (r2s * r), zero)
            out.append(torch.einsum("...bn,...bnk->...bk", coef, dr))
        else:
            inv_r3 = 1.0 / (r2s * r)
            mdotr = torch.einsum("...nk,...bnk->...bn", src, dr)
            c1 = torch.where(ok, 3.0 * d2 * mdotr * inv_r3 / r2s, zero)
            c2 = torch.where(ok, d1 * inv_r3, zero)
            out.append(torch.einsum("...bn,...bnk->...bk", c1, dr)
                       - c2 @ src)
    if not out:
        return torch.zeros(pos.shape, dtype=pos.dtype, device=pos.device)
    return torch.cat(out, -2)


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


def _chains_plain(mode, pos, box, src, site_ok, mol_id, rc, lam, damp_kind,
                  visit, active):
    """Plain B5 over [C]: the listed chains' fields in one batched pass,
    zeros for the others; ``box`` and ``rc`` shared or per chain."""
    if active is None:
        return _field_plain(mode, pos, box, src, site_ok, mol_id, rc, lam,
                            damp_kind, visit)
    out = torch.zeros(pos.shape, dtype=pos.dtype, device=pos.device)
    if len(active):
        idx = torch.as_tensor(active, dtype=torch.int64, device=pos.device)
        rc = torch.as_tensor(rc)
        out[idx] = _field_plain(mode, pos[idx],
                                box[idx] if box.ndim == 3 else box,
                                src[idx], site_ok[idx], mol_id[idx],
                                rc[idx] if rc.ndim else rc, lam, damp_kind,
                                None if visit is None else visit[idx])
    return out


def charge_field_chains_plain(pos, box, site_ok, charge, mol_id, rc, lam,
                              damp_kind, ortho=False, visit=None,
                              active=None):
    """Plain B5 over a chain axis, charge mode (module docstring)."""
    return _chains_plain("charge", pos, box, charge, site_ok, mol_id, rc,
                         lam, damp_kind, visit, active)


def dipole_field_chains_plain(pos, box, site_ok, mu, mol_id, rc, lam,
                              damp_kind, ortho=False, visit=None,
                              active=None):
    """Plain B5 over a chain axis, dipole mode (module docstring)."""
    return _chains_plain("dipole", pos, box, mu, site_ok, mol_id, rc, lam,
                         damp_kind, visit, active)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def scalars(box, rc, lam):
    """The kernel's scalar header [rc, lam, box (9), box^-1 (9)] on the
    box's device (no host round trip: inv_ex skips inv's error check, a
    host sync); [C, 20], a row per chain, for stacked boxes [C, 3, 3] and
    a [C] rc."""
    lead = box.shape[:-2]
    rc = torch.as_tensor(rc, dtype=box.dtype, device=box.device)
    lam = torch.full(lead + (1,), float(lam), dtype=box.dtype,
                     device=box.device)
    return torch.cat([rc.expand(lead).reshape(lead + (1,)), lam,
                      box.reshape(lead + (9,)),
                      torch.linalg.inv_ex(box)[0].reshape(lead + (9,))],
                     -1).contiguous()


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
    header ``scal``, the work list ``wl`` of the listed chains (None:
    every item) and its length ``slots``; the box, rc, damping width and
    visit table it was built from; the chain count ``C`` (1 for a
    single-chain plan, whose ``visit`` is [NI, NJ]), the listed chains
    (``listed``: a host tuple, None for all; ``chains``: the same on the
    device) and each chain's visited-tile count (``counts``, culled
    plans)."""
    n: int
    scal: torch.Tensor
    wl: Optional[torch.Tensor]
    slots: int
    box: torch.Tensor
    rc: object
    lam: object
    visit: Optional[torch.Tensor]
    C: int = 1
    listed: Optional[tuple] = None
    chains: Optional[torch.Tensor] = None
    counts: Optional[tuple] = None


def plan(box, rc, lam, n, visit=None):
    """The FieldPlan of single-chain calls on ``n`` sites with this box,
    rc, damping width and [NI, NJ] visit table (module docstring).  A
    culled plan reads its list's length W on the host: one sync."""
    _, ni, nj = grid_shape(n)
    if visit is not None and tuple(visit.shape) != (ni, nj):
        raise ValueError(f"visit: shape {tuple(visit.shape)}, {n} sites "
                         f"take ({ni}, {nj})")
    fplan = plan_chains(box, rc, lam, n, 1,
                        None if visit is None else visit.reshape(1, ni, nj))
    return fplan._replace(visit=visit)


def plan_chains(box, rc, lam, n, C, visit=None):
    """The FieldPlan of calls on C chains of ``n`` sites with this box,
    rc, damping width and [C, NI, NJ] visit table, every chain listed.
    ``box`` [3, 3] and ``rc`` 0-d shared by the chains (a [20] header),
    or [C, 3, 3] and [C], one per chain (a [C, 20] header).  A culled
    plan reads each chain's visited-tile count on the host: one sync."""
    _, ni, nj = grid_shape(n)
    scal = scalars(box, rc, lam)
    if visit is None:
        return FieldPlan(n, scal, None, C * ni * nj, box, rc, lam, None, C)
    if tuple(visit.shape) != (C, ni, nj):
        raise ValueError(f"visit: shape {tuple(visit.shape)}, {C} chains "
                         f"of {n} sites take ({C}, {ni}, {nj})")
    counts = tuple(int(x) for x in (visit != 0).sum((1, 2)).tolist())
    return FieldPlan(n, scal, work_list(visit.reshape(C * ni, nj)),
                     sum(counts), box, rc, lam, visit, C, counts=counts)


def subplan(fplan, active, chains=None):
    """The plan of ``fplan``'s calls restricted to the chains ``active``
    (a sorted host sequence of chain indices; ``chains``: the same as an
    int32 tensor on the plan's device, made by the caller, or copied
    here): the listed chains' work list, built on the device with no host
    sync."""
    active = tuple(int(c) for c in active)
    if fplan.listed is not None:
        raise ValueError("subplan: the plan already lists a subset")
    if active == tuple(range(fplan.C)):
        return fplan
    if any(not 0 <= c < fplan.C for c in active) or \
            list(active) != sorted(set(active)):
        raise ValueError(f"subplan: active {active} is not a sorted subset "
                         f"of {fplan.C} chains")
    _, ni, nj = grid_shape(fplan.n)
    dev = fplan.scal.device
    if chains is None:
        chains = torch.as_tensor(active, dtype=torch.int32, device=dev)
    if fplan.visit is None:
        return fplan._replace(slots=len(active) * ni * nj, listed=active,
                              chains=chains)
    v = fplan.visit.reshape(fplan.C, ni, nj)
    sel = v.index_select(0, chains.to(torch.int64))
    return fplan._replace(wl=work_list(sel.reshape(-1, nj)),
                          slots=sum(fplan.counts[c] for c in active),
                          listed=active, chains=chains)


def _same(a, b):
    """The same tensor, or equal numbers."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return a is b
    return a == b


def check_plan(fplan, box, rc, lam, n, visit, C=1):
    """Raise unless ``fplan`` was built by ``plan`` (``plan_chains``) for
    this call: the same box, rc and visit tensors (or equal numbers),
    damping width, site count and chain count.  The kernel reads the
    header and the list from the plan alone, so a plan of another table
    or cell would skip pairs inside rc."""
    if not (fplan.n == n and fplan.C == C and _same(fplan.box, box)
            and _same(fplan.rc, rc) and _same(fplan.lam, lam)
            and _same(fplan.visit, visit)):
        raise ValueError("plan: built for another call (box, rc, lam, "
                         "site count, chain count or visit table)")


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
            ortho, visit, fplan, active=None):
    """One launch of B5 over the chains of ``pos`` [C, N, 3] that
    ``fplan`` (checked by the caller; built when None) and ``active``
    list; (out, err), err None when nothing was launched."""
    C, n = pos.shape[:2]
    dt, dev = pos.dtype, pos.device
    _check("pos", pos, dt, (C, n, 3))
    _check("src", src, dt, (C, n) if mode == "charge" else (C, n, 3), dev)
    _check("site_ok", site_ok, torch.bool, (C, n), dev)
    _check("mol_id", mol_id, torch.int32, (C, n), dev)
    if box.ndim == 3:
        _check("box", box, dt, (C, 3, 3), dev)
    else:
        _check("box", box, dt, (3, 3), dev)
    if damp_kind not in _DAMP:
        raise ValueError(f"polar_damp_type {damp_kind} not supported")
    _, ni, nj = grid_shape(n)
    if visit is not None:
        _check("visit", visit, torch.int32, (C, ni, nj), dev)
    if fplan is None:
        fplan = plan_chains(box, rc, lam, n, C, visit)
    if active is not None and fplan.listed is None:
        fplan = subplan(fplan, active)
    elif active is not None and tuple(active) != fplan.listed:
        raise ValueError("plan: lists other chains than active")
    K = C if fplan.listed is None else len(fplan.listed)
    out = (torch.empty if K == C else torch.zeros)((C, n, 3), dtype=dt,
                                                   device=dev)
    if n == 0 or K == 0:
        return out, None
    blocks = card_config(dev, dt, mode)
    part, ticket = scratch(dev, max(fplan.slots, 1) * TI * 3, K * ni)
    from mpmc_tpu_torch.ops.cuda import _build
    fn = getattr(_build.library("thole_kernel"), "thole_field_" + _suffix(dt))
    err = fn(_ptr(pos), _ptr(src), _ptr(site_ok), _ptr(mol_id),
             _ptr(fplan.scal), 20 if fplan.scal.ndim == 2 else 0,
             _ptr(fplan.wl) if fplan.wl is not None else None,
             _ptr(fplan.chains) if fplan.chains is not None else None, K, n,
             ni, nj, int(mode == "dipole"), _DAMP[damp_kind], int(ortho),
             min(blocks, K * ni * nj), _ptr(part), _ptr(ticket), _ptr(out),
             _stream(dev))
    return out, err


def _launch_one(mode, pos, box, src, site_ok, mol_id, rc, lam, damp_kind,
                ortho, visit, fplan):
    """The single-chain call: the chain launch at C = 1."""
    n = pos.shape[0]
    _check("pos", pos, pos.dtype, (n, 3))
    _, ni, nj = grid_shape(n)
    if visit is not None:
        _check("visit", visit, torch.int32, (ni, nj), pos.device)
    if fplan is not None:
        check_plan(fplan, box, rc, lam, n, visit)
    out, err = _launch(mode, pos[None], box, src[None], site_ok[None],
                       mol_id[None], rc, lam, damp_kind, ortho,
                       None if visit is None else visit[None], fplan)
    return out[0], err


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
    out, err = _launch_one("charge", pos, box, charge, site_ok, mol_id, rc,
                           lam, damp_kind, ortho, visit, plan)
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
    out, err = _launch_one("dipole", pos, box, mu, site_ok, mol_id, rc,
                           lam, damp_kind, ortho, visit, plan)
    if err is not None:
        dipole_field.launches += 1
        _raise_on(err, "dipole_field")
    return out


dipole_field.launches = 0


def charge_field_chains(pos, box, site_ok, charge, mol_id, rc, lam,
                        damp_kind, ortho=False, visit=None, plan=None,
                        active=None):
    """B5 charge mode over a chain axis: the damped intermolecular static
    field [C, N, 3] of each chain (module docstring).  ``pos`` [C, N, 3],
    ``site_ok`` bool, ``charge`` and ``mol_id`` (int32) [C, N]; ``visit``
    [C, NI, NJ]; ``box`` and ``rc`` shared ([3, 3], 0-d) or one per chain
    ([C, 3, 3], [C]); ``plan`` from ``plan_chains`` (or its ``subplan``)
    with the same box, rc, lam, sizes and ``visit``; ``active`` a sorted
    host sequence of the chains to compute (the others come out as
    zeros)."""
    if pos.device.type == "cpu":
        return charge_field_chains_plain(pos, box, site_ok, charge, mol_id,
                                         rc, lam, damp_kind, ortho=ortho,
                                         visit=visit, active=active)
    if pos.device.type != "cuda":
        raise ValueError(f"charge_field_chains: no kernel for {pos.device}")
    if plan is not None:
        check_plan(plan, box, rc, lam, pos.shape[1], visit, pos.shape[0])
    out, err = _launch("charge", pos, box, charge, site_ok, mol_id, rc, lam,
                       damp_kind, ortho, visit, plan, active)
    if err is not None:
        charge_field_chains.launches += 1
        _raise_on(err, "charge_field_chains")
    return out


charge_field_chains.launches = 0


def dipole_field_chains(pos, box, site_ok, mu, mol_id, rc, lam, damp_kind,
                        ortho=False, visit=None, plan=None, active=None):
    """B5 dipole mode over a chain axis: each chain's matvec (T mu)
    [C, N, 3] (module docstring); ``mu`` [C, N, 3], zero where a site is
    not ok; the other arguments as for ``charge_field_chains``."""
    if pos.device.type == "cpu":
        return dipole_field_chains_plain(pos, box, site_ok, mu, mol_id, rc,
                                         lam, damp_kind, ortho=ortho,
                                         visit=visit, active=active)
    if pos.device.type != "cuda":
        raise ValueError(f"dipole_field_chains: no kernel for {pos.device}")
    if plan is not None:
        check_plan(plan, box, rc, lam, pos.shape[1], visit, pos.shape[0])
    out, err = _launch("dipole", pos, box, mu, site_ok, mol_id, rc, lam,
                       damp_kind, ortho, visit, plan, active)
    if err is not None:
        dipole_field_chains.launches += 1
        _raise_on(err, "dipole_field_chains")
    return out


dipole_field_chains.launches = 0


def reset_counts():
    """Zero every wrapper's launch counter."""
    charge_field.launches = 0
    dipole_field.launches = 0
    charge_field_chains.launches = 0
    dipole_field_chains.launches = 0
