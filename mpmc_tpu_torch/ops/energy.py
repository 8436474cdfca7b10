"""Total-energy dispatcher (port of mpmc_tpu/ops/energy.py, without cdvdw,
which the port refuses at setup): pair pass -> reciprocal/self
electrostatics -> long-range tail -> polarization SCF, summed into
per-term EnergyBreakdown slots.
"""
from __future__ import annotations

import torch

from mpmc_tpu_torch.ops import ewald, pairs, thole
from mpmc_tpu_torch.state import EnergyBreakdown


def total_energy(pos, box, mol_alive, params, cfg, thermo, mu0=None,
                 split_frozen=False, frozen_cached=None,
                 active_row_start=0, e0=None):
    """Full-system energy.

    Returns (EnergyBreakdown, aux) — or, with ``split_frozen``,
    (active, frozen, aux): the frozen part holds every term internal to
    the frozen framework (pairwise rd/es_real/es_excl/lrc plus its self
    energy), constant across MC moves and kept out of the delta
    accumulators.

    With ``frozen_cached`` (implies ``split_frozen``) the frozen-frozen
    part is not recomputed: the pair pass is restricted to rows >=
    ``active_row_start`` and ``frozen_cached`` is returned as the frozen
    part — the fast per-corrtime refresh.

    aux carries the structure factor (sk_re, sk_im) under Ewald and, with
    polarization, the induced dipoles ``mu`` (the solve warm-starts from
    ``mu0``), the static field ``e0``, the SCF iterations
    ``polar_iters`` and — when thole.residual_supported — the re-grounded
    CG residual ``r_pol`` = e0 - (mu/alpha - T mu).  ``e0``: the static
    field when the caller has it (multichain.initialize_batched computes
    every chain's in one launch), else computed here.
    """
    if cfg.cdvdw:
        raise NotImplementedError("cdvdw is not yet ported — ROADMAP A12b")
    dtype, dev = pos.dtype, pos.device
    alive = mol_alive[params.mol_id] & params.atom_ok
    atom_frozen = params.mol_frozen[params.mol_id]
    zero = torch.zeros((), dtype=dtype, device=dev)
    aux = {}

    reuse_ff = frozen_cached is not None
    if reuse_ff and not split_frozen:
        raise ValueError("frozen_cached requires split_frozen=True")
    if reuse_ff:
        pt = pairs.pair_pass(pos, box, alive, params, cfg,
                             thermo.temperature, split_frozen=False,
                             row_start=active_row_start)
        pt_ff = None
    else:
        pt = pairs.pair_pass(pos, box, alive, params, cfg,
                             thermo.temperature, split_frozen=split_frozen)
        pt, pt_ff = pt if split_frozen else (pt, None)

    rc = pairs.derived_cutoff(box, cfg)
    volume = torch.abs(torch.linalg.det(box))

    # RD long-range tail (LJ or the dispersion expansion): U = (1/2V) *
    # [ 2 * (i<j inter sum) + self images ]
    lrc = lrc_ff = zero
    if pairs.lrc_on(cfg):
        if split_frozen:
            sc_act = pairs.lrc_self_coefficient(alive & ~atom_frozen,
                                                params, cfg, rc)
            lrc = (pt.lrc_coeff + 0.5 * sc_act) / volume
            if not reuse_ff:
                sc_ff = pairs.lrc_self_coefficient(alive & atom_frozen,
                                                   params, cfg, rc)
                lrc_ff = (pt_ff.lrc_coeff + 0.5 * sc_ff) / volume
        else:
            sc = pairs.lrc_self_coefficient(alive, params, cfg, rc)
            lrc = (pt.lrc_coeff + 0.5 * sc) / volume

    es_recip = es_self = es_self_ff = zero
    if cfg.coulomb == "ewald":
        alpha = pairs.derived_alpha(rc, cfg)
        es_recip, (sk_re, sk_im) = ewald.recip_energy(
            pos, params.charge, alive, box, alpha, cfg.ewald_kmax)
        # charged-cell jellium correction (zero when neutral), ACTIVE slot
        bg = ewald.background_correction(params.charge, alive, alpha,
                                         volume)
        if split_frozen:
            es_self = ewald.self_energy(params.charge,
                                        alive & ~atom_frozen, alpha) + bg
            if not reuse_ff:
                es_self_ff = ewald.self_energy(params.charge,
                                               alive & atom_frozen, alpha)
        else:
            es_self = ewald.self_energy(params.charge, alive, alpha) + bg
        aux["sk_re"], aux["sk_im"] = sk_re, sk_im
    elif cfg.coulomb == "wolf":
        alpha = pairs.derived_alpha(rc, cfg)
        if split_frozen:
            es_self = ewald.wolf_self_energy(
                params.charge, alive & ~atom_frozen, alpha, rc)
            if not reuse_ff:
                es_self_ff = ewald.wolf_self_energy(
                    params.charge, alive & atom_frozen, alpha, rc)
        else:
            es_self = ewald.wolf_self_energy(params.charge, alive, alpha, rc)

    polar = zero
    if cfg.polarization:
        if e0 is None:
            e0 = thole.static_field(pos, box, alive, params, cfg)
        mu, n_iter, _ = thole.solve_scf(pos, box, alive, params, cfg, e0,
                                        mu0)
        polar = thole.polar_energy(mu, e0)
        aux["mu"], aux["e0"], aux["polar_iters"] = mu, e0, n_iter
        if thole.residual_supported(cfg):
            # re-ground the carried residual exactly (CG's recurrence
            # residual drifts from the true one): one matvec per refresh
            pol_ok = alive & (params.polar > 0)
            inv_a = torch.where(pol_ok,
                                1.0 / torch.clamp(params.polar, min=1e-30),
                                torch.zeros_like(params.polar))[:, None]
            t_mu = thole.dipole_matvec(pos, box, alive, params, cfg, mu)
            r_pol = e0 - (inv_a * mu - t_mu)
            aux["r_pol"] = torch.where(pol_ok[:, None], r_pol,
                                       torch.zeros_like(r_pol))

    e = EnergyBreakdown(
        rd=pt.rd, lrc=lrc, es_real=pt.es_real, es_recip=es_recip,
        es_self=es_self, es_excl=pt.es_excl, polar=polar, vdw=zero)
    if not split_frozen:
        return e, aux
    if reuse_ff:
        return e, frozen_cached, aux
    e_frozen = EnergyBreakdown(
        rd=pt_ff.rd, lrc=lrc_ff, es_real=pt_ff.es_real, es_recip=zero,
        es_self=es_self_ff, es_excl=pt_ff.es_excl, polar=zero, vdw=zero)
    return e, e_frozen, aux
