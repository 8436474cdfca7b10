"""Shared by the parallel-tempering tests (test_torch_replica.py on the
CPU, test_torch_cuda.py on the card): a swap round recomputed on the host.
Imports nothing of JAX."""
import numpy as np
import torch


def recompute_round(rnd):
    """(new ladder, accepted, margin) of a PT round record recomputed on
    the host in float64 from its energies, counts and uniforms: the
    temperature rule, or the fugacity rule when the record has
    ``fugacity``.  ``margin``: the least |ln u - ln P| relative to
    1 + |ln P| over the round's pairs — a decision taken in float32 on
    the card may differ from float64's only where it is below ~1e-6."""
    host = {k: (v.double().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in rnd.items()}
    par, u = host["parity"], np.asarray(host["u"], np.float64)
    margins = [np.inf]
    if "fugacity" in host:
        f = host["fugacity"]
        new, acc = f.copy(), 0
        n = host["counts"]
        for lo in range(par, f.shape[0] - 1, 2):
            if n.ndim == 1:       # host route: the total-N rule
                ln_p = (n[lo] - n[lo + 1]) * np.log(f[lo + 1].sum()
                                                    / f[lo].sum())
            else:         # the per-species rule over sp_ids' columns
                lnf = np.log(f[:, list(host["sp_ids"])])
                ln_p = np.sum((n[lo] - n[lo + 1]) * (lnf[lo + 1] - lnf[lo]))
            margins.append(abs(np.log(u[lo]) - ln_p) / (1 + abs(ln_p)))
            if np.log(u[lo]) < ln_p:
                new[[lo, lo + 1]] = f[[lo + 1, lo]]
                acc += 1
        return new, acc, min(margins)
    t, e = host["temps"], host["energies"]
    new, acc = t.copy(), 0
    for lo in range(par, len(t) - 1, 2):
        ln_p = (1 / t[lo] - 1 / t[lo + 1]) * (e[lo] - e[lo + 1])
        if host["n_mols"] is not None:
            n = host["n_mols"]
            ln_p += (n[lo] - n[lo + 1]) * np.log(t[lo] / t[lo + 1])
        margins.append(abs(np.log(u[lo]) - ln_p) / (1 + abs(ln_p)))
        if np.log(u[lo]) < ln_p:
            new[lo], new[lo + 1] = t[lo + 1], t[lo]
            acc += 1
    return new, acc, min(margins)
