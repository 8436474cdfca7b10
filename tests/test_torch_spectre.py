"""The port's SPECTRE (mc/spectre.py, wired in mc/run.py) against the JAX
package on the CPU: the clamp and target renormalization, the S-flagged
site list and ``apply``, and the run: renormalization before each
refresh (the refreshed energy is the new charges' full energy, S(k),
self and frozen terms included), the block observables, the target
rescale, the fused NVT route, Ewald with free charges, the chains
warning, and the reference's run giving the same charge observables."""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpmc_tpu.io import input_script as jinput  # noqa: E402
from mpmc_tpu.mc import run as jrun  # noqa: E402
from mpmc_tpu.mc import spectre as jspectre  # noqa: E402
from mpmc_tpu_torch.io import input_script  # noqa: E402
from mpmc_tpu_torch.mc import metropolis as tm  # noqa: E402
from mpmc_tpu_torch.mc import run as trun  # noqa: E402
from mpmc_tpu_torch.mc import spectre as tspectre  # noqa: E402
from mpmc_tpu_torch.ops import energy as tenergy  # noqa: E402

torch.set_num_threads(1)

PQR = ("ATOM 1 FW FRZ 1 F 2.0 2.0 2.0 40.0 0.5 0.0 50.0 3.0\n"
       "ATOM 2 FW FRZ 1 F 10.0 10.0 10.0 40.0 -0.5 0.0 50.0 3.0\n"
       "ATOM 3 SP SPC 2 S 5.0 5.0 5.0 10.0 0.9 0.0 20.0 3.0\n"
       "ATOM 4 SP SPC 3 S 8.0 8.0 8.0 10.0 -0.7 0.0 20.0 3.0\n"
       "ATOM 5 AR ARG 4 M 11.0 4.0 7.0 39.9 0.0 0.0 100.0 3.2\n"
       "END\n")


def _deck_text(tmp_path, max_charge=0.5, target=0.0, extra=""):
    (tmp_path / "sp.pqr").write_text(PQR)
    t = f"spectre_max_target {target}\n" if target else ""
    return f"""
ensemble nvt
numsteps 300
corrtime 100
temperature 200
basis1 14 0 0
basis2 0 14 0
basis3 0 0 14
precision float64
rd_lrc off
spectre on
spectre_max_charge {max_charge}
{t}{extra}
pqr_input {tmp_path / 'sp.pqr'}
"""


def test_renormalize_matches_reference():
    """Clamp only, clamp and rescale onto the target, signs kept, the
    other charges untouched — the reference's numbers on seeded inputs."""
    q = np.array([0.0, 2.0, -3.0, 0.4, 1.0])
    idx = np.array([1, 2, 3])
    out = tspectre.renormalize_charges(q, idx, 1.0, 0.0)
    np.testing.assert_allclose(out, [0.0, 1.0, -1.0, 0.4, 1.0])
    out = tspectre.renormalize_charges(q, idx, 5.0, 2.7)
    assert np.sum(np.abs(out[idx])) == pytest.approx(2.7)
    np.testing.assert_allclose(out[[0, 4]], [0.0, 1.0])
    rng = np.random.default_rng(4)
    for mc, tg in ((0.3, 0.0), (0.8, 1.5), (2.0, 0.9)):
        q = rng.normal(size=40)
        idx = np.sort(rng.choice(40, 12, replace=False))
        np.testing.assert_array_equal(
            tspectre.renormalize_charges(q, idx, mc, tg),
            jspectre.renormalize_charges(q, idx, mc, tg))


def test_sites_and_apply_match_reference(tmp_path):
    """The S-flagged species, their atom rows and ``apply`` on the setup
    of one deck, against the reference's setup."""
    text = _deck_text(tmp_path, max_charge=0.6, target=1.0)
    su = trun.setup(input_script.parse(text), device="cpu")
    jsu = jrun.setup(jinput.parse(text))
    assert su.spectre_species == jsu.spectre_species == (0,)
    idx = tspectre.spectre_atom_indices(su.params, su.spectre_species)
    np.testing.assert_array_equal(idx, jspectre.spectre_atom_indices(
        jsu.params, jsu.spectre_species))
    assert len(idx) == 2
    p = tspectre.apply(su.params, idx, su.cfg)
    jp = jspectre.apply(jsu.params, idx, jsu.cfg)
    np.testing.assert_allclose(p.charge.numpy(), np.asarray(jp.charge),
                               rtol=0, atol=1e-15)
    assert p.charge.dtype == su.params.charge.dtype


def test_refresh_after_renormalization_is_the_new_charges_energy(tmp_path):
    """Charges renormalized between a chunk and its refresh: the refreshed
    state's energy (Ewald: S(k), self and exclusion; the frozen part) is
    the full energy with the new charges, and a further chunk keeps its
    bookkeeping (1e-9)."""
    text = _deck_text(tmp_path, max_charge=0.5, extra="coulomb ewald\n"
                      "ewald_kmax 4\n")
    su = trun.setup(input_script.parse(text), device="cpu")
    P, C, T = su.params, su.cfg, su.thermo
    st = tm.initialize(su.state, P, C, T)
    g = torch.Generator().manual_seed(0)
    st, _ = tm.run_chunk(st, P, C, T, 100, generator=g)
    idx = tspectre.spectre_atom_indices(P, su.spectre_species)
    P2 = tspectre.apply(P, idx, C)
    assert float(P2.charge[idx].abs().max()) == pytest.approx(0.5)
    st2 = tm.initialize(st, P2, C, T, frozen_rows=tm.frozen_refresh_rows(
        P2, C))
    e, ef, aux = tenergy.total_energy(st.pos, st.box, st.mol_alive, P2, C,
                                      T, split_frozen=True)
    for k in ("es_real", "es_recip", "es_self", "es_excl", "rd"):
        assert float(getattr(st2.energy, k)) == pytest.approx(
            float(getattr(e, k)), rel=1e-12, abs=1e-12), k
    torch.testing.assert_close(st2.sk_re, aux["sk_re"], rtol=0, atol=0)
    assert float(st2.e_frozen.total) == pytest.approx(float(ef.total),
                                                      rel=1e-12)
    st3, _ = tm.run_chunk(st2, P2, C, T, 100, generator=g)
    fresh = tm.initialize(st3, P2, C, T)
    assert float(st3.energy.total) == pytest.approx(
        float(fresh.energy.total), abs=1e-9)


@pytest.mark.parametrize("extra", ["", "fused_mc on\nwolf on\n"
                                   "precision float32\n"])
def test_run_renormalizes_and_reports(tmp_path, extra):
    """The run clamps |q| to 0.5 from the first corrtime, reports the
    reference's observables and names the sites; with fused_mc (NVT,
    wolf) the fused kernel's route takes the new charges every launch."""
    job = input_script.parse(_deck_text(tmp_path, 0.5, extra=extra))
    log = io.StringIO()
    su, avgs = trun.run(job, log=log, device="cpu")
    out = log.getvalue()
    assert "spectre: 2 free-charge sites" in out
    assert max(avgs.samples["spectre_max_abs_charge"]) <= 0.5 + 1e-12
    assert avgs.samples["spectre_total_charge"][0] == pytest.approx(1.0)
    if extra:
        assert "fused_mc: single-chain fused NVT kernel" in out
        assert "unsupported" not in out
    fresh = tm.initialize(su.state, su.params, su.cfg, su.thermo)
    assert float(su.state.energy.total) == pytest.approx(
        float(fresh.energy.total), rel=1e-5 if extra else 0.0,
        abs=0.0 if extra else 1e-9)


def test_run_with_target_rescale_matches_reference(tmp_path):
    """A target of 1.0 e: every block's sum |q| is 1.0, as the
    reference's run reports it."""
    text = _deck_text(tmp_path, max_charge=2.0, target=1.0)
    _, avgs = trun.run(input_script.parse(text), log=io.StringIO(),
                       device="cpu")
    _, javgs = jrun.run(jinput.parse(text), log=io.StringIO())
    np.testing.assert_allclose(avgs.samples["spectre_total_charge"], 1.0)
    np.testing.assert_allclose(avgs.samples["spectre_total_charge"],
                               javgs.samples["spectre_total_charge"])
    np.testing.assert_allclose(avgs.samples["spectre_max_abs_charge"],
                               javgs.samples["spectre_max_abs_charge"])


def test_chains_warn_and_ewald_takes_free_charges(tmp_path):
    """``chains 2`` runs with the reference's single-chain-only warning;
    Ewald with the (non-neutral) free charges needs no allow_charged_cell
    under spectre."""
    text = _deck_text(tmp_path, 0.5, extra="chains 2\ncoulomb ewald\n"
                      "ewald_kmax 3\nnumsteps 100\n")
    log = io.StringIO()
    trun.run(input_script.parse(text), log=log, device="cpu")
    assert ("WARNING: spectre charge renormalization runs only in the "
            "single-chain driver") in log.getvalue()
