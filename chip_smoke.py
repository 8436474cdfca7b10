"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises, so the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build  — the CUDA kernels from mpmc_tpu_torch/csrc (one nvcc per
   source, all at once), with build seconds;
3. kernels — B2 (pair_terms, one launch over its tile work list) at
   row_start 0 and F and B4 (mol_pair) against their plain PyTorch
   versions on the 10.8k-atom bench system (MOF lattice n_side=21 + 512
   H2 slots), float32 and float64, with CUDA-event timings per call and
   on the card alone (time_device), and the launch floor (an empty kernel
   timed the same way); B4's launch shape (mol_pair_plan) and ptxas's
   registers, spills and shared memory of its two kernels in f32 and
   f64;
4. B1 — the fused µVT kernel (run_steps_uvt, one thread-block cluster of
   G CTAs per chain) against its plain version on the same system, at
   every cluster size G whose slice fits: one numpy-seeded [C=2, K=256,
   16] uniform table in float64 and float32 (the same decisions,
   positions and sums within the stated tolerances), each chain of the
   C = 2 launch against a C = 1 launch on its own block at the same G,
   and CUDA-event timings of 1000-step launches at C = 1 and C = 32, at
   each G and at the G the wrapper picks;
4b. B3 — the fused NVT kernel (run_steps) against its plain version on
   the 10.0k MOF + H2 NVT system and the 10k LJ fluid, each after 2,000
   steps off its lattice: a numpy-seeded [2, 256, 16] table in float64 and
   float32 at every G (B1's checks and tolerances), NVE on the LJ fluid,
   and CUDA-event timings of 1000-step launches (MOF at C = 1 and 16, LJ
   at C = 1) beside the bound;
5. energy — total_energy on the card (float32, kernels) against the port
   on the CPU (float64, plain), term by term; the CPU references run in a
   process of their own (``chip_smoke.py --cpu-references``, 4 threads)
   from the build's end, beside the card's phases, and the comparison
   runs last;
6. scan path — the 10.8k system written to PQR and run as a GCMC deck
   through mpmc_tpu_torch.mc.run.run (2000 steps): B2 and B4 must have
   been launched by it, and the carried energy of a further chunk must
   match a fresh recompute; a profiled chunk shows where a step's time
   goes; then examples/h2_sorption.inp (1000 steps);
7. fused path — the same deck with ``fused_mc on`` (20,000 steps): B1 and
   B2 must have been launched, the carried energy of a further chunk
   must match a fresh recompute, the kernel alone is timed and a chunk
   profiled; then ``chains 32`` (the reference's headline width), with
   the bookkeeping of chain 0 and of the last chain and a profiled chunk;
8. fused NVT — the MOF + H2 deck under ``ensemble nvt`` with ``fused_mc
   on`` (10,000 steps, one chain and ``chains 16``), the LJ fluid deck
   under nvt (10,000 steps) and nve (5,000 steps, total_energy from an
   ``ensemble te`` run): B3 launched once per corrtime, bookkeeping after
   a further chunk, the NVE reservoir positive; profiled MOF chunks at
   C = 1 and 16 with B3's share of the device time;
9. polar — the 10.8k system with polarizable framework sites through
   run.run (phase_polar): plain Metropolis, the scan-path delayed
   acceptance and the rc 14 A tile-culled CG, 100 steps each, B5 in
   every CG iteration, with bookkeeping of the polar term, B5 launches
   against CG iterations, host syncs and a profile per step;
9b. fused polar DA — the same system with ``polar_delayed on`` and
   ``fused_mc on`` (phase_pda_decks): the direct field, ``polar_wolf on``
   and ``cutoff 14``, 100 steps each through run.run — B6 per segment,
   the exact SCF per survivor — with the same checks, B6 launches per
   step and B6's share of a profiled chunk.

10. batched scan chains — B4 over a chain axis (phase_mol_pair_chains:
   C = 1 against the single-chain launch bit for bit, C = 2 and 128
   against the plain version, chains with an empty pick included, times
   and bound at C = 128; at C = 16 a [16, 20] header, each chain in its
   own scaled box, against the plain version, a shared header equal to
   its row repeated bit for bit, times and bound), then DECK with
   ``chains 128`` and no fused_mc
   (phase_batched: 200 steps, the aggregate rate, B4 and B2 launches,
   every chain's bookkeeping after a further chunk, the busy share);
11. parallel tempering (phase_pt) — 8 replicas, 77-250 K or 1-10 atm:
   fused NVT over B3, fused µVT over B1, batched scan chains with host
   swaps, pt_fugacity over B1, and the polar deck as batched polar
   chains; each ladder a permutation of its rungs and its last swap round
   recomputed on the host;
12. the restart write (phase_restart_write) — the Python writer and the
   native one on the 10.8k system in turns, median ms, equal bytes;
13. batched polar chains — B5 over a chain axis (phase_thole_chains: 8
   chains of the polar system moved apart by B1, both modes, dense and
   rc 14 culled, float64 and float32: each chain its single-chain launch
   bit for bit, C = 1 and an active subset too, within B5's tolerance of
   the plain version; times and the bound), then the polar deck with
   ``chains 8`` (phase_polar_chains: plain, ``polar_delayed on``,
   ``cutoff 14``, 100 steps each: every chain's polar bookkeeping, B5
   launches == CG rounds, host syncs, a profile); PT deck (v) of phase 11
   is the polar deck as 8 replicas;
14. exact checkpoints (phase_checkpoint) — DECK on the scan path and with
   ``fused_mc on``: two corrtime blocks twice, then one block with
   ``checkpoint_output`` and one with ``checkpoint_input``; the resumed
   state as close to the uninterrupted one as two uninterrupted runs are
   to each other; save and load ms and bytes;
15. replay (phase_replay) — ``ensemble replay`` over a 10-frame LJ
   trajectory with ``calc_pressure on`` and a 10-frame GCMC one (N
   changing), each written by a port run: B2 launches per frame, the LJ
   run's first frame's and the GCMC run's last frame's card terms against
   CPU float64, the pressure
   within the bound of its energies' float32 rounding; frames/s and the
   reader's ms per frame;
15b. analyze (phase_analyze) — every frame, insertion and geometry
   analyzer of mpmc_tpu_torch.analyze in float64 on the card over those
   two trajectories at the reference's defaults: rdf, density (0.7 A),
   loading, cluster, msd and orient of the GCMC one's H2, sq of the LJ
   fluid, widom and widom_mol (h2_bss3) at 2,000 tries a frame, pore
   (20,000 points, 2,000 centres) and asa (512 points a sphere) over its
   framework; frames/s (pore, asa: seconds), and each held against the
   same call on the CPU in the replay references' process (cuts:
   ANALYZE_CUTS), integers equal, floats within rel 1e-9, pairs that
   move bins within 1e-9 A of an edge;
16. isotherm campaign (phase_campaign) — ``python -m
   mpmc_tpu_torch.campaign``'s main on DECK, 16 chains at 0.5, 1 and 2
   atm, twice uninterrupted and once stopped after the first pressure and
   resumed from its checkpoint directory: the rows against each other, B4
   over chains and B2 on every point, chain-steps/s;
17. NPT (phase_npt) — the 10k LJ fluid at its virial pressure on the scan
   path (3000 steps), on the hybrid fused path (``fused_mc on``, 20,000
   steps: B3 segments between scan-path volume attempts) and as 16
   batched chains (200 steps, a B4 header per chain): steps/s, volume
   attempts and acceptances, <V> and its drift, B2 launches == volume
   attempts x chains + refreshes, B3 launches == segments, every chain's
   bookkeeping after a further chunk, one chain against the chain run
   alone over the same rows, the cost of a volume attempt;
18. the library PT drivers (phase_pt_drivers) — 8 replicas, 1,024 steps a
   round, 6 rounds, 77-250 K on the 10.8k GCMC system: NVT per replica
   (B3) and in one launch (B3), µVT in one launch (B1): aggregate steps/s
   with the swaps, the final ladder a permutation, launches per round,
   B2 launches per refresh;
19. Feynman-Hibbs / Feynman-Kleinert kernels (phase_fh_kernels) — B1 on
   the 10.8k bench system with FH2, FH4 and FK at C = 2 (77 and 120 K, a
   beta per chain) and C = 1 (chain 0's bits), B3 on the MOF + H2 NVT
   system with FH2, FH4 and FK at C = 2, B6 on the polar system with FH2,
   each against its plain version at G = 16 on one numpy-seeded table;
   times per step beside the classical launch's in the same call, the
   plain version's and the bound with the quantum operations counted;
20. the FH/FK decks (phase_fh_decks) — DECK with ``feynman_hibbs on`` on
   the scan path (300 steps) and on fused µVT (5,000), with
   ``feynman_kleinert on`` on fused µVT (5,000), the MOF NVT deck with FH
   order 4 (5,000), PDA (d) with FH (100), and examples/h2_quantum_fk.inp
   through mpmc_tpu_torch's command-line main (10,000 steps): the pair
   passes' route logged, B2/B4 never launched, the fused kernel launched,
   the carried energy against a fresh recompute after a further chunk,
   |rd(FH/FK) - rd(classical)| > 1 K on the final configuration.
   Phase 5 (energy) also holds the card's FH2 and FK terms against CPU
   float64;
21. cavity bias and TMMC kernels (phase_xt_kernels) — B1's and B6's XT
   instances (cavity_grid 10, cavity_radius 2.5, tmmc, tmmc_bias with a
   seeded random eta) against their plain versions: B1 on the 10.8k bench
   system at C = 1 (G = 16) and C = 32, equal decisions, slot aliveness
   and TMMC attempt counts, the Sigma a columns within _sum_a_tol; B6 on
   the polar system with forced survivors, natural coins and a
   survivor-free table; times per step beside the classical instance's;
22. the cavity / TMMC decks (phase_xt_decks) — DECK with cavity_bias on
   the scan path (300 steps), with cavity_bias and tmmc_bias on fused µVT
   (5,000), with tmmc and chains 32 (5,000), PDA (d) with tmmc and
   cavity_bias (100), and examples/h2_polar_tmmc.inp through the
   command-line main (2,000 of its 6,000 steps) with ``analyze tmmc`` on
   its matrix: the route and kernel launches, n_open at every refresh,
   TMMC attempts == insert + delete attempts, the carried energy against
   a fresh recompute;
23. the rotor table (phase_qrot_table) — B4 at position stride 0 over the
   512 orientations of the first rotors of the bench system past the
   card's grid_min (B4's regime 1) against its plain version and bit for
   bit against the same launch over an expanded, copied pos (regime 2);
   the refresh's one launch over all 256 rotors (C = 131,072) bit for bit
   its four 64-rotor launches and the expanded launch on its first and
   last 8,192 chains; both launches timed beside the bound; a refresh of
   DECK's 256 rotors timed (B4 and the host eigensolves apart, one B4
   launch); 4 rotors' F_para, F_ortho against CPU float64 within the Weyl
   bound of their grids' |dV|;
24. spinflip kernels (phase_sf_kernels) — B1's XT instance with spinflip
   at C = 1 (G = 16) and at C = 32 with cavity bias and TMMC too, B3's SF
   instance on the MOF + H2 NVT system at C = 1 and 16, B6's XT instance
   on PDA (d) with a forced spinflip survivor, against their plain
   versions with each state's real rotor table: equal decisions and
   spins; times beside the instance without spinflip in the same call;
25. the spinflip decks (phase_sf_decks) — DECK with quantum_rotation on
   the scan path (300 steps), fused µVT (2,000), ``chains 32`` (200),
   fused MOF NVT (2,000), PDA (d) (100) and the 8-replica B1 ladder (400),
   each at corrtime <= 200: the route, the kernel and the rotor grid
   launched, the ortho fraction, spinflip acceptance, ms per refresh, and
   the carried energy against a fresh recompute after a further chunk;
26. RD form kernels (phase_rd_kernels) — B2 and B4's instance of each RD
   form (sg, dreiding, b14_7, disp_expansion damped with its tail) on the
   bench system with its LJ wells mapped to the form
   (systems.rd_form_columns): B2 at row_start F and 0, B4 on an H2's rows
   and a trial, over 128 chains and at position stride 0 (the rotors'
   512 orientations past grid_min, regime 1, and bit for bit the
   expanded launch; one 64-rotor launch timed), each against its plain
   version in float64 and float32; times and bounds (OPS_RD_*), B4's
   launch shapes and ptxas lines;
27. the RD decks (phase_rd_decks) — the disp_expansion µVT scan deck
   (1,000 steps, C10 from extrapolate_disp_coeffs), its ``chains 16``
   deck (200), its Thole-polar scan deck (100), a ``gwp on`` deck (200,
   the plain pass: B2 and B4 never launched), and the sg, dreiding and
   b14_7 scan decks (300 each): the pair route, steps/s, and the carried
   energy against a fresh recompute after a further chunk;
28. the fused kernels' form instances (phase_rd_fused_kernels) — B1, B3
   and B6's instance of each RD form and of coulomb gwp (LJ; widths
   0.2-0.6 A, numpy seed 17) against its plain version in float64 and
   float32: B1 on the bench system under the form at C = 1 (G = 16) and
   C = 32, and B1's gwp instance with the Feynman-Hibbs terms (lj, FH2)
   at C = 1, B3 on the MOF + H2 NVT system at C = 2 (G = 16) and C = 16,
   B6 on the polar system with forced survivors, natural coins and a
   survivor-free table; times per step beside the classical instance's
   in the same call, the plain version's and the bound with the form's
   operations (OPS_RD_IN, OPS_RD_MIX_FUSED, OPS_GWP_SMEAR);
29. the fused form decks (phase_rd_fused_decks) — RD_FUSED_DECKS: fused
   µVT with disp_expansion (damped, its tail on) on one chain (2,000
   steps) and ``chains 32`` (1,000), the MOF NVT deck (2,000) and PDA (d)
   (100, PHAHST's shape with Thole) with it, fused µVT with gwp (also
   under ``feynman_hibbs on``), sg, dreiding and b14_7 (2,000 each), and
   the other forms' NVT (1,000) and
   PDA (100) decks: the fused route and the form instances logged, the
   kernel launched, steps/s, and the carried energy against a fresh
   recompute after a further chunk;
30. B5 with a header per chain (phase_thole_header) — the polar NPT
   fluid (3,456 polarizable H2) rescaled into 8 cells (edges -5 % .. +5
   %): a [8, 20] header in one launch, a shared header equal to the same
   header repeated and each chain equal to its lone launch in its own
   cell bit for bit, culled equal to dense, each chain within
   phase_thole_chains' tolerance of the plain version; times beside the
   shared-header launch;
31. polar NPT (phase_polar_npt) — that fluid (77 K, 200 atm) on the scan
   path (300 steps) and as 8 batched chains (100): volume attempts and
   acceptances, <V>, CG iterations per volume attempt, B2 == attempts x
   chains + refreshes, B5 launched, polar bookkeeping;
32. A12b's energy terms — cdvdw on a 512-site Drude fluid with and
   without cdvdw_sig_repulsion (phase_cdvdw: the eigensolve's share,
   float64 bookkeeping at 1e-9, vdw against the CPU), rd_crystal on fcc
   argon at order 3 (phase_rd_crystal: the fcc lattice sum, card against
   CPU), SPECTRE with 32 S-flagged charges in the bench system
   (phase_spectre: the clamp and target every block, bookkeeping) and
   quantum_vibration in DECK (phase_qvib: one stride-0 B4 launch per
   refresh, the grid against plain, levels against CPU float64);
33. B2 over a batch of geometries (phase_b2_chains) — pair_terms_chains
   on 512 BSS H2 dimers (float64 and float32: every entry its lone launch
   bit for bit, C = 1 pair_terms, within _tol of the plain version) and
   on two geometries of the 10.8k system at row_start F; times at C =
   512 beside a lone dimer launch, the bound;
34. cell_list (phase_cell_list) — DECK with cutoff 12 and ``cell_list
   on``: the scan path (500 steps; B4 never launched), ``chains 16``
   (200), fused µVT (1,000, rd_lrc off) bit for bit against the same
   deck without the option, and with rd_lrc the reference's tail trap
   refused; bookkeeping; the culled pass beside B4's dense delta and
   the share of framework columns the cells cover;
35. mol_cache (phase_mol_cache) — DECK with RunConfig(mol_cache=True)
   (a 513 x 513 cache): the scan path (1,000 steps) and ``chains 16``
   (200), the carried cache against a fresh pair_matrix after each run
   and a further chunk, bookkeeping;
36. the surf drivers (phase_surf) — the BSS H2 dimer scan (surf_ang 45:
   102,400 orientation pairs a separation, 2.5-8.0 A by 0.5, one B2 x
   512 launch a batch), the polar scan (surf_ang 90; B5 over the batch),
   an argon surf_fit (60 points, 2,000 SA steps) and a surf_multi_fit
   (256 four-H2 configurations): launches per batch or evaluation,
   surf_output's lines, parameters recovered.
37. multi-device (ROADMAP A13; every time here of ranks that share the
   one card: the route, not the scaling) — phase_spatial: two gloo ranks
   (``chip_smoke.py --md-rank``) run ``ensemble te`` with
   ``spatial_devices 2`` on DECK (each term against the single-rank te),
   the polar bench system's sharded energy (the polar term within
   _polar_tol, CG iterations beside one rank's), a 200-step spatial µVT
   scan (the ranks' digests equal at every block, carried energy against
   a fresh recompute, steps/s, collectives a step and their share) and
   each rank's strips against their plain versions (B2 on its row tiles,
   B4 on its column range and, on rank 0, the full range bit for bit the
   launch without one, B5 with its row tiles' visit table), beside a
   world-size-1 NCCL group's sharded te; phase_chain_devices: ``chains
   32`` fused µVT and the 8-replica B3 PT deck with ``chain_devices 2``
   (each rank's block after the first chunk bit for bit this process's
   launch of it, the ladder a permutation); phase_multihost_pt: the PT
   deck through ``python -m mpmc_tpu_torch --distributed --dist-backend
   gloo`` as two processes, its JSONL history equal to
   phase_chain_devices's.

Phase 4c (phase_thole_kernel) holds B5, both modes, against its plain
version on that polar system, dense and culled (culled == dense bit for
bit; each check's share of its tolerance logged), phase 4d
(phase_pda_kernel) holds B6, one thread-block cluster of G CTAs,
against its plain version there at every G whose slice fits and at the
wrapper's own (direct, wolf, ewald fields and nvt; float64 and float32),
and phase 5 adds its polar term.

The second-to-last line is a JSON object with each kernel's launches on
its main path, error against its plain version, times (``ms`` per call
around its wrapper, ``device_ms`` on the card alone: back-to-back launches
between one pair of events) and bound; the last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"pair_terms": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "pair_terms_chains": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "mol_pair": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "run_steps_uvt": "mpmc_tpu_torch/csrc/uvt_kernel.cu",
           "run_steps": "mpmc_tpu_torch/csrc/nvt_kernel.cu",
           "dipole_field": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "charge_field": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "run_steps_uvt_pda": "mpmc_tpu_torch/csrc/pda_kernel.cu",
           "mol_pair_c128": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "dipole_field_c8": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "mol_pair_c16_header": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "run_steps_uvt_fh2": "mpmc_tpu_torch/csrc/uvt_kernel.cu",
           "run_steps_uvt_fk": "mpmc_tpu_torch/csrc/uvt_kernel.cu",
           "run_steps_fh4": "mpmc_tpu_torch/csrc/nvt_kernel.cu",
           "run_steps_uvt_pda_fh2": "mpmc_tpu_torch/csrc/pda_kernel.cu",
           "run_steps_uvt_xt": "mpmc_tpu_torch/csrc/uvt_xt_kernel.cu",
           "run_steps_uvt_xt_c32": "mpmc_tpu_torch/csrc/uvt_xt_kernel.cu",
           "run_steps_uvt_pda_xt": "mpmc_tpu_torch/csrc/pda_xt_kernel.cu",
           "mol_pair_grid": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "run_steps_uvt_sf": "mpmc_tpu_torch/csrc/uvt_xt_kernel.cu",
           "run_steps_uvt_sf_c32": "mpmc_tpu_torch/csrc/uvt_xt_kernel.cu",
           "run_steps_sf": "mpmc_tpu_torch/csrc/nvt_sf_kernel.cu",
           "run_steps_uvt_pda_sf": "mpmc_tpu_torch/csrc/pda_xt_kernel.cu",
           **{f"{k}_{f}": f"mpmc_tpu_torch/csrc/pair_{f}_kernel.cu"
              for k in ("pair_terms", "mol_pair")
              for f in ("sg", "dreiding", "b14_7", "disp")},
           "mol_pair_chains_disp": "mpmc_tpu_torch/csrc/pair_disp_kernel.cu",
           "dipole_field_c8_header": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           # the spatial strips (A13): B2 on a rank's row tiles, B4 on its
           # column range, B5 with its row tiles' visit table
           "pair_terms_strip": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "mol_pair_cols": "mpmc_tpu_torch/csrc/pair_kernel.cu",
           "dipole_field_strip": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           "charge_field_strip": "mpmc_tpu_torch/csrc/thole_kernel.cu",
           **{f"run_steps_uvt_{f}": f"mpmc_tpu_torch/csrc/uvt_{f}_kernel.cu"
              for f in ("sg", "dreiding", "b14_7", "disp", "gwp")},
           "run_steps_uvt_disp_c32": "mpmc_tpu_torch/csrc/uvt_disp_kernel.cu",
           "run_steps_uvt_gwp_fh2": "mpmc_tpu_torch/csrc/uvt_gwp_kernel.cu",
           **{f"run_steps_{f}": f"mpmc_tpu_torch/csrc/nvt_{f}_kernel.cu"
              for f in ("sg", "dreiding", "b14_7", "disp", "gwp")},
           **{f"run_steps_uvt_pda_{f}":
              f"mpmc_tpu_torch/csrc/pda_{f}_kernel.cu"
              for f in ("sg", "dreiding", "b14_7", "disp", "gwp")}}
REPLACES = {"pair_terms": "mpmc_tpu/ops/pallas/pair_kernel.py:79",
            "pair_terms_chains": "mpmc_tpu/ops/pallas/pair_kernel.py:79",
            "mol_pair": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "run_steps_uvt": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps": "mpmc_tpu/ops/pallas/mc_kernel.py:220",
            "dipole_field": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "charge_field": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "run_steps_uvt_pda": "mpmc_tpu/ops/pallas/mc_kernel.py:2089",
            "mol_pair_c128": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "dipole_field_c8": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "mol_pair_c16_header": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "run_steps_uvt_fh2": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_uvt_fk": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_fh4": "mpmc_tpu/ops/pallas/mc_kernel.py:220",
            "run_steps_uvt_pda_fh2": "mpmc_tpu/ops/pallas/mc_kernel.py:2089",
            "run_steps_uvt_xt": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_uvt_xt_c32": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_uvt_pda_xt": "mpmc_tpu/ops/pallas/mc_kernel.py:2089",
            "mol_pair_grid": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "run_steps_uvt_sf": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_uvt_sf_c32": "mpmc_tpu/ops/pallas/mc_kernel.py:910",
            "run_steps_sf": "mpmc_tpu/ops/pallas/mc_kernel.py:220",
            "run_steps_uvt_pda_sf": "mpmc_tpu/ops/pallas/mc_kernel.py:2089",
            **{f"pair_terms_{f}": "mpmc_tpu/ops/pallas/pair_kernel.py:79"
               for f in ("sg", "dreiding", "b14_7", "disp")},
            **{f"mol_pair_{f}": "mpmc_tpu/ops/pallas/pair_kernel.py:336"
               for f in ("sg", "dreiding", "b14_7", "disp")},
            "mol_pair_chains_disp": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "dipole_field_c8_header": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "pair_terms_strip": "mpmc_tpu/ops/pallas/pair_kernel.py:79",
            "mol_pair_cols": "mpmc_tpu/ops/pallas/pair_kernel.py:336",
            "dipole_field_strip": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            "charge_field_strip": "mpmc_tpu/ops/pallas/thole_kernel.py:68",
            **{f"run_steps_uvt_{f}": "mpmc_tpu/ops/pallas/mc_kernel.py:910"
               for f in ("sg", "dreiding", "b14_7", "disp", "gwp",
                         "disp_c32", "gwp_fh2")},
            **{f"run_steps_{f}": "mpmc_tpu/ops/pallas/mc_kernel.py:220"
               for f in ("sg", "dreiding", "b14_7", "disp", "gwp")},
            **{f"run_steps_uvt_pda_{f}":
               "mpmc_tpu/ops/pallas/mc_kernel.py:2089"
               for f in ("sg", "dreiding", "b14_7", "disp", "gwp")}}
# NVIDIA H100 SXM peaks (data sheet, at the 700 W limit): f32 outside the
# tensor cores, and device memory
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# floating-point operations per evaluated pair (a square root, division,
# erfc/erf or rounding counted as one), as the sources' notes count them:
# B2/B4 general-box minimum image 36, r^2 and guard 6, LJ 13, LJ tail 11,
# Coulomb and exclusion 9, sums 4.  B1 and B3 (csrc/mc_common.cuh
# pair_values and column_pass), for every pair: displacement 3,
# orthorhombic minimum image 12, r^2 5, cutoff test 1, sums 3; for a pair
# within rc only: the r^2 guard 1, LJ 13 (rd lj), the real-space Ewald
# term 6 (coulomb on); per k-vector phase 13, per reciprocal term 9
OPS_PAIR_B2B4 = 79
# operations of a form's RD energy for a pair within rc (csrc/
# pair_kernel.cuh rd_form; a square root, division, exp or pow counted as
# one): sg 30 (r 1, the floor 2, exp(a - b r - g r^2) 5, r^2 and r^6 3,
# the four dispersion terms 10, the damping 6, the sum 3); dreiding 15 (r
# 1, D0 2, r0 3, p 1, the exponential 4, p^-6 2, the sum 2); b14_7 36 (r
# 1, r0 11, the mixed eps 8, p 1, the buffered term 6, p^7 and its factor
# 7, 2); disp_expansion 67 (r 1, A 3, B 5, the Born-Mayer term 4, r^2 and
# r^6 3, the damping 39: x, one exp, ten terms of 3, three factors of 2,
# the three dispersion terms 12); disp_expansion's C mixing 9 and tail 6
# for every counted pair; beside them a pair of the RD form instances
# costs OPS_PAIR_B2B4 less LJ (13) and the LJ tail (11)
OPS_RD_IN = {"sg": 30, "dreiding": 15, "b14_7": 36, "disp_expansion": 67}
OPS_RD_ANY = {"sg": 0, "dreiding": 0, "b14_7": 0, "disp_expansion": 15}
OPS_PAIR_RD_BASE = OPS_PAIR_B2B4 - 13 - 11
OPS_PAIR_FUSED, OPS_GUARD, OPS_LJ, OPS_COULOMB = 24, 1, 13, 6
# B1, B3 and B6's form instances (csrc/mc_cluster.cuh pair_energy_form),
# per pair within rc, beside the guard: the form's energy (OPS_RD_IN, r
# included), disp_expansion's three geometric means of its C's (3 each:
# the product, the floor, the square root), and under coulomb gwp the
# smear beside the Coulomb term (s^2 3, the floor 1, 2 s^2 1, the square
# root 1, the division 1, erf 1, the product 1)
OPS_RD_MIX_FUSED = {"disp_expansion": 9}
OPS_GWP_SMEAR = 9
OPS_PHASE_FUSED, OPS_K_FUSED = 13, 9
# B5 (csrc/thole_kernel.cu), for every pair it evaluates: displacement 3,
# orthorhombic minimum image 12, r^2 5, cutoff test 1; for a pair inside
# rc: guard 1, reciprocal square root 1, exponential damping 15, and the
# dipole-mode field 24 (1/r^3 2, mu.dr 5, coefficients 5, three components
# 12) or the charge-mode field 9 (coefficient 3, three components 6)
OPS_B5_PAIR = 21
OPS_B5_IN = {"dipole": 1 + 1 + 15 + 24, "charge": 1 + 1 + 15 + 9}
# B6 (csrc/pda_kernel.cu), beyond B1's per-pair and per-phase counts: for
# a pair inside rc the field coefficient — guard 1, square root 1, the
# exponential d1 8, then direct d1/r^3 2 or the screened kernel 17 (erfc,
# exp, the shift and the near field) — and the source's share of dE_j 7
# (q c 1, three multiply-adds); the field at the trial row 7 per new pair
# inside rc (and at the old row under polar_ewald); per surrogate column
# alpha_j (2 E0.dE + |dE|^2) 14
OPS_B6_FIELD = {"direct": 1 + 1 + 8 + 2 + 7, "screened": 1 + 1 + 8 + 17 + 7}
OPS_B6_ROW, OPS_B6_COL = 7, 14
# B1, B3 and B6 under a quantum correction (csrc/mc_common.cuh
# quantum_pair, quantum_column), keyed by mc_kernel.quantum_option: per
# pair within rc, FH2 20 (r, 1/r, s12, 4 eps, V' 5, V'' 6, the term 4, the
# sum 1), FH4 41 (+ r^-3 2, V''' 5, V'''' 6, the term 7, the sum 1), FK 228
# (the derivatives 28, then the fixed point: 13 to start, 8 rounds of 20
# - sqrt, x coth x - 1 with an exp and a division, a2, the new curvature
# -, 26 to finish with ln(sinh x / x), the sum 1); per column the reduced
# mass 4, with FH2's prefactor 7, FH4's 12
OPS_QC_PAIR = {0: 0, 1: 20, 2: 41, 3: 228}
OPS_QC_COL = {0: 0, 1: 7, 2: 12, 3: 4}
# the corrections the FH phases run, as cfg fields, and the temperatures
# of the two chains of a C = 2 launch
FH_VARIANTS = {"classical": {"feynman_hibbs": False,
                             "feynman_kleinert": False},
               "fh2": {"feynman_hibbs": True},
               "fh4": {"feynman_hibbs": True, "feynman_hibbs_order": 4},
               "fk": {"feynman_kleinert": True}}
FH_TEMPS = (77.0, 120.0)
EPS32 = float(np.finfo(np.float32).eps)
# the explicit cutoff of the culled polar cell (the reference's rc14 row)
RC_CULL = 14.0
# the polar decks: steps each, and a corrtime short enough that a deck
# makes several per-corrtime refreshes (a full SCF solve each)
# one block of the polar decks (cut from two, 200 steps, for the time limit)
POLAR_STEPS, POLAR_CORRTIME = 100, 100
# the bench system: mof_h2_gcmc(n_side=21, spacing=4.0, n_h2=256,
# capacity=512) -> 9,261 framework atoms + 512 x 3 H2 sites
N_SIDE, N_H2, CAPACITY = 21, 256, 512
# the 10k LJ fluid of the reference's NVT benchmark: argon, 0.0212 A^-3,
# box 77.8 A, 120 K; the NVE reservoir per atom of the reference's test
N_LJ = 10000
NVE_K_PER_ATOM = 180.0
# a reservoir whose effective temperature (2/3 of it per atom: 400 K) is
# far from the fluid's 120 K, where NVE and NVT decisions must differ
NVE_K_FAR = 600.0
SLOTS = ("rd", "es_real", "es_excl", "lrc", "rd_ff", "es_real_ff",
         "es_excl_ff", "lrc_ff", "min_r2")
MOL_SLOTS = ("rd", "es_real", "lrc", "min_r2")


def log(*a):
    print(*a, flush=True)


def time_calls(fn, device, n=10):
    """Median ms of ``n`` CUDA-event-timed calls (after one warm-up), or
    of host-clock calls on the CPU."""
    fn()
    ts = []
    for _ in range(n):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def time_device(fn, device, n=100):
    """ms per call of ``n`` back-to-back calls between one pair of CUDA
    events, queued behind a spin kernel (torch.cuda._sleep) long enough
    that the host has queued every call before the card starts them: the
    card's own time per call, with no host gap between launches.  Retries
    with a longer spin if the card caught up with the host."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    spin = max(0.02, 3.0 * n * (time.perf_counter() - t0))
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2e9))      # cycles at up to 2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ahead = not a.query()      # the spin still ran when all were queued
        torch.cuda.synchronize(device)
        if ahead:
            return a.elapsed_time(b) / n
        spin *= 4.0
    raise AssertionError("time_device: the host did not queue ahead of the "
                         "card")


def null_launch_ms(device, n=200):
    """The launch floor: time_device of an empty kernel (a spin of 0
    cycles)."""
    return time_device(lambda: torch.cuda._sleep(0), device, n)


def _clock_host(fn, device):
    """Seconds of one call of ``fn`` on the host clock, the card idle
    before and after."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke run needs a CUDA device")
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    return dev, smi


def phase_build():
    from mpmc_tpu_torch.ops.cuda import _build
    t0 = time.time()
    paths = _build.build(force=True)
    secs = time.time() - t0
    for name in paths:
        _build.library(name)
    log(f"build: {secs:.1f} s (one nvcc per source, in parallel) -> "
        + ", ".join(os.path.relpath(p, REPO) for p in paths.values()))
    for path in paths.values():
        for line in path.with_suffix(".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                log("  ptxas: " + line.strip())
    return secs


def _b4_ptxas(lib):
    """ptxas's lines of B4's two kernels in library ``lib`` (a pair
    library): {"grid f32": "registers ..., spills ...", ...}."""
    import re
    from mpmc_tpu_torch.ops.cuda import _build
    out, cur = {}, None
    for ln in _build.target(lib).with_suffix(
            ".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"mol_pair_(grid|cluster)_kernelI([fd])", ln)
            cur = (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'}"
                   if m else None)
        elif cur and ("registers" in ln or "spill" in ln):
            out[cur] = (out.get(cur, "") + "; "
                        + ln.split(":", 1)[-1].strip()).strip("; ")
    return out


def _bound_ms(ops, nbytes):
    """(bound ms, bound_by): the larger of ops at the f32 peak and bytes
    at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _in_rc_ops(cfg):
    """Operations of a B1/B3/B6 pair within rc: the guard, the RD term (LJ,
    or a form's energy with disp_expansion's C mixing), the Coulomb term
    (gwp: with its smear) and a quantum correction's."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    rd = cfg.rd_potential
    return (OPS_GUARD + (OPS_LJ if rd == "lj" else OPS_RD_IN.get(rd, 0)
                         + OPS_RD_MIX_FUSED.get(rd, 0))
            + (OPS_COULOMB + OPS_GWP_SMEAR * (cfg.coulomb == "gwp"))
            * (cfg.coulomb != "none")
            + OPS_QC_PAIR[mk.quantum_option(cfg)])


def _fused_ops(trace, cfg, nk):
    """Floating-point operations of chain 0's steps in a plain B1 or B3
    trace: what this run's data needs (pairs beyond rc stop after the
    cutoff test; no LJ or Coulomb operations where the term is off; a
    quantum correction's per pair within rc and per column)."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    qc = mk.quantum_option(cfg)
    in_rc = _in_rc_ops(cfg)
    return sum(int(t["pairs"][0]) * OPS_PAIR_FUSED
               + int(t["pairs_in"][0]) * in_rc
               + int(t["cols"][0]) * OPS_QC_COL[qc]
               + int(t["phases"][0]) * OPS_PHASE_FUSED
               + (int(t["phases"][0]) > 0) * nk * OPS_K_FUSED for t in trace)


def bench_system(dtype, device, n_side=N_SIDE, n_h2=N_H2,
                 capacity=CAPACITY, polarization=False):
    from mpmc_tpu_torch.models import systems
    return systems.mof_h2_gcmc(n_side=n_side, n_h2=n_h2, capacity=capacity,
                               polarization=polarization, dtype=dtype,
                               device=device)


def _tol(dtype, ref, p32=None):
    """Allowed |kernel - plain|.  float64: rel 1e-12 or abs 1e-6 K (the
    sums cancel across ~1e7 terms of either sign, so an absolute floor
    at float64 rounding of the summed magnitudes is needed).  float32:
    rel 2e-5, or 4x the distance of the plain float32 result from the
    float64 one (float32 rounding of a cancelling sum), or abs 1e-3."""
    if dtype == torch.float64:
        return np.maximum(1e-12 * np.abs(ref), 1e-6)
    return np.maximum.reduce([2e-5 * np.abs(ref), 4.0 * np.abs(p32 - ref),
                              np.full_like(ref, 1e-3)])


def phase_kernels(device, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY):
    """Each kernel against its plain version on the same card tensors."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    report = {"pair_terms": {"max_abs_err": 0.0},
              "mol_pair": {"max_abs_err": 0.0}}
    ref64 = {}
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = bench_system(dtype, device, n_side,
                                                  n_h2, capacity)
        F = metropolis.frozen_refresh_rows(params, cfg)
        alive = state.atom_alive(params)
        frozen = params.mol_frozen[params.mol_id]
        scal = pairs.pair_scalars(state.box, cfg)
        args = (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, alive, frozen, scal, cfg)
        for rs in (0, F):
            k = pk.pair_terms(*args, row_start=rs)
            p = pk.pair_terms_plain(*args, row_start=rs)
            k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
            key = ("pair_terms", rs)
            if dtype == "float64":
                ref64[key] = p
                tol = _tol(torch.float64, p)
            else:
                tol = _tol(torch.float32, ref64[key], p)
                p = ref64[key]
            err = np.abs(k - p)
            fin = np.isfinite(p)
            ms = time_calls(lambda: pk.pair_terms(*args, row_start=rs),
                            device)
            dms = time_device(lambda: pk.pair_terms(*args, row_start=rs),
                              device, n=50)
            pms = time_calls(lambda: pk.pair_terms_plain(
                *args, row_start=rs), device, n=5)
            log(f"B2 pair_terms {dtype} row_start={rs}: kernel {ms:.3f} ms "
                f"per call, {dms:.4f} ms on the card alone; plain {pms:.3f} "
                "ms")
            for s, name in enumerate(SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not (np.all(err[fin] <= tol[fin])
                    and np.array_equal(np.isfinite(k), fin)):
                raise AssertionError(f"B2 {dtype} row_start={rs} disagrees "
                                     "with its plain version")
            report["pair_terms"]["max_abs_err"] = max(
                report["pair_terms"]["max_abs_err"], float(err[fin].max()))
            if dtype == "float32":
                # pairs this (row-restricted) pass counts: every alive row
                # >= rs against the alive columns above it and below rs
                idx = np.flatnonzero(alive.cpu().numpy())
                n_f = int(np.sum(idx < rs))
                pos_in = np.arange(len(idx))
                n_pairs = int(np.sum((len(idx) - pos_in - 1 + n_f)
                                     [idx >= rs]))
                bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4,
                                      _nbytes(*args[:8]) + 9 * 4)
                entry = dict(ms=ms, device_ms=dms, plain_ms=pms,
                             bound_ms=bound, bound_by=by, pairs=n_pairs,
                             tiles=pk.work_list(len(alive), rs,
                                                device).numel())
                if rs == F:
                    report["pair_terms"].update(entry)
                else:
                    report["pair_terms"]["full"] = entry
                log(f"    bound {bound:.5f} ms ({by}; {n_pairs} pairs, "
                    f"{entry['tiles']} tiles listed)")
        # B4: an alive H2 (current rows) and a trial next to the framework
        h2 = int(np.flatnonzero(
            (params.mol_species >= 0).cpu().numpy()
            & state.mol_alive.cpu().numpy())[0])
        # off the lattice's symmetry planes: no pair sits exactly at rc,
        # where the kernel's fused multiply-adds and the plain version's
        # separate roundings may count a tie differently
        near = state.pos[0] + torch.tensor([2.0, 0.31, 0.17],
                                           dtype=cfg.tdtype, device=device)
        trial = near + params.species_pos[0]
        for label, mol, rows in (("H2", h2, None),
                                 ("framework-adjacent", h2, trial)):
            m = torch.tensor(mol, device=device)
            margs = (state.pos, params.charge, params.eps, params.sig,
                     params.mol_id32, alive, params.mol_atoms,
                     params.mol_natoms, m, rows, scal, cfg)
            k = pk.mol_pair(*margs).double().cpu().numpy()
            p = pk.mol_pair_plain(*margs).double().cpu().numpy()
            key = ("mol_pair", label)
            if dtype == "float64":
                ref64[key] = p
                tol = _tol(torch.float64, p)
            else:
                tol = _tol(torch.float32, ref64[key], p)
                p = ref64[key]
            err = np.abs(k - p)
            ms = time_calls(lambda: pk.mol_pair(*margs), device)
            dms = time_device(lambda: pk.mol_pair(*margs), device, n=200)
            pms = time_calls(lambda: pk.mol_pair_plain(*margs), device)
            log(f"B4 mol_pair {dtype} {label}: kernel {ms:.4f} ms per call, "
                f"{dms:.4f} ms on the card alone; plain {pms:.4f} ms")
            for s, name in enumerate(MOL_SLOTS):
                log(f"    {name:11s} kernel {k[s]: .10e} ref {p[s]: .10e} "
                    f"|d| {err[s]:.3e} tol {tol[s]:.3e}")
            if not np.all(err <= tol):
                raise AssertionError(f"B4 {dtype} {label} disagrees with "
                                     "its plain version")
            report["mol_pair"]["max_abs_err"] = max(
                report["mol_pair"]["max_abs_err"], float(err.max()))
            if dtype == "float32" and label == "H2":
                own = (params.mol_id == h2).cpu().numpy()
                n_pairs = int(params.mol_natoms[h2]) * int(np.sum(
                    alive.cpu().numpy() & ~own))
                bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4,
                                      _nbytes(*margs[:11]) + 4 * 4)
                null = null_launch_ms(device)
                plan = pk.mol_pair_plan(len(alive), 1, False,
                                        torch.float32, cfg)
                ptx = _b4_ptxas("pair_kernel")
                report["mol_pair"].update(ms=ms, device_ms=dms, plain_ms=pms,
                                          bound_ms=bound, bound_by=by,
                                          null_device_ms=null, plan=plan,
                                          ptxas=ptx)
                log(f"    bound {bound:.5f} ms ({by}; {n_pairs} pairs); the "
                    f"launch floor (an empty kernel, back to back) {null:.4f}"
                    f" ms; launch shape {plan}")
                for k, v in ptx.items():
                    log(f"    B4 {k} ptxas: {v}")
    return report


def _first_divergence(counts_of, trace, K):
    """(step, chain, |ln u - ln acc| there) of the first step whose
    decision differs between the kernel and the plain trace, by bisection
    over launches on the leading steps of the table; ``counts_of(k)`` is
    the kernel's [C] accepted-move counts over the first k steps."""
    cum = torch.cumsum(torch.stack([t["accept"] for t in trace]).long(), 0)

    def agrees(k):
        return torch.equal(counts_of(k), cum[k - 1].cpu())

    lo, hi = 0, K              # agrees on lo steps, disagrees on hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if agrees(mid):
            lo = mid
        else:
            hi = mid
    step = hi - 1
    chain = int(torch.nonzero(counts_of(hi) != cum[step].cpu())[0])
    return step, chain, float(abs(trace[step]["margin"][chain]))


def _time_steps(launch, device, K, n=5):
    """Kernel ms per step of a K-step launch (CUDA events around each
    launch, median of n; a launch of K = 1000 steps lasts milliseconds, so
    the wrapper's host time is a small part of it)."""
    return time_calls(launch, device, n=n) / K


def _resident(entry, sfx):
    """{shape: {G: clusters resident at once}} of one B1/B3 entry, from
    the wrapper's occupancy queries."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    out = {}
    for key, n in sorted(mk.occupancy.items()):
        if key[:2] == (entry, sfx):
            out.setdefault(str(key[2:-1]), {})[key[-1]] = n
    return out


def phase_uvt_kernel(device, C=2, K=256, seed=2024, k_time=1000):
    """B1 against its plain version on one numpy-seeded [C, K, 16] table,
    at every cluster size G whose slice fits (16, 8, 4 and 2 in float32;
    16, 8 and 4 in float64).

    float64: identical move counts and aliveness, positions within 1e-9 A,
    sums within rel 1e-10 (abs 1e-8 K where a sum cancels to ~0).
    float32: the same decisions, positions within 1e-4 A, and each energy
    sum within 2e-5 of its size plus 2e-3 K x sqrt(accepted moves + 1):
    the phases k.r reach ~44 rad, whose float32 spacing (3.8e-6 rad) moves
    each accepted move's reciprocal delta by up to ~1e-3 K, and the kernel
    contracts multiply-adds into FMAs where the plain version rounds
    twice.  At each G, every chain of the C = 2 launch must equal, bit for
    bit, a C = 1 launch on its own block at the same G.  Times (float32,
    CUDA events, launches of ``k_time`` steps, per step): one chain and 32
    chains, at each G and at the G the wrapper picks, beside the plain
    version's time and the bound.  Returns the kernel's report entry."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    u_np = np.random.default_rng(seed).random((C, K, 16))
    rep = {"max_abs_err": 0.0, "checked_G": {}}
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = bench_system(dtype, device)
        state = metropolis.initialize(state, params, cfg, thermo)
        tables = metropolis.uvt_fused_tables(params, cfg)
        u = torch.as_tensor(u_np, dtype=cfg.tdtype, device=device)
        args, kw = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, u,
            tables)
        trace = []
        p = mk.run_steps_uvt_plain(*args, **kw, trace=trace)
        ps = p[2].cpu().numpy()
        f64 = dtype == "float64"
        n_acc = ps[:, 6:9].sum(1, keepdims=True)
        tol = (np.maximum(1e-10 * np.abs(ps[:, :6]), 1e-8) if f64 else
               2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0))
        sk_tol = 1e-9 if f64 else 1e-4 * (1.0 + float(p[3].abs().max()))
        n_all, nk, n_slots = (state.pos.shape[0], kw["kvecs"].shape[0],
                              args[6].shape[0])
        # every G that fits, largest first: the main paths use 16 for one
        # chain and, as the card's resident clusters allow, fewer for more
        sizes = mk.fitting_cluster_sizes(n_all, cfg.tdtype, nk,
                                         n_slots)[::-1]
        rep["checked_G"][dtype] = sizes
        for G in sizes:
            k = mk.run_steps_uvt(*args, **kw, cluster=G)
            torch.cuda.synchronize(device)
            ks = k[2].cpu().numpy()
            log(f"B1 {dtype} G={G} C={C} K={K}: kernel counts "
                f"{ks[:, 6:12].tolist()} plain {ps[:, 6:12].tolist()}")
            if not (np.array_equal(ks[:, 6:12], ps[:, 6:12])
                    and torch.equal(k[1], p[1])):
                step, chain, margin = _first_divergence(
                    lambda n: mk.run_steps_uvt(
                        *args[:24], args[24][:, :n].contiguous(), args[25],
                        **kw, cluster=G)[2][:, 6:9].sum(1).long().cpu(),
                    trace, K)
                raise AssertionError(
                    f"B1 {dtype} G={G}: decisions differ from the plain "
                    f"version; first at step {step} of chain {chain}, "
                    f"|ln u - ln acc| = {margin:.3e}")
            d_sums = np.abs(ks[:, :6] - ps[:, :6])
            d_pos = float((k[0] - p[0]).abs().max())
            d_sk = max(float((a - b).abs().max())
                       for a, b in zip(k[3:], p[3:]))
            for c in range(C):
                log("    sums kernel "
                    + " ".join(f"{x: .8e}" for x in ks[c, :6])
                    + "\n    sums plain  "
                    + " ".join(f"{x: .8e}" for x in ps[c, :6]))
            log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
                f"{tol.max():.3e}), pos {d_pos:.3e} A, S(k) {d_sk:.3e}")
            if not (np.all(d_sums <= tol)
                    and d_pos <= (1e-9 if f64 else 1e-4) and d_sk <= sk_tol):
                raise AssertionError(f"B1 {dtype} G={G} disagrees with its "
                                     "plain version")
            rep["max_abs_err"] = max(rep["max_abs_err"], float(d_sums.max()),
                                     d_pos, d_sk)
            # chain c of the C-chain launch == a C = 1 launch on its block,
            # both at this G
            for c in range(C):
                a1, kw1 = metropolis.fused_uvt_launch_args(
                    multichain.stack_states(state, 1), params, cfg, thermo,
                    u[c:c + 1], tables)
                one = mk.run_steps_uvt(*a1, **kw1, cluster=G)
                if not all(torch.equal(x[0], y[c]) for x, y in zip(one, k)):
                    raise AssertionError(
                        f"B1 {dtype} G={G}: chain {c} of the C={C} launch "
                        "differs from its C=1 launch")
            log(f"    G={G}: every chain equals its C=1 launch bit for bit")
        if f64:
            continue
        a1, kw1 = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, 1), params, cfg, thermo, u[:1],
            tables)
        one = mk.run_steps_uvt(*a1, **kw1)
        pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1),
                         device, n=2) / K
        ops = _fused_ops(trace, cfg, nk)
        # each input read once; out: pos, atom alive, slot alive, S(k)
        # and the sums written once
        n_in = _nbytes(*a1[:25], *kw1.values())
        n_out = _nbytes(one[0], a1[1], one[1], one[2], *one[3:])
        bound, by = _bound_ms(ops, n_in + n_out)
        rep.update(plain_ms=pms, bound_ms=bound / K, bound_by=by)
        for chains in (1, 32):
            ut = torch.as_tensor(np.random.default_rng(seed + chains).random(
                (chains, k_time, 16)), dtype=cfg.tdtype, device=device)
            at, kwt = metropolis.fused_uvt_launch_args(
                multichain.stack_states(state, chains), params, cfg, thermo,
                ut, tables)
            by_g = {G: _time_steps(
                lambda: mk.run_steps_uvt(*at, **kwt, cluster=G), device,
                k_time) for G in sizes}
            ms_step = _time_steps(lambda: mk.run_steps_uvt(*at, **kwt),
                                  device, k_time)
            dms_step = time_device(lambda: mk.run_steps_uvt(*at, **kwt),
                                   device, n=5) / k_time
            G = mk.run_steps_uvt.last_cluster
            rep[f"c{chains}"] = {"G": G, "ms": ms_step, "device_ms": dms_step,
                                 "by_G": by_g}
            log(f"B1 f32 C={chains}: kernel {ms_step * 1e3:.3f} us per step"
                f" at its G={G} ({k_time}-step launches; "
                f"{dms_step * 1e3:.3f} back to back); by G: "
                + ", ".join(f"{g} {t * 1e3:.3f}" for g, t in by_g.items()))
        rep.update(ms=rep["c1"]["ms"], device_ms=rep["c1"]["device_ms"],
                   cluster=f"G={rep['c1']['G']} (C=1), "
                   f"G={rep['c32']['G']} (C=32)")
        log("B1 f32 resident clusters by G (cudaOccupancyMaxActiveClusters):"
            f" {_resident('uvt_occupancy', 'f32')}")
        log(f"B1 f32 C=1: kernel {rep['ms'] * 1e3:.3f} us/step, plain "
            f"{pms * 1e3:.1f} us/step, bound {bound / K * 1e3:.4f} us/step "
            f"({by}; {ops / K:.3e} ops/step)")
    return rep


def nvt_system(kind, dtype, device, seed=31, warm_steps=2000):
    """(params, state, cfg, thermo) of a full-width B3 system on the card,
    after it has run: jittered off its lattice, then ``warm_steps`` fused
    steps (one B3 launch) and a fresh energy.  ``kind``: "mof" — the
    10.0k MOF + H2 system (mof_h2_gcmc(n_side=21, n_h2=256, capacity=256),
    nvt, N = 10,029) — or "lj" — the 10k LJ fluid (lj_fluid(n=10000))."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    if kind == "mof":
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=N_SIDE, n_h2=N_H2, capacity=N_H2, dtype=dtype,
            device=device)
    else:
        params, state, cfg, thermo = systems.lj_fluid(n=N_LJ, dtype=dtype,
                                                      device=device)
    cfg = dataclasses.replace(cfg, ensemble="nvt", fused_mc=True)
    state = metropolis.initialize(systems.jittered(params, state, seed),
                                  params, cfg, thermo)
    u = torch.as_tensor(np.random.default_rng(seed).random((warm_steps, 16)),
                        dtype=cfg.tdtype, device=device)
    state, _ = metropolis.run_chunk_fused(state, params, cfg, thermo,
                                          warm_steps, uniforms=u)
    return (params, metropolis.initialize(state, params, cfg, thermo), cfg,
            thermo)


def _nvt_check(label, system, u_np, device, rep, trace_out=None,
               sizes=None, rss=False, slopes=False):
    """B3 against its plain version on the table ``u_np`` [C, K, 16] for
    the stacked copies of ``system``'s state, at each cluster size G of
    ``sizes`` (None: every G whose slice fits); at each G every chain
    against a C = 1 launch on its own block at the same G, bit for bit.
    Tolerances as for B1 (with ``rss``: plus _rss_tol for rd and es, as
    the FH/FK comparisons hold them; with ``slopes`` in float32 also
    _slope_tol, the plain version run with its slopes).  Returns {G: (the
    C = 1 launch arguments of chain 0, its outputs)}."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C, K = u_np.shape[0], u_np.shape[1]
    f64 = cfg.tdtype == torch.float64
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    u = torch.as_tensor(u_np, dtype=cfg.tdtype, device=device)
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u, tables)
    trace = [] if trace_out is None else trace_out
    p = mk.run_steps_plain(*args, **kw, trace=trace, slopes=slopes)
    ps = p[1].cpu().numpy()
    ew = cfg.coulomb == "ewald"
    nk = kw["kvecs"].shape[0] if ew else 0
    n_acc = ps[:, 3:4]
    tol = (np.maximum(1e-10 * np.abs(ps[:, :3]), 1e-8) if f64 else
           2e-5 * np.abs(ps[:, :3]) + 2e-3 * np.sqrt(n_acc + 1.0))
    if rss:
        tol[:, :2] += _rss_tol(trace)
    if slopes and not f64:
        tol += _slope_tol(trace, state.box, 3)
    sk_tol = ((1e-9 if f64 else 1e-4 * (1.0 + float(p[2].abs().max())))
              if ew else 0.0)
    if sizes is None:
        sizes = mk.fitting_cluster_sizes(state.pos.shape[0], cfg.tdtype,
                                         nk)[::-1]
    firsts = {}
    for G in sizes:
        k = mk.run_steps(*args, **kw, cluster=G)
        torch.cuda.synchronize(device)
        ks = k[1].cpu().numpy()
        log(f"B3 {label} G={G} C={C} K={K}: kernel accepts "
            f"{ks[:, 3].tolist()} plain {ps[:, 3].tolist()}")
        if not np.array_equal(ks[:, 3], ps[:, 3]):
            step, chain, margin = _first_divergence(
                lambda n: mk.run_steps(
                    *args[:15], args[15][:, :n].contiguous(), args[16],
                    **kw, cluster=G)[1][:, 3].long().cpu(), trace, K)
            raise AssertionError(
                f"B3 {label} G={G}: decisions differ from the plain "
                f"version; first at step {step} of chain {chain}, |ln u - "
                f"ln acc| = {margin:.3e}")
        d_sums = np.abs(ks[:, :3] - ps[:, :3])
        d_pos = float((k[0] - p[0]).abs().max())
        d_sk = (max(float((a - b).abs().max())
                    for a, b in zip(k[2:], p[2:])) if ew else 0.0)
        for c in range(C):
            log("    sums kernel " + " ".join(f"{x: .8e}" for x in ks[c, :3])
                + "\n    sums plain  "
                + " ".join(f"{x: .8e}" for x in ps[c, :3]))
        log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
            f"{tol.max():.3e}), pos {d_pos:.3e} A, S(k) {d_sk:.3e}")
        if not (np.all(d_sums <= tol)
                and d_pos <= (1e-9 if f64 else 1e-4)
                and d_sk <= sk_tol):
            raise AssertionError(f"B3 {label} G={G} disagrees with its "
                                 "plain version")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d_sums.max()),
                                 d_pos, d_sk)
        for c in range(C):
            a1, kw1 = metropolis.fused_nvt_launch_args(
                multichain.stack_states(state, 1), params, cfg, thermo,
                u[c:c + 1], tables)
            one = mk.run_steps(*a1, **kw1, cluster=G)
            if not all(x is None or torch.equal(x[0], y[c])
                       for x, y in zip(one, k)):
                raise AssertionError(f"B3 {label} G={G}: chain {c} of the "
                                     f"C={C} launch differs from its C=1 "
                                     "launch")
            if c == 0:
                firsts[G] = (a1, kw1, one)
        if C > 1:
            log(f"    G={G}: every chain equals its C=1 launch bit for bit")
    return firsts


def phase_nvt_kernel(device, C=2, K=256, seed=2025, k_time=1000):
    """B3 against its plain version on both full-width systems, after
    they have run (nvt_system), in float64 and float32, on one
    numpy-seeded [C, K, 16] table, at every cluster size G whose slice
    fits: identical decisions, sums within the B1 tolerances, each chain
    of the C = 2 launch equal to its C = 1 launch at the same G bit for
    bit; NVE on the LJ fluid (C = 1, at one chain's G) at the reference's
    reservoir of 180 K per atom, whose effective temperature (2/3 of it)
    is the thermo's 120 K, and at NVE_K_FAR per atom, where Ray's rule
    must decide apart from Metropolis (its accept count differs from the
    NVT launch's on the same rows); and the kernel's time (CUDA events,
    median of 5 launches of ``k_time`` steps, per step): the MOF system
    at one chain and 16 chains, the LJ fluid at one chain, at each G and
    at the G the wrapper picks, beside the bound and the plain version's
    time.  Returns the kernel's report entry (times of the MOF system at
    C = 1)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    u_np = np.random.default_rng(seed).random((C, K, 16))
    rep = {"max_abs_err": 0.0}
    for kind in ("mof", "lj"):
        for dtype in ("float64", "float32"):
            system = nvt_system(kind, dtype, device)
            params, state, cfg, thermo = system
            trace = []
            firsts = _nvt_check(f"{kind} {dtype}", system, u_np, device,
                                rep, trace_out=trace)
            # the G the wrapper picks for one chain, from a default launch
            a1, kw1, _ = next(iter(firsts.values()))
            nk = 0 if kw1["kvecs"] is None else kw1["kvecs"].shape[0]
            mk.run_steps(*a1, **kw1)
            G1 = mk.run_steps.last_cluster
            a1, kw1, one = firsts[G1]
            if kind == "lj":
                e = state.reported_energy().total
                nve_cfg = dataclasses.replace(cfg, ensemble="nve")
                for per_atom in (NVE_K_PER_ATOM, NVE_K_FAR):
                    nve = (params, state, nve_cfg, thermo.replace(
                        nve_energy=e + per_atom * N_LJ))
                    acc = float(_nvt_check(
                        f"lj nve {per_atom:g} K/atom {dtype}", nve,
                        u_np[:1], device, rep, sizes=[G1])[G1][2][1][0, 3])
                    log(f"    accepts: nve {acc:g}, nvt "
                        f"{float(one[1][0, 3]):g} on the same rows")
                    if per_atom == NVE_K_FAR and acc == float(one[1][0, 3]):
                        raise AssertionError(
                            "B3 nve: the same accept count as nvt at an "
                            "effective temperature far from the thermo's")
            if dtype == "float64":
                continue
            pms = time_calls(lambda: mk.run_steps_plain(*a1, **kw1), device,
                             n=2) / K
            ops = _fused_ops(trace, cfg, nk)
            # each input read once; out: positions, S(k) and the sums
            bound, by = _bound_ms(ops, _nbytes(*a1[:16], *kw1.values())
                                  + _nbytes(*one))
            tables = metropolis.nvt_fused_tables(params, state.mol_alive)
            out = {"plain_ms": pms, "bound_ms": bound / K, "bound_by": by}
            for chains in ((1, 16) if kind == "mof" else (1,)):
                ut = torch.as_tensor(
                    np.random.default_rng(seed + chains).random(
                        (chains, k_time, 16)), dtype=cfg.tdtype,
                    device=device)
                at, kwt = metropolis.fused_nvt_launch_args(
                    multichain.stack_states(state, chains), params, cfg,
                    thermo, ut, tables)
                by_g = {G: _time_steps(
                    lambda: mk.run_steps(*at, **kwt, cluster=G), device,
                    k_time) for G in firsts}
                ms_step = _time_steps(lambda: mk.run_steps(*at, **kwt),
                                      device, k_time)
                dms_step = time_device(lambda: mk.run_steps(*at, **kwt),
                                       device, n=5) / k_time
                G = mk.run_steps.last_cluster
                out[f"c{chains}"] = {"G": G, "ms": ms_step,
                                     "device_ms": dms_step, "by_G": by_g}
                log(f"B3 {kind} f32 C={chains}: kernel {ms_step * 1e3:.3f} "
                    f"us per step at its G={G} ({k_time}-step launches; "
                    f"{dms_step * 1e3:.3f} back to back); by G: "
                    + ", ".join(f"{g} {t * 1e3:.3f}"
                                for g, t in by_g.items()))
            out["ms"] = out["c1"]["ms"]
            out["device_ms"] = out["c1"]["device_ms"]
            log(f"B3 {kind} f32 C=1: kernel {out['ms'] * 1e3:.3f} us/step, "
                f"plain {pms * 1e3:.1f} us/step, bound "
                f"{bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
                "ops/step)")
            rep[kind] = out
    rep.update({k: rep["mof"][k] for k in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")})
    rep["cluster"] = (f"G={rep['mof']['c1']['G']} (C=1), "
                      f"G={rep['mof']['c16']['G']} (C=16)")
    log("B3 f32 resident clusters by G (cudaOccupancyMaxActiveClusters):"
        f" {_resident('nvt_occupancy', 'f32')}")
    return rep


def polar_system(dtype, device, seed=37):
    """(params, state, cfg, thermo) of the polar bench system on the card
    (mof_h2_gcmc(n_side=21, n_h2=256, capacity=512, polarization=True):
    N = 10,797, framework sites 0.35 A^3), jittered off its lattice, with
    its energies, static field and converged dipoles from initialize."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    params, state, cfg, thermo = bench_system(dtype, device,
                                              polarization=True)
    state = metropolis.initialize(systems.jittered(params, state, seed),
                                  params, cfg, thermo)
    return params, state, cfg, thermo


def _b5_pairs(mode, pos, box, ok, mol, rc, visit=None, rows=256):
    """(pairs B5 evaluates, of them inside rc) for one call: ok rows
    against ok columns, i != j, another molecule in charge mode, visited
    tiles only — counted on the card in row chunks."""
    from mpmc_tpu_torch.ops import pbc
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    n = pos.shape[0]
    cols = torch.arange(n, device=pos.device)
    box_inv = torch.linalg.inv(box)
    n_eval = n_in = 0
    for i0 in range(0, n, rows):
        r = cols[i0:i0 + rows]
        m = ok[r][:, None] & ok[None, :] & (r[:, None] != cols[None, :])
        if mode == "charge":
            m &= mol[r][:, None] != mol[None, :]
        if visit is not None:
            m &= visit[(r // tk.TI)[:, None], (cols // tk.TJ)[None, :]] != 0
        dr = pbc.min_image(pos[r][:, None, :] - pos[None, :, :], box,
                           box_inv)
        inside = m & (torch.sum(dr * dr, -1) < rc * rc)
        n_eval += int(m.sum())
        n_in += int(inside.sum())
    return n_eval, n_in


def phase_thole_kernel(device):
    """B5 against its plain version on the polar bench system (N =
    10,797), float64 and float32, in both modes: dense at the derived rc
    (42 A), and at rc = RC_CULL on the cell-sorted sites (thole.cull_perm)
    with the tile-visit table (thole.cull_visit), where the culled launch
    must equal the dense launch on the same sorted input bit for bit.

    float64: max |kernel - plain| <= 1e-10 x the largest |E_i|.  float32:
    the plain version in float64 on the same float32 inputs is the
    reference; the kernel (double sums) may be at most 4x as far from it
    as the plain float32 version (float32 sums) is, or 2e-6 x the largest
    |E_i| (a few float32 roundings of one pair's contribution, ~1e-7 each,
    where the field nearly cancels).  Each check logs the share of its
    tolerance used.  Times (float32): per call (CUDA events around the
    wrapper, median of 20) with the call's plan built once, as solve_scf
    calls it, and without, and on the card alone (time_device), beside
    the bound and the plain version's time.  Returns {name: report
    entry}."""
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    rep = {"dipole_field": {"max_abs_err": 0.0, "tol_share": 0.0},
           "charge_field": {"max_abs_err": 0.0, "tol_share": 0.0}}
    funcs = {"dipole_field": (tk.dipole_field, tk.dipole_field_plain),
             "charge_field": (tk.charge_field, tk.charge_field_plain)}
    for dtype in ("float64", "float32"):
        params, state, cfg, _ = polar_system(dtype, device)
        alive = state.atom_alive(params)
        pol_ok = alive & (params.polar > 0)
        box, lam, kind = state.box, cfg.polar_damp, cfg.polar_damp_type
        mu = torch.where(pol_ok[:, None], state.mu, 0.0)
        rc = pairs.derived_cutoff(box, cfg)
        rc14 = torch.as_tensor(RC_CULL, dtype=box.dtype, device=device)
        for name, (kern, plain) in funcs.items():
            mode = name.split("_")[0]
            ok, src = (pol_ok, mu) if mode == "dipole" else (alive,
                                                            params.charge)
            perm, _ = thole.cull_perm(state.pos, box, ok, rc14)
            pos_s, ok_s = state.pos[perm], ok[perm]
            src_s, mol_s = src[perm].contiguous(), params.mol_id32[perm]
            visit = thole.cull_visit(pos_s, ok_s, box, rc14)
            cases = {
                "dense": ((state.pos, box, ok, src, params.mol_id32, rc,
                           lam, kind), None),
                f"rc{RC_CULL:g} culled": ((pos_s.contiguous(), box, ok_s,
                                           src_s, mol_s, rc14, lam, kind),
                                          visit)}
            for label, (args, vis) in cases.items():
                fplan = tk.plan(box, args[5], lam, args[0].shape[0], vis)
                k = kern(*args, ortho=True, visit=vis, plan=fplan)
                torch.cuda.synchronize(device)
                if not torch.equal(k, kern(*args, ortho=True, visit=vis)):
                    raise AssertionError(f"B5 {name} {dtype} {label}: the "
                                         "launch with a plan differs from "
                                         "the launch without")
                if vis is not None:
                    dense = kern(*args, ortho=True)
                    if not torch.equal(k, dense):
                        raise AssertionError(
                            f"B5 {name} {dtype}: the culled launch differs "
                            "from the dense launch on the same input")
                a64 = tuple(x.double() if torch.is_tensor(x)
                            and x.is_floating_point() else x for x in args)
                p64 = plain(*a64).cpu()
                scale = float(p64.abs().max())
                err = float((k.double().cpu() - p64).abs().max())
                if dtype == "float64":
                    tol = 1e-10 * scale
                else:
                    p32 = plain(*args).double().cpu()
                    tol = max(4.0 * float((p32 - p64).abs().max()),
                              2e-6 * scale)
                log(f"B5 {name} {dtype} {label}: max |E| {scale:.6e}, "
                    f"|kernel - plain| {err:.3e} (tol {tol:.3e}, "
                    f"{err / tol:.3f} of it)"
                    + (f", visit {float(vis.float().mean()):.3f} of "
                       f"{vis.numel()} tiles, culled == dense bit for bit"
                       if vis is not None else ""))
                if not err <= tol:
                    raise AssertionError(f"B5 {name} {dtype} {label} "
                                         "disagrees with its plain version")
                rep[name]["max_abs_err"] = max(rep[name]["max_abs_err"],
                                               err)
                rep[name]["tol_share"] = max(rep[name]["tol_share"],
                                             err / tol)
                if dtype == "float64":
                    continue

                def call(p=fplan):
                    return kern(*args, ortho=True, visit=vis, plan=p)

                ms = time_calls(call, device)
                ms_unplanned = time_calls(lambda: call(None), device)
                dms = time_device(call, device, n=50)
                pms = time_calls(lambda: plain(*args, visit=vis), device,
                                 n=3)
                n_eval, n_in = _b5_pairs(mode, args[0], box, args[2],
                                         args[4], args[5], vis)
                ops = n_eval * OPS_B5_PAIR + n_in * OPS_B5_IN[mode]
                # each input read once, the field written once
                nbytes = _nbytes(*args[:5], fplan.scal, vis, k)
                bound, by = _bound_ms(ops, nbytes)
                log(f"    f32 kernel {ms:.4f} ms per call ({ms_unplanned:.4f}"
                    f" building its plan), {dms:.4f} ms on the card alone; "
                    f"plain {pms:.3f} ms, bound {bound:.5f} ms ({by}; "
                    f"{n_eval} pairs evaluated, {n_in} inside rc)")
                entry = {"ms": ms, "device_ms": dms,
                         "unplanned_ms": ms_unplanned, "plain_ms": pms,
                         "bound_ms": bound, "bound_by": by, "pairs": n_eval,
                         "pairs_in": n_in}
                if label == "dense":
                    rep[name].update(entry)
                else:
                    rep[name]["culled"] = entry
    from mpmc_tpu_torch.ops.cuda import _build
    log("B5 f32 CTAs on the card (dipole, charge): "
        f"{tk.card_config(device, torch.float32, 'dipole')}, "
        f"{tk.card_config(device, torch.float32, 'charge')}; tiles "
        f"{tk.TI} x {tk.TJ}; " + "; ".join(
            ln.strip() for ln in _build.target("thole_kernel").with_suffix(
                ".ptxas.txt").read_text().splitlines()
            if "registers" in ln or "spill" in ln))
    return rep


PDA_VARIANTS = (("direct", {}), ("wolf", {"polar_wolf": True}),
                ("ewald", {"polar_ewald": True}), ("nvt", {"ensemble": "nvt"}))


def _pda_survivor_free(launch, u, rng):
    """``u`` [K,16] with every stage-1 coin 1 - 1e-7 and each row that
    still survives (a move with ln(acceptance) > ln u) drawn anew until
    the kernel runs all K rows: B6 never changes the state, so each row
    decides alone.  ``launch(u)`` returns B6's record."""
    u = u.clone()
    u[:, 4] = 1.0 - 1e-7
    for _ in range(400):
        rec = launch(u)
        if float(rec[0, 1]) < 0.5:
            return u
        k = int(rec[0, 0]) - 1
        u[k] = torch.as_tensor(rng.random(16), dtype=u.dtype)
        u[k, 4] = 1.0 - 1e-7
    raise AssertionError("B6: no survivor-free table found")


def _pda_ops(trace, field, nk, qc=0, cfg=None):
    """Floating-point operations of the steps in a plain B6 trace: B1's
    per-pair and per-phase counts plus the field and surrogate work, and
    a quantum correction's (mc_kernel.quantum_option ``qc``); with
    ``cfg``, a pair within rc as _in_rc_ops counts it (an RD form)."""
    f = OPS_B6_FIELD["direct" if field == "direct" else "screened"]
    in_rc = (OPS_GUARD + OPS_LJ + OPS_COULOMB + f + OPS_QC_PAIR[qc]
             if cfg is None else _in_rc_ops(cfg) + f)
    return sum(t["pairs"] * OPS_PAIR_FUSED
               + (t["in_old"] + t["in_new"]) * in_rc
               + (t["in_new"] + (field == "ewald") * t["in_old"]) * OPS_B6_ROW
               + t["cols"] * (OPS_B6_COL + OPS_QC_COL[qc])
               + t["phases"] * OPS_PHASE_FUSED
               + (t["phases"] > 0) * nk * OPS_K_FUSED for t in trace)


def phase_pda_kernel(device, seed=43):
    """B6 (run_steps_uvt_pda) against its plain version on the polar bench
    system (polar_system: N = 10,797, jittered, initialized under each
    field variant), float64 and float32, for the direct, polar_wolf and
    polar_ewald fields and ensemble nvt (insert_probability 0): on
    numpy-seeded [PDA_SEG, 16] tables — per move type one whose step 0
    survives (lane 4 = 1e-30; under nvt all three displace), one of
    natural coins, and a survivor-free one (every coin 1 - 1e-7, rows
    that still survive drawn anew: all 16 steps run).  Equal: n_done, hit,
    mtype, slot, species and attempts.  float64: the rows within 1e-9 A,
    the six deltas, d* and lnb within rel 1e-10 + 1e-8 K.  float32: rows
    within 1e-4 A; each value within 2e-5 of its size + 1e-3 K + 8 float32
    epsilons x the root sum of squares of its terms (the plain trace's
    rss): each pair's, column's or k-vector's term is rounded to float32
    once or twice in either version (the kernel contracts multiply-adds,
    the plain version rounds each product), so the two sums drift apart
    as a random walk of that scale.  Each table runs at every cluster
    size G whose slice (with the polar planes) fits, then at the G the
    wrapper picks.  Times (float32, direct, the survivor-free table, the
    wrapper's G): CUDA events, median of 20 launches, per launch and per
    step, beside the bound (operations from the plain trace, _pda_ops)
    and the plain version's time.  Returns the kernel's report entry (per
    step, with its G)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    rng = np.random.default_rng(seed)
    rep = {"max_abs_err": 0.0}
    K = mk.PDA_SEG
    for dtype in ("float64", "float32"):
        f64 = dtype == "float64"
        params, state0, cfg0, thermo0 = polar_system(dtype, device)
        for label, extra in PDA_VARIANTS:
            cfg = dataclasses.replace(cfg0, polar_delayed=True,
                                      fused_mc=True, **extra)
            state, thermo = state0, thermo0
            if label in ("wolf", "ewald"):     # this variant's static field
                state = metropolis.initialize(state0, params, cfg, thermo)
            if label == "nvt":
                thermo = thermo.replace(insert_probability=torch.zeros_like(
                    thermo.insert_probability))
            cfg_eff = mk.pda_effective_cfg(cfg, params)
            tables = metropolis.uvt_fused_tables(params, cfg_eff)
            consts = metropolis._uvt_chunk_consts(
                state.pos, state.box, params, thermo, cfg_eff, tables[5],
                tables[6])

            def args_of(u):
                return metropolis.pda_launch_args(state, params, cfg_eff,
                                                  thermo, u, tables, consts)

            def launch(u):
                a, kw = args_of(u)
                return mk.run_steps_uvt_pda(*a, **kw)

            def table(x):
                return torch.as_tensor(x, dtype=cfg.tdtype, device=device)

            us = {}
            for mt, lane8 in ((0, 0.9), (1, 0.1), (2, 0.4)):
                x = rng.random((K, 16))
                x[0, 4], x[0, 8] = 1e-30, lane8
                us[f"step 0 survives ({'disp ins del'.split()[mt]})"] = (
                    table(x))
            us["natural"] = table(rng.random((K, 16)))
            us["survivor-free"] = _pda_survivor_free(
                launch, table(rng.random((K, 16))), rng)
            hits = 0
            a0, kw0 = args_of(us["natural"])
            fits = mk.fitting_cluster_sizes(
                a0[0].shape[0], a0[0].dtype,
                kw0["kvecs"].shape[0] if kw0["kvecs"] is not None else 0,
                a0[8].shape[0], polar=True)
            for name, u in us.items():
                a, kw = args_of(u)
                trace = []
                p = mk.run_steps_uvt_pda_plain(*a, **kw,
                                               trace=trace).cpu().numpy()
                rss = np.zeros(8)
                if trace[-1].get("rss"):
                    rss[[0, 1, 2, 6]] = trace[-1]["rss"]
                want = np.concatenate([p[1, :6], p[0, 9:11]])
                tol = (1e-10 * np.abs(want) + 1e-8 if f64
                       else 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss)
                # every G whose slice fits, then the wrapper's own G
                for G in fits + [None]:
                    k = mk.run_steps_uvt_pda(*a, **kw,
                                             cluster=G).cpu().numpy()
                    torch.cuda.synchronize(device)
                    G_run = mk.run_steps_uvt_pda.last_cluster
                    same = np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                          p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
                    vals = np.concatenate([k[1, :6], k[0, 9:11]])
                    d_vals = np.abs(vals - want)
                    d_rows = float(np.abs(k[2:5] - p[2:5]).max())
                    which = "" if G else " (the wrapper's G)"
                    log(f"B6 {dtype} {label} {name} G={G_run}{which}: n_done "
                        f"{k[0, 0]:g} hit {k[0, 1]:g} mtype {k[0, 2]:g} "
                        f"(plain: {p[0, 0]:g} {p[0, 1]:g} {p[0, 2]:g}); "
                        f"|d| deltas/d*/lnb {d_vals.max():.3e} (worst "
                        f"|d|/tol {float(np.max(d_vals / tol)):.3f}), rows "
                        f"{d_rows:.3e} A; d* {k[0, 9]:.6f} K")
                    if not (same and np.all(d_vals <= tol)
                            and d_rows <= (1e-9 if f64 else 1e-4)):
                        margins = [f"{t['margin']:.3e}" for t in trace]
                        raise AssertionError(
                            f"B6 {dtype} {label} {name} G={G_run} disagrees "
                            f"with its plain version: kernel "
                            f"{k[:2].tolist()} plain {p[:2].tolist()}; "
                            f"plain margins {margins}")
                    rep["max_abs_err"] = max(rep["max_abs_err"],
                                             float(d_vals.max()), d_rows)
                hits += int(k[0, 1])
                if f64 or label != "direct" or name != "survivor-free":
                    continue
                if k[0, 0] != K or k[0, 1] != 0:
                    raise AssertionError("B6: the survivor-free table froze")
                ms = time_calls(lambda: mk.run_steps_uvt_pda(*a, **kw),
                                device)
                dms = time_device(lambda: mk.run_steps_uvt_pda(*a, **kw),
                                  device, n=20)
                pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw),
                                 device, n=3)
                nk = kw["kvecs"].shape[0]
                ops = _pda_ops(trace, label, nk)
                # each input read once, the record written once
                bound, by = _bound_ms(ops, _nbytes(*a, *kw.values())
                                      + 8 * 16 * 8)
                rep.update(ms=ms / K, device_ms=dms / K, plain_ms=pms / K,
                           bound_ms=bound / K, bound_by=by, launch_ms=ms,
                           plain_launch_ms=pms,
                           cluster=mk.run_steps_uvt_pda.last_cluster,
                           fitting_clusters=fits)
                log(f"B6 f32 direct, survivor-free table, G="
                    f"{rep['cluster']} (fitting: {fits}): kernel {ms:.4f} ms "
                    f"per launch of {K} steps ({ms / K * 1e3:.2f} us/step; "
                    f"{dms:.4f} ms back to back, {dms / K * 1e3:.2f} "
                    f"us/step), plain {pms:.3f} ms, bound "
                    f"{bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
                    "ops/step)")
            if hits < 3:
                raise AssertionError(f"B6 {dtype} {label}: only {hits} "
                                     "survivors on the forced tables")
    return rep


def _energy_terms(q, dtype, dev, n_side=N_SIDE, n_h2=N_H2,
                  capacity=CAPACITY):
    """{term: K} of the bench system's total energy on ``dev`` in
    ``dtype`` under the correction ``q`` (FH_VARIANTS): classical on the
    whole system, FH2 and FK on its active part (every pair with a
    sorbate site, the rows from the frozen prefix's end on, as the
    refresh's frozen reuse computes it)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import energy
    from mpmc_tpu_torch.state import EnergyBreakdown
    params, state, cfg, thermo = bench_system(dtype, dev, n_side, n_h2,
                                              capacity)
    F = metropolis.frozen_refresh_rows(params, cfg)
    cfg = dataclasses.replace(cfg, **FH_VARIANTS[q])
    if q == "classical":
        e, _ = energy.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo)
    else:
        e, _, _ = energy.total_energy(
            state.pos, state.box, state.mol_alive, params, cfg, thermo,
            split_frozen=True,
            frozen_cached=EnergyBreakdown.zero(cfg.tdtype, dev),
            active_row_start=F)
    return {k: float(v) for k, v in e.as_dict().items()}


def _polar_energy(dtype, dev, n_side=N_SIDE, n_h2=N_H2, capacity=CAPACITY):
    """(polar term K, CG iterations from mu = 0, _polar_tol) of the polar
    bench system on ``dev`` in ``dtype``."""
    from mpmc_tpu_torch.ops import energy
    params, state, cfg, thermo = bench_system(dtype, dev, n_side, n_h2,
                                              capacity, polarization=True)
    e, aux = energy.total_energy(state.pos, state.box, state.mol_alive,
                                 params, cfg, thermo)
    return (float(e.polar), int(aux["polar_iters"]),
            _polar_tol(state.replace(mu=aux["mu"], energy=e), params, cfg))


# phase_energy's references on the CPU (float64, and float32 for the
# rounding distance of _tol's rule): (correction or "polar", dtype)
CPU_REFERENCES = (("classical", "float64"), ("classical", "float32"),
                  ("fh2", "float64"), ("fh2", "float32"),
                  ("fk", "float64"), ("fk", "float32"), ("polar", "float64"))
# CPU threads of the process that computes them beside the card's phases
CPU_REFERENCE_THREADS = 4


def cpu_references(path):
    """Compute CPU_REFERENCES on the CPU and write them to ``path`` as JSON
    ({"<q> <dtype>": terms or [polar, iters, tol], "seconds": {...}}):
    the work of ``python3 chip_smoke.py --cpu-references <path>``, which
    main starts in a process of its own after the build, so that these
    minutes of CPU float64 run while the card's phases do."""
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    cpu = torch.device("cpu")
    out, secs = {}, {}
    for q, dtype in CPU_REFERENCES:
        t0 = time.time()
        out[f"{q} {dtype}"] = (_polar_energy(dtype, cpu) if q == "polar"
                               else _energy_terms(q, dtype, cpu))
        secs[f"{q} {dtype}"] = time.time() - t0
    out["seconds"] = secs
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


class _CpuReferences:
    """The process computing phase_energy's CPU references (cpu_references)
    while the card's phases run: started after the build; ``result()``
    waits for it and reads its file; ``stop()`` ends it if it still runs."""

    def __init__(self):
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        os.unlink(self.path)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(CPU_REFERENCE_THREADS))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-references",
             self.path], env=env, cwd=REPO)

    def result(self):
        rc = self.proc.wait()
        if rc != 0 or not os.path.exists(self.path):
            raise AssertionError(f"the CPU references' process failed ({rc})")
        with open(self.path) as f:
            out = json.load(f)
        os.unlink(self.path)
        return out

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.path):
            os.unlink(self.path)


def phase_energy(device, refs):
    """Card float32 (kernels) against CPU float64 (plain), per term, on the
    bench system classical (the whole system) and under FH2 and FK (whose
    pair terms take the plain tile pass on the card: B2's gate refuses
    them) on its active part (_energy_terms; the framework's own pairs, a
    constant of the run, are the classical case's); then the polar term
    of the polar bench system (B5 in both modes).  The CPU references
    come from ``refs`` (_CpuReferences), computed beside the card's
    phases."""
    cpu_refs = refs.result()
    log(f"CPU references: {json.dumps(cpu_refs.pop('seconds'))} s")
    for q in ("classical", "fh2", "fk"):
        out = {"card f32": _energy_terms(q, "float32", device),
               "cpu f64": cpu_refs[f"{q} float64"],
               "cpu f32": cpu_refs[f"{q} float32"]}
        for k in out["cpu f64"]:
            ref, got, p32 = out["cpu f64"][k], out["card f32"][k], \
                out["cpu f32"][k]
            # rel 1e-5 or abs 1e-2 K, or 4x the plain f32 rounding distance
            tol = max(1e-5 * abs(ref), 1e-2, 4.0 * abs(p32 - ref))
            log(f"    {q:9s} {k:9s} card {got: .8e} cpu-f64 {ref: .8e} "
                f"|d| {abs(got - ref):.3e} tol {tol:.3e}")
            if not abs(got - ref) <= tol:
                raise AssertionError(f"energy term {k} ({q}) disagrees")
    # the polar term on the same system with polarizable framework sites:
    # every other term is the one above; the polar energies differ by the
    # two solves' stopping residuals (_polar_tol) and float32 rounding
    pol = {"card f32": _polar_energy("float32", device),
           "cpu f64": tuple(cpu_refs["polar float64"])}
    for tag, (val, iters, _) in pol.items():
        log(f"energy polar {tag}: {val:.8e} K, {iters} CG iterations from "
            "mu = 0")
    # each _polar_tol covers two solves of its own |mu|: average them
    (got, _, tol_a), (ref, _, tol_b) = pol["card f32"], pol["cpu f64"]
    tol = 0.5 * (tol_a + tol_b)
    log(f"    polar     card {got: .8e} cpu-f64 {ref: .8e} "
        f"|d| {abs(got - ref):.3e} tol {tol:.3e}")
    if not (ref < 0 and abs(got - ref) <= tol):
        raise AssertionError("energy term polar disagrees")


DECK = """job_name bench10k
ensemble uvt
numsteps {numsteps}
corrtime 1000
seed 7
temperature 77
pressure 1.0
h2_fugacity on
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
insert_probability 0.5
move_factor 1.0
rot_factor 3.14159
cavity_autoreject_absolute 1.0
max_molecules 256
allow_charged_cell on
pqr_input bench10k.pqr
pqr_restart restart.pqr
"""


LJ_DECK = """job_name lj10k
ensemble nvt
numsteps {numsteps}
corrtime 1000
seed 7
temperature 120
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
move_factor 0.5
rot_factor 0
coulomb off
pqr_input lj10k.pqr
pqr_restart restart.pqr
"""


def _params_on(params, device="cpu", float64=False):
    """``params`` on ``device`` (its floating columns in float64 with
    ``float64``), the derived columns rebuilt; a field that is None (no
    cell index) stays None."""
    def move(t):
        if t is None:
            return None
        t = t.to(device)
        return t.double() if float64 and t.is_floating_point() else t
    return params.__class__(**{f.name: move(getattr(params, f.name))
                               for f in dataclasses.fields(params) if f.init})


def _reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    pk.reset_counts()
    mk.reset_counts()
    tk.reset_counts()


def _launch_counts():
    """Every kernel wrapper's launch count."""
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    return {"pair_terms": pk.pair_terms.launches,
            "pair_terms_chains": pk.pair_terms_chains.launches,
            "mol_pair": pk.mol_pair.launches,
            "mol_pair_chains": pk.mol_pair_chains.launches,
            "run_steps_uvt": mk.run_steps_uvt.launches,
            "run_steps": mk.run_steps.launches,
            "charge_field": tk.charge_field.launches,
            "dipole_field": tk.dipole_field.launches,
            "charge_field_chains": tk.charge_field_chains.launches,
            "dipole_field_chains": tk.dipole_field_chains.launches,
            "run_steps_uvt_pda": mk.run_steps_uvt_pda.launches}


def _run_deck(device, extra="", numsteps=3000, kind="mof", verbose=True,
              form=None, cfg_kw=None):
    """A full-size system written to PQR and run as a deck through run.run,
    every launch count set to 0 just before and read just after: ``kind``
    "mof" — the 10.8k system as DECK (plus ``extra`` lines) —, "polar" —
    the same system with polarizable framework sites (0.35 A^3), as DECK
    with ``polarization on`` and corrtime POLAR_CORRTIME — or "lj" — the
    10k LJ fluid as LJ_DECK.  An ``ensemble nve`` LJ deck gets
    total_energy = U0 + NVE_K_PER_ATOM x N, U0 from an ``ensemble te`` run
    of the same deck.  ``form`` (an RD form or "gwp"): the system's
    columns as _rd_params makes them, written with the PQR's extended
    columns (C10 left 0 under disp_expansion, for extrapolate_disp_coeffs
    to fill).  Without ``verbose`` only the run's last lines are logged.
    ``cfg_kw``: RunConfig fields set on the parsed job (a library option
    with no deck keyword: mol_cache).  Returns (Setup, averages, log text,
    launches)."""
    from mpmc_tpu_torch.io import input_script, pqr
    from mpmc_tpu_torch.mc import run
    from mpmc_tpu_torch.models import systems
    if kind == "mof":
        params, state, cfg, _ = bench_system("float32", "cpu")
        name, template, species = "bench10k", DECK, ["H2"]
    elif kind == "polar":
        params, state, cfg, _ = bench_system("float32", "cpu",
                                             polarization=True)
        name, species = "bench10k", ["H2"]
        template = (DECK.replace("corrtime 1000",
                                 f"corrtime {POLAR_CORRTIME}")
                    + "polarization on\n")
    else:
        params, state, cfg, _ = systems.lj_fluid(n=N_LJ, device="cpu")
        name, template, species = "lj10k", LJ_DECK, ["AR"]
    if form is not None:
        params, _ = _rd_params(params, cfg, form)
        if form == "disp_expansion":
            params = params.replace(c10=torch.zeros_like(params.c10))
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pqr.write_state(f"{name}.pqr", params, state, species,
                            extended=form is not None)
            text = template.format(numsteps=numsteps,
                                   L=float(state.box[0, 0]))
            if "ensemble nve" in extra:
                with open(f"{name}_te.inp", "w") as f:
                    f.write(text + "ensemble te\n")
                e0 = run.run(input_script.parse_file(f"{name}_te.inp"),
                             log=io.StringIO(), device=device)
                total = float(e0.total) + NVE_K_PER_ATOM * N_LJ
                log(f"NVE deck: U0 {float(e0.total):.6f} K (ensemble te), "
                    f"total_energy {total:.6f} K")
                extra += f"total_energy {total!r}\n"
            with open(f"{name}.inp", "w") as f:
                f.write(text + extra)
            job = input_script.parse_file(f"{name}.inp")
            if cfg_kw:
                job = dataclasses.replace(job, cfg=dataclasses.replace(
                    job.cfg, **cfg_kw))
            buf = io.StringIO()
            _reset_counts()
            su, avgs = run.run(job, log=buf, device=device)
            torch.cuda.synchronize(device)
            launches = _launch_counts()
        finally:
            os.chdir(old)
    text = buf.getvalue()
    log(text.rstrip() if verbose else "\n".join(text.splitlines()[-3:]))
    log(f"launches: {launches}")
    for k in ("N", "energy_total"):
        if not np.isfinite(avgs.mean(k)):
            raise AssertionError(f"non-finite average {k}")
    return su, avgs, text, launches


def _check_bookkeeping(label, st, su, polar=False):
    """Carried energy after a further chunk against a fresh recompute
    (rel 1e-4); with ``polar`` also the polar term, within
    _polar_tol(fresh state)."""
    from mpmc_tpu_torch.mc import metropolis
    fresh = metropolis.initialize(st, su.params, su.cfg, su.thermo)
    carried, full = float(st.energy.total), float(fresh.energy.total)
    log(f"bookkeeping {label}: carried {carried:.6f} fresh {full:.6f}")
    if not abs(carried - full) <= 1e-4 * max(abs(full), 1.0):
        raise AssertionError(f"{label}: carried energy drifted from a "
                             "fresh recompute beyond rel 1e-4")
    if polar:
        c_pol, f_pol = float(st.energy.polar), float(fresh.energy.polar)
        tol = _polar_tol(fresh, su.params, su.cfg)
        log(f"    polar carried {c_pol:.6f} fresh {f_pol:.6f} |d| "
            f"{abs(c_pol - f_pol):.3e} tol {tol:.3e}")
        if not abs(c_pol - f_pol) <= tol:
            raise AssertionError(f"{label}: carried polar energy drifted "
                                 "from a fresh solve")


def _polar_tol(state, params, cfg):
    """Allowed difference of two polar energies of one configuration, each
    from a CG solve stopped at an rms residual r <= polar_precision per
    component: at the fixed point the energy error of a residual r is
    (ke/2) mu.r, so two solves differ by at most ke |mu| |r| <= ke |mu|
    polar_precision sqrt(3 n_pol) (Cauchy-Schwarz), plus float32 rounding
    of the field and the energy sum, rel 1e-4."""
    from mpmc_tpu_torch.constants import KE
    pol = state.atom_alive(params) & (params.polar > 0)
    n_pol = int(pol.sum())
    mu_norm = float(torch.sqrt(torch.sum(
        torch.where(pol[:, None], state.mu, 0.0) ** 2)))
    return (KE * mu_norm * cfg.polar_precision * (3 * n_pol) ** 0.5
            + 1e-4 * abs(float(state.energy.polar)))


def phase_main(device, numsteps=2000):
    """The port's scan path at full size through run.run."""
    from mpmc_tpu_torch.mc import metropolis
    su, avgs, text, launches = _run_deck(device, numsteps=numsteps)
    if not (launches["pair_terms"] > 0 and launches["mol_pair"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k scan path: {rate:.2f} steps/s, <N> "
        f"{avgs.mean('N'):.3f}, acceptance displace/insert/delete "
        f"{avgs.mean('acc_displace'):.4f}/{avgs.mean('acc_insert'):.4f}/"
        f"{avgs.mean('acc_delete'):.4f}")
    # bookkeeping: carry one more chunk and recompute from scratch
    g = torch.Generator(device=device).manual_seed(11)
    st, stats = metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo,
                                     1000, generator=g)
    log(f"scan chunk accepts {stats.host().accepts.tolist()}")
    _check_bookkeeping("scan path, 1000 steps", st, su)
    return launches, rate, dataclasses.replace(su, state=st)


def phase_fused(device, numsteps=20000):
    """The fused µVT path at full size: the bench deck with fused_mc on."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.state import stack_chains
    su, avgs, text, launches = _run_deck(device, "fused_mc on\n",
                                         numsteps=numsteps)
    if "fused_mc: single-chain fused" not in text:
        raise AssertionError("the fused deck did not take the fused path")
    if not (launches["run_steps_uvt"] > 0 and launches["pair_terms"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k fused single chain: {rate:.2f} steps/s (run_mc), <N>"
        f" {avgs.mean('N'):.3f}, acceptance displace/insert/delete "
        f"{avgs.mean('acc_displace'):.4f}/{avgs.mean('acc_insert'):.4f}/"
        f"{avgs.mean('acc_delete'):.4f}")
    tables = metropolis.uvt_fused_tables(su.params, su.cfg)
    g = torch.Generator(device=device).manual_seed(13)
    st, stats = metropolis.run_chunk_fused_uvt(
        su.state, su.params, su.cfg, su.thermo, 1000, generator=g,
        tables=tables)
    log(f"fused chunk accepts {stats.host().accepts.tolist()}")
    _check_bookkeeping("fused single chain, 1000 steps", st, su)
    # the kernel alone: CUDA events around one 1000-step launch
    u = torch.rand((1, 1000, 16), generator=g, device=device)
    args, kw = metropolis.fused_uvt_launch_args(
        stack_chains([st]), su.params, su.cfg, su.thermo, u, tables)
    ms = time_calls(lambda: mk.run_steps_uvt(*args, **kw), device, n=5)
    log(f"B1 kernel alone, single chain: {ms / 1000 * 1e3:.2f} us/step "
        f"({ms:.2f} ms per 1000-step launch)")
    _block_breakdown(device, su, "fused single chain")
    return launches, rate, dataclasses.replace(su, state=st), ms / 1000


def phase_fused_nvt(device, chains=16, nvt_steps=10000, nve_steps=5000):
    """The fused NVT/NVE path (B3) at full width through run_mc and
    run_mc_chains: the MOF + H2 deck under nvt, one chain and ``chains``
    chains (``nvt_steps`` each), the 10k LJ fluid under nvt (``nvt_steps``)
    and under nve (``nve_steps``).  Each deck must launch B3 once per
    corrtime and keep its carried energy equal to a fresh recompute after
    a further 1000 fused steps (chain 0 and the last chain when stacked);
    under nve the kinetic reservoir must stay positive; each deck's block
    breakdown (refresh, observables, restart write) is logged.  Returns
    ({deck: launches}, {deck: steps/s}, {deck: Setup})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.state import slice_chain
    decks = (("mof_nvt", "mof", "ensemble nvt\nfused_mc on\n", nvt_steps),
             (f"mof_nvt_c{chains}", "mof",
              f"ensemble nvt\nfused_mc on\nchains {chains}\n", nvt_steps),
             ("lj_nvt", "lj", "fused_mc on\n", nvt_steps),
             ("lj_nve", "lj", "ensemble nve\nfused_mc on\n", nve_steps))
    launches, rates, sus = {}, {}, {}
    for i, (label, kind, extra, numsteps) in enumerate(decks):
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind=kind)
        want = ("chain-interleaved multi-chain" if "chains" in extra
                else "single-chain fused NVT")
        if f"fused_mc: {want}" not in text or "WARNING" in text:
            raise AssertionError(f"{label} did not take the fused NVT path")
        if ln["run_steps"] != numsteps // 1000:
            raise AssertionError(f"{label}: B3 launched {ln['run_steps']} "
                                 f"times, not numsteps / corrtime = "
                                 f"{numsteps // 1000}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        log(f"{label}: {rate:.2f} steps/s"
            + (" aggregate" if "chains" in extra else "")
            + f", <U> {avgs.mean('energy_total'):.4f} K, acceptance "
            f"{avgs.mean('acc_displace'):.4f}")
        g = torch.Generator(device=device).manual_seed(19 + i)
        if su.states is not None:
            sts, _ = metropolis.run_chunk_fused_multi(
                su.states, su.params, su.cfg, su.thermo, 1000, generator=g)
            for c in (0, chains - 1):
                _check_bookkeeping(f"{label} chain {c}, 1000 steps",
                                   slice_chain(sts, c), su)
        else:
            st, stats = metropolis.run_chunk_fused(
                su.state, su.params, su.cfg, su.thermo, 1000, generator=g)
            log(f"{label} chunk accepts {stats.host().accepts.tolist()}")
            _check_bookkeeping(f"{label}, 1000 steps", st, su)
            if su.cfg.ensemble == "nve":
                k = float(su.thermo.nve_energy
                          - st.reported_energy().total)
                log(f"{label}: kinetic reservoir after the run and a "
                    f"further chunk {k:.4f} K")
                if not k > 0:
                    raise AssertionError(f"{label}: the reservoir left > 0")
        _block_breakdown(device, su, label, states=su.states)
        launches[label], rates[label], sus[label] = ln, rate, su
    return launches, rates, sus


# steps of a chunk run in torch's sync debug mode (each synchronizing call
# warns, with a backtrace, at a cost far above the step's own), and of a
# profiled chunk of the polar decks (~700 device ops a step: the trace's
# post-processing, not the steps, sets the phase's time)
SYNC_STEPS = 10
PROFILE_STEPS = 10


def _count_syncs(fn):
    """(fn's result, host syncs it made): torch's sync debug mode warns
    once per synchronizing call."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _polar_step_layers(device, su, n=20, seed=23):
    """The polar step's layers on ``n`` trial displacements of alive H2
    from ``su``'s state: host-clock ms of thole.move_deltas (the O(A N)
    field and residual update) and of the warm-started solve_scf (it
    syncs once per CG iteration), its iterations and the ms per
    iteration."""
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.state import mol_rows, mol_rows_update
    st, params, cfg = su.state, su.params, su.cfg
    alive = st.atom_alive(params)
    mols = np.flatnonzero((st.mol_alive & ~params.mol_frozen
                           & (params.mol_species >= 0)).cpu().numpy())
    rng = np.random.default_rng(seed)
    md_ms, solve_ms, iters = [], [], []
    for mol in rng.choice(mols, size=min(n, len(mols)), replace=False):
        mol = int(mol)
        rows = mol_rows(st.pos, params, mol) + torch.as_tensor(
            rng.uniform(-0.5, 0.5, 3), dtype=st.pos.dtype, device=device)

        def deltas():
            return thole.move_deltas(
                st.pos, st.box, alive, params, cfg, mol, st.e0, st.mu,
                st.r_pol, new_rows=rows,
                with_residual=thole.residual_supported(cfg),
                sk=(st.sk_re, st.sk_im))

        # host clock: the function is a few hundred small launches
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        e0_new, r0 = deltas()
        torch.cuda.synchronize(device)
        md_ms.append((time.perf_counter() - t0) * 1e3)
        pos_c = mol_rows_update(st.pos.clone(), params, mol, rows)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, it, _ = thole.solve_scf(pos_c, st.box, alive, params, cfg, e0_new,
                                   mu0=st.mu, r0=r0)
        torch.cuda.synchronize(device)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(it)
    out = {"move_deltas_ms": statistics.median(md_ms),
           "solve_ms": statistics.median(solve_ms),
           "solve_iters_mean": float(np.mean(iters)),
           "ms_per_cg_iter": float(np.sum(solve_ms)
                                   / max(int(np.sum(iters)), 1))}
    log(f"polar step layers ({len(iters)} trial displacements): " +
        json.dumps(out))
    return out


def phase_polar(device, numsteps=POLAR_STEPS):
    """The polar scan path at full width (the 10.8k system with 9,261
    polarizable framework sites) through run.run, in three decks: (a)
    ``polarization on`` — B4 per move, move_deltas, and solve_scf with B5
    in every CG iteration; (b) with ``polar_delayed on`` — the scan-path
    delayed acceptance, the SCF only for stage-1 survivors; (c) with
    ``cutoff 14`` — the tile-culled CG through B5's visit table.  Each
    deck must take the scan path (no WARNING) and launch B2, B4 and both
    B5 modes; after a further 100-step chunk the carried energy and its
    polar term must match a fresh recompute.  On a SYNC_STEPS-step chunk
    of each: B5 dipole launches against the CG iterations (equal: the move's
    initial residual comes from move_deltas; the CG launches B5 through
    the chain wrapper at C = 1, thole.solve_scf being one chain of
    solve_scf_chains), host syncs per step, and a
    profile with B5's share of the device time; for (a) the step's layers.
    Returns ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    decks = (("polar", ""), ("polar_da", "polar_delayed on\n"),
             (f"polar_rc{RC_CULL:g}", f"cutoff {RC_CULL:g}\n"))
    launches, reps = {}, {}
    for i, (label, extra) in enumerate(decks):
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind="polar")
        if "WARNING" in text:
            raise AssertionError(f"{label}: a WARNING in the run's log")
        if not all(ln[k] > 0 for k in ("pair_terms", "mol_pair",
                                        "charge_field", "dipole_field",
                                        "dipole_field_chains")):
            raise AssertionError(f"{label}: a kernel was not launched: {ln}")
        if thole.cull_supported(su.cfg) != ("cutoff" in extra):
            raise AssertionError(f"{label}: the culled CG gate is wrong")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate,
               "cg_iters_per_step": avgs.mean("polar_iters_per_step"),
               "b5_launches_per_step": (ln["dipole_field"]
                                        + ln["dipole_field_chains"])
               / numsteps,
               "polar_K": avgs.mean("energy_polar"),
               "polar_rrms_debye": avgs.mean("polar_rrms_debye"),
               "N": avgs.mean("N")}
        g = torch.Generator(device=device).manual_seed(29 + i)
        st, stats = metropolis.run_chunk(su.state, su.params, su.cfg,
                                         su.thermo, 100, generator=g)
        _check_bookkeeping(f"{label}, 100 steps", st, su, polar=True)
        su = dataclasses.replace(su, state=st)
        u = metropolis.draw_uniforms(g, SYNC_STEPS, su.cfg.tdtype)
        tk.reset_counts()
        (_, stats), syncs = _count_syncs(lambda: metropolis.run_chunk(
            su.state, su.params, su.cfg, su.thermo, SYNC_STEPS, uniforms=u))
        stats = stats.host()
        if tk.dipole_field_chains.launches != stats.polar_iters:
            raise AssertionError(
                f"{label}: {tk.dipole_field_chains.launches} B5 dipole "
                f"launches for {stats.polar_iters} CG iterations")
        rep.update(chunk_cg_iters_per_step=stats.polar_iters / SYNC_STEPS,
                   host_syncs_per_step=syncs / SYNC_STEPS)
        prof = _profile(label, lambda: metropolis.run_chunk(
            su.state, su.params, su.cfg, su.thermo, PROFILE_STEPS,
            generator=g), PROFILE_STEPS, device, kernel="thole_field")
        rep.update(device_busy_share=prof["device_busy_share"],
                   b5_share=prof.get("kernel_share"),
                   ms_per_step=prof["ms_per_step"])
        if label == "polar":
            rep["layers"] = _polar_step_layers(device, su)
            rep["block"] = _block_breakdown(device, su, label)
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def phase_pda_decks(device, numsteps=POLAR_STEPS, chunk=100):
    """The fused polar delayed acceptance at full width through run.run:
    DECK + ``polarization on`` + ``polar_delayed on`` + ``fused_mc on`` on
    the 10.8k polar system, (a) the direct field (the reference's
    fused_stage1_delayed_acceptance row), (b) ``polar_wolf on``
    (bench_polar_wolf_gcmc), (c) ``cutoff 14`` (the culled CG in stage 2,
    bench_polar_rc14_gcmc).  Each deck must log the PDA route and no
    WARNING and launch B6, B2 and B5's dipole mode, and B5's charge mode
    where the static field is the direct one (not under polar_wolf,
    whose field is plain torch, as in the reference); after a further
    ``chunk``-step chunk the carried energy and its polar term must match a
    fresh recompute.  On a second chunk: B6 launches, host syncs and CG
    iterations per step, B5 dipole launches equal to the CG iterations;
    and a profile of a third with B6's share of the device time.  Returns
    ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    decks = (("pda", ""), ("pda_wolf", "polar_wolf on\n"),
             (f"pda_rc{RC_CULL:g}", f"cutoff {RC_CULL:g}\n"))
    launches, reps = {}, {}
    for i, (label, extra) in enumerate(decks):
        su, avgs, text, ln = _run_deck(
            device, "polar_delayed on\nfused_mc on\n" + extra,
            numsteps=numsteps, kind="polar")
        if ("fused_mc: polar delayed-acceptance stage-1 kernel (exact SCF "
                "stage 2 per survivor)") not in text or "WARNING" in text:
            raise AssertionError(f"{label} did not take the fused PDA path")
        # the wolf-shifted static field is plain torch (as in the
        # reference): B5's charge mode runs for the direct field only
        need = ("run_steps_uvt_pda", "pair_terms", "dipole_field") + (
            () if "polar_wolf" in extra else ("charge_field",))
        if not all(ln[k] > 0 for k in need):
            raise AssertionError(f"{label}: a kernel was not launched: {ln}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate,
               "cg_iters_per_step": avgs.mean("polar_iters_per_step"),
               "b6_launches_per_step": ln["run_steps_uvt_pda"] / numsteps,
               "polar_K": avgs.mean("energy_polar"), "N": avgs.mean("N"),
               "acc_displace": avgs.mean("acc_displace"),
               "acc_insert": avgs.mean("acc_insert"),
               "acc_delete": avgs.mean("acc_delete")}
        tables = metropolis.uvt_fused_tables(
            su.params, mk.pda_effective_cfg(su.cfg, su.params))
        g = torch.Generator(device=device).manual_seed(47 + i)

        def run_chunk(st, n=chunk):
            return metropolis.run_chunk_fused_uvt_polar_da(
                st, su.params, su.cfg, su.thermo, n, generator=g,
                tables=tables)

        st, _ = run_chunk(su.state)
        _check_bookkeeping(f"{label}, {chunk} steps", st, su, polar=True)
        su = dataclasses.replace(su, state=st)
        mk.reset_counts()
        tk.reset_counts()
        (_, stats), syncs = _count_syncs(lambda: run_chunk(su.state,
                                                           2 * SYNC_STEPS))
        stats = stats.host()
        steps = int(stats.attempts.sum())
        if tk.dipole_field_chains.launches != stats.polar_iters:
            raise AssertionError(
                f"{label}: {tk.dipole_field_chains.launches} B5 dipole "
                f"launches for {stats.polar_iters} CG iterations")
        rep.update(chunk_steps=steps,
                   chunk_cg_iters_per_step=stats.polar_iters / steps,
                   chunk_b6_launches_per_step=(mk.run_steps_uvt_pda.launches
                                               / steps),
                   chunk_accepts_per_step=int(stats.accepts.sum()) / steps,
                   host_syncs_per_step=syncs / steps)
        prof = _profile(label, lambda: run_chunk(su.state,
                                                 2 * PROFILE_STEPS),
                        2 * PROFILE_STEPS, device, kernel="pda_kernel")
        rep.update(device_busy_share=prof["device_busy_share"],
                   b6_share=prof.get("kernel_share"),
                   ms_per_step=prof["ms_per_step"])
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def _block_breakdown(device, su, label, states=None):
    """Host-clock seconds of the per-corrtime work of a run_mc block
    besides the chunk: the refresh, the observables and the restart
    write (the part of a block that the kernel's time does not cover)."""
    from mpmc_tpu_torch.io import pqr
    from mpmc_tpu_torch.mc import metropolis, run
    from mpmc_tpu_torch.parallel import multichain
    F = metropolis.frozen_refresh_rows(su.params, su.cfg)

    if states is None:
        refresh = _clock_host(lambda: metropolis.initialize(
            su.state, su.params, su.cfg, su.thermo, frozen_rows=F), device)
        obs = _clock_host(lambda: run.observables(su, su.state), device)
    else:
        refresh = _clock_host(lambda: multichain.initialize_batched(
            states, su.params, su.cfg, su.thermo, frozen_rows=F), device)
        obs = _clock_host(lambda: run.observables_batched(
            su, states, states.pos.shape[0]), device)
    with tempfile.TemporaryDirectory() as tmp:
        restart = _clock_host(lambda: pqr.write_state(
            os.path.join(tmp, "r.pqr"), su.params, su.state,
            su.species_names, wrap=True), device)
    log(f"block breakdown {label}: refresh {refresh * 1e3:.2f} ms, "
        f"observables {obs * 1e3:.2f} ms, restart write "
        f"{restart * 1e3:.2f} ms (host clock)")
    return {"refresh_ms": refresh * 1e3, "observables_ms": obs * 1e3,
            "restart_ms": restart * 1e3}


def phase_fused_chains(device, chains=32, numsteps=10000):
    """The fused µVT path at the reference's headline width: the bench
    deck with fused_mc on and chains 32; bookkeeping of chain 0 and of
    the last chain after a further chunk."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.state import slice_chain
    su, avgs, text, launches = _run_deck(
        device, f"fused_mc on\nchains {chains}\n", numsteps=numsteps)
    if not launches["run_steps_uvt"] > 0:
        raise AssertionError(f"B1 was not launched: {launches}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k fused c{chains}: {rate:.2f} steps/s aggregate, <N> "
        f"{avgs.mean('N'):.3f}")
    g = torch.Generator(device=device).manual_seed(17)
    sts, _ = metropolis.run_chunk_fused_uvt_multi(
        su.states, su.params, su.cfg, su.thermo, 1000, generator=g)
    for c in (0, chains - 1):
        _check_bookkeeping(f"fused c{chains} chain {c}, 1000 steps",
                           slice_chain(sts, c), su)
    _block_breakdown(device, su, f"fused c{chains}", states=su.states)
    return launches, rate, su


def _profile(label, chunk, n_steps, device, kernel=None):
    """One untraced run of ``chunk`` for the rate, then a torch.profiler
    run for device busy time by kernel; ``kernel``: a substring of a
    kernel's name whose share of the device time is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    timed()
    wall = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_traced = timed()
    # device-side events only (kernels, memcpy, memset): CPU ops also
    # carry the device time of the kernels they launched
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, _, t in dev)
    launches = sum(c for _, c, _ in dev)
    out = {"path": label, "steps": n_steps,
           "ms_per_step": 1e3 * wall / n_steps,
           "ms_per_step_traced": 1e3 * wall_traced / n_steps,
           "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share": busy_us / 1e6 / wall,
           "device_busy_share_traced": busy_us / 1e6 / wall_traced,
           "device_ops_per_step": launches / n_steps,
           "device_ops_per_chunk": launches,
           "top": [{"kernel": k[:90], "count": c, "ms": t / 1e3}
                   for k, c, t in sorted(dev, key=lambda x: -x[2])[:10]]}
    if kernel is not None:
        out["kernel_share"] = (sum(t for k, _, t in dev if kernel in k)
                               / max(busy_us, 1e-30))
    log("profile " + json.dumps(out))
    if busy_us <= 0:
        log("profile: the profiler recorded no device time")
    return out


def phase_profile(device, su, n_steps=20):
    """Where a scan-path GCMC step's time goes, and the check that a step
    makes no host sync (over ``n_steps`` steps each)."""
    from mpmc_tpu_torch.mc import metropolis
    g = torch.Generator(device=device).manual_seed(5)
    out = _profile("scan", lambda: metropolis.run_chunk(
        su.state, su.params, su.cfg, su.thermo, n_steps, generator=g),
        n_steps, device)
    # a step makes no host sync: torch raises on any synchronizing call
    step, carry, c, branch, stats = metropolis.chunk_setup(
        su.state, su.params, su.cfg, su.thermo,
        metropolis.draw_uniforms(g, n_steps, su.cfg.tdtype))
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(n_steps):
            step(carry, carry["u"][k], int(branch[k]), su.thermo, c, stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"no host sync in {n_steps} steps (branches {np.bincount(branch)})")
    return out


def phase_profile_fused(device, su, n_steps=1000, states=None):
    """Where a fused chunk's time goes: one launch of the fused kernel (B3
    for an nvt/nve Setup, else B1) plus the per-corrtime refresh, as
    run_mc runs them for one chain, or as run_mc_chains runs them for the
    stacked ``states``; with the kernel's share of the device time."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    g = torch.Generator(device=device).manual_seed(6)
    F = metropolis.frozen_refresh_rows(su.params, su.cfg)
    nvt = su.cfg.ensemble in ("nvt", "nve")
    if nvt:
        tables = metropolis.nvt_fused_tables(su.params, su.state.mol_alive)
        single, multi = (metropolis.run_chunk_fused,
                         metropolis.run_chunk_fused_multi)
    else:
        tables = metropolis.uvt_fused_tables(su.params, su.cfg)
        single, multi = (metropolis.run_chunk_fused_uvt,
                         metropolis.run_chunk_fused_uvt_multi)

    def chunk():
        if states is None:
            st, _ = single(su.state, su.params, su.cfg, su.thermo, n_steps,
                           generator=g, tables=tables)
            metropolis.initialize(st, su.params, su.cfg, su.thermo,
                                  frozen_rows=F)
        else:
            sts, _ = multi(states, su.params, su.cfg, su.thermo, n_steps,
                           generator=g, tables=tables)
            multichain.initialize_batched(sts, su.params, su.cfg,
                                          su.thermo, frozen_rows=F)

    label = ("fused_nvt" if nvt else "fused") + (
        "" if states is None else f"_c{states.pos.shape[0]}")
    return _profile(label, chunk, n_steps, device,
                    kernel="nvt_kernel" if nvt else "uvt_kernel")


def phase_example(device, numsteps=1000):
    """examples/h2_sorption.inp with numsteps overridden, in a temp dir."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run
    job = input_script.parse_file(os.path.join(REPO, "examples",
                                               "h2_sorption.inp"))
    job = dataclasses.replace(
        job, cfg=dataclasses.replace(job.cfg, numsteps=numsteps),
        pqr_input=os.path.join(REPO, job.pqr_input))
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            buf = io.StringIO()
            _, avgs = run.run(job, log=buf, device=device)
            made = sorted(os.listdir("."))
        finally:
            os.chdir(old)
    text = buf.getvalue()
    log("\n".join(text.splitlines()[-4:]))
    for f in ("restart.pqr", "traj.pqr", "h2_density.dx"):
        if f not in made:
            raise AssertionError(f"h2_sorption.inp did not write {f}")
    if "=== averages ===" not in text or not np.isfinite(avgs.mean("N")):
        raise AssertionError("h2_sorption.inp averages missing")
    log(f"h2_sorption.inp: {numsteps} steps, <N> {avgs.mean('N'):.3f}")


# ---------------------------------------------------------------------------
# Batched scan chains (B4 over a chain axis), parallel tempering, the native
# restart writer
# ---------------------------------------------------------------------------

# the batched scan deck's width (the reference's headline batch,
# bench.py:71-84) and the PT decks' ladder (bench.py:733-807)
C_BATCHED = 128
PT_R, PT_T_MAX = 8, 250.0


def _chain_inputs(device, C, seed=29):
    """B4's inputs over C chains of the 10.8k bench system, {dtype: (args
    without rows, rows, pick counts, params)}: chain c jittered off the
    lattice by its own seed, about a tenth of its H2 slots dead, one alive
    H2 picked by rank from its own uniform (every 16th chain's mask
    emptied: count 0, index 0) and displaced to trial rows — all in
    float64; the float32 inputs are those cast (the same picks)."""
    from mpmc_tpu_torch.mc import metropolis, moves
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.state import stack_chains
    out = {}
    params, state, cfg, _ = bench_system("float64", device)
    rng = np.random.default_rng(seed)
    chains = []
    mov = ((params.mol_species >= 0) & ~params.mol_frozen).cpu().numpy()
    for c in range(C):
        st = systems.jittered(params, state, seed + c)
        kill = mov & (rng.random(len(mov)) < 0.1)
        alive = st.mol_alive & ~torch.as_tensor(kill, device=device)
        chains.append(st.replace(mol_alive=alive))
    states = stack_chains(chains)
    mask = metropolis._movable_mask(params, states.mol_alive)
    mask[::16] = False
    u = torch.as_tensor(rng.random((C, 16)), dtype=torch.float64,
                        device=device)
    mol, cnt = moves.pick_by_rank(mask, u[:, 0])
    rows = moves.displace_rows(states.pos, params, mol, u, 1.0, np.pi)
    alive = states.mol_alive[:, params.mol_id] & params.atom_ok
    out["float64"] = ((states.pos, params.charge, params.eps, params.sig,
                       params.mol_id32, alive, params.mol_atoms,
                       params.mol_natoms, mol, None,
                       pairs.pair_scalars(state.box, cfg), cfg), rows, cnt,
                      params)
    p32, s32, c32, _ = bench_system("float32", device)
    out["float32"] = ((states.pos.float(), p32.charge, p32.eps, p32.sig,
                       p32.mol_id32, alive, p32.mol_atoms, p32.mol_natoms,
                       mol, None, pairs.pair_scalars(s32.box, c32), c32),
                      rows.float(), cnt, p32)
    return out


def phase_mol_pair_chains(device, C=C_BATCHED):
    """B4 over a chain axis on the 10.8k system: C = 1 against the
    single-chain launch bit for bit; C = 2 and C against the plain version
    with B4's tolerance (_tol: float64 plain as the reference, float32 by
    the float32 rule), current and trial rows, chains with an empty pick
    included; times at C per call, on the card alone and plain, and the
    bound from this run's inputs."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    rep = {"max_abs_err": 0.0}
    inputs = _chain_inputs(device, C)
    for dt in ("float64", "float32"):
        args, rows, cnt, params = inputs[dt]
        if dt == "float64":
            log(f"B4 chains: {C} chains, {int((cnt == 0).sum())} with an "
                "empty pick")
        # C = 1: the single-chain launch's bits
        for r in (None, rows):
            one = list(args)
            one[0], one[5], one[8] = args[0][:1], args[5][:1], args[8][:1]
            one[9] = None if r is None else r[:1]
            k1 = pk.mol_pair_chains(*one)
            s1 = pk.mol_pair(args[0][0], *args[1:5], args[5][0], *args[6:8],
                             args[8][0], None if r is None else r[0],
                             *args[10:])
            if not torch.equal(k1[0], s1):
                raise AssertionError(f"B4 {dt}: C = 1 is not the "
                                     "single-chain launch bit for bit")
        for width in (2, C):
            for label, r in (("current", None), ("trial", rows)):
                a = list(args)
                a[0], a[5], a[8] = (args[0][:width], args[5][:width],
                                    args[8][:width])
                a[9] = None if r is None else r[:width]
                k = pk.mol_pair_chains(*a).double().cpu().numpy()
                p = pk.mol_pair_chains_plain(*a).double().cpu().numpy()
                key = (width, label)
                if dt == "float64":
                    inputs[key] = p
                    tol = _tol(torch.float64, p)
                else:
                    tol = _tol(torch.float32, inputs[key], p)
                    p = inputs[key]
                err = np.abs(k - p)
                if not np.all(err <= tol):
                    bad = np.argwhere(err > tol)[:4].tolist()
                    raise AssertionError(f"B4 {dt} C={width} {label} "
                                         f"disagrees with its plain version "
                                         f"at {bad}")
                rep["max_abs_err"] = max(rep["max_abs_err"],
                                         float(err.max()))
                log(f"B4 chains {dt} C={width} {label}: max |d| "
                    f"{err.max():.3e}, least tol/|d| "
                    f"{np.min(tol / np.maximum(err, 1e-300)):.3g}")
        if dt == "float32":
            a = list(args)
            a[9] = rows
            ms = time_calls(lambda: pk.mol_pair_chains(*a), device)
            dms = time_device(lambda: pk.mol_pair_chains(*a), device, n=100)
            pms = time_calls(lambda: pk.mol_pair_chains_plain(*a), device,
                             n=3)
            # pairs this run's inputs need: each chain's molecule's rows
            # (its sites, at most the A rows of mol_atoms: an empty pick's
            # index 0 names the framework's molecule) against its alive
            # columns outside the molecule
            alive = args[5]
            mol = args[8]
            own = params.mol_id[None, :] == mol[:, None]
            cols = (alive & ~own).sum(1)
            sites = torch.clamp(params.mol_natoms[mol],
                                max=params.mol_atoms.shape[1])
            n_pairs = int((sites * cols).sum())
            nbytes = _nbytes(*a[:9], rows) + 20 * 4 + C * 4 * 4
            bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4, nbytes)
            plan = pk.mol_pair_plan(alive.shape[1], C, False, torch.float32,
                                    args[11])
            rep.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bound,
                       bound_by=by, pairs=n_pairs, bytes=nbytes, plan=plan)
            log(f"B4 chains f32 C={C}: kernel {ms:.4f} ms per call, "
                f"{dms:.4f} ms on the card alone; plain {pms:.3f} ms; bound "
                f"{bound:.5f} ms ({by}; {n_pairs} pairs x {OPS_PAIR_B2B4}, "
                f"{nbytes} bytes); launch shape {plan}")
    rep["header"] = _mol_pair_header(device, inputs, C_HEADER)
    return rep


# the NPT chains' width (phase_npt's n3 deck and B4's header per chain)
C_HEADER = 16


def _mol_pair_header(device, inputs, C):
    """B4 over C chains with a [C, 20] header, a box per chain (the NPT
    chains): the first C chains of ``inputs`` (_chain_inputs), each with
    its positions and box scaled by its own exp(d ln V / 3), d ln V from
    -0.06 to 0.06 (float64, then cast), current and trial rows, against
    the plain version with each chain's own header row (B4's tolerance,
    _tol); a shared [20] header gives the bits of the same row repeated
    per chain; times at C per call, on the card alone and plain, and the
    bound from this run's inputs."""
    from mpmc_tpu_torch.mc import moves
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    rep = {"max_abs_err": 0.0}
    args64, rows64, _, params64 = inputs["float64"]
    box = args64[10][2:11].reshape(3, 3)
    d_lnv = torch.linspace(-0.06, 0.06, C, dtype=torch.float64,
                           device=device)
    pos64, box64 = moves.scale_volume(args64[0][:C].contiguous(),
                                      box.expand(C, 3, 3), params64, d_lnv)
    ref = {}
    for dt in ("float64", "float32"):
        args, rows, _, params = inputs[dt]
        cast = pos64.to(args[0].dtype)
        scal = pairs.pair_scalars(box64.to(args[0].dtype), args[11])
        shared = args[10]
        for label, r in (("current", None), ("trial", rows[:C])):
            a = [cast] + list(args[1:5]) + [args[5][:C].contiguous()] + list(
                args[6:8]) + [args[8][:C].contiguous(), r]
            k = pk.mol_pair_chains(*a, scal, args[11])
            p = pk.mol_pair_chains_plain(*a, scal, args[11])
            k0 = pk.mol_pair_chains(*a, shared, args[11])
            k_rep = pk.mol_pair_chains(
                *a, shared.expand(C, 20).contiguous(), args[11])
            if not torch.equal(k0, k_rep):
                raise AssertionError(f"B4 header {dt} {label}: a shared "
                                     "header is not its row repeated per "
                                     "chain, bit for bit")
            k = k.double().cpu().numpy()
            p = p.double().cpu().numpy()
            if dt == "float64":
                ref[label] = p
                tol = _tol(torch.float64, p)
            else:
                tol = _tol(torch.float32, ref[label], p)
                p = ref[label]
            err = np.abs(k - p)
            if not np.all(err <= tol):
                bad = np.argwhere(err > tol)[:4].tolist()
                raise AssertionError(f"B4 header {dt} C={C} {label} "
                                     f"disagrees with its plain version at "
                                     f"{bad}")
            rep["max_abs_err"] = max(rep["max_abs_err"], float(err.max()))
            log(f"B4 header per chain {dt} C={C} {label}: max |d| "
                f"{err.max():.3e}, least tol/|d| "
                f"{np.min(tol / np.maximum(err, 1e-300)):.3g}; shared "
                "header == its row repeated, bit for bit")
        if dt == "float32":
            a = [cast] + list(args[1:5]) + [args[5][:C].contiguous()] + list(
                args[6:8]) + [args[8][:C].contiguous(), rows[:C], scal,
                              args[11]]
            ms = time_calls(lambda: pk.mol_pair_chains(*a), device)
            dms = time_device(lambda: pk.mol_pair_chains(*a), device, n=100)
            pms = time_calls(lambda: pk.mol_pair_chains_plain(*a), device,
                             n=3)
            alive, mol = a[5], a[8]
            own = params.mol_id[None, :] == mol[:, None]
            cols = (alive & ~own).sum(1)
            sites = torch.clamp(params.mol_natoms[mol],
                                max=params.mol_atoms.shape[1])
            n_pairs = int((sites * cols).sum())
            nbytes = _nbytes(*a[:10], scal) + C * 4 * 4
            bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4, nbytes)
            plan = pk.mol_pair_plan(alive.shape[1], C, False, torch.float32,
                                    args[11])
            rep.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bound,
                       bound_by=by, pairs=n_pairs, bytes=nbytes, plan=plan)
            log(f"B4 header per chain f32 C={C}: kernel {ms:.4f} ms per "
                f"call, {dms:.4f} ms on the card alone; plain {pms:.3f} ms; "
                f"bound {bound:.5f} ms ({by}; {n_pairs} pairs x "
                f"{OPS_PAIR_B2B4}, {nbytes} bytes); launch shape {plan}")
    return rep


def _pt_recompute(rnd):
    """(new ladder, accepted, margin) of a PT round recomputed on the host
    in float64 from the round's record (run_mc_pt / run_mc_pt_fug):
    temperatures and energies (and the µVT counts), or fugacity rows and
    counts; ``margin`` the least |ln u - ln P| / (1 + |ln P|) over the
    pairs (a float32 decision may differ from float64's below ~1e-6)."""
    h = {k: (v.double().cpu().numpy() if torch.is_tensor(v) else v)
         for k, v in rnd.items()}
    par, u = h["parity"], np.asarray(h["u"], np.float64)
    margins = [np.inf]
    fug = "fugacity" in h
    x = h["fugacity"] if fug else h["temps"]
    new, acc = x.copy(), 0
    for lo in range(par, x.shape[0] - 1, 2):
        if fug and h["counts"].ndim == 1:
            n = h["counts"]
            ln_p = (n[lo] - n[lo + 1]) * np.log(x[lo + 1].sum()
                                                / x[lo].sum())
        elif fug:
            lnf = np.log(x[:, list(h["sp_ids"])])
            ln_p = np.sum((h["counts"][lo] - h["counts"][lo + 1])
                          * (lnf[lo + 1] - lnf[lo]))
        else:
            t, e = x, h["energies"]
            ln_p = (1 / t[lo] - 1 / t[lo + 1]) * (e[lo] - e[lo + 1])
            if h["n_mols"] is not None:
                n = h["n_mols"]
                ln_p += (n[lo] - n[lo + 1]) * np.log(t[lo] / t[lo + 1])
        margins.append(abs(np.log(u[lo]) - ln_p) / (1 + abs(ln_p)))
        if np.log(u[lo]) < ln_p:
            new[[lo, lo + 1]] = x[[lo + 1, lo]]
            acc += 1
    return new, acc, min(margins)


def phase_batched(device, C=C_BATCHED, numsteps=200, chunk=100):
    """The batched scan chains at the reference's headline width: DECK
    with ``chains C`` and no fused_mc (corrtime 100), through run.run;
    the aggregate rate, B4-over-chains and B2 launches; a further chunk of
    every chain held against a fresh recompute by _check_bookkeeping's
    rule; a profiled chunk for the device's busy share."""
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    su, avgs, text, ln = _run_deck(
        device, f"chains {C}\ncorrtime 100\n", numsteps=numsteps)
    if f"batched scan chains (C={C})" not in text or "fused_mc" in text:
        raise AssertionError("the chains deck did not take the batched "
                             "scan route")
    if not (ln["mol_pair_chains"] > 0 and ln["pair_terms"] > 0):
        raise AssertionError(f"a kernel was not launched: {ln}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"GCMC 10.8k batched scan c{C}: {rate:.2f} steps/s aggregate, <N> "
        f"{avgs.mean('N'):.3f}; B4 over chains {ln['mol_pair_chains']} "
        f"launches ({ln['mol_pair_chains'] / numsteps:.3f} per step), B2 "
        f"{ln['pair_terms']}, single-chain B4 {ln['mol_pair']}")
    g = torch.Generator(device=device).manual_seed(23)
    sts, stats = multichain.run_chunk_batched(su.states, su.params, su.cfg,
                                              su.thermo, chunk, generator=g)
    log(f"batched chunk accepts (all chains) "
        f"{stats.host().accepts.sum(0).tolist()}")
    for c in range(C):
        _check_bookkeeping(f"batched c{C} chain {c}, {chunk} steps",
                           slice_chain(sts, c), su)
    prof = _profile(f"batched_c{C}", lambda: multichain.run_chunk_batched(
        su.states, su.params, su.cfg, su.thermo, 50, generator=g), 50,
        device, kernel="mol_pair")
    # a batched step makes no host sync: torch raises on any
    # synchronizing call
    from mpmc_tpu_torch.mc import metropolis
    u = torch.rand((C, 50, 16), generator=g, device=device)
    step, carry, c, branch, stats = metropolis.batched_chunk_setup(
        su.states, su.params, su.cfg, su.thermo, u)
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(50):
            step(carry, carry["u"][:, k], int(branch[k]), su.thermo, c,
                 stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"no host sync in 50 batched steps (branches "
        f"{np.bincount(branch, minlength=3).tolist()})")
    return ln, {"steps_per_sec": rate,
                "device_busy_share": prof["device_busy_share"],
                "b4_share": prof["kernel_share"],
                "ms_per_step": prof["ms_per_step"]}


PT_DECKS = (
    # label, deck kind, deck lines, numsteps, the kernel its route launches
    ("pt_nvt_b3", "mof", "ensemble nvt\nfused_mc on\nparallel_tempering on"
     f"\nn_replicas {PT_R}\nmax_temperature {PT_T_MAX}\nptemp_freq 500\n",
     4000, "run_steps"),
    ("pt_uvt_b1", "mof", "fused_mc on\nparallel_tempering on\n"
     f"n_replicas {PT_R}\nmax_temperature {PT_T_MAX}\nptemp_freq 500\n",
     4000, "run_steps_uvt"),
    ("pt_uvt_batched", "mof", "parallel_tempering on\ncorrtime 200\n"
     f"n_replicas {PT_R}\nmax_temperature {PT_T_MAX}\nptemp_freq 100\n",
     400, "mol_pair_chains"),
    ("pt_fugacity_b1", "mof", "fused_mc on\npt_fugacity on\n"
     f"n_replicas {PT_R}\nptemp_freq 500\n", 4000, "run_steps_uvt"),
    ("pt_polar_batched", "polar", "parallel_tempering on\n"
     f"n_replicas {PT_R}\nmax_temperature {PT_T_MAX}\nptemp_freq 100\n",
     200, "dipole_field_chains"),
)


def phase_pt(device):
    """The five PT decks (8 replicas; 77-250 K, or 1-10 atm at 77 K):
    (i) fused NVT over B3, (ii) fused µVT over B1, (iii) batched scan
    chains with host swaps, (iv) pt_fugacity fused over B1, (v) the polar
    deck (corrtime 100) as batched polar chains with host swaps, B5 over
    the chains.  Each: its route's kernel launched, the aggregate rate
    and swap acceptance, the ladder a permutation of its rungs at the
    end, and the last swap round's decisions recomputed on the host from
    its energies, counts and uniforms."""
    from mpmc_tpu_torch.parallel import replica
    reps, launches = {}, {}
    for label, kind, extra, numsteps, kernel in PT_DECKS:
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind=kind)
        fused = kernel not in ("mol_pair_chains", "dipole_field_chains")
        if ("on-device swaps" in text) != fused or "WARNING" in text:
            raise AssertionError(f"{label} did not take its route")
        if not ln[kernel] > 0:
            raise AssertionError(f"{label}: {kernel} was not launched: {ln}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        acc, att = (int(x) for x in
                    text.split("swap acceptance:")[1].split()[0].split("/"))
        if "pt_fugacity" in extra:
            rows = su.thermo.fugacity.double().cpu().numpy().sum(1)
            want = rows.min() * np.geomspace(1.0, 10.0, PT_R)
            got = np.sort(rows)
        else:
            want = replica.geometric_ladder(77.0, PT_T_MAX, PT_R)
            got = np.sort(su.thermo.temperature.double().cpu().numpy())
        if not np.allclose(got, want, rtol=1e-5):
            raise AssertionError(f"{label}: the ladder is not a permutation "
                                 f"of its rungs: {got} vs {want}")
        rnd = su.pt_round
        new, n_acc, margin = _pt_recompute(rnd)
        dev_new = (rnd["new_fugacity"] if "fugacity" in rnd
                   else rnd["new_temps"]).double().cpu().numpy()
        same = (np.array_equal(new, dev_new)
                and n_acc == int(rnd["accepted"]))
        log(f"{label}: {rate:.2f} steps/s aggregate ({PT_R} replicas), swap "
            f"acceptance {acc}/{att}, <N> {avgs.mean('N'):.3f}; last round "
            f"(parity {rnd['parity']}): {n_acc} swaps, host recompute "
            f"{'equal' if same else 'DIFFERS'} (margin {margin:.3g}); "
            f"launches {ln}")
        if not same and margin > 1e-5:
            raise AssertionError(f"{label}: the host recomputation of the "
                                 "last swap round differs")
        reps[label] = {"steps_per_sec": rate, "swap_acceptance":
                       acc / max(att, 1)}
        launches[label] = ln
    return launches, reps


# NPT on the 10k LJ fluid (phase_npt): the virial pressure of LJ_DECK's
# frame 0 (1,962.87 atm, phase_replay), so the volume drifts little; a volume
# attempt every 100 steps, d ln V within +-0.004 (+-0.002 accepted 62-69 %
# of the attempts)
NPT_LINES = ("ensemble npt\npressure 1963\nvolume_probability 0.01\n"
             "volume_change_factor 0.004\n")
NPT_ROUTES = (
    # label, deck lines, numsteps, chains, the route's log line
    ("n1_scan", "", 3000, 1, None),
    ("n2_hybrid", "fused_mc on\n", 20000, 1,
     "fused_mc: hybrid fused NPT (B3 segments + scan-path volume moves)"),
    ("n3_chains", f"chains {C_HEADER}\ncorrtime 100\n", 200, C_HEADER,
     f"batched scan chains (C={C_HEADER})"),
)


class _VolumeCount:
    """Counts NPT volume attempts (one per chain) and acceptances while a
    deck runs, around metropolis._volume_step; the acceptances are summed
    on the card and read once, at the end."""

    def __enter__(self):
        from mpmc_tpu_torch.mc import metropolis
        self.mod, self.orig = metropolis, metropolis._volume_step
        self.attempts, self.acc = 0, []

        def counted(carry, u, thermo, c, params, cfg, stats, trace=None):
            before = stats.accepts[..., metropolis.VOLUME].sum()
            self.orig(carry, u, thermo, c, params, cfg, stats, trace)
            self.attempts += 1 if u.ndim == 1 else u.shape[0]
            self.acc.append(stats.accepts[..., metropolis.VOLUME].sum()
                            - before)
        metropolis._volume_step = counted
        return self

    def __exit__(self, *exc):
        self.mod._volume_step = self.orig

    def accepted(self):
        return int(torch.stack(self.acc).sum()) if self.acc else 0


def phase_npt(device):
    """NPT on every route at full width: the 10k LJ fluid (LJ_DECK with
    NPT_LINES) on the scan path (n1, 3000 steps), under fused_mc on the
    hybrid path (n2, 20,000 steps: B3 segments between scan-path volume
    attempts) and as 16 batched chains (n3, 200 steps, corrtime 100).
    Each: its route, steps/s, volume attempts and acceptances, <V> and
    the final volume's drift from the start, B2 launches == volume
    attempts x chains + refreshes, B3 launches == segments (n2), B4 (n1)
    or B4 over chains with a header per chain (n3) launched; then a
    further chunk with volume moves and every chain's carried energy
    against a fresh recompute (rel 1e-4); n2 also the cost of a volume
    attempt (a hybrid chunk against a pure B3 one) and a profile; n3 one
    chain beside the chain run alone over the same uniform rows."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    v0 = N_LJ / 0.0212
    launches, reps, sus = {}, {}, {}
    for label, extra, numsteps, C, route in NPT_ROUTES:
        with _VolumeCount() as vc:
            su, avgs, text, ln = _run_deck(device, NPT_LINES + extra,
                                           numsteps=numsteps, kind="lj",
                                           verbose=False)
            att, acc = vc.attempts, vc.accepted()
        if (route is not None and route not in text) or (
                route is None and ("fused_mc" in text or "batched" in text)):
            raise AssertionError(f"npt {label} did not take its route")
        if C == 1 and "WARNING" in text:
            raise AssertionError(f"npt {label}: {text}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        corr = 100 if C > 1 else 1000
        blocks = max(numsteps // corr, 1)
        refreshes = 1 + C * blocks
        vols = torch.abs(torch.linalg.det(
            (su.states if C > 1 else su.state).box.double()))
        drift = float(vols.mean()) / v0 - 1.0
        log(f"npt {label}: {rate:.2f} steps/s" + (" aggregate" if C > 1
                                                  else "")
            + f", volume attempts {att} accepted {acc} "
            f"({acc / max(att, 1):.3f}), <V> {avgs.mean('volume'):.2f} A^3 "
            f"(start {v0:.2f}), final volume drift {drift:+.3e}, "
            f"displace acceptance {avgs.mean('acc_displace'):.4f}; "
            f"launches {ln}")
        if not 0 < acc < att:
            raise AssertionError(f"npt {label}: {acc} of {att} volume "
                                 "attempts accepted")
        if ln["pair_terms"] != att + refreshes:
            raise AssertionError(
                f"npt {label}: B2 launched {ln['pair_terms']} times, not "
                f"volume attempts x chains {att} + refreshes {refreshes}")
        kern = {"n1_scan": "mol_pair", "n2_hybrid": "run_steps",
                "n3_chains": "mol_pair_chains"}[label]
        if label == "n2_hybrid":
            n_v = round(0.01 * corr)
            if ln["run_steps"] != blocks * n_v or att != blocks * n_v:
                raise AssertionError(
                    f"npt n2: B3 launched {ln['run_steps']} times and "
                    f"{att} volume attempts, not {blocks * n_v} segments")
        elif not ln[kern] > 0:
            raise AssertionError(f"npt {label}: {kern} was not launched")
        g = torch.Generator(device=device).manual_seed(61)
        more = su.thermo.replace(volume_probability=torch.full_like(
            su.thermo.volume_probability, 0.05))
        if label == "n1_scan":
            st, stats = metropolis.run_chunk(su.state, su.params, su.cfg,
                                             more, 1000, generator=g)
            chains = [st]
        elif label == "n2_hybrid":
            st, stats = metropolis.run_chunk_fused_npt(
                su.state, su.params, su.cfg, more, 2000, generator=g)
            chains = [st]
        else:
            u = torch.rand((C, 100, 16), generator=g, device=device)
            sts, stats = multichain.run_chunk_batched(
                su.states, su.params, su.cfg, more, 100, uniforms=u)
            chains = [slice_chain(sts, c) for c in range(C)]
            c = C // 2
            uc = u[c].clone()
            uc[:, 8] = u[0, :, 8]
            one, st1 = metropolis.run_chunk(slice_chain(su.states, c),
                                            su.params, su.cfg, more, 100,
                                            uniforms=uc)
            mine = stats.host().accepts[c].tolist()
            alone = st1.host().accepts.tolist()
            e_b, e_1 = float(chains[c].energy.total), float(one.energy.total)
            dpos = float((chains[c].pos - one.pos).abs().max())
            log(f"npt n3 chain {c} of {C} (100 steps at volume_probability "
                f"0.05): accepts {mine}, energy {e_b:.6f} K, volume "
                f"{float(torch.linalg.det(chains[c].box.double())):.4f}; "
                f"run alone over the same rows: accepts {alone}, energy "
                f"{e_1:.6f} K, volume "
                f"{float(torch.linalg.det(one.box.double())):.4f}; max "
                f"|d pos| {dpos:.3e} A")
            if mine != alone or abs(e_b - e_1) > 1e-5 * abs(e_1):
                raise AssertionError("npt n3: a chain differs from the "
                                     "chain run alone")
        acc_all = stats.host().accepts
        log(f"npt {label} further chunk accepts "
            f"{(acc_all.sum(0) if C > 1 else acc_all).tolist()}")
        for c, st in enumerate(chains):
            _check_bookkeeping(f"npt {label} chain {c}", st, su)
        if label == "n2_hybrid":
            # what a volume attempt costs: 1000 hybrid steps (10 attempts)
            # against 1000 pure B3 steps
            nvt = dataclasses.replace(su.cfg, ensemble="nvt")
            tables = metropolis.nvt_fused_tables(su.params, su.state.mol_alive)
            hyb = statistics.median(_clock_host(
                lambda: metropolis.run_chunk_fused_npt(
                    su.state, su.params, su.cfg, su.thermo, 1000,
                    generator=g, tables=tables), device) for _ in range(5))
            pure = statistics.median(_clock_host(
                lambda: metropolis.run_chunk_fused(
                    su.state, su.params, nvt, su.thermo, 1000, generator=g,
                    tables=tables), device) for _ in range(5))
            per_v = (hyb - pure * 0.99) / 10
            log(f"npt n2: 1000 hybrid steps {hyb * 1e3:.2f} ms, 1000 pure "
                f"B3 steps {pure * 1e3:.2f} ms: a volume attempt ~"
                f"{per_v * 1e3:.3f} ms (host clock, median of 5)")
            prof = _profile(
                "npt_hybrid", lambda: metropolis.run_chunk_fused_npt(
                    su.state, su.params, su.cfg, su.thermo, 1000,
                    generator=g, tables=tables), 1000, device,
                kernel="pair_terms")
            reps[label] = {"volume_attempt_ms": per_v * 1e3,
                           "b2_share": prof["kernel_share"],
                           "device_busy_share": prof["device_busy_share"]}
        reps.setdefault(label, {}).update(
            steps_per_sec=rate, volume_attempts=att, volume_accepted=acc,
            mean_volume=avgs.mean("volume"), volume_drift=drift)
        launches[label], sus[label] = ln, su
    return launches, reps


def phase_pt_drivers(device, R=8, spr=1024, rounds=6):
    """The library PT drivers on the reference's bench decks
    (bench.py:733-797): 8 replicas on a 77-250 K ladder, 1,024 steps a
    round, 6 rounds, on the 10.8k GCMC system — NVT through
    run_parallel_tempering_fused (B3, R launches a round) and _multi (B3,
    one launch a round), µVT through _multi (B1).  Each after a one-round
    warm-up: the aggregate steps/s with the swaps, the accepted swaps,
    the final temperatures a permutation of the ladder, the kernel's
    launches per round, and B2 launches == 1 + R per refresh (every
    corrtime, not after the last round)."""
    from mpmc_tpu_torch.parallel import replica
    params, state, cfg, thermo = bench_system("float32", device)
    nvt = dataclasses.replace(cfg, ensemble="nvt", fused_mc=True)
    uvt = dataclasses.replace(cfg, fused_mc=True)
    temps = replica.geometric_ladder(77.0, 250.0, R)
    reps, launches = {}, {}
    for label, run, c, kernel, per_round in (
            ("pt_fused_nvt", replica.run_parallel_tempering_fused, nvt,
             "run_steps", R),
            ("pt_fused_multi_nvt", replica.run_parallel_tempering_fused_multi,
             nvt, "run_steps", 1),
            ("pt_fused_multi_uvt", replica.run_parallel_tempering_fused_multi,
             uvt, "run_steps_uvt", 1)):
        run(params, state, c, thermo, temps, 1, spr, seed=4)
        torch.cuda.synchronize(device)
        _reset_counts()
        t0 = time.perf_counter()
        states, final, n_acc = run(params, state, c, thermo, temps, rounds,
                                   spr, seed=5)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        ln = _launch_counts()
        rate = rounds * spr * R / wall
        attempted = sum((R - (r % 2)) // 2 for r in range(rounds))
        log(f"{label}: {rate:.2f} steps/s aggregate with the swaps ({R} "
            f"replicas x {rounds} rounds x {spr} steps in {wall:.3f} s), "
            f"swaps accepted {n_acc}/{attempted}, final T "
            + " ".join(f"{t:.2f}" for t in final)
            + f"; {kernel} {ln[kernel] / rounds:.2f} launches a round, B2 "
            f"{ln['pair_terms']}; launches {ln}")
        if not np.allclose(np.sort(final), temps, rtol=1e-5):
            raise AssertionError(f"{label}: the final temperatures are not "
                                 "a permutation of the ladder")
        if ln[kernel] != per_round * rounds:
            raise AssertionError(f"{label}: {kernel} launched {ln[kernel]} "
                                 f"times, not {per_round} a round")
        since = n_ref = 0
        for r in range(rounds):      # the drivers' per-corrtime refresh
            since += spr
            if since >= max(c.corrtime, 1) and r + 1 < rounds:
                n_ref, since = n_ref + 1, 0
        if ln["pair_terms"] != 1 + R * n_ref:
            raise AssertionError(f"{label}: B2 launched {ln['pair_terms']} "
                                 f"times, not 1 + R x {n_ref} refreshes")
        reps[label] = {"steps_per_sec": rate, "swaps": n_acc,
                       "attempted": attempted,
                       "launches_per_round": ln[kernel] / rounds}
        launches[label] = ln
    return launches, reps


# the batched polar chains' width (a PT ladder's, and the c8 decks')
C_POLAR = 8


def polar_chains(dtype, device, C=C_POLAR, steps=2000, seed=41):
    """(params, C stacked states, cfg, thermo) of the polar bench system:
    C copies of polar_system("float32") moved apart by ``steps`` fused
    µVT steps each (B1, on the system without polarization: a few hundred
    accepted moves a chain), then in ``dtype`` each chain initialized
    under the polar cfg — its energies, static field and converged
    dipoles."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain, stack_chains
    params, state, cfg, thermo = polar_system("float32", device)
    cfg_np = dataclasses.replace(cfg, polarization=False)
    g = torch.Generator(device=device).manual_seed(seed)
    sts, stats = metropolis.run_chunk_fused_uvt_multi(
        multichain.stack_states(state, C), params, cfg_np, thermo, steps,
        generator=g)
    acc = stats.host().accepts.sum(1)
    if dtype == "float64":
        params, _, cfg, thermo = polar_system("float64", device)
        sts = sts.replace(pos=sts.pos.double(), box=sts.box.double())
    chains = [metropolis.initialize(
        slice_chain(sts, c).replace(mu=None, e0=None, r_pol=None,
                                    e_frozen=None),
        params, cfg, thermo) for c in range(C)]
    log(f"polar chains {dtype}: {C} chains, accepted moves "
        f"{acc.tolist()}, N "
        f"{[int(ch.n_molecules(params)) for ch in chains]}")
    return params, stack_chains(chains), cfg, thermo


def phase_thole_chains(device, C=C_POLAR):
    """B5 over a chain axis on C chains of the polar bench system
    (polar_chains), float64 and float32, both modes, dense at the derived
    rc and culled at rc = RC_CULL (each chain sorted by its own cull_perm,
    its own visit table).  Checks: against the plain version over [C]
    with phase 4c's tolerance per chain (float64 1e-10 x max |E|; float32
    the float64 plain on the same inputs as the reference, at most 4x
    the float32 plain's distance or 2e-6 x max |E|); each chain bit for
    bit its own single-chain launch; C = 1 the single-chain launch; an
    active subset (chains 1, 4, 7) those chains' launches and zeros
    elsewhere.  Float32 times: per call (the plan built once, as
    solve_scf_chains builds it), on the card alone and plain, beside the
    bound summed over the chains (OPS_B5_* per evaluated and inside-rc
    pair, each chain's pairs counted).  Returns the dipole mode's dense
    report (with a "culled" and a "charge" entry)."""
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    rep = {"max_abs_err": 0.0, "tol_share": 0.0}
    active = tuple(range(1, C, 3))
    for dtype in ("float64", "float32"):
        params, states, cfg, _ = polar_chains(dtype, device, C)
        box, lam, kind = states.box[0], cfg.polar_damp, cfg.polar_damp_type
        alive = states.mol_alive[:, params.mol_id] & params.atom_ok
        pol_ok = alive & (params.polar > 0)
        mu = torch.where(pol_ok[..., None], states.mu, 0.0)
        rc = pairs.derived_cutoff(box, cfg)
        rc14 = torch.as_tensor(RC_CULL, dtype=box.dtype, device=device)
        mol = params.mol_id32.expand(C, -1).contiguous()
        q = params.charge.expand(C, -1).contiguous()
        for mode in ("dipole", "charge"):
            kern, one_fn, plain = (
                (tk.dipole_field_chains, tk.dipole_field,
                 tk.dipole_field_chains_plain) if mode == "dipole" else
                (tk.charge_field_chains, tk.charge_field,
                 tk.charge_field_chains_plain))
            ok, src = (pol_ok, mu) if mode == "dipole" else (alive, q)
            perm, _ = thole.cull_perm(states.pos, box, ok, rc14)
            sorted_ = [thole._gather_sites(x, perm).contiguous()
                       for x in (states.pos, ok, src, mol)]
            visit = thole.cull_visit(sorted_[0], sorted_[1], box, rc14)
            cases = {"dense": ((states.pos, box, ok, src, mol, rc, lam,
                                kind), None),
                     f"rc{RC_CULL:g} culled": ((sorted_[0], box,
                                                *sorted_[1:], rc14, lam,
                                                kind), visit)}
            for label, (args, vis) in cases.items():
                fplan = tk.plan_chains(box, args[5], lam, args[0].shape[1],
                                       C, vis)
                k = kern(*args, ortho=True, visit=vis, plan=fplan)
                sub = kern(*args, ortho=True, visit=vis, plan=fplan,
                           active=active)
                torch.cuda.synchronize(device)
                for c in range(C):
                    one = one_fn(args[0][c], box, args[2][c], args[3][c],
                                 args[4][c], args[5], lam, kind, ortho=True,
                                 visit=None if vis is None else vis[c])
                    if not torch.equal(k[c], one):
                        raise AssertionError(
                            f"B5 x C {mode} {dtype} {label}: chain {c} is "
                            "not its single-chain launch bit for bit")
                    if not (torch.equal(sub[c], one) if c in active
                            else not sub[c].any()):
                        raise AssertionError(
                            f"B5 x C {mode} {dtype} {label}: the active "
                            f"subset's chain {c} is wrong")
                one_c = kern(*(x[:1] if torch.is_tensor(x) and x.ndim >= 2
                               and x is not box else x for x in args),
                             ortho=True,
                             visit=None if vis is None else vis[:1])
                if not torch.equal(one_c[0], k[0]):
                    raise AssertionError(f"B5 x C {mode} {dtype} {label}: "
                                         "C = 1 is not the single-chain "
                                         "launch")
                a64 = tuple(x.double() if torch.is_tensor(x)
                            and x.is_floating_point() else x for x in args)
                p64 = plain(*a64, visit=vis).cpu()
                p32 = (plain(*args, visit=vis).double().cpu()
                       if dtype == "float32" else None)
                err = share = 0.0
                for c in range(C):
                    scale = float(p64[c].abs().max())
                    e = float((k[c].double().cpu() - p64[c]).abs().max())
                    tol = (1e-10 * scale if dtype == "float64" else
                           max(4.0 * float((p32[c] - p64[c]).abs().max()),
                               2e-6 * scale))
                    if not e <= tol:
                        raise AssertionError(
                            f"B5 x C {mode} {dtype} {label}: chain {c} "
                            "disagrees with its plain version")
                    err, share = max(err, e), max(share, e / tol)
                log(f"B5 x C={C} {mode} {dtype} {label}: each chain its "
                    "single-chain launch bit for bit, C = 1 and the active "
                    f"subset {active} too; |kernel - plain| {err:.3e} "
                    f"({share:.3f} of the tolerance)")
                if mode == "dipole":
                    rep["max_abs_err"] = max(rep["max_abs_err"], err)
                    rep["tol_share"] = max(rep["tol_share"], share)
                if dtype == "float64":
                    continue

                def call(p=fplan, a=args, v=vis):
                    return kern(*a, ortho=True, visit=v, plan=p)

                ms = time_calls(call, device)
                dms = time_device(call, device, n=20)
                pms = time_calls(lambda: plain(*args, visit=vis), device,
                                 n=3)
                n_eval = n_in = 0
                for c in range(C):
                    e_c, i_c = _b5_pairs(mode, args[0][c], box, args[2][c],
                                         args[4][c], args[5],
                                         None if vis is None else vis[c])
                    n_eval, n_in = n_eval + e_c, n_in + i_c
                ops = n_eval * OPS_B5_PAIR + n_in * OPS_B5_IN[mode]
                nbytes = _nbytes(*args[:5], fplan.scal, vis, k)
                bound, by = _bound_ms(ops, nbytes)
                log(f"    f32 C={C}: kernel {ms:.4f} ms per call, {dms:.4f} "
                    f"ms on the card alone; plain {pms:.3f} ms; bound "
                    f"{bound:.5f} ms ({by}; {n_eval} pairs evaluated, "
                    f"{n_in} inside rc, {nbytes} bytes)")
                entry = {"ms": ms, "device_ms": dms, "plain_ms": pms,
                         "bound_ms": bound, "bound_by": by,
                         "pairs": n_eval, "pairs_in": n_in}
                if mode == "charge":
                    rep.setdefault("charge", {})[label] = entry
                elif label == "dense":
                    rep.update(entry)
                else:
                    rep["culled"] = entry
    return rep


def phase_polar_chains(device, C=C_POLAR, numsteps=100, chunk=50):
    """The batched polar chains at full width through run.run: the polar
    deck (phase_polar's DECK + ``polarization on``, corrtime 100) with
    ``chains C``, 100 steps, (a') plain, (b') ``polar_delayed on``, (c')
    ``cutoff 14`` (each chain's culled CG).  Each deck must take the
    batched route with no WARNING and launch B2, B4 over chains and B5
    over chains in both modes (charge: every chain's static field at each
    refresh, multichain.initialize_batched); after a further ``chunk``
    steps every chain's carried energy and polar term must match a fresh
    recompute (_check_bookkeeping(polar=True)); on a SYNC_STEPS-step
    chunk B5-over-chains launches must equal the CG rounds (a step's rounds: its longest
    chain's iterations); host syncs per step and a profile with B5's
    share.  Returns ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    decks = (("polar_c8", ""), ("polar_da_c8", "polar_delayed on\n"),
             (f"polar_rc{RC_CULL:g}_c8", f"cutoff {RC_CULL:g}\n"))
    launches, reps = {}, {}
    for i, (label, extra) in enumerate(decks):
        su, avgs, text, ln = _run_deck(device, f"chains {C}\n" + extra,
                                       numsteps=numsteps, kind="polar")
        if f"batched scan chains (C={C})" not in text or "WARNING" in text:
            raise AssertionError(f"{label} did not take the batched route "
                                 "without a WARNING")
        if not all(ln[k] > 0 for k in ("pair_terms", "mol_pair_chains",
                                        "charge_field_chains",
                                        "dipole_field_chains")):
            raise AssertionError(f"{label}: a kernel was not launched: {ln}")
        if thole.cull_supported(su.cfg) != ("cutoff" in extra):
            raise AssertionError(f"{label}: the culled CG gate is wrong")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate,
               "cg_iters_per_chain_step": avgs.mean("polar_iters_per_step"),
               "b5c_launches_per_step": ln["dipole_field_chains"] / numsteps,
               "polar_K": avgs.mean("energy_polar"), "N": avgs.mean("N")}
        g = torch.Generator(device=device).manual_seed(37 + i)
        sts, _ = multichain.run_chunk_batched(su.states, su.params, su.cfg,
                                              su.thermo, chunk, generator=g)
        for c in range(C):
            _check_bookkeeping(f"{label} chain {c}, {chunk} steps",
                               slice_chain(sts, c), su, polar=True)
        su = dataclasses.replace(su, states=sts)
        u = torch.rand((C, SYNC_STEPS, 16), generator=g, device=device,
                       dtype=su.cfg.tdtype)
        trace = []
        tk.reset_counts()
        (_, stats), syncs = _count_syncs(lambda: multichain.run_chunk_batched(
            su.states, su.params, su.cfg, su.thermo, SYNC_STEPS, uniforms=u,
            trace=trace))
        rounds = sum(int(np.max(r["iters"])) for r in trace)
        del trace
        if tk.dipole_field_chains.launches != rounds:
            raise AssertionError(
                f"{label}: {tk.dipole_field_chains.launches} B5-over-chains "
                f"launches for {rounds} CG rounds")
        iters = stats.host().polar_iters
        rep.update(chunk_cg_rounds_per_step=rounds / SYNC_STEPS,
                   chunk_cg_iters_per_chain_step=(float(iters.mean())
                                                  / SYNC_STEPS),
                   host_syncs_per_step=syncs / SYNC_STEPS)
        prof = _profile(label, lambda: multichain.run_chunk_batched(
            su.states, su.params, su.cfg, su.thermo, PROFILE_STEPS,
            generator=g), PROFILE_STEPS, device, kernel="thole_field")
        rep.update(device_busy_share=prof["device_busy_share"],
                   b5_share=prof.get("kernel_share"),
                   ms_per_step=prof["ms_per_step"])
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def phase_restart_write(device, n=20):
    """The restart write on the 10.8k system in one call: the Python
    writer (pqr.write of snapshot_atoms, the plain version) and the
    native one (pqr.write_state), median ms of ``n`` each, wrapped
    coordinates (wrapall) as _block_breakdown writes them; their bytes
    must be equal."""
    from mpmc_tpu_torch.io import pqr
    params, state, _, _ = bench_system("float32", device)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "native.pqr"), os.path.join(tmp, "py.pqr")

        def native():
            pqr.write_state(a, params, state, ["H2"], remark="restart",
                            wrap=True)

        def python():
            pqr.write(b, pqr.snapshot_atoms(
                params, state, ["H2"], pos=pqr.wrapped_positions(params,
                                                                 state)),
                remark="restart", box=pqr._host(state.box))
        native()            # the first call builds the library (g++)
        python()
        times = {}
        for name, fn in (("python", python), ("native", native),
                         ("native2", native), ("python2", python)):
            ts = []
            for _ in range(n // 2):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            times.setdefault(name.rstrip("2"), []).extend(ts)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same = fa.read() == fb.read()
        lines = sum(1 for _ in open(a))
    rep = {k: statistics.median(v) for k, v in times.items()}
    log(f"restart write, 10.8k system ({lines} lines): python "
        f"{rep['python']:.2f} ms, native {rep['native']:.2f} ms per call "
        f"(median of {n}, host clock, in turns p n n p); bytes "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the native restart file differs from the "
                             "Python writer's")
    return rep


# ---------------------------------------------------------------------------
# Exact checkpoints, trajectory replay with the virial pressure, isotherm
# campaigns
# ---------------------------------------------------------------------------

def _state_gap(a, b):
    """How far two single-chain states lie apart: max |d pos| [A] over
    every row, alive slots that differ, max |d E| [K] over the energy
    terms (active and frozen), steps that differ."""
    d_e = [abs(float(x) - float(y))
           for e, f in ((a.energy, b.energy), (a.e_frozen, b.e_frozen))
           for x, y in zip(e.as_dict().values(), f.as_dict().values())]
    return {"pos": float(torch.max(torch.abs(a.pos - b.pos))),
            "mol_alive": int(torch.sum(a.mol_alive != b.mol_alive)),
            "energy": max(d_e), "step": abs(int(a.step) - int(b.step))}


def _held_as_two_runs(label, gap_runs, gap_resumed):
    """The resumed run must match the uninterrupted one as closely as two
    uninterrupted runs match each other: bit for bit when they do, else no
    gap larger than theirs."""
    log(f"{label}: two uninterrupted runs differ by {gap_runs}; the "
        f"resumed run differs by {gap_resumed}")
    if not any(gap_runs.values()):
        if any(gap_resumed.values()):
            raise AssertionError(f"{label}: the uninterrupted runs agree bit "
                                 "for bit and the resumed run does not")
        return
    if any(gap_resumed[k] > gap_runs[k] for k in gap_runs):
        raise AssertionError(f"{label}: the resumed run lies further from "
                             "the uninterrupted one than two uninterrupted "
                             "runs lie apart")


def phase_checkpoint(device, smi):
    """Exact resume at full width: DECK on the scan path (B2 + B4, corrtime
    500) and with ``fused_mc on`` (B1, corrtime 1000), each run for two
    corrtime blocks twice, then for one block with ``checkpoint_output``
    and one more with ``checkpoint_input``; the resumed run's positions,
    alive mask, energy terms and step against the uninterrupted run's
    (_held_as_two_runs), and the checkpoint's save and load ms and bytes."""
    from mpmc_tpu_torch.io import checkpoint
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, lines, corr in (("scan", "", 500),
                                   ("fused", "fused_mc on\n", 1000)):
            lines += f"corrtime {corr}\n"
            ck = os.path.join(tmp, f"{label}.ck")
            su_a, _, _, ln = _run_deck(device, lines, numsteps=2 * corr,
                                       verbose=False)
            su_b, _, _, _ = _run_deck(device, lines, numsteps=2 * corr,
                                      verbose=False)
            _run_deck(device, lines + f"checkpoint_output {ck}\n",
                      numsteps=corr, verbose=False)
            su_r, avgs_r, text, ln_r = _run_deck(
                device, lines + f"checkpoint_input {ck}\n", numsteps=corr,
                verbose=False)
            if f"resumed exactly from {ck} at step {corr}" not in text:
                raise AssertionError(f"{label}: the run did not resume")
            kern = "run_steps_uvt" if "fused" in lines else "mol_pair"
            if not (ln[kern] > 0 and ln["pair_terms"] > 0
                    and ln_r[kern] > 0):
                raise AssertionError(f"{label}: a kernel was not launched: "
                                     f"{ln}, resumed {ln_r}")
            _held_as_two_runs(f"checkpoint {label}",
                              _state_gap(su_a.state, su_b.state),
                              _state_gap(su_a.state, su_r.state))
            g = torch.Generator(device=device).manual_seed(3)
            path = os.path.join(tmp, f"{label}.timed")

            def save():
                checkpoint.save(path, su_r.state, avgs_r, generator=g)

            def load():
                checkpoint.load(path, su_r.state, generator=g)
            save_ms = 1e3 * statistics.median(
                _clock_host(save, device) for _ in range(5))
            load_ms = 1e3 * statistics.median(
                _clock_host(load, device) for _ in range(5))
            rep[label] = {"save_ms": save_ms, "load_ms": load_ms,
                          "bytes": os.path.getsize(path)}
            log(f"checkpoint {label}: save {save_ms:.2f} ms, load "
                f"{load_ms:.2f} ms, {rep[label]['bytes']} bytes (10.8k "
                f"system, median of 5, host clock; {smi})")
    return rep


def _replay_frame_plain(job, frame, dtype, pressure):
    """The plain version of one replayed frame on the CPU: a Setup of the
    parsed frame in ``dtype``, its energy terms, and with ``pressure`` the
    two energies of the virial pressure, with N and V — run.setup +
    metropolis.initialize + the volume perturbations of
    run._frame_pressure."""
    from mpmc_tpu_torch.mc import metropolis, moves, run
    from mpmc_tpu_torch.ops import energy
    jb = dataclasses.replace(job, cfg=dataclasses.replace(job.cfg,
                                                          dtype=dtype))
    su = run.setup(jb, device="cpu", frame=frame)
    st = metropolis.initialize(su.state, su.params, su.cfg, su.thermo)
    obs = run.observables(su, st)
    terms = {k: obs[f"energy_{k}"] for k in st.energy.as_dict()}
    e_pm = []
    if pressure:
        for sgn in (1.0, -1.0):
            p2, b2 = moves.scale_volume(st.pos, st.box, su.params,
                                        sgn * job.calc_pressure_dv)
            e2, _ = energy.total_energy(p2, b2, st.mol_alive, su.params,
                                        su.cfg, su.thermo)
            e_pm.append(float(e2.total))
    return terms, e_pm, obs["N"], obs["volume"]


def phase_replay(device, smi, refs):
    """``ensemble replay`` at full width over two trajectories written by
    port runs: the 10k LJ fluid (fused NVT, 10 frames) with
    ``calc_pressure on`` and the 10.8k GCMC fused µVT deck (10 frames, N
    changing: frames laid out into the existing slots).  B2 launches must
    be 1 per frame (3 with the pressure); the card float32 terms of the
    LJ trajectory's first frame and of the GCMC one's last are held
    against the plain float64 terms of the same parsed frame on the CPU by
    phase_energy's rule, and the first LJ frame's pressure against the
    float64 pressure within the bound of its two energies' float32
    rounding — those CPU frames in a process of their own beside the later
    phases (``refs``, _ReplayReferences; compared by its ``check``, at the
    end).  Frames/s, and the reader's ms per frame."""
    from mpmc_tpu_torch.constants import ATM2K_A3
    from mpmc_tpu_torch.io import input_script, native, pqr
    from mpmc_tpu_torch.mc import run
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kind, deck, lines, steps in (
                ("lj", "lj", LJ_DECK,
                 "fused_mc on\ncorrtime 200\ncalc_pressure on\n", 2000),
                ("gcmc", "mof", DECK, "fused_mc on\n", 10000)):
            traj = os.path.join(tmp, f"{label}.traj.pqr")
            t_phase = time.perf_counter()
            su, _, _, _ = _run_deck(device, lines + f"traj_output {traj}\n",
                                    numsteps=steps, kind=kind, verbose=False)
            t_traj = time.perf_counter() - t_phase
            text = (deck.format(numsteps=1, L=float(su.state.box[0, 0]))
                    + lines + f"ensemble replay\npqr_input {traj}\n")
            job = input_script.parse(text)
            t0 = time.perf_counter()
            n_frames = sum(1 for _ in native.stream_frames_arrays(traj))
            read_ms = 1e3 * (time.perf_counter() - t0) / n_frames
            buf = io.StringIO()
            _reset_counts()
            t0 = time.perf_counter()
            avgs = run.run(job, log=buf, device=device)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            ln = _launch_counts()
            summary = [x for x in buf.getvalue().splitlines()
                       if x.startswith("replay:")][0]
            per = 3 if job.calc_pressure else 1
            log(f"replay {label}: {summary}; {n_frames / wall:.2f} frames/s"
                f", reader {read_ms:.2f} ms per frame, B2 launches "
                f"{ln['pair_terms']} ({smi})")
            if avgs.count() != n_frames or ln["pair_terms"] != per * n_frames:
                raise AssertionError(f"replay {label}: {avgs.count()} frames"
                                     f" of {n_frames}, B2 launches {ln}")
            if label == "gcmc" and " 0 laid out" in summary:
                raise AssertionError("replay gcmc: no frame was laid out "
                                     "into the existing slots")
            # the plain float64 / float32 frame on the CPU, in a process
            # of its own beside the later card phases (_ReplayReferences):
            # the LJ trajectory's first frame (with its pressure), the
            # GCMC one's last (laid out into the existing slots)
            i = 0 if job.calc_pressure else n_frames - 1
            keep = os.path.join(refs.dir, f"{label}.traj.pqr")
            shutil.move(traj, keep)
            refs.add(label, text.replace(f"pqr_input {traj}",
                                         f"pqr_input {keep}"), i, {
                "terms": {k[7:]: v[i] for k, v in avgs.samples.items()
                          if k.startswith("energy_")},
                "pressure": (avgs.samples["pressure_atm"][i]
                             if job.calc_pressure else None)})
            log(f"replay {label}: seconds: trajectory run {t_traj:.1f}, "
                f"replay {wall:.1f}")
            rep[label] = {"frames": n_frames,
                          "frames_per_sec": n_frames / wall,
                          "reader_ms_per_frame": read_ms,
                          "pair_terms": ln["pair_terms"],
                          "summary": summary}
    return rep


class _ReplayReferences:
    """phase_replay's CPU frames (_replay_frame_plain in float64 and
    float32 of each replayed deck's checked frame), computed in a process
    of their own (``python3 chip_smoke.py --replay-references <dir>``,
    CPU_REFERENCE_THREADS threads) while the card's later phases run;
    ``check`` waits for it and holds each card frame against them."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="replay_refs_")
        self.items, self.proc = {}, None
        self.analyze = {}          # phase_analyze's card runs of its checks

    def add(self, label, deck, frame, card):
        with open(os.path.join(self.dir, f"{label}.inp"), "w") as f:
            f.write(deck)
        self.items[label] = {"frame": frame, "card": card}

    def start(self):
        with open(os.path.join(self.dir, "frames.json"), "w") as f:
            json.dump({k: v["frame"] for k, v in self.items.items()}, f)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(CPU_REFERENCE_THREADS))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--replay-references", self.dir], env=env, cwd=REPO)

    def check(self, smi):
        from mpmc_tpu_torch.constants import ATM2K_A3
        from mpmc_tpu_torch.io import input_script
        t0 = time.perf_counter()
        rc = self.proc.wait()
        out = os.path.join(self.dir, "refs.json")
        if rc != 0 or not os.path.exists(out):
            raise AssertionError(f"the replay references' process failed "
                                 f"({rc})")
        with open(out) as f:
            refs = json.load(f)
        for label, item in self.items.items():
            r = refs[label]
            i, card = item["frame"], item["card"]
            job = input_script.parse_file(os.path.join(self.dir,
                                                       f"{label}.inp"))
            for k, ref in r["f64"].items():
                got = card["terms"][k]
                tol = max(1e-5 * abs(ref), 1e-2, 4.0 * abs(r["f32"][k] - ref))
                if not abs(got - ref) <= tol:
                    raise AssertionError(
                        f"replay {label} frame {i}: {k} card {got!r} cpu-f64 "
                        f"{ref!r} tol {tol:.3e}")
            if card["pressure"] is not None:
                dlnv, (n, vol) = job.calc_pressure_dv, r["n_vol"]
                e64, e32 = r["e64"], r["e32"]
                p_ref = ((n * job.temperature - (e64[0] - e64[1])
                          / (2.0 * dlnv)) / vol / ATM2K_A3)
                # each card energy within 4x the plain f32 distance or 2
                # ulps (float32) of its value: the difference over 2 dlnV V
                # bounds the pressure's error
                t_e = sum(max(4.0 * abs(a - b), 2.0 * EPS32 * abs(b))
                          for a, b in zip(e32, e64))
                bound = t_e / (2.0 * dlnv) / vol / ATM2K_A3
                got = card["pressure"]
                log(f"    replay {label} frame {i}: pressure card {got:.6f} "
                    f"atm, cpu-f64 {p_ref:.6f}, |d| {abs(got - p_ref):.3e} "
                    f"bound {bound:.3e} ({smi})")
                if not abs(got - p_ref) <= bound:
                    raise AssertionError(f"replay {label} frame {i}: "
                                         "pressure disagrees")
            log(f"replay {label}: frame {i} held against cpu f64 term by "
                f"term (the references' process {r['seconds']:.1f} s, "
                f"waited {time.perf_counter() - t0:.1f} s)")
        if self.analyze:
            cpu = refs["analyze"]
            moved = {k: _analyze_agree(k, v, cpu[k])
                     for k, v in self.analyze.items()}
            log(f"analyze: {len(moved)} analyzers held card against cpu "
                f"float64 (integers equal, floats rel 1e-9; pairs moved "
                f"bins within 1e-9 A of an edge: {moved}; cpu cuts: "
                f"{ANALYZE_CUTS}; cpu runs {cpu['seconds']:.1f} s) ({smi})")
        self.stop()

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def replay_references(path):
    """The --replay-references process: _replay_frame_plain of each deck
    in ``path`` (float64 and float32, the pressure's two energies where
    the deck computes it), written to ``path``/refs.json."""
    from mpmc_tpu_torch.io import input_script, pqr
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    with open(os.path.join(path, "frames.json")) as f:
        frames = json.load(f)
    out = {}
    for label, i in frames.items():
        t0 = time.perf_counter()
        job = input_script.parse_file(os.path.join(path, f"{label}.inp"))
        frame = pqr.read_frames(job.pqr_input)[i]
        with_p = bool(job.calc_pressure)
        ref, e64, n, vol = _replay_frame_plain(job, frame, "float64", with_p)
        p32, e32, _, _ = _replay_frame_plain(job, frame, "float32", with_p)
        out[label] = {"f64": ref, "f32": p32, "e64": e64, "e32": e32,
                      "n_vol": [n, vol],
                      "seconds": time.perf_counter() - t0}
    spec = os.path.join(path, "analyze.json")
    if os.path.exists(spec):
        t0 = time.perf_counter()
        with open(spec) as f:
            labels = json.load(f)
        calls = _analyze_calls(path)
        out["analyze"] = {k: _json_ready((calls[k][1] or calls[k][0])("cpu"))
                          for k in labels}
        out["analyze"]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(path, "refs.json"), "w") as f:
        json.dump(out, f)


# phase_analyze: the analyzers at the reference's defaults over the replay
# trajectories, and the cuts of their CPU checks (the checks' inputs; the
# card runs the cut input too, to compare)
ANALYZE_T, ANALYZE_TRIES, ANALYZE_SPHERE = 77.0, 2000, 512
ANALYZE_CUTS = {
    "sq": "the LJ trajectory's first 2 of 10 frames",
    "widom_mol": "the GCMC trajectory's first 3 of 10 frames",
    "asa": "the spheres of 64 of the 9,261 framework atoms, every 145th "
           "(all 9,261 block)"}


def _first_frames(src, dst, n):
    """The first n frames of a PQR trajectory, copied to dst."""
    out, k = [], 0
    with open(src) as f:
        for line in f:
            out.append(line)
            if line.startswith("END"):
                k += 1
                if k == n:
                    break
    with open(dst, "w") as f:
        f.writelines(out)


def analyze_inputs(refs):
    """The analyze phase's inputs beside the replay trajectories in
    ``refs.dir``: the h2_bss3 insertion template and the cut trajectories
    of the CPU checks (ANALYZE_CUTS); and the request for the CPU runs in
    the references' process."""
    from mpmc_tpu_torch.io import pqr
    from mpmc_tpu_torch.models import systems
    sp = systems.h2_bss3()
    atoms = [pqr.PqrAtom(serial=k + 1, name=sp.atom_names[k],
                         mol_name=sp.name, mol_id=1, flag="M",
                         xyz=np.asarray(sp.pos[k], np.float64),
                         mass=float(sp.mass[k]), charge=float(sp.charge[k]),
                         polar=0.0, eps=float(sp.eps[k]),
                         sig=float(sp.sig[k]))
             for k in range(len(sp.atom_names))]
    d = refs.dir
    pqr.write(os.path.join(d, "h2_bss3.pqr"), atoms)
    _first_frames(os.path.join(d, "lj.traj.pqr"),
                  os.path.join(d, "lj2.traj.pqr"), 2)
    _first_frames(os.path.join(d, "gcmc.traj.pqr"),
                  os.path.join(d, "gcmc3.traj.pqr"), 3)
    with open(os.path.join(d, "analyze.json"), "w") as f:
        json.dump(sorted(_analyze_calls(d)), f)


def _analyze_calls(d):
    """{label: (timed call, the CPU check's call or None: the timed one)},
    a call taking the device and returning {"frames", "exact" (lists
    equal), "float" (lists within rel 1e-9), "bins" (integer histograms
    under the bin-edge rule), "near" (entries within 1e-9 A of an
    edge)}, over the trajectories in ``d``."""
    from mpmc_tpu_torch import analyze as an
    from mpmc_tpu_torch.io import pqr
    g, lj, g3, lj2, tpl = (os.path.join(d, f) for f in (
        "gcmc.traj.pqr", "lj.traj.pqr", "gcmc3.traj.pqr", "lj2.traj.pqr",
        "h2_bss3.pqr"))
    box = pqr.read_first_frame(g).box
    dims = tuple(int(x) for x in np.maximum(np.ceil(
        np.linalg.norm(box, axis=1) / 0.7), 1))
    rng = np.random.default_rng(0)          # pore(seed=0)'s points
    pts, ctr = rng.uniform(0, 1, (20000, 3)), rng.uniform(0, 1, (2000, 3))
    fp = np.random.default_rng(0).uniform(0, 1, (ANALYZE_TRIES, 3))
    pq = an.random_posquat(ANALYZE_TRIES, seed=0)
    u = an.sphere_points(ANALYZE_SPHERE, seed=0)

    def rdf(dev):
        h, norm, near, nf = an.rdf_counts(g, "H2G", "H2G", device=dev)
        return {"frames": nf, "bins": [h], "float": [[norm]], "near": near}

    def density(dev):
        grid, nf, near = an.density_grid(g, "H2", "M", dims, device=dev)
        return {"frames": nf, "bins": [grid.ravel()], "near": near}

    def loading(dev):
        n = an.loading(g, "H2", "M", device=dev)
        return {"frames": len(n), "exact": [n]}

    def cluster(dev):
        series, hist = an.cluster(g, "H2", "M", device=dev)
        return {"frames": len(series), "exact": [series.ravel(), hist]}

    def msd(dev):
        m, c = an.msd(g, "H2", "M", device=dev)
        return {"frames": len(m), "float": [m], "exact": [c]}

    def orient(dev):
        c1, c2, c = an.orientation(g, "H2", "M", "H2E", device=dev)
        return {"frames": len(c1), "float": [c1, c2], "exact": [c]}

    def sq(path):
        def call(dev):
            _, total, nf, near = an.sq_hist(path, device=dev)
            return {"frames": nf, "bins": [total], "near": near}
        return call

    def widom(dev):
        e, ue, nf = an.widom_means(g, 34.2, 2.96, ANALYZE_T, fp, device=dev)
        return {"frames": nf, "float": [[e, ue]]}

    def widom_mol(path):
        def call(dev):
            e, ue, nf = an.widom_mol_means(path, *an.template_sites(tpl),
                                           ANALYZE_T, pq, device=dev)
            return {"frames": nf, "float": [[e, ue]]}
        return call

    def pore(dev):
        ds, rp = an.pore_samples(g, "*", "F", frac_pts=pts, frac_ctr=ctr,
                                 device=dev)
        return {"frames": 1, "float": [ds, rp]}

    def asa(atoms):
        def call(dev):
            c, _ = an.asa_counts(g, "*", "F", probe_sigma=3.64, unit_pts=u,
                                 atoms=atoms, device=dev)
            return {"frames": 1, "exact": [c]}
        return call

    n_fw = sum(1 for a in pqr.read_first_frame(g).atoms
               if a.flag == "F" and a.sig > 0)
    return {"rdf": (rdf, None), "density": (density, None),
            "loading": (loading, None), "cluster": (cluster, None),
            "msd": (msd, None), "orient": (orient, None),
            "sq": (sq(lj), sq(lj2)), "widom": (widom, None),
            "widom_mol": (widom_mol(g), widom_mol(g3)),
            "pore": (pore, None),
            "asa": (asa(None), asa(np.arange(0, n_fw, 145)[:64]))}


def _json_ready(res):
    return {k: ([np.asarray(x).tolist() for x in v] if isinstance(v, list)
                else v) for k, v in res.items()}


def phase_analyze(device, smi, refs):
    """Every frame, insertion and geometry analyzer of
    mpmc_tpu_torch.analyze on the card in float64, over phase_replay's
    10-frame trajectories: rdf of the H2 centres, the H2 COM density at
    0.7 A, loading, cluster, msd and orient of the 10.8k GCMC run (N
    changing), sq of the 10k LJ fluid, widom (one LJ site) and widom_mol
    (h2_bss3) at 2,000 tries a frame, pore (20,000 points, 2,000 centres)
    and asa (512 points a sphere) over its 9,261 framework atoms.  Each
    is timed (frames/s; seconds for pore and asa) and its check run
    kept: the references' process runs the same calls on the CPU
    (ANALYZE_CUTS), compared by _ReplayReferences.check."""
    calls = _analyze_calls(refs.dir)
    rep = {}
    for label, (timed, check) in calls.items():
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = timed(device)
        torch.cuda.synchronize(device)
        sec = time.perf_counter() - t0
        rep[label] = {"seconds": sec, "frames": res["frames"],
                      "frames_per_sec": res["frames"] / sec}
        refs.analyze[label] = check(device) if check else res
    log("analyze on the card (float64): " + "  ".join(
        f"{k} {r['seconds']:.2f} s" if k in ("pore", "asa")
        else f"{k} {r['frames_per_sec']:.2f} frames/s"
        for k, r in rep.items()) + f"  ({smi})")
    return rep


def _analyze_agree(label, card, cpu):
    """Hold one analyzer's card run against its CPU run; returns the
    count of pairs that moved bins (within the edge rule)."""
    for a, b in zip(card.get("exact", []), cpu.get("exact", [])):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"analyze {label}: exact outputs differ")
    for a, b in zip(card.get("float", []), cpu.get("float", [])):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        if not np.allclose(a, b, rtol=1e-9, atol=1e-9 * scale):
            raise AssertionError(f"analyze {label}: card vs cpu beyond rel "
                                 f"1e-9: {np.max(np.abs(a - b))!r}")
    moved = 0
    for a, b in zip(card.get("bins", []), cpu.get("bins", [])):
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        n = max(a.size, b.size)
        a, b = np.pad(a, (0, n - a.size)), np.pad(b, (0, n - b.size))
        diff = int(np.abs(a - b).sum())
        allowed = 2 * (card.get("near", 0) + cpu.get("near", 0))
        if diff > allowed:
            raise AssertionError(f"analyze {label}: {diff} bin counts moved,"
                                 f" {allowed} allowed by the edge rule")
        moved += (diff + 1) // 2
    if card["frames"] != cpu["frames"]:
        raise AssertionError(f"analyze {label}: frames {card['frames']} vs "
                             f"{cpu['frames']}")
    return moved


class _PointLog(io.StringIO):
    """A campaign's log that keeps the launch counts at each finished
    point (the ``point done`` line)."""

    def __init__(self):
        super().__init__()
        self.points = []

    def write(self, text):
        if "point done:" in text:
            self.points.append((text.strip(), _launch_counts()))
        return super().write(text)


def phase_campaign(device, smi, chains=16):
    """``python -m mpmc_tpu_torch.campaign``'s main in process on DECK
    (corrtime 100): 16 chains, pressures 0.5 1 2 atm, 200-400 steps a
    point, one equilibration block, a checkpoint directory — twice
    uninterrupted, then the first pressure alone and the full list resumed
    in a fresh directory; the resumed rows against the uninterrupted ones
    (as closely as the two uninterrupted campaigns agree), B4 over chains
    and B2 launched on every point, and the aggregate chain-steps/s."""
    import contextlib

    from mpmc_tpu_torch import campaign
    from mpmc_tpu_torch.io import pqr
    params, state, _, _ = bench_system("float32", "cpu")
    rep = {}
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pqr.write_state("bench10k.pqr", params, state, ["H2"])
            with open("deck.inp", "w") as f:
                f.write(DECK.format(numsteps=400, L=float(state.box[0, 0]))
                        + "corrtime 100\n")
            args = ["deck.inp", "--chains", str(chains), "--min-steps",
                    "200", "--max-steps", "400", "--equil-blocks", "1"]
            runs = {}
            for name, pressures, ck in (
                    ("a", ["0.5", "1", "2"], "ck_a"),
                    ("b", ["0.5", "1", "2"], "ck_b"),
                    ("first", ["0.5"], "ck_r"),
                    ("resumed", ["0.5", "1", "2"], "ck_r")):
                out = _PointLog()
                _reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rows = campaign.main(args + [
                        "--pressures", *pressures, "--checkpoint-dir", ck,
                        "-o", f"{name}.csv"])
                torch.cuda.synchronize(device)
                runs[name] = (rows, out, time.perf_counter() - t0)
        finally:
            os.chdir(old)
    rows_a, out_a, wall_a = runs["a"]
    prev = {"pair_terms": 0, "mol_pair_chains": 0}
    steps_total = 0
    for r, (line, ln) in zip(rows_a, out_a.points):
        b4 = ln["mol_pair_chains"] - prev["mol_pair_chains"]
        b2 = ln["pair_terms"] - prev["pair_terms"]
        prev = ln
        steps_total += r.steps
        log(f"campaign point {r.pressure_atm} atm: {r.steps} steps, <N> "
            f"{r.n_mean:.3f} +- {r.n_sem:.4f}, B4 over {chains} chains "
            f"{b4} launches, B2 {b2}  ({line}; {smi})")
        if not (r.steps <= b4 <= 2 * r.steps and b2 >= chains):
            raise AssertionError(f"campaign point {r.pressure_atm}: B4 over "
                                 f"chains {b4}, B2 {b2} for {r.steps} steps")
    rate = chains * steps_total / wall_a
    log(f"campaign: {len(rows_a)} points, {steps_total} steps, "
        f"{rate:.2f} chain-steps/s aggregate ({wall_a:.2f} s, set-up "
        f"included; {smi})")
    if "resuming: 1 points done" not in runs["resumed"][1].getvalue():
        raise AssertionError("the campaign did not resume")

    def gap(x, y):
        return {"rows": sum(1 for a, b in zip(x, y)
                            if not _rows_equal(a.row(), b.row())),
                "n_mean": max(abs(a.n_mean - b.n_mean)
                              for a, b in zip(x, y))}
    _held_as_two_runs("campaign", gap(rows_a, runs["b"][0]),
                      gap(rows_a, runs["resumed"][0]))
    rep.update(points=[(r.pressure_atm, r.steps, r.n_mean, r.n_sem)
                       for r in rows_a],
               chain_steps_per_sec=rate, wall_s=wall_a)
    return rep


# ---------------------------------------------------------------------------
# The Feynman-Hibbs and Feynman-Kleinert corrections: B1, B3 and B6 with
# them against their plain versions, and the decks that run them
# ---------------------------------------------------------------------------

def _rss_tol(trace):
    """[C, 2]: 8 float32 epsilons x the root sum of squares of the rd and
    es terms summed into the accepted steps' deltas (the plain trace's
    rss) — each term is rounded to float32 once or twice in either
    version, so the two sums drift apart as a random walk of that scale
    (B6's rule, phase_pda_kernel)."""
    sq = sum(torch.where(t["accept"][:, None], t["rss"] ** 2,
                         torch.zeros_like(t["rss"])) for t in trace)
    return 8 * EPS32 * np.sqrt(sq.cpu().numpy())


# The float32 rows of a kernel and of its plain version may differ in
# their last places (the kernels contract multiply-adds into FMAs in the
# trial rows, the plain version rounds each product): bounded in advance
# by ROW_ULPS float32 ulps of the cell's longest edge.  On the 84 A bench
# cell (ulp 7.6e-6 A) the largest difference in five H100 runs of
# phase_rd_fused_kernels was 1.526e-5 A, 2 ulps.
ROW_ULPS = 8


def _row_bound(box):
    """ROW_ULPS float32 ulps of the longest edge of ``box`` [3, 3], in A."""
    b = box.double().cpu()
    edge = max(float(torch.linalg.norm(b, dim=0).max()),
               float(torch.linalg.norm(b, dim=1).max()))
    return ROW_ULPS * float(np.spacing(np.float32(edge)))


def _slope_tol(trace, box, n_sums):
    """[C, n_sums]: the first-order move of the rd and es sums (the first
    two columns) when the two versions' rows differ by _row_bound(box):
    the plain trace's slope (run with ``slopes``) summed over the accepted
    steps x that bound.  Near a close contact (a form softer than LJ lets
    an H2 reach a charged framework site) one last-place rounding of a row
    moves a step's sums beyond the per-term rule of _rss_tol."""
    sl = sum(torch.where(t["accept"][:, None], t["slope"],
                         torch.zeros_like(t["slope"])) for t in trace)
    tol = np.zeros((sl.shape[0], n_sums))
    tol[:, :2] = sl.cpu().numpy() * _row_bound(box)
    return tol


def _uvt_fh_check(label, system, thermo_c, u, device, cluster=16,
                  slopes=False):
    """B1 at ``cluster`` against its plain version on the table ``u`` [C,
    K, 16] for C stacked copies of ``system``'s state at ``thermo_c`` (a
    temperature per chain, or one): equal decisions and slot aliveness,
    the sums within phase_uvt_kernel's float32 tolerance plus, for rd and
    es, _rss_tol; positions within 1e-4 A, S(k) within 1e-4 of its scale
    (float64: phase_uvt_kernel's rule, rel 1e-10; S(k) only under ewald).
    With ``slopes`` the float32 rd and es sums also get _slope_tol, the
    plain version run with its slopes.  Returns (the kernel's outputs, the
    plain trace, the largest |d|, the launch's arguments)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, _ = system
    C, K = u.shape[0], u.shape[1]
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo_c, u,
        metropolis.uvt_fused_tables(params, cfg))
    trace = []
    p = mk.run_steps_uvt_plain(*args, **kw, trace=trace, slopes=slopes)
    k = mk.run_steps_uvt(*args, **kw, cluster=cluster)
    torch.cuda.synchronize(device)
    ps, ks = p[2].cpu().numpy(), k[2].cpu().numpy()
    log(f"B1 {label} G={cluster} C={C} K={K}: kernel counts "
        f"{ks[:, 6:12].tolist()} plain {ps[:, 6:12].tolist()}")
    if not (np.array_equal(ks[:, 6:12], ps[:, 6:12])
            and torch.equal(k[1], p[1])):
        step, chain, margin = _first_divergence(
            lambda n: mk.run_steps_uvt(
                *args[:24], args[24][:, :n].contiguous(), args[25], **kw,
                cluster=cluster)[2][:, 6:9].sum(1).long().cpu(), trace, K)
        raise AssertionError(
            f"B1 {label}: decisions differ from the plain version; first at "
            f"step {step} of chain {chain}, |ln u - ln acc| = {margin:.3e}")
    n_acc = ps[:, 6:9].sum(1, keepdims=True)
    f64 = cfg.tdtype == torch.float64
    ew = cfg.coulomb == "ewald"
    if f64:             # phase_uvt_kernel's float64 rule
        tol = np.maximum(1e-10 * np.abs(ps[:, :6]), 1e-8)
    else:
        tol = 2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0)
        tol[:, :2] += _rss_tol(trace)
    d_sums = np.abs(ks[:, :6] - ps[:, :6])
    d_pos = float((k[0] - p[0]).abs().max())
    if slopes and not f64:
        tol += _slope_tol(trace, state.box, 6)
    d_sk = (max(float((a - b).abs().max()) for a, b in zip(k[3:5], p[3:5]))
            if ew else 0.0)
    sk_tol = (1e-9 if f64 else 1e-4 * (1.0 + float(p[3].abs().max()))
              ) if ew else 0.0
    log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
        f"{tol.max():.3e}), pos {d_pos:.3e} A, S(k) {d_sk:.3e}")
    if not (np.all(d_sums <= tol) and d_pos <= (1e-9 if f64 else 1e-4)
            and d_sk <= sk_tol):
        raise AssertionError(f"B1 {label} disagrees with its plain version")
    return k, trace, max(float(d_sums.max()), d_pos, d_sk), (args, kw)


def phase_fh_kernels(device, K=32, seed=2026, k_time=1000):
    """B1, B3 and B6 under the Feynman-Hibbs (order 2, 4) and
    Feynman-Kleinert corrections against their plain versions, float32,
    at G = 16, on numpy-seeded tables: B1 on the 10.8k bench system (77
    K) with FH2, FH4 and FK, at C = 2 with the chains at 77 and 120 K (a
    beta per chain) and at C = 1 (equal bit for bit to chain 0 of the C =
    2 launch); B3 on the 10.0k MOF + H2 NVT system (nvt_system, after its
    warm-up) with FH2, FH4 and FK at C = 2 (_nvt_check, each chain equal
    to its C = 1 launch); B6 on the polar bench system with FH2 (direct
    field): forced survivors of each move type, natural coins and a
    survivor-free table (phase_pda_kernel's float32 tolerances).  B1's
    and B3's sums are held to their classical float32 tolerance plus, for
    rd and es, 8 float32 epsilons x the root sum of squares of their
    terms (_rss_tol, B6's rule): the quantum terms make more of the large
    core terms whose rounding the classical allowance does not cover.  Times
    per step at G = 16 (B1, B3: 1000-step launches at C = 1; B6: the
    survivor-free 16-step table), each beside the classical launch's in
    this call, the plain version's time and the bound with the quantum
    operations counted (_fused_ops, _pda_ops).  Returns {entry: report}
    for run_steps_uvt_{fh2,fh4,fk}, run_steps_{fh2,fh4,fk} and
    run_steps_uvt_pda_fh2."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    rng = np.random.default_rng(seed)
    reps = {}
    f32 = torch.float32

    def timed(fn, n_steps):
        return (_time_steps(fn, device, n_steps),
                time_device(fn, device, n=5) / n_steps)

    # ---- B1
    params, state0, cfg0, thermo = bench_system("float32", device)
    u2 = torch.as_tensor(rng.random((2, K, 16)), dtype=f32, device=device)
    ut = torch.as_tensor(rng.random((1, k_time, 16)), dtype=f32,
                         device=device)
    two = thermo.replace(temperature=torch.tensor(FH_TEMPS, dtype=f32,
                                                  device=device))
    classical = None
    for q in ("classical", "fh2", "fh4", "fk"):
        cfg = dataclasses.replace(cfg0, **FH_VARIANTS[q])
        state = metropolis.initialize(state0, params, cfg, thermo)
        at, kwt = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, 1), params, cfg, thermo, ut,
            metropolis.uvt_fused_tables(params, cfg))
        ms, dms = timed(lambda: mk.run_steps_uvt(*at, **kwt, cluster=16),
                        k_time)
        log(f"B1 f32 {q} C=1 G=16: {ms * 1e3:.3f} us per step ({k_time}-"
            f"step launches; {dms * 1e3:.3f} back to back)")
        if q == "classical":
            classical = (ms, dms)
            continue
        system = (params, state, cfg, thermo)
        k2, _, err2, _ = _uvt_fh_check(f"f32 {q} (77 / 120 K)", system, two,
                                       u2, device)
        k1, trace, err1, (a1, kw1) = _uvt_fh_check(f"f32 {q} (77 K)", system,
                                                   thermo, u2[:1], device)
        if not all(torch.equal(x[0], y[0]) for x, y in zip(k1, k2)):
            raise AssertionError(f"B1 {q}: the C = 1 launch differs from "
                                 "chain 0 of the C = 2 launch")
        pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1), device,
                         n=1) / K
        ops = _fused_ops(trace, cfg, kw1["kvecs"].shape[0])
        n_io = (_nbytes(*a1[:25], *kw1.values())
                + _nbytes(k1[0], a1[1], k1[1], k1[2], *k1[3:]))
        bound, by = _bound_ms(ops, n_io)
        reps[f"run_steps_uvt_{q}"] = {
            "max_abs_err": max(err1, err2), "ms": ms, "device_ms": dms,
            "plain_ms": pms, "bound_ms": bound / K, "bound_by": by,
            "classical_ms": classical[0],
            "classical_device_ms": classical[1], "cluster": "G=16 (C=1)"}
        log(f"B1 f32 {q}: kernel {ms * 1e3:.3f} us/step (classical "
            f"{classical[0] * 1e3:.3f}), plain {pms * 1e3:.1f} us/step, "
            f"bound {bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
            "ops/step)")
    # ---- B3
    params, state0, cfg0, thermo = nvt_system("mof", "float32", device)
    u_np = rng.random((2, K, 16))
    ut = torch.as_tensor(rng.random((1, k_time, 16)), dtype=f32,
                         device=device)
    tables = metropolis.nvt_fused_tables(params, state0.mol_alive)
    for q in ("classical", "fh2", "fh4", "fk"):
        cfg = dataclasses.replace(cfg0, **FH_VARIANTS[q])
        state = metropolis.initialize(state0, params, cfg, thermo)
        at, kwt = metropolis.fused_nvt_launch_args(
            multichain.stack_states(state, 1), params, cfg, thermo, ut,
            tables)
        ms, dms = timed(lambda: mk.run_steps(*at, **kwt, cluster=16), k_time)
        log(f"B3 f32 {q} C=1 G=16: {ms * 1e3:.3f} us per step ({k_time}-"
            f"step launches; {dms * 1e3:.3f} back to back)")
        if q == "classical":
            classical = (ms, dms)
            continue
        rep, trace = {"max_abs_err": 0.0}, []
        a1, kw1, one = _nvt_check(f"mof f32 {q}", (params, state, cfg,
                                                    thermo), u_np, device,
                                  rep, trace_out=trace, sizes=[16],
                                  rss=True)[16]
        pms = time_calls(lambda: mk.run_steps_plain(*a1, **kw1), device,
                         n=1) / K
        ops = _fused_ops(trace, cfg, kw1["kvecs"].shape[0])
        bound, by = _bound_ms(ops, _nbytes(*a1[:16], *kw1.values())
                              + _nbytes(*one))
        rep.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bound / K,
                   bound_by=by, classical_ms=classical[0],
                   classical_device_ms=classical[1], cluster="G=16 (C=1)")
        reps[f"run_steps_{q}"] = rep
        log(f"B3 f32 {q}: kernel {ms * 1e3:.3f} us/step (classical "
            f"{classical[0] * 1e3:.3f}), plain {pms * 1e3:.1f} us/step, "
            f"bound {bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} "
            "ops/step)")
    # ---- B6 (direct field) with FH2
    params, state0, cfg0, thermo = polar_system("float32", device)
    Kp = mk.PDA_SEG
    rep = {"max_abs_err": 0.0}
    runs = {}
    for q in ("fh2", "classical"):
        cfg = dataclasses.replace(cfg0, polar_delayed=True, fused_mc=True,
                                  **FH_VARIANTS[q])
        state = metropolis.initialize(state0, params, cfg, thermo)
        cfg_eff = mk.pda_effective_cfg(cfg, params)
        tables = metropolis.uvt_fused_tables(params, cfg_eff)
        consts = metropolis._uvt_chunk_consts(
            state.pos, state.box, params, thermo, cfg_eff, tables[5],
            tables[6])
        runs[q] = (state, cfg_eff, tables, consts)

    def pda_args(q, u):
        state, cfg_eff, tables, consts = runs[q]
        return metropolis.pda_launch_args(state, params, cfg_eff, thermo, u,
                                          tables, consts)

    def table(x):
        return torch.as_tensor(x, dtype=f32, device=device)

    us = {}
    for mt, lane8 in ((0, 0.9), (1, 0.1), (2, 0.4)):
        x = rng.random((Kp, 16))
        x[0, 4], x[0, 8] = 1e-30, lane8
        us[f"step 0 survives ({'disp ins del'.split()[mt]})"] = table(x)
    us["natural"] = table(rng.random((Kp, 16)))
    def launch_fh2(u):
        a, kw = pda_args("fh2", u)
        return mk.run_steps_uvt_pda(*a, **kw)

    us["survivor-free"] = _pda_survivor_free(
        launch_fh2, table(rng.random((Kp, 16))), rng)
    hits = 0
    for name, u in us.items():
        a, kw = pda_args("fh2", u)
        trace = []
        p = mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace).cpu().numpy()
        k = mk.run_steps_uvt_pda(*a, **kw, cluster=16).cpu().numpy()
        rss = np.zeros(8)
        if trace[-1].get("rss"):
            rss[[0, 1, 2, 6]] = trace[-1]["rss"]
        want = np.concatenate([p[1, :6], p[0, 9:11]])
        tol = 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss
        d_vals = np.abs(np.concatenate([k[1, :6], k[0, 9:11]]) - want)
        d_rows = float(np.abs(k[2:5] - p[2:5]).max())
        log(f"B6 f32 fh2 {name} G=16: n_done {k[0, 0]:g} hit {k[0, 1]:g} "
            f"mtype {k[0, 2]:g} (plain: {p[0, 0]:g} {p[0, 1]:g} "
            f"{p[0, 2]:g}); |d| deltas/d*/lnb {d_vals.max():.3e} (worst "
            f"|d|/tol {float(np.max(d_vals / tol)):.3f}), rows {d_rows:.3e}")
        if not (np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                               p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
                and np.all(d_vals <= tol) and d_rows <= 1e-4):
            raise AssertionError(f"B6 fh2 {name} disagrees with its plain "
                                 "version")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d_vals.max()),
                                 d_rows)
        hits += int(k[0, 1])
    if hits < 3:
        raise AssertionError(f"B6 fh2: only {hits} survivors")
    u = us["survivor-free"]
    a, kw = pda_args("fh2", u)
    trace = []
    mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
    ops = _pda_ops(trace, "direct", kw["kvecs"].shape[0],
                   mk.quantum_option(a[-1]))
    bound, by = _bound_ms(ops, _nbytes(*a, *kw.values()) + 8 * 16 * 8)
    ac, kwc = pda_args("classical", u)
    for tag, (aa, kk) in (("classical", (ac, kwc)), ("fh2", (a, kw))):
        ms = time_calls(lambda: mk.run_steps_uvt_pda(*aa, **kk, cluster=16),
                        device) / Kp
        dms = time_device(lambda: mk.run_steps_uvt_pda(*aa, **kk,
                                                       cluster=16),
                          device, n=20) / Kp
        rep.update({f"{tag}_ms": ms, f"{tag}_device_ms": dms})
        log(f"B6 f32 {tag}, survivor-free table, G=16: {ms * 1e3:.2f} "
            f"us/step per call, {dms * 1e3:.2f} on the card alone")
    pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw), device,
                     n=3) / Kp
    rep.update(ms=rep.pop("fh2_ms"), device_ms=rep.pop("fh2_device_ms"),
               plain_ms=pms, bound_ms=bound / Kp, bound_by=by,
               cluster="G=16")
    reps["run_steps_uvt_pda_fh2"] = rep
    log("fh kernels: " + json.dumps(reps))
    return reps


# the FH/FK decks: (label, system, deck lines, numsteps); DECK's corrtime
# 1000 (100 on the scan deck, POLAR_CORRTIME on the polar one)
FH_DECKS = (
    ("fh2_scan", "mof", "feynman_hibbs on\ncorrtime 100\n", 300),
    ("fh2_fused", "mof", "feynman_hibbs on\nfused_mc on\n", 5000),
    ("fk_fused", "mof", "feynman_kleinert on\nfused_mc on\n", 5000),
    ("fh4_nvt", "mof", "ensemble nvt\nfused_mc on\nfeynman_hibbs on\n"
     "feynman_hibbs_order 4\n", 5000),
    ("fh2_pda", "polar", "polar_delayed on\nfused_mc on\nfeynman_hibbs on\n",
     100))
FH_ROUTES = {"fh2_scan": (None, None),
             "fh2_fused": ("single-chain fused µVT kernel", "run_steps_uvt"),
             "fk_fused": ("single-chain fused µVT kernel", "run_steps_uvt"),
             "fh4_nvt": ("single-chain fused NVT kernel", "run_steps"),
             "fh2_pda": ("polar delayed-acceptance stage-1 kernel",
                         "run_steps_uvt_pda")}


def _fh_deck_checks(label, su, text, ln, device, seed):
    """The checks of an FH/FK deck after its run: the pair passes' route
    named in the log, B2 and B4 never launched, the fused route taken and
    its kernel launched; after a further chunk the carried energy equals a
    fresh recompute (the polar term within _polar_tol); the correction
    moves rd by more than 1 K on the final configuration.  Returns the
    deck's report."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    route, kernel = FH_ROUTES[label]
    if ("pair passes: the plain tile pass on the device" not in text
            or "WARNING" in text):
        raise AssertionError(f"{label}: the pair passes' route is not "
                             "logged, or a WARNING was")
    b2b4 = ln["pair_terms"] + ln["mol_pair"] + ln["mol_pair_chains"]
    if b2b4:
        raise AssertionError(f"{label}: B2/B4 launched under FH/FK: {ln}")
    if route and (f"fused_mc: {route}" not in text or not ln[kernel]):
        raise AssertionError(f"{label}: did not run {route}: {ln}")
    rate = float(text.split("steps/sec:")[1].split()[0])
    g = torch.Generator(device=device).manual_seed(seed)
    params, cfg, thermo = su.params, su.cfg, su.thermo
    if kernel == "run_steps_uvt":
        st, _ = metropolis.run_chunk_fused_uvt(su.state, params, cfg,
                                               thermo, 1000, generator=g)
    elif kernel == "run_steps":
        st, _ = metropolis.run_chunk_fused(su.state, params, cfg, thermo,
                                           1000, generator=g)
    elif kernel == "run_steps_uvt_pda":
        st, _ = metropolis.run_chunk_fused_uvt_polar_da(
            su.state, params, cfg, thermo, 100, generator=g,
            tables=metropolis.uvt_fused_tables(
                params, mk.pda_effective_cfg(cfg, params)))
    else:
        st, _ = metropolis.run_chunk(su.state, params, cfg, thermo, 100,
                                     generator=g)
    _check_bookkeeping(f"{label}, a further chunk", st, su,
                       polar=cfg.polarization)
    fresh = metropolis.initialize(st, params, cfg, thermo)
    plain = metropolis.initialize(st, params, dataclasses.replace(
        cfg, **FH_VARIANTS["classical"]), thermo)
    d_rd = float(fresh.energy.rd) - float(plain.energy.rd)
    log(f"{label}: {rate:.2f} steps/s; rd {float(fresh.energy.rd):.4f} K, "
        f"classical {float(plain.energy.rd):.4f} K (FH/FK - classical "
        f"{d_rd:+.4f} K); B2/B4 launches {b2b4}; {kernel} launches "
        f"{ln.get(kernel)}")
    if not abs(d_rd) > 1.0:
        raise AssertionError(f"{label}: |rd(FH) - rd(classical)| <= 1 K")
    return {"steps_per_sec": rate, "d_rd_K": d_rd, "b2_b4_launches": b2b4,
            "kernel_launches": ln.get(kernel), "N": float(
                st.n_molecules(params))}


def phase_fh_decks(device, example_steps=10000):
    """The FH/FK decks through run.run (FH_DECKS: DECK with feynman_hibbs
    on the scan path and on fused µVT, DECK with feynman_kleinert on fused
    µVT, the MOF NVT deck with FH order 4, PDA (d) with FH), each checked
    by _fh_deck_checks; then examples/h2_quantum_fk.inp through
    mpmc_tpu_torch's command-line main (``example_steps`` steps), B1
    launched once per corrtime.  Returns ({deck: launches}, {deck:
    report})."""
    import contextlib
    from mpmc_tpu_torch import __main__ as port_main
    from mpmc_tpu_torch.io import input_script
    launches, reps = {}, {}
    for i, (label, kind, extra, numsteps) in enumerate(FH_DECKS):
        su, _, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                    kind=kind)
        reps[label] = _fh_deck_checks(label, su, text, ln, device, 61 + i)
        launches[label] = ln
    deck = open(os.path.join(REPO, "examples", "h2_quantum_fk.inp")).read()
    deck = deck.replace("numsteps         20000",
                        f"numsteps {example_steps}")
    deck = deck.replace("examples/framework_h2.pqr",
                        os.path.join(REPO, "examples", "framework_h2.pqr"))
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open("h2_quantum_fk.inp", "w") as f:
                f.write(deck)
            job = input_script.parse_file("h2_quantum_fk.inp")
            out = io.StringIO()
            _reset_counts()
            with contextlib.redirect_stdout(out):
                port_main.main(["h2_quantum_fk.inp"])
            torch.cuda.synchronize(device)
            ln = _launch_counts()
        finally:
            os.chdir(old)
    text = out.getvalue()
    log("\n".join(text.splitlines()[:6] + text.splitlines()[-3:]))
    n_blocks = job.cfg.numsteps // job.cfg.corrtime
    if not (job.cfg.feynman_kleinert and ln["run_steps_uvt"] == n_blocks):
        raise AssertionError(f"h2_quantum_fk.inp: B1 launched "
                             f"{ln['run_steps_uvt']} times for {n_blocks} "
                             "blocks")
    rate = float(text.split("steps/sec:")[1].split()[0])
    if ("fused_mc: single-chain fused µVT kernel" not in text
            or "pair passes: the plain tile pass" not in text
            or ln["pair_terms"] + ln["mol_pair"]):
        raise AssertionError(f"h2_quantum_fk.inp: not the FK fused route "
                             f"({ln})")
    log(f"h2_quantum_fk.inp: {example_steps} steps at "
        f"{job.temperature:g} K, {rate:.2f} steps/s, B1 "
        f"launches {ln['run_steps_uvt']}")
    launches["example_fk"] = ln
    reps["example_fk"] = {"steps_per_sec": rate,
                          "kernel_launches": ln["run_steps_uvt"]}
    return launches, reps


# the µVT extras (cavity bias, TMMC and its flat-histogram bias) at the
# reference's default grid: on the 84 A lattice of the bench system
# (framework atoms at (i + 0.5) 4 A) 128 of the 1,000 cell centres are
# open before any H2 closes one, the nearest 2.553 A from an atom
XT_CFG = {"cavity_bias": True, "cavity_grid": 10, "cavity_radius": 2.5,
          "tmmc": True, "tmmc_bias": True}


def _xt_system(device, seed, polar=False):
    """(params, state, cfg, thermo) of the bench system (``polar``: the
    polar one, jittered, with polar_delayed and fused_mc, the PDA (d)
    setting) under XT_CFG, initialized on the card (its cavity grid and
    TMMC matrix), with a numpy-seeded eta in [-1, 1) per macrostate (a
    random table, so that a wrong row of it changes decisions)."""
    from mpmc_tpu_torch.mc import metropolis
    if polar:
        params, state, cfg, thermo = polar_system("float32", device)
        cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True)
    else:
        params, state, cfg, thermo = bench_system("float32", device)
    cfg = dataclasses.replace(cfg, **XT_CFG)
    state = metropolis.initialize(state, params, cfg, thermo)
    eta = np.random.default_rng(seed).uniform(
        -1.0, 1.0, params.n_mols_max + 1)
    thermo = thermo.replace(tmmc_eta=torch.as_tensor(
        eta, dtype=torch.float32, device=device))
    return params, state, cfg, thermo


def _sum_a_tol(tm_plain, beta):
    """The rule for a TMMC matrix's Sigma a columns, kernel against plain:
    each attempt's a = min(1, e^{ln t}) moves by at most beta |d du| with
    |d du| <= 2e-3 K, the float32 rule of one move's energy delta
    (phase_uvt_kernel), plus 1e-5 for the 2e-5 relative part at a du
    where a e^{...} peaks; so |d Sigma a[N]| <= n[N] (beta 2e-3 K +
    1e-5)."""
    n = tm_plain[..., [0, 2]]
    return n * (beta * 2e-3 + 1e-5)


def _uvt_xt_check(label, system, u, device, cluster=None):
    """B1's XT instance against its plain version on ``u`` [C, K, 16]:
    equal move counts, slot aliveness and TMMC counts; the sums within
    phase_uvt_kernel's float32 rule, the Sigma a columns within
    _sum_a_tol, positions within 1e-4 A.  Returns (kernel outputs, plain
    trace, largest |d|, (args, kw), TMMC matrices (kernel, plain))."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C, K = u.shape[0], u.shape[1]
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    trace = []
    tm_p = kw["tmmc_out"]
    p = mk.run_steps_uvt_plain(*args, **kw, trace=trace)
    kw_k = dict(kw, tmmc_out=torch.zeros_like(tm_p))
    k = mk.run_steps_uvt(*args, **kw_k, cluster=cluster)
    torch.cuda.synchronize(device)
    tm_k = kw_k["tmmc_out"].cpu().numpy()
    tm_pn = tm_p.cpu().numpy()
    ps, ks = p[2].cpu().numpy(), k[2].cpu().numpy()
    log(f"B1 XT {label} C={C} K={K} G={mk.run_steps_uvt.last_cluster}: "
        f"kernel counts {ks[:, 6:12].sum(0).tolist()} plain "
        f"{ps[:, 6:12].sum(0).tolist()}; TMMC attempts kernel "
        f"{tm_k[..., [0, 2]].sum():.0f} plain {tm_pn[..., [0, 2]].sum():.0f}")
    if not (np.array_equal(ks[:, 6:12], ps[:, 6:12])
            and torch.equal(k[1], p[1])
            and np.array_equal(tm_k[..., [0, 2]], tm_pn[..., [0, 2]])):
        raise AssertionError(f"B1 XT {label}: decisions differ from the "
                             "plain version")
    if tm_k[..., [0, 2]].sum() != ks[:, 10:12].sum():
        raise AssertionError(f"B1 XT {label}: TMMC attempts != insert + "
                             "delete attempts")
    n_acc = ps[:, 6:9].sum(1, keepdims=True)
    tol = 2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0)
    d_sums = np.abs(ks[:, :6] - ps[:, :6])
    d_pos = float((k[0] - p[0]).abs().max())
    beta = float(args[14].reshape(-1)[0])
    d_a = np.abs(tm_k[..., [1, 3]] - tm_pn[..., [1, 3]])
    tol_a = _sum_a_tol(tm_pn, beta)
    worst = float(np.max(d_a / np.maximum(tol_a, 1e-30)))
    log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
        f"{tol.max():.3e}), pos {d_pos:.3e} A, Sigma a {d_a.max():.3e} "
        f"(worst |d|/tol {worst:.3f}), Sigma a total "
        f"{tm_pn[..., [1, 3]].sum():.6f}")
    if not (np.all(d_sums <= tol) and d_pos <= 1e-4
            and np.all(d_a <= tol_a)):
        raise AssertionError(f"B1 XT {label} disagrees with its plain "
                             "version")
    return (k, trace, max(float(d_sums.max()), d_pos, float(d_a.max())),
            (args, kw_k), (tm_k, tm_pn))


def phase_xt_kernels(device, K=128, K32=48, seed=2027, k_time=1000):
    """B1 and B6 with cavity bias, TMMC and tmmc_bias (their XT instances,
    XT_CFG) against their plain versions, float32, on numpy-seeded tables:
    B1 on the 10.8k bench system at C = 1 (G = 16) and C = 32 (the
    wrapper's G) — equal decisions, slot aliveness and TMMC attempt
    counts, the sums in phase_uvt_kernel's rule, the Sigma a columns in
    _sum_a_tol's —; B6 on the polar system (PDA (d)) with forced
    survivors of each move type, natural coins and a survivor-free table,
    in phase_pda_kernel's float32 tolerances.  Times per step beside the
    classical instance's in the same call (B1 1000-step launches at C = 1
    and 32, on the card alone too; B6 the survivor-free 16-step table), the
    plain version's and the bound.  Returns {entry: report} for
    run_steps_uvt_xt, run_steps_uvt_xt_c32 and run_steps_uvt_pda_xt."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    reps = {}
    system = _xt_system(device, seed)
    params, state, cfg, thermo = system
    n_open = int(state.cavity_open.sum())
    log(f"B1 XT: the bench system's grid has {n_open} open cells of "
        f"{cfg.cavity_grid ** 3}")
    if not 0 < n_open < cfg.cavity_grid ** 3:
        raise AssertionError(f"cavity grid: {n_open} open cells")
    cls = dataclasses.replace(cfg, **{k: False for k in
                                      ("cavity_bias", "tmmc", "tmmc_bias")})
    tables = metropolis.uvt_fused_tables(params, cfg)
    for C, Kc, G in ((1, K, 16), (32, K32, None)):
        u = torch.as_tensor(rng.random((C, Kc, 16)), dtype=f32,
                            device=device)
        k, trace, err, (a1, kw1), _ = _uvt_xt_check(
            "f32 (77 K)", system, u, device, cluster=G)
        name = "run_steps_uvt_xt" + ("" if C == 1 else f"_c{C}")
        pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1), device,
                         n=1) / Kc
        ops = _fused_ops(trace, cfg, kw1["kvecs"].shape[0])
        n_io = (_nbytes(*a1[:25], *kw1.values())
                + _nbytes(k[0], a1[1], k[1], k[2], *k[3:]))
        bound, by = _bound_ms(ops, n_io)
        ut = torch.as_tensor(rng.random((C, k_time, 16)), dtype=f32,
                             device=device)
        times = {}
        for tag, c in (("classical", cls), ("xt", cfg)):
            at, kwt = metropolis.fused_uvt_launch_args(
                multichain.stack_states(state, C), params, c, thermo, ut,
                tables)

            def launch():
                if "tmmc_out" in kwt:
                    kwt["tmmc_out"].zero_()
                return mk.run_steps_uvt(*at, **kwt, cluster=G)

            times[tag] = (_time_steps(launch, device, k_time),
                          time_device(launch, device, n=5) / k_time)
            log(f"B1 f32 {tag} C={C} G={mk.run_steps_uvt.last_cluster}: "
                f"{times[tag][0] * 1e3:.3f} us per step ({k_time}-step "
                f"launches; {times[tag][1] * 1e3:.3f} back to back)")
        reps[name] = {
            "max_abs_err": err, "ms": times["xt"][0],
            "device_ms": times["xt"][1], "plain_ms": pms,
            "bound_ms": bound / Kc, "bound_by": by,
            "classical_ms": times["classical"][0],
            "classical_device_ms": times["classical"][1],
            "cluster": f"G={mk.run_steps_uvt.last_cluster} (C={C})",
            "per": "step" if C == 1 else f"step of {C} chains"}
        log(f"B1 XT C={C}: kernel {times['xt'][0] * 1e3:.3f} us/step "
            f"(classical {times['classical'][0] * 1e3:.3f}), plain "
            f"{pms * 1e3:.1f} us/step, bound {bound / Kc * 1e3:.4f} us/step "
            f"({by}; {ops / Kc:.3e} ops/step of chain 0)")
    # ---- B6 (direct field), PDA (d) with cavity bias and the TMMC tilt
    params, state, cfg, thermo = _xt_system(device, seed + 1, polar=True)
    cfg_eff = mk.pda_effective_cfg(cfg, params)
    tables = metropolis.uvt_fused_tables(params, cfg_eff)
    consts = metropolis._uvt_chunk_consts(state.pos, state.box, params,
                                          thermo, cfg_eff, tables[5],
                                          tables[6])
    cls_eff = dataclasses.replace(cfg_eff, cavity_bias=False, tmmc=False,
                                  tmmc_bias=False)
    Kp = mk.PDA_SEG

    def pda_args(c, u):
        return metropolis.pda_launch_args(state, params, c, thermo, u,
                                          tables, consts)

    def table(x):
        return torch.as_tensor(x, dtype=f32, device=device)

    us = {}
    for mt, lane8 in ((0, 0.9), (1, 0.1), (2, 0.4)):
        x = rng.random((Kp, 16))
        x[0, 4], x[0, 8] = 1e-30, lane8
        us[f"step 0 survives ({'disp ins del'.split()[mt]})"] = table(x)
    us["natural"] = table(rng.random((Kp, 16)))

    def launch_xt(u):
        a, kw = pda_args(cfg_eff, u)
        return mk.run_steps_uvt_pda(*a, **kw)

    us["survivor-free"] = _pda_survivor_free(
        launch_xt, table(rng.random((Kp, 16))), rng)
    rep = {"max_abs_err": 0.0}
    hits = 0
    for name, u in us.items():
        a, kw = pda_args(cfg_eff, u)
        trace = []
        p = mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace).cpu().numpy()
        k = mk.run_steps_uvt_pda(*a, **kw, cluster=16).cpu().numpy()
        rss = np.zeros(8)
        if trace[-1].get("rss"):
            rss[[0, 1, 2, 6]] = trace[-1]["rss"]
        want = np.concatenate([p[1, :6], p[0, 9:11]])
        tol = 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss
        d_vals = np.abs(np.concatenate([k[1, :6], k[0, 9:11]]) - want)
        d_rows = float(np.abs(k[2:5] - p[2:5]).max())
        log(f"B6 XT f32 {name} G=16: n_done {k[0, 0]:g} hit {k[0, 1]:g} "
            f"mtype {k[0, 2]:g} (plain: {p[0, 0]:g} {p[0, 1]:g} "
            f"{p[0, 2]:g}); |d| deltas/d*/lnb {d_vals.max():.3e} (worst "
            f"|d|/tol {float(np.max(d_vals / tol)):.3f}), rows {d_rows:.3e}")
        if not (np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                               p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
                and np.all(d_vals <= tol) and d_rows <= 1e-4):
            raise AssertionError(f"B6 XT {name} disagrees with its plain "
                                 "version")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d_vals.max()),
                                 d_rows)
        hits += int(k[0, 1])
    if hits < 3:
        raise AssertionError(f"B6 XT: only {hits} survivors")
    u = us["survivor-free"]
    a, kw = pda_args(cfg_eff, u)
    trace = []
    mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
    ops = _pda_ops(trace, "direct", kw["kvecs"].shape[0])
    bound, by = _bound_ms(ops, _nbytes(*a, *kw.values()) + 8 * 16 * 8)
    ac, kwc = pda_args(cls_eff, u)
    for tag, (aa, kk) in (("classical", (ac, kwc)), ("xt", (a, kw))):
        ms = time_calls(lambda: mk.run_steps_uvt_pda(*aa, **kk, cluster=16),
                        device) / Kp
        dms = time_device(lambda: mk.run_steps_uvt_pda(*aa, **kk,
                                                       cluster=16),
                          device, n=20) / Kp
        rep.update({f"{tag}_ms": ms, f"{tag}_device_ms": dms})
        log(f"B6 f32 {tag}, survivor-free table, G=16: {ms * 1e3:.2f} "
            f"us/step per call, {dms * 1e3:.2f} on the card alone")
    pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw), device,
                     n=3) / Kp
    rep.update(ms=rep.pop("xt_ms"), device_ms=rep.pop("xt_device_ms"),
               plain_ms=pms, bound_ms=bound / Kp, bound_by=by,
               cluster="G=16")
    reps["run_steps_uvt_pda_xt"] = rep
    log("xt kernels: " + json.dumps(reps))
    return reps


# the cavity / TMMC decks: (label, system, deck lines, numsteps, route line
# or None for the scan path, the kernel the route launches); DECK's corrtime
# 1000 (100 on the scan deck, POLAR_CORRTIME on the polar one)
XT_DECKS = (
    ("cav_scan", "mof", "cavity_bias on\ncorrtime 100\n", 300, None, None),
    ("cav_bias_fused", "mof", "cavity_bias on\ntmmc_bias on\nfused_mc on\n",
     5000, "single-chain fused µVT kernel", "run_steps_uvt"),
    ("tmmc_c32", "mof", "tmmc on\nfused_mc on\nchains 32\n", 5000,
     "chain-interleaved multi-chain kernel (C=32)", "run_steps_uvt"),
    ("pda_tmmc_cav", "polar", "polar_delayed on\nfused_mc on\ntmmc on\n"
     "cavity_bias on\n", 100, "polar delayed-acceptance stage-1 kernel",
     "run_steps_uvt_pda"))


def _tmmc_attempts(label, text):
    """(collected, insert + delete attempts) from a run's TMMC log line;
    raises unless they are equal."""
    line = [ln for ln in text.splitlines() if "attempts collected" in ln]
    if not line:
        raise AssertionError(f"{label}: no TMMC matrix written")
    w = line[-1].split()
    got = (int(w[w.index("attempts") - 1]), int(w[w.index("insert") - 1]))
    if got[0] != got[1] or got[0] == 0:
        raise AssertionError(f"{label}: TMMC collected {got[0]} of "
                             f"{got[1]} insert + delete attempts")
    return got[0]


def phase_xt_decks(device, example_steps=2000):
    """The cavity / TMMC decks (XT_DECKS) through run.run: DECK with
    ``cavity_bias on`` on the scan path (300 steps, corrtime 100), with
    cavity_bias and tmmc_bias on fused µVT (5,000), with tmmc and
    ``chains 32`` (5,000), and PDA (d) with tmmc and cavity_bias (100),
    the default grid (cavity_grid 10, cavity_radius 2.5).  Each deck logs
    its route and no WARNING, launches its kernel (B1 once per corrtime),
    reports n_open at each refresh (no grid may be empty) and, under tmmc,
    a matrix holding every insert and delete attempt; after a further
    chunk the carried energy matches a fresh recompute.  Then
    examples/h2_polar_tmmc.inp through ``python -m mpmc_tpu_torch``'s main
    (``example_steps`` of its 6,000 steps) and ``python -m
    mpmc_tpu_torch.analyze tmmc`` on its matrix.  Returns ({deck:
    launches}, {deck: report})."""
    import contextlib
    from mpmc_tpu_torch import __main__ as port_main
    from mpmc_tpu_torch import analyze
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.state import slice_chain
    launches, reps = {}, {}
    for i, (label, kind, extra, numsteps, route, kernel) in enumerate(
            XT_DECKS):
        su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                       kind=kind, verbose=False)
        if "WARNING" in text or (route and f"fused_mc: {route}" not in text):
            raise AssertionError(f"{label}: not the route {route!r}")
        if kernel and not ln[kernel]:
            raise AssertionError(f"{label}: {kernel} not launched: {ln}")
        corr = su.cfg.corrtime
        if kernel == "run_steps_uvt" and ln[kernel] != numsteps // corr:
            raise AssertionError(f"{label}: B1 launched {ln[kernel]} times "
                                 f"for {numsteps // corr} blocks")
        if route is None and not ln["mol_pair"]:
            raise AssertionError(f"{label}: the scan path launched no B4")
        n_open = avgs.samples.get("cavity_open", [])
        if su.cfg.cavity_bias and (not n_open or min(n_open) < 1):
            raise AssertionError(f"{label}: n_open per refresh {n_open}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        rep = {"steps_per_sec": rate, "n_open": n_open,
               "N": avgs.mean("N"), "acc_insert": avgs.mean("acc_insert"),
               "acc_delete": avgs.mean("acc_delete"),
               "kernel_launches": ln.get(kernel),
               "b4_launches": ln["mol_pair"] + ln["mol_pair_chains"],
               "b1_launches": ln["run_steps_uvt"],
               "b6_launches": ln["run_steps_uvt_pda"]}
        if su.cfg.tmmc:
            rep["tmmc_attempts"] = _tmmc_attempts(label, text)
        g = torch.Generator(device=device).manual_seed(71 + i)
        params, cfg, thermo = su.params, su.cfg, su.thermo
        if su.states is not None:
            sts, _ = metropolis.run_chunk_fused_uvt_multi(
                su.states, params, cfg, thermo, 1000, generator=g)
            for c in (0, sts.pos.shape[0] - 1):
                _check_bookkeeping(f"{label} chain {c}, 1000 steps",
                                   slice_chain(sts, c), su)
        else:
            if kernel == "run_steps_uvt":
                st, _ = metropolis.run_chunk_fused_uvt(
                    su.state, params, cfg, thermo, 1000, generator=g)
            elif kernel == "run_steps_uvt_pda":
                st, _ = metropolis.run_chunk_fused_uvt_polar_da(
                    su.state, params, cfg, thermo, 100, generator=g,
                    tables=metropolis.uvt_fused_tables(
                        params, mk.pda_effective_cfg(cfg, params)))
            else:
                st, _ = metropolis.run_chunk(su.state, params, cfg, thermo,
                                             100, generator=g)
            _check_bookkeeping(f"{label}, a further chunk", st, su,
                               polar=cfg.polarization)
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    # examples/h2_polar_tmmc.inp through the command-line main, then the
    # analysis of its matrix
    deck = open(os.path.join(REPO, "examples", "h2_polar_tmmc.inp")).read()
    deck = deck.replace("numsteps         6000", f"numsteps {example_steps}")
    deck = deck.replace("examples/framework_h2_polar.pqr", os.path.join(
        REPO, "examples", "framework_h2_polar.pqr"))
    if f"numsteps {example_steps}" not in deck:
        raise AssertionError("h2_polar_tmmc.inp: numsteps not found")
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open("h2_polar_tmmc.inp", "w") as f:
                f.write(deck)
            job = input_script.parse_file("h2_polar_tmmc.inp")
            out, iso = io.StringIO(), io.StringIO()
            _reset_counts()
            with contextlib.redirect_stdout(out):
                port_main.main(["h2_polar_tmmc.inp"])
            torch.cuda.synchronize(device)
            ln = _launch_counts()
            with contextlib.redirect_stdout(iso):
                analyze.main(["tmmc", "tmmc_polar.json", "--out",
                              "iso.csv"])
            rows = open("iso.csv").read().strip().splitlines()
            c, _ = analyze.tmmc_load(["tmmc_polar.json"])
        finally:
            os.chdir(old)
    text = out.getvalue()
    log("\n".join(text.splitlines()[:6] + text.splitlines()[-4:]))
    log(iso.getvalue().rstrip())
    if not (job.cfg.tmmc and "polar delayed-acceptance stage-1 kernel" in
            text and ln["run_steps_uvt_pda"] > 0):
        raise AssertionError(f"h2_polar_tmmc.inp: not B6's route ({ln})")
    n_att = _tmmc_attempts("h2_polar_tmmc.inp", text)
    means = [float(r.split(",")[1]) for r in rows[1:]]
    if not (len(rows) == 22 and np.all(np.isfinite(means))
            and int(c[:, 0].sum() + c[:, 2].sum()) == n_att):
        raise AssertionError("analyze tmmc: bad isotherm or matrix")
    rate = float(text.split("steps/sec:")[1].split()[0])
    log(f"h2_polar_tmmc.inp: {example_steps} steps, {rate:.2f} steps/s, B6 "
        f"launches {ln['run_steps_uvt_pda']}, TMMC attempts {n_att}; "
        f"analyze tmmc: <N> {means[0]:.4f} .. {means[-1]:.4f} over 0.1-10 f")
    launches["example_tmmc"] = ln
    reps["example_tmmc"] = {"steps_per_sec": rate, "tmmc_attempts": n_att,
                            "kernel_launches": ln["run_steps_uvt_pda"]}
    return launches, reps


# ---------------------------------------------------------------------------
# quantum rotation: the rotor tables (B4 at position stride 0) and the
# spinflip move in B1, B3 and B6
# ---------------------------------------------------------------------------

# the spinflip probability of the kernel phase and the decks, and the
# float32 rule of a rotor table against CPU float64: a rotor's Hamiltonian
# moves by dH = sum_g w_g dV_g |Y(g)><Y(g)|, whose norm is at most max_g
# |dV_g| (the quadrature integrates |Y|^2 to 1), so by Weyl's inequality
# each level - and each free energy, a smooth mean of levels - moves by
# at most the grid's largest |dV| (card float32 against CPU float64),
# plus 1e-4 K for the float32 table; and |dV| itself stays within
# F32_V_ABS K, the float32 rounding of Coulomb pair terms of up to 10^4 K
# (eps32 10^4 K ~ 1e-3 K each, a random walk over the near pairs)
P_SPIN = 0.1
F32_V_ABS = 0.1


def _rotor_table(system, device, times=None):
    """(state with the initial spins and the rotor table at its positions,
    eigensolves) of ``system`` on the card (run.qrot_init's work, with
    ``times`` as qrot.eigen_tables)."""
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import qrot
    params, state, cfg, thermo = system
    eigs = qrot.eigen_tables(state.pos, state.box, state.atom_alive(params),
                             state.mol_alive, params, cfg, thermo,
                             [systems.h2_bss3()], times=times)
    table = qrot.table_from_eigs(eigs, params.n_mols_max,
                                 float(thermo.temperature))
    spins = qrot.initial_spins(cfg.seed, None, params.n_mols_max)
    return state.replace(
        spin=torch.as_tensor(spins, device=device),
        rot_f=torch.as_tensor(table, dtype=cfg.tdtype, device=device)), eigs


def _with_sf(system):
    """``system`` with quantum_rotation on and spinflip_probability
    P_SPIN."""
    params, state, cfg, thermo = system
    return (params, state, dataclasses.replace(cfg, quantum_rotation=True),
            thermo.replace(spinflip_probability=torch.tensor(
                P_SPIN, dtype=cfg.tdtype, device=state.pos.device)))


# B4's rotor-grid launch of 64 rotors (the launch a refresh once made
# four of), timed beside the refresh's one launch
GRID_ROTORS = 64


def _grid_rotors_past(cfg, n, G):
    """The fewest rotors whose G orientations reach past B4's grid_min on
    this card: a stride-0 launch of that many takes B4's regime 1."""
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    return pk.mol_pair_plan(n, 1, True, torch.float32,
                            cfg)["grid_min"] // G + 1


def phase_qrot_table(device, n_check=4):
    """The rotor table of DECK's system (256 H2 rotors, float32 on the
    card): B4 at position stride 0 over the 512 orientations of the
    fewest rotors past grid_min (regime 1) against its plain version (the
    F32 rule of phase_kernels) and bit for bit the same launch over an
    expanded, copied pos (regime 2); the refresh's one launch over every
    rotor bit for bit its GRID_ROTORS-rotor launches and the expanded
    launch on its first and last 8,192 chains; then one full refresh,
    timed (B4's potentials and the host eigensolves apart, the card
    synchronized, one B4 launch), repeated for the median; the F_para and
    F_ortho of n_check rotors against the CPU float64 tables of the same
    positions, within the rotor's max |dV| + 1e-4 K (dV: its grid
    potentials on the card against CPU float64, each within F32_V_ABS).
    B4's time per refresh launch and per GRID_ROTORS-rotor launch (per
    call, on the card alone), its plain version's, the bounds and the
    launch shapes.  Returns (report of mol_pair_grid, the table state)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs, qrot
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    params, state, cfg, thermo = bench_system("float32", device)
    state = metropolis.initialize(state, params, cfg, thermo)
    system = (params, state, cfg, thermo)
    sp = [systems.h2_bss3()]
    mols, _ = qrot.rotor_slots(state.mol_alive, params, sp)
    log(f"rotor table: {len(mols)} rotors of the bench system")
    axes = torch.as_tensor(qrot._basis(4, qrot.N_THETA, qrot.N_PHI)[3],
                           dtype=torch.float32, device=device)
    G = axes.shape[0]
    n = state.pos.shape[0]
    scal = pairs.pair_scalars(state.box, cfg)
    alive = state.atom_alive(params)
    common = (params.charge, params.eps, params.sig, params.mol_id32)

    def grid_args(ms):
        mt = torch.as_tensor(ms, device=device)
        rows = qrot.grid_rows(state.pos, params, mt, axes)
        return (params.mol_atoms, params.mol_natoms,
                mt.repeat_interleave(G),
                rows.reshape(-1, rows.shape[2], 3).contiguous(), scal, cfg)

    def expanded(tail, sl):
        k = tail[2][sl].shape[0]
        return pk.mol_pair_chains(
            state.pos.expand(k, -1, -1).contiguous(), *common,
            alive.expand(k, -1).contiguous(), *tail[:2], tail[2][sl],
            tail[3][sl], scal, cfg)

    n_grid = _grid_rotors_past(cfg, n, G)
    tail = grid_args(mols[:n_grid])
    C = tail[2].shape[0]
    plan = pk.mol_pair_plan(n, C, True, torch.float32, cfg)
    k = pk.mol_pair_chains(state.pos, *common, alive, *tail)
    p = pk.mol_pair_chains_plain(state.pos, *common, alive, *tail)
    wide = expanded(tail, slice(None))
    torch.cuda.synchronize(device)
    p64 = pk.mol_pair_chains_plain(
        state.pos.double(), *(x.double() for x in common[:3]), common[3],
        alive, *tail[:3], tail[3].double(), scal.double(), cfg)
    kd, pd = k.double().cpu().numpy(), p.double().cpu().numpy()
    ref = p64.cpu().numpy()
    err = np.abs(kd - pd)
    tol = _tol(torch.float32, ref, pd)
    log(f"B4 stride 0, {n_grid} rotors x {G} orientations (C={C}, launch "
        f"shape {plan}): |d| {err[:, :3].max():.3e} (worst |d|/tol "
        f"{float(np.max(err / tol)):.3f}); equal to the expanded-pos launch "
        f"(regime 2): {torch.equal(k, wide)}")
    if not (plan["regime"] == 1 and np.all(err <= tol)
            and torch.equal(k, wide)):
        raise AssertionError("B4 at position stride 0 disagrees with its "
                             "plain version or the expanded launch")
    # the refresh's one launch over every rotor, and a 64-rotor launch
    full = grid_args(mols)
    Cf = full[2].shape[0]
    plan_f = pk.mol_pair_plan(n, Cf, True, torch.float32, cfg)

    def launch():
        return pk.mol_pair_chains(state.pos, *common, alive, *full)

    k_all = launch()
    parts = torch.cat([pk.mol_pair_chains(
        state.pos, *common, alive, *grid_args(mols[r0:r0 + GRID_ROTORS]))
        for r0 in range(0, len(mols), GRID_ROTORS)])
    step = min(8192, Cf)
    ends = all(torch.equal(k_all[sl], expanded(full, sl))
               for sl in (slice(0, step), slice(Cf - step, Cf)))
    log(f"B4 refresh launch, {len(mols)} rotors (C={Cf}, launch shape "
        f"{plan_f}): equal to its {GRID_ROTORS}-rotor launches "
        f"{torch.equal(k_all, parts)}, to the expanded launch on its first "
        f"and last {step} chains {ends}")
    if not (torch.equal(k_all, parts) and ends
            and torch.isfinite(k_all[:, :3]).all()):
        raise AssertionError("B4's one launch over every rotor disagrees "
                             "with its 64-rotor launches or the expanded "
                             "launch")
    ms = time_calls(launch, device, n=5)
    dms = time_device(launch, device, n=5)
    pms = time_calls(lambda: pk.mol_pair_chains_plain(
        state.pos, *common, alive, *full), device, n=1)
    n_cols = int(alive.sum())
    pairs_n = Cf * 3 * n_cols
    bound, by = _bound_ms(pairs_n * OPS_PAIR_B2B4,
                          _nbytes(state.pos, *common, alive, *full[:5])
                          + Cf * 4 * 4)
    part = grid_args(mols[:GRID_ROTORS])
    C64 = part[2].shape[0]

    def launch64():
        return pk.mol_pair_chains(state.pos, *common, alive, *part)

    ms64 = time_calls(launch64, device)
    dms64 = time_device(launch64, device, n=10)
    bound64, by64 = _bound_ms(C64 * 3 * n_cols * OPS_PAIR_B2B4,
                              _nbytes(state.pos, *common, alive, *part[:5])
                              + C64 * 4 * 4)
    log(f"B4 stride 0, the refresh's launch of {len(mols)} rotors "
        f"(C={Cf}): {ms:.3f} ms per call, {dms:.3f} on the card alone, "
        f"plain {pms:.1f} ms, bound {bound:.4f} ms ({by}; {pairs_n:.3e} "
        f"pairs); a {GRID_ROTORS}-rotor launch (C={C64}): {ms64:.3f} ms per"
        f" call, {dms64:.3f} on the card alone, bound {bound64:.4f} ms")
    for key, v in _b4_ptxas("pair_kernel").items():
        log(f"    B4 {key} ptxas: {v}")
    # the refresh, timed, and eight rotors against CPU float64
    runs = []
    for _ in range(3):
        times = {}
        before = pk.mol_pair_chains.shared_launches
        t0 = time.perf_counter()
        st, eigs = _rotor_table(system, device, times)
        runs.append(((time.perf_counter() - t0) * 1e3, times,
                     pk.mol_pair_chains.shared_launches - before))
    total = statistics.median(r[0] for r in runs)
    b4 = statistics.median(r[1]["b4_s"] * 1e3 for r in runs)
    eig = statistics.median(r[1]["eigh_s"] * 1e3 for r in runs)
    per_refresh = {r[2] for r in runs}
    log(f"rotor table refresh ({len(mols)} rotors): {total:.1f} ms (B4 grid "
        f"{b4:.1f} ms in {per_refresh} launches, eigensolves {eig:.1f} ms), "
        "median of 3")
    if per_refresh != {1}:
        raise AssertionError(f"a refresh made {per_refresh} B4 launches, "
                             "not one")
    pick = mols[::max(len(mols) // n_check, 1)][:n_check]
    p64, _, c64, _ = bench_system("float64", "cpu")
    pos64, box64 = state.pos.double().cpu(), state.box.double().cpu()
    alive64 = state.atom_alive(params).cpu()
    t64 = thermo.temperature.double().cpu()
    ax64 = axes.double().cpu()
    v64 = np.concatenate([qrot.potentials_on_grid(
        pos64, box64, alive64, p64, c64, t64, [m], ax64).numpy()
        for m in pick])
    ev64, lo64 = qrot.levels_from_potentials(
        v64, [qrot.rotational_constant(sp[0])] * len(pick), 4)
    v32 = qrot.potentials_on_grid(state.pos, state.box, alive, params, cfg,
                                  thermo.temperature, pick, axes
                                  ).double().cpu().numpy()
    worst, worst_v = 0.0, 0.0
    for i, m in enumerate(pick):
        f64 = qrot.symmetry_free_energies(ev64[i], lo64[i],
                                          float(thermo.temperature))
        f32 = st.rot_f[m].double().cpu().numpy()
        d_v = float(np.abs(v32[i] - v64[i]).max())
        tol_f = d_v + 1e-4
        d = float(np.abs(f32 - np.asarray(f64)).max())
        worst, worst_v = max(worst, d / tol_f), max(worst_v, d_v)
        if not (np.array_equal(eigs[m][1], lo64[i]) and d <= tol_f
                and d_v <= F32_V_ABS):
            raise AssertionError(f"rotor {m}: F {f32} against CPU float64 "
                                 f"{f64} (tol {tol_f:.3e}, max |dV| "
                                 f"{d_v:.3e}), labels equal "
                                 f"{np.array_equal(eigs[m][1], lo64[i])}")
    gap = st.rot_f[mols, 1] - st.rot_f[mols, 0]
    log(f"rotor table: {len(pick)} rotors' F_para, F_ortho within the f32 "
        f"rule of CPU float64 (worst |dF|/(max |dV| + 1e-4 K) {worst:.3f};"
        f" max |dV| {worst_v:.3e} K, max |V| {float(np.abs(v64).max()):.1f}"
        " K); "
        f"ortho - para {float(gap.min()):.2f} .. {float(gap.max()):.2f} K")
    rep = {"max_abs_err": float(err[:, :3].max()), "ms": ms, "device_ms": dms,
           "plain_ms": pms, "bound_ms": bound, "bound_by": by,
           "per": f"the refresh's launch of {len(mols)} rotors x {G} "
                  "orientations",
           "chains": Cf, "plan": plan_f, "launches_per_refresh": 1,
           "per64": {"ms": ms64, "device_ms": dms64, "bound_ms": bound64,
                     "bound_by": by64, "chains": C64},
           "refresh_ms": total, "refresh_b4_ms": b4,
           "refresh_eigh_ms": eig, "table_max_dv": worst_v,
           "ptxas": _b4_ptxas("pair_kernel")}
    return rep, st


def _spin_counts(k_spin, p_spin, label):
    """Raise unless the kernel's and the plain version's spins agree."""
    if not torch.equal(k_spin, p_spin):
        raise AssertionError(f"{label}: spins differ from the plain version")


def _uvt_sf_check(label, system, u, device, cluster=None):
    """B1's XT instance with spinflip against its plain version on ``u``
    [C, K, 16] (stacked copies of the state, its spins and table): equal
    move counts (spinflip's too), slot aliveness and spins, under tmmc the
    TMMC attempts; sums within _uvt_fh_check's float32 rule (with
    _rss_tol for rd and es), positions within 1e-4 A.  Returns (kernel
    outputs, plain trace, max |d|, (args, kw))."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C, K = u.shape[0], u.shape[1]
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    trace = []
    p = mk.run_steps_uvt_plain(*args, **kw, trace=trace)
    kw_k = dict(kw)
    if "tmmc_out" in kw:
        kw_k["tmmc_out"] = torch.zeros_like(kw["tmmc_out"])
    k = mk.run_steps_uvt(*args, **kw_k, cluster=cluster)
    torch.cuda.synchronize(device)
    ps, ks = p[2].cpu().numpy(), k[2].cpu().numpy()
    log(f"B1 {label} C={C} K={K} G={mk.run_steps_uvt.last_cluster}: kernel "
        f"counts {ks[:, 6:14].sum(0).tolist()} plain "
        f"{ps[:, 6:14].sum(0).tolist()}")
    if not (np.array_equal(ks[:, 6:14], ps[:, 6:14])
            and torch.equal(k[1], p[1])):
        raise AssertionError(f"B1 {label}: decisions differ from the "
                             "plain version")
    _spin_counts(k[5], p[5], f"B1 {label}")
    if "tmmc_out" in kw:
        tk_, tp = kw_k["tmmc_out"].cpu().numpy(), kw["tmmc_out"].cpu().numpy()
        if not np.array_equal(tk_[..., [0, 2]], tp[..., [0, 2]]):
            raise AssertionError(f"B1 {label}: TMMC attempts differ")
    if ps[:, 13].sum() < 1 or ps[:, 12].sum() < 1:
        raise AssertionError(f"B1 {label}: no spinflip attempted/accepted")
    n_acc = ps[:, 6:9].sum(1, keepdims=True)
    tol = 2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0)
    tol[:, :2] += _rss_tol(trace)
    d_sums = np.abs(ks[:, :6] - ps[:, :6])
    d_pos = float((k[0] - p[0]).abs().max())
    worst = np.unravel_index(np.argmax(d_sums / tol), d_sums.shape)
    log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
        f"{tol.max():.3e}; worst |d|/tol {float(np.max(d_sums / tol)):.3f} "
        f"at chain {worst[0]} term {worst[1]}), pos {d_pos:.3e} A; spins "
        f"equal, {int((k[5] != kw['spin']).sum())} flipped")
    if not (np.all(d_sums <= tol) and d_pos <= 1e-4):
        raise AssertionError(f"B1 {label} disagrees with its plain version")
    return k, trace, max(float(d_sums.max()), d_pos), (args, kw_k)


def _nvt_sf_check(label, system, u, device):
    """B3's SF instance against its plain version on ``u`` [C, K, 16]:
    equal accept and spinflip counts and spins, sums within
    phase_nvt_kernel's float32 rule with _rss_tol for rd and es,
    positions within 1e-4 A.  Returns
    (kernel outputs, plain trace, max |d|, (args, kw))."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C, K = u.shape[0], u.shape[1]
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u,
        metropolis.nvt_fused_tables(params, state.mol_alive))
    trace = []
    p = mk.run_steps_plain(*args, **kw, trace=trace)
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(device)
    ps, ks = p[1].cpu().numpy(), k[1].cpu().numpy()
    log(f"B3 {label} C={C} K={K} G={mk.run_steps.last_cluster}: kernel "
        f"accepts/spin acc/spin att {ks[:, 3:6].sum(0).tolist()} plain "
        f"{ps[:, 3:6].sum(0).tolist()}")
    if not np.array_equal(ks[:, 3:6], ps[:, 3:6]):
        raise AssertionError(f"B3 {label}: decisions differ from the plain "
                             "version")
    _spin_counts(k[4], p[4], f"B3 {label}")
    if ps[:, 5].sum() < 1 or ps[:, 4].sum() < 1:
        raise AssertionError(f"B3 {label}: no spinflip attempted/accepted")
    tol = 2e-5 * np.abs(ps[:, :3]) + 2e-3 * np.sqrt(ps[:, 3:4] + 1.0)
    tol[:, :2] += _rss_tol(trace)
    d_sums = np.abs(ks[:, :3] - ps[:, :3])
    d_pos = float((k[0] - p[0]).abs().max())
    log(f"    |d| sums {d_sums.max():.3e} (tol {tol.min():.3e}.."
        f"{tol.max():.3e}; worst |d|/tol "
        f"{float(np.max(d_sums / tol)):.3f}), pos {d_pos:.3e} A; spins "
        "equal")
    if not (np.all(d_sums <= tol) and d_pos <= 1e-4):
        raise AssertionError(f"B3 {label} disagrees with its plain version")
    return k, trace, max(float(d_sums.max()), d_pos), (args, kw)


def phase_sf_kernels(device, K=128, K32=48, seed=2028, k_time=1000):
    """B1, B3 and B6 with spinflip (p_spin P_SPIN, each state's real rotor
    table and the initial spins) against their plain versions, float32,
    on numpy-seeded tables: B1 (XT) on the 10.8k bench system at C = 1 (G
    = 16) and at C = 32 with cavity bias, TMMC and tmmc_bias too (XT_CFG);
    B3 (SF) on the 10.0k MOF + H2 NVT system at C = 1 and 16; B6 (XT) on
    PDA (d) with a forced spinflip survivor, forced survivors of the other
    move types, natural coins and a survivor-free table.  Equal decisions
    and spins; sums, positions and B6's records within their phases'
    rules.  Times per step on the card alone (and per call) beside the
    instance without spinflip in the same call, the plain version's and
    the bound.  Returns {entry: report}."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    reps = {}
    # ---- B1 at C = 1 (spinflip) and C = 32 (spinflip + XT_CFG)
    params, state, cfg, thermo = bench_system("float32", device)
    base = (params, metropolis.initialize(state, params, cfg, thermo), cfg,
            thermo)
    st, _ = _rotor_table(base, device)
    sys1 = _with_sf((base[0], st, base[2], base[3]))
    xt = _xt_system(device, seed)
    st_x, _ = _rotor_table(xt, device)
    sys32 = _with_sf((xt[0], st_x, xt[2], xt[3]))
    for C, Kc, G, system, name in ((1, K, 16, sys1, "run_steps_uvt_sf"),
                                   (32, K32, None, sys32,
                                    "run_steps_uvt_sf_c32")):
        params, state, cfg, thermo = system
        u = torch.as_tensor(rng.random((C, Kc, 16)), dtype=f32,
                            device=device)
        k, trace, err, (a1, kw1) = _uvt_sf_check(
            f"spinflip{'' if C == 1 else ' + XT'} f32", system, u, device,
            cluster=G)
        pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1), device,
                         n=1) / Kc
        ops = _fused_ops(trace, cfg, kw1["kvecs"].shape[0])
        n_io = (_nbytes(*a1[:25], *kw1.values())
                + _nbytes(k[0], a1[1], *k[1:]))
        bound, by = _bound_ms(ops, n_io)
        ut = torch.as_tensor(rng.random((C, k_time, 16)), dtype=f32,
                             device=device)
        no_sf = dataclasses.replace(cfg, quantum_rotation=False)
        tables = metropolis.uvt_fused_tables(params, cfg)
        times = {}
        for tag, c in (("without", no_sf), ("sf", cfg)):
            at, kwt = metropolis.fused_uvt_launch_args(
                multichain.stack_states(state, C), params, c, thermo, ut,
                tables)

            def launch():
                if "tmmc_out" in kwt:
                    kwt["tmmc_out"].zero_()
                return mk.run_steps_uvt(*at, **kwt, cluster=G)

            times[tag] = (_time_steps(launch, device, k_time),
                          time_device(launch, device, n=5) / k_time)
            log(f"B1 f32 {tag} spinflip C={C} G="
                f"{mk.run_steps_uvt.last_cluster}: {times[tag][0] * 1e3:.3f}"
                f" us per step ({k_time}-step launches; "
                f"{times[tag][1] * 1e3:.3f} back to back)")
        reps[name] = {
            "max_abs_err": err, "ms": times["sf"][0],
            "device_ms": times["sf"][1], "plain_ms": pms,
            "bound_ms": bound / Kc, "bound_by": by,
            "without_ms": times["without"][0],
            "without_device_ms": times["without"][1],
            "cluster": f"G={mk.run_steps_uvt.last_cluster} (C={C})",
            "per": "step" if C == 1 else f"step of {C} chains"}
    # ---- B3 at C = 1 and 16 on the MOF + H2 NVT system
    nsys = nvt_system("mof", "float32", device)
    st_n, _ = _rotor_table(nsys, device)
    nsys = _with_sf((nsys[0], st_n, nsys[2], nsys[3]))
    params, state, cfg, thermo = nsys
    rep3 = {}
    for C, Kc in ((1, K), (16, K32)):
        u = torch.as_tensor(rng.random((C, Kc, 16)), dtype=f32,
                            device=device)
        k, trace, err, (a1, kw1) = _nvt_sf_check("spinflip f32", nsys, u,
                                                 device)
        pms = time_calls(lambda: mk.run_steps_plain(*a1, **kw1), device,
                         n=1) / Kc
        ops = _fused_ops(trace, cfg, kw1["kvecs"].shape[0])
        bound, by = _bound_ms(ops, _nbytes(*a1[:16], *kw1.values())
                              + _nbytes(*k))
        ut = torch.as_tensor(rng.random((C, k_time, 16)), dtype=f32,
                             device=device)
        tables = metropolis.nvt_fused_tables(params, state.mol_alive)
        times = {}
        for tag, c in (("without", dataclasses.replace(
                cfg, quantum_rotation=False)), ("sf", cfg)):
            at, kwt = metropolis.fused_nvt_launch_args(
                multichain.stack_states(state, C), params, c, thermo, ut,
                tables)
            times[tag] = (
                _time_steps(lambda: mk.run_steps(*at, **kwt), device,
                            k_time),
                time_device(lambda: mk.run_steps(*at, **kwt), device,
                            n=5) / k_time)
            log(f"B3 f32 {tag} spinflip C={C} G={mk.run_steps.last_cluster}"
                f": {times[tag][0] * 1e3:.3f} us per step "
                f"({times[tag][1] * 1e3:.3f} back to back)")
        rep3[C] = {"max_abs_err": err, "ms": times["sf"][0],
                   "device_ms": times["sf"][1], "plain_ms": pms,
                   "bound_ms": bound / Kc, "bound_by": by,
                   "without_ms": times["without"][0],
                   "without_device_ms": times["without"][1],
                   "cluster": f"G={mk.run_steps.last_cluster} (C={C})",
                   "per": "step" if C == 1 else f"step of {C} chains"}
    reps["run_steps_sf"] = dict(rep3[1], c16=rep3[16])
    # ---- B6 on PDA (d) with spinflip
    psys = polar_system("float32", device)
    cfg_p = dataclasses.replace(psys[2], polar_delayed=True, fused_mc=True)
    st_p, _ = _rotor_table((psys[0], psys[1], cfg_p, psys[3]), device)
    params, state, cfg, thermo = _with_sf((psys[0], st_p, cfg_p, psys[3]))
    cfg_eff = mk.pda_effective_cfg(cfg, params)
    tables = metropolis.uvt_fused_tables(params, cfg_eff)
    consts = metropolis._uvt_chunk_consts(state.pos, state.box, params,
                                          thermo, cfg_eff, tables[5],
                                          tables[6])
    Kp = mk.PDA_SEG

    def pda_args(c, u):
        return metropolis.pda_launch_args(state, params, c, thermo, u,
                                          tables, consts)

    def table(x):
        return torch.as_tensor(x, dtype=f32, device=device)

    us = {}
    for name, l11, lane8 in (("spinflip", 1e-30, 0.9), ("disp", 0.9, 0.9),
                             ("ins", 0.9, 0.1), ("del", 0.9, 0.4)):
        x = rng.random((Kp, 16))
        x[0, 4], x[0, 8], x[0, 11] = 1e-30, lane8, l11
        us[f"step 0 survives ({name})"] = table(x)
    for i in range(3):
        us[f"natural {i}"] = table(rng.random((Kp, 16)))

    def launch_sf(u):
        a, kw = pda_args(cfg_eff, u)
        return mk.run_steps_uvt_pda(*a, **kw)

    us["survivor-free"] = _pda_survivor_free(
        launch_sf, table(rng.random((Kp, 16))), rng)
    rep = {"max_abs_err": 0.0}
    spins = 0
    for name, u in us.items():
        a, kw = pda_args(cfg_eff, u)
        trace = []
        p = mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace).cpu().numpy()
        k = mk.run_steps_uvt_pda(*a, **kw, cluster=16).cpu().numpy()
        rss = np.zeros(8)
        if trace[-1].get("rss"):
            rss[[0, 1, 2, 6]] = trace[-1]["rss"]
        want = np.concatenate([p[1, :6], p[0, 9:11]])
        tol = 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss
        d_vals = np.abs(np.concatenate([k[1, :6], k[0, 9:11]]) - want)
        d_rows = float(np.abs(k[2:5] - p[2:5]).max())
        log(f"B6 spinflip f32 {name} G=16: n_done {k[0, 0]:g} hit "
            f"{k[0, 1]:g} mtype {k[0, 2]:g} spin att {k[0, 11]:g} (plain: "
            f"{p[0, 0]:g} {p[0, 1]:g} {p[0, 2]:g} {p[0, 11]:g}); |d| "
            f"{d_vals.max():.3e}, rows {d_rows:.3e}")
        if not (np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8, 11]],
                               p[0, [0, 1, 2, 3, 4, 6, 7, 8, 11]])
                and np.all(d_vals <= tol) and d_rows <= 1e-4):
            raise AssertionError(f"B6 spinflip {name} disagrees with its "
                                 "plain version")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d_vals.max()),
                                 d_rows)
        spins += int(k[0, 1] > 0.5 and k[0, 2] == 3)
    if spins < 1:
        raise AssertionError("B6 spinflip: no spinflip survivor")
    u = us["survivor-free"]
    a, kw = pda_args(cfg_eff, u)
    trace = []
    mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
    ops = _pda_ops(trace, "direct", kw["kvecs"].shape[0])
    bound, by = _bound_ms(ops, _nbytes(*a, *kw.values()) + 8 * 16 * 8)
    ac, kwc = pda_args(dataclasses.replace(cfg_eff, quantum_rotation=False),
                       u)
    for tag, (aa, kk) in (("without", (ac, kwc)), ("sf", (a, kw))):
        ms = time_calls(lambda: mk.run_steps_uvt_pda(*aa, **kk, cluster=16),
                        device) / Kp
        dms = time_device(lambda: mk.run_steps_uvt_pda(*aa, **kk,
                                                       cluster=16),
                          device, n=20) / Kp
        rep.update({f"{tag}_ms": ms, f"{tag}_device_ms": dms})
        log(f"B6 f32 {tag} spinflip, survivor-free table, G=16: "
            f"{ms * 1e3:.2f} us/step per call, {dms * 1e3:.2f} on the card "
            "alone")
    pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw), device,
                     n=3) / Kp
    rep.update(ms=rep.pop("sf_ms"), device_ms=rep.pop("sf_device_ms"),
               plain_ms=pms, bound_ms=bound / Kp, bound_by=by,
               cluster="G=16")
    reps["run_steps_uvt_pda_sf"] = rep
    log("spinflip kernels: " + json.dumps(reps))
    return reps


class _RefreshClock:
    """Counts the rotor-table refreshes of a run and their B4 and
    eigensolve seconds (qrot.eigen_tables given a ``times`` dict while the
    clock is on)."""

    def __enter__(self):
        from mpmc_tpu_torch.ops import qrot
        self.qrot, self.orig = qrot, qrot.eigen_tables
        self.times, self.calls = {}, 0

        def timed(*a, **kw):
            self.calls += 1
            kw["times"] = self.times
            return self.orig(*a, **kw)

        qrot.eigen_tables = timed
        return self

    def __exit__(self, *exc):
        self.qrot.eigen_tables = self.orig

    def ms(self):
        """(ms per refresh, of them B4, of them eigensolves)."""
        n = max(self.calls, 1)
        b4 = self.times.get("b4_s", 0.0) * 1e3 / n
        eig = self.times.get("eigh_s", 0.0) * 1e3 / n
        return b4 + eig, b4, eig


SF_LINES = (f"quantum_rotation on\nspinflip_probability {P_SPIN}\n")
# the spinflip decks: (label, system, deck lines, numsteps, route line or
# None for the scan path, the kernel the route launches), each at corrtime
# <= 200, the parser's staleness bound
SF_DECKS = (
    ("sf_scan", "mof", SF_LINES + "corrtime 100\n", 300, None, None),
    ("sf_fused", "mof", SF_LINES + "fused_mc on\ncorrtime 200\n", 2000,
     "single-chain fused µVT kernel", "run_steps_uvt"),
    ("sf_c32", "mof", SF_LINES + "fused_mc on\nchains 32\ncorrtime 200\n",
     200, "chain-interleaved multi-chain kernel (C=32)", "run_steps_uvt"),
    ("sf_nvt", "mof", SF_LINES + "ensemble nvt\nfused_mc on\ncorrtime 200\n",
     2000, "single-chain fused NVT kernel", "run_steps"),
    ("sf_pda", "polar", SF_LINES + "polar_delayed on\nfused_mc on\n", 100,
     "polar delayed-acceptance stage-1 kernel", "run_steps_uvt_pda"),
    ("sf_pt", "mof", SF_LINES + "fused_mc on\nparallel_tempering on\n"
     f"n_replicas {PT_R}\nmax_temperature {PT_T_MAX}\nptemp_freq 100\n"
     "corrtime 200\n", 400, "chain-interleaved PT kernel", "run_steps_uvt"))


def phase_sf_decks(device):
    """The spinflip decks (SF_DECKS) through run.run: DECK with
    quantum_rotation on the scan path (300 steps), fused µVT (2,000),
    ``chains 32`` (200: each refresh rebuilds 32 tables), fused MOF NVT
    (2,000), PDA (d) (100) and PT
    (ii), the B1 ladder of 8 replicas (400 steps).  Each deck logs its
    route and no WARNING, launches its kernel (B1 and B3 once per corrtime
    on one chain) and the rotor grid (B4 at stride 0) at each refresh,
    reports the ortho fraction and the spinflip acceptance; after a
    further chunk the carried energy matches a fresh recompute.  Logs
    steps/s and ms per refresh (B4 and eigensolves apart).  Returns
    ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.state import slice_chain
    launches, reps = {}, {}
    for i, (label, kind, extra, numsteps, route, kernel) in enumerate(
            SF_DECKS):
        with _RefreshClock() as clock:
            su, avgs, text, ln = _run_deck(device, extra, numsteps=numsteps,
                                           kind=kind, verbose=False)
        ln["mol_pair_grid"] = pk.mol_pair_chains.shared_launches
        if "WARNING" in text or (route and f"fused_mc: {route}" not in text):
            raise AssertionError(f"{label}: not the route {route!r}")
        if kernel and not ln[kernel]:
            raise AssertionError(f"{label}: {kernel} not launched: {ln}")
        corr = su.cfg.corrtime
        if (kernel in ("run_steps_uvt", "run_steps") and "chains" not in
                extra and "parallel" not in extra
                and ln[kernel] != numsteps // corr):
            raise AssertionError(f"{label}: {kernel} launched {ln[kernel]} "
                                 f"times for {numsteps // corr} blocks")
        if not ln["mol_pair_grid"]:
            raise AssertionError(f"{label}: the rotor grid launched no B4")
        ortho = avgs.samples.get("ortho_fraction", [])
        acc_sp = avgs.mean("acc_spinflip") if "acc_spinflip" in \
            avgs.samples else float("nan")
        if not ortho or not 0.0 <= min(ortho) <= max(ortho) <= 1.0:
            raise AssertionError(f"{label}: ortho fractions {ortho}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        ref_ms, b4_ms, eig_ms = clock.ms()
        rep = {"steps_per_sec": rate, "ortho_fraction": ortho,
               "acc_spinflip": acc_sp, "N": avgs.mean("N"),
               "refreshes": clock.calls, "refresh_ms": ref_ms,
               "refresh_b4_ms": b4_ms, "refresh_eigh_ms": eig_ms,
               "kernel_launches": ln.get(kernel),
               "b4_grid_launches": ln["mol_pair_grid"],
               "b4_launches": ln["mol_pair"] + ln["mol_pair_chains"],
               "b1_launches": ln["run_steps_uvt"],
               "b3_launches": ln["run_steps"],
               "b6_launches": ln["run_steps_uvt_pda"]}
        g = torch.Generator(device=device).manual_seed(91 + i)
        params, cfg, thermo = su.params, su.cfg, su.thermo
        if su.states is not None:       # chains 32, and the PT ladder
            sts, _ = metropolis.run_chunk_fused_uvt_multi(
                su.states, params, cfg, thermo, 1000, generator=g)
            for c in (0, sts.pos.shape[0] - 1):
                _check_bookkeeping(f"{label} chain {c}, 1000 steps",
                                   slice_chain(sts, c), su)
        else:
            if kernel == "run_steps_uvt":
                st, _ = metropolis.run_chunk_fused_uvt(
                    su.state, params, cfg, thermo, 1000, generator=g)
            elif kernel == "run_steps":
                st, _ = metropolis.run_chunk_fused(
                    su.state, params, cfg, thermo, 1000, generator=g)
            elif kernel == "run_steps_uvt_pda":
                st, _ = metropolis.run_chunk_fused_uvt_polar_da(
                    su.state, params, cfg, thermo, 100, generator=g,
                    tables=metropolis.uvt_fused_tables(
                        params, mk.pda_effective_cfg(cfg, params)))
            else:
                st, _ = metropolis.run_chunk(su.state, params, cfg, thermo,
                                             100, generator=g)
            _check_bookkeeping(f"{label}, a further chunk", st, su,
                               polar=cfg.polarization)
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


# ---------------------------------------------------------------- RD forms
# the RD forms of B2 and B4's form instances, the name of each one's report
# entries (pair_terms_<key>, mol_pair_<key>) and its source
RD_FORMS = ("sg", "dreiding", "b14_7", "disp_expansion")
RD_KEY = {"sg": "sg", "dreiding": "dreiding", "b14_7": "b14_7",
          "disp_expansion": "disp"}
RD_LINES = {"sg": "sg on\n", "dreiding": "dreiding on\n",
            "b14_7": "lj_buffered_14_7 on\n",
            "disp_expansion": "disp_expansion on\ndamp_dispersion on\n"
            "extrapolate_disp_coeffs on\nrd_lrc on\n",
            "gwp": "gwp on\n"}
C_RD_CHAINS = 128


def _rd_ops(form, n_pairs, n_in):
    """Operations of a B2/B4 pass under ``form``: every counted pair's,
    and the RD energy of the inter pairs within rc."""
    return (n_pairs * (OPS_PAIR_RD_BASE + OPS_RD_ANY[form])
            + n_in * OPS_RD_IN[form])


def _rd_params(params, cfg, form):
    """The bench system's (params, cfg) under ``form``: its LJ wells mapped
    (systems.rd_form_columns; disp_expansion with rd_lrc and damping on),
    or, for "gwp", GWP widths 0.2-0.6 A (numpy seed 17) on every charged
    site under coulomb gwp."""
    from mpmc_tpu_torch.models import systems
    if form == "gwp":
        q = params.charge.cpu().numpy()
        w = np.random.default_rng(17).uniform(0.2, 0.6, q.shape)
        return (params.replace(gwp_alpha=torch.as_tensor(
            np.where(q != 0, w, 0.0), dtype=params.eps.dtype,
            device=params.device)),
                dataclasses.replace(cfg, coulomb="gwp"))
    return systems.with_rd_form(params, cfg, form, rd_lrc=True,
                                damp_dispersion=True)


def _rd_bench(form, dtype, device):
    params, state, cfg, thermo = bench_system(dtype, device)
    params, cfg = _rd_params(params, cfg, form)
    return params, state, cfg, thermo


def _within_rc(rows, row_ok, pos, col_ok, scal, block=1024):
    """Pairs of trial rows [C, A, 3] (row_ok [C, A]) with the columns pos
    [N, 3] or [C, N, 3] (col_ok [C, N]) inside rc, on the card in blocks
    of chains: what a form's RD energy is computed for."""
    from mpmc_tpu_torch.ops import pbc
    rc = float(scal[0])
    box, inv = scal[2:11].reshape(3, 3), scal[11:20].reshape(3, 3)
    n_in = 0
    for c0 in range(0, rows.shape[0], block):
        sl = slice(c0, c0 + block)
        p = pos if pos.ndim == 2 else pos[sl]
        pc = p[None, None] if pos.ndim == 2 else p[:, None]
        dr = pbc.min_image(rows[sl][:, :, None, :] - pc, box, inv)
        r2 = torch.sum(dr * dr, -1)
        ok = row_ok[sl][:, :, None] & col_ok[sl][:, None, :]
        n_in += int((ok & (r2 < rc * rc)).sum())
    return n_in


def _b2_counts(state, params, cfg, rs, block=512):
    """(pairs B2 evaluates at row_start rs, of them the inter pairs within
    rc): every alive row >= rs against the alive columns above it and
    below rs."""
    from mpmc_tpu_torch.ops import pairs, pbc
    scal = pairs.pair_scalars(state.box, cfg)
    rc = float(scal[0])
    box, inv = scal[2:11].reshape(3, 3), scal[11:20].reshape(3, 3)
    alive = state.atom_alive(params)
    n = alive.shape[0]
    cols = torch.arange(n, device=alive.device)
    n_all = n_in = 0
    for i0 in range(rs, n, block):
        rows = cols[i0:i0 + block]
        ok = (alive[rows][:, None] & alive[None, :]
              & ((cols[None, :] > rows[:, None]) | (cols[None, :] < rs)))
        dr = pbc.min_image(state.pos[rows][:, None, :] - state.pos[None],
                           box, inv)
        r2 = torch.sum(dr * dr, -1)
        inter = ok & (params.mol_id[rows][:, None] != params.mol_id[None, :])
        n_all += int(ok.sum())
        n_in += int((inter & (r2 < rc * rc)).sum())
    return n_all, n_in


def _agree(label, k, p, ref64, dtype, slots):
    """k against the plain p (float64) or the float64 plain ref64 within
    _tol (float32); logged per slot; returns max |d|."""
    k = k.double().cpu().numpy()
    p = p.double().cpu().numpy()
    if dtype == "float64":
        ref, tol = p, _tol(torch.float64, p)
    else:
        ref, tol = ref64, _tol(torch.float32, ref64, p)
    err = np.abs(k - ref)
    fin = np.isfinite(ref)
    for s, name in enumerate(slots):
        e, t = err.reshape(-1, len(slots))[:, s], tol.reshape(
            -1, len(slots))[:, s]
        log(f"    {name:11s} |d| {e.max():.3e} tol {t.min():.3e} (worst "
            f"|d|/tol {float(np.max(e / t)):.3f})")
    if not (np.all(err[fin] <= tol[fin])
            and np.array_equal(np.isfinite(k), fin)):
        raise AssertionError(f"{label} {dtype} disagrees with its plain "
                             "version")
    return float(err[fin].max())


def phase_rd_kernels(device):
    """B2 and B4's instance of each RD form (sg, dreiding, b14_7,
    disp_expansion damped with its tail) on the 10.8k bench system with
    its LJ wells mapped to the form (systems.rd_form_columns), each
    against its plain version in float64 (rel 1e-12) and float32 (_tol):
    B2 at row_start F and 0; B4 on an H2's rows and a trial beside the
    framework; B4 over C_RD_CHAINS chains (positions per chain, the trial
    moved per chain); B4 at position stride 0 over the 512 orientations
    of the fewest rotors past grid_min (regime 1), bit for bit the launch
    over an expanded, copied pos (regime 2).  Times (float32) per call, on
    the card alone and of the plain version (a GRID_ROTORS-rotor launch at
    stride 0); bounds from OPS_RD_* and this run's pairs within rc; B4's
    launch shapes and each form's ptxas lines of B4.  Returns the report
    entries pair_terms_<key> and mol_pair_<key>."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs, qrot
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    report = {}
    for form in RD_FORMS:
        key = RD_KEY[form]
        b2 = report[f"pair_terms_{key}"] = {"max_abs_err": 0.0}
        b4 = report[f"mol_pair_{key}"] = {"max_abs_err": 0.0}
        ref64, errs = {}, {"c128": 0.0, "grid": 0.0}
        for dtype in ("float64", "float32"):
            params, state, cfg, thermo = _rd_bench(form, dtype, device)
            disp = pairs.site_columns(params, cfg)[0]
            F = metropolis.frozen_refresh_rows(params, cfg)
            alive = state.atom_alive(params)
            scal = pairs.pair_scalars(state.box, cfg)
            args = (state.pos, params.charge, params.eps, params.sig,
                    params.mol_id32, alive, params.mol_frozen[params.mol_id],
                    scal, cfg)
            f32 = dtype == "float32"
            for rs in (F, 0):
                k = pk.pair_terms(*args, row_start=rs, disp=disp)
                p = pk.pair_terms_plain(*args, row_start=rs, disp=disp)
                if not f32:
                    ref64[("b2", rs)] = p.double().cpu().numpy()
                log(f"B2 {form} {dtype} row_start={rs}:")
                b2["max_abs_err"] = max(b2["max_abs_err"], _agree(
                    f"B2 {form}", k, p, ref64[("b2", rs)], dtype, SLOTS))
                if f32:
                    ms = time_calls(lambda: pk.pair_terms(
                        *args, row_start=rs, disp=disp), device)
                    dms = time_device(lambda: pk.pair_terms(
                        *args, row_start=rs, disp=disp), device, n=20)
                    pms = time_calls(lambda: pk.pair_terms_plain(
                        *args, row_start=rs, disp=disp), device, n=3)
                    n_pairs, n_in = _b2_counts(state, params, cfg, rs)
                    bound, by = _bound_ms(_rd_ops(form, n_pairs, n_in),
                                          _nbytes(*args[:8], *(disp or ()))
                                          + 9 * 4)
                    e = dict(ms=ms, device_ms=dms, plain_ms=pms,
                             bound_ms=bound, bound_by=by, pairs=n_pairs,
                             pairs_in_rc=n_in)
                    if rs == F:
                        b2.update(e)
                    else:
                        b2["full"] = e
                    log(f"    {ms:.4f} ms per call, {dms:.4f} on the card "
                        f"alone, plain {pms:.3f}; bound {bound:.5f} ms ({by};"
                        f" {n_pairs} pairs, {n_in} within rc)")
            # B4: an H2's rows and a trial beside the framework
            h2 = int(np.flatnonzero((params.mol_species >= 0).cpu().numpy()
                                    & state.mol_alive.cpu().numpy())[0])
            trial = (state.pos[0] + params.species_pos[0]
                     + torch.tensor([2.0, 0.31, 0.17], dtype=cfg.tdtype,
                                    device=device))
            m = torch.tensor(h2, device=device)
            for label, rows in (("H2", None), ("trial", trial)):
                margs = (state.pos, params.charge, params.eps, params.sig,
                         params.mol_id32, alive, params.mol_atoms,
                         params.mol_natoms, m, rows, scal, cfg)
                k = pk.mol_pair(*margs, disp=disp)
                p = pk.mol_pair_plain(*margs, disp=disp)
                if not f32:
                    ref64[("b4", label)] = p.double().cpu().numpy()
                log(f"B4 {form} {dtype} {label}:")
                b4["max_abs_err"] = max(b4["max_abs_err"], _agree(
                    f"B4 {form}", k, p, ref64[("b4", label)], dtype,
                    MOL_SLOTS))
                if f32 and label == "H2":
                    ms = time_calls(lambda: pk.mol_pair(*margs, disp=disp),
                                    device)
                    dms = time_device(lambda: pk.mol_pair(*margs, disp=disp),
                                      device, n=200)
                    pms = time_calls(lambda: pk.mol_pair_plain(
                        *margs, disp=disp), device)
                    own = params.mol_id == h2
                    na = int(params.mol_natoms[h2])
                    n_pairs = na * int((alive & ~own).sum())
                    rows_h2 = state.pos[params.mol_atoms[h2]][None]
                    n_in = _within_rc(rows_h2, torch.arange(
                        rows_h2.shape[1], device=device)[None] < na,
                        state.pos, (alive & ~own)[None], scal)
                    bound, by = _bound_ms(_rd_ops(form, n_pairs, n_in),
                                          _nbytes(*margs[:11], *(disp or ()))
                                          + 4 * 4)
                    b4.update(ms=ms, device_ms=dms, plain_ms=pms,
                              bound_ms=bound, bound_by=by, pairs=n_pairs,
                              pairs_in_rc=n_in)
                    log(f"    {ms:.4f} ms per call, {dms:.4f} on the card "
                        f"alone, plain {pms:.4f}; bound {bound:.6f} ms ({by};"
                        f" {n_pairs} pairs, {n_in} within rc)")
            # B4 over chains: every chain the system, the trial moved
            C = C_RD_CHAINS
            g = np.random.default_rng(31)
            shift = torch.as_tensor(g.uniform(-1.5, 1.5, (C, 1, 3)),
                                    dtype=cfg.tdtype, device=device)
            crows = (trial[None] + shift).contiguous()
            mols = torch.full((C,), h2, dtype=torch.int64, device=device)
            cpos = state.pos.expand(C, -1, -1).contiguous()
            calive = alive.expand(C, -1).contiguous()
            cargs = (cpos, params.charge, params.eps, params.sig,
                     params.mol_id32, calive, params.mol_atoms,
                     params.mol_natoms, mols, crows, scal, cfg)
            k = pk.mol_pair_chains(*cargs, disp=disp)
            p = pk.mol_pair_chains_plain(*cargs, disp=disp)
            if not f32:
                ref64["c128"] = p.double().cpu().numpy()
            log(f"B4 {form} {dtype} over {C} chains:")
            errs["c128"] = max(errs["c128"], _agree(
                f"B4 {form} c{C}", k, p, ref64["c128"], dtype, MOL_SLOTS))
            if f32:
                ms = time_calls(lambda: pk.mol_pair_chains(*cargs, disp=disp),
                                device)
                dms = time_device(lambda: pk.mol_pair_chains(
                    *cargs, disp=disp), device, n=100)
                pms = time_calls(lambda: pk.mol_pair_chains_plain(
                    *cargs, disp=disp), device, n=1)
                own = params.mol_id == h2
                na = int(params.mol_natoms[h2])
                n_pairs = C * na * int((alive & ~own).sum())
                n_in = _within_rc(crows, torch.arange(
                    crows.shape[1], device=device)[None].expand(C, -1) < na,
                    state.pos, (alive & ~own)[None].expand(C, -1), scal)
                bound, by = _bound_ms(_rd_ops(form, n_pairs, n_in),
                                      _nbytes(*cargs[:11], *(disp or ()))
                                      + C * 4 * 4)
                b4["c128"] = dict(ms=ms, device_ms=dms, plain_ms=pms,
                                  bound_ms=bound, bound_by=by, pairs=n_pairs,
                                  pairs_in_rc=n_in,
                                  max_abs_err=errs["c128"])
                log(f"    {ms:.4f} ms per call, {dms:.4f} on the card alone,"
                    f" plain {pms:.2f}; bound {bound:.5f} ms ({by})")
            # B4 at position stride 0: the orientations of the fewest
            # rotors past grid_min (regime 1)
            state0 = metropolis.initialize(state, params, cfg, thermo)
            mols_r, _ = qrot.rotor_slots(state0.mol_alive, params,
                                         [systems.h2_bss3()])
            axes = torch.as_tensor(qrot._basis(4, qrot.N_THETA,
                                               qrot.N_PHI)[3],
                                   dtype=cfg.tdtype, device=device)
            G = axes.shape[0]

            def grid(ms_):
                mt = torch.as_tensor(ms_, device=device)
                rows = qrot.grid_rows(state.pos, params, mt, axes)
                return (params.mol_atoms, params.mol_natoms,
                        mt.repeat_interleave(G),
                        rows.reshape(-1, rows.shape[2], 3).contiguous(),
                        scal, cfg)

            common = (params.charge, params.eps, params.sig, params.mol_id32)
            n_grid = _grid_rotors_past(cfg, state.pos.shape[0], G)
            tail = grid(mols_r[:n_grid])
            Cg = tail[2].shape[0]
            plan = pk.mol_pair_plan(state.pos.shape[0], Cg, True,
                                    state.pos.dtype, cfg)
            k = pk.mol_pair_chains(state.pos, *common, alive, *tail,
                                   disp=disp)
            p = pk.mol_pair_chains_plain(state.pos, *common, alive, *tail,
                                         disp=disp)
            wide = pk.mol_pair_chains(
                state.pos.expand(Cg, -1, -1).contiguous(), *common,
                alive.expand(Cg, -1).contiguous(), *tail, disp=disp)
            if not f32:
                ref64["grid"] = p.double().cpu().numpy()
            log(f"B4 {form} {dtype} at stride 0, {n_grid} rotors x {G} "
                f"(launch shape {plan}; equal to the expanded-pos launch: "
                f"{torch.equal(k, wide)}):")
            if not (plan["regime"] == 1 and torch.equal(k, wide)):
                raise AssertionError(f"B4 {form} {dtype}: the stride-0 "
                                     "launch (regime 1) is not the expanded "
                                     "launch bit for bit")
            errs["grid"] = max(errs["grid"], _agree(
                f"B4 {form} stride 0", k, p, ref64["grid"], dtype,
                MOL_SLOTS))
            if f32:
                for kk, v in _b4_ptxas(pk.FORM_LIBRARY[form]).items():
                    log(f"    B4 {form} {kk} ptxas: {v}")
                full = grid(mols_r[:GRID_ROTORS])
                Cf = full[2].shape[0]

                def launch():
                    return pk.mol_pair_chains(state.pos, *common, alive,
                                              *full, disp=disp)

                ms = time_calls(launch, device)
                dms = time_device(launch, device, n=10)

                pms = time_calls(lambda: pk.mol_pair_chains_plain(
                    state.pos, *common, alive, *full, disp=disp), device,
                    n=1)
                col_ok = alive[None] & (params.mol_id[None, :]
                                        != full[2][:, None])
                n_pairs = Cf * 3 * int(alive.sum())
                n_in = _within_rc(full[3], torch.ones(
                    full[3].shape[:2], dtype=torch.bool, device=device),
                    state.pos, col_ok, scal)
                bound, by = _bound_ms(_rd_ops(form, n_pairs, n_in),
                                      _nbytes(state.pos, *common, alive,
                                              *full[:5], *(disp or ()))
                                      + Cf * 4 * 4)
                b4["grid"] = dict(ms=ms, device_ms=dms, plain_ms=pms,
                                  bound_ms=bound, bound_by=by, chains=Cf,
                                  pairs=n_pairs, pairs_in_rc=n_in,
                                  max_abs_err=errs["grid"],
                                  plan=pk.mol_pair_plan(
                                      state.pos.shape[0], Cf, True,
                                      state.pos.dtype, cfg))
                log(f"    a {GRID_ROTORS}-rotor launch (C={Cf}):"
                    f" {ms:.3f} ms per call, {dms:.3f} on the card alone, "
                    f"plain {pms:.1f}; bound {bound:.4f} ms ({by})")
    return report


# (label, form, extra deck lines, numsteps, deck kind, the pair route)
RD_DECKS = (
    ("disp", "disp_expansion", "", 1000, "mof", "kernels"),
    ("disp_c16", "disp_expansion", "chains 16\ncorrtime 100\n", 200, "mof",
     "kernels"),
    ("disp_polar", "disp_expansion", "", 100, "polar", "kernels"),
    ("gwp", "gwp", "corrtime 100\n", 200, "mof", "plain"),
    ("sg", "sg", "corrtime 100\n", 300, "mof", "kernels"),
    ("dreiding", "dreiding", "corrtime 100\n", 300, "mof", "kernels"),
    ("b14_7", "b14_7", "corrtime 100\n", 300, "mof", "kernels"))


def phase_rd_decks(device, chunk=100):
    """The RD forms and coulomb gwp on the 10.8k bench system (77 K, 1
    atm) through run.run: the disp_expansion µVT scan deck (damped, its
    tail on, C10 from extrapolate_disp_coeffs), its ``chains 16`` batched
    deck, its Thole-polar scan deck (PHAHST's shape, polar (a)), a
    coulomb gwp deck (the plain pass: B2 and B4 launch 0 times), and the
    sg, dreiding and b14_7 scan decks.  Each deck's steps/s and launches,
    and its carried energy after a further chunk against a fresh
    recompute (rel 1e-4; polar: _polar_tol)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    launches, reps = {}, {}
    for i, (label, form, extra, numsteps, kind, route) in enumerate(
            RD_DECKS):
        su, avgs, text, ln = _run_deck(device, RD_LINES[form] + extra,
                                       numsteps=numsteps, kind=kind,
                                       verbose=False, form=form)
        plain = "pair passes: the plain tile pass" in text
        b2b4 = ln["pair_terms"] + ln["mol_pair"] + ln["mol_pair_chains"]
        if plain != (route == "plain") or (b2b4 > 0) != (route != "plain"):
            raise AssertionError(f"{label}: not the {route} pair route: "
                                 f"{ln}")
        if su.cfg.rd_potential != (form if form != "gwp" else "lj") or (
                (form == "gwp") != (su.cfg.coulomb == "gwp")):
            raise AssertionError(f"{label}: the deck ran {su.cfg.rd_potential}"
                                 f" / {su.cfg.coulomb}")
        if form == "disp_expansion" and not float(su.params.c10.max()) > 0:
            raise AssertionError(f"{label}: extrapolate_disp_coeffs left C10 "
                                 "0")
        rate = float(text.split("steps/sec:")[1].split()[0])
        g = torch.Generator(device=device).manual_seed(61 + i)
        params, cfg, thermo = su.params, su.cfg, su.thermo
        if su.states is not None:
            sts, _ = multichain.run_chunk_batched(su.states, params, cfg,
                                                  thermo, chunk, generator=g)
            for c in (0, sts.pos.shape[0] - 1):
                _check_bookkeeping(f"{label} chain {c}, {chunk} steps",
                                   slice_chain(sts, c), su)
        else:
            st, _ = metropolis.run_chunk(su.state, params, cfg, thermo,
                                         chunk, generator=g)
            _check_bookkeeping(f"{label}, {chunk} steps", st, su,
                               polar=cfg.polarization)
        rep = {"steps_per_sec": rate, "N": avgs.mean("N"),
               "acc_insert": avgs.mean("acc_insert"),
               "energy_rd": avgs.mean("energy_rd"),
               "energy_lrc": avgs.mean("energy_lrc")}
        log(f"{label}: " + json.dumps(rep) + f"  launches {ln}")
        launches[label], reps[label] = ln, rep
    return launches, reps


# the fused kernels' forms (B1, B3 and B6's form libraries): the RD forms
# and coulomb gwp, and their entries' keys
FUSED_FORMS = RD_FORMS + ("gwp",)
FUSED_KEY = {**RD_KEY, "gwp": "gwp"}


def _form_system(system, form):
    """``system`` (params, state, cfg, thermo) with its columns under
    ``form`` (_rd_params) and its state initialized under it."""
    from mpmc_tpu_torch.mc import metropolis
    params, state, cfg, thermo = system
    params, cfg = _rd_params(params, cfg, form)
    return (params, metropolis.initialize(state, params, cfg, thermo), cfg,
            thermo)


def phase_rd_fused_kernels(device, K=16, K32=8, seed=2029, k_time=1000):
    """B1, B3 and B6's instance of each form (sg, dreiding, b14_7,
    disp_expansion damped with its tail, and coulomb gwp with LJ: widths
    0.2-0.6 A, numpy seed 17) against its plain version on numpy-seeded
    tables, float64 (phase_uvt_kernel's rule) and float32 (its rule plus,
    for rd and es, _rss_tol, as the FH/FK phase holds them, and
    _slope_tol): B1 on the 10.8k bench system at C = 1 (G = 16) and, in
    float32, at C = 32 (the wrapper's G), and gwp's instance with FH2
    (lj) at C = 1; B3 on the 10.0k MOF + H2 NVT system (nvt_system, after
    its warm-up) at C = 2 (G = 16, each chain equal to its C = 1 launch)
    and, in float32, at C = 16 (the wrapper's G); B6 on the polar bench
    system (direct field) as one 16-step segment: forced survivors of
    each move type, natural coins and a survivor-free table (phase_pda_
    kernel's rules, G = 16).  Times per step (float32; B1 and B3:
    1000-step launches, C = 1 at G = 16 and C = 32 / 16 at the wrapper's
    G; B6: the survivor-free table), each beside the classical
    instance's from this call, the plain version's, and the bound with
    the form's operations (_in_rc_ops).  Returns {entry: report} for
    run_steps_uvt_<k>, run_steps_<k> and run_steps_uvt_pda_<k>, k the
    forms' keys (FUSED_KEY), and run_steps_uvt_gwp_fh2."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    rng = np.random.default_rng(seed)
    reps = {}
    f32 = torch.float32

    def timed(fn, n_steps):
        return (_time_steps(fn, device, n_steps),
                time_device(fn, device, n=5) / n_steps)

    def tab(x, dt=f32):
        return torch.as_tensor(x, dtype=dt, device=device)

    # ---- B1
    u1, u32 = rng.random((1, K, 16)), rng.random((32, K32, 16))
    ut1, ut32 = rng.random((1, k_time, 16)), rng.random((32, k_time, 16))
    base = {dt: bench_system(dt, device) for dt in ("float64", "float32")}
    params, state, cfg, thermo = base["float32"]
    state = metropolis.initialize(state, params, cfg, thermo)
    tables = metropolis.uvt_fused_tables(params, cfg)
    classical = {}
    for C, ut in ((1, ut1), (32, ut32)):
        at, kwt = metropolis.fused_uvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, tab(ut),
            tables)
        G = 16 if C == 1 else None
        classical[C] = timed(lambda: mk.run_steps_uvt(*at, **kwt, cluster=G),
                             k_time)
    log(f"B1 f32 classical: C=1 G=16 {classical[1][0] * 1e3:.3f} us/step "
        f"({classical[1][1] * 1e3:.3f} back to back), C=32 "
        f"{classical[32][0] * 1e3:.3f} ({classical[32][1] * 1e3:.3f})")
    for form in FUSED_FORMS:
        key = FUSED_KEY[form]
        rep = {"max_abs_err": 0.0}
        for dtype in ("float64", "float32"):
            system = _form_system(base[dtype], form)
            params, state, cfg, thermo = system
            k1, trace, err, (a1, kw1) = _uvt_fh_check(
                f"{dtype} {form}", system, thermo, tab(u1, cfg.tdtype),
                device, slopes=True)
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if dtype == "float64":
                continue
            _, _, err32, _ = _uvt_fh_check(f"{dtype} {form}", system, thermo,
                                           tab(u32), device, cluster=None,
                                           slopes=True)
            G32 = mk.run_steps_uvt.last_cluster
            rep["max_abs_err"] = max(rep["max_abs_err"], err32)
            tables = metropolis.uvt_fused_tables(params, cfg)
            times = {}
            for C, ut in ((1, ut1), (32, ut32)):
                at, kwt = metropolis.fused_uvt_launch_args(
                    multichain.stack_states(state, C), params, cfg, thermo,
                    tab(ut), tables)
                G = 16 if C == 1 else None
                times[C] = timed(lambda: mk.run_steps_uvt(*at, **kwt,
                                                          cluster=G), k_time)
            pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1),
                             device, n=1) / K
            nk = kw1["kvecs"].shape[0] if kw1["kvecs"] is not None else 0
            ops = _fused_ops(trace, cfg, nk)
            n_io = (_nbytes(*a1[:25], *[v for v in kw1.values()
                                        if torch.is_tensor(v)],
                            *(kw1["disp"] or ()))
                    + _nbytes(k1[0], a1[1], k1[1], k1[2]))
            bound, by = _bound_ms(ops, n_io)
            rep.update(ms=times[1][0], device_ms=times[1][1], plain_ms=pms,
                       bound_ms=bound / K, bound_by=by,
                       classical_ms=classical[1][0],
                       classical_device_ms=classical[1][1],
                       cluster=f"G=16 (C=1), G={G32} (C=32)",
                       c32={"ms": times[32][0], "device_ms": times[32][1],
                            "classical_ms": classical[32][0],
                            "classical_device_ms": classical[32][1],
                            "G": G32})
            log(f"B1 f32 {form}: kernel {times[1][0] * 1e3:.3f} us/step "
                f"({times[1][1] * 1e3:.3f} on the card alone; classical "
                f"{classical[1][0] * 1e3:.3f} / {classical[1][1] * 1e3:.3f}),"
                f" C=32 G={G32} {times[32][0] * 1e3:.3f} / "
                f"{times[32][1] * 1e3:.3f} (classical "
                f"{classical[32][0] * 1e3:.3f} / "
                f"{classical[32][1] * 1e3:.3f}); plain {pms * 1e3:.1f} "
                f"us/step; bound {bound / K * 1e3:.4f} us/step ({by}; "
                f"{ops / K:.3e} ops/step)")
        reps[f"run_steps_uvt_{key}"] = rep
    # gwp with lj under FH2: the quantum instance of gwp's library
    rep = {"max_abs_err": 0.0}
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = base[dtype]
        params, cfg = _rd_params(params, cfg, "gwp")
        cfg = dataclasses.replace(cfg, feynman_hibbs=True)
        system = (params, metropolis.initialize(state, params, cfg, thermo),
                  cfg, thermo)
        k1, trace, err, (a1, kw1) = _uvt_fh_check(
            f"{dtype} gwp fh2", system, thermo, tab(u1, cfg.tdtype), device,
            slopes=True)
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
    params, state, cfg, thermo = system
    at, kwt = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, 1), params, cfg, thermo, tab(ut1),
        metropolis.uvt_fused_tables(params, cfg))
    t1 = timed(lambda: mk.run_steps_uvt(*at, **kwt, cluster=16), k_time)
    pms = time_calls(lambda: mk.run_steps_uvt_plain(*a1, **kw1), device,
                     n=1) / K
    nk = kw1["kvecs"].shape[0] if kw1["kvecs"] is not None else 0
    ops = _fused_ops(trace, cfg, nk)
    bound, by = _bound_ms(ops, _nbytes(*a1[:25], *[
        v for v in kw1.values() if torch.is_tensor(v)])
        + _nbytes(k1[0], a1[1], k1[1], k1[2]))
    rep.update(ms=t1[0], device_ms=t1[1], plain_ms=pms, bound_ms=bound / K,
               bound_by=by, classical_ms=classical[1][0],
               classical_device_ms=classical[1][1], cluster="G=16 (C=1)")
    log(f"B1 f32 gwp fh2: kernel {t1[0] * 1e3:.3f} us/step ({t1[1] * 1e3:.3f}"
        f" on the card alone; classical {classical[1][0] * 1e3:.3f} / "
        f"{classical[1][1] * 1e3:.3f}); plain {pms * 1e3:.1f} us/step; bound "
        f"{bound / K * 1e3:.4f} us/step ({by}; {ops / K:.3e} ops/step)")
    reps["run_steps_uvt_gwp_fh2"] = rep
    # ---- B3
    u2, u16 = rng.random((2, K, 16)), rng.random((16, K32, 16))
    ut16 = rng.random((16, k_time, 16))
    base = {dt: nvt_system("mof", dt, device)
            for dt in ("float64", "float32")}
    params, state, cfg, thermo = base["float32"]
    tables = metropolis.nvt_fused_tables(params, state.mol_alive)
    for C, ut in ((1, ut1), (16, ut16)):
        at, kwt = metropolis.fused_nvt_launch_args(
            multichain.stack_states(state, C), params, cfg, thermo, tab(ut),
            tables)
        G = 16 if C == 1 else None
        classical[C] = timed(lambda: mk.run_steps(*at, **kwt, cluster=G),
                             k_time)
    log(f"B3 f32 classical: C=1 G=16 {classical[1][0] * 1e3:.3f} us/step "
        f"({classical[1][1] * 1e3:.3f} back to back), C=16 "
        f"{classical[16][0] * 1e3:.3f} ({classical[16][1] * 1e3:.3f})")
    for form in FUSED_FORMS:
        key = FUSED_KEY[form]
        rep = {"max_abs_err": 0.0}
        for dtype in ("float64", "float32"):
            system = _form_system(base[dtype], form)
            params, state, cfg, thermo = system
            trace = []
            a1, kw1, one = _nvt_check(f"mof {dtype} {form}", system, u2,
                                      device, rep, trace_out=trace,
                                      sizes=[16], rss=True, slopes=True)[16]
            if dtype == "float64":
                continue
            tables = metropolis.nvt_fused_tables(params, state.mol_alive)
            a16, kw16 = metropolis.fused_nvt_launch_args(
                multichain.stack_states(state, 16), params, cfg, thermo,
                tab(u16), tables)
            mk.run_steps(*a16, **kw16)
            G16 = mk.run_steps.last_cluster
            _nvt_check(f"mof {dtype} {form} C=16", system, u16, device, rep,
                       sizes=[G16], rss=True, slopes=True)
            times = {}
            for C, ut in ((1, ut1), (16, ut16)):
                at, kwt = metropolis.fused_nvt_launch_args(
                    multichain.stack_states(state, C), params, cfg, thermo,
                    tab(ut), tables)
                G = 16 if C == 1 else None
                times[C] = timed(lambda: mk.run_steps(*at, **kwt, cluster=G),
                                 k_time)
            pms = time_calls(lambda: mk.run_steps_plain(*a1, **kw1), device,
                             n=1) / K
            nk = kw1["kvecs"].shape[0] if kw1["kvecs"] is not None else 0
            ops = _fused_ops(trace, cfg, nk)
            bound, by = _bound_ms(ops, _nbytes(*a1[:16], *[
                v for v in kw1.values() if torch.is_tensor(v)],
                *(kw1["disp"] or ())) + _nbytes(*one))
            rep.update(ms=times[1][0], device_ms=times[1][1], plain_ms=pms,
                       bound_ms=bound / K, bound_by=by,
                       classical_ms=classical[1][0],
                       classical_device_ms=classical[1][1],
                       cluster=f"G=16 (C=1), G={G16} (C=16)",
                       c16={"ms": times[16][0], "device_ms": times[16][1],
                            "classical_ms": classical[16][0],
                            "classical_device_ms": classical[16][1],
                            "G": G16})
            log(f"B3 f32 {form}: kernel {times[1][0] * 1e3:.3f} us/step "
                f"({times[1][1] * 1e3:.3f} on the card alone; classical "
                f"{classical[1][0] * 1e3:.3f} / {classical[1][1] * 1e3:.3f}),"
                f" C=16 G={G16} {times[16][0] * 1e3:.3f} / "
                f"{times[16][1] * 1e3:.3f} (classical "
                f"{classical[16][0] * 1e3:.3f} / "
                f"{classical[16][1] * 1e3:.3f}); plain {pms * 1e3:.1f} "
                f"us/step; bound {bound / K * 1e3:.4f} us/step ({by}; "
                f"{ops / K:.3e} ops/step)")
        reps[f"run_steps_{key}"] = rep
    # ---- B6 (direct field), one 16-step segment
    Kp = mk.PDA_SEG
    base = {dt: polar_system(dt, device) for dt in ("float64", "float32")}

    def pda_setup(system):
        params, state, cfg, thermo = system
        cfg = dataclasses.replace(cfg, polar_delayed=True, fused_mc=True)
        state = metropolis.initialize(state, params, cfg, thermo)
        cfg_eff = mk.pda_effective_cfg(cfg, params)
        tables = metropolis.uvt_fused_tables(params, cfg_eff)
        consts = metropolis._uvt_chunk_consts(
            state.pos, state.box, params, thermo, cfg_eff, tables[5],
            tables[6])

        def args_of(u):
            return metropolis.pda_launch_args(state, params, cfg_eff, thermo,
                                              u, tables, consts)
        return args_of, cfg_eff

    classical_args, _ = pda_setup(base["float32"])

    def classical_launch(u):
        a, kw = classical_args(u)
        return mk.run_steps_uvt_pda(*a, **kw)

    # the classical instance's own survivor-free table: all 16 steps run
    u_classical = _pda_survivor_free(
        classical_launch, tab(rng.random((Kp, 16))), rng)
    for form in FUSED_FORMS:
        key = FUSED_KEY[form]
        rep = {"max_abs_err": 0.0}
        for dtype in ("float64", "float32"):
            f64 = dtype == "float64"
            params, state, cfg, thermo = base[dtype]
            params, cfg = _rd_params(params, cfg, form)
            args_of, cfg_eff = pda_setup((params, state, cfg, thermo))

            def launch(u):
                a, kw = args_of(u)
                return mk.run_steps_uvt_pda(*a, **kw)

            # per move type a table whose step 0 survives (a forced coin can
            # still meet an overlap: such tables are drawn again, up to 8
            # times, by the kernel itself)
            us = {}
            for mt, lane8 in ((0, 0.9), (1, 0.1), (2, 0.4)):
                for _ in range(8):
                    x = rng.random((Kp, 16))
                    x[0, 4], x[0, 8] = 1e-30, lane8
                    x = tab(x, cfg.tdtype)
                    if float(launch(x)[0, 1]) > 0.5:
                        break
                us[f"step 0 survives ({'disp ins del'.split()[mt]})"] = x
            us["natural"] = tab(rng.random((Kp, 16)), cfg.tdtype)
            us["survivor-free"] = _pda_survivor_free(
                launch, tab(rng.random((Kp, 16)), cfg.tdtype), rng)
            hits = 0
            for name, u in us.items():
                a, kw = args_of(u)
                trace = []
                p = mk.run_steps_uvt_pda_plain(
                    *a, **kw, trace=trace, slopes=not f64).cpu().numpy()
                k = mk.run_steps_uvt_pda(*a, **kw,
                                         cluster=16).cpu().numpy()
                rss = np.zeros(8)
                if trace[-1].get("rss"):
                    rss[[0, 1, 2, 6]] = trace[-1]["rss"]
                want = np.concatenate([p[1, :6], p[0, 9:11]])
                tol = (1e-10 * np.abs(want) + 1e-8 if f64
                       else 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss)
                d_vals = np.abs(np.concatenate([k[1, :6], k[0, 9:11]])
                                - want)
                d_rows = float(np.abs(k[2:5] - p[2:5]).max())
                if not f64 and trace[-1].get("slope"):   # _slope_tol's rule
                    tol[:2] += (np.asarray(trace[-1]["slope"])
                                * _row_bound(state.box))
                log(f"B6 {dtype} {form} {name} G=16: n_done {k[0, 0]:g} hit "
                    f"{k[0, 1]:g} mtype {k[0, 2]:g} (plain: {p[0, 0]:g} "
                    f"{p[0, 1]:g} {p[0, 2]:g}); |d| deltas/d*/lnb "
                    f"{d_vals.max():.3e} (worst |d|/tol "
                    f"{float(np.max(d_vals / tol)):.3f}), rows {d_rows:.3e}")
                if not (np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                                       p[0, [0, 1, 2, 3, 4, 6, 7, 8]])
                        and np.all(d_vals <= tol)
                        and d_rows <= (1e-9 if f64 else 1e-4)):
                    raise AssertionError(f"B6 {dtype} {form} {name} "
                                         "disagrees with its plain version")
                rep["max_abs_err"] = max(rep["max_abs_err"],
                                         float(d_vals.max()), d_rows)
                hits += int(k[0, 1])
            if hits < 3:
                raise AssertionError(f"B6 {dtype} {form}: only {hits} "
                                     "survivors")
            if f64:
                continue
            u = us["survivor-free"]
            a, kw = args_of(u)
            trace = []
            mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace)
            nk = kw["kvecs"].shape[0] if kw["kvecs"] is not None else 0
            ops = _pda_ops(trace, "direct", nk, cfg=a[-1])
            bound, by = _bound_ms(ops, _nbytes(*a, *[
                v for v in kw.values() if torch.is_tensor(v)],
                *(kw["disp"] or ())) + 8 * 16 * 8)
            ac, kwc = classical_args(u_classical)
            for tag, (aa, kk) in (("classical", (ac, kwc)), ("form", (a, kw))):
                ms = time_calls(lambda: mk.run_steps_uvt_pda(*aa, **kk,
                                                             cluster=16),
                                device) / Kp
                dms = time_device(lambda: mk.run_steps_uvt_pda(
                    *aa, **kk, cluster=16), device, n=20) / Kp
                rep.update({f"{tag}_ms": ms, f"{tag}_device_ms": dms})
            pms = time_calls(lambda: mk.run_steps_uvt_pda_plain(*a, **kw),
                             device, n=3) / Kp
            rep.update(ms=rep.pop("form_ms"),
                       device_ms=rep.pop("form_device_ms"), plain_ms=pms,
                       bound_ms=bound / Kp, bound_by=by, cluster="G=16")
            log(f"B6 f32 {form}, survivor-free table, G=16: "
                f"{rep['ms'] * 1e3:.2f} us/step per call, "
                f"{rep['device_ms'] * 1e3:.2f} on the card alone (classical "
                f"{rep['classical_ms'] * 1e3:.2f} / "
                f"{rep['classical_device_ms'] * 1e3:.2f}); plain "
                f"{pms * 1e3:.1f} us/step; bound {bound / Kp * 1e3:.4f} "
                f"us/step ({by}; {ops / Kp:.3e} ops/step)")
        reps[f"run_steps_uvt_pda_{key}"] = rep
    log("rd fused kernels: " + json.dumps(reps))
    return reps


# the decks of the fused kernels' form instances on the 10.8k system (77 K,
# 1 atm): (label, form, deck kind, extra lines, numsteps, the kernel and
# the route's log line); PHAHST's shape is disp_pda (disp_expansion,
# Thole, delayed acceptance); each other form's B3 and B6 instance runs a
# short deck of its own
_NVT = "ensemble nvt\nfused_mc on\n"
_PDA = "polar_delayed on\nfused_mc on\n"
RD_FUSED_DECKS = (
    ("disp_uvt", "disp_expansion", "mof", "fused_mc on\n", 2000,
     "run_steps_uvt", "single-chain fused µVT kernel"),
    ("disp_c32", "disp_expansion", "mof", "fused_mc on\nchains 32\n", 1000,
     "run_steps_uvt", "chain-interleaved"),
    ("disp_nvt", "disp_expansion", "mof", _NVT, 2000, "run_steps",
     "single-chain fused NVT kernel"),
    ("disp_pda", "disp_expansion", "polar", _PDA, 100, "run_steps_uvt_pda",
     "polar delayed-acceptance stage-1 kernel"),
    ("gwp_uvt", "gwp", "mof", "fused_mc on\n", 2000, "run_steps_uvt",
     "single-chain fused µVT kernel"),
    ("gwp_fh2_uvt", "gwp", "mof", "fused_mc on\nfeynman_hibbs on\n", 2000,
     "run_steps_uvt", "single-chain fused µVT kernel"),
    *((f"{RD_KEY.get(f, f)}_uvt", f, "mof", "fused_mc on\n", 2000,
       "run_steps_uvt", "single-chain fused µVT kernel")
      for f in ("sg", "dreiding", "b14_7")),
    *((f"{f}_nvt", f, "mof", _NVT, 1000, "run_steps",
       "single-chain fused NVT kernel")
      for f in ("sg", "dreiding", "b14_7", "gwp")),
    *((f"{f}_pda", f, "polar", _PDA, 100, "run_steps_uvt_pda",
       "polar delayed-acceptance stage-1 kernel")
      for f in ("sg", "dreiding", "b14_7", "gwp")))


def phase_rd_fused_decks(device, chunk=200):
    """The fused kernels' form instances at full width through run.run
    (RD_FUSED_DECKS): fused µVT with disp_expansion (damped, its tail on,
    C10 from extrapolate_disp_coeffs) on one chain and ``chains 32``, the
    MOF NVT deck and the PDA (d) deck with Thole (PHAHST's shape) with it,
    fused µVT with gwp (and with gwp under feynman_hibbs, lj), sg,
    dreiding and b14_7, and short NVT and PDA decks
    of the other forms.  Each deck: the route's log line and the form
    instances' line, its kernel launched (B1 and B3 once per corrtime),
    no plain pair pass (B2 and B4's form instances price the refresh, the
    chunk's tail constants and B6's survivors; under gwp, whose pair
    passes B2 and B4's gate refuses as the reference's does, the plain
    pass and its log line), steps/s, and the carried energy after a
    further ``chunk`` (PDA: 100) steps against a fresh recompute (rel
    1e-4; polar: _polar_tol).
    Returns ({deck: launches}, {deck: report})."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.state import slice_chain
    launches, reps = {}, {}
    for i, (label, form, kind, extra, numsteps, kernel, route) in enumerate(
            RD_FUSED_DECKS):
        su, avgs, text, ln = _run_deck(device, RD_LINES[form] + extra,
                                       numsteps=numsteps, kind=kind,
                                       verbose=False, form=form)
        stem = FUSED_KEY[form]
        if (f"fused_mc: {route}" not in text or "WARNING" in text
                or f"form instances (uvt_{stem}_kernel" not in text):
            raise AssertionError(f"{label}: not the fused {route} route of "
                                 f"the form instances")
        want = (-(-numsteps // 1000) if kernel != "run_steps_uvt_pda" else 1)
        if ln[kernel] < want:
            raise AssertionError(f"{label}: {kernel} launched {ln[kernel]} "
                                 f"times (>= {want})")
        if kernel != "run_steps_uvt_pda" and ln[kernel] != want:
            raise AssertionError(f"{label}: {kernel} launched {ln[kernel]} "
                                 f"times, not numsteps / corrtime = {want}")
        plain = "pair passes: the plain tile pass" in text
        if plain != (form == "gwp") or (ln["pair_terms"] > 0) == plain:
            raise AssertionError(f"{label}: the refresh's pair pass is not "
                                 f"{'plain' if form == 'gwp' else 'B2'}")
        rate = float(text.split("steps/sec:")[1].split()[0])
        g = torch.Generator(device=device).manual_seed(71 + i)
        params, cfg, thermo = su.params, su.cfg, su.thermo
        if su.states is not None:
            sts, _ = metropolis.run_chunk_fused_uvt_multi(
                su.states, params, cfg, thermo, chunk, generator=g)
            for c in (0, sts.pos.shape[0] - 1):
                _check_bookkeeping(f"{label} chain {c}, {chunk} steps",
                                   slice_chain(sts, c), su)
        elif kernel == "run_steps_uvt":
            st, _ = metropolis.run_chunk_fused_uvt(su.state, params, cfg,
                                                   thermo, chunk, generator=g)
            _check_bookkeeping(f"{label}, {chunk} steps", st, su)
        elif kernel == "run_steps":
            st, _ = metropolis.run_chunk_fused(su.state, params, cfg, thermo,
                                               chunk, generator=g)
            _check_bookkeeping(f"{label}, {chunk} steps", st, su)
        else:
            st, _ = metropolis.run_chunk_fused_uvt_polar_da(
                su.state, params, cfg, thermo, 100, generator=g,
                tables=metropolis.uvt_fused_tables(
                    params, mk.pda_effective_cfg(cfg, params)))
            _check_bookkeeping(f"{label}, 100 steps", st, su, polar=True)
        rep = {"steps_per_sec": rate, "N": avgs.mean("N"),
               "energy_rd": avgs.mean("energy_rd"),
               "energy_lrc": avgs.mean("energy_lrc"),
               "kernel_launches": ln[kernel], "b2_launches": ln["pair_terms"]}
        log(f"{label}: " + json.dumps(rep) + f"  launches {ln}")
        launches[label], reps[label] = ln, rep
    return launches, reps


# ---------------------------------------------------------------------------
# polar NPT with B5 over a box per chain, then A12b's energy terms: cdvdw
# and its repulsions, rd_crystal, SPECTRE, quantum vibration
# ---------------------------------------------------------------------------

# the frameless polarizable H2 fluid of the polar NPT decks: the polar
# bench sorbate (h2_bss3: alpha 0.6938 A^3 on the centre, the bench's
# Thole damping) at 77 K and 200 atm, 3,456 molecules (10,368 sites), its
# box started at the ideal-gas volume (N + 1) kT / P
N_FLUID, FLUID_T, FLUID_P = 3456, 77.0, 200.0
POLAR_NPT_LINES = ("ensemble npt\npressure 200\nvolume_probability 0.05\n"
                   "volume_change_factor 0.008\ncorrtime 100\n"
                   "polarization on\newald_kmax 5\n")
# the Drude fluid of the cdvdw decks: 512 H2 with alpha and omega on the
# centre (P = 512, a 1,536 x 1,536 eigensolve per trial), float64
N_DRUDE, DRUDE_OMEGA = 512, 0.6
# B5 over chains with a header per chain: the cells' edge factors
HEADER_SCALE = (0.95, 1.05)
# quantum vibration: H2's fundamental [cm^-1]
H2_VIB = 4161.0
# the spectre sites added to the bench system: count, |q|, the clamp and
# the target of the renormalization
N_SPECTRE, SPECTRE_Q, SPECTRE_MAX, SPECTRE_TARGET = 32, 0.9, 0.5, 8.0


def _fluid_state(sp, n_mol, L, dtype, device, seed):
    """(params, state) of ``n_mol`` rigid ``sp`` molecules on a jittered
    cubic lattice in a cubic box of edge L (no framework)."""
    from mpmc_tpu_torch.state import build_system
    m = int(np.ceil(n_mol ** (1.0 / 3.0)))
    rng = np.random.default_rng(seed)
    ijk = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    ijk = ijk[rng.permutation(len(ijk))[:n_mol]]
    coms = (ijk + 0.5) * (L / m) + rng.uniform(-0.2, 0.2, (n_mol, 3))
    return build_system(
        np.eye(3) * L, species=(sp,), capacity=(n_mol,),
        initial_counts=(n_mol,),
        initial_pos={0: coms[:, None, :] + sp.pos[None]},
        dtype=getattr(torch, dtype), seed=seed, device=device)


def polar_fluid(dtype, device, seed=47):
    """(params, state, cfg, thermo) of the polar NPT fluid (N_FLUID polar
    H2 at FLUID_T and FLUID_P, Ewald, Thole on the centres)."""
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.constants import ATM2K_A3
    from mpmc_tpu_torch.models import systems
    L = ((N_FLUID + 1) * FLUID_T / (FLUID_P * ATM2K_A3)) ** (1.0 / 3.0)
    params, state = _fluid_state(systems.h2_bss3(), N_FLUID, L, dtype,
                                 device, seed)
    cfg = RunConfig(ensemble="npt", rd_potential="lj", coulomb="ewald",
                    ewald_kmax=5, polarization=True, ortho_box=True,
                    dtype=dtype, seed=seed)
    thermo = Thermo.make(temperature=FLUID_T, pressure=FLUID_P,
                         volume_probability=0.05, volume_change_factor=0.008,
                         move_factor=1.0, rot_factor=np.pi, n_species=1,
                         dtype=cfg.tdtype, device=device)
    return params, state, cfg, thermo


def drude_fluid(device, seed=53):
    """(params, state) of the cdvdw fluid: N_DRUDE H2 (h2_bss3) with
    omega DRUDE_OMEGA a.u. on the polarizable centre, at the polar NPT
    fluid's density, float64."""
    from mpmc_tpu_torch.constants import ATM2K_A3
    from mpmc_tpu_torch.models import systems
    sp = dataclasses.replace(systems.h2_bss3(),
                             omega=np.array([DRUDE_OMEGA, 0.0, 0.0]))
    L = ((N_DRUDE + 1) * FLUID_T / (FLUID_P * ATM2K_A3)) ** (1.0 / 3.0)
    return _fluid_state(sp, N_DRUDE, L, "float64", device, seed)


def _run_text_deck(device, name, params, state, species, text,
                   extended=False, flags=None):
    """``state`` written to ``name``.pqr (``flags``: {mol_name: flag}
    rewritten on its atom lines) and ``text`` run as a deck through
    run.run in a temporary directory, every launch count set to 0 just
    before and read just after.  Returns (Setup, averages, log text,
    launches)."""
    from mpmc_tpu_torch.io import input_script, pqr
    from mpmc_tpu_torch.mc import run
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pqr.write_state(f"{name}.pqr", params, state, species,
                            extended=extended)
            if flags:
                with open(f"{name}.pqr") as f:
                    lines = f.read().splitlines()
                for i, line in enumerate(lines):
                    t = line.split()
                    if t and t[0] == "ATOM" and t[3] in flags:
                        t[5] = flags[t[3]]
                        lines[i] = " ".join(t)
                with open(f"{name}.pqr", "w") as f:
                    f.write("\n".join(lines) + "\n")
            with open(f"{name}.inp", "w") as f:
                f.write(text + f"pqr_input {name}.pqr\n"
                        "pqr_restart restart.pqr\n")
            job = input_script.parse_file(f"{name}.inp")
            buf = io.StringIO()
            _reset_counts()
            su, avgs = run.run(job, log=buf, device=device)
            torch.cuda.synchronize(device)
            launches = _launch_counts()
            launches["mol_pair_grid"] = pk.mol_pair_chains.shared_launches
        finally:
            os.chdir(old)
    out = buf.getvalue()
    log("\n".join(out.splitlines()[-4:]))
    log(f"launches: {launches}")
    return su, avgs, out, launches


def _fluid_text(L, *lines):
    return "\n".join([f"basis1 {L!r} 0 0", f"basis2 0 {L!r} 0",
                      f"basis3 0 0 {L!r}", "seed 7", *lines]) + "\n"


def phase_thole_header(device, C=C_POLAR):
    """B5 over C chains with a header per chain: the polar NPT fluid's
    state rescaled into C cells (edges HEADER_SCALE[0] .. [1] of the box,
    each chain's centres of mass with it, as a volume move does), float64
    and float32, both modes, dense at each chain's derived rc and culled
    at rc = RC_CULL (each chain its own cell order and visit table).
    Checks: the launch with a [C, 20] header; a shared header equals that
    header repeated per chain bit for bit; each chain equals its lone
    launch in its own cell bit for bit; culled equals dense bit for bit;
    each chain within phase_thole_chains' tolerance of the plain version
    with a box per chain.  Float32 dipole times, per call and on the card
    alone, beside the same launch with one shared header, the plain
    version and the bound.  Returns the dipole mode's dense report."""
    from mpmc_tpu_torch.mc import metropolis, moves
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    rep = {"max_abs_err": 0.0, "tol_share": 0.0}
    f = torch.linspace(*HEADER_SCALE, C, dtype=torch.float64)
    for dtype in ("float64", "float32"):
        params, state, cfg, thermo = polar_fluid(dtype, device)
        state = metropolis.initialize(state, params, cfg, thermo)
        d_lnv = (3.0 * torch.log(f)).to(device=device, dtype=state.pos.dtype)
        pos, box = moves.scale_volume(state.pos.expand(C, -1, -1),
                                      state.box.expand(C, 3, 3), params,
                                      d_lnv)
        pos, box = pos.contiguous(), box.contiguous()
        lam, kind = cfg.polar_damp, cfg.polar_damp_type
        alive = state.atom_alive(params).expand(C, -1).contiguous()
        pol_ok = alive & (params.polar > 0)
        mu = torch.where(pol_ok[..., None], state.mu, 0.0).expand(
            C, -1, -1).contiguous()
        rc = pairs.derived_cutoff(box, cfg)
        rc14 = torch.full((C,), RC_CULL, dtype=box.dtype, device=device)
        mol = params.mol_id32.expand(C, -1).contiguous()
        q = params.charge.expand(C, -1).contiguous()
        for mode in ("dipole", "charge"):
            kern, one_fn, plain = (
                (tk.dipole_field_chains, tk.dipole_field,
                 tk.dipole_field_chains_plain) if mode == "dipole" else
                (tk.charge_field_chains, tk.charge_field,
                 tk.charge_field_chains_plain))
            ok, src = (pol_ok, mu) if mode == "dipole" else (alive, q)
            perm, _ = thole.cull_perm(pos, box, ok, rc14)
            srt = [thole._gather_sites(x, perm).contiguous()
                   for x in (pos, ok, src, mol)]
            visit = thole.cull_visit(srt[0], srt[1], box, rc14)
            cases = {"dense": ((pos, box, ok, src, mol, rc, lam, kind),
                               None),
                     f"rc{RC_CULL:g} culled": ((srt[0], box, *srt[1:], rc14,
                                                lam, kind), visit)}
            for label, (args, vis) in cases.items():
                before = kern.launches
                k = kern(*args, ortho=True, visit=vis)
                torch.cuda.synchronize(device)
                if kern.launches != before + 1:
                    raise AssertionError(f"B5 header {mode}: not one launch")
                if vis is not None and not torch.equal(
                        k, kern(*args, ortho=True)):
                    raise AssertionError(f"B5 header {mode} {dtype}: culled "
                                         "!= dense bit for bit")
                a = list(args)
                shared = kern(*(a[:1] + [a[1][0]] + a[2:5] + [a[5][0]]
                                + a[6:]), ortho=True, visit=vis)
                rept = kern(*(a[:1] + [a[1][0].expand(C, 3, 3).contiguous()]
                              + a[2:5] + [a[5][0].expand(C).contiguous()]
                              + a[6:]), ortho=True, visit=vis)
                if not torch.equal(shared, rept):
                    raise AssertionError(f"B5 header {mode} {dtype} {label}:"
                                         " a shared header is not the same "
                                         "header repeated, bit for bit")
                for c in range(C):
                    one = one_fn(args[0][c], box[c], args[2][c], args[3][c],
                                 args[4][c], args[5][c], lam, kind,
                                 ortho=True,
                                 visit=None if vis is None else vis[c])
                    if not torch.equal(k[c], one):
                        raise AssertionError(
                            f"B5 header {mode} {dtype} {label}: chain {c} is "
                            "not its lone launch in its own cell")
                a64 = tuple(x.double() if torch.is_tensor(x)
                            and x.is_floating_point() else x for x in args)
                p64 = plain(*a64, visit=vis).cpu()
                p32 = (plain(*args, visit=vis).double().cpu()
                       if dtype == "float32" else None)
                err = share = 0.0
                for c in range(C):
                    scale = float(p64[c].abs().max())
                    e = float((k[c].double().cpu() - p64[c]).abs().max())
                    tol = (1e-10 * scale if dtype == "float64" else
                           max(4.0 * float((p32[c] - p64[c]).abs().max()),
                               2e-6 * scale))
                    if not e <= tol:
                        raise AssertionError(
                            f"B5 header {mode} {dtype} {label}: chain {c} "
                            "disagrees with its plain version")
                    err, share = max(err, e), max(share, e / tol)
                log(f"B5 x C={C}, a header per chain ({mode} {dtype} "
                    f"{label}; cells {float(box[0, 0, 0]):.3f} .. "
                    f"{float(box[-1, 0, 0]):.3f} A): each chain its lone "
                    "launch bit for bit, a shared header its repeat bit for "
                    f"bit; |kernel - plain| {err:.3e} ({share:.3f} of the "
                    "tolerance)")
                if mode == "dipole":
                    rep["max_abs_err"] = max(rep["max_abs_err"], err)
                    rep["tol_share"] = max(rep["tol_share"], share)
                if dtype == "float64" or mode != "dipole" or vis is not None:
                    continue
                fplan = tk.plan_chains(box, args[5], lam, args[0].shape[1], C)
                b0, r0 = box[0], args[5][0]
                splan = tk.plan_chains(b0, r0, lam, args[0].shape[1], C)

                def call(p=fplan, a=args):
                    return kern(*a, ortho=True, plan=p)

                def call_shared(p=splan, a=args):
                    return kern(a[0], b0, *a[2:5], r0, *a[6:], ortho=True,
                                plan=p)

                ms, ms_s = time_calls(call, device), time_calls(call_shared,
                                                                device)
                dms = time_device(call, device, n=20)
                dms_s = time_device(call_shared, device, n=20)
                dms2 = time_device(call, device, n=20)
                pms = time_calls(lambda: plain(*args), device, n=3)
                n_eval = n_in = 0
                for c in range(C):
                    e_c, i_c = _b5_pairs(mode, args[0][c], box[c],
                                         args[2][c], args[4][c], args[5][c])
                    n_eval, n_in = n_eval + e_c, n_in + i_c
                ops = n_eval * OPS_B5_PAIR + n_in * OPS_B5_IN[mode]
                nbytes = _nbytes(*args[:5], fplan.scal, k)
                bound, by = _bound_ms(ops, nbytes)
                log(f"    f32 C={C} dipole dense, a header per chain: "
                    f"{ms:.4f} ms per call, {dms:.4f} / {dms2:.4f} ms on the "
                    f"card alone; one shared header (box of chain 0): "
                    f"{ms_s:.4f} ms per call, {dms_s:.4f} ms on the card "
                    f"alone; plain {pms:.3f} ms; bound {bound:.5f} ms ({by}; "
                    f"{n_eval} pairs evaluated, {n_in} inside rc)")
                rep.update(ms=ms, device_ms=dms, device_ms_repeat=dms2,
                           shared_ms=ms_s, shared_device_ms=dms_s,
                           plain_ms=pms, bound_ms=bound, bound_by=by,
                           pairs=n_eval, pairs_in=n_in)
    return rep


def phase_polar_npt(device, numsteps=300, c_steps=100):
    """Polar NPT at full width through run.run: the polar fluid (N_FLUID
    polarizable H2, 10,368 sites, 77 K, 200 atm) on the scan path (300
    steps) and as C_POLAR batched chains (100 steps), corrtime 100,
    volume_probability 0.05.  Each: the route (no fused kernel; the
    batched deck's B5 over the chains), steps/s, volume attempts and
    acceptances, <V> and its drift from the start, B2 == volume attempts
    x chains + refreshes, B5 launched in both modes; then a further chunk
    with volume moves at 0.25 (40 steps; chains 20) whose trace gives the
    CG iterations per volume attempt, and every chain's carried energy
    and polar term against a fresh recompute."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    params, state, _, _ = polar_fluid("float32", "cpu")
    L = float(state.box[0, 0])
    v0 = L ** 3
    launches, reps = {}, {}
    for label, extra, steps, C in (("npt_polar", "", numsteps, 1),
                                   (f"npt_polar_c{C_POLAR}",
                                    f"chains {C_POLAR}\n", c_steps,
                                    C_POLAR)):
        text = _fluid_text(L, f"numsteps {steps}", "temperature 77",
                           "move_factor 1.0", "rot_factor 3.14159") \
            + POLAR_NPT_LINES + extra
        with _VolumeCount() as vc:
            su, avgs, out, ln = _run_text_deck(device, "h2polar", params,
                                               state, ["H2"], text)
            att, acc = vc.attempts, vc.accepted()
        if "fused_mc" in out or (C > 1) != ("batched scan chains" in out):
            raise AssertionError(f"{label} did not take its route")
        rate = float(out.split("steps/sec:")[1].split()[0])
        refreshes = 1 + C * max(steps // 100, 1)
        vols = torch.abs(torch.linalg.det(
            (su.states if C > 1 else su.state).box.double()))
        drift = float(vols.mean()) / v0 - 1.0
        b5 = {m: ln[f"{m}_field"] + ln[f"{m}_field_chains"]
              for m in ("charge", "dipole")}
        log(f"{label}: {rate:.2f} steps/s" + (" aggregate" if C > 1 else "")
            + f", volume attempts {att} accepted {acc}, <V> "
            f"{avgs.mean('volume'):.1f} A^3 (start {v0:.1f}), final drift "
            f"{drift:+.3e}, displace acceptance "
            f"{avgs.mean('acc_displace'):.4f}, <polar> "
            f"{avgs.mean('energy_polar'):.2f} K, CG iterations per step "
            f"{avgs.mean('polar_iters_per_step'):.3f}; B5 launches {b5}")
        if not (att > 0 and acc > 0):
            raise AssertionError(f"{label}: {acc} of {att} volume attempts "
                                 "accepted")
        if ln["pair_terms"] != att + refreshes:
            raise AssertionError(f"{label}: B2 launched {ln['pair_terms']} "
                                 f"times, not {att} + {refreshes}")
        if not (b5["charge"] > 0 and b5["dipole"] > 0):
            raise AssertionError(f"{label}: B5 was not launched: {ln}")
        more = su.thermo.replace(volume_probability=torch.full_like(
            su.thermo.volume_probability, 0.25))
        g = torch.Generator(device=device).manual_seed(71)
        trace = []
        if C == 1:
            st, stats = metropolis.run_chunk(su.state, su.params, su.cfg,
                                             more, 40, generator=g)
            step, carry, cc, branch, stats = metropolis.chunk_setup(
                st, su.params, su.cfg, more, torch.rand(
                    (40, 16), generator=g, device=device))
            for k in range(40):
                step(carry, carry["u"][k], int(branch[k]), more, cc, stats,
                     trace)
            chains = [metropolis._from_carry(st, carry, 40)]
        else:
            sts, _ = multichain.run_chunk_batched(
                su.states, su.params, su.cfg, more, 20, generator=g,
                trace=trace)
            chains = [slice_chain(sts, c) for c in (0, C - 1)]
        vol = [r for r in trace if "box" in r]
        iters = [float(np.mean(r["iters"])) for r in vol]
        acc_v = [float(r["accept"].float().mean()) for r in vol]
        for i, st in enumerate(chains):
            _check_bookkeeping(f"{label} chain {i}", st, su, polar=True)
        rep = {"steps_per_sec": rate, "volume_attempts": att,
               "volume_accepted": acc, "mean_volume": avgs.mean("volume"),
               "volume_drift": drift,
               "cg_iters_per_step": avgs.mean("polar_iters_per_step"),
               "cg_iters_per_volume_attempt": float(np.mean(iters)),
               "trace_volume_acceptance": float(np.mean(acc_v)),
               "b5_launches": b5, "polar_K": avgs.mean("energy_polar")}
        log(f"{label}: " + json.dumps(rep))
        launches[label], reps[label] = ln, rep
    return launches, reps


def phase_cdvdw(device, numsteps=100):
    """Coupled-dipole vdW at the size users run: the Drude fluid (N_DRUDE
    sites with alpha and omega, a 1,536 x 1,536 eigensolve per trial),
    NVT at 77 K in float64, through run.run with cdvdw (cdvdw) and with
    cdvdw_sig_repulsion (cdvdw_sig: the plain tile pass, B2 and B4 refuse
    it).  Each: steps/s, the eigensolve's share of a step (vdw_energy
    timed alone on the host clock against the deck's ms per step), the
    carried energy after a further 20 steps against a fresh recompute
    (rel 1e-9, float64), and the card's vdw energy of the final state
    against the CPU's (rel 1e-9)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import vdw
    params, state = drude_fluid("cpu")
    L = float(state.box[0, 0])
    launches, reps = {}, {}
    for label, extra in (("cdvdw", ""),
                         ("cdvdw_sig", "cdvdw_sig_repulsion on\n")):
        text = _fluid_text(L, f"numsteps {numsteps}", "corrtime 50",
                           "ensemble nvt", "temperature 77",
                           "move_factor 1.0", "rot_factor 3.14159",
                           "precision float64", "ewald_kmax 5", "rd_lrc off",
                           "cdvdw on") + extra
        su, avgs, out, ln = _run_text_deck(device, "drude", params, state,
                                           ["H2"], text, extended=True)
        plain = "the plain tile pass" in out
        if plain != (label == "cdvdw_sig") or (
                (ln["pair_terms"] + ln["mol_pair"] > 0) == plain):
            raise AssertionError(f"{label}: not its pair route: {ln}")
        rate = float(out.split("steps/sec:")[1].split()[0])
        st = su.state
        alive = st.atom_alive(su.params)
        ms_vdw = statistics.median(1e3 * _clock_host(
            lambda: vdw.vdw_energy(st.pos, st.box, alive, su.params, su.cfg),
            device) for _ in range(5))
        g = torch.Generator(device=device).manual_seed(73)
        st2, stats = metropolis.run_chunk(st, su.params, su.cfg, su.thermo,
                                          20, generator=g)
        fresh = metropolis.initialize(st2, su.params, su.cfg, su.thermo)
        carried, full = float(st2.energy.total), float(fresh.energy.total)
        if not abs(carried - full) <= 1e-9 * max(abs(full), 1.0):
            raise AssertionError(f"{label}: carried {carried!r} fresh "
                                 f"{full!r}")
        cpu = _params_on(su.params)
        e_cpu = float(vdw.vdw_energy(st2.pos.cpu(), st2.box.cpu(),
                                     st2.atom_alive(su.params).cpu(), cpu,
                                     su.cfg))
        e_card = float(st2.energy.vdw)
        if not abs(e_card - e_cpu) <= 1e-9 * abs(e_cpu):
            raise AssertionError(f"{label}: vdw card {e_card!r} cpu "
                                 f"{e_cpu!r}")
        share = ms_vdw / (1e3 / rate)
        rep = {"steps_per_sec": rate, "vdw_ms": ms_vdw,
               "vdw_share_of_step": share, "vdw_K": avgs.mean("energy_vdw"),
               "rd_K": avgs.mean("energy_rd"),
               "acc_displace": avgs.mean("acc_displace"),
               "sites": int(su.params.vdw_sites.shape[0])}
        log(f"{label}: " + json.dumps(rep) + f"; bookkeeping carried "
            f"{carried:.9f} fresh {full:.9f}; vdw card {e_card:.9f} cpu "
            f"{e_cpu:.9f}")
        launches[label], reps[label] = ln, rep
    return launches, reps


# the fcc lattice sums of the LJ crystal (nearest-neighbour units)
A12_FCC, A6_FCC = 12.13188, 14.45392


def phase_rd_crystal(device, cells=4, order=3, numsteps=300):
    """rd_crystal on a small crystal cell, the case the option exists for:
    fcc argon, cells^3 unit cells (256 atoms, a = 5.26 A, a 21 A box
    where no legal cutoff holds the RD tail), order 3 (343 image shifts),
    NVT at 40 K in float64 through run.run.  Checks: the first block's
    energy per atom against the fcc lattice sum 2 eps [A12 (sig/r)^12 -
    A6 (sig/r)^6] (rel 2e-3: the perfect lattice at the start, one
    corrtime in), the card's image sum of the final state against the
    CPU's (rel 1e-10), the carried RD against a fresh recompute (rel
    1e-9) and the route's log line."""
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import crystal
    from mpmc_tpu_torch.state import build_system
    a = 5.26
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5]])
    ijk = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    sites = ((ijk[:, None, :] + basis[None]) * a).reshape(-1, 3)
    sp = systems.lj_atom(name="AR")
    L = cells * a
    params, state = build_system(
        np.eye(3) * L, species=(sp,), capacity=(len(sites),),
        initial_counts=(len(sites),), initial_pos={0: sites[:, None, :]},
        dtype=torch.float64, device="cpu")
    text = _fluid_text(L, f"numsteps {numsteps}", "corrtime 100",
                       "ensemble nvt", "temperature 40", "move_factor 0.1",
                       "rot_factor 0", "coulomb off", "precision float64",
                       "rd_crystal on", f"rd_crystal_order {order}")
    t0 = time.time()
    su, avgs, out, ln = _run_text_deck(device, "ar_fcc", params, state,
                                       ["AR"], text)
    wall = time.time() - t0
    if f"lattice sum (order {order}" not in out or su.cfg.rd_lrc:
        raise AssertionError("rd_crystal: not the image-sum route")
    rate = float(out.split("steps/sec:")[1].split()[0])
    from mpmc_tpu_torch.ops import energy as energy_mod
    x = (sp.sig[0] / (a / np.sqrt(2.0))) ** 6
    per_atom = 2.0 * sp.eps[0] * (A12_FCC * x * x - A6_FCC * x)
    e0, _ = energy_mod.total_energy(
        state.pos.to(device), state.box.to(device),
        state.mol_alive.to(device), su.params, su.cfg, su.thermo)
    first = float(e0.rd) / len(sites)
    st = su.state
    card = float(crystal.rd_crystal_full(st.pos, st.box,
                                         st.atom_alive(su.params), su.params,
                                         su.cfg, su.thermo.temperature))
    cpu_p = _params_on(su.params)
    cpu = float(crystal.rd_crystal_full(st.pos.cpu(), st.box.cpu(),
                                        st.atom_alive(su.params).cpu(),
                                        cpu_p, su.cfg,
                                        su.thermo.temperature.cpu()))
    log(f"rd_crystal: {rate:.2f} steps/s, the perfect lattice {first:.4f} "
        "K/atom "
        f"(fcc lattice sum {per_atom:.4f}), final image sum card "
        f"{card:.9f} cpu {cpu:.9f}, deck {wall:.1f} s; launches {ln}")
    if not abs(first / per_atom - 1.0) <= 2e-3:
        raise AssertionError("rd_crystal: the fcc energy is off the lattice "
                             "sum")
    if not abs(card - cpu) <= 1e-10 * abs(cpu):
        raise AssertionError("rd_crystal: card and CPU image sums differ")
    from mpmc_tpu_torch.mc import metropolis
    fresh = metropolis.initialize(st, su.params, su.cfg, su.thermo)
    if not abs(float(st.energy.rd) - float(fresh.energy.rd)) <= 1e-9 * abs(
            float(fresh.energy.rd)):
        raise AssertionError("rd_crystal: carried RD drifted")
    return ln, {"steps_per_sec": rate, "energy_per_atom": first,
                "lattice_sum_per_atom": per_atom,
                "acc_displace": avgs.mean("acc_displace")}


def phase_spectre(device, numsteps=300):
    """SPECTRE with S-flagged sites in the bench system: the 10.8k
    system plus N_SPECTRE free charges (+-SPECTRE_Q e on free interstitial
    sites, PQR flag S), NVT through run.run (DECK, corrtime 100) with
    spectre_max_charge SPECTRE_MAX and spectre_max_target SPECTRE_TARGET.
    Checks: the log names the sites, every block's max |q| <= the clamp
    and sum |q| = the target, B2 and B4 launched, the carried energy after
    a further chunk against a fresh recompute (the renormalized charges'
    S(k), self and frozen terms rebuilt by the refresh)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.state import Species, build_system
    params, state, cfg, _ = bench_system("float32", "cpu")
    h2 = systems.h2_bss3()
    sp = Species(name="SPC", atom_names=("SP",), pos=np.zeros((1, 3)),
                 mass=np.array([10.0]), charge=np.array([SPECTRE_Q]),
                 polar=np.zeros(1), eps=np.array([20.0]),
                 sig=np.array([3.0]))
    spacing = 4.0
    frozen = (params.mol_frozen[params.mol_id] & params.atom_ok).numpy()
    mov = (state.atom_alive(params).numpy() & ~frozen)
    fpos = state.pos.numpy()[frozen]
    ijk = np.stack(np.meshgrid(*[np.arange(N_SIDE)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    taken = {tuple(np.round(c / spacing - 1.0).astype(int))
             for c in state.pos.numpy()[mov][0::3]}
    free = [s for s in ijk if tuple(s) not in taken]
    rng = np.random.default_rng(5)
    pick = np.asarray(free)[rng.permutation(len(free))[:N_SPECTRE]]
    sp_pos = (pick + 1.0) * spacing
    h2_pos = state.pos.numpy()[mov].reshape(-1, 3, 3)
    signs = np.where(np.arange(N_SPECTRE) % 2 == 0, 1.0, -1.0)
    fp = {k: getattr(params, k).numpy()[frozen].astype(np.float64)
          for k in ("charge", "mass", "polar", "eps", "sig")}
    p2, s2 = build_system(
        state.box.numpy(), frozen_pos=fpos, frozen_params=fp,
        species=(h2, sp), capacity=(len(h2_pos), N_SPECTRE),
        initial_counts=(len(h2_pos), N_SPECTRE),
        initial_pos={0: h2_pos, 1: sp_pos[:, None, :]},
        dtype=torch.float32, device="cpu")
    q = p2.charge.numpy().copy()
    sp_rows = np.nonzero((p2.mol_species[p2.mol_id] == 1).numpy()
                         & p2.atom_ok.numpy())[0]
    q[sp_rows] = SPECTRE_Q * signs
    p2 = p2.replace(charge=torch.as_tensor(q))
    L = float(state.box[0, 0])
    text = (DECK.format(numsteps=numsteps, L=L).replace(
        "pqr_input bench10k.pqr\npqr_restart restart.pqr\n", "")
        + "ensemble nvt\ncorrtime 100\nspectre on\n"
        f"spectre_max_charge {SPECTRE_MAX}\n"
        f"spectre_max_target {SPECTRE_TARGET}\n")
    su, avgs, out, ln = _run_text_deck(device, "bench_spectre", p2, s2,
                                       ["H2", "SPC"], text,
                                       flags={"SPC": "S"})
    if f"spectre: {N_SPECTRE} free-charge sites" not in out:
        raise AssertionError("spectre: the sites were not found")
    if not (ln["pair_terms"] > 0 and ln["mol_pair"] > 0):
        raise AssertionError(f"spectre: a kernel was not launched: {ln}")
    mx = max(avgs.samples["spectre_max_abs_charge"])
    tot = avgs.samples["spectre_total_charge"]
    if not (mx <= SPECTRE_MAX + 1e-6
            and np.allclose(tot, SPECTRE_TARGET, rtol=1e-5)):
        raise AssertionError(f"spectre: max |q| {mx}, sum |q| {tot}")
    rate = float(out.split("steps/sec:")[1].split()[0])
    g = torch.Generator(device=device).manual_seed(79)
    st, _ = metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo,
                                 200, generator=g)
    _check_bookkeeping("spectre, 200 steps", st, su)
    rep = {"steps_per_sec": rate, "max_abs_charge": mx,
           "total_charge": float(np.mean(tot)),
           "acc_displace": avgs.mean("acc_displace")}
    log("spectre: " + json.dumps(rep))
    return ln, rep


def phase_qvib(device, numsteps=200):
    """quantum_vibration in the 10.8k H2 sorption deck (DECK, corrtime
    100, vib_omega H2_VIB): B4 at position stride 0 launched once per
    refresh for every H2's 225-point grid (the block keys qvib_zpe and
    qvib_fundamental_shift); the grid launch against its plain version on
    the same rows (f32 tolerance of _close); 4 molecules' levels on the
    card against the CPU float64 ones (rel 1e-4); the refresh's time with
    its B4 launch and host eigensolves apart; the ZPE within 5 % of hbar
    w / 2."""
    from mpmc_tpu_torch.ops import pairs, qvib
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    params, state, _, _ = bench_system("float32", "cpu")
    L = float(state.box[0, 0])
    text = (DECK.format(numsteps=numsteps, L=L).replace(
        "pqr_input bench10k.pqr\npqr_restart restart.pqr\n", "")
        + f"corrtime 100\nquantum_vibration on\nvib_omega {H2_VIB}\n")
    su, avgs, out, ln = _run_text_deck(device, "bench_qvib", params, state,
                                       ["H2"], text)
    blocks = numsteps // 100
    if ln["mol_pair_grid"] != blocks:
        raise AssertionError(f"qvib: {ln['mol_pair_grid']} stride-0 B4 "
                             f"launches for {blocks} refreshes")
    zpe = avgs.samples["qvib_zpe"]
    shift = avgs.samples["qvib_fundamental_shift"]
    hw = H2_VIB * qvib.CM1_K
    if not (len(zpe) == blocks and all(abs(z / (0.5 * hw) - 1.0) < 0.05
                                       for z in zpe)):
        raise AssertionError(f"qvib: ZPE {zpe} against hbar w / 2 "
                             f"{0.5 * hw}")
    st = su.state
    sp = su.species[0]
    s, b0, mu = qvib.stretch_geometry(sp)
    grid = np.concatenate([qvib.stretch_grid(b0, mu, hw), [b0]])
    mols = np.flatnonzero(st.mol_alive.cpu().numpy()
                          & (su.params.mol_species >= 0).cpu().numpy())
    alive = st.atom_alive(su.params)
    t = su.thermo.temperature
    v = qvib.external_potentials_on_grid(
        st.pos, st.box, alive, su.params, su.cfg, t, mols[:4], [s] * 4,
        [b0] * 4, [grid] * 4)
    rows = qvib.stretch_rows(st.pos, su.params, mols[:4], [s] * 4, [b0] * 4,
                             [grid] * 4).reshape(-1, su.params.mol_atoms
                                                 .shape[1], 3).contiguous()
    mt = torch.as_tensor(mols[:4], device=device).repeat_interleave(
        grid.shape[0])
    scal = pairs.pair_scalars(st.box, su.cfg)
    common = (su.params.charge, su.params.eps, su.params.sig,
              su.params.mol_id32)
    tail = (su.params.mol_atoms, su.params.mol_natoms, mt, rows, scal,
            su.cfg)
    k = pk.mol_pair_chains(st.pos, *common, alive, *tail)
    p = pk.mol_pair_chains_plain(st.pos, *common, alive, *tail)
    p64 = pk.mol_pair_chains_plain(
        st.pos.double(), *(x.double() for x in common[:3]), common[3],
        alive, *tail[:3], rows.double(), scal.double(), su.cfg)
    if not torch.equal(v.reshape(-1), k[:, 0] + pairs.KE * k[:, 1]):
        raise AssertionError("qvib: the grid is not the raw launch's")
    kd, pd = k.double().cpu().numpy(), p.double().cpu().numpy()
    gerr = np.abs(kd - pd)
    tol = _tol(torch.float32, p64.cpu().numpy(), pd)
    log(f"qvib grid, 4 molecules x {grid.shape[0]} bond lengths at stride 0:"
        f" |kernel - plain| {gerr[:, :3].max():.3e} (worst |d|/tol "
        f"{float(np.max(gerr / tol)):.3f})")
    if not np.all(gerr <= tol):
        raise AssertionError("qvib: the grid launch disagrees with plain")
    gerr = float(gerr[:, :3].max())
    cpu_p = _params_on(su.params, float64=True)
    cfg64 = dataclasses.replace(su.cfg, dtype="float64")
    err = 0.0
    for m in mols[:4]:
        lv, _ = qvib.vibrational_levels(st.pos, st.box, alive, su.params,
                                        su.cfg, t, int(m), sp)
        lc, _ = qvib.vibrational_levels(
            st.pos.double().cpu(), st.box.double().cpu(), alive.cpu(),
            cpu_p, cfg64, t.double().cpu(), int(m), sp)
        err = max(err, float(np.max(np.abs(lv / lc - 1.0))))
    if not err <= 1e-4:
        raise AssertionError(f"qvib: card levels off the CPU f64 ({err})")
    tb = statistics.median(1e3 * _clock_host(
        lambda: qvib.external_potentials_on_grid(
            st.pos, st.box, alive, su.params, su.cfg, t, mols,
            [s] * len(mols), [b0] * len(mols), [grid] * len(mols)), device)
        for _ in range(3))
    tr = statistics.median(1e3 * _clock_host(
        lambda: qvib.vibration_table(st.pos, st.box, alive, st.mol_alive,
                                     su.params, su.cfg, su.thermo,
                                     list(su.species)), device)
        for _ in range(3))
    rate = float(out.split("steps/sec:")[1].split()[0])
    rep = {"steps_per_sec": rate, "zpe_K": float(np.mean(zpe)),
           "fundamental_shift_K": float(np.mean(shift)),
           "molecules": int(len(mols)), "grid_launch_ms": tb,
           "refresh_ms": tr, "grid_max_abs_err": gerr,
           "levels_rel_err": err}
    log("qvib: " + json.dumps(rep))
    return ln, rep


def _rows_equal(a, b):
    """Two campaign rows equal, NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]) for k in a)



# ---------------------------------------------------------------------------
# cell_list, mol_cache, the surf drivers over B2 x C
# ---------------------------------------------------------------------------

# the cell_list decks' explicit cutoff, far below L/2 = 42 A
RC_CELL = 12.0
# B2 over a batch of geometries: a surf scan batch of dimers
C_SURF = 512
# the surf decks: the BSS H2 dimer in a 30 A cube, separations 2.5-8.0 A
SURF_BOX = 30.0
# 2.5-8.0 A by SURF_INC (cut from 0.25 A, 23 separations, for the time
# limit: the launches a separation and the output's rows are checked alike)
SURF_INC = 0.5
SURF_LINES = ("surf_min 2.5\nsurf_max 8.0\nsurf_inc " + f"{SURF_INC}"
              "\nsurf_decomp on\nsurf_output surf.dat\n")
# the polar surf scan's orientation grid (cut from 45 degrees: the SCF of
# 102,400 pairs a separation would take ~100 s)
SURF_ANG, SURF_ANG_POLAR = 45, 90
# the fits: an argon curve of 60 points, 256 H2 cluster configurations
FIT_POINTS, FIT_CONFIGS, FIT_CLUSTER = 60, 256, 4
FIT_LINES = "numsteps 2000\nfit_schedule 0.998\n"


def _dimer_system(dtype, device, n=2, seed=12, spread=None):
    """(params, state, cfg) of n BSS H2 molecules in a SURF_BOX cube (the
    surf decks' system), LJ + Ewald with the tail: two at (0, 0, 0) and
    (4, 0, 0); with ``spread`` a seeded cluster of n molecules within
    that radius."""
    from mpmc_tpu_torch.config import RunConfig
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.state import build_system
    sp = systems.h2_bss3()
    if spread is None:
        com = np.array([[0.0, 0, 0], [4.0, 0, 0]])
    else:
        com = _cluster_coms(np.random.default_rng(seed), n, spread)
    dt = torch.float64 if dtype == "float64" else torch.float32
    params, state = build_system(
        np.eye(3) * SURF_BOX, species=(sp,), capacity=(n,),
        initial_counts=(n,), initial_pos={0: com[:, None, :] + sp.pos},
        dtype=dt, device=device)
    return params, state, RunConfig(ensemble="surf", dtype=dtype)


def _cluster_coms(rng, n, spread, dmin=3.2):
    """n centres within ``spread`` of the origin, each pair >= dmin
    apart."""
    out = []
    while len(out) < n:
        p = rng.uniform(-spread, spread, 3)
        if np.linalg.norm(p) <= spread and all(
                np.linalg.norm(p - q) >= dmin for q in out):
            out.append(p)
    return np.array(out)


def _dimer_batch(params, state, C, seed=5):
    """C geometries of the dimer: separations 2.5-8.0 A, seeded
    orientations of both molecules ([C, N, 3])."""
    from mpmc_tpu_torch.mc import surface
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, C, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    dt, dev = state.pos.dtype, state.pos.device
    return surface.dimer_positions(
        params, state.pos, 0, 1,
        torch.as_tensor(rng.uniform(2.5, 8.0, C), dtype=dt, device=dev),
        torch.as_tensor(q[1], dtype=dt, device=dev),
        torch.as_tensor(q[0], dtype=dt, device=dev)).contiguous()


def _b2_shared(params, state, cfg):
    from mpmc_tpu_torch.ops import pairs
    return (params.charge, params.eps, params.sig, params.mol_id32,
            state.atom_alive(params), params.mol_frozen[params.mol_id],
            pairs.pair_scalars(state.box, cfg), cfg)


def phase_b2_chains(device, C=C_SURF):
    """B2 over a batch of geometries (pair_terms_chains): on C dimers in
    float64 and float32 every entry equal to the lone launch on its
    positions bit for bit, C = 1 equal to pair_terms, and the batch
    within B2's tolerance (_tol) of pair_terms_chains_plain; on two
    geometries of the 10.8k system at row_start F the same; times at C
    (per call, on the card alone, plain) beside a lone dimer launch, and
    the bound from this run's inputs."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    rep = {"max_abs_err": 0.0}
    ref = {}
    for dt in ("float64", "float32"):
        params, state, cfg = _dimer_system(dt, device)
        pos = _dimer_batch(params, state, C)
        sh = _b2_shared(params, state, cfg)
        k = pk.pair_terms_chains(pos, *sh)
        for c in range(C):
            if not torch.equal(k[c], pk.pair_terms(pos[c].contiguous(),
                                                   *sh)):
                raise AssertionError(f"B2 x C {dt}: entry {c} is not its "
                                     "lone launch bit for bit")
        if not torch.equal(pk.pair_terms_chains(pos[:1].contiguous(),
                                                *sh)[0],
                           pk.pair_terms(pos[0].contiguous(), *sh)):
            raise AssertionError(f"B2 x C {dt}: C = 1 is not pair_terms")
        p = pk.pair_terms_chains_plain(pos, *sh).double().cpu().numpy()
        kk = k.double().cpu().numpy()
        if dt == "float64":
            ref["dimer"] = p
            tol = _tol(torch.float64, p)
        else:
            tol = _tol(torch.float32, ref["dimer"], p)
            p = ref["dimer"]
        fin = np.isfinite(p)
        err = np.where(fin, np.abs(kk - p), 0.0)
        if not (np.array_equal(np.isfinite(kk), fin)
                and np.all(err <= tol)):
            raise AssertionError(f"B2 x C {dt}: disagrees with its plain "
                                 f"version at {np.argwhere(err > tol)[:4]}")
        rep["max_abs_err"] = max(rep["max_abs_err"], float(err.max()))
        log(f"B2 x C {dt} C={C} dimers: every entry its lone launch bit for "
            f"bit, C = 1 pair_terms; max |d| vs plain {err.max():.3e}")
        # the 10.8k system: its own geometry and a jittered one, row_start F
        bp, bs, bc, _ = bench_system(dt, device)
        two = torch.stack([bs.pos, systems.jittered(bp, bs, seed=4).pos])
        shb = _b2_shared(bp, bs, bc)
        rs = metropolis.frozen_refresh_rows(bp, bc)
        kb = pk.pair_terms_chains(two.contiguous(), *shb, row_start=rs)
        for c in range(2):
            lone = pk.pair_terms(two[c].contiguous(), *shb, row_start=rs)
            if not torch.equal(kb[c], lone):
                raise AssertionError(f"B2 x C {dt} 10.8k: entry {c} is not "
                                     "its lone launch bit for bit")
        pb = pk.pair_terms_chains_plain(two, *shb,
                                        row_start=rs).double().cpu().numpy()
        if dt == "float64":
            ref["bench"] = pb
            tol = _tol(torch.float64, pb)
        else:
            tol = _tol(torch.float32, ref["bench"], pb)
            pb = ref["bench"]
        err = np.abs(kb.double().cpu().numpy() - pb)
        if not np.all(err <= tol):
            raise AssertionError(f"B2 x C {dt} 10.8k disagrees with plain")
        log(f"B2 x C {dt} 10.8k C=2 row_start {rs}: bit for bit per entry, "
            f"max |d| vs plain {err.max():.3e}")
        if dt == "float32":
            ms = time_calls(lambda: pk.pair_terms_chains(pos, *sh), device)
            dms = time_device(lambda: pk.pair_terms_chains(pos, *sh), device)
            pms = time_calls(lambda: pk.pair_terms_chains_plain(pos, *sh),
                             device, n=3)
            one = pos[0].contiguous()
            lms = time_calls(lambda: pk.pair_terms(one, *sh), device)
            ldms = time_device(lambda: pk.pair_terms(one, *sh), device)
            # counted pairs of this run's inputs: every alive i < j pair
            alive = sh[4]
            na = int(alive.sum())
            n_pairs = C * na * (na - 1) // 2
            nbytes = (_nbytes(pos, *sh[:7]) + C * 9 * 4
                      + pk.work_list(pos.shape[1], 0, device).numel() * 4)
            bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4, nbytes)
            rep.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bound,
                       bound_by=by, lone_ms=lms, lone_device_ms=ldms,
                       pairs=n_pairs, bytes=nbytes)
            log(f"B2 x C f32 C={C} dimers: {ms:.4f} ms per call, {dms:.4f} "
                f"ms on the card alone ({1e3 * dms / C:.3f} us an entry); a "
                f"lone dimer launch {lms:.4f} / {ldms:.4f} ms; plain "
                f"{pms:.3f} ms; bound {bound:.6f} ms ({by}; {n_pairs} pairs "
                f"x {OPS_PAIR_B2B4}, {nbytes} bytes)")
    return rep


def _cache_gap(label, st, su):
    """The carried molecule-pair cache against a fresh pair_matrix (each
    matrix within 1e-4 of its largest entry: float32 partials summed in
    another order), and the carried energy against a fresh recompute."""
    from mpmc_tpu_torch.ops import pairs
    fresh = pairs.pair_matrix(st.pos, st.box, st.atom_alive(su.params),
                              su.params, su.cfg, su.thermo.temperature)
    for k, f in zip(("cache_rd", "cache_es", "cache_lrc"), fresh):
        gap = float((getattr(st, k) - f).abs().max())
        scale = max(float(f.abs().max()), 1.0)
        log(f"cache {label} {k}: max |carried - fresh| {gap:.3e} "
            f"(largest entry {scale:.3e})")
        if not gap <= 1e-4 * scale:
            raise AssertionError(f"{label}: the carried cache drifted from "
                                 "a fresh pair_matrix")
    _check_bookkeeping(label, st, su)


def phase_cell_list(device, scan_steps=500, chains=16, chain_steps=200,
                    fused_steps=1000):
    """``cell_list on`` at rc 12 on DECK: the index attached, the scan
    path (culled per-move pass, B4 never launched), ``chains 16``, and
    fused µVT with and without the option under rd_lrc off (the same
    trajectory: B1 reads no index; with the tail on, the reference's
    trap, CELL_LIST_FUSED_LRC_TRAP, is refused); bookkeeping after a further chunk; the culled pass's time
    beside B4's dense delta on the same system and cutoff, and the share
    of framework columns the cells cover."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import celllist, pairs
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    lines = f"cutoff {RC_CELL}\ncell_list on\n"
    reps, launches = {}, {}
    su, avgs, text, ln = _run_deck(device, lines + f"corrtime {scan_steps}\n",
                                   numsteps=scan_steps)
    ci = su.params.cell_index
    if ci is None or "cell_list: framework cell index" not in text:
        raise AssertionError("cell_list: no index attached on DECK")
    if ln["mol_pair"] or ln["mol_pair_chains"] or not ln["pair_terms"]:
        raise AssertionError(f"cell_list scan: B4 launched or B2 not: {ln}")
    g = torch.Generator(device=device).manual_seed(31)
    st, _ = metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo, 500,
                                 generator=g)
    _check_bookkeeping("cell_list scan, 500 steps", st, su)
    cover = ci.columns / ci.n_frozen
    # the culled pass against B4's dense delta: one H2's trial rows
    mol = torch.nonzero(st.mol_alive & ~su.params.mol_frozen)[0, 0]
    rows = st.pos[su.params.mol_atoms[mol]] + 0.5
    alive = st.atom_alive(su.params)
    dense = dataclasses.replace(su.cfg, cell_list=False)
    scal = pairs.pair_scalars(st.box, su.cfg)

    def culled():
        return pairs.mol_pair_pass(st.pos, st.box, alive, su.params, su.cfg,
                                   su.thermo.temperature, mol, row_pos=rows,
                                   scal=scal)

    def b4():
        return pairs.mol_pair_pass(st.pos, st.box, alive, su.params, dense,
                                   su.thermo.temperature, mol, row_pos=rows,
                                   scal=scal)
    # the two in float64 (float32 es_real nets terms of either sign): a
    # float64 copy of the system, its own index
    c64 = dataclasses.replace(su.cfg, dtype="float64")
    pos64, box64 = st.pos.double(), st.box.double()
    p64 = celllist.attach(_params_on(su.params.replace(cell_index=None),
                                     device, float64=True), pos64, box64,
                          c64)
    t64 = su.thermo.temperature.double()
    a, b = (pairs.mol_pair_pass(pos64, box64, alive, p64, cfg, t64, mol,
                                row_pos=rows.double(),
                                scal=pairs.pair_scalars(box64, cfg))
            for cfg in (c64, dataclasses.replace(c64, cell_list=False)))
    fields = ("rd", "es_real", "lrc_coeff", "min_r2")
    for f in fields:
        x, y = float(getattr(a, f)), float(getattr(b, f))
        if not abs(x - y) <= 1e-9 * max(abs(y), 1e-3):
            raise AssertionError(f"cell_list f64: culled {f} {x!r} vs B4 "
                                 f"{y!r}")
    # float32: the culled pass and B4 on the card, each against the float64
    # value within _tol's float32 rule (max of rel 2e-5, 4x the plain
    # float32 dense pass's distance from the float64 value, 1e-3 K), so
    # their gap is bounded by twice that
    ref = np.array([float(getattr(b, f)) for f in fields])
    pl = pairs.mol_pair_pass(
        st.pos.cpu(), st.box.cpu(), alive.cpu(),
        _params_on(su.params.replace(cell_index=None), "cpu"), dense,
        su.thermo.temperature.cpu(), mol.cpu(), row_pos=rows.cpu(),
        scal=pairs.pair_scalars(st.box.cpu(), dense))
    p32 = np.array([float(getattr(pl, f)) for f in fields])
    tol = _tol(torch.float32, ref, p32)
    c32 = np.array([float(getattr(culled(), f)) for f in fields])
    k32 = np.array([float(getattr(b4(), f)) for f in fields])
    d_c, d_k, gap = np.abs(c32 - ref), np.abs(k32 - ref), np.abs(c32 - k32)
    for i, f in enumerate(fields):
        log(f"cell_list f32 {f}: culled {c32[i]: .9e} B4 {k32[i]: .9e} "
            f"f64 {ref[i]: .9e}; |culled - B4| {gap[i]:.3e} (bound "
            f"{2 * tol[i]:.3e}), |culled - f64| {d_c[i]:.3e} |B4 - f64| "
            f"{d_k[i]:.3e} (tol {tol[i]:.3e}, plain f32 {abs(p32[i] - ref[i]):.3e})")
    if not (np.all(d_c <= tol) and np.all(d_k <= tol)):
        raise AssertionError("cell_list f32: the culled pass or B4 beyond "
                             "its float32 tolerance of the float64 value")
    reps["culled_f32"] = {"fields": fields, "gap": gap.tolist(),
                          "bound": (2 * tol).tolist(), "tol": tol.tolist(),
                          "culled_f64": d_c.tolist(), "b4_f64": d_k.tolist(),
                          "plain_f64": np.abs(p32 - ref).tolist()}
    # the culled pass is hundreds of launches: 2 calls stay inside the
    # card's queue of pending launches, so the host still queues ahead
    c_ms, c_dms = time_calls(culled, device), time_device(culled, device,
                                                          n=2)
    b_ms, b_dms = time_calls(b4, device), time_device(b4, device)
    reps["culled"] = {"ms": c_ms, "device_ms": c_dms, "b4_ms": b_ms,
                      "b4_device_ms": b_dms, "cover": cover,
                      "grid": ci.grid, "columns": ci.columns}
    log(f"cell_list rc {RC_CELL}: grid {ci.grid}, {ci.offsets.shape[0]} "
        f"cells x {ci.fw_pos.shape[1]} = {ci.columns} of {ci.n_frozen} "
        f"framework columns ({cover:.4f}); culled pass {c_ms:.4f} ms per "
        f"call, {c_dms:.4f} ms on the card alone; B4 dense {b_ms:.4f} / "
        f"{b_dms:.4f} ms")
    reps["scan"] = {"steps_per_sec": float(
        text.split("steps/sec:")[1].split()[0])}
    launches["scan"] = ln
    # chains: the culled pass over the chains
    suc, _, text, ln = _run_deck(device, lines + f"chains {chains}\n"
                                 "corrtime 100\n", numsteps=chain_steps,
                                 verbose=False)
    if "one culled cell-list pass over the chains" not in text or \
            ln["mol_pair_chains"]:
        raise AssertionError(f"cell_list chains: not the culled route {ln}")
    sts, _ = multichain.run_chunk_batched(suc.states, suc.params, suc.cfg,
                                          suc.thermo, 100, generator=g)
    for c in (0, chains - 1):
        _check_bookkeeping(f"cell_list c{chains} chain {c}, 100 steps",
                           slice_chain(sts, c), suc)
    reps["c16"] = {"steps_per_sec": float(
        text.split("steps/sec:")[1].split()[0])}
    launches["c16"] = ln
    # fused µVT with and without the option (rd_lrc off: with the tail
    # on, the reference's trap is refused): one trajectory
    try:
        metropolis.check_cell_list_fused(
            su.params, dataclasses.replace(su.cfg, fused_mc=True))
    except ValueError as err:
        if "fused_mc µVT under cell_list" not in str(err):
            raise
    else:
        raise AssertionError("fused µVT + cell_list + rd_lrc not refused")
    runs = {}
    for key, extra in (("fused", lines), ("fused_no_index",
                                          f"cutoff {RC_CELL}\n")):
        s, _, text, ln = _run_deck(device, extra + "fused_mc on\n"
                                   "rd_lrc off\n", numsteps=fused_steps,
                                   verbose=False)
        if "single-chain fused µVT kernel" not in text:
            raise AssertionError(f"{key}: not the fused µVT route")
        runs[key] = (s, text, ln)
    a, b = runs["fused"][0].state, runs["fused_no_index"][0].state
    if not (torch.equal(a.pos, b.pos) and torch.equal(a.mol_alive,
                                                      b.mol_alive)
            and float(a.energy.total) == float(b.energy.total)):
        raise AssertionError("fused µVT under cell_list left the trajectory "
                             "it runs without the option")
    log(f"cell_list fused µVT: {fused_steps} steps, the trajectory without "
        f"the option bit for bit (N {int(a.n_molecules(runs['fused'][0].params))},"
        f" U {float(a.energy.total):.6f} K)")
    reps["fused"] = {"steps_per_sec": float(
        runs["fused"][1].split("steps/sec:")[1].split()[0])}
    launches["fused"] = runs["fused"][2]
    return launches, reps


def phase_mol_cache(device, scan_steps=1000, chains=16, chain_steps=200):
    """DECK with RunConfig(mol_cache=True) (a library option, no deck
    keyword; M = 513, a 513 x 513 cache): the scan path (the partials
    replace B4; B2 still refreshes) and ``chains 16`` (a [16, 513, 513]
    cache); after each run and a further chunk the carried cache against
    a fresh pair_matrix and the carried energy against a recompute; the
    cache's build ms."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    reps, launches = {}, {}
    su, _, text, ln = _run_deck(device, numsteps=scan_steps,
                                cfg_kw={"mol_cache": True})
    if "mol_cache: the molecule-pair cache" not in text or ln["mol_pair"]:
        raise AssertionError(f"mol_cache scan: not the cache route {ln}")
    M = su.params.n_mols_max
    if tuple(su.state.cache_rd.shape) != (M, M):
        raise AssertionError("mol_cache: the cache is not [M, M]")
    _cache_gap("mol_cache scan", su.state, su)
    g = torch.Generator(device=device).manual_seed(37)
    st, _ = metropolis.run_chunk(su.state, su.params, su.cfg, su.thermo, 500,
                                 generator=g)
    _cache_gap("mol_cache scan + 500 steps", st, su)
    build_ms = 1e3 * _clock_host(lambda: pairs.pair_matrix(
        st.pos, st.box, st.atom_alive(su.params), su.params, su.cfg,
        su.thermo.temperature), device)
    reps["scan"] = {"steps_per_sec": float(
        text.split("steps/sec:")[1].split()[0]), "build_ms": build_ms, "M": M}
    launches["scan"] = ln
    suc, _, text, ln = _run_deck(device, f"chains {chains}\ncorrtime 100\n",
                                 numsteps=chain_steps, verbose=False,
                                 cfg_kw={"mol_cache": True})
    if tuple(suc.states.cache_rd.shape) != (chains, M, M) or \
            ln["mol_pair_chains"]:
        raise AssertionError(f"mol_cache chains: not [C, M, M] {ln}")
    sts, _ = multichain.run_chunk_batched(suc.states, suc.params, suc.cfg,
                                          suc.thermo, 100, generator=g)
    for c in (0, chains - 1):
        _cache_gap(f"mol_cache c{chains} chain {c}", slice_chain(sts, c), suc)
    reps["c16"] = {"steps_per_sec": float(
        text.split("steps/sec:")[1].split()[0])}
    launches["c16"] = ln
    log(f"mol_cache: M {M}, a pair_matrix {build_ms:.1f} ms; scan "
        f"{reps['scan']['steps_per_sec']:.2f} steps/s, c{chains} "
        f"{reps['c16']['steps_per_sec']:.2f} aggregate")
    return launches, reps


def _surf_run(device, text, files=None):
    """An ensemble surf* deck through run.run in a temporary directory
    (``files``: name -> text written beside it), every launch count set to
    0 just before and read just after: (result, log, launches, seconds,
    surf_output's text or None)."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, body in (files or {}).items():
                if callable(body):
                    body()
                else:
                    with open(name, "w") as f:
                        f.write(body)
            job = input_script.parse(text)
            buf = io.StringIO()
            _reset_counts()
            t0 = time.time()
            res = run.run(job, log=buf, device=device)
            torch.cuda.synchronize(device)
            secs = time.time() - t0
            ln = _launch_counts()
            out = (open("surf.dat").read() if os.path.exists("surf.dat")
                   else None)
        finally:
            os.chdir(old)
    return res, buf.getvalue(), ln, secs, out


def _write_dimer_pqr(path):
    from mpmc_tpu_torch.io import pqr
    params, state, _ = _dimer_system("float64", "cpu")
    pqr.write_state(path, params, state, ["H2"])


SURF_DECK = (f"ensemble surf\ntemperature 77\nbasis1 {SURF_BOX} 0 0\n"
             f"basis2 0 {SURF_BOX} 0\nbasis3 0 0 {SURF_BOX}\n"
             "pqr_input dimer.pqr\n")


def phase_surf(device):
    """The surf drivers on the card: the BSS H2 dimer scan (surf_ang 45:
    320 orientations each, 102,400 pairs, 200 launches of 512 a
    separation; 2.5-8.0 A by SURF_INC; surf_decomp), the same with
    polarization on (surf_ang 90: B5 over the batch in the SCF), an argon
    surf_fit of 60 analytic-LJ points from perturbed parameters (2,000 SA
    steps, one B2 x 60 launch each) and a surf_multi_fit of 256 four-H2
    cluster configurations with energies from the true parameters (one
    B2 x 256 launch a step): B2 x C launched once per batch or
    evaluation, never the lone B2, scans/s and SA steps/s, the minimum
    well of the scan, parameters recovered."""
    from mpmc_tpu_torch.mc import surface
    from mpmc_tpu_torch.ops import energy as energy_mod
    reps, launches = {}, {}
    dimer = {"dimer.pqr": lambda: _write_dimer_pqr("dimer.pqr")}
    seps = int(round((8.0 - 2.5) / SURF_INC)) + 1
    for key, extra, ang in (("surf", "", SURF_ANG),
                            ("surf_polar", "polarization on\n",
                             SURF_ANG_POLAR)):
        n_one = len(np.arange(0, 360 - 1e-9, ang)) ** 2 * len(
            np.arange(0, 180 + 1e-9, ang))
        batches = -(-n_one ** 2 // surface.BATCH)
        res, text, ln, secs, out = _surf_run(
            device, SURF_DECK + SURF_LINES + extra + f"surf_ang {ang}\n",
            dimer)
        if ln["pair_terms_chains"] != seps * batches or ln["pair_terms"]:
            raise AssertionError(f"{key}: B2 x C launched "
                                 f"{ln['pair_terms_chains']} times, want "
                                 f"{seps * batches} ({ln})")
        if extra and not ln["charge_field_chains"]:
            raise AssertionError(f"{key}: B5 over the batch not launched")
        if out is None or len(out.splitlines()) != seps + 1 or any(
                not np.isfinite(r["min"]) for r in res):
            raise AssertionError(f"{key}: surf_output malformed")
        best = min(res, key=lambda r: r["min"])
        reps[key] = {"seconds": secs, "separations": seps,
                     "pairs_per_sep": n_one ** 2,
                     "batches_per_sec": seps * batches / secs,
                     "geometries_per_sec": seps * n_one ** 2 / secs,
                     "well_r": best["r"], "well_min": best["min"]}
        launches[key] = ln
        log(f"{key}: {seps} separations x {n_one ** 2} orientation pairs in "
            f"{secs:.2f} s ({seps * batches / secs:.1f} B2 x "
            f"{surface.BATCH} batches/s); well {best['min']:.4f} K at {best['r']:.2f} A; "
            f"launches {ln}")
    # surf_fit: argon, 60 points of the analytic LJ, perturbed start
    eps_t, sig_t = 119.8, 3.405
    rs = 3.0 + 0.1 * np.arange(FIT_POINTS)
    curve = "\n".join(f"{r:.4f} {4 * eps_t * ((sig_t / r) ** 12 - (sig_t / r) ** 6):.8f}"
                      for r in rs)
    ar = ("ATOM 1 Ar AR 1 M 0.0 0.0 0.0 39.948 0.0 0.0 140.0 3.30\n"
          "ATOM 2 Ar AR 2 M 4.0 0.0 0.0 39.948 0.0 0.0 140.0 3.30\nEND\n")
    (res, chi2), text, ln, secs, _ = _surf_run(
        device, SURF_DECK.replace("ensemble surf", "ensemble surf_fit")
        .replace("dimer.pqr", "ar2.pqr") + FIT_LINES
        + "fit_input curve.dat\nfit_boltzmann_weight 500\n",
        {"ar2.pqr": ar, "curve.dat": curve})
    fit = res["type0"]
    _fit_check("surf_fit", fit, eps_t, sig_t, ln, 2001, text)
    reps["surf_fit"] = {"sa_steps_per_sec": 2001 / secs, "chi2": chi2,
                        "eps": fit["eps"], "sig": fit["sig"]}
    launches["surf_fit"] = ln
    # surf_multi_fit: 256 configurations of a four-H2 cluster
    params, state, cfg = _dimer_system("float32", device, n=FIT_CLUSTER,
                                       spread=4.0)
    rng = np.random.default_rng(7)
    from mpmc_tpu_torch.config import Thermo
    from mpmc_tpu_torch.utils import quaternion as quat
    coms = np.stack([_cluster_coms(rng, FIT_CLUSTER, 4.5)
                     for _ in range(FIT_CONFIGS)])
    q = rng.normal(size=(FIT_CONFIGS, FIT_CLUSTER, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tmpl = torch.as_tensor(params.species_pos[0][:3].cpu().numpy(),
                           dtype=torch.float64)
    xyz = (quat.rotate(tmpl[None, None].expand(FIT_CONFIGS, FIT_CLUSTER, 3,
                                               3),
                       torch.as_tensor(q)[:, :, None, :]).numpy()
           + coms[:, :, None, :]).reshape(FIT_CONFIGS, -1, 3)
    rows = torch.arange(3 * FIT_CLUSTER, device=device)
    pos = state.pos.expand(FIT_CONFIGS, -1, 3).clone()
    pos[:, rows] = torch.as_tensor(xyz, dtype=pos.dtype, device=device)
    thermo = Thermo.make(temperature=77.0, dtype=torch.float32,
                         device=device)
    e_true = energy_mod.total_energy_chains(
        pos, state.box, state.mol_alive, params, cfg,
        thermo).total.double().cpu().numpy()
    conf = "\n".join(f"E {e:.6f}\n" + "\n".join(
        f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in c)
        for e, c in zip(e_true, xyz))

    def start_pqr():       # the start: eps 15 % high, sig 4 % low
        from mpmc_tpu_torch.io import pqr
        pqr.write_state("cluster.pqr", params.replace(
            eps=params.eps * 1.15, sig=params.sig * 0.96), state, ["H2"])
    (res, chi2), text, ln, secs, _ = _surf_run(
        device, SURF_DECK.replace("ensemble surf", "ensemble surf_multi_fit")
        .replace("dimer.pqr", "cluster.pqr") + FIT_LINES
        + "fit_input configs.dat\n",
        {"configs.dat": conf, "cluster.pqr": start_pqr})
    fit = res["type0"]
    _fit_check("surf_multi_fit", fit, 34.2, 2.96, ln, 2001, text)
    reps["surf_multi_fit"] = {"sa_steps_per_sec": 2001 / secs, "chi2": chi2,
                              "eps": fit["eps"], "sig": fit["sig"]}
    launches["surf_multi_fit"] = ln
    return launches, reps


def _fit_check(label, fit, eps_t, sig_t, ln, evals, text):
    """A fit's parameters within 5 % (eps) and 2 % (sig) of the truth, one
    B2 x C launch per chi^2 evaluation (the start and every SA step)."""
    log(f"{label}: {text.strip().splitlines()[0]} -> eps {fit['eps']:.4f} "
        f"K (true {eps_t}), sig {fit['sig']:.4f} A (true {sig_t}); "
        f"launches {ln}")
    if ln["pair_terms_chains"] != evals or ln["pair_terms"]:
        raise AssertionError(f"{label}: {ln['pair_terms_chains']} B2 x C "
                             f"launches for {evals} evaluations")
    if not (abs(fit["eps"] / eps_t - 1) <= 0.05
            and abs(fit["sig"] / sig_t - 1) <= 0.02):
        raise AssertionError(f"{label}: parameters not recovered")


# ---------------------------------------------------------------------------
# Multi-device (A13): ranks of a torch.distributed group on the one card
# ---------------------------------------------------------------------------

# ranks of the gloo groups that share the card, the spatial µVT scan
# (steps, corrtime: two lockstep checks), the chain_devices decks' steps
MD_RANKS = 2
SPATIAL_STEPS, SPATIAL_CORRTIME = 200, 100
MD_MOVES = ("displace", "insert", "delete")   # metropolis.DISPLACE.. order
CHAIN_STEPS = 2000
# seconds a group of ranks may take before the phase fails
MD_TIMEOUT = 300
MD_TE = "ensemble te\nspatial_devices {D}\n"
MD_SCAN = "spatial_devices {D}\n"
MD_CHAINS = "fused_mc on\nchains 32\nchain_devices {D}\n"
MD_PT = PT_DECKS[0][2] + "chain_devices {D}\n"


def _md_decks(tmp, D=MD_RANKS):
    """The multi-device decks over ``D`` ranks, written into ``tmp`` beside
    the bench system's PQR (DECK's): te.inp, scan.inp, chains.inp and
    pt.inp."""
    from mpmc_tpu_torch.io import pqr
    params, state, _, _ = bench_system("float32", "cpu")
    pqr.write_state(os.path.join(tmp, "bench10k.pqr"), params, state,
                    ["H2"])
    L = float(state.box[0, 0])
    decks = {
        "te": DECK.format(numsteps=0, L=L) + MD_TE.format(D=D),
        "scan": DECK.format(numsteps=SPATIAL_STEPS, L=L).replace(
            "corrtime 1000", f"corrtime {SPATIAL_CORRTIME}")
        + MD_SCAN.format(D=D),
        "chains": DECK.format(numsteps=CHAIN_STEPS, L=L)
        + MD_CHAINS.format(D=D),
        "pt": DECK.format(numsteps=CHAIN_STEPS, L=L) + MD_PT.format(D=D)}
    for k, text in decks.items():
        with open(os.path.join(tmp, f"{k}.inp"), "w") as f:
            f.write(text)


def _md_launch(mode, world, tmp, backend="gloo"):
    """Start ``world`` ranks of ``chip_smoke.py --md-rank <mode>`` (one
    gloo or NCCL group at a free local port, cwd ``tmp``), wait for all,
    and return each rank's result (a JSON file); a rank that fails or
    runs past MD_TIMEOUT fails the phase with its output's end."""
    return _md_wait(_md_start(mode, world, tmp, backend), f"{mode} ranks")


def _md_start(mode, world, tmp, backend="gloo"):
    """_md_launch's processes, started: [(process, log, result path)]."""
    from mpmc_tpu_torch.parallel import multihost
    port = multihost.free_port()
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"{mode}_{r}.json")
        logf = open(os.path.join(tmp, f"{mode}_{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--md-rank", mode,
             str(r), str(world), str(port), out, backend], cwd=tmp,
            stdout=logf, stderr=subprocess.STDOUT), logf, out))
    return procs


def _md_wait(procs, what):
    """Wait for (process, log file, result path or None) entries; kill
    them all and fail if one fails or MD_TIMEOUT passes."""
    t_end = time.time() + MD_TIMEOUT
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    bad = [(i, p.returncode) for i, (p, _, _) in enumerate(procs)
           if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- {what} {i} (rc {rc}):\n" + open(
            procs[i][1].name).read()[-3000:] for i, rc in bad)
        raise AssertionError(f"{what} failed: {bad}\n{tails}")
    return [json.load(open(out)) if out else None for _, _, out in procs]


def md_rank(mode, rank, world, port, out, backend):
    """A child rank (``chip_smoke.py --md-rank``): join the group, run
    ``mode``'s body on this rank's device, write its result as JSON."""
    sys.path.insert(0, REPO)
    from mpmc_tpu_torch.parallel import multihost
    dev = multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                               backend=backend)
    try:
        res = {"spatial": _md_spatial_rank, "te1": _md_te1_rank,
               "chains": _md_chains_rank}[mode](dev)
        torch.cuda.synchronize(dev)
    finally:
        multihost.teardown()
    with open(out, "w") as f:
        json.dump(res, f)


def _md_strip_checks(dev, d, D):
    """This rank's strips against their plain versions on the card: B2 on
    row tiles I mod D == d of the bench system (row_start 0), B4 on the
    column strip d of D (and, on rank 0, the full range [0, N) bit for
    bit the launch without a range), B5 (dipole mode) with the strip's
    visit table on the polar bench system (the other rows exact zeros);
    float32 against the plain float64, _tol's and phase_thole_kernel's
    rules.  Times per call (CUDA events) while the other ranks time
    theirs: two ranks on one card."""
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    rep, strip = {}, (d, D)
    sys32 = bench_system("float32", dev)
    sys64 = bench_system("float64", dev)

    def b2_args(s):
        params, state, cfg, _ = s
        return (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, state.atom_alive(params),
                params.mol_frozen[params.mol_id],
                pairs.pair_scalars(state.box, cfg), cfg)

    a32, a64 = b2_args(sys32), b2_args(sys64)
    k = pk.pair_terms(*a32, strip=strip).double().cpu().numpy()
    p64 = pk.pair_terms_plain(*a64, strip=strip).cpu().numpy()
    p32 = pk.pair_terms_plain(*a32, strip=strip).double().cpu().numpy()
    fin = np.isfinite(p64)
    tol = _tol(torch.float32, p64, p32)
    err = np.abs(k - p64)
    if not (np.all(err[fin] <= tol[fin])
            and np.array_equal(np.isfinite(k), fin)):
        raise AssertionError(f"B2 strip {strip} disagrees with its plain "
                             f"version: {err} tol {tol}")
    alive = a32[5].cpu().numpy()
    rows = pk.strip_rows(len(alive), 0, strip)
    idx = np.flatnonzero(alive)
    above = len(idx) - np.searchsorted(idx, rows, side="right")
    n_pairs = int(np.sum(above[alive[rows]]))
    bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4, _nbytes(*a32[:8]) + 36)
    rep["pair_terms_strip"] = dict(
        max_abs_err=float(err[fin].max()),
        ms=time_calls(lambda: pk.pair_terms(*a32, strip=strip), dev),
        device_ms=time_device(lambda: pk.pair_terms(*a32, strip=strip), dev,
                              n=50),
        plain_ms=time_calls(lambda: pk.pair_terms_plain(*a32, strip=strip),
                            dev, n=3),
        full_ms=time_calls(lambda: pk.pair_terms(*a32), dev),
        bound_ms=bound, bound_by=by, pairs=n_pairs,
        tiles=pk.work_list(len(alive), 0, dev, strip).numel(),
        tiles_full=pk.work_list(len(alive), 0, dev).numel())
    # B4: an alive H2's current rows against the column strip
    params, state, cfg, _ = sys32
    h2 = int(np.flatnonzero((params.mol_species >= 0).cpu().numpy()
                            & state.mol_alive.cpu().numpy())[0])

    def m_args(s):
        params, state, cfg, _ = s
        return (state.pos, params.charge, params.eps, params.sig,
                params.mol_id32, state.atom_alive(params), params.mol_atoms,
                params.mol_natoms, torch.tensor(h2, device=dev), None,
                pairs.pair_scalars(state.box, cfg), cfg)

    m32, m64 = m_args(sys32), m_args(sys64)
    n = len(alive)
    cols = pk.strip_cols(n, strip)
    ranges = [cols] + ([(0, n)] if d == 0 else [])
    for cr in ranges:
        k = pk.mol_pair(*m32, cols=cr).double().cpu().numpy()
        p64 = pk.mol_pair_plain(*m64, cols=cr).cpu().numpy()
        p32 = pk.mol_pair_plain(*m32, cols=cr).double().cpu().numpy()
        tol = _tol(torch.float32, p64, p32)
        err = np.abs(k - p64)
        fin = np.isfinite(p64)
        if not (np.all(err[fin] <= tol[fin])
                and np.array_equal(np.isfinite(k), fin)):
            raise AssertionError(f"B4 columns {cr} disagree with the plain "
                                 f"version: {err} tol {tol}")
        if cr == (0, n):
            if not torch.equal(pk.mol_pair(*m32, cols=cr),
                               pk.mol_pair(*m32)):
                raise AssertionError("B4 over the full range [0, N) is not "
                                     "the launch without a range, bit for "
                                     "bit")
            rep["mol_pair_full_range_bits"] = True
            continue
        own = (params.mol_id == h2).cpu().numpy()
        n_cols = int(np.sum(alive[cr[0]:cr[1]] & ~own[cr[0]:cr[1]]))
        n_pairs = int(params.mol_natoms[h2]) * n_cols
        sub = [t[cr[0]:cr[1]] if torch.is_tensor(t) and t.ndim
               and t.shape[0] == n else t for t in m32[:8]]
        bound, by = _bound_ms(n_pairs * OPS_PAIR_B2B4,
                              _nbytes(*sub, m32[10]) + 16)
        rep["mol_pair_cols"] = dict(
            max_abs_err=float(err[fin].max()), cols=list(cr),
            ms=time_calls(lambda: pk.mol_pair(*m32, cols=cr), dev),
            device_ms=time_device(lambda: pk.mol_pair(*m32, cols=cr), dev,
                                  n=200),
            full_ms=time_calls(lambda: pk.mol_pair(*m32), dev),
            plain_ms=time_calls(lambda: pk.mol_pair_plain(*m32, cols=cr),
                                dev),
            bound_ms=bound, bound_by=by, pairs=n_pairs,
            plan=pk.mol_pair_plan(cr[1] - cr[0], 1, False, torch.float32,
                                  cfg))
    # B5, both modes, over the strip's row tiles: the charge mode is the
    # sharded static field, the dipole mode every sharded matvec
    for mode, kern, plain in (("dipole", tk.dipole_field,
                               tk.dipole_field_plain),
                              ("charge", tk.charge_field,
                               tk.charge_field_plain)):
        out = {}
        for dtype in ("float64", "float32"):
            params, state, cfg, _ = bench_system(dtype, dev,
                                                 polarization=True)
            alive = state.atom_alive(params)
            pol_ok = alive & (params.polar > 0)
            if mode == "dipole":
                g = np.random.default_rng(91)
                src = torch.as_tensor(g.normal(size=(len(alive), 3)) * 0.05,
                                      dtype=state.pos.dtype, device=dev)
                site_ok, src = pol_ok, torch.where(pol_ok[:, None], src, 0.0)
            else:
                site_ok, src = alive, params.charge
            _, ni, nj = tk.grid_shape(len(alive))
            visit = ((torch.arange(ni, device=dev) % D) == d)[:, None].expand(
                ni, nj).to(torch.int32).contiguous()
            args = (state.pos, state.box, site_ok, src, params.mol_id32,
                    pairs.derived_cutoff(state.box, cfg), cfg.polar_damp,
                    cfg.polar_damp_type)
            out[dtype] = (args, kern(*args, ortho=True, visit=visit), visit)
        (a64, _, _), (a32, k, visit) = out["float64"], out["float32"]
        rows_in = (torch.arange(k.shape[0], device=dev) // tk.TI % D) == d
        if bool((k[~rows_in] != 0).any()):
            raise AssertionError(f"B5 {mode} strip: a row outside the strip "
                                 "is not exactly zero")
        p64 = plain(*a64, ortho=True, visit=visit).cpu()
        p32 = plain(*a32, ortho=True, visit=visit).double().cpu()
        scale = float(p64.abs().max())
        err = float((k.double().cpu() - p64).abs().max())
        tol = max(4.0 * float((p32 - p64).abs().max()), 2e-6 * scale)
        if not err <= tol:
            raise AssertionError(f"B5 {mode} strip {strip} disagrees with "
                                 f"its plain version: {err} > {tol}")
        fplan = tk.plan(a32[1], a32[5], a32[6], k.shape[0], visit)
        n_eval, n_in = _b5_pairs(mode, a32[0], a32[1], a32[2], a32[4],
                                 a32[5], visit)
        bound, by = _bound_ms(n_eval * OPS_B5_PAIR + n_in * OPS_B5_IN[mode],
                              _nbytes(*a32[:5], fplan.scal, visit, k))
        rep[f"{mode}_field_strip"] = dict(
            max_abs_err=err, tol=tol,
            ms=time_calls(lambda: kern(*a32, ortho=True, visit=visit,
                                       plan=fplan), dev),
            device_ms=time_device(lambda: kern(
                *a32, ortho=True, visit=visit, plan=fplan), dev, n=50),
            full_ms=time_calls(lambda: kern(*a32, ortho=True), dev),
            plain_ms=time_calls(lambda: plain(*a32, ortho=True, visit=visit),
                                dev, n=3),
            bound_ms=bound, bound_by=by, pairs=n_eval, pairs_in=n_in)
    return rep


def _md_spatial_rank(dev):
    """A rank of phase_spatial: (a) te.inp through run.run (the sharded
    te), its B2 strip launches and tiles; (b) the polar bench system's
    sharded total energy (the polar term, CG iterations, mu saved for
    the parent); (c) scan.inp (spatial µVT, SPATIAL_STEPS steps) through
    run.run, then a further chunk's carried energy against a fresh
    sharded recompute, the ranks' digests compared; the strip checks."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from mpmc_tpu_torch.parallel import multihost, spatial
    d, D = multihost.rank(), multihost.world()
    res = {"rank": d}
    _reset_counts()
    multihost.reset_counts()
    t0 = time.time()
    job = input_script.parse_file("te.inp")
    e = run_mod.run(job, log=io.StringIO(), device=dev)
    torch.cuda.synchronize(dev)
    res["te"] = {k: float(v) for k, v in e.as_dict().items()}
    res["te_seconds"] = time.time() - t0
    n = int(run_mod.setup(job, device="cpu").params.mol_id.shape[0])
    res["te_b2"] = {"launches": pk.pair_terms.launches,
                    "strip_launches": pk.pair_terms.strip_launches,
                    "tiles": len(pk.strip_tiles(n, 0, (d, D))),
                    "tiles_full": len(pk.strip_tiles(n, 0)),
                    "collectives": dict(multihost.counts)}
    # (b) the polar bench system's sharded total energy
    params, state, cfg, thermo = bench_system("float32", dev,
                                              polarization=True)
    _reset_counts()
    multihost.reset_counts()
    e, aux = spatial.total_energy_sharded(state.pos, state.box,
                                          state.mol_alive, params, cfg,
                                          thermo)
    torch.cuda.synchronize(dev)
    torch.save(aux["mu"].cpu(), f"mu_{d}.pt")
    res["polar"] = {"polar": float(e.polar), "iters": int(aux["polar_iters"]),
                    "launches": _launch_counts(),
                    "collectives": dict(multihost.counts)}
    # (c) the spatial µVT scan through run.run
    _reset_counts()
    buf = io.StringIO()
    su, avgs = run_mod.run(input_script.parse_file("scan.inp"), log=buf,
                           device=dev)
    torch.cuda.synchronize(dev)
    text = buf.getvalue()
    res["scan"] = {"launches": _launch_counts(),
                   "b2_strip": pk.pair_terms.strip_launches,
                   "b4_strip": pk.mol_pair.strip_launches,
                   "steps_per_sec": float(text.split("steps/sec:")[1]
                                          .split()[0]),
                   "collectives_line": text.split("spatial MC:")[1]
                   .splitlines()[0].strip(), "N": avgs.mean("N"),
                   "acc": {k: avgs.mean(f"acc_{k}") for k in MD_MOVES},
                   "log_tail": text.splitlines()[-4:]}
    g = torch.Generator(device=dev).manual_seed(17)
    st, stats = spatial.run_chunk_spatial(su.state, su.params, su.cfg,
                                          su.thermo, SPATIAL_CORRTIME,
                                          generator=g)
    stats = stats.host()
    res["scan"]["chunk_accepts"] = stats.accepts[:3].tolist()
    res["scan"]["chunk_attempts"] = stats.attempts[:3].tolist()
    fresh = spatial.initialize_spatial(st, su.params, su.cfg, su.thermo)
    spatial.check_lockstep(st, "phase_spatial carried")
    spatial.check_lockstep(fresh, "phase_spatial fresh")
    res["scan"]["carried"] = float(st.energy.total)
    res["scan"]["fresh"] = float(fresh.energy.total)
    res["strips"] = _md_strip_checks(dev, d, D)
    return res


def _md_te1_rank(dev):
    """phase_spatial (d): the bench system's sharded total energy at world
    size 1 (the group's backend: NCCL)."""
    from mpmc_tpu_torch.parallel import spatial
    params, state, cfg, thermo = bench_system("float32", dev)
    e, _ = spatial.total_energy_sharded(state.pos, state.box,
                                        state.mol_alive, params, cfg, thermo)
    return {k: float(v) for k, v in e.as_dict().items()}


def _md_chunk_thermo(job, thermo, C):
    """(the Thermo, the steps) of a chain_devices deck's first chunk, as
    run_mc_chains (corrtime, the shared Thermo) or run_mc_pt (ptemp_freq
    at most corrtime, the ladder's Thermo) takes it."""
    from mpmc_tpu_torch.parallel import replica
    corr = max(job.cfg.corrtime, 1)
    if not job.parallel_tempering:
        return thermo, corr
    ladder = replica.geometric_ladder(
        job.temperature, job.max_temperature or 2.0 * job.temperature, C)
    return (replica.stack_thermo(thermo, ladder),
            max(min(job.ptemp_freq, corr), 1))


def _md_first_chunk(job, dev):
    """The first chunk of a chain_devices deck as its driver takes it on
    this rank (multichain.ChainBlock over the deck's route, the run's
    generator): this block's positions and energies, saved for the
    parent's single-process launch at the same shape."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.parallel import multichain
    su = run_mod.setup(job, device=dev)
    cfg, params, thermo = su.cfg, su.params, su.thermo
    state = metropolis.initialize(su.state, params, cfg, thermo)
    pt = job.parallel_tempering
    C = job.n_replicas if pt else job.chains
    blk = multichain.ChainBlock(C, job.chain_devices, device=dev)
    chunk, fused = run_mod._chains_route(
        cfg, params, state.mol_alive, C,
        types.SimpleNamespace(log=io.StringIO()))
    thermo, n = _md_chunk_thermo(job, thermo, C)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    loc, _ = blk.chunk(chunk, blk.local(multichain.stack_states(state, C)),
                       params, cfg, thermo, n, gen)
    torch.save({"pos": loc.pos.cpu(), "energy": loc.energy.total.cpu()},
               f"first_{'pt' if pt else 'chains'}_{blk.lo}.pt")
    return {"fused": fused, "lo": blk.lo, "hi": blk.hi, "steps": n}


def _md_chains_rank(dev):
    """A rank of phase_chain_devices: the first chunk of chains.inp and of
    pt.inp as their drivers take them (_md_first_chunk), then both decks
    through run.run (pt.inp with a JSONL stream on rank 0), the rates,
    launches and the final ladder."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.parallel import multihost
    res = {}
    for name in ("chains", "pt"):
        job = input_script.parse_file(f"{name}.inp")
        res[f"{name}_first"] = _md_first_chunk(job, dev)
        _reset_counts()
        buf = io.StringIO()
        su, avgs = run_mod.run(
            job, log=buf, device=dev,
            jsonl_path=("pt_ranks.jsonl" if name == "pt"
                        and multihost.is_root() else None))
        torch.cuda.synchronize(dev)
        text = buf.getvalue()
        res[name] = {"launches": _launch_counts(),
                     "steps_per_sec": float(text.split("steps/sec:")[1]
                                            .split()[0]),
                     "N": avgs.mean("N"), "log_tail": text.splitlines()[-3:]}
        if name == "pt":
            res[name]["ladder"] = su.thermo.temperature.double().cpu() \
                .tolist()
    return res


def _md_single_first(tmp, name, dev, D=MD_RANKS):
    """Each rank's block of ``name``.inp's first chunk, launched in this
    process at the rank's shape (C/D chains, its rows of the run's
    uniform table, the batched route's move types from global chain 0),
    against the block the rank saved: bit for bit."""
    from mpmc_tpu_torch.io import input_script
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import chain_block
    old = os.getcwd()
    os.chdir(tmp)
    try:
        job = input_script.parse_file(f"{name}.inp")
        su = run_mod.setup(job, device=dev)
    finally:
        os.chdir(old)
    cfg, params, thermo = su.cfg, su.params, su.thermo
    state = metropolis.initialize(su.state, params, cfg, thermo)
    pt = job.parallel_tempering
    C = job.n_replicas if pt else job.chains
    chunk, _ = run_mod._chains_route(
        cfg, params, state.mol_alive, C,
        types.SimpleNamespace(log=io.StringIO()))
    thermo, n = _md_chunk_thermo(job, thermo, C)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    u = torch.rand((C, n, metropolis.N_LANES), generator=gen,
                   dtype=cfg.tdtype, device=dev)
    stack = multichain.stack_states(state, C)
    per = C // D
    for d in range(D):
        lo, hi = d * per, (d + 1) * per
        kw = ({"branch_u": u[0]} if chunk is multichain.run_chunk_batched
              else {})
        loc, _ = chunk(chain_block(stack, lo, hi), params, cfg,
                       multichain.thermo_block(thermo, lo, hi, C), n,
                       uniforms=u[lo:hi], **kw)
        got = torch.load(os.path.join(tmp, f"first_{name}_{lo}.pt"))
        same = (torch.equal(got["pos"], loc.pos.cpu())
                and torch.equal(got["energy"], loc.energy.total.cpu()))
        log(f"    {name}: rank {d}'s chains [{lo}, {hi}) after the first "
            f"chunk ({n} steps) {'equal' if same else 'DIFFER FROM'} this "
            "process's launch at C = {0} bit for bit".format(per))
        if not same:
            raise AssertionError(f"{name}: rank {d}'s chains differ from "
                                 "the single-process launch of its block")


def phase_spatial(device, smi):
    """spatial_devices over MD_RANKS gloo ranks sharing the one card
    (every time here is of ranks that share it: the route, not the
    scaling): (a) ensemble te on DECK, each term against the single-rank
    te by phase_energy's rule (rel 1e-5, 1e-2 K, or 4x the plain f32
    distance); (b) the polar bench system's sharded energy, the polar
    term within _polar_tol of the single-rank solve, CG iterations beside
    the single-rank count; (c) a spatial µVT scan of SPATIAL_STEPS steps
    on DECK (the ranks' digests equal at every block, or the run stops),
    a further chunk's carried energy against a fresh recompute at rel
    1e-4, steps/s and collectives a step; (d) (a) at world size 1 on NCCL
    (its process beside the gloo ranks).
    Each rank's strips against their plain versions (_md_strip_checks).
    Returns (launches of the strip forms on the main path, report)."""
    from mpmc_tpu_torch.mc import run as run_mod
    from mpmc_tpu_torch.ops import energy
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        _md_decks(tmp)
        t0 = time.time()
        # (d) beside the two gloo ranks: its own group (NCCL, world 1)
        te1_procs = _md_start("te1", 1, tmp, backend="nccl")
        ranks = _md_launch("spatial", MD_RANKS, tmp)
        te1 = _md_wait(te1_procs, "te1 rank")[0]
        rep["seconds"] = time.time() - t0
        # the single-rank references, in this process
        from mpmc_tpu_torch.io import input_script
        old = os.getcwd()
        os.chdir(tmp)
        try:
            job = input_script.parse_file("te.inp")
            single = run_mod.run(dataclasses.replace(job, spatial_devices=0),
                                 log=io.StringIO(), device=device)
        finally:
            os.chdir(old)
        mu = [torch.load(os.path.join(tmp, f"mu_{d}.pt"))
              for d in range(MD_RANKS)]
    ref = {k: float(v) for k, v in single.as_dict().items()}
    for label, got in [(f"rank {r['rank']}", r["te"]) for r in ranks] + [
            ("world 1 NCCL", te1)]:
        for k, want in ref.items():
            tol = max(1e-5 * abs(want), 1e-2)
            log(f"    spatial te {label} {k:9s} {got[k]: .8e} single "
                f"{want: .8e} |d| {abs(got[k] - want):.3e} tol {tol:.3e}")
            if not abs(got[k] - want) <= tol:
                raise AssertionError(f"spatial te ({label}) term {k} "
                                     "disagrees with the single-rank te")
    for r in ranks:
        log(f"spatial te rank {r['rank']}: B2 {r['te_b2']['launches']} "
            f"launches ({r['te_b2']['strip_launches']} on its strip), "
            f"{r['te_b2']['tiles']} of {r['te_b2']['tiles_full']} tiles; "
            f"collectives {r['te_b2']['collectives']}; "
            f"{r['te_seconds']:.2f} s")
    # (b) the polar term and the dipoles against one rank's solve
    params, state, cfg, thermo = bench_system("float32", device,
                                              polarization=True)
    e, aux = energy.total_energy(state.pos, state.box, state.mol_alive,
                                 params, cfg, thermo)
    tol = _polar_tol(state.replace(mu=aux["mu"], energy=e), params, cfg)
    for r in ranks:
        pol = r["polar"]
        dmu = float((mu[r["rank"]] - aux["mu"].cpu()).abs().max())
        log(f"spatial polar rank {r['rank']}: {pol['polar']:.8e} K in "
            f"{pol['iters']} CG iterations; single rank {float(e.polar):.8e}"
            f" K in {int(aux['polar_iters'])}; |d| "
            f"{abs(pol['polar'] - float(e.polar)):.3e} tol {tol:.3e}; max "
            f"|d mu| {dmu:.3e}; B5 launches {pol['launches']}; "
            f"collectives {pol['collectives']}")
        if not abs(pol["polar"] - float(e.polar)) <= tol:
            raise AssertionError("spatial polar term disagrees with the "
                                 "single-rank solve")
    if not torch.equal(mu[0], mu[1]):
        raise AssertionError("the ranks' sharded dipoles differ")
    # (c) the spatial scan: every move type accepted, the ranks alike
    for r in ranks:
        s = r["scan"]
        log(f"spatial scan rank {r['rank']}: {s['steps_per_sec']:.2f} "
            f"steps/s (two ranks on one card), {s['collectives_line']}; "
            f"<N> {s['N']:.3f}; acceptance d/i/d "
            + "/".join(f"{s['acc'][k]:.4f}" for k in MD_MOVES)
            + f" over the run, accepts/attempts {s['chunk_accepts']}/"
            f"{s['chunk_attempts']} over a further {SPATIAL_CORRTIME} "
            f"steps; launches {s['launches']} (strips: B2 "
            f"{s['b2_strip']}, B4 {s['b4_strip']}); carried "
            f"{s['carried']:.6f} fresh {s['fresh']:.6f}")
        for i, k in enumerate(MD_MOVES):
            if not (s["acc"][k] > 0 or s["chunk_accepts"][i] > 0):
                raise AssertionError(f"spatial scan rank {r['rank']}: no "
                                     f"{k} move was accepted")
        if not abs(s["carried"] - s["fresh"]) <= 1e-4 * max(
                abs(s["fresh"]), 1.0):
            raise AssertionError("spatial scan: carried energy drifted from "
                                 "a fresh recompute beyond rel 1e-4")
        if not (s["b4_strip"] > 0 and s["b2_strip"] > 0):
            raise AssertionError("spatial scan: the strips were not "
                                 f"launched: {s}")
    for k in ("carried", "acc", "chunk_accepts", "chunk_attempts"):
        if ranks[0]["scan"][k] != ranks[1]["scan"][k]:
            raise AssertionError(f"spatial scan: the ranks' {k} differ")
    for r in ranks:
        for k, v in r["strips"].items():
            log(f"strip rank {r['rank']} {k}: {v}")
    rep["ranks"] = ranks
    rep["te1"] = te1
    launches = {"pair_terms_strip": sum(r["scan"]["b2_strip"]
                                        + r["te_b2"]["strip_launches"]
                                        for r in ranks),
                "mol_pair_cols": sum(r["scan"]["b4_strip"] for r in ranks),
                "dipole_field_strip": sum(
                    r["polar"]["launches"]["dipole_field"]
                    + r["polar"]["launches"]["dipole_field_chains"]
                    for r in ranks),
                "charge_field_strip": sum(
                    r["polar"]["launches"]["charge_field"] for r in ranks)}
    log(f"phase_spatial: {rep['seconds']:.1f} s for the ranks; strip "
        f"launches {launches} ({smi})")
    return launches, rep


def phase_chain_devices(device, smi):
    """chain_devices over MD_RANKS gloo ranks sharing the one card:
    ``chains 32`` fused µVT (B1 at 16 chains a rank) and PT (i) on B3 with
    8 replicas (4 a rank), CHAIN_STEPS steps each through run.run.  Each
    rank's block after the first chunk against this process's launch of
    the same chains at the same shape, bit for bit; the ladder a
    permutation of its rungs; the aggregate rates (two ranks on one
    card).  Returns (the launches, report, the PT run's JSONL)."""
    from mpmc_tpu_torch.parallel import replica
    with tempfile.TemporaryDirectory() as tmp:
        _md_decks(tmp)
        t0 = time.time()
        ranks = _md_launch("chains", MD_RANKS, tmp)
        secs = time.time() - t0
        for name in ("chains", "pt"):
            _md_single_first(tmp, name, device)
        with open(os.path.join(tmp, "pt_ranks.jsonl")) as f:
            jsonl = f.read()
    want = replica.geometric_ladder(77.0, PT_T_MAX, PT_R)
    got = np.sort(ranks[0]["pt"]["ladder"])
    if not np.allclose(got, want, rtol=1e-5):
        raise AssertionError(f"chain_devices PT: the ladder is not a "
                             f"permutation of its rungs: {got}")
    if ranks[0]["pt"]["ladder"] != ranks[1]["pt"]["ladder"]:
        raise AssertionError("chain_devices PT: the ranks' ladders differ")
    for r, res in enumerate(ranks):
        for name in ("chains", "pt"):
            log(f"chain_devices {name} rank {r}: {res[name]['steps_per_sec']}"
                f" steps/s aggregate (two ranks on one card), <N> "
                f"{res[name]['N']:.3f}, launches {res[name]['launches']}; "
                f"first chunk {res[name + '_first']}")
    if not all(r["chains"]["launches"]["run_steps_uvt"] > 0
               and r["pt"]["launches"]["run_steps"] > 0 for r in ranks):
        raise AssertionError("chain_devices: B1 or B3 was not launched")
    log(f"phase_chain_devices: {secs:.1f} s for the ranks ({smi})")
    return ({"run_steps_uvt": [r["chains"]["launches"]["run_steps_uvt"]
                               for r in ranks],
             "run_steps": [r["pt"]["launches"]["run_steps"] for r in ranks]},
            ranks, jsonl)


def _jsonl_rows(text):
    """The JSONL records without their timing fields."""
    rows = []
    for line in text.splitlines():
        rec = json.loads(line)
        rows.append({k: v for k, v in rec.items()
                     if "sec" not in k and "time" not in k})
    return rows


def phase_multihost_pt(device, smi, ranks_jsonl):
    """``python -m mpmc_tpu_torch --distributed --dist-backend gloo`` as
    MD_RANKS processes on the card (the multi-host command line, one
    process a host), the PT deck of phase_chain_devices (8 replicas, 4 a
    rank): its JSONL history equal to that run's."""
    from mpmc_tpu_torch.parallel import multihost
    with tempfile.TemporaryDirectory() as tmp:
        _md_decks(tmp)
        port = multihost.free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = []
        t0 = time.time()
        for r in range(MD_RANKS):
            logf = open(os.path.join(tmp, f"cli_{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "mpmc_tpu_torch", "--distributed",
                 "--dist-backend", "gloo", "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", str(MD_RANKS),
                 "--process-id", str(r), "pt.inp", "--jsonl", "pt.jsonl"],
                cwd=tmp, env=env, stdout=logf, stderr=subprocess.STDOUT),
                logf, None))
        _md_wait(procs, "multi-host PT processes")
        secs = time.time() - t0
        with open(os.path.join(tmp, "pt.jsonl")) as f:
            cli = f.read()
        out = open(os.path.join(tmp, "cli_0.log")).read()
    log("\n".join(out.splitlines()[-4:]))
    a, b = _jsonl_rows(cli), _jsonl_rows(ranks_jsonl)
    if a != b or not a:
        raise AssertionError("multi-host PT: the --distributed history "
                             "differs from the chain_devices run's")
    log(f"phase_multihost_pt: {len(a)} JSONL records equal to the "
        f"chain_devices run's; {secs:.1f} s for the two processes ({smi})")
    return {"seconds": secs, "records": len(a)}


# ---------------------------------------------------------------------------
# phase_fuzz: the parity fuzz corpus through every hand kernel its routes run
# ---------------------------------------------------------------------------

FUZZ_CORPUS = os.path.join(REPO, "tests", "torch_fuzz_corpus.json")


def fuzz_system(entry, dtype, device):
    """(params, state, cfg, thermo) of a corpus entry built by the port
    (tools/fuzz_recipe.py: the named builder or build_system, then the RD
    form's columns, GWP widths, skew, cfg, thermo, tmmc eta, rotor table
    and cell index), not initialized.  The CPU tests hold it equal to the
    reference's build carried over."""
    from tools import fuzz_recipe as fr
    from mpmc_tpu_torch.config import RunConfig, Thermo
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import celllist
    from mpmc_tpu_torch.state import Species, build_system
    tdt = torch.float64 if dtype == "float64" else torch.float32
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt,  # noqa: E731
                                    device=device)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    kind, kw = fr.system_recipe(entry)
    if kind == "builder":
        p, s, c, _ = getattr(systems, kw["name"])(**kw["args"], dtype=dtype,
                                                  device=device)
    else:
        kw = dict(kw)
        sp = tuple(Species(**fr.species_kwargs(d))
                   for d in kw.pop("species"))
        p, s = build_system(species=sp, dtype=tdt, device=device, **kw)
        c = RunConfig()
    c = dataclasses.replace(c, **fr.cfg_fields(entry, dtype))
    rep = {}
    if c.rd_potential in fr.RD_FORMS:
        cols = systems.rd_form_columns(host(p.eps), host(p.sig),
                                       c.rd_potential)
        rep.update({k: arr(v) for k, v in
                    zip(("eps", "sig", "c6", "c8", "c10"), cols)})
    if c.coulomb == "gwp":
        rep["gwp_alpha"] = arr(fr.gwp_widths(host(p.charge),
                                             entry["gwp_seed"]))
    if rep:
        p = p.replace(**rep)
    if entry["skew"]:
        s = s.replace(box=arr(fr.skewed_box(host(s.box), entry["skew"])))
    t = Thermo.make(**entry["thermo"],
                    n_species=len(entry["system"]["species"]), dtype=tdt,
                    device=device)
    if c.tmmc_bias:
        t = t.replace(tmmc_eta=arr(fr.tmmc_eta(int(p.n_mols_max) + 1,
                                               entry["rseed"])))
    if c.quantum_rotation:
        spins, rot_f = fr.rotor_table(int(p.n_mols_max), entry["rseed"])
        s = s.replace(spin=torch.as_tensor(spins, device=device),
                      rot_f=arr(rot_f))
    if c.cell_list:
        p = celllist.attach(p, s.pos, s.box, c, min_reduction=None)
    return p, s, c, t


def _fuzz_route(entry, system, steps, generator, uniforms=None):
    """(states, stats) of ``steps`` steps of the entry's route through the
    port's chunk functions on the card (the kernels the route runs), or
    the ValueError of a refusal entry."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    r, C = entry["route"], entry["chains"]
    g = dict(generator=generator, uniforms=uniforms)
    if r == "scan":
        return metropolis.run_chunk(state, params, cfg, thermo, steps, **g)
    if r.startswith("batched"):
        return multichain.run_chunk_batched(
            multichain.stack_states(state, C), params, cfg, thermo, steps,
            **g)
    if r == "pda":
        return metropolis.run_chunk_fused_uvt_polar_da(
            state, params, cfg, thermo, steps, **g)
    if r == "fused1":
        fn = {"uvt": metropolis.run_chunk_fused_uvt,
              "npt": metropolis.run_chunk_fused_npt}.get(
                  cfg.ensemble, metropolis.run_chunk_fused)
        return fn(state, params, cfg, thermo, steps, **g)
    fn = (metropolis.run_chunk_fused_uvt_multi if cfg.ensemble == "uvt"
          else metropolis.run_chunk_fused_multi)
    if uniforms is None:
        g["uniforms"] = torch.rand((C, steps, 16), generator=generator,
                                   dtype=cfg.tdtype,
                                   device=generator.device)
    return fn(multichain.stack_states(state, C), params, cfg, thermo,
              steps, uniforms=g["uniforms"])


class _FuzzShare:
    """The largest share of its tolerance any check of phase_fuzz used:
    max |d| / tol, with the entry and the check."""

    def __init__(self):
        self.share, self.where = 0.0, None

    def add(self, eid, what, d, tol):
        d = np.asarray(d, np.float64)
        tol = np.asarray(tol, np.float64)
        s = float(np.max(np.where(tol > 0, d / np.maximum(tol, 1e-300),
                                  np.where(d > 0, np.inf, 0.0)), initial=0))
        if not s <= 1.0:
            raise AssertionError(f"phase_fuzz {eid} {what}: |d| {d.max():.3e}"
                                 f" beyond its tolerance (share {s:.3f})")
        if s > self.share:
            self.share, self.where = s, f"{eid} {what}"


def _fuzz_agree(sh, eid, what, k, p, r):
    """A float32 kernel result k against the float64 plain result r of
    the same inputs within _tol's float32 rule (p: the float32 plain
    result); the same terms finite on both sides."""
    k, p, r = (x.double().cpu().numpy() for x in (k, p, r))
    fin = np.isfinite(r)
    if not np.array_equal(np.isfinite(k), fin):
        raise AssertionError(f"phase_fuzz {eid} {what}: non-finite terms "
                             "differ")
    with np.errstate(invalid="ignore"):
        sh.add(eid, what, np.abs(k - r)[fin],
               _tol(torch.float32, r, p)[fin])


def _fuzz_b2(eid, system, sh, dev):
    """B2 (pair_terms) at row_start 0 and F, and B2 over a batch of three
    jittered geometries (pair_terms_chains), against the plain version,
    within _tol's float32 rule (the plain version in float64 on the same
    inputs is the reference)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    params, state, cfg, _ = system
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    disp = ((params.c6, params.c8, params.c10)
            if cfg.rd_potential == "disp_expansion" else None)
    d64 = None if disp is None else tuple(x.double() for x in disp)
    F = metropolis.frozen_refresh_rows(params, cfg)
    a32 = (state.pos,) + _b2_shared(params, state, cfg)
    p64 = params.replace(charge=params.charge.double(),
                         eps=params.eps.double(), sig=params.sig.double())
    a64 = (state.pos.double(),) + _b2_shared(
        p64, state.replace(box=state.box.double()), cfg64)
    for rs in sorted({0, F}):
        k = pk.pair_terms(*a32, row_start=rs, disp=disp)
        p = pk.pair_terms_plain(*a32, row_start=rs, disp=disp)
        r = pk.pair_terms_plain(*a64, row_start=rs, disp=d64)
        _fuzz_agree(sh, eid, f"B2 row_start {rs}", k, p, r)
    pos = torch.stack([systems.jittered(params, state, seed=s,
                                        amplitude=0.1).pos
                       for s in range(3)]).contiguous()
    k = pk.pair_terms_chains(pos, *a32[1:], row_start=F, disp=disp)
    p = pk.pair_terms_chains_plain(pos, *a32[1:], row_start=F, disp=disp)
    r = pk.pair_terms_chains_plain(pos.double(), *a64[1:], row_start=F,
                                   disp=d64)
    _fuzz_agree(sh, eid, "B2 x 3", k, p, r)


def _fuzz_b4(eid, system, sh, dev, C):
    """B4 (mol_pair) on an alive movable molecule's rows and on trial rows
    shifted off them, and B4 over C chains (mol_pair_chains) with one
    shared header and with a header per chain (each chain's box scaled
    by 1 + 0.02 c), against the plain version within _tol's float32
    rule."""
    from mpmc_tpu_torch.ops import pairs
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    params, state, cfg, _ = system
    mov = ((params.mol_species >= 0) & state.mol_alive
           & ~params.mol_frozen).cpu().numpy()
    if not mov.any():
        return
    mols = np.flatnonzero(mov)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    disp = ((params.c6, params.c8, params.c10)
            if cfg.rd_potential == "disp_expansion" else None)
    d64 = None if disp is None else tuple(x.double() for x in disp)
    alive = state.atom_alive(params)
    col32 = (params.charge, params.eps, params.sig, params.mol_id32)
    col64 = (params.charge.double(), params.eps.double(),
             params.sig.double(), params.mol_id32)
    tab = (params.mol_atoms, params.mol_natoms)
    m = torch.tensor(int(mols[0]), device=dev)
    rows0 = state.pos[params.mol_atoms[int(mols[0])]]
    shift = torch.tensor([0.37, -0.21, 0.13], dtype=state.pos.dtype,
                         device=dev)
    for label, rows in (("rows", None), ("trial", rows0 + shift)):
        a32 = (state.pos, *col32, alive, *tab, m, rows,
               pairs.pair_scalars(state.box, cfg), cfg)
        a64 = (state.pos.double(), *col64, alive, *tab, m,
               None if rows is None else rows.double(),
               pairs.pair_scalars(state.box.double(), cfg64), cfg64)
        k = pk.mol_pair(*a32, disp=disp)
        p = pk.mol_pair_plain(*a32, disp=disp)
        r = pk.mol_pair_plain(*a64, disp=d64)
        _fuzz_agree(sh, eid, f"B4 {label}", k, p, r)
    # over C chains: a molecule per chain, shared header, then one per chain
    C = max(C, 2)
    pos = torch.stack([state.pos] * C).contiguous()
    al = torch.stack([alive] * C).contiguous()
    mc = torch.as_tensor(mols[np.arange(C) % len(mols)], device=dev)
    scal1 = pairs.pair_scalars(state.box, cfg)
    hdr = torch.stack([pairs.pair_scalars(state.box * (1 + 0.02 * c), cfg)
                       for c in range(C)])
    hdr64 = torch.stack([pairs.pair_scalars(
        state.box.double() * (1 + 0.02 * c), cfg64) for c in range(C)])
    for label, s32, s64 in (("shared header", scal1,
                             pairs.pair_scalars(state.box.double(), cfg64)),
                            ("header per chain", hdr, hdr64)):
        a32 = (pos, *col32, al, *tab, mc, None, s32, cfg)
        a64 = (pos.double(), *col64, al, *tab, mc, None, s64, cfg64)
        k = pk.mol_pair_chains(*a32, disp=disp)
        p = pk.mol_pair_chains_plain(*a32, disp=disp)
        r = pk.mol_pair_chains_plain(*a64, disp=d64)
        _fuzz_agree(sh, eid, f"B4 x {C} {label}", k, p, r)


F32_EPS = float(np.finfo(np.float32).eps)
# float32 ulps of a B5 field component's sum of |terms|: each term within
# a few ulps (sqrt, the damping's exp, the division), the sum of the terms
# far inside the (n - 1) ulps of a worst case
B5_TERM_ULPS = 8.0


def _b5_terms(mode, pos, box, src, ok, mol, rc, lam, kind):
    """The sum over j of |term_ij| of each component of plain B5's field
    (thole_kernel._field_plain's pairs, terms and damping, in float64):
    what the float32 rounding of a component scales with."""
    from mpmc_tpu_torch.ops import pbc as pbc_ops
    from mpmc_tpu_torch.ops.cuda.thole_kernel import damping
    pos, box, src = pos.double(), box.double(), src.double()
    n = pos.shape[-2]
    dr = pbc_ops.min_image(pos[..., :, None, :] - pos[..., None, :, :],
                           box, torch.linalg.inv(box))
    r2 = torch.sum(dr * dr, -1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair = (ok[..., :, None] & ok[..., None, :] & ~eye
            & (r2 < float(rc) ** 2))
    if mode == "charge":
        pair = pair & (mol[..., :, None] != mol[..., None, :])
    r2s = torch.where(pair, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    d1, d2 = damping(r, lam, kind)
    zero = torch.zeros_like(r2)
    adr = dr.abs()
    if mode == "charge":
        coef = torch.where(pair, (src[..., None, :] * d1 / (r2s * r)).abs(),
                           zero)
        return torch.einsum("...ij,...ijk->...ik", coef, adr)
    inv_r3 = 1.0 / (r2s * r)
    mdotr = torch.einsum("...jk,...ijk->...ij", src, dr)
    c1 = torch.where(pair, (3.0 * d2 * mdotr * inv_r3 / r2s).abs(), zero)
    c2 = torch.where(pair, (d1 * inv_r3).abs(), zero)
    return (torch.einsum("...ij,...ijk->...ik", c1, adr)
            + c2 @ src.abs())


def _fuzz_b5(eid, system, sh, dev, C):
    """B5 in both modes, dense at the derived rc and culled at rc 6 A on
    the cell-sorted sites (equal to the dense launch on the sorted input
    bit for bit), and over C jittered chains, against the plain version:
    phase_thole_kernel's float32 rule (at most 4x the plain float32
    version's distance from the float64 plain version, or 2e-6 x the
    largest |E_i|), or B5_TERM_ULPS float32 ulps of the component's sum
    of |terms| (_b5_terms): on these small cells the terms of a field
    component cancel to far below the largest field, and their float32
    rounding is what is left."""
    from mpmc_tpu_torch.models import systems
    from mpmc_tpu_torch.ops import pairs, thole
    from mpmc_tpu_torch.ops.cuda import thole_kernel as tk
    params, state, cfg, _ = system
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    if not bool(pol_ok.any()):
        return
    box, lam, kind = state.box, cfg.polar_damp, cfg.polar_damp_type
    mu = torch.where(pol_ok[:, None], state.mu, 0.0)
    rc = pairs.derived_cutoff(box, cfg)
    rc6 = torch.as_tensor(min(6.0, float(rc)), dtype=box.dtype, device=dev)

    def rule(what, k, p, r, terms):
        k, p, r = (x.double().cpu().numpy() for x in (k, p, r))
        scale = float(np.abs(r).max())
        sh.add(eid, what, np.abs(k - r),
               np.maximum(np.maximum(4.0 * np.abs(p - r), 2e-6 * scale),
                          B5_TERM_ULPS * F32_EPS * terms.cpu().numpy()))

    for mode, kern, plain, kc, pc in (
            ("dipole", tk.dipole_field, tk.dipole_field_plain,
             tk.dipole_field_chains, tk.dipole_field_chains_plain),
            ("charge", tk.charge_field, tk.charge_field_plain,
             tk.charge_field_chains, tk.charge_field_chains_plain)):
        ok, src = (pol_ok, mu) if mode == "dipole" else (alive,
                                                        params.charge)
        src = src.contiguous()
        mol = params.mol_id32
        k = kern(state.pos, box, ok, src, mol, rc, lam, kind)
        p = plain(state.pos, box, ok, src, mol, rc, lam, kind)
        r = plain(state.pos.double(), box.double(), ok, src.double(), mol,
                  rc.double(), lam, kind)
        rule(f"B5 {mode} dense", k, p, r,
             _b5_terms(mode, state.pos, box, src, ok, mol, rc, lam, kind))
        perm, _ = thole.cull_perm(state.pos, box, ok, rc6)
        ps_, oks, srcs, mols = (state.pos[perm].contiguous(), ok[perm],
                                src[perm].contiguous(), mol[perm])
        visit = thole.cull_visit(ps_, oks, box, rc6)
        kd = kern(ps_, box, oks, srcs, mols, rc6, lam, kind)
        kv = kern(ps_, box, oks, srcs, mols, rc6, lam, kind, visit=visit)
        if not torch.equal(kd, kv):
            raise AssertionError(f"phase_fuzz {eid} B5 {mode}: the culled "
                                 "launch is not the dense one bit for bit")
        rule(f"B5 {mode} culled", kv,
             plain(ps_, box, oks, srcs, mols, rc6, lam, kind),
             plain(ps_.double(), box.double(), oks, srcs.double(), mols,
                   rc6.double(), lam, kind),
             _b5_terms(mode, ps_, box, srcs, oks, mols, rc6, lam, kind))
        Cc = max(C, 2)
        pos = torch.stack([systems.jittered(params, state, seed=s,
                                            amplitude=0.1).pos
                           for s in range(Cc)]).contiguous()
        okc = torch.stack([ok] * Cc)
        srcc = torch.stack([src] * Cc).contiguous()
        molc = torch.stack([mol] * Cc).contiguous()
        k = kc(pos, box, okc, srcc, molc, rc, lam, kind)
        p = pc(pos, box, okc, srcc, molc, rc, lam, kind)
        r = pc(pos.double(), box.double(), okc, srcc.double(), molc,
               rc.double(), lam, kind)
        rule(f"B5 {mode} x {Cc}", k, p, r,
             _b5_terms(mode, pos, box, srcc, okc, molc, rc, lam, kind))


def _fuzz_b1(eid, system, sh, dev, u):
    """B1 on the entry's table u [C, K, 16] against its plain version:
    equal counts, slot aliveness, spins and TMMC attempts; the sums within
    phase_uvt_kernel's float32 rule plus _rss_tol and _slope_tol (the
    rule of phase_rd_fused_kernels), positions within 1e-4 A, S(k) within
    1e-4 of its scale, the Sigma a columns within _sum_a_tol."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    C = u.shape[0]
    args, kw = metropolis.fused_uvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u,
        metropolis.uvt_fused_tables(params, cfg))
    trace = []
    p = mk.run_steps_uvt_plain(*args, **kw, trace=trace, slopes=True)
    kw_k = dict(kw)
    if "tmmc_out" in kw:
        kw_k["tmmc_out"] = torch.zeros_like(kw["tmmc_out"])
    k = mk.run_steps_uvt(*args, **kw_k)
    torch.cuda.synchronize(dev)
    ps, ks = p[2].cpu().numpy(), k[2].cpu().numpy()
    same = (np.array_equal(ks[:, 6:14], ps[:, 6:14])
            and torch.equal(k[1], p[1]))
    if cfg.quantum_rotation:
        same = same and torch.equal(k[5], p[5])
    if "tmmc_out" in kw:
        tk_, tp_ = kw_k["tmmc_out"].cpu().numpy(), kw["tmmc_out"].cpu(
            ).numpy()
        same = same and np.array_equal(tk_[..., [0, 2]], tp_[..., [0, 2]])
    if not same:
        raise AssertionError(f"phase_fuzz {eid} B1: decisions differ from "
                             f"the plain version: kernel {ks[:, 6:14]} "
                             f"plain {ps[:, 6:14]}")
    n_acc = ps[:, 6:9].sum(1, keepdims=True)
    tol = 2e-5 * np.abs(ps[:, :6]) + 2e-3 * np.sqrt(n_acc + 1.0)
    tol[:, :2] += _rss_tol(trace)
    tol += _slope_tol(trace, state.box, 6)
    sh.add(eid, "B1 sums", np.abs(ks[:, :6] - ps[:, :6]), tol)
    sh.add(eid, "B1 positions", float((k[0] - p[0]).abs().max()), 1e-4)
    if cfg.coulomb == "ewald":
        sh.add(eid, "B1 S(k)", max(float((a - b).abs().max())
                                   for a, b in zip(k[3:5], p[3:5])),
               1e-4 * (1.0 + float(p[3].abs().max())))
    if "tmmc_out" in kw:
        beta = float(args[14].reshape(-1)[0])
        sh.add(eid, "B1 Sigma a", np.abs(tk_[..., [1, 3]] - tp_[..., [1, 3]]),
               _sum_a_tol(tp_, beta))
    return int(ps[:, 6:9].sum())


def _fuzz_b3(eid, system, sh, dev, u):
    """B3 on the entry's table against its plain version (the hybrid NPT
    path's segments: under nvt): equal accepts and spinflip counts, the
    sums within the float32 rule plus _rss_tol and _slope_tol (the rule
    of phase_rd_fused_kernels), positions within 1e-4 A, S(k) within 1e-4
    of its scale."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.parallel import multichain
    params, state, cfg, thermo = system
    if cfg.ensemble == "npt":
        cfg = dataclasses.replace(cfg, ensemble="nvt")
    C = u.shape[0]
    args, kw = metropolis.fused_nvt_launch_args(
        multichain.stack_states(state, C), params, cfg, thermo, u,
        metropolis.nvt_fused_tables(params, state.mol_alive))
    trace = []
    p = mk.run_steps_plain(*args, **kw, trace=trace, slopes=True)
    k = mk.run_steps(*args, **kw)
    torch.cuda.synchronize(dev)
    ps, ks = p[1].cpu().numpy(), k[1].cpu().numpy()
    if not np.array_equal(ks[:, 3:], ps[:, 3:]):
        raise AssertionError(f"phase_fuzz {eid} B3: decisions differ from "
                             f"the plain version: kernel {ks[:, 3:]} plain "
                             f"{ps[:, 3:]}")
    tol = 2e-5 * np.abs(ps[:, :3]) + 2e-3 * np.sqrt(ps[:, 3:4] + 1.0)
    tol[:, :2] += _rss_tol(trace)
    tol += _slope_tol(trace, state.box, 3)
    sh.add(eid, "B3 sums", np.abs(ks[:, :3] - ps[:, :3]), tol)
    sh.add(eid, "B3 positions", float((k[0] - p[0]).abs().max()), 1e-4)
    if cfg.coulomb == "ewald":
        sh.add(eid, "B3 S(k)", max(float((a - b).abs().max())
                                   for a, b in zip(k[2:4], p[2:4])),
               1e-4 * (1.0 + float(p[2].abs().max())))
    return int(ps[:, 3].sum())


def _fuzz_b6(eid, system, sh, dev, us):
    """B6 on segment tables us [n, PDA_SEG, 16] against its plain version
    (phase_pda_kernel's float32 rule): equal n_done, hit, move type, slot,
    species and attempts; rows within 1e-4 A; the six deltas, d* and lnb
    within 2e-5 of their size + 1e-3 K + 8 float32 epsilons x their rss,
    rd and es also within _slope_tol's rule."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    params, state, cfg, thermo = system
    if cfg.ensemble == "nvt":
        thermo = thermo.replace(insert_probability=torch.zeros_like(
            thermo.insert_probability))
    cfg = mk.pda_effective_cfg(cfg, params)
    tables = metropolis.uvt_fused_tables(params, cfg)
    hits = 0
    for u in us:
        a, kw = metropolis.pda_launch_args(state, params, cfg, thermo, u,
                                           tables)
        trace = []
        p = mk.run_steps_uvt_pda_plain(*a, **kw, trace=trace,
                                       slopes=True).cpu().numpy()
        k = mk.run_steps_uvt_pda(*a, **kw).cpu().numpy()
        if not np.array_equal(k[0, [0, 1, 2, 3, 4, 6, 7, 8]],
                              p[0, [0, 1, 2, 3, 4, 6, 7, 8]]):
            raise AssertionError(f"phase_fuzz {eid} B6: record differs from "
                                 f"the plain version: kernel {k[0, :12]} "
                                 f"plain {p[0, :12]}")
        rss = np.zeros(8)
        if trace and trace[-1].get("rss"):
            rss[[0, 1, 2, 6]] = trace[-1]["rss"]
        want = np.concatenate([p[1, :6], p[0, 9:11]])
        vals = np.concatenate([k[1, :6], k[0, 9:11]])
        tol = 2e-5 * np.abs(want) + 1e-3 + 8 * EPS32 * rss
        if trace and trace[-1].get("slope"):
            tol[:2] += np.asarray(trace[-1]["slope"]) * _row_bound(state.box)
        sh.add(eid, "B6 deltas", np.abs(vals - want), tol)
        sh.add(eid, "B6 rows", float(np.abs(k[2:5] - p[2:5]).max()), 1e-4)
        hits += int(p[0, 1])
    return hits


def _fuzz_book(eid, entry, system, states, sh, start):
    """The deck's carried energy against a fresh recompute: every chain's
    total within rel 1e-4 (_check_bookkeeping's rule) of the largest of
    the total and the sums of the terms' sizes at the deck's start
    (``start``) and end (on these small cells the terms nearly cancel,
    and a molecule inserted and deleted again leaves the float32 rounding
    of its terms behind), its polar term within _polar_tol (and the
    1e-4 K floor of the total's rule)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.parallel import multichain
    from mpmc_tpu_torch.state import slice_chain
    params, _, cfg, thermo = system
    multi = entry["chains"] > 1 and entry["route"] != "pda"
    fresh = (multichain.initialize_batched(states, params, cfg, thermo)
             if multi else metropolis.initialize(states, params, cfg,
                                                 thermo))
    for c in range(entry["chains"] if multi else 1):
        st = slice_chain(states, c) if multi else states
        fr = slice_chain(fresh, c) if multi else fresh
        a, b = float(st.energy.total), float(fr.energy.total)
        mag = max(sum(abs(float(getattr(x.energy, k))) for k in (
            "rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
            "polar", "vdw")) for x in (fr, start))
        sh.add(eid, "carried = fresh", abs(a - b),
               1e-4 * max(abs(b), mag, 1.0))
        if cfg.polarization:
            sh.add(eid, "carried = fresh polar",
                   abs(float(st.energy.polar) - float(fr.energy.polar)),
                   _polar_tol(fr, params, cfg) + 1e-4)


FUZZ_DECK_STEPS = 64


def phase_fuzz(device):
    """The parity fuzz corpus (tests/torch_fuzz_corpus.json,
    tools/make_fuzz_corpus.py) on the card in float32, every entry built
    by the port (fuzz_system) and initialized: B2 (row_start 0 and F, and
    over a batch) and B4 (rows, a trial, over chains with a shared header
    and with a header per chain) where their gate takes the entry; B5
    (both modes, dense, culled and over chains) where it is polar; on a
    fused route B1, B3 or B6 on the entry's own numpy table through every
    instance the entry selects (its RD form, coulomb, quantum correction,
    cavity / TMMC, spinflip); each against its plain version on the same
    inputs with the rules of their own phases; then FUZZ_DECK_STEPS steps
    of the entry's route through the port's chunk functions and carried =
    fresh.  A refusal entry must raise its named ValueError.  Returns
    (entries run, launches per kernel in the phase, the largest share of
    a tolerance used and where, seconds)."""
    from mpmc_tpu_torch.mc import metropolis
    from mpmc_tpu_torch.ops.cuda import mc_kernel as mk
    from mpmc_tpu_torch.ops.cuda import pair_kernel as pk
    from tools import fuzz_recipe as fr
    t0 = time.time()
    entries = fr.load(FUZZ_CORPUS)["entries"]
    sh = _FuzzShare()
    _reset_counts()
    for e in entries:
        eid, r = e["id"], e["route"]
        system = fuzz_system(e, "float32", device)
        params, state, cfg, thermo = system
        state = metropolis.initialize(state, params, cfg, thermo)
        if cfg.ensemble == "nve":
            u0 = float(state.energy.total + state.e_frozen.total)
            thermo = thermo.replace(nve_energy=torch.tensor(
                u0 + e["nve_kinetic"], dtype=torch.float32, device=device))
        system = (params, state, cfg, thermo)
        C = e["chains"]
        if pk.supported(cfg):
            _fuzz_b2(eid, system, sh, device)
            _fuzz_b4(eid, system, sh, device, C)
        if cfg.polarization:
            _fuzz_b5(eid, system, sh, device, C)
        g = torch.Generator(device=device).manual_seed(e["useed"] % 2 ** 31)
        if e["refusal"]:
            try:
                _fuzz_route(e, system, 8, g)
            except ValueError as err:
                if not str(err).startswith(
                        getattr(metropolis, e["refusal"])[:40]):
                    raise
            else:
                raise AssertionError(f"phase_fuzz {eid}: {e['refusal']} "
                                     "was not refused")
            log(f"fuzz {eid} {r} {cfg.ensemble}: refused "
                f"({e['refusal']}) as the port must")
            continue
        if r in ("fused1", "fused2", "fused5"):
            u = torch.as_tensor(fr.uniforms(e, (C, e["steps"], 16)),
                                dtype=torch.float32, device=device)
            if cfg.ensemble == "uvt":
                _fuzz_b1(eid, system, sh, device, u)
            else:
                _fuzz_b3(eid, system, sh, device, u)
        elif r == "pda":
            us = fr.uniforms(e, (3, mk.PDA_SEG, 16)).astype(np.float32)
            us[0, 0, 4], us[0, 0, 8] = 1e-30, 0.9
            _fuzz_b6(eid, system, sh, device,
                     torch.as_tensor(us, device=device))
        states, stats = _fuzz_route(e, system, FUZZ_DECK_STEPS, g)
        _fuzz_book(eid, e, system, states, sh, state)
        log(f"fuzz {eid} {r} {cfg.ensemble} {cfg.rd_potential}/"
            f"{cfg.coulomb} N={state.pos.shape[0]}: "
            f"accepts {np.asarray(stats.host().accepts).sum(0).tolist()}; "
            f"largest share so far {sh.share:.3f} ({sh.where})")
    torch.cuda.synchronize(device)
    launches = _launch_counts()
    secs = time.time() - t0
    log(f"phase_fuzz: {len(entries)} entries, launches {launches}, largest "
        f"tolerance share {sh.share:.4f} ({sh.where}), {secs:.1f} s")
    return len(entries), launches, sh.share, sh.where, secs


def _md_phases(dev, smi, mark):
    """phase_spatial, phase_chain_devices and phase_multihost_pt: (the
    strips' report, their launches, seconds)."""
    t_md = time.time()
    mark("phase_spatial")
    md_launches, md_rep = phase_spatial(dev, smi)
    mark("phase_chain_devices")
    cd_launches, _, pt_jsonl = phase_chain_devices(dev, smi)
    mark("phase_multihost_pt")
    phase_multihost_pt(dev, smi, pt_jsonl)
    log(f"chain_devices launches {cd_launches}")
    return md_rep, md_launches, time.time() - t_md


def _md_kernels(md_rep, launches):
    """The kernels line's entries of the three strip forms: rank 0's
    times (two ranks sharing the card) with rank 1's beside them, the
    larger error of the two ranks' strips."""
    out = []
    r0, r1 = (r["strips"] for r in md_rep["ranks"])
    for name in ("pair_terms_strip", "mol_pair_cols", "dipole_field_strip",
                 "charge_field_strip"):
        a, b = r0[name], r1[name]
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": max(a["max_abs_err"], b["max_abs_err"]),
                    "ms": a["ms"], "device_ms": a["device_ms"],
                    "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                    "bound_by": a["bound_by"], "library_ms": None,
                    "ranks": "2 sharing one card",
                    "rank1": {k: b[k] for k in ("ms", "device_ms",
                                                "plain_ms", "bound_ms")},
                    "full_ms": a["full_ms"]})
    return out


def main():
    dev, smi = phase_device()
    sys.path.insert(0, REPO)
    t0 = time.time()
    build_s = phase_build()
    # phase_energy's CPU references, computed beside the card's phases
    refs = _CpuReferences()
    replay_refs = _ReplayReferences()
    try:
        _phases(dev, smi, t0, build_s, refs, replay_refs)
    finally:
        refs.stop()
        replay_refs.stop()


def _phases(dev, smi, t0, build_s, refs, replay_refs):
    """Every phase after the build (main), then the JSON lines."""

    def mark(name):
        # the wall seconds at which each phase starts: where a run's time goes
        log(f"--- {name} at {time.time() - t0:.1f} s")

    mark("phase_kernels")
    report = phase_kernels(dev)
    mark("phase_uvt_kernel")
    report["run_steps_uvt"] = phase_uvt_kernel(dev)
    mark("phase_nvt_kernel")
    report["run_steps"] = phase_nvt_kernel(dev)
    mark("phase_thole_kernel")
    report.update(phase_thole_kernel(dev))
    mark("phase_pda_kernel")
    report["run_steps_uvt_pda"] = phase_pda_kernel(dev)
    mark("phase_mol_pair_chains")
    report["mol_pair_c128"] = phase_mol_pair_chains(dev)
    t_c8 = time.time()
    mark("phase_thole_chains")
    report["dipole_field_c8"] = phase_thole_chains(dev)
    t_c8 = time.time() - t_c8
    mark("phase_main")
    scan_launches, rate, su = phase_main(dev)
    mark("phase_profile")
    prof_scan = phase_profile(dev, su)
    mark("phase_example")
    phase_example(dev)
    mark("phase_fused")
    fused_launches, fused_rate, su_f, kernel_us = phase_fused(dev)
    mark("phase_profile_fused")
    prof_fused = phase_profile_fused(dev, su_f)
    mark("phase_fused_chains")
    chain_launches, chains_rate, su_c = phase_fused_chains(dev)
    mark("phase_profile_fused")
    prof_chains = phase_profile_fused(dev, su_c, states=su_c.states)
    mark("phase_fused_nvt")
    nvt_launches, nvt_rates, nvt_sus = phase_fused_nvt(dev)
    mark("phase_profile_fused")
    prof_nvt = phase_profile_fused(dev, nvt_sus["mof_nvt"])
    su16 = nvt_sus["mof_nvt_c16"]
    mark("phase_profile_fused")
    prof_nvt16 = phase_profile_fused(dev, su16, states=su16.states)
    mark("phase_polar")
    polar_launches, polar_reps = phase_polar(dev)
    mark("phase_pda_decks")
    pda_launches, pda_reps = phase_pda_decks(dev)
    t_new = time.time()
    mark("phase_batched")
    batched_launches, batched_rep = phase_batched(dev)
    mark("phase_pt")
    pt_launches, pt_reps = phase_pt(dev)
    mark("phase_restart_write")
    restart = phase_restart_write(dev)
    t_new = time.time() - t_new
    t_11 = time.time()
    mark("phase_checkpoint")
    ckpt_rep = phase_checkpoint(dev, smi)
    mark("phase_replay")
    replay_rep = phase_replay(dev, smi, replay_refs)
    analyze_inputs(replay_refs)
    replay_refs.start()
    mark("phase_analyze")
    analyze_rep = phase_analyze(dev, smi, replay_refs)
    mark("phase_campaign")
    campaign_rep = phase_campaign(dev, smi)
    t_11 = time.time() - t_11
    t_pc = time.time()
    mark("phase_polar_chains")
    pc_launches, pc_reps = phase_polar_chains(dev)
    t_c8 += time.time() - t_pc
    t_12 = time.time()
    mark("phase_npt")
    npt_launches, npt_reps = phase_npt(dev)
    mark("phase_pt_drivers")
    ptd_launches, ptd_reps = phase_pt_drivers(dev)
    t_12 = time.time() - t_12
    t_13 = time.time()
    mark("phase_fh_kernels")
    report.update(phase_fh_kernels(dev))
    mark("phase_fh_decks")
    fh_launches, fh_reps = phase_fh_decks(dev)
    t_13 = time.time() - t_13
    t_14 = time.time()
    mark("phase_xt_kernels")
    report.update(phase_xt_kernels(dev))
    mark("phase_xt_decks")
    xt_launches, xt_reps = phase_xt_decks(dev)
    t_14 = time.time() - t_14
    t_sf = time.time()
    mark("phase_qrot_table")
    report["mol_pair_grid"] = phase_qrot_table(dev)[0]
    mark("phase_sf_kernels")
    report.update(phase_sf_kernels(dev))
    mark("phase_sf_decks")
    sf_launches, sf_reps = phase_sf_decks(dev)
    t_sf = time.time() - t_sf
    t_rd = time.time()
    mark("phase_rd_kernels")
    report.update(phase_rd_kernels(dev))
    mark("phase_rd_decks")
    rd_launches, rd_reps = phase_rd_decks(dev)
    t_rd = time.time() - t_rd
    t_rdf = time.time()
    mark("phase_rd_fused_kernels")
    report.update(phase_rd_fused_kernels(dev))
    mark("phase_rd_fused_decks")
    rdf_launches, rdf_reps = phase_rd_fused_decks(dev)
    t_rdf = time.time() - t_rdf
    t_19 = time.time()
    mark("phase_thole_header")
    report["dipole_field_c8_header"] = phase_thole_header(dev)
    mark("phase_polar_npt")
    pnpt_launches, pnpt_reps = phase_polar_npt(dev)
    mark("phase_cdvdw")
    vdw_launches, vdw_reps = phase_cdvdw(dev)
    mark("phase_rd_crystal")
    cry_launches, cry_rep = phase_rd_crystal(dev)
    mark("phase_spectre")
    spc_launches, spc_rep = phase_spectre(dev)
    mark("phase_qvib")
    qv_launches, qv_rep = phase_qvib(dev)
    t_19 = time.time() - t_19
    t_ccs = time.time()
    mark("phase_b2_chains")
    report["pair_terms_chains"] = phase_b2_chains(dev)
    mark("phase_cell_list")
    cl_launches, cl_reps = phase_cell_list(dev)
    mark("phase_mol_cache")
    mc_launches, mc_reps = phase_mol_cache(dev)
    mark("phase_surf")
    surf_launches, surf_reps = phase_surf(dev)
    t_ccs = time.time() - t_ccs
    md_report, md_launches, t_md = _md_phases(dev, smi, mark)
    mark("phase_fuzz")
    fuzz = phase_fuzz(dev)
    # last: its CPU references have had the card's phases to finish in
    mark("phase_energy")
    phase_energy(dev, refs)
    mark("replay references")
    replay_refs.check(smi)
    # each kernel's launches on its own main path: B2 and B4 on the scan
    # path, B1 on the fused single-chain µVT path, B3 on the single-chain
    # MOF NVT deck, B5 (both modes) on the polar scan-path deck (dipole:
    # the refresh's matvec through dipole_field and the CG's through the
    # chain wrapper at C = 1, one kernel), B6 on the direct fused PDA deck
    launches = {"pair_terms": scan_launches["pair_terms"],
                "mol_pair": scan_launches["mol_pair"],
                "run_steps_uvt": fused_launches["run_steps_uvt"],
                "run_steps": nvt_launches["mof_nvt"]["run_steps"],
                "dipole_field": (polar_launches["polar"]["dipole_field"]
                                 + polar_launches["polar"][
                                     "dipole_field_chains"]),
                "charge_field": polar_launches["polar"]["charge_field"],
                "run_steps_uvt_pda": pda_launches["pda"]["run_steps_uvt_pda"],
                "mol_pair_c128": batched_launches["mol_pair_chains"],
                "dipole_field_c8":
                    pc_launches["polar_c8"]["dipole_field_chains"],
                # B4 over chains with a header per chain: the NPT chains
                "mol_pair_c16_header":
                    npt_launches["n3_chains"]["mol_pair_chains"],
                # B1, B3 and B6 with a quantum correction: the FH/FK decks
                "run_steps_uvt_fh2": fh_launches["fh2_fused"]["run_steps_uvt"],
                "run_steps_uvt_fk": fh_launches["fk_fused"]["run_steps_uvt"],
                "run_steps_fh4": fh_launches["fh4_nvt"]["run_steps"],
                "run_steps_uvt_pda_fh2":
                    fh_launches["fh2_pda"]["run_steps_uvt_pda"],
                # B1 and B6 with cavity bias and TMMC: their decks
                "run_steps_uvt_xt":
                    xt_launches["cav_bias_fused"]["run_steps_uvt"],
                "run_steps_uvt_xt_c32":
                    xt_launches["tmmc_c32"]["run_steps_uvt"],
                "run_steps_uvt_pda_xt":
                    xt_launches["pda_tmmc_cav"]["run_steps_uvt_pda"],
                # B4 at position stride 0 (the rotor grid of every refresh)
                # and B1, B3 and B6 with spinflip: the spinflip decks
                "mol_pair_grid": sf_launches["sf_fused"]["mol_pair_grid"],
                "run_steps_uvt_sf": sf_launches["sf_fused"]["run_steps_uvt"],
                "run_steps_uvt_sf_c32":
                    sf_launches["sf_c32"]["run_steps_uvt"],
                "run_steps_sf": sf_launches["sf_nvt"]["run_steps"],
                "run_steps_uvt_pda_sf":
                    sf_launches["sf_pda"]["run_steps_uvt_pda"],
                # B2 and B4's RD form instances: each form's scan deck (the
                # disp_expansion µVT deck), B4 over chains its chains 16 deck
                **{f"pair_terms_{k}": rd_launches[k]["pair_terms"]
                   for k in RD_KEY.values()},
                **{f"mol_pair_{k}": rd_launches[k]["mol_pair"]
                   for k in RD_KEY.values()},
                "mol_pair_chains_disp":
                    rd_launches["disp_c16"]["mol_pair_chains"],
                # B1, B3 and B6's form instances: the fused decks of each
                # form (B1 over 32 chains: the disp_expansion chains 32 deck)
                **{f"run_steps_uvt_{k}": rdf_launches[f"{k}_uvt"][
                    "run_steps_uvt"] for k in FUSED_KEY.values()},
                "run_steps_uvt_disp_c32":
                    rdf_launches["disp_c32"]["run_steps_uvt"],
                "run_steps_uvt_gwp_fh2":
                    rdf_launches["gwp_fh2_uvt"]["run_steps_uvt"],
                **{f"run_steps_{k}": rdf_launches[f"{k}_nvt"]["run_steps"]
                   for k in FUSED_KEY.values()},
                **{f"run_steps_uvt_pda_{k}": rdf_launches[f"{k}_pda"][
                    "run_steps_uvt_pda"] for k in FUSED_KEY.values()},
                # B5 over chains with a header per chain: the polar NPT
                # chains deck, every chain in its own cell
                "dipole_field_c8_header": pnpt_launches[
                    f"npt_polar_c{C_POLAR}"]["dipole_field_chains"],
                # B2 over a batch of geometries: the surf scan deck
                "pair_terms_chains": surf_launches["surf"][
                    "pair_terms_chains"]}
    report["mol_pair_c16_header"] = report["mol_pair_c128"]["header"]
    report["mol_pair_chains_disp"] = report["mol_pair_disp"]["c128"]
    report["run_steps_uvt_disp_c32"] = dict(
        report["run_steps_uvt_disp"],
        **report["run_steps_uvt_disp"]["c32"],
        cluster=f"G={report['run_steps_uvt_disp']['c32']['G']} (C=32)")
    names = ("pair_terms", "mol_pair", "run_steps_uvt", "run_steps",
             "dipole_field", "charge_field", "run_steps_uvt_pda",
             "mol_pair_c128", "dipole_field_c8", "mol_pair_c16_header",
             "run_steps_uvt_fh2", "run_steps_uvt_fk", "run_steps_fh4",
             "run_steps_uvt_pda_fh2", "run_steps_uvt_xt",
             "run_steps_uvt_xt_c32", "run_steps_uvt_pda_xt",
             "mol_pair_grid", "run_steps_uvt_sf", "run_steps_uvt_sf_c32",
             "run_steps_sf", "run_steps_uvt_pda_sf",
             *(f"pair_terms_{RD_KEY[f]}" for f in RD_FORMS),
             *(f"mol_pair_{RD_KEY[f]}" for f in RD_FORMS),
             "mol_pair_chains_disp",
             *(f"run_steps_uvt_{k}" for k in FUSED_KEY.values()),
             "run_steps_uvt_disp_c32", "run_steps_uvt_gwp_fh2",
             *(f"run_steps_{k}" for k in FUSED_KEY.values()),
             *(f"run_steps_uvt_pda_{k}" for k in FUSED_KEY.values()),
             "dipole_field_c8_header", "pair_terms_chains")
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "device_ms": report[name]["device_ms"],
                "plain_ms": report[name]["plain_ms"],
                "bound_ms": report[name]["bound_ms"],
                "bound_by": report[name]["bound_by"],
                "library_ms": None}
               for name in names]
    for kern in kernels:       # B1 and B3: the cluster size of each timing
        if "cluster" in report[kern["name"]]:
            kern["cluster"] = report[kern["name"]]["cluster"]
    kernels += _md_kernels(md_report, md_launches)
    # B2 on the replay path: one pass per frame, three with the pressure
    kernels[0]["replay_launches"] = {k: r["pair_terms"]
                                     for k, r in replay_rep.items()}
    log(f"launches per path: scan {scan_launches}, fused {fused_launches}, "
        f"fused chains {chain_launches}, fused nvt {nvt_launches}")
    log(f"build_seconds {build_s:.1f}  scan_steps_per_sec {rate:.2f}  "
        f"fused_steps_per_sec {fused_rate:.2f}  "
        f"fused_c32_steps_per_sec {chains_rate:.2f}  "
        f"b1_kernel_us_per_step {kernel_us * 1e3:.2f}  "
        f"b1_c32_kernel_us_per_step "
        f"{report['run_steps_uvt']['c32']['ms'] * 1e3:.2f}  "
        f"fused_device_busy {prof_fused['device_busy_share']:.4f}  "
        f"fused_c32_device_busy {prof_chains['device_busy_share']:.4f}  "
        f"scan_device_busy {prof_scan['device_busy_share']:.4f}")
    b3 = report["run_steps"]
    log("  ".join(f"{k}_steps_per_sec {v:.2f}" for k, v in nvt_rates.items())
        + f"  b3_kernel_us_per_step mof {b3['mof']['ms'] * 1e3:.2f}"
        f" lj {b3['lj']['ms'] * 1e3:.2f}"
        f" c16 {b3['mof']['c16']['ms'] * 1e3:.2f}"
        f"  fused_nvt_device_busy {prof_nvt['device_busy_share']:.4f}"
        f" (b3 share {prof_nvt['kernel_share']:.4f})"
        f"  fused_nvt_c16_device_busy {prof_nvt16['device_busy_share']:.4f}"
        f" (b3 share {prof_nvt16['kernel_share']:.4f})"
        f"  wall_seconds {time.time() - t0:.1f}")
    log("  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_cg_iters_"
                  f"per_step {r['cg_iters_per_step']:.3f}  {k}_device_busy "
                  f"{r['device_busy_share']:.4f}" for k, r in
                  polar_reps.items())
        + f"  polar_launches {polar_launches}"
        + f"  wall_seconds {time.time() - t0:.1f}")
    b6 = report["run_steps_uvt_pda"]
    log("  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_cg_iters_"
                  f"per_step {r['cg_iters_per_step']:.3f}  {k}_b6_launches_"
                  f"per_step {r['b6_launches_per_step']:.3f}  {k}_device_busy "
                  f"{r['device_busy_share']:.4f}  {k}_b6_share "
                  f"{r['b6_share']:.4f}" for k, r in pda_reps.items())
        + f"  b6_kernel_us_per_step {b6['ms'] * 1e3:.2f}"
        + f"  b6_device_us_per_step {b6['device_ms'] * 1e3:.2f}"
        + f"  b6_cluster {b6['cluster']}"
        + f"  b6_kernel_ms_per_launch {b6['launch_ms']:.4f}"
        + f"  pda_launches {pda_launches}"
        + f"  wall_seconds {time.time() - t0:.1f}")
    b4c = report["mol_pair_c128"]
    log(f"batched_c{C_BATCHED}_steps_per_sec "
        f"{batched_rep['steps_per_sec']:.2f}  batched_device_busy "
        f"{batched_rep['device_busy_share']:.4f}  batched_b4_share "
        f"{batched_rep['b4_share']:.4f}  b4_c{C_BATCHED}_ms {b4c['ms']:.4f}  "
        f"b4_c{C_BATCHED}_device_ms {b4c['device_ms']:.4f}  "
        + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_swap_"
                    f"acceptance {r['swap_acceptance']:.4f}"
                    for k, r in pt_reps.items())
        + f"  restart_write_ms python {restart['python']:.2f} native "
        f"{restart['native']:.2f}  batched_launches {batched_launches}  "
        f"pt_launches {pt_launches}  new_phases_seconds {t_new:.1f}")
    b5c = report["dipole_field_c8"]
    log("  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_cg_"
                  f"iters_per_chain_step {r['cg_iters_per_chain_step']:.3f}  "
                  f"{k}_cg_rounds_per_step {r['chunk_cg_rounds_per_step']:.3f}"
                  f"  {k}_host_syncs_per_step {r['host_syncs_per_step']:.3f}"
                  f"  {k}_device_busy {r['device_busy_share']:.4f}  {k}_b5_"
                  f"share {r['b5_share']:.4f}" for k, r in pc_reps.items())
        + f"  b5_c{C_POLAR}_dipole_ms {b5c['ms']:.4f}  b5_c{C_POLAR}_dipole_"
        f"device_ms {b5c['device_ms']:.4f}  b5_c{C_POLAR}_dipole_culled_"
        f"device_ms {b5c['culled']['device_ms']:.4f}  polar_chains_launches "
        f"{pc_launches}  polar_chains_seconds {t_c8:.1f}"
        f"  wall_seconds {time.time() - t0:.1f}")
    b2 = report["pair_terms"]
    log(f"b2_ms_row_start_F {b2['ms']:.4f}  b2_device_ms_row_start_F "
        f"{b2['device_ms']:.4f}  b2_ms_full {b2['full']['ms']:.4f}  "
        f"b2_device_ms_full {b2['full']['device_ms']:.4f}  b2_tiles "
        f"{b2['tiles']} / {b2['full']['tiles']}")
    log("  ".join(f"checkpoint_{k}_save_ms {r['save_ms']:.2f}  checkpoint_"
                  f"{k}_load_ms {r['load_ms']:.2f}  checkpoint_{k}_bytes "
                  f"{r['bytes']}" for k, r in ckpt_rep.items())
        + "  " + "  ".join(
            f"replay_{k}_frames_per_sec {r['frames_per_sec']:.2f}  replay_"
            f"{k}_reader_ms_per_frame {r['reader_ms_per_frame']:.2f}"
            for k, r in replay_rep.items())
        + f"  campaign_c16_chain_steps_per_sec "
        f"{campaign_rep['chain_steps_per_sec']:.2f}  campaign_points "
        f"{campaign_rep['points']}  pr11_phases_seconds {t_11:.1f}"
        f"  ({smi})")
    b4h = report["mol_pair_c16_header"]
    log("  ".join(f"npt_{k}_steps_per_sec {r['steps_per_sec']:.2f}  npt_{k}_"
                  f"volume_acceptance {r['volume_accepted']}/"
                  f"{r['volume_attempts']}  npt_{k}_mean_volume "
                  f"{r['mean_volume']:.2f}  npt_{k}_volume_drift "
                  f"{r['volume_drift']:+.3e}" for k, r in npt_reps.items())
        + f"  npt_volume_attempt_ms "
        f"{npt_reps['n2_hybrid']['volume_attempt_ms']:.3f}  npt_hybrid_b2_"
        f"share {npt_reps['n2_hybrid']['b2_share']:.4f}  npt_hybrid_device_"
        f"busy {npt_reps['n2_hybrid']['device_busy_share']:.4f}  "
        f"b4_c{C_HEADER}_header_ms {b4h['ms']:.4f}  b4_c{C_HEADER}_header_"
        f"device_ms {b4h['device_ms']:.4f}  b4_c{C_HEADER}_header_bound_ms "
        f"{b4h['bound_ms']:.5f}  "
        + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_swaps "
                    f"{r['swaps']}/{r['attempted']}  {k}_launches_per_round "
                    f"{r['launches_per_round']:.0f}"
                    for k, r in ptd_reps.items())
        + f"  npt_launches {npt_launches}  pt_driver_launches {ptd_launches}"
        f"  pr12_phases_seconds {t_12:.1f}  wall_seconds "
        f"{time.time() - t0:.1f}  ({smi})")
    log("  ".join(f"{k}_us_per_step {report[k]['ms'] * 1e3:.3f}  {k}_device_"
                  f"us_per_step {report[k]['device_ms'] * 1e3:.3f}  {k}_"
                  f"classical_device_us_per_step "
                  f"{report[k]['classical_device_ms'] * 1e3:.3f}  {k}_"
                  f"plain_us_per_step {report[k]['plain_ms'] * 1e3:.1f}  "
                  f"{k}_bound_us_per_step {report[k]['bound_ms'] * 1e3:.4f}"
                  for k in ("run_steps_uvt_fh2", "run_steps_uvt_fh4",
                            "run_steps_uvt_fk", "run_steps_fh2",
                            "run_steps_fh4", "run_steps_fk",
                            "run_steps_uvt_pda_fh2"))
        + "  " + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}"
                           for k, r in fh_reps.items())
        + f"  fh_launches {fh_launches}  pr13_phases_seconds {t_13:.1f}  "
        f"wall_seconds {time.time() - t0:.1f}  ({smi})")
    log("  ".join(f"{k}_us_per_step {report[k]['ms'] * 1e3:.3f}  {k}_device_"
                  f"us_per_step {report[k]['device_ms'] * 1e3:.3f}  {k}_"
                  f"classical_us_per_step "
                  f"{report[k]['classical_ms'] * 1e3:.3f}  {k}_classical_"
                  f"device_us_per_step "
                  f"{report[k]['classical_device_ms'] * 1e3:.3f}  {k}_plain_"
                  f"us_per_step {report[k]['plain_ms'] * 1e3:.1f}  {k}_bound_"
                  f"us_per_step {report[k]['bound_ms'] * 1e3:.4f}"
                  for k in ("run_steps_uvt_xt", "run_steps_uvt_xt_c32",
                            "run_steps_uvt_pda_xt"))
        + "  " + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}"
                           for k, r in xt_reps.items())
        + f"  xt_launches {xt_launches}  build_seconds {build_s:.1f}  "
        f"pr14_phases_seconds {t_14:.1f}  wall_seconds "
        f"{time.time() - t0:.1f}  ({smi})")
    b4g = report["mol_pair_grid"]
    log(f"b4_grid_ms {b4g['ms']:.4f}  b4_grid_device_ms "
        f"{b4g['device_ms']:.4f}  b4_grid_bound_ms {b4g['bound_ms']:.4f}  "
        f"qrot_refresh_ms {b4g['refresh_ms']:.1f} (b4 "
        f"{b4g['refresh_b4_ms']:.1f}, eigh {b4g['refresh_eigh_ms']:.1f})  "
        + "  ".join(f"{k}_us_per_step {r['ms'] * 1e3:.3f}  {k}_device_us_"
                    f"per_step {r['device_ms'] * 1e3:.3f}  {k}_without_"
                    f"device_us_per_step {r['without_device_ms'] * 1e3:.3f}"
                    f"  {k}_plain_us_per_step {r['plain_ms'] * 1e3:.1f}  "
                    f"{k}_bound_us_per_step {r['bound_ms'] * 1e3:.4f}"
                    for k, r in (("run_steps_uvt_sf",
                                  report["run_steps_uvt_sf"]),
                                 ("run_steps_uvt_sf_c32",
                                  report["run_steps_uvt_sf_c32"]),
                                 ("run_steps_sf", report["run_steps_sf"]),
                                 ("run_steps_sf_c16",
                                  report["run_steps_sf"]["c16"]),
                                 ("run_steps_uvt_pda_sf",
                                  report["run_steps_uvt_pda_sf"])))
        + "  " + "  ".join(
            f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_acc_spinflip "
            f"{r['acc_spinflip']:.4f}  {k}_ortho_fraction "
            f"{np.mean(r['ortho_fraction']):.4f}  {k}_refresh_ms "
            f"{r['refresh_ms']:.1f}" for k, r in sf_reps.items())
        + f"  sf_launches {sf_launches}  spinflip_phases_seconds {t_sf:.1f}  "
        f"wall_seconds {time.time() - t0:.1f}  ({smi})")
    log("  ".join(
        f"{k}_ms {r['ms']:.4f}  {k}_device_ms {r['device_ms']:.4f}  {k}_"
        f"plain_ms {r['plain_ms']:.3f}  {k}_bound_ms {r['bound_ms']:.5f}"
        for k, r in [(f"b2_{RD_KEY[f]}", report[f"pair_terms_{RD_KEY[f]}"])
                     for f in RD_FORMS]
        + [(f"b2_{RD_KEY[f]}_full",
            report[f"pair_terms_{RD_KEY[f]}"]["full"]) for f in RD_FORMS]
        + [(f"b4_{RD_KEY[f]}", report[f"mol_pair_{RD_KEY[f]}"])
           for f in RD_FORMS]
        + [(f"b4_{RD_KEY[f]}_c{C_RD_CHAINS}",
            report[f"mol_pair_{RD_KEY[f]}"]["c128"]) for f in RD_FORMS]
        + [(f"b4_{RD_KEY[f]}_grid", report[f"mol_pair_{RD_KEY[f]}"]["grid"])
           for f in RD_FORMS])
        + "  " + "  ".join(f"rd_{k}_steps_per_sec {r['steps_per_sec']:.2f}  "
                           f"rd_{k}_N {r['N']:.3f}"
                           for k, r in rd_reps.items())
        + f"  rd_launches {rd_launches}  build_seconds {build_s:.1f}  "
        f"rd_phases_seconds {t_rd:.1f}  wall_seconds {time.time() - t0:.1f}"
        f"  ({smi})")
    fused_rows = [(f"{n}_{k}", report[f"{n}_{k}"])
                  for n in ("run_steps_uvt", "run_steps", "run_steps_uvt_pda")
                  for k in FUSED_KEY.values()]
    wide_rows = ([(f"run_steps_uvt_{k}_c32", report[f"run_steps_uvt_{k}"][
        "c32"]) for k in FUSED_KEY.values()]
        + [(f"run_steps_{k}_c16", report[f"run_steps_{k}"]["c16"])
           for k in FUSED_KEY.values()])
    log("  ".join(
        f"{k}_us_per_step {r['ms'] * 1e3:.3f}  {k}_device_us_per_step "
        f"{r['device_ms'] * 1e3:.3f}  {k}_classical_us_per_step "
        f"{r['classical_ms'] * 1e3:.3f}  {k}_classical_device_us_per_step "
        f"{r['classical_device_ms'] * 1e3:.3f}"
        + (f"  {k}_plain_us_per_step {r['plain_ms'] * 1e3:.1f}  {k}_bound_"
           f"us_per_step {r['bound_ms'] * 1e3:.4f}" if "plain_ms" in r
           else f"  {k}_G {r['G']}")
        for k, r in fused_rows + wide_rows)
        + "  " + "  ".join(f"rdf_{k}_steps_per_sec {r['steps_per_sec']:.2f}"
                           for k, r in rdf_reps.items())
        + f"  rdf_launches {rdf_launches}  build_seconds {build_s:.1f}  "
        f"rd_fused_phases_seconds {t_rdf:.1f}  wall_seconds "
        f"{time.time() - t0:.1f}  ({smi})")
    b5h = report["dipole_field_c8_header"]
    log(f"b5_c{C_POLAR}_header_ms {b5h['ms']:.4f}  b5_c{C_POLAR}_header_"
        f"device_ms {b5h['device_ms']:.4f} / {b5h['device_ms_repeat']:.4f}  "
        f"b5_c{C_POLAR}_shared_ms {b5h['shared_ms']:.4f}  b5_c{C_POLAR}_"
        f"shared_device_ms {b5h['shared_device_ms']:.4f}  b5_c{C_POLAR}_"
        f"header_plain_ms {b5h['plain_ms']:.3f}  b5_c{C_POLAR}_header_bound_"
        f"ms {b5h['bound_ms']:.5f}  "
        + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_volume_"
                    f"acceptance {r['volume_accepted']}/{r['volume_attempts']}"
                    f"  {k}_mean_volume {r['mean_volume']:.1f}  {k}_volume_"
                    f"drift {r['volume_drift']:+.3e}  {k}_cg_iters_per_step "
                    f"{r['cg_iters_per_step']:.3f}  {k}_cg_iters_per_volume_"
                    f"attempt {r['cg_iters_per_volume_attempt']:.2f}  {k}_b5_"
                    f"launches {r['b5_launches']}"
                    for k, r in pnpt_reps.items())
        + "  " + "  ".join(f"{k}_steps_per_sec {r['steps_per_sec']:.2f}  {k}_"
                           f"eigensolve_ms {r['vdw_ms']:.2f}  {k}_eigensolve_"
                           f"share {r['vdw_share_of_step']:.4f}"
                           for k, r in vdw_reps.items())
        + f"  rd_crystal_steps_per_sec {cry_rep['steps_per_sec']:.2f}  "
        f"spectre_steps_per_sec {spc_rep['steps_per_sec']:.2f}  "
        f"qvib_steps_per_sec {qv_rep['steps_per_sec']:.2f}  qvib_refresh_ms "
        f"{qv_rep['refresh_ms']:.1f} (b4 grid {qv_rep['grid_launch_ms']:.1f})"
        f"  launches polar_npt {pnpt_launches} cdvdw {vdw_launches} "
        f"rd_crystal {cry_launches} spectre {spc_launches} qvib "
        f"{qv_launches}  slice19_phases_seconds {t_19:.1f}  wall_seconds "
        f"{time.time() - t0:.1f}  ({smi})")
    b2c = report["pair_terms_chains"]
    cul = cl_reps["culled"]
    log(f"b2_c{C_SURF}_ms {b2c['ms']:.4f}  b2_c{C_SURF}_device_ms "
        f"{b2c['device_ms']:.4f}  b2_c{C_SURF}_device_us_per_entry "
        f"{1e3 * b2c['device_ms'] / C_SURF:.3f}  b2_lone_dimer_ms "
        f"{b2c['lone_ms']:.4f}  b2_lone_dimer_device_ms "
        f"{b2c['lone_device_ms']:.4f}  b2_c{C_SURF}_plain_ms "
        f"{b2c['plain_ms']:.3f}  b2_c{C_SURF}_bound_ms {b2c['bound_ms']:.6f}"
        f"  culled_ms {cul['ms']:.4f}  culled_device_ms "
        f"{cul['device_ms']:.4f}  b4_rc{RC_CELL:g}_ms {cul['b4_ms']:.4f}  "
        f"b4_rc{RC_CELL:g}_device_ms {cul['b4_device_ms']:.4f}  "
        f"cell_cover {cul['cover']:.4f}  "
        + "  ".join(f"cell_list_{k}_steps_per_sec {r['steps_per_sec']:.2f}"
                    for k, r in cl_reps.items() if "steps_per_sec" in r)
        + "  " + "  ".join(f"mol_cache_{k}_steps_per_sec "
                           f"{r['steps_per_sec']:.2f}"
                           for k, r in mc_reps.items())
        + f"  mol_cache_build_ms {mc_reps['scan']['build_ms']:.1f}  "
        + "  ".join(f"{k}_seconds {r['seconds']:.2f}  {k}_batches_per_sec "
                    f"{r['batches_per_sec']:.1f}  {k}_well {r['well_min']:.4f}"
                    f"@{r['well_r']:.2f}" for k, r in surf_reps.items()
                    if "seconds" in r)
        + "  " + "  ".join(f"{k}_sa_steps_per_sec "
                           f"{surf_reps[k]['sa_steps_per_sec']:.1f}  {k}_eps "
                           f"{surf_reps[k]['eps']:.4f}  {k}_sig "
                           f"{surf_reps[k]['sig']:.4f}"
                           for k in ("surf_fit", "surf_multi_fit"))
        + f"  launches cell_list {cl_launches} mol_cache {mc_launches} surf "
        f"{surf_launches}  cell_cache_surf_phases_seconds {t_ccs:.1f}  wall_seconds "
        f"{time.time() - t0:.1f}  ({smi})")
    log("  ".join(f"analyze_{k}_seconds {r['seconds']:.3f}" if k in (
        "pore", "asa") else f"analyze_{k}_frames_per_sec "
        f"{r['frames_per_sec']:.2f}" for k, r in analyze_rep.items())
        + f"  ({smi})")
    log(f"multi-device phases (two ranks sharing one card) {t_md:.1f} s; "
        f"wall_seconds {time.time() - t0:.1f}  ({smi})")
    cf = cl_reps["culled_f32"]
    log("cell_list_f32 " + "  ".join(
        f"{f}_gap {g:.3e} {f}_bound {b:.3e}" for f, g, b in
        zip(cf["fields"], cf["gap"], cf["bound"])) + f"  ({smi})")
    n_fz, fz_launches, fz_share, fz_where, fz_s = fuzz
    log(f"phase_fuzz entries {n_fz}  launches {fz_launches}  "
        f"largest_tolerance_share {fz_share:.4f} ({fz_where})  seconds "
        f"{fz_s:.1f}  wall_seconds {time.time() - t0:.1f}  ({smi})")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-references"]:
        cpu_references(sys.argv[2])
    elif sys.argv[1:2] == ["--replay-references"]:
        replay_references(sys.argv[2])
    elif sys.argv[1:2] == ["--md-rank"]:
        md_rank(*sys.argv[2:8])
    else:
        main()
