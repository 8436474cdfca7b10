// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with rd sg, the Silvera-Goldman H2-H2 potential
// (rd_forms.cuh; the reference's _pair_terms RD branch,
// mpmc_tpu/ops/pallas/mc_kernel.py:173-187): its XT instances, of its own.
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_SG, f32, float)
RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_SG, f64, double)
