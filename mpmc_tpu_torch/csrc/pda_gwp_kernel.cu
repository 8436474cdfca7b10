// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with rd none or lj and coulomb gwp, the
// Gaussian-smeared charges of the width plane (rd_forms.cuh gwp_smear;
// mpmc_tpu/ops/pallas/mc_kernel.py:201-210): its XT instances, of its own.
// The RD form instances read gwp at run time (Opts.es 4).
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_FORM_ENTRY(FORM_GWP, f32, float)
RUN_STEPS_UVT_PDA_FORM_ENTRY(FORM_GWP, f64, double)
