// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with rd dreiding, the Dreiding exponential-6
// (rd_forms.cuh; mpmc_tpu/ops/pallas/mc_kernel.py:173-187): its XT
// instances, of its own.
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_DREIDING, f32, float)
RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_DREIDING, f64, double)
