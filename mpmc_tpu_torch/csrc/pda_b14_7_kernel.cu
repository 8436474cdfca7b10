// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with rd b14_7, Halgren's buffered 14-7 (rd_forms.cuh;
// mpmc_tpu/ops/pallas/mc_kernel.py:173-187): its XT instances, of its own.
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_B14_7, f32, float)
RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_B14_7, f64, double)
