// B1, the fused µVT step loop (uvt_kernel.cuh), with rd b14_7, Halgren's
// buffered 14-7 (rd_forms.cuh; mpmc_tpu/ops/pallas/mc_kernel.py:173-187):
// its XT instance, an instance of its own.
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_FORM_ENTRY(RD_B14_7, f32, float)
RUN_STEPS_UVT_FORM_ENTRY(RD_B14_7, f64, double)
