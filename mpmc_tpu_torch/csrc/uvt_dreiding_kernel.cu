// B1, the fused µVT step loop (uvt_kernel.cuh), with rd dreiding, the
// Dreiding exponential-6 (rd_forms.cuh; mpmc_tpu/ops/pallas/mc_kernel.py:
// 173-187): its XT instance, an instance of its own.
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_FORM_ENTRY(RD_DREIDING, f32, float)
RUN_STEPS_UVT_FORM_ENTRY(RD_DREIDING, f64, double)
