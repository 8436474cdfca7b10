// B3, the fused NVT/NVE step loop (nvt_kernel.cuh), with rd b14_7,
// Halgren's buffered 14-7 (rd_forms.cuh; mpmc_tpu/ops/pallas/mc_kernel.py:
// 173-187): its SF instance, an instance of its own.
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_FORM_ENTRY(RD_B14_7, f32, float)
RUN_STEPS_NVT_FORM_ENTRY(RD_B14_7, f64, double)
