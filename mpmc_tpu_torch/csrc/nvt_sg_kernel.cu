// B3, the fused NVT/NVE step loop (nvt_kernel.cuh), with rd sg, the
// Silvera-Goldman H2-H2 potential (rd_forms.cuh; the reference's
// _pair_terms RD branch, mpmc_tpu/ops/pallas/mc_kernel.py:173-187): its SF
// instance, an instance of its own.
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_FORM_ENTRY(RD_SG, f32, float)
RUN_STEPS_NVT_FORM_ENTRY(RD_SG, f64, double)
