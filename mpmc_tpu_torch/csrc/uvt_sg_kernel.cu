// B1, the fused µVT step loop (uvt_kernel.cuh), with rd sg, the
// Silvera-Goldman H2-H2 potential (rd_forms.cuh; the reference's
// _pair_terms RD branch, mpmc_tpu/ops/pallas/mc_kernel.py:173-187): its XT
// instance, an instance of its own.
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_FORM_ENTRY(RD_SG, f32, float)
RUN_STEPS_UVT_FORM_ENTRY(RD_SG, f64, double)
