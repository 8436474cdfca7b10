// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with rd disp_expansion, Born-Mayer repulsion and the
// (Tang-Toennies damped) C6/C8/C10 dispersion with the C planes in the
// slice (rd_forms.cuh; mpmc_tpu/ops/pallas/mc_kernel.py:173-187,
// :2168-2169, :2305-2308, :2416-2418, :2451-2458): its XT instances, of its
// own - PHAHST's shape with Thole polarization.
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_DISP, f32, float)
RUN_STEPS_UVT_PDA_FORM_ENTRY(RD_DISP, f64, double)
