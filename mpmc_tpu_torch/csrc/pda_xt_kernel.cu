// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh), with the µVT extras of the reference
// (mpmc_tpu/ops/pallas/mc_kernel.py:2118-2124, :2596-2612): cavity-biased
// insertion, the tmmc_bias tilt of the stage-1 test, and the spinflip move
// (:2213-2221, :2275-2284; mc_common.cuh XtArgs).
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_ENTRY(f32, float, true)
RUN_STEPS_UVT_PDA_ENTRY(f64, double, true)
