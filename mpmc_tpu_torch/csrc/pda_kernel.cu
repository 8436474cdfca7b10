// B6, the stage-1 kernel of the fused polar delayed acceptance
// (pda_kernel.cuh): its instances without the µVT extras (those build in
// pda_xt_kernel.cu, with their own nvcc, so the two compile in parallel).
#include "pda_kernel.cuh"

RUN_STEPS_UVT_PDA_ENTRY(f32, float, false)
RUN_STEPS_UVT_PDA_ENTRY(f64, double, false)
