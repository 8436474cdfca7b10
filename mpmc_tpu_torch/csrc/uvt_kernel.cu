// B1, the fused µVT step loop (uvt_kernel.cuh): its classical and quantum
// instances, without the µVT extras (those build in uvt_xt_kernel.cu, with
// their own nvcc, so the two compile in parallel).
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_ENTRY(f32, float, false)
RUN_STEPS_UVT_ENTRY(f64, double, false)
