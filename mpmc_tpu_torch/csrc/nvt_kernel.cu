// B3, the fused NVT/NVE step loop (nvt_kernel.cuh): its classical and
// quantum instances, without the spinflip move (those build in
// nvt_sf_kernel.cu, with their own nvcc, so the two compile in parallel).
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_ENTRY(f32, float, false)
RUN_STEPS_NVT_ENTRY(f64, double, false)
