// B1, the fused µVT step loop (uvt_kernel.cuh), with the µVT extras of the
// reference (mpmc_tpu/ops/pallas/mc_kernel.py:941-976): cavity-biased
// insertion, the TMMC collection and its flat-histogram bias, and the
// spinflip move (:951-960, :1071-1079; mc_common.cuh XtArgs); classical
// and quantum instances.
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_ENTRY(f32, float, true)
RUN_STEPS_UVT_ENTRY(f64, double, true)
