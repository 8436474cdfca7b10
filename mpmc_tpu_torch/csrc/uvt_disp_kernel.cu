// B1, the fused µVT step loop (uvt_kernel.cuh), with rd disp_expansion,
// Born-Mayer repulsion and the (Tang-Toennies damped) C6/C8/C10 dispersion
// with the C planes in the slice (rd_forms.cuh; mpmc_tpu/ops/pallas/
// mc_kernel.py:173-187, :1154-1157, :1302-1304): its XT instance, an
// instance of its own; the count-dependent tail is the wrapper's c1/cx.
#include "uvt_kernel.cuh"

RUN_STEPS_UVT_FORM_ENTRY(RD_DISP, f32, float)
RUN_STEPS_UVT_FORM_ENTRY(RD_DISP, f64, double)
