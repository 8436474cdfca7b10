// B3, the fused NVT/NVE step loop (nvt_kernel.cuh), with rd
// disp_expansion, Born-Mayer repulsion and the (Tang-Toennies damped)
// C6/C8/C10 dispersion with the C planes in the slice (rd_forms.cuh;
// mpmc_tpu/ops/pallas/mc_kernel.py:173-187, :260-261, :344-347, :398-400):
// its SF instance, an instance of its own; a displacement moves no tail.
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_FORM_ENTRY(RD_DISP, f32, float)
RUN_STEPS_NVT_FORM_ENTRY(RD_DISP, f64, double)
