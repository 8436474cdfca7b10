// B3, the fused NVT/NVE step loop (nvt_kernel.cuh), with rd none or lj
// and coulomb gwp, the Gaussian-smeared charges of the width plane
// (rd_forms.cuh gwp_smear; mpmc_tpu/ops/pallas/mc_kernel.py:201-210): its
// SF instance, an instance of its own.  The RD form instances read gwp at
// run time (Opts.es 4).
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_FORM_ENTRY(FORM_GWP, f32, float)
RUN_STEPS_NVT_FORM_ENTRY(FORM_GWP, f64, double)
