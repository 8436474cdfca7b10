// B3, the fused NVT step loop (nvt_kernel.cuh), with the reference's
// spinflip move (mpmc_tpu/ops/pallas/mc_kernel.py:297-322, :493-500):
// lane 8 < p_spin flips the picked molecule's nuclear spin on its rotor
// free-energy difference; classical and quantum instances.
#include "nvt_kernel.cuh"

RUN_STEPS_NVT_ENTRY(f32, float, true)
RUN_STEPS_NVT_ENTRY(f64, double, true)
