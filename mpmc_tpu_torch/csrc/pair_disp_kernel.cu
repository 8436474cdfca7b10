// B2 and B4 (pair_kernel.cuh) with rd disp_expansion, Born-Mayer repulsion
// and the (Tang-Toennies damped) C6/C8/C10 dispersion with its tail
// (ops/potentials.py disp_expansion_energy, disp_tail_coefficient): an
// instance of its own.
#include "pair_kernel.cuh"

PAIR_RD_ENTRIES(RD_DISP, f32, float)
PAIR_RD_ENTRIES(RD_DISP, f64, double)
