// B2 and B4 (pair_kernel.cuh) with rd dreiding, the Dreiding
// exponential-6 (ops/potentials.py dreiding_energy): an instance of its own.
#include "pair_kernel.cuh"

PAIR_RD_ENTRIES(RD_DREIDING, f32, float)
PAIR_RD_ENTRIES(RD_DREIDING, f64, double)
