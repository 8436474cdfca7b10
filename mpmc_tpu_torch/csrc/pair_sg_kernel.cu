// B2 and B4 (pair_kernel.cuh) with rd sg, the Silvera-Goldman H2-H2
// potential (ops/potentials.py sg_energy): an instance of its own.
#include "pair_kernel.cuh"

PAIR_RD_ENTRIES(RD_SG, f32, float)
PAIR_RD_ENTRIES(RD_SG, f64, double)
