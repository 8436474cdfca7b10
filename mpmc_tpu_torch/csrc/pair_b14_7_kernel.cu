// B2 and B4 (pair_kernel.cuh) with rd b14_7, Halgren's buffered 14-7
// (ops/potentials.py b14_7_energy): an instance of its own.
#include "pair_kernel.cuh"

PAIR_RD_ENTRIES(RD_B14_7, f32, float)
PAIR_RD_ENTRIES(RD_B14_7, f64, double)
