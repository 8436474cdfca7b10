// The classical instance of B2 and B4 (pair_kernel.cuh): rd none or lj,
// read at run time, as before the other forms were ported.
#include "pair_kernel.cuh"

PAIR_TERMS_ENTRY(f32, float)
PAIR_TERMS_ENTRY(f64, double)
MOL_PAIR_ENTRY(f32, float)
MOL_PAIR_ENTRY(f64, double)
