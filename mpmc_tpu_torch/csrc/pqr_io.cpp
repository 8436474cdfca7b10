// Native PQR frame writer of the port: the per-corrtime restart, trajectory
// and per-chain files (io/pqr.py::write_state through io/native.py).
//
// The port's own copy of the JAX package's native writer
// (native/mpmc_io.cpp::pqr_write_frame, with the fixed name width kNameLen
// of native/mpmc_common.h); only the writer is copied.  Built with g++ into
// build/mpmc_tpu_torch/ at first use (ops/cuda/_build.py::host_library) and
// loaded with ctypes.  Host code: no CUDA.
//
// Column contract (io/pqr.py):
//   ATOM serial name mol_name mol_id flag x y z mass charge polar eps sig
//        [omega c6 c8 c10 gwp_alpha]
#include <cstdio>

namespace {
constexpr int kNameLen = 8;   // fixed-width strings handed from Python
}  // namespace

extern "C" {

// Append one frame.  mode: "w" or "a".  num [n,13] doubles (x y z mass
// charge polar eps sig omega c6 c8 c10 gwp_alpha), ids [n,2] (serial,
// mol_id), flags [n], names and mol_names [n * kNameLen].  Returns the atoms
// written, -1 when the file cannot be opened.
long pqr_write_frame(const char* path, const char* mode, const char* remark,
                     long n, const double* num, const long* ids,
                     const char* flags, const char* names,
                     const char* mol_names, int extended) {
    FILE* f = std::fopen(path, mode);
    if (!f) return -1;
    if (remark && remark[0]) std::fprintf(f, "REMARK %s\n", remark);
    for (long k = 0; k < n; ++k) {
        const double* r = num + 13 * k;
        std::fprintf(f,
                     "ATOM  %6ld %-5.7s %-5.7s %5ld %c "
                     "%11.5f %11.5f %11.5f %9.4f %10.6f %8.4f "
                     "%10.5f %8.5f",
                     ids[2 * k], names + kNameLen * k,
                     mol_names + kNameLen * k, ids[2 * k + 1], flags[k],
                     r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]);
        if (extended)
            std::fprintf(f, " %9.5f %11.5f %11.5f %12.5f %8.5f",
                         r[8], r[9], r[10], r[11], r[12]);
        std::fputc('\n', f);
    }
    std::fputs("END\n", f);
    std::fclose(f);
    return n;
}

}  // extern "C"
