// Native PQR codec of the port: the streaming trajectory reader of
// ``ensemble replay`` (mc/run.py::run_replay through io/native.py::
// stream_frames_arrays) and the frame writer of the per-corrtime restart,
// trajectory and per-chain files (io/pqr.py::write_state through
// io/native.py::write_frame_arrays).
//
// The port's own copy of the JAX package's native codec
// (native/mpmc_io.cpp: read_one_frame, the streaming handle and its
// accessors, pqr_write_frame; the Atom/Frame/File model and kNameLen of
// native/mpmc_common.h); only the streaming reader and the writer are
// copied.  Built with g++ into build/mpmc_tpu_torch/ at first use
// (ops/cuda/_build.py::host_library) and loaded with ctypes.  Host code:
// no CUDA.
//
// Column contract (io/pqr.py):
//   ATOM serial name mol_name mol_id flag x y z mass charge polar eps sig
//        [omega c6 c8 c10 gwp_alpha]
// '#'/'!'/'REMARK' lines are comments, 'CRYST' sets the frame's cell and
// 'END'/'ENDMDL' ends a frame.
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNameLen = 8;   // fixed-width strings handed to Python

struct Atom {
    long serial;
    char name[kNameLen];
    char mol_name[kNameLen];
    long mol_id;
    char flag;
    double x, y, z, mass, charge, polar, eps, sig;
    double omega, c6, c8, c10, gwp_alpha;
};

struct Frame {
    std::vector<Atom> atoms;
    bool has_box = false;
    double box[6] = {0, 0, 0, 0, 0, 0};   // a b c alpha beta gamma
};

// A streaming handle: one frame in memory at a time (constant memory on
// trajectories of any length).
struct Stream {
    std::FILE* fp = nullptr;
    Frame frame;
    std::string error;
    long lineno = 0;
};

// split a line into whitespace tokens (in place, zero-copy)
int tokenize(char* line, char** tok, int max_tok) {
    int n = 0;
    char* p = line;
    while (*p && n < max_tok) {
        while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (!*p) break;
        tok[n++] = p;
        while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (*p) *p++ = '\0';
    }
    return n;
}

void copy_name(char* dst, const char* src) {
    std::strncpy(dst, src, kNameLen - 1);
    dst[kNameLen - 1] = '\0';
}

// Parse the next frame of s into s->frame (cleared first).  Returns 1 on
// a frame, 0 at EOF with no frame, -1 on a malformed line (error set).
int read_one_frame(Stream* s) {
    Frame* out = &s->frame;
    out->atoms.clear();
    out->has_box = false;
    char line[1024];
    char* tok[24];
    while (std::fgets(line, sizeof line, s->fp)) {
        ++s->lineno;
        // fast-path skip: comments and blank lines
        char* c = line;
        while (*c == ' ' || *c == '\t') ++c;
        if (*c == '\0' || *c == '\n' || *c == '#' || *c == '!') continue;
        if (!std::strncmp(c, "REMARK", 6)) continue;
        if (!std::strncmp(c, "CRYST", 5)) {
            int n = tokenize(line, tok, 24);
            if (n >= 7) {
                for (int k = 0; k < 6; ++k)
                    out->box[k] = std::strtod(tok[k + 1], nullptr);
                out->has_box = true;
            }
            continue;
        }
        if (!std::strncmp(c, "END", 3)) {   // END or ENDMDL
            if (!out->atoms.empty()) return 1;
            continue;
        }
        int n = tokenize(line, tok, 24);
        if (n == 0) continue;
        if (std::strcmp(tok[0], "ATOM") && std::strcmp(tok[0], "HETATM"))
            continue;
        if (n < 14) {
            char buf[128];
            std::snprintf(buf, sizeof buf,
                          "line %ld: ATOM needs >=14 fields, got %d",
                          s->lineno, n);
            s->error = buf;
            return -1;
        }
        Atom a{};
        a.serial = std::strtol(tok[1], nullptr, 10);
        copy_name(a.name, tok[2]);
        copy_name(a.mol_name, tok[3]);
        a.mol_id = std::strtol(tok[4], nullptr, 10);
        a.flag = static_cast<char>(
            std::toupper(static_cast<unsigned char>(tok[5][0])));
        a.x = std::strtod(tok[6], nullptr);
        a.y = std::strtod(tok[7], nullptr);
        a.z = std::strtod(tok[8], nullptr);
        a.mass = std::strtod(tok[9], nullptr);
        a.charge = std::strtod(tok[10], nullptr);
        a.polar = std::strtod(tok[11], nullptr);
        a.eps = std::strtod(tok[12], nullptr);
        a.sig = std::strtod(tok[13], nullptr);
        a.omega = n > 14 ? std::strtod(tok[14], nullptr) : 0.0;
        a.c6 = n > 15 ? std::strtod(tok[15], nullptr) : 0.0;
        a.c8 = n > 16 ? std::strtod(tok[16], nullptr) : 0.0;
        a.c10 = n > 17 ? std::strtod(tok[17], nullptr) : 0.0;
        a.gwp_alpha = n > 18 ? std::strtod(tok[18], nullptr) : 0.0;
        out->atoms.push_back(a);
    }
    return out->atoms.empty() ? 0 : 1;   // EOF flushes a trailing frame
}

}  // namespace

extern "C" {

// Open a streaming handle, or nullptr when the file cannot be opened.
void* pqr_open_stream(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* s = new Stream();
    s->fp = f;
    return s;
}

// Parse the handle's next frame (readable through pqr_frame_cell and
// pqr_frame_data).  Returns the frame's atom count, 0 at EOF, -3 on a
// parse error (message in pqr_error).
long pqr_stream_advance(void* h) {
    auto* s = static_cast<Stream*>(h);
    if (!s->error.empty()) return -3;
    int r = read_one_frame(s);
    if (r < 0) return -3;
    return r == 1 ? static_cast<long>(s->frame.atoms.size()) : 0;
}

const char* pqr_error(void* h) {
    auto* s = static_cast<Stream*>(h);
    return s->error.empty() ? nullptr : s->error.c_str();
}

// 1 if the frame carried a CRYST record (out = a b c alpha beta gamma).
long pqr_frame_cell(void* h, double* out) {
    const Frame& fr = static_cast<Stream*>(h)->frame;
    if (!fr.has_box) return 0;
    for (int k = 0; k < 6; ++k) out[k] = fr.box[k];
    return 1;
}

// Fill caller-allocated buffers: num [n,13] doubles (x y z mass charge
// polar eps sig omega c6 c8 c10 gwp_alpha), ids [n,2] (serial, mol_id),
// flags [n], names and mol_names [n * kNameLen].  Returns n.
long pqr_frame_data(void* h, double* num, long* ids, char* flags,
                    char* names, char* mol_names) {
    const auto& atoms = static_cast<Stream*>(h)->frame.atoms;
    for (size_t k = 0; k < atoms.size(); ++k) {
        const Atom& a = atoms[k];
        double* r = num + 13 * k;
        r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.mass;
        r[4] = a.charge; r[5] = a.polar; r[6] = a.eps; r[7] = a.sig;
        r[8] = a.omega; r[9] = a.c6; r[10] = a.c8; r[11] = a.c10;
        r[12] = a.gwp_alpha;
        ids[2 * k] = a.serial;
        ids[2 * k + 1] = a.mol_id;
        flags[k] = a.flag;
        std::memcpy(names + kNameLen * k, a.name, kNameLen);
        std::memcpy(mol_names + kNameLen * k, a.mol_name, kNameLen);
    }
    return static_cast<long>(atoms.size());
}

void pqr_close(void* h) {
    auto* s = static_cast<Stream*>(h);
    if (s->fp) std::fclose(s->fp);
    delete s;
}

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
