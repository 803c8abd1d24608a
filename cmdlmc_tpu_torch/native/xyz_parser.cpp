// Copied from cmdlmc_tpu/native/xyz_parser.cpp (the port keeps its own copy; it never imports the JAX package).
// Fast xyz atom-line tokenizer for the trajectory streaming hot path.
//
// The reference parses every frame with np.genfromtxt through a Python
// generator chain (reference IO/trajectory_parser.py:217-249) — the dominant
// host cost when streaming millions of frames. This tokenizer turns a text
// block of atom lines ("name x y z\n" each) into a float32 position array in
// one pass, ~50-100x faster than per-frame genfromtxt, so the host never
// starves the TPU.
//
// Built as a shared library (see build.py) and bound via ctypes — no pybind11
// dependency.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_token(const char* p, const char* end) {
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
    return p;
}

// Minimal fast float parser: sign, digits, fraction, exponent.
inline const char* parse_float(const char* p, const char* end, float* out) {
    double sign = 1.0;
    if (p < end && (*p == '-' || *p == '+')) {
        if (*p == '-') sign = -1.0;
        ++p;
    }
    double val = 0.0;
    while (p < end && *p >= '0' && *p <= '9') {
        val = val * 10.0 + (*p - '0');
        ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            val += (*p - '0') * scale;
            scale *= 0.1;
            ++p;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        int esign = 1;
        if (p < end && (*p == '-' || *p == '+')) {
            if (*p == '-') esign = -1;
            ++p;
        }
        int ex = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            ex = ex * 10 + (*p - '0');
            ++p;
        }
        double factor = 1.0;
        double base = (esign > 0) ? 10.0 : 0.1;
        for (int i = 0; i < ex; ++i) factor *= base;
        val *= factor;
    }
    *out = static_cast<float>(sign * val);
    return p;
}

}  // namespace

extern "C" {

// Parse up to max_atoms atom lines from buf[0:len].
// out_pos: float32 array with room for max_atoms * 3.
// out_names: char array with room for first_names * name_width bytes; the
//            names of the first `first_names` lines are copied (space-padded).
// Returns the number of atom lines parsed, or -1 on a malformed line.
int64_t parse_atom_lines(const char* buf, int64_t len, int64_t max_atoms,
                         float* out_pos, char* out_names, int64_t first_names,
                         int64_t name_width) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t atom = 0;
    while (p < end && atom < max_atoms) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') {  // empty line
            ++p;
            continue;
        }
        const char* name_start = p;
        p = skip_token(p, end);
        if (atom < first_names) {
            int64_t n = p - name_start;
            if (n > name_width) n = name_width;
            char* dst = out_names + atom * name_width;
            memset(dst, ' ', name_width);
            memcpy(dst, name_start, n);
        }
        for (int d = 0; d < 3; ++d) {
            p = skip_ws(p, end);
            if (p >= end || *p == '\n') return -1;
            const char* q = p;
            p = parse_float(p, end, &out_pos[atom * 3 + d]);
            if (p == q) return -1;
        }
        // skip anything else on the line (extra columns tolerated)
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
        ++atom;
    }
    return atom;
}

}  // extern "C"
