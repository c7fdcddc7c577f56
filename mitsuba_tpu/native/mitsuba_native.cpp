// Native runtime components for mitsuba_tpu.
//
// The reference keeps its hot host-side paths in C++ (mesh parsing in
// src/shapes/obj.cpp, image codecs in src/libcore/bitmap.cpp); this
// renderer does the same for the host-side loaders that feed scene
// compilation — the device compute path stays JAX/XLA. Exposed
// through a small C ABI consumed by ctypes (mitsuba_tpu/native/__init__.py)
// with pure-Python fallbacks when no compiler is available.
//
// Components:
//  * Wavefront OBJ parser (two-pass: count then fill; fan triangulation,
//    negative-index resolution, usemtl group ids) — ref: obj.cpp
//  * Radiance RGBE (.hdr) codec, old-style + RLE scanlines — the Bitmap
//    ERGBE format (ref: bitmap.cpp writeRGBE/readRGBE)
//  * Woop triangle-transform packing (the scene compiler's O(T) hot loop)

//  * OpenEXR ZIP/ZIPS chunk codec (reorder + delta predictor + zlib) and
//    HALF<->FLOAT conversion — the compressed-EXR subset of the Bitmap
//    OpenEXR path (ref: bitmap.cpp readOpenEXR/writeOpenEXR)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

// Counts entities in an OBJ buffer. out = {nv, nvn, nvt, ntri, ngroups}.
// A face with k vertices contributes k-2 triangles (fan).
void obj_count(const char* text, int64_t len, int64_t* out) {
    int64_t nv = 0, nvn = 0, nvt = 0, ntri = 0, ngroups = 1;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        // skip leading spaces
        while (p < end && (*p == ' ' || *p == '\t')) p++;
        if (p + 1 < end && p[0] == 'v') {
            if (p[1] == ' ' || p[1] == '\t') nv++;
            else if (p[1] == 'n') nvn++;
            else if (p[1] == 't') nvt++;
        } else if (p < end && p[0] == 'f') {
            int verts = 0;
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && (*q == ' ' || *q == '\t')) q++;
                if (q < end && *q != '\n' && *q != '\r') {
                    verts++;
                    while (q < end && *q != ' ' && *q != '\t' && *q != '\n')
                        q++;
                }
            }
            if (verts >= 3) ntri += verts - 2;
        } else if (p + 5 < end && strncmp(p, "usemtl", 6) == 0) {
            ngroups++;
        }
        while (p < end && *p != '\n') p++;
        p++;
    }
    out[0] = nv; out[1] = nvn; out[2] = nvt; out[3] = ntri;
    out[4] = ngroups;
}

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) p++;
    return p;
}

static inline const char* parse_double(const char* p, const char* end,
                                       double* out) {
    char* q;
    *out = strtod(p, &q);
    (void)end;
    return q;
}

// Fills pre-allocated arrays. Faces are triangulated; missing uv/normal
// indices are -1. group_id[t] indexes the usemtl group of triangle t;
// group name offsets are written as byte ranges into `text`
// (gname_beg/gname_end, capacity = ngroups from obj_count).
// Returns the number of groups actually used.
int64_t obj_parse(const char* text, int64_t len,
                  double* verts, double* norms, double* uvs,
                  int64_t* tri_v, int64_t* tri_t, int64_t* tri_n,
                  int32_t* group_id,
                  int64_t* gname_beg, int64_t* gname_end) {
    const char* p = text;
    const char* end = text + len;
    int64_t iv = 0, ivn = 0, ivt = 0, itri = 0;
    int64_t ngroups = 1;
    int32_t cur_group = 0;
    gname_beg[0] = 0; gname_end[0] = 0;   // "default"
    // counts needed to resolve negative indices
    int64_t cv = 0, cvt = 0, cvn = 0;

    while (p < end) {
        p = skip_ws(p, end);
        const char* line_end = p;
        while (line_end < end && *line_end != '\n') line_end++;

        if (p + 1 < end && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == '\t')) {
            const char* q = p + 1;
            for (int k = 0; k < 3; k++) {
                q = skip_ws(q, line_end);
                q = parse_double(q, line_end, &verts[iv * 3 + k]);
            }
            iv++; cv++;
        } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n') {
            const char* q = p + 2;
            for (int k = 0; k < 3; k++) {
                q = skip_ws(q, line_end);
                q = parse_double(q, line_end, &norms[ivn * 3 + k]);
            }
            ivn++; cvn++;
        } else if (p + 2 < end && p[0] == 'v' && p[1] == 't') {
            const char* q = p + 2;
            for (int k = 0; k < 2; k++) {
                q = skip_ws(q, line_end);
                q = parse_double(q, line_end, &uvs[ivt * 2 + k]);
            }
            ivt++; cvt++;
        } else if (p < end && p[0] == 'f' &&
                   (p + 1 >= end || p[1] == ' ' || p[1] == '\t')) {
            // gather up to 64 corners: v/vt/vn triples
            int64_t fv[64], ft[64], fn[64];
            int corners = 0;
            const char* q = p + 1;
            while (q < line_end && corners < 64) {
                q = skip_ws(q, line_end);
                if (q >= line_end || *q == '\r') break;
                char* r;
                int64_t a = strtoll(q, &r, 10);
                int64_t b = 0, c = 0;
                bool has_t = false, has_n = false;
                if (*r == '/') {
                    r++;
                    if (*r != '/') {
                        b = strtoll(r, &r, 10);
                        has_t = true;
                    }
                    if (*r == '/') {
                        r++;
                        c = strtoll(r, &r, 10);
                        has_n = true;
                    }
                }
                fv[corners] = a > 0 ? a - 1 : cv + a;
                ft[corners] = has_t ? (b > 0 ? b - 1 : cvt + b) : -1;
                fn[corners] = has_n ? (c > 0 ? c - 1 : cvn + c) : -1;
                corners++;
                q = r;
            }
            for (int k = 1; k + 1 < corners; k++) {
                tri_v[itri * 3 + 0] = fv[0];
                tri_v[itri * 3 + 1] = fv[k];
                tri_v[itri * 3 + 2] = fv[k + 1];
                tri_t[itri * 3 + 0] = ft[0];
                tri_t[itri * 3 + 1] = ft[k];
                tri_t[itri * 3 + 2] = ft[k + 1];
                tri_n[itri * 3 + 0] = fn[0];
                tri_n[itri * 3 + 1] = fn[k];
                tri_n[itri * 3 + 2] = fn[k + 1];
                group_id[itri] = cur_group;
                itri++;
            }
        } else if (p + 6 < end && strncmp(p, "usemtl", 6) == 0) {
            const char* q = skip_ws(p + 6, line_end);
            const char* name_end = line_end;
            while (name_end > q && (name_end[-1] == '\r'
                   || name_end[-1] == ' ')) name_end--;
            gname_beg[ngroups] = q - text;
            gname_end[ngroups] = name_end - text;
            cur_group = (int32_t)ngroups;
            ngroups++;
        }
        p = line_end + 1;
    }
    return ngroups;
}

// ---------------------------------------------------------------------------
// Radiance RGBE (.hdr) codec — ref: Bitmap ERGBE (bitmap.cpp)
// ---------------------------------------------------------------------------

static inline void float2rgbe(const float* rgb, uint8_t* rgbe) {
    float v = rgb[0];
    if (rgb[1] > v) v = rgb[1];
    if (rgb[2] > v) v = rgb[2];
    if (v < 1e-32f) {
        rgbe[0] = rgbe[1] = rgbe[2] = rgbe[3] = 0;
    } else {
        int e;
        float m = frexpf(v, &e);
        float scale = m * 256.0f / v;
        rgbe[0] = (uint8_t)(rgb[0] * scale);
        rgbe[1] = (uint8_t)(rgb[1] * scale);
        rgbe[2] = (uint8_t)(rgb[2] * scale);
        rgbe[3] = (uint8_t)(e + 128);
    }
}

static inline void rgbe2float(const uint8_t* rgbe, float* rgb) {
    if (rgbe[3]) {
        float f = ldexpf(1.0f, (int)rgbe[3] - (128 + 8));
        rgb[0] = rgbe[0] * f;
        rgb[1] = rgbe[1] * f;
        rgb[2] = rgbe[2] * f;
    } else {
        rgb[0] = rgb[1] = rgb[2] = 0.0f;
    }
}

// Encode [h, w, 3] float RGB to RLE RGBE scanline data. `out` must hold
// at least h * (4 + w * 8) bytes; returns the byte count written.
int64_t rgbe_encode(const float* img, int64_t w, int64_t h, uint8_t* out) {
    uint8_t* o = out;
    for (int64_t y = 0; y < h; y++) {
        // new-style RLE scanline header
        *o++ = 2; *o++ = 2;
        *o++ = (uint8_t)(w >> 8); *o++ = (uint8_t)(w & 0xff);
        // build the 4 planes
        for (int c = 0; c < 4; c++) {
            int64_t x = 0;
            while (x < w) {
                // find a run of >= 4 equal bytes
                uint8_t px[4];
                int64_t run_start = x, run_len = 0;
                uint8_t run_val = 0;
                for (int64_t i = x; i < w; i++) {
                    float2rgbe(&img[(y * w + i) * 3], px);
                    uint8_t v = px[c];
                    if (run_len == 0 || v != run_val) {
                        run_start = i; run_val = v; run_len = 1;
                    } else if (++run_len >= 4) {
                        break;
                    }
                }
                if (run_len >= 4) {
                    // literal up to run_start, then the run
                    int64_t lit = run_start - x;
                    while (lit > 0) {
                        int64_t n = lit > 128 ? 128 : lit;
                        *o++ = (uint8_t)n;
                        for (int64_t i = 0; i < n; i++) {
                            float2rgbe(&img[(y * w + x + i) * 3], px);
                            *o++ = px[c];
                        }
                        x += n; lit -= n;
                    }
                    // extend the run as far as it goes
                    int64_t rl = 0;
                    while (x + rl < w) {
                        float2rgbe(&img[(y * w + x + rl) * 3], px);
                        if (px[c] != run_val) break;
                        rl++;
                    }
                    while (rl > 0) {
                        int64_t n = rl > 127 ? 127 : rl;
                        *o++ = (uint8_t)(128 + n);
                        *o++ = run_val;
                        x += n; rl -= n;
                    }
                } else {
                    // literal to end of scanline
                    int64_t lit = w - x;
                    while (lit > 0) {
                        int64_t n = lit > 128 ? 128 : lit;
                        *o++ = (uint8_t)n;
                        for (int64_t i = 0; i < n; i++) {
                            float2rgbe(&img[(y * w + x + i) * 3], px);
                            *o++ = px[c];
                        }
                        x += n; lit -= n;
                    }
                }
            }
        }
    }
    return o - out;
}

// Decode RGBE scanline data (RLE or flat) into [h, w, 3] floats.
// Returns 0 on success.
int32_t rgbe_decode(const uint8_t* data, int64_t len, int64_t w, int64_t h,
                    float* img) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint8_t* line = (uint8_t*)malloc((size_t)w * 4);
    if (!line) return -2;
    for (int64_t y = 0; y < h; y++) {
        if (p + 4 > end) { free(line); return -1; }
        if (p[0] == 2 && p[1] == 2 && ((p[2] << 8) | p[3]) == w) {
            p += 4;
            for (int c = 0; c < 4; c++) {
                int64_t x = 0;
                while (x < w) {
                    if (p >= end) { free(line); return -1; }
                    int n = *p++;
                    if (n > 128) {
                        n -= 128;
                        if (p >= end || x + n > w) {
                            free(line); return -1;
                        }
                        memset(line + x * 4 + c, 0, 0);
                        uint8_t v = *p++;
                        for (int i = 0; i < n; i++)
                            line[(x + i) * 4 + c] = v;
                        x += n;
                    } else {
                        if (p + n > end || x + n > w) {
                            free(line); return -1;
                        }
                        for (int i = 0; i < n; i++)
                            line[(x + i) * 4 + c] = *p++;
                        x += n;
                    }
                }
            }
            for (int64_t x = 0; x < w; x++)
                rgbe2float(&line[x * 4], &img[(y * w + x) * 3]);
        } else {
            // old-style flat scanline (with possible +exp repeats)
            int64_t x = 0;
            int shift = 0;
            while (x < w) {
                if (p + 4 > end) { free(line); return -1; }
                if (p[0] == 1 && p[1] == 1 && p[2] == 1) {
                    int64_t n = (int64_t)p[3] << shift;
                    if (x == 0 || x + n > w) { free(line); return -1; }
                    for (int64_t i = 0; i < n; i++) {
                        memcpy(&img[(y * w + x + i) * 3],
                               &img[(y * w + x - 1) * 3],
                               3 * sizeof(float));
                    }
                    x += n; shift += 8; p += 4;
                } else {
                    rgbe2float(p, &img[(y * w + x) * 3]);
                    x++; shift = 0; p += 4;
                }
            }
        }
    }
    free(line);
    return 0;
}

// ---------------------------------------------------------------------------
// Woop transform packing — scene-compile hot loop
// (accel/dense.py build_woop semantics: affine transform mapping each
// world triangle to the canonical unit triangle)
// ---------------------------------------------------------------------------

// For each triangle (p0, e1, e2): invert M = [e1 e2 n] (columns) and
// compute trans = -M⁻¹·p0 — the per-triangle hot loop of build_woop
// (accel/dense.py:39; Python side does the final [4,3T]/[3,3T] packing).
// Degenerate triangles (|n| ≤ 1e-18, the padded far-away soup) get
// minv = 0, trans = (0, 0, 1): rays map to "parallel, no hit".
// out: minv [T, 9] row-major (minv[t][i][j]), trans [T, 3].
int32_t woop_invert(const double* p0, const double* e1, const double* e2,
                    int64_t t_count, double* minv, double* trans) {
    for (int64_t t = 0; t < t_count; t++) {
        const double* a = &e1[t * 3];
        const double* b = &e2[t * 3];
        const double* o = &p0[t * 3];
        double n[3] = {a[1] * b[2] - a[2] * b[1],
                       a[2] * b[0] - a[0] * b[2],
                       a[0] * b[1] - a[1] * b[0]};
        double n2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
        double* mi = &minv[t * 9];
        double* tr = &trans[t * 3];
        if (n2 <= 1e-36) {                 // |n| <= 1e-18
            for (int k = 0; k < 9; k++) mi[k] = 0.0;
            tr[0] = 0.0; tr[1] = 0.0; tr[2] = 1.0;
            continue;
        }
        // M columns are (e1, e2, n): m[r][c]
        double m[9] = {a[0], b[0], n[0],
                       a[1], b[1], n[1],
                       a[2], b[2], n[2]};
        double det = m[0] * (m[4] * m[8] - m[5] * m[7])
                   - m[1] * (m[3] * m[8] - m[5] * m[6])
                   + m[2] * (m[3] * m[7] - m[4] * m[6]);
        double id = 1.0 / det;
        mi[0] = (m[4] * m[8] - m[5] * m[7]) * id;
        mi[1] = (m[2] * m[7] - m[1] * m[8]) * id;
        mi[2] = (m[1] * m[5] - m[2] * m[4]) * id;
        mi[3] = (m[5] * m[6] - m[3] * m[8]) * id;
        mi[4] = (m[0] * m[8] - m[2] * m[6]) * id;
        mi[5] = (m[2] * m[3] - m[0] * m[5]) * id;
        mi[6] = (m[3] * m[7] - m[4] * m[6]) * id;
        mi[7] = (m[1] * m[6] - m[0] * m[7]) * id;
        mi[8] = (m[0] * m[4] - m[1] * m[3]) * id;
        for (int r = 0; r < 3; r++)
            tr[r] = -(mi[r * 3] * o[0] + mi[r * 3 + 1] * o[1]
                      + mi[r * 3 + 2] * o[2]);
    }
    return 0;
}

// PLY binary face-list parser (ref: the vendored C parser under
// src/shapes/ply/ — list properties force a per-face loop, which is the
// host-side hot path for multi-million-face scans). Reads `count`
// variable-length index lists (count_size-byte count followed by
// idx_size-byte indices, little or big endian), fan-triangulates, and
// writes int64 triples. Two-phase use: pass out == NULL to get the
// triangle count, then call again with a buffer of 3*n_tris int64s.
// Returns the triangle count, or -1 on truncated/oversized input.
static inline uint64_t rd_uint(const uint8_t* p, int size, int big) {
    uint64_t v = 0;
    if (big) { for (int i = 0; i < size; i++) v = (v << 8) | p[i]; }
    else     { for (int i = size - 1; i >= 0; i--) v = (v << 8) | p[i]; }
    return v;
}

int64_t ply_parse_faces(const uint8_t* data, int64_t len, int64_t count,
                        int32_t count_size, int32_t idx_size,
                        int32_t big_endian, int64_t* out,
                        int64_t* consumed) {
    int64_t pos = 0, n_tri = 0;
    for (int64_t f = 0; f < count; f++) {
        if (pos + count_size > len) return -1;
        uint64_t k = rd_uint(&data[pos], count_size, big_endian);
        pos += count_size;
        if (k > 255 || pos + (int64_t)k * idx_size > len) return -1;
        if (out != NULL && k >= 3) {
            int64_t i0 = (int64_t)rd_uint(&data[pos], idx_size,
                                          big_endian);
            int64_t prev = (int64_t)rd_uint(&data[pos + idx_size],
                                            idx_size, big_endian);
            for (uint64_t j = 2; j < k; j++) {
                int64_t cur = (int64_t)rd_uint(
                    &data[pos + j * idx_size], idx_size, big_endian);
                out[n_tri * 3 + 0] = i0;
                out[n_tri * 3 + 1] = prev;
                out[n_tri * 3 + 2] = cur;
                prev = cur;
                n_tri++;
            }
        } else if (k >= 3) {
            n_tri += (int64_t)k - 2;
        }
        pos += (int64_t)k * idx_size;
    }
    if (consumed != NULL) *consumed = pos;
    return n_tri;
}

// ---------------------------------------------------------------------------
// OpenEXR ZIP/ZIPS chunk codec
// ---------------------------------------------------------------------------
// EXR's ZIP compression wraps zlib with two reversible transforms that
// make float/half scanlines compress well: an interleave "reorder" that
// splits the byte stream into two halves (high/low bytes of half data end
// up contiguous) and a byte-wise delta predictor. Layout and transforms
// follow the OpenEXR file-format specification (ZIP = 16 scanlines per
// chunk, ZIPS = 1). Ref role: src/libcore/bitmap.cpp readOpenEXR —
// the reference links the OpenEXR library; here the subset is native.

// Uncompress one chunk: inflate `src` into a temp buffer of raw_size
// bytes, undo the predictor, then un-reorder into dst. If src_len ==
// raw_size the chunk was stored raw (OpenEXR stores incompressible
// chunks verbatim). Returns 0 on success.
int32_t exr_zip_uncompress(const uint8_t* src, int64_t src_len,
                           uint8_t* dst, int64_t raw_size) {
    if (src_len == raw_size) {               // stored raw
        memcpy(dst, src, raw_size);
        return 0;
    }
    uint8_t* tmp = (uint8_t*)malloc(raw_size ? raw_size : 1);
    if (!tmp) return -1;
    uLongf out_len = (uLongf)raw_size;
    if (uncompress(tmp, &out_len, src, (uLong)src_len) != Z_OK
        || (int64_t)out_len != raw_size) {
        free(tmp);
        return -2;
    }
    // undo delta predictor (byte-wise running sum)
    for (int64_t i = 1; i < raw_size; i++)
        tmp[i] = (uint8_t)((int)tmp[i - 1] + (int)tmp[i] - 128);
    // un-reorder: interleave the two halves
    {
        const uint8_t* t1 = tmp;
        const uint8_t* t2 = tmp + (raw_size + 1) / 2;
        int64_t i = 0;
        while (i < raw_size) {
            dst[i++] = *t1++;
            if (i < raw_size) dst[i++] = *t2++;
        }
    }
    free(tmp);
    return 0;
}

// Compress one chunk: reorder + predictor + deflate. Returns the
// compressed size, or raw_size if the result would not be smaller (the
// caller must then store the chunk verbatim, per the EXR spec), or -1
// on allocation/zlib failure. dst capacity must be >= raw_size + 64.
int64_t exr_zip_compress(const uint8_t* raw, int64_t raw_size,
                         uint8_t* dst) {
    uint8_t* tmp = (uint8_t*)malloc(raw_size ? raw_size : 1);
    if (!tmp) return -1;
    // reorder: de-interleave into two halves
    {
        uint8_t* t1 = tmp;
        uint8_t* t2 = tmp + (raw_size + 1) / 2;
        int64_t i = 0;
        while (i < raw_size) {
            *t1++ = raw[i++];
            if (i < raw_size) *t2++ = raw[i++];
        }
    }
    // delta predictor
    {
        int prev = tmp[0];
        for (int64_t i = 1; i < raw_size; i++) {
            int cur = tmp[i];
            tmp[i] = (uint8_t)(cur - prev + (128 + 256));
            prev = cur;
        }
    }
    uLongf out_len = compressBound((uLong)raw_size);
    uint8_t* cbuf = (uint8_t*)malloc(out_len);
    if (!cbuf) { free(tmp); return -1; }
    int rc = compress2(cbuf, &out_len, tmp, (uLong)raw_size,
                       Z_DEFAULT_COMPRESSION);
    free(tmp);
    if (rc != Z_OK) { free(cbuf); return -1; }
    if ((int64_t)out_len >= raw_size) {      // incompressible: store raw
        free(cbuf);
        return raw_size;
    }
    memcpy(dst, cbuf, out_len);
    free(cbuf);
    return (int64_t)out_len;
}

// ---------------------------------------------------------------------------
// HALF <-> FLOAT (IEEE 754 binary16, as OpenEXR half)
// ---------------------------------------------------------------------------

void half_to_float(const uint16_t* src, int64_t n, float* dst) {
    for (int64_t i = 0; i < n; i++) {
        uint16_t h = src[i];
        uint32_t sign = (uint32_t)(h >> 15) << 31;
        uint32_t exp = (h >> 10) & 0x1F;
        uint32_t man = h & 0x3FF;
        uint32_t bits;
        if (exp == 0) {
            if (man == 0) {
                bits = sign;                       // +-0
            } else {                               // subnormal
                exp = 127 - 15 + 1;
                while (!(man & 0x400)) { man <<= 1; exp--; }
                man &= 0x3FF;
                bits = sign | (exp << 23) | (man << 13);
            }
        } else if (exp == 31) {                    // inf/nan
            bits = sign | 0x7F800000u | (man << 13);
        } else {
            bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
        }
        memcpy(&dst[i], &bits, 4);
    }
}

void float_to_half(const float* src, int64_t n, uint16_t* dst) {
    for (int64_t i = 0; i < n; i++) {
        uint32_t bits;
        memcpy(&bits, &src[i], 4);
        uint32_t sign = (bits >> 16) & 0x8000;
        int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
        uint32_t man = bits & 0x7FFFFF;
        uint16_t h;
        if (exp <= 0) {                            // underflow → subnormal/0
            if (exp < -10) {
                h = (uint16_t)sign;
            } else {
                man |= 0x800000;
                int shift = 14 - exp;
                uint32_t r = man >> shift;
                // round to nearest even
                if ((man >> (shift - 1)) & 1)
                    if ((man & ((1u << (shift - 1)) - 1)) || (r & 1)) r++;
                h = (uint16_t)(sign | r);
            }
        } else if (exp >= 31) {                    // overflow → inf (or nan)
            h = (uint16_t)(sign | 0x7C00 |
                           (((bits & 0x7F800000) == 0x7F800000 && man)
                            ? (man >> 13 ? man >> 13 : 1) : 0));
        } else {
            uint32_t r = (uint32_t)(exp << 10) | (man >> 13);
            if (man & 0x1000) {                    // round to nearest even
                if ((man & 0xFFF) || (r & 1)) r++;
            }
            h = (uint16_t)(sign | r);
        }
        dst[i] = h;
    }
}

}  // extern "C"
