// Native sample codec: the host-side hot loops of the engine.
//
// C++ counterpart of the reference's performance-critical C conversion
// paths: raw2real.h / real2raw.h (interleaved raw <-> planar float at
// integer scale, all PCM/float formats, byte-swapped variants) and
// dither_funs.h (mid-tread requantization, with and without HP-TPDF dither
// + {1,-1} error feedback -- the sequential recurrence that defeats numpy).
//
// Built as a plain shared object driven through ctypes (no pybind11 in the
// image). All functions are single-threaded per call; the Python layer
// parallelizes across channels/devices if needed.

#include <cstdint>
#include <cstring>
#include <cmath>

// 3-byte streams are assembled with explicit shifts, which is
// host-independent -- so their byte order must key on the STREAM's
// endianness, not the host-relative `swap` flag the word-sized paths
// use with bswap. fmt_is_big == (swap == host_is_little).
static const bool kHostLE =
    __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__;


extern "C" {

struct OvfStats {
    uint32_t n_overflows;
    int32_t intlargest;
    double largest;
};

// ---------------------------------------------------------------- decode
// raw (interleaved, n_frames x open_ch) -> out rows [n_sel][n_frames]
// at integer scale, matching raw2real.h semantics.
void bf_decode_f32(const uint8_t* raw, float* out, int64_t n_frames,
                   int32_t open_ch, const int32_t* sel, int32_t n_sel,
                   int32_t bytes, int32_t is_float, int32_t swap) {
    for (int32_t c = 0; c < n_sel; c++) {
        const int64_t ch = sel[c];
        float* o = out + (int64_t)c * n_frames;
        if (is_float) {
            if (bytes == 4) {
                const uint32_t* p = (const uint32_t*)raw + ch;
                for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                    uint32_t v = *p;
                    if (swap) v = __builtin_bswap32(v);
                    float f;
                    std::memcpy(&f, &v, 4);
                    o[i] = f;
                }
            } else {  // 8-byte float
                const uint64_t* p = (const uint64_t*)raw + ch;
                for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                    uint64_t v = *p;
                    if (swap) v = __builtin_bswap64(v);
                    double d;
                    std::memcpy(&d, &v, 8);
                    o[i] = (float)d;
                }
            }
        } else if (bytes == 1) {
            const int8_t* p = (const int8_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch)
                o[i] = (float)*p;
        } else if (bytes == 2) {
            const uint16_t* p = (const uint16_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                uint16_t v = *p;
                if (swap) v = __builtin_bswap16(v);
                o[i] = (float)(int16_t)v;
            }
        } else if (bytes == 3) {
            const uint8_t* p = raw + ch * 3;
            const int64_t stride = (int64_t)open_ch * 3;
            const bool be = ((bool)swap == kHostLE);
            for (int64_t i = 0; i < n_frames; i++, p += stride) {
                uint32_t v = be
                    ? ((uint32_t)p[2] | ((uint32_t)p[1] << 8) | ((uint32_t)p[0] << 16))
                    : ((uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16));
                o[i] = (float)((int32_t)(v << 8) >> 8);
            }
        } else {  // 4-byte int (S32 and S24_4: full int32 read)
            const uint32_t* p = (const uint32_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                uint32_t v = *p;
                if (swap) v = __builtin_bswap32(v);
                o[i] = (float)(int32_t)v;
            }
        }
    }
}

// -------------------------------------------------------------- quantize
// Mid-tread, no dither (dither_funs.h:70-114). x -> q (int32), stats updated.
void bf_quantize_nd(const float* x, int64_t n, int32_t bits, int32_t* q,
                    OvfStats* st) {
    const int32_t imax = (int32_t)((1u << (bits - 1)) - 1);
    const int32_t imin = -imax - 1;
    // the reference's float path promotes through the DOUBLE quantizer
    // (real2rawf_no_dither calls ditherd_real2int_no_dither,
    // fftw_convolver.c:447-450) with float-typed rmin/rmax arguments --
    // so: double arithmetic, float-rounded bounds (golden-verified)
    const double rmin = (double)(float)imin, rmax = (double)(float)imax;
    uint32_t novf = st->n_overflows;
    int32_t il = st->intlargest;
    double lg = st->largest;
    for (int64_t i = 0; i < n; i++) {
        double v = (double)x[i] + 0.5;
        if (v != v) {
            // NaN fails every range comparison; an unguarded
            // (int32_t) cast is UB. Saturate + count like the rows
            // variant (the reference aborts earlier, real2raw.h:27-31;
            // the engine's block NaN check is the abort path here).
            q[i] = imin;
            novf++;
            continue;
        }
        int32_t s;
        if (v < 0.0) {
            if (v <= rmin) {
                s = imin;
                novf++;
                if (-v > lg) lg = -v;
            } else {
                s = (int32_t)v - 1;
                // s can be INT32_MIN (x = -2^31 is in range); negate in
                // unsigned space -- plain -s is signed-overflow UB. The
                // wrapped value keeps the reference's observed behavior
                // (full-scale negative peak never recorded).
                if ((int32_t)(0u - (uint32_t)s) > il)
                    il = (int32_t)(0u - (uint32_t)s);
            }
        } else {
            if (v > rmax) {
                s = imax;
                novf++;
                if (v > lg) lg = v;
            } else {
                s = (int32_t)v;
                if (s > il) il = s;
            }
        }
        q[i] = s;
    }
    st->n_overflows = novf;
    st->intlargest = il;
    st->largest = lg;
}

// HP-TPDF dithered quantization with {1,-1} error feedback
// (dither_funs.h:7-68). dith[] holds the precomputed randmap values.
// sf[0], sf[1] carry the feedback state across blocks.
void bf_quantize_dither(const float* x, const float* dith, int64_t n,
                        int32_t bits, float* sf, int32_t* q, OvfStats* st) {
    const int32_t imax = (int32_t)((1u << (bits - 1)) - 1);
    const int32_t imin = -imax - 1;
    const float rmin = (float)imin, rmax = (float)imax;
    // bits==32: rmax rounds UP to 2^31, so d == 2^31 would pass
    // `d > rmax` and hit an out-of-range cast (UB; the reference shares
    // this edge, dither_funs.h:49). Define it as a clip: clip_hi is the
    // smallest float whose cast would overflow.
    const float clip_hi =
        (bits == 32) ? rmax : std::nextafterf(rmax, INFINITY);
    float sf0 = sf[0], sf1 = sf[1];
    uint32_t novf = st->n_overflows;
    int32_t il = st->intlargest;
    double lg = st->largest;
    for (int64_t i = 0; i < n; i++) {
        // difference first: the reference's `real_sample += sf[0] - sf[1]`
        // association; (x + sf0) - sf1 rounds differently in float32
        float real = x[i] + (sf0 - sf1);
        sf1 = sf0;
        float d = real + dith[i];
        if (d != d) {
            // NaN: saturate + count + reset the feedback so one bad
            // sample cannot poison every later block's error filter
            q[i] = imin;
            novf++;
            sf0 = 0.0f;
            continue;
        }
        int32_t s;
        // clip peak: compare the pre-dither value, store the dithered
        // one -- the reference's exact (quirky) accounting, which the
        // golden-vector tests pin (dither_funs.h:38-39,52-53)
        if (d < 0.0f) {
            if (d <= rmin) {
                s = imin;
                novf++;
                if (real < -lg) lg = (double)-d;
            } else {
                s = (int32_t)d - 1;
                // unsigned negate: no signed-overflow UB (see nd path)
                if ((int32_t)(0u - (uint32_t)s) > il)
                    il = (int32_t)(0u - (uint32_t)s);
            }
        } else {
            if (d >= clip_hi) {
                s = imax;
                novf++;
                if (real > lg) lg = (double)d;
            } else {
                s = (int32_t)d;
                if (s > il) il = s;
            }
        }
        sf0 = real - (float)s;
        q[i] = s;
    }
    sf[0] = sf0;
    sf[1] = sf1;
    st->n_overflows = novf;
    st->intlargest = il;
    st->largest = lg;
}

// Batched row variants: one call per device instead of one per channel,
// with per-row stats. The no-dither inner loop is written branch-light so
// the compiler can vectorize it.
void bf_quantize_nd_rows(const float* x, int32_t n_rows, int64_t n,
                         int32_t bits, int32_t* q, OvfStats* stats) {
    const int32_t imax = (int32_t)((1u << (bits - 1)) - 1);
    const int32_t imin = -imax - 1;
    // double arithmetic + float-rounded bounds, matching the scalar
    // variant / the reference's promotion through ditherd_ (see
    // bf_quantize_nd above; golden-verified)
    const double rmin = (double)(float)imin, rmax = (double)(float)imax;
    for (int32_t r = 0; r < n_rows; r++) {
        const float* xr = x + (int64_t)r * n;
        int32_t* qr = q + (int64_t)r * n;
        OvfStats* st = stats + r;
        uint32_t novf = 0;
        int32_t il = st->intlargest;
        double lgc = 0.0;  // max |v| among clipped samples this block
        for (int64_t i = 0; i < n; i++) {
            double v = (double)xr[i] + 0.5;
            // the float->int cast is well-defined only for in-range
            // values; clipped (and NaN, which fails both comparisons)
            // samples take the saturated constants instead, like the
            // scalar path's branch-guarded casts
            const bool in_range = (v > rmin) & (v <= rmax);
            const bool over = v > rmax;
            const bool clip = !in_range;
            int32_t s = in_range ? (int32_t)v - (v < 0.0)
                                 : (over ? imax : imin);
            novf += clip;
            double a = v < 0.0 ? -v : v;
            lgc = (clip && a > lgc) ? a : lgc;
            // unsigned negate: s == INT32_MIN (in-range x = -2^31, and
            // every imin-saturated clip) must not hit signed-overflow UB
            int32_t sa = s < 0 ? (int32_t)(0u - (uint32_t)s) : s;
            il = (!clip && sa > il) ? sa : il;
            qr[i] = s;
        }
        st->n_overflows += novf;
        st->intlargest = il;
        if (lgc > st->largest) st->largest = lgc;
    }
}

// ---------------------------------------------------------------- encode
// int32 rows [n_sel][n_frames] -> interleaved raw (real2raw.h packing).
void bf_encode_int(const int32_t* rows, uint8_t* raw, int64_t n_frames,
                   int32_t open_ch, const int32_t* sel, int32_t n_sel,
                   int32_t bytes, int32_t swap) {
    for (int32_t c = 0; c < n_sel; c++) {
        const int64_t ch = sel[c];
        const int32_t* r = rows + (int64_t)c * n_frames;
        if (bytes == 1) {
            int8_t* p = (int8_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch)
                *p = (int8_t)r[i];
        } else if (bytes == 2) {
            uint16_t* p = (uint16_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                uint16_t v = (uint16_t)(int16_t)r[i];
                *p = swap ? __builtin_bswap16(v) : v;
            }
        } else if (bytes == 3) {
            uint8_t* p = raw + ch * 3;
            const int64_t stride = (int64_t)open_ch * 3;
            const bool be = ((bool)swap == kHostLE);
            for (int64_t i = 0; i < n_frames; i++, p += stride) {
                uint32_t v = (uint32_t)r[i];
                if (be) {
                    p[0] = (uint8_t)(v >> 16);
                    p[1] = (uint8_t)(v >> 8);
                    p[2] = (uint8_t)v;
                } else {
                    p[0] = (uint8_t)v;
                    p[1] = (uint8_t)(v >> 8);
                    p[2] = (uint8_t)(v >> 16);
                }
            }
        } else {
            uint32_t* p = (uint32_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                uint32_t v = (uint32_t)r[i];
                *p = swap ? __builtin_bswap32(v) : v;
            }
        }
    }
}

// float rows -> interleaved raw floats, with overflow accounting
// (real2raw.h float path; ovfmax is overflow->max per channel).
void bf_encode_float(const float* rows, uint8_t* raw, int64_t n_frames,
                     int32_t open_ch, const int32_t* sel, int32_t n_sel,
                     int32_t bytes, int32_t swap, const double* ovfmax,
                     OvfStats* stats) {
    for (int32_t c = 0; c < n_sel; c++) {
        const int64_t ch = sel[c];
        const float* r = rows + (int64_t)c * n_frames;
        OvfStats* st = stats + c;
        const float mx = (float)ovfmax[c];
        uint32_t novf = st->n_overflows;
        double lg = st->largest;
        if (bytes == 4) {
            uint32_t* p = (uint32_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                float v = r[i];
                float a = std::fabs(v);
                if (a > mx) novf++;
                if (a > lg) lg = a;
                uint32_t u;
                std::memcpy(&u, &v, 4);
                *p = swap ? __builtin_bswap32(u) : u;
            }
        } else {
            uint64_t* p = (uint64_t*)raw + ch;
            for (int64_t i = 0; i < n_frames; i++, p += open_ch) {
                double v = (double)r[i];
                double a = std::fabs(v);
                if (a > mx) novf++;
                if (a > lg) lg = a;
                uint64_t u;
                std::memcpy(&u, &v, 8);
                *p = swap ? __builtin_bswap64(u) : u;
            }
        }
        st->n_overflows = novf;
        st->largest = lg;
    }
}

}  // extern "C"
