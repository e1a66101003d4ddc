// K5 `match_masked`: masked Hamming matching with top-2, Lowe's ratio test,
// the mutual cross-check and the rotation-consistency histogram.
//
// Replaces corbslam_tpu/matching/matcher.py match_masked,
// projection_window_mask and rotation_consistency, with the part of
// corbslam_tpu/ops/descriptors.py they run (masked_hamming_matrix,
// best_match's top-2 + ratio, mutual_best), for the three callers of the
// tracking step: search_frame_frame (window mask, octave +-1, ratio 0.9,
// rotation check), search_by_projection_points (window mask, ratio 0.8) and
// search_by_descriptor (valid-only mask, ratio 0.7); and, for mono
// initialization and local mapping, search_for_initialization (a 100-px
// area window, ratio 0.9, rotation check) and search_for_triangulation with
// epipolar_band_mask (the band of the query's epipolar line, optionally the
// epipole guard, ratio 1.0, mutual), which create_new_points in
// corbslam_tpu/mapping/triangulation.py vmaps over the keyframe's
// neighbours: here one launch with a batch per neighbour.
//
// Bound on the H100: integer work of the candidate test: a validity test of
// each target for each valid query (up to 2048 x 8192 for the local map), a
// window test for each valid query x valid target pair and, where it
// passes, 8 XORs and 8 popcounts. An invalid query costs one flag read. The
// bytes are small (descriptors and keypoints, a few hundred KB,
// L2-resident), so the [Nq, Nt] mask and distance matrix the reference
// materializes are the thing to avoid.
// Design: `match_rows` is one 256-thread block per (query row, batch); a
// batch has its own targets, query flags and band geometry, and shares the
// queries' descriptors and keypoints. Threads stride
// over the targets, evaluate the mask inline (the window's d2 <= r^2 with
// explicitly rounded f32 operations in the reference's order, so no FMA
// moves a candidate across the radius) and keep a running top-2 of
// (distance, index): best distance, best index with the lower index on
// ties, and the second distance, which equals the best on a tie — exactly
// lax.top_k(-d, 2). Masked pairs count as distance 512. For the mutual
// check each thread does an atomicMin of (d << 32 | row) into a per-target
// key, pre-filled with (512 << 32 | 0), which is the column top-k's answer
// for a fully masked column; only unmasked pairs issue atomics. The mask
// modes: 0 validity only; 1 the projection window; 2 an area window
// (|xy_t - xy_q|^2 <= r^2, no octave test); 3 the epipolar band
// (CheckDistEpipolarLine: the line l = F12 (x, y, 1) of the query, then
// (l . (x_t, y_t, 1))^2 / max(a^2 + b^2, 1e-12) < 3.84 sigma^2 of the
// target's octave); 4 the band and the epipole guard
// (|xy_t - e|^2 > (sqrt(100 scale_t))^2). Every test runs in the
// reference's order of f32 operations with explicit rounding. A query
// that is itself invalid is a fully masked row (target 0 at 512, twice).
// `match_finish` is one block per batch for all its queries: the threshold,
// the ratio test
// as a strict < against the f32 product ratio * second, the mutual check,
// and for the rotation check a shared-memory 30-bin histogram of the
// floor-mod angle differences of the accepted matches, its top 3 bins (the
// lower bin on ties) and the reference's "more than a tenth of the top bin".

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int INF_DIST = 512;
constexpr unsigned long long COL_EMPTY = (unsigned long long)INF_DIST << 32;
constexpr float BAND_CHI2 = 3.84f;

struct Top2 {
    int d1, j1, d2;
};

__device__ __forceinline__ void push(Top2& a, int d, int j) {
    if (d < a.d1 || (d == a.d1 && j < a.j1)) {
        a.d2 = a.d1;
        a.d1 = d;
        a.j1 = j;
    } else if (d < a.d2) {
        a.d2 = d;
    }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
    const bool b_wins = b.d1 < a.d1 || (b.d1 == a.d1 && b.j1 < a.j1);
    const Top2& w = b_wins ? b : a;
    const Top2& l = b_wins ? a : b;
    return Top2{w.d1, w.j1, min(w.d2, l.d1)};
}

__device__ __forceinline__ int hamming256(uint4 a0, uint4 a1, uint4 b0, uint4 b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
           __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
           __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// l = F12 (x, y, 1): the epipolar line in image 2 of query point p.
__device__ __forceinline__ void epipolar_line(const float* F, float2 p, float& a, float& b,
                                              float& c) {
    a = __fadd_rn(__fadd_rn(__fmul_rn(p.x, F[0]), __fmul_rn(p.y, F[1])), F[2]);
    b = __fadd_rn(__fadd_rn(__fmul_rn(p.x, F[3]), __fmul_rn(p.y, F[4])), F[5]);
    c = __fadd_rn(__fadd_rn(__fmul_rn(p.x, F[6]), __fmul_rn(p.y, F[7])), F[8]);
}

// CheckDistEpipolarLine: target p against the line (a, b, c), the gate
// 3.84 sigma^2 with sigma^2 = scale^2 of the target's octave.
__device__ __forceinline__ bool in_band(float a, float b, float c, float2 p, float scale) {
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(a, p.x), __fmul_rn(b, p.y)), c);
    const float den2 = fmaxf(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), 1e-12f);
    return __fdiv_rn(__fmul_rn(num, num), den2) < __fmul_rn(BAND_CHI2, __fmul_rn(scale, scale));
}

// The epipole guard: |p - e|^2 > min_epi^2 with min_epi = sqrt(100 scale).
__device__ __forceinline__ bool outside_epipole(float2 p, float ex, float ey, float scale) {
    const float dx = __fsub_rn(p.x, ex), dy = __fsub_rn(p.y, ey);
    const float me = __fsqrt_rn(__fmul_rn(100.f, scale));
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > __fmul_rn(me, me);
}

constexpr int N_BINS = 30;
constexpr int KEEP_TOP = 3;
constexpr int ROWS_THREADS = 256;
constexpr int FINISH_THREADS = 1024;
constexpr int GEO_STRIDE = 11;  // per batch: F12 row-major (9) and the epipole (2)
enum MaskMode { M_VALID = 0, M_PROJECTION = 1, M_AREA = 2, M_BAND = 3, M_BAND_EPIPOLE = 4 };

__global__ void fill_cols_kernel(unsigned long long* __restrict__ col_key, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < n) col_key[j] = COL_EMPTY;
}

__global__ void __launch_bounds__(ROWS_THREADS) match_rows_kernel(
        const uint4* __restrict__ desc_q, const uint4* __restrict__ desc_t,
        const bool* __restrict__ valid_q, const bool* __restrict__ valid_t,
        const float2* __restrict__ uv_t, const float2* __restrict__ xy_q,
        const int* __restrict__ oct_q, const int* __restrict__ pred_t,
        const float* __restrict__ scales, const float* __restrict__ geo, float radius, int slack,
        int slack_up, int Nq, int Nt, int mode, int* __restrict__ best_d,
        int* __restrict__ best_j, int* __restrict__ second_d,
        unsigned long long* __restrict__ col_key) {
    __shared__ Top2 red[ROWS_THREADS / 32];
    const int q = blockIdx.x, t = threadIdx.x, batch = blockIdx.y;
    // The batch's own targets, query flags, geometry, outputs and column keys.
    const size_t bt = (size_t)batch * Nt, bq = (size_t)batch * Nq;
    desc_t += 2 * bt;
    valid_t += bt;
    if (uv_t) uv_t += bt;
    if (pred_t) pred_t += bt;
    if (geo) geo += batch * GEO_STRIDE;
    if (col_key) col_key += bt;
    valid_q += bq;
    best_d += bq;
    best_j += bq;
    second_d += bq;
    if (!valid_q[q]) {
        if (t == 0) {
            best_d[q] = INF_DIST;
            best_j[q] = 0;
            second_d[q] = INF_DIST;
        }
        return;
    }
    const uint4 a0 = desc_q[2 * q], a1 = desc_q[2 * q + 1];
    float2 pq = make_float2(0.f, 0.f);
    float r2 = 0.f, la = 0.f, lb = 0.f, lc = 0.f;
    int oq = 0;
    if (mode != M_VALID) pq = xy_q[q];
    if (mode == M_PROJECTION) {
        oq = oct_q[q];
        const float r = __fmul_rn(radius, scales[oq]);
        r2 = __fmul_rn(r, r);
    } else if (mode == M_AREA) {
        r2 = radius;  // the caller passes the squared radius
    } else if (mode >= M_BAND) {
        epipolar_line(geo, pq, la, lb, lc);
    }
    Top2 s{INT_MAX, INT_MAX, INT_MAX};
    for (int j = t; j < Nt; j += ROWS_THREADS) {
        bool m = valid_t[j];
        if (m && mode == M_PROJECTION) {
            const float2 u = uv_t[j];
            const float dx = __fsub_rn(u.x, pq.x), dy = __fsub_rn(u.y, pq.y);
            const int d_oct = oq - pred_t[j];
            m = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2 && d_oct >= -slack &&
                d_oct <= slack_up;
        } else if (m && mode == M_AREA) {
            const float2 u = uv_t[j];
            const float dx = __fsub_rn(pq.x, u.x), dy = __fsub_rn(pq.y, u.y);
            m = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2;
        } else if (m && mode >= M_BAND) {
            m = in_band(la, lb, lc, uv_t[j], scales[pred_t[j]]) &&
                (mode == M_BAND || outside_epipole(uv_t[j], geo[9], geo[10], scales[pred_t[j]]));
        }
        int d = INF_DIST;
        if (m) {
            d = hamming256(a0, a1, desc_t[2 * j], desc_t[2 * j + 1]);
            if (col_key) atomicMin(&col_key[j], ((unsigned long long)d << 32) | (unsigned)q);
        }
        push(s, d, j);
    }
    for (int o = 16; o > 0; o >>= 1) {
        const Top2 other{__shfl_down_sync(0xffffffffu, s.d1, o),
                         __shfl_down_sync(0xffffffffu, s.j1, o),
                         __shfl_down_sync(0xffffffffu, s.d2, o)};
        s = merge(s, other);
    }
    if ((t & 31) == 0) red[t >> 5] = s;
    __syncthreads();
    if (t == 0) {
        Top2 b = red[0];
        for (int k = 1; k < ROWS_THREADS / 32; ++k) b = merge(b, red[k]);
        best_d[q] = b.d1;
        best_j[q] = b.j1;
        second_d[q] = b.d2;
    }
}

// floor(((a - b) mod 2pi) / 2pi * 30) mod 30 with the reference's floor-mod.
__device__ __forceinline__ int rotation_bin(float a, float b) {
    const float two_pi = 6.28318530717958647692f;
    float r = fmodf(__fsub_rn(a, b), two_pi);
    if (r < 0.f) r = __fadd_rn(r, two_pi);
    return ((int)floorf(__fmul_rn(__fdiv_rn(r, two_pi), (float)N_BINS))) % N_BINS;
}

__global__ void __launch_bounds__(FINISH_THREADS) match_finish_kernel(
        const int* __restrict__ best_d, const int* __restrict__ best_j,
        const int* __restrict__ second_d, const unsigned long long* __restrict__ col_key,
        const float* __restrict__ angle_q, const float* __restrict__ angle_t, int Nq, int Nt,
        int max_dist, float ratio, int use_ratio, int* __restrict__ idx,
        int* __restrict__ dist, bool* __restrict__ ok) {
    extern __shared__ int s_bin[];  // rotation bin of each accepted query, -1 otherwise
    __shared__ int hist[N_BINS];
    __shared__ int top_bin[KEEP_TOP];
    __shared__ bool top_good[KEEP_TOP];
    const int t = threadIdx.x;
    const size_t bq = (size_t)blockIdx.x * Nq;  // batch blockIdx.x (rotation only with one batch)
    best_d += bq;
    best_j += bq;
    second_d += bq;
    idx += bq;
    dist += bq;
    ok += bq;
    if (col_key) col_key += (size_t)blockIdx.x * Nt;
    const bool rot = angle_q != nullptr;
    for (int k = t; k < N_BINS; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    for (int q = t; q < Nq; q += blockDim.x) {
        const int b = best_d[q], j = best_j[q];
        bool o = b <= max_dist &&
                 (!use_ratio || (float)b < __fmul_rn(ratio, (float)second_d[q]));
        if (col_key) o = o && (int)(unsigned)(col_key[j] & 0xffffffffull) == q;
        dist[q] = b;
        if (rot) {
            const int bin = o ? rotation_bin(angle_q[q], angle_t[j]) : -1;
            s_bin[q] = bin;
            if (o) atomicAdd(&hist[bin], 1);
        } else {
            ok[q] = o;
            idx[q] = o ? j : -1;
        }
    }
    if (!rot) return;
    __syncthreads();
    if (t == 0) {
        bool used[N_BINS];
        for (int k = 0; k < N_BINS; ++k) used[k] = false;
        int top0 = 0;
        for (int k = 0; k < KEEP_TOP; ++k) {
            int best = -1;
            for (int b = 0; b < N_BINS; ++b)
                if (!used[b] && (best < 0 || hist[b] > hist[best])) best = b;
            used[best] = true;
            if (k == 0) top0 = hist[best];
            top_bin[k] = best;
            top_good[k] = hist[best] > top0 / 10;
        }
    }
    __syncthreads();
    for (int q = t; q < Nq; q += blockDim.x) {
        const int bin = s_bin[q];
        bool o = false;
        for (int k = 0; k < KEEP_TOP; ++k) o |= bin >= 0 && bin == top_bin[k] && top_good[k];
        ok[q] = o;
        idx[q] = o ? best_j[q] : -1;
    }
}

}  // namespace

// Per query row of each of B batches: best / second distance and best target
// (and, with col_key, the per-target best row of the mutual check), [B, Nq]
// (col_key [B, Nt]). The queries' descriptors, keypoints and octaves are
// shared by the batches; valid_q is [B, Nq], and the targets' descriptors,
// flags, uv_t and pred_t are [B, Nt]. `mode` is a MaskMode: uv_t holds the
// targets' projections (1) or keypoints (2-4), pred_t their predicted (1) or
// own (3, 4) octaves; `radius` is the window radius (1) or its square (2);
// geo is [B, 11]: F12 row-major and the epipole (3, 4). Arguments a mode does
// not use may be null.
C_ENTRY int match_rows(const uint8_t* desc_q, const uint8_t* desc_t, const bool* valid_q,
                       const bool* valid_t, const float* uv_t, const float* xy_q,
                       const int* oct_q, const int* pred_t, const float* scales,
                       const float* geo, float radius, int slack, int slack_up, int Nq, int Nt,
                       int B, int mode, int* best_d, int* best_j, int* second_d,
                       unsigned long long* col_key, cudaStream_t stream) {
    if (col_key) fill_cols_kernel<<<(B * Nt + 255) / 256, 256, 0, stream>>>(col_key, B * Nt);
    match_rows_kernel<<<dim3(Nq, B), ROWS_THREADS, 0, stream>>>(
        reinterpret_cast<const uint4*>(desc_q), reinterpret_cast<const uint4*>(desc_t), valid_q,
        valid_t, reinterpret_cast<const float2*>(uv_t), reinterpret_cast<const float2*>(xy_q),
        oct_q, pred_t, scales, geo, radius, slack, slack_up, Nq, Nt, mode, best_d, best_j,
        second_d, col_key);
    return (int)cudaGetLastError();
}

// Accept rules for the Nq queries of each of B batches (one block per batch,
// Nq <= 12288), and with angles (B = 1) the rotation filter.
C_ENTRY int match_finish(const int* best_d, const int* best_j, const int* second_d,
                         const unsigned long long* col_key, const float* angle_q,
                         const float* angle_t, int Nq, int Nt, int B, int max_dist, float ratio,
                         int use_ratio, int* idx, int* dist, bool* ok, cudaStream_t stream) {
    const size_t shm = angle_q ? (size_t)Nq * sizeof(int) : 0;
    match_finish_kernel<<<B, FINISH_THREADS, shm, stream>>>(best_d, best_j, second_d, col_key,
                                                           angle_q, angle_t, Nq, Nt, max_dist,
                                                           ratio, use_ratio, idx, dist, ok);
    return (int)cudaGetLastError();
}
