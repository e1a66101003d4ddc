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
// materializes are the thing to avoid, and so is reading the target table
// once per query row.
// Design: one launch per call, `match_select_kernel` over (query tiles,
// batch); a batch has its own targets, query flags and band geometry, and
// shares the queries' descriptors and keypoints. A CTA of 512 threads takes
// a tile of 16 query rows (one a warp). It stages the valid targets, up to
// 8192 a pass (every flag load in flight, compacted by warp ballots), with
// their uv and predicted octave or octave scale into shared memory, once
// per tile instead of once per row. In the window modes (1, 2) it then
// sorts them into 32-px cell buckets (a 64 x 16 grid that wraps, a counting
// sort in shared memory), so a row tests only the targets of the cells its
// window touches, with a 1-px margin (every target a window takes lies in
// those cells, and each is seen once; a window wider than the grid tests
// them all); the other modes test every staged target. The mask runs inline
// (the window's d2 <= r^2 with explicitly rounded f32 operations in the
// reference's order, so no FMA moves a candidate across the radius); the
// targets that pass go to the row's candidate buffer, whose descriptors are
// then read all at once for the distances. The running top-2 of (distance,
// index) keeps the best distance, the best index with the lower index on
// ties, and the second distance, which equals the best on a tie — exactly
// lax.top_k(-d, 2) — and starts at (512, 0, 512): masked targets count as
// distance 512, and with Nt >= 2 the lowest index among them is 0, so
// pushing only the unmasked pairs gives the same answer in any order; a
// query that is itself invalid (or has no candidate) is a fully masked row
// (target 0 at 512, twice). For the mutual check each unmasked pair does an
// atomicMin of (d << 32 | row) into a per-target key; the keys start at
// (512 << 32 | 0), the column top-k's answer for a fully masked column. A
// row's own accept tests run at the end of the row phase: the threshold,
// the ratio test as a strict < against the f32 product ratio * second, and
// for the rotation check the floor-mod bin of the angle difference. The
// mask modes: 0 validity only; 1 the projection window; 2 an area window
// (|xy_t - xy_q|^2 <= r^2, no octave test); 3 the epipolar band
// (CheckDistEpipolarLine: the line l = F12 (x, y, 1) of the query, then
// (l . (x_t, y_t, 1))^2 / max(a^2 + b^2, 1e-12) < 3.84 sigma^2 of the
// target's octave); 4 the band and the epipole guard (|xy_t - e|^2 >
// (sqrt(100 scale_t))^2). Every test runs in the reference's order of f32
// operations with explicit rounding. The last CTA of a batch to finish (an
// atomic ticket after a __threadfence) applies the rest to all the batch's
// queries: the mutual check and, for the rotation check, a shared-memory
// 30-bin histogram of the accepted matches, its top 3 bins (the lower bin
// on ties, one warp) and the reference's "more than a tenth of the top
// bin". It then restores the column keys and the ticket, which the wrapper
// keeps from call to call (one workspace a stream), so a call needs no
// fill launch.

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
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 16;                  // query rows a CTA, one a warp
constexpr int ROWS_PER_WARP = TILE_ROWS / WARPS;
constexpr int FLAGS_PER_THREAD = 16;           // target flags a thread loads at once
constexpr int RAW = THREADS * FLAGS_PER_THREAD;  // targets staged a pass (8192)
constexpr int STAGE_LOADS = 8;                 // staged targets a thread reads at once
constexpr int GX = 64, GY = 16, NB = GX * GY;  // buckets of 32-px cells (wrapping: 2048 x 512 px)
constexpr int CAND = 64;                       // a row's candidates buffered at most
constexpr int FLUSH_LOADS = CAND / 32;         // descriptor loads a lane has in flight a row
constexpr int FINISH_LOADS = 4;                // queries a thread of the finish reads at once
constexpr int MAX_FINISH_N = 12288;            // the finish's rotation bins in 48 KB
// index, uv, octave or scale and the bucket order of RAW targets; bucket
// starts and ends
constexpr size_t SMEM_BYTES = (size_t)RAW * (4 + 8 + 4 + 4) + 2 * NB * 4;
constexpr int GEO_STRIDE = 11;  // per batch: F12 row-major (9) and the epipole (2)
enum MaskMode { M_VALID = 0, M_PROJECTION = 1, M_AREA = 2, M_BAND = 3, M_BAND_EPIPOLE = 4 };

// floor(((a - b) mod 2pi) / 2pi * 30) mod 30 with the reference's floor-mod.
__device__ __forceinline__ int rotation_bin(float a, float b) {
    const float two_pi = 6.28318530717958647692f;
    float r = fmodf(__fsub_rn(a, b), two_pi);
    if (r < 0.f) r = __fadd_rn(r, two_pi);
    return ((int)floorf(__fmul_rn(__fdiv_rn(r, two_pi), (float)N_BINS))) % N_BINS;
}

struct Args {
    const uint4 *desc_q, *desc_t;
    const bool *valid_q, *valid_t;
    const float2 *uv_t, *xy_q;
    const int *oct_q, *pred_t;
    const float *scales, *geo;
    float radius;
    int slack, slack_up, Nq, Nt;
    int max_dist;
    float ratio;
    int use_ratio;
    const float *angle_q, *angle_t;
    unsigned long long* col_key;  // [B, Nt]: COL_EMPTY on entry and on exit, or null
    unsigned int* ticket;         // [B]: 0 on entry and on exit
    int *best_j, *code, *idx, *dist;  // [B, Nq]; code: the row's accept tests (-1: failed)
    bool* ok;                         // [B, Nq]
};

// The 32-px cell of a coordinate and the bucket of a point (wrapping).
__device__ __forceinline__ int cell(float v) { return __float2int_rd(v * 0.03125f); }
__device__ __forceinline__ int bucket(float2 u) {
    return ((cell(u.y) & (GY - 1)) << 6) | (cell(u.x) & (GX - 1));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) match_select_kernel(Args a) {
    // The window modes look only at the buckets of the cells their window
    // touches (with a 1-px margin); the others at every staged target.
    constexpr bool GRID = MODE == M_PROJECTION || MODE == M_AREA;
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_j = reinterpret_cast<int*>(smem);                 // [RAW] target index
    float2* s_uv = reinterpret_cast<float2*>(s_j + RAW);     // [RAW]
    int* s_aux = reinterpret_cast<int*>(s_uv + RAW);         // [RAW] octave or scale bits
    int* s_sort = s_aux + RAW;                               // [RAW] staged slots by bucket
    int* s_off = s_sort + RAW;                               // [NB] bucket starts
    int* s_end = s_off + NB;                                 // [NB] counts, cursors, ends
    __shared__ int s_cand[WARPS][ROWS_PER_WARP][CAND];       // a row's candidates (slots)
    __shared__ int s_n, s_wsum[WARPS];
    __shared__ bool s_last;
    __shared__ int hist[N_BINS];
    __shared__ int top_bin[KEEP_TOP];
    __shared__ bool top_good[KEEP_TOP];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, batch = blockIdx.y;
    const unsigned lt = (1u << lane) - 1u;
    const int Nq = a.Nq, Nt = a.Nt;
    // The batch's own targets, query flags, geometry, outputs and column keys.
    const size_t bt = (size_t)batch * Nt, bq = (size_t)batch * Nq;
    const uint4* desc_t = a.desc_t + 2 * bt;
    const bool* valid_t = a.valid_t + bt;
    const float2* uv_t = a.uv_t ? a.uv_t + bt : nullptr;
    const int* pred_t = a.pred_t ? a.pred_t + bt : nullptr;
    const float* geo = a.geo ? a.geo + batch * GEO_STRIDE : nullptr;
    unsigned long long* col_key = a.col_key ? a.col_key + bt : nullptr;
    const bool* valid_q = a.valid_q + bq;
    float ex = 0.f, ey = 0.f;
    if (MODE == M_BAND_EPIPOLE) {
        ex = geo[9];
        ey = geo[10];
    }

    // This warp's rows: descriptor, window geometry and running top-2 (the
    // loads issued before any is used).
    int qr[ROWS_PER_WARP], oq[ROWS_PER_WARP], nc[ROWS_PER_WARP];
    bool live[ROWS_PER_WARP];
    uint4 da[ROWS_PER_WARP], db[ROWS_PER_WARP];
    float px[ROWS_PER_WARP], py[ROWS_PER_WARP], r2[ROWS_PER_WARP], rad[ROWS_PER_WARP],
        la[ROWS_PER_WARP], lb[ROWS_PER_WARP], lc[ROWS_PER_WARP];
    Top2 top[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int q = blockIdx.x * TILE_ROWS + warp + r * WARPS;
        const bool in = q < Nq;
        qr[r] = q;
        nc[r] = 0;
        top[r] = Top2{INF_DIST, 0, INF_DIST};
        live[r] = in && valid_q[q];
        da[r] = in ? __ldg(a.desc_q + 2 * q) : make_uint4(0u, 0u, 0u, 0u);
        db[r] = in ? __ldg(a.desc_q + 2 * q + 1) : make_uint4(0u, 0u, 0u, 0u);
        const float2 p = (in && MODE != M_VALID) ? a.xy_q[q] : make_float2(0.f, 0.f);
        px[r] = p.x;
        py[r] = p.y;
        oq[r] = (in && MODE == M_PROJECTION) ? a.oct_q[q] : 0;
        r2[r] = rad[r] = la[r] = lb[r] = lc[r] = 0.f;
    }
    bool any = false;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        if (!live[r]) continue;
        any = true;
        if (MODE == M_PROJECTION) {
            const float rr = __fmul_rn(a.radius, a.scales[oq[r]]);
            r2[r] = __fmul_rn(rr, rr);
            rad[r] = rr + 1.f;
        } else if (MODE == M_AREA) {
            r2[r] = a.radius;  // the caller passes the squared radius
            rad[r] = sqrtf(a.radius) + 1.f;
        } else if (MODE >= M_BAND) {
            epipolar_line(geo, make_float2(px[r], py[r]), la[r], lb[r], lc[r]);
        }
    }

    // Row r against staged target k (k < 0: none): the mask test, and a
    // target that passes goes to the row's candidate buffer. Every lane
    // calls it (the ballot).
    auto consider = [&](int r, int k) {
        bool m = k >= 0;
        if (m) {
            const float2 u = s_uv[k];
            if (MODE == M_PROJECTION) {
                const float dx = __fsub_rn(u.x, px[r]), dy = __fsub_rn(u.y, py[r]);
                const int d_oct = oq[r] - s_aux[k];
                m = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2[r] &&
                    d_oct >= -a.slack && d_oct <= a.slack_up;
            } else if (MODE == M_AREA) {
                const float dx = __fsub_rn(px[r], u.x), dy = __fsub_rn(py[r], u.y);
                m = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2[r];
            } else if (MODE >= M_BAND) {
                const float sc = __int_as_float(s_aux[k]);
                m = in_band(la[r], lb[r], lc[r], u, sc) &&
                    (MODE == M_BAND || outside_epipole(u, ex, ey, sc));
            }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, m);
        if (m) s_cand[warp][r][nc[r] + __popc(bal & lt)] = k;
        nc[r] += __popc(bal);
    };
    // The buffered candidates of both rows: their descriptors read all at
    // once, then the distances, the column keys and the top-2.
    auto flush = [&]() {
        __syncwarp();
        int jj[ROWS_PER_WARP][FLUSH_LOADS];
        uint4 b0[ROWS_PER_WARP][FLUSH_LOADS], b1[ROWS_PER_WARP][FLUSH_LOADS];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
            for (int u = 0; u < FLUSH_LOADS; ++u) {
                const int i = u * 32 + lane;
                jj[r][u] = i < nc[r] ? s_j[s_cand[warp][r][i]] : -1;
                if (jj[r][u] >= 0) {
                    b0[r][u] = __ldg(desc_t + 2 * jj[r][u]);
                    b1[r][u] = __ldg(desc_t + 2 * jj[r][u] + 1);
                }
            }
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
#pragma unroll
            for (int u = 0; u < FLUSH_LOADS; ++u) {
                if (jj[r][u] < 0) continue;
                const int d = hamming256(da[r], db[r], b0[r][u], b1[r][u]);
                if (col_key)
                    atomicMin(&col_key[jj[r][u]],
                              ((unsigned long long)d << 32) | (unsigned)qr[r]);
                push(top[r], d, jj[r][u]);
            }
            nc[r] = 0;
        }
        __syncwarp();
    };
    auto full = [&]() {
        bool f = false;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) f |= nc[r] > CAND - 32;
        return f;
    };

    if (__syncthreads_or(any)) {
        for (int c0 = 0; c0 < Nt; c0 += RAW) {
            const int c1 = min(Nt, c0 + RAW);
            // Stage the pass's valid targets: every flag load in flight,
            // then one slot range a warp (in any order: the top-2 and the
            // column keys do not depend on it).
            bool v[FLAGS_PER_THREAD];
            int wcount = 0;
#pragma unroll
            for (int u = 0; u < FLAGS_PER_THREAD; ++u) {
                const int j = c0 + u * THREADS + tid;
                v[u] = j < c1 && valid_t[j];
            }
            if (tid == 0) s_n = 0;
            if (GRID)
                for (int b = tid; b < NB; b += THREADS) s_end[b] = 0;
            __syncthreads();
#pragma unroll
            for (int u = 0; u < FLAGS_PER_THREAD; ++u)
                wcount += __popc(__ballot_sync(0xffffffffu, v[u]));
            int slot = 0;
            if (lane == 0 && wcount) slot = atomicAdd(&s_n, wcount);
            slot = __shfl_sync(0xffffffffu, slot, 0);
#pragma unroll
            for (int u = 0; u < FLAGS_PER_THREAD; ++u) {
                const unsigned bal = __ballot_sync(0xffffffffu, v[u]);
                if (v[u]) s_j[slot + __popc(bal & lt)] = c0 + u * THREADS + tid;
                slot += __popc(bal);
            }
            __syncthreads();
            const int n = s_n;
            // Their uv and octave (scale), STAGE_LOADS a thread at once,
            // and the bucket counts.
            for (int k0 = 0; k0 < n; k0 += THREADS * STAGE_LOADS) {
                int jj[STAGE_LOADS], ax[STAGE_LOADS];
                float2 uu[STAGE_LOADS];
#pragma unroll
                for (int u = 0; u < STAGE_LOADS; ++u) {
                    const int k = k0 + u * THREADS + tid;
                    jj[u] = k < n ? s_j[k] : -1;
                    uu[u] = make_float2(0.f, 0.f);
                    ax[u] = 0;
                    if (jj[u] >= 0 && MODE != M_VALID) uu[u] = uv_t[jj[u]];
                    if (jj[u] >= 0 && MODE != M_VALID && MODE != M_AREA) ax[u] = pred_t[jj[u]];
                }
#pragma unroll
                for (int u = 0; u < STAGE_LOADS; ++u) {
                    if (jj[u] < 0) continue;
                    const int k = k0 + u * THREADS + tid;
                    if (MODE >= M_BAND) ax[u] = __float_as_int(a.scales[ax[u]]);
                    s_uv[k] = uu[u];
                    s_aux[k] = ax[u];
                    if (GRID) atomicAdd(&s_end[bucket(uu[u])], 1);
                }
            }
            __syncthreads();
            if (GRID) {
                // Bucket starts (an exclusive scan of the counts, NB /
                // THREADS a thread), then the slots in bucket order.
                constexpr int PER = NB / THREADS;
                int cnt[PER], tot = 0;
#pragma unroll
                for (int u = 0; u < PER; ++u) {
                    cnt[u] = s_end[tid * PER + u];
                    tot += cnt[u];
                }
                int inc = tot;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int y = __shfl_up_sync(0xffffffffu, inc, o);
                    if (lane >= o) inc += y;
                }
                if (lane == 31) s_wsum[warp] = inc;
                __syncthreads();
                int start = inc - tot;
                for (int w = 0; w < warp; ++w) start += s_wsum[w];
#pragma unroll
                for (int u = 0; u < PER; ++u) {
                    s_off[tid * PER + u] = start;
                    s_end[tid * PER + u] = start;
                    start += cnt[u];
                }
                __syncthreads();
                for (int k = tid; k < n; k += THREADS)
                    s_sort[atomicAdd(&s_end[bucket(s_uv[k])], 1)] = k;
                __syncthreads();
#pragma unroll
                for (int r = 0; r < ROWS_PER_WARP; ++r) {
                    if (!live[r]) continue;
                    const int cx0 = cell(px[r] - rad[r]), cx1 = cell(px[r] + rad[r]);
                    const int cy0 = cell(py[r] - rad[r]), cy1 = cell(py[r] + rad[r]);
                    if (cx1 - cx0 >= GX || cy1 - cy0 >= GY) {  // wider than the grid
                        for (int i0 = 0; i0 < n; i0 += 32) {
                            consider(r, i0 + lane < n ? i0 + lane : -1);
                            if (full()) flush();
                        }
                        continue;
                    }
                    const int bx0 = cx0 & (GX - 1), bx1 = cx1 & (GX - 1);
                    for (int cy = cy0; cy <= cy1; ++cy) {
                        const int row = (cy & (GY - 1)) << 6;
                        // The cells' buckets are one run of the row, or two
                        // where the window wraps.
                        for (int part = 0; part < (bx0 <= bx1 ? 1 : 2); ++part) {
                            const int lo = s_off[row + (part == 0 ? bx0 : 0)];
                            const int hi = s_end[row + (bx0 <= bx1 || part == 1 ? bx1 : GX - 1)];
                            for (int i0 = lo; i0 < hi; i0 += 32) {
                                consider(r, i0 + lane < hi ? s_sort[i0 + lane] : -1);
                                if (full()) flush();
                            }
                        }
                    }
                }
            } else {
                for (int i0 = 0; i0 < n; i0 += 32) {
                    const int k = i0 + lane < n ? i0 + lane : -1;
#pragma unroll
                    for (int r = 0; r < ROWS_PER_WARP; ++r)
                        if (live[r]) consider(r, k);
                    if (full()) flush();
                }
            }
            flush();
            __syncthreads();
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        Top2 s = top[r];
        for (int o = 16; o > 0; o >>= 1) {
            const Top2 other{__shfl_down_sync(0xffffffffu, s.d1, o),
                             __shfl_down_sync(0xffffffffu, s.j1, o),
                             __shfl_down_sync(0xffffffffu, s.d2, o)};
            s = merge(s, other);
        }
        if (lane == 0 && qr[r] < Nq) {
            // The row's own accept tests: the threshold, the ratio test as a
            // strict < against the f32 product ratio * second, and with the
            // rotation check the bin of the angle difference; the finish
            // adds the mutual check and the histogram.
            const int q = qr[r];
            const bool pre = s.d1 <= a.max_dist &&
                             (!a.use_ratio || (float)s.d1 < __fmul_rn(a.ratio, (float)s.d2));
            int code = -1;
            if (pre) code = a.angle_q ? rotation_bin(a.angle_q[q], a.angle_t[s.j1]) : 0;
            a.dist[bq + q] = s.d1;
            a.best_j[bq + q] = s.j1;
            a.code[bq + q] = code;
        }
    }

    // The last CTA of the batch to get here applies the accept rules.
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&a.ticket[batch], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const int* best_j = a.best_j + bq;
    const int* code = a.code + bq;
    int* idx = a.idx + bq;
    bool* ok = a.ok + bq;
    // With the rotation check, each query's bin and target (bin | j << 5) if
    // accepted, else -1.
    int* s_bin = reinterpret_cast<int*>(smem);
    const bool rot = a.angle_q != nullptr;  // (rotation only with one batch)
    for (int k = tid; k < N_BINS; k += THREADS) hist[k] = 0;
    __syncthreads();
    for (int q0 = 0; q0 < Nq; q0 += THREADS * FINISH_LOADS) {
        int j[FINISH_LOADS], c[FINISH_LOADS];
#pragma unroll
        for (int u = 0; u < FINISH_LOADS; ++u) {
            const int q = q0 + u * THREADS + tid;
            j[u] = 0;
            c[u] = -1;
            if (q < Nq) {
                j[u] = __ldcg(best_j + q);
                c[u] = __ldcg(code + q);
            }
        }
        unsigned long long ck[FINISH_LOADS];
#pragma unroll
        for (int u = 0; u < FINISH_LOADS; ++u)
            ck[u] = (col_key && c[u] >= 0) ? __ldcg(col_key + j[u]) : 0ull;
#pragma unroll
        for (int u = 0; u < FINISH_LOADS; ++u) {
            const int q = q0 + u * THREADS + tid;
            if (q >= Nq) continue;
            bool o = c[u] >= 0;
            if (col_key) o = o && (int)(unsigned)(ck[u] & 0xffffffffull) == q;
            if (rot) {
                s_bin[q] = o ? (c[u] | (j[u] << 5)) : -1;
                if (o) atomicAdd(&hist[c[u]], 1);
            } else {
                ok[q] = o;
                idx[q] = o ? j[u] : -1;
            }
        }
    }
    __syncthreads();
    if (rot) {
        if (warp == 0) {
            // The top 3 bins, one warp: the largest count, the lower bin on
            // ties, three times with the winner taken out.
            int cnt = lane < N_BINS ? hist[lane] : -1, top0 = 0;
            for (int k = 0; k < KEEP_TOP; ++k) {
                int bc = cnt, bl = lane;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
                    const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
                    if (oc > bc || (oc == bc && ol < bl)) {
                        bc = oc;
                        bl = ol;
                    }
                }
                if (k == 0) top0 = bc;
                if (lane == 0) {
                    top_bin[k] = bl;
                    top_good[k] = bc > top0 / 10;
                }
                if (lane == bl) cnt = -1;
            }
        }
        __syncthreads();
        for (int q = tid; q < Nq; q += THREADS) {
            const int e = s_bin[q];
            const int bin = e >= 0 ? (e & 31) : -1;
            bool o = false;
            for (int k = 0; k < KEEP_TOP; ++k) o |= bin >= 0 && bin == top_bin[k] && top_good[k];
            ok[q] = o;
            idx[q] = o ? (e >> 5) : -1;
        }
    }
    // Restore the workspace for the next call.
    if (col_key)
        for (int j = tid; j < Nt; j += THREADS) col_key[j] = COL_EMPTY;
    if (tid == 0) a.ticket[batch] = 0u;
}

template <int MODE>
cudaError_t launch_mode(const Args& a, int B, cudaStream_t stream) {
    static bool attr = false;
    if (!attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            match_select_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return err;
        attr = true;
    }
    const dim3 grid((a.Nq + TILE_ROWS - 1) / TILE_ROWS, B);
    match_select_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Masked best match of the Nq queries of each of B batches, in one launch:
// idx / dist / ok [B, Nq]. The queries' descriptors, keypoints and octaves
// are shared by the batches; valid_q is [B, Nq], and the targets'
// descriptors, flags, uv_t and pred_t are [B, Nt] (Nt >= 2). `mode` is a
// MaskMode: uv_t holds the targets' projections (1) or keypoints (2-4),
// pred_t their predicted (1) or own (3, 4) octaves; `radius` is the window
// radius (1) or its square (2); geo is [B, 11]: F12 row-major and the
// epipole (3, 4). Arguments a mode does not use may be null. With col_key
// ([B, Nt], all (512 << 32) on entry) the mutual check; with angles (B = 1,
// Nq <= 12288) the rotation filter. ticket [B] is 0 on entry; both are so
// again on exit. rows: [2, B, Nq] ints of scratch.
C_ENTRY int match_select(const uint8_t* desc_q, const uint8_t* desc_t, const bool* valid_q,
                         const bool* valid_t, const float* uv_t, const float* xy_q,
                         const int* oct_q, const int* pred_t, const float* scales,
                         const float* geo, float radius, int slack, int slack_up, int Nq, int Nt,
                         int B, int mode, int max_dist, float ratio, int use_ratio,
                         const float* angle_q, const float* angle_t,
                         unsigned long long* col_key, unsigned int* ticket, int* rows, int* idx,
                         int* dist, bool* ok, cudaStream_t stream) {
    if (Nq < 1 || Nt < 2 || B < 1 || (angle_q && (B != 1 || Nq > MAX_FINISH_N)))
        return (int)cudaErrorInvalidValue;
    Args a;
    a.desc_q = reinterpret_cast<const uint4*>(desc_q);
    a.desc_t = reinterpret_cast<const uint4*>(desc_t);
    a.valid_q = valid_q;
    a.valid_t = valid_t;
    a.uv_t = reinterpret_cast<const float2*>(uv_t);
    a.xy_q = reinterpret_cast<const float2*>(xy_q);
    a.oct_q = oct_q;
    a.pred_t = pred_t;
    a.scales = scales;
    a.geo = geo;
    a.radius = radius;
    a.slack = slack;
    a.slack_up = slack_up;
    a.Nq = Nq;
    a.Nt = Nt;
    a.max_dist = max_dist;
    a.ratio = ratio;
    a.use_ratio = use_ratio;
    a.angle_q = angle_q;
    a.angle_t = angle_t;
    a.col_key = col_key;
    a.ticket = ticket;
    const size_t n = (size_t)B * Nq;
    a.best_j = rows;
    a.code = rows + n;
    a.idx = idx;
    a.dist = dist;
    a.ok = ok;
    cudaError_t err;
    switch (mode) {
        case M_VALID: err = launch_mode<M_VALID>(a, B, stream); break;
        case M_PROJECTION: err = launch_mode<M_PROJECTION>(a, B, stream); break;
        case M_AREA: err = launch_mode<M_AREA>(a, B, stream); break;
        case M_BAND: err = launch_mode<M_BAND>(a, B, stream); break;
        case M_BAND_EPIPOLE: err = launch_mode<M_BAND_EPIPOLE>(a, B, stream); break;
        default: err = cudaErrorInvalidValue;
    }
    return (int)err;
}
