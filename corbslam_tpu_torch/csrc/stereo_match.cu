// K4 `stereo_match`: masked Hamming best match + SAD sub-pixel refinement +
// median cut, for every left feature of a stereo pair.
//
// Replaces corbslam_tpu/ops/stereo.py match_stereo_features together with
// the part of corbslam_tpu/ops/descriptors.py it uses (hamming_matrix,
// masked_hamming_matrix, best_match with ratio 1.0, popcount).
//
// Bound on the H100: latency. The work is small: the candidate pairs that
// pass the row / disparity / octave / validity mask (8 XORs and 8 popcounts
// each), the 11 x 11 x 11 SAD slide of each matched feature and a median;
// the bytes are a few hundred KB (descriptors, keypoints, the two 11-row
// windows per left feature), L2-resident. The [N, M] mask and distance
// matrix the reference materializes, a scan of every right feature for
// every left one, and a second launch for the median are what to avoid.
// Design: one launch, `stereo_match_kernel`, 512-thread CTAs of 16 left
// features, a warp each. A CTA stages the valid right features (up to 2048
// a pass, every load in flight, four a thread) and sorts them into row
// buckets by floor(y) (a counting sort in shared memory over 512 buckets
// that wrap), records of (x, y, octave, index). A left feature's warp then
// tests only the buckets of the rows within 2 x scale[min(o_l + 1, L - 1)]
// of its y, widened by one row on each side, so the exact f32 test
// fabsf(dy) <= 2 x scale[o_r] decides; it reads descriptors only for the
// pairs that pass, and keeps a running (distance, index) minimum with the
// lower index on ties (any scan order gives the reference's argmin),
// starting at (512, 0), the answer of a fully masked row. A matched feature
// (distance <= max_hamming) stages the 11x11 centre window of its left
// patch and the 11x21 slide window of the right patch in the warp's shared
// memory (coalesced patch rows), sums the 121 (shift, row) partials on the
// lanes and the 11 shifts in the reference's order, takes the first
// minimum, and evaluates the parabola and u_right with explicitly rounded
// f32 operations in the reference's order (no fused multiply-add). Each
// feature's outputs are written as if the median cut removed nothing. Each
// CTA then takes an atomic ticket that also adds its failed features (one
// word: the count of CTAs in the low 16 bits, of failures above), after a
// __threadfence where all its features passed. The last CTA learns the
// total from its ticket: if a feature failed, the reference's median is NaN
// and the cut is a no-op, so it is done; otherwise it finds the two middle
// best SADs by a radix select over their f32 bit patterns (four 8-bit
// passes, exact with duplicates, no N^2 ranking), averages them as
// jnp.median does and turns off the features above 2.1 x median + 1e-3.
// The ticket word lives in a per-stream workspace that the last CTA
// restores to 0.
//
// `finish_keypoints` replaces corbslam_tpu/geometry/camera.py
// undistort_points and corbslam_tpu/ops/stereo.py compute_stereo_from_rgbd
// (B6's RGB-D half): the one launch that finishes every frame's keypoints,
// whatever the sensor. One thread a keypoint runs the 5 fixed-point
// undistortion iterations in the f32 operations and order that PyTorch runs
// `undistort_points` in on the card (every product and sum explicitly
// rounded, no FMA; a division by a camera scalar is a product with its f32
// reciprocal, as PyTorch's CUDA division by a Python scalar is; each
// constant rounded to f32 once, where PyTorch rounds it), so its output is
// bit-equal to that sequence of ~180 elementwise launches. In RGB-D mode it
// also rounds the raw keypoint half to even (rintf, as jnp.round), clamps
// it into the image, reads the registered depth map there and writes
// u_right = x_undistorted - bf / max(d, min_depth) and the depth, or -1 / 0
// where the feature is invalid or d <= min_depth; in mono mode it writes
// -1 / 0. Bound: bytes (8 in and 8 out a keypoint, RGB-D a 4-byte
// gather and 9 bytes more), so it is one launch with no shared memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int RAW = 32;
constexpr int C = RAW / 2;
constexpr int PW = 5;           // SAD half-window (11x11)
constexpr int SR = 5;           // +-5 px slide
constexpr int WIN = 2 * PW + 1;
constexpr int NS = 2 * SR + 1;  // 11 shifts
constexpr int RW = WIN + 2 * SR;  // 21 columns of the right window
constexpr int INF_DIST = 512;
constexpr int WARPS = 16;       // left features of a CTA, a warp each
constexpr int THREADS = 32 * WARPS;
constexpr int PER = 4;          // right features a thread stages in a pass
constexpr int CHUNK = PER * THREADS;  // right features a pass
constexpr int NB = 512;         // row buckets: floor(y) mod NB
constexpr int MAX_L = 32;       // octaves
constexpr int MAX_N = 12288;    // left features (the finish's keys in 48 KB)
constexpr int PEND = 4;         // candidates a lane gathers before reading their descriptors
// finish_keypoints: a thread a keypoint; its modes; undistort_points' iterations.
constexpr int FINISH_THREADS = 128;
constexpr int FINISH_STEREO = 0, FINISH_MONO = 1, FINISH_RGBD = 2;
constexpr int UNDISTORT_ITERS = 5;
constexpr int WARP_FLOATS = WIN * WIN + WIN * RW + NS * WIN + NS + 1;
static_assert(NB == THREADS, "the bucket scan takes one bucket a thread");

struct Args {
    const float2* xy_l;
    const int* oct_l;
    const bool* valid_l;
    const uint4* desc_l;
    const float* patch_l;
    const float2* xy_r;
    const int* oct_r;
    const bool* valid_r;
    const uint4* desc_r;
    const float* patch_r;
    const float* scales;
    int N, M, L;
    float max_disp;
    int max_hamming;
    float bf;
    unsigned int* work;  // the ticket (low 16 bits) and failed features (high); 0 on entry and exit
    float* best_sad;     // [N] scratch
    int* idx;
    int* dist;
    float* u_right;
    float* depth;
    bool* ok;
};

__device__ __forceinline__ bool better(int d, int j, int bd, int bj) {
    return d < bd || (d == bd && j < bj);
}

__device__ __forceinline__ int row_of(float y) {
    return (int)floorf(fminf(fmaxf(y, -1e6f), 1e6f));
}

// The running (distance, index) minimum over the first n of the candidate
// right features j[]: their descriptors are loaded together, then compared.
__device__ __forceinline__ void hamming_min(const uint4* __restrict__ desc_r, const int (&j)[PEND],
                                            int n, uint4 a0, uint4 a1, int& bd, int& bj) {
    uint4 b0[PEND], b1[PEND];
#pragma unroll
    for (int q = 0; q < PEND; ++q)
        if (q < n) {
            b0[q] = desc_r[2 * j[q]];
            b1[q] = desc_r[2 * j[q] + 1];
        }
#pragma unroll
    for (int q = 0; q < PEND; ++q)
        if (q < n) {
            const int d = __popc(a0.x ^ b0[q].x) + __popc(a0.y ^ b0[q].y) +
                          __popc(a0.z ^ b0[q].z) + __popc(a0.w ^ b0[q].w) +
                          __popc(a1.x ^ b1[q].x) + __popc(a1.y ^ b1[q].y) +
                          __popc(a1.z ^ b1[q].z) + __popc(a1.w ^ b1[q].w);
            if (better(d, j[q], bd, bj)) {
                bd = d;
                bj = j[q];
            }
        }
}

// Order-preserving map of f32 bit patterns to unsigned keys and back.
__device__ __forceinline__ unsigned int to_key(float f) {
    const unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned int k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Inclusive sum over the CTA of one int a thread (s_warp: WARPS ints).
__device__ __forceinline__ int block_inclusive_sum(int v, int* s_warp, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
        const int x = s_warp[q];
        before += q < warp ? x : 0;
        all += x;
    }
    *total = all;
    return v + before;
}

// The rank-th smallest of n keys (0-based): four 8-bit radix passes over
// the keys in shared memory, warp-aggregated histogram adds.
__device__ unsigned int radix_select(const unsigned int* keys, int n, int rank,
                                     unsigned int* s_hist, unsigned int* s_sel) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned int prefix = 0u, pmask = 0u;
    unsigned int k = (unsigned int)rank;
    for (int shift = 24; shift >= 0; shift -= 8) {
        if (tid < 256) s_hist[tid] = 0u;
        __syncthreads();
        for (int e0 = 0; e0 < n; e0 += THREADS) {
            const int e = e0 + tid;
            const unsigned int key = e < n ? keys[e] : 0u;
            const bool in = e < n && (key & pmask) == prefix;
            const unsigned int active = __ballot_sync(0xffffffffu, in);
            if (in) {
                const unsigned int digit = (key >> shift) & 255u;
                const unsigned int peers = __match_any_sync(active, digit);
                if (lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], (unsigned int)__popc(peers));
            }
        }
        __syncthreads();
        if (warp == 0) {
            unsigned int cnt[8], sum = 0u;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                cnt[q] = s_hist[lane * 8 + q];
                sum += cnt[q];
            }
            unsigned int incl = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned int u = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += u;
            }
            unsigned int run = incl - sum;
            if (k >= run && k < incl) {
                bool found = false;
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    if (!found && k < run + cnt[q]) {
                        found = true;
                        s_sel[0] = (unsigned int)(lane * 8 + q);
                        s_sel[1] = run;
                    }
                    run += cnt[q];
                }
            }
        }
        __syncthreads();
        prefix |= s_sel[0] << shift;
        pmask |= 255u << shift;
        k -= s_sel[1];
        __syncthreads();
    }
    return prefix;
}

__global__ void __launch_bounds__(THREADS) stereo_match_kernel(const Args a) {
    extern __shared__ float4 s_rec[];  // [CHUNK] (x, y, octave, index); the finish's keys
    __shared__ float s_win[WARPS][WARP_FLOATS];
    __shared__ int s_start[NB + 1];
    __shared__ int s_cur[NB];
    __shared__ float s_scale[MAX_L];
    __shared__ int s_warp[WARPS];
    __shared__ unsigned int s_hist[256], s_sel[2], s_red[2];
    __shared__ int s_fail;
    __shared__ bool s_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int i = blockIdx.x * WARPS + warp;
    const bool has = i < a.N;
    if (tid < a.L) s_scale[tid] = a.scales[tid];
    if (tid == 0) s_fail = 0;

    float2 pl = make_float2(0.f, 0.f);
    int ol = 0;
    bool vl = false;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    float lv[WIN];  // lane's column of the left patch's centre rows, read early
    if (has) {
        pl = a.xy_l[i];
        ol = a.oct_l[i];
        vl = a.valid_l[i];
        a0 = a.desc_l[2 * i];
        a1 = a.desc_l[2 * i + 1];
        const float* Lp = a.patch_l + (size_t)i * RAW * RAW + (C - PW) * RAW + lane;
#pragma unroll
        for (int r = 0; r < WIN; ++r) lv[r] = Lp[r * RAW];
    }
    int bd = INF_DIST, bj = 0;

    for (int base = 0; base < a.M; base += CHUNK) {
        const int m = min(CHUNK, a.M - base);
        float2 rxy[PER];
        int roct[PER], rrow[PER];
        bool rv[PER];
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int k = tid + q * THREADS;
            rv[q] = false;
            if (k < m) {
                rv[q] = a.valid_r[base + k];
                rxy[q] = a.xy_r[base + k];
                roct[q] = a.oct_r[base + k];
            }
        }
        s_start[tid] = 0;
        __syncthreads();
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            if (rv[q]) {
                rrow[q] = row_of(rxy[q].y) & (NB - 1);
                atomicAdd(&s_start[rrow[q]], 1);
            }
        }
        __syncthreads();
        const int cnt = s_start[tid];
        int total;
        const int incl = block_inclusive_sum(cnt, s_warp, &total);
        s_start[tid] = incl - cnt;
        s_cur[tid] = incl - cnt;
        if (tid == 0) s_start[NB] = total;
        __syncthreads();
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            if (rv[q]) {
                const int pos = atomicAdd(&s_cur[rrow[q]], 1);
                s_rec[pos] = make_float4(rxy[q].x, rxy[q].y, __int_as_float(roct[q]),
                                         __int_as_float(base + tid + q * THREADS));
            }
        }
        __syncthreads();
        if (has && vl) {
            // Rows a candidate can lie on: the widest octave tolerance the
            // octave test allows, one row more on each side.
            float tol = 0.f;
            for (int o = max(ol - 1, 0); o <= min(ol + 1, a.L - 1); ++o)
                tol = fmaxf(tol, 2.0f * s_scale[o]);
            const int ra = row_of(pl.y - tol) - 1, rb = row_of(pl.y + tol) + 1;
            int e0 = 0, e1 = total, e2 = 0, e3 = 0;
            if (rb - ra + 1 < NB) {
                const int ba = ra & (NB - 1), bb = rb & (NB - 1);
                e0 = s_start[ba];
                if (ba <= bb) {
                    e1 = s_start[bb + 1];
                } else {
                    e3 = s_start[bb + 1];
                }
            }
            // The lane's candidates are gathered, then their descriptors
            // read together: one L2 round trip for up to PEND of them.
            int pend[PEND], np_ = 0;
            for (int pass = 0; pass < 2; ++pass) {
                const int lo = pass ? e2 : e0, hi = pass ? e3 : e1;
                for (int e = lo + lane; e < hi; e += 32) {
                    const float4 r = s_rec[e];
                    const int orr = __float_as_int(r.z);
                    const float row_tol = 2.0f * s_scale[orr];
                    const float disp = pl.x - r.x;
                    if (fabsf(pl.y - r.y) <= row_tol && disp >= -1.0f && disp <= a.max_disp &&
                        abs(ol - orr) <= 1) {
#pragma unroll
                        for (int q = 0; q < PEND; ++q)
                            if (q == np_) pend[q] = __float_as_int(r.w);
                        if (++np_ == PEND) {
                            hamming_min(a.desc_r, pend, np_, a0, a1, bd, bj);
                            np_ = 0;
                        }
                    }
                }
            }
            hamming_min(a.desc_r, pend, np_, a0, a1, bd, bj);
        }
        __syncthreads();
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const int od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (better(od, oj, bd, bj)) {
            bd = od;
            bj = oj;
        }
    }

    if (has) {
        const int j = bj;
        bool okp = false;
        float u = -1.0f, disparity = 0.f, s1 = 0.f;
        if (bd <= a.max_hamming) {  // otherwise ok_pre is false whatever the SAD
            float* Lw = s_win[warp];
            float* Rw = Lw + WIN * WIN;
            float* part = Rw + WIN * RW;
            float* sad = part + NS * WIN;
            const float* R = a.patch_r + (size_t)j * RAW * RAW + (C - PW) * RAW;
            float rv2[WIN];
#pragma unroll
            for (int r = 0; r < WIN; ++r) rv2[r] = R[r * RAW + lane];
            const float xr = a.xy_r[j].x;
            const int orj = a.oct_r[j];
#pragma unroll
            for (int r = 0; r < WIN; ++r) {
                if (lane >= C - PW && lane < C + PW + 1) Lw[r * WIN + lane - (C - PW)] = lv[r];
                if (lane >= C - SR - PW && lane < C + SR + PW + 1)
                    Rw[r * RW + lane - (C - SR - PW)] = rv2[r];
            }
            __syncwarp();
            for (int k = lane; k < NS * WIN; k += 32) {
                const int s = k / WIN, r = k - s * WIN;
                float acc = 0.f;
#pragma unroll
                for (int c = 0; c < WIN; ++c) acc += fabsf(Rw[r * RW + c + s] - Lw[r * WIN + c]);
                part[s * WIN + r] = acc;
            }
            __syncwarp();
            if (lane < NS) {
                float acc = 0.f;
#pragma unroll
                for (int r = 0; r < WIN; ++r) acc += part[lane * WIN + r];
                sad[lane] = acc;
            }
            __syncwarp();
            if (lane == 0) {
                int best = 0;
                for (int s = 1; s < NS; ++s)
                    if (sad[s] < sad[best]) best = s;
                const int bir = min(max(best, 1), NS - 2);
                const float s0 = sad[bir - 1], s2 = sad[bir + 1];
                s1 = sad[bir];
                const float denom = __fsub_rn(__fadd_rn(s0, s2), __fmul_rn(2.0f, s1));
                float delta = 0.f;
                if (fabsf(denom) > 1e-6f)
                    delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s0, s2)), fmaxf(denom, 1e-6f));
                delta = fminf(fmaxf(delta, -1.0f), 1.0f);
                const float shift = __fadd_rn((float)(bir - SR), delta);
                u = __fadd_rn(xr, __fmul_rn(shift, s_scale[orj]));
                disparity = __fsub_rn(pl.x, u);
                okp = disparity > 0.1f && disparity < a.max_disp;
            }
        }
        if (lane == 0) {
            // The outputs as if the median cut removed nothing.
            a.idx[i] = j;
            a.dist[i] = bd;
            a.ok[i] = okp;
            a.depth[i] = okp ? __fdiv_rn(a.bf, fmaxf(disparity, 0.1f)) : 0.f;
            a.u_right[i] = okp ? u : -1.0f;
            a.best_sad[i] = s1;
            if (!okp) atomicAdd(&s_fail, 1);
        }
    }

    // The last CTA to get here applies the median cut. One atomic counts
    // the CTA (low 16 bits) and its failed features (high bits); only a CTA
    // whose features all passed needs its best SADs visible to the last.
    __syncthreads();
    if (s_fail == 0) __threadfence();
    __syncthreads();
    if (tid == 0) {
        const unsigned int old = atomicAdd(&a.work[0], 1u + ((unsigned int)s_fail << 16));
        s_last = (old & 0xffffu) == gridDim.x - 1;
        s_red[0] = (old >> 16) + (unsigned int)s_fail;
        if (s_last) a.work[0] = 0u;
    }
    __syncthreads();
    if (!s_last || s_red[0] != 0u) return;  // a feature failed: jnp.median is NaN, nothing is cut
    __threadfence();
    const int N = a.N;
    unsigned int* keys = reinterpret_cast<unsigned int*>(s_rec);
    for (int e = tid; e < N; e += THREADS) keys[e] = to_key(__ldcg(a.best_sad + e));
    __syncthreads();
    const int lo = (N - 1) / 2, hi = N / 2;
    const unsigned int lo_key = radix_select(keys, N, lo, s_hist, s_sel);
    unsigned int hi_key = lo_key;
    if (hi != lo) {  // the next value up: lo's again if it repeats past rank hi
        if (tid == 0) {
            s_red[0] = 0u;
            s_red[1] = 0xffffffffu;
        }
        __syncthreads();
        unsigned int n_le = 0u, above = 0xffffffffu;
        for (int e = tid; e < N; e += THREADS) {
            const unsigned int key = keys[e];
            if (key <= lo_key) ++n_le;
            else above = min(above, key);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            n_le += __shfl_xor_sync(0xffffffffu, n_le, o);
            above = min(above, __shfl_xor_sync(0xffffffffu, above, o));
        }
        if (lane == 0) {
            atomicAdd(&s_red[0], n_le);
            atomicMin(&s_red[1], above);
        }
        __syncthreads();
        hi_key = s_red[0] > (unsigned int)hi ? lo_key : s_red[1];
    }
    const float med = __fmul_rn(__fadd_rn(from_key(lo_key), from_key(hi_key)), 0.5f);
    const float cut = __fadd_rn(__fmul_rn(2.1f, med), 1e-3f);
    for (int e = tid; e < N; e += THREADS) {
        if (!(from_key(keys[e]) <= cut)) {
            a.ok[e] = false;
            a.depth[e] = 0.f;
            a.u_right[e] = -1.0f;
        }
    }
}

// Camera and distortion terms of `finish_keypoints`, each already the f32
// that PyTorch's CUDA elementwise kernels use.
struct Undistort {
    float fx, fy, cx, cy, k1, k2, p1, p2, k3, two_p1, two_p2;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// camera.undistort_points of one pixel, operation by operation:
// x0 = (u - cx) * (1 / fx); 5 x (r2, radial, xd, yd, x = x0 - (xd - x));
// u = x * fx + cx.
__device__ __forceinline__ float2 undistort(const Undistort& c, float2 p) {
    const float x0 = mul_rn(sub_rn(p.x, c.cx), __fdiv_rn(1.0f, c.fx));
    const float y0 = mul_rn(sub_rn(p.y, c.cy), __fdiv_rn(1.0f, c.fy));
    float x = x0, y = y0;
#pragma unroll
    for (int it = 0; it < UNDISTORT_ITERS; ++it) {
        const float r2 = add_rn(mul_rn(x, x), mul_rn(y, y));
        // ((1 + k1 r2) + (k2 r2) r2) + ((k3 r2) r2) r2
        const float radial = add_rn(add_rn(add_rn(mul_rn(r2, c.k1), 1.0f),
                                           mul_rn(mul_rn(r2, c.k2), r2)),
                                    mul_rn(mul_rn(mul_rn(r2, c.k3), r2), r2));
        // (x radial + ((2 p1) x) y) + p2 (r2 + (2 x) x)
        const float xd = add_rn(add_rn(mul_rn(x, radial), mul_rn(mul_rn(x, c.two_p1), y)),
                                mul_rn(add_rn(r2, mul_rn(mul_rn(x, 2.0f), x)), c.p2));
        // (y radial + p1 (r2 + (2 y) y)) + ((2 p2) x) y
        const float yd = add_rn(add_rn(mul_rn(y, radial),
                                       mul_rn(add_rn(r2, mul_rn(mul_rn(y, 2.0f), y)), c.p1)),
                                mul_rn(mul_rn(x, c.two_p2), y));
        const float xn = sub_rn(x0, sub_rn(xd, x));
        y = sub_rn(y0, sub_rn(yd, y));
        x = xn;
    }
    return make_float2(add_rn(mul_rn(x, c.fx), c.cx), add_rn(mul_rn(y, c.fy), c.cy));
}

__global__ void __launch_bounds__(FINISH_THREADS) finish_keypoints_kernel(
        const float2* __restrict__ xy, const bool* __restrict__ valid,
        const float* __restrict__ depth_map, int h, int w, int N, int mode, Undistort c, float bf,
        float min_depth, float2* __restrict__ xy_und, float* __restrict__ u_right,
        float* __restrict__ depth, bool* __restrict__ ok) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const float2 p = xy[i];
    const float2 q = undistort(c, p);
    xy_und[i] = q;
    if (mode == FINISH_STEREO) return;
    if (mode == FINISH_MONO) {
        u_right[i] = -1.0f;
        depth[i] = 0.f;
        return;
    }
    const int xi = min(max((int)rintf(p.x), 0), w - 1);
    const int yi = min(max((int)rintf(p.y), 0), h - 1);
    const float d = depth_map[(size_t)yi * w + xi];
    const bool o = valid[i] && d > min_depth;
    ok[i] = o;
    depth[i] = o ? d : 0.f;
    u_right[i] = o ? sub_rn(q.x, __fdiv_rn(bf, fmaxf(d, min_depth))) : -1.0f;
}

}  // namespace

// Stereo match of N left features against M right ones in one launch (N in
// 1..12288, M >= 1, L <= 32 octaves): idx, dist, u_right, depth, ok [N].
// best_sad: [N] floats of scratch; work: 1 uint, 0 on entry and on exit.
C_ENTRY int stereo_match(const float* xy_l, const int* oct_l, const bool* valid_l,
                         const uint8_t* desc_l, const float* patch_l, const float* xy_r,
                         const int* oct_r, const bool* valid_r, const uint8_t* desc_r,
                         const float* patch_r, const float* scales, int N, int M, int L,
                         float max_disp, int max_hamming, float bf, unsigned int* work,
                         float* best_sad, int* idx, int* dist, float* u_right, float* depth,
                         bool* ok, cudaStream_t stream) {
    if (N < 1 || N > MAX_N || M < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
    Args a;
    a.xy_l = reinterpret_cast<const float2*>(xy_l);
    a.oct_l = oct_l;
    a.valid_l = valid_l;
    a.desc_l = reinterpret_cast<const uint4*>(desc_l);
    a.patch_l = patch_l;
    a.xy_r = reinterpret_cast<const float2*>(xy_r);
    a.oct_r = oct_r;
    a.valid_r = valid_r;
    a.desc_r = reinterpret_cast<const uint4*>(desc_r);
    a.patch_r = patch_r;
    a.scales = scales;
    a.N = N;
    a.M = M;
    a.L = L;
    a.max_disp = max_disp;
    a.max_hamming = max_hamming;
    a.bf = bf;
    a.work = work;
    a.best_sad = best_sad;
    a.idx = idx;
    a.dist = dist;
    a.u_right = u_right;
    a.depth = depth;
    a.ok = ok;
    const int recs = M < CHUNK ? M : CHUNK;
    const size_t smem = (size_t)recs * sizeof(float4) > (size_t)N * sizeof(unsigned int)
                            ? (size_t)recs * sizeof(float4)
                            : (size_t)N * sizeof(unsigned int);
    static bool attr = false;
    if (!attr) {
        const cudaError_t err =
            cudaFuncSetAttribute(stereo_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(MAX_N * sizeof(unsigned int)));
        if (err != cudaSuccess) return (int)err;
        attr = true;
    }
    stereo_match_kernel<<<(N + WARPS - 1) / WARPS, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Undistorted keypoints xy_und [N, 2] of N raw keypoints xy [N, 2], and by
// `mode`: nothing more (FINISH_STEREO), u_right -1 / depth 0 (FINISH_MONO),
// or (u_right, depth, ok) [N] from the registered [h, w] depth map at the
// raw keypoints (FINISH_RGBD; valid [N], depth_map and ok used only there).
C_ENTRY int finish_keypoints(const float* xy, const bool* valid, const float* depth_map, int h,
                             int w, int N, int mode, float fx, float fy, float cx, float cy,
                             float k1, float k2, float p1, float p2, float k3, float two_p1,
                             float two_p2, float bf, float min_depth, float* xy_und,
                             float* u_right, float* depth, bool* ok, cudaStream_t stream) {
    if (N < 0 || mode < FINISH_STEREO || mode > FINISH_RGBD ||
        (mode == FINISH_RGBD && (h < 1 || w < 1)))
        return (int)cudaErrorInvalidValue;
    if (N > 0)
        finish_keypoints_kernel<<<(N + FINISH_THREADS - 1) / FINISH_THREADS, FINISH_THREADS, 0,
                                  stream>>>(
            reinterpret_cast<const float2*>(xy), valid, depth_map, h, w, N, mode,
            Undistort{fx, fy, cx, cy, k1, k2, p1, p2, k3, two_p1, two_p2}, bf, min_depth,
            reinterpret_cast<float2*>(xy_und), u_right, depth, ok);
    return (int)cudaGetLastError();
}
