// K9 `vocab`: bag-of-words assignment, tf-idf histogram (dense and sparse)
// and the L1 database scores.
//
// Replaces corbslam_tpu/place/vocab.py _assign (a flat [F, W] Hamming
// argmin as an int8 MXU product), _assign_tree (the 2-level descent: the
// top-2 of G group centres, then their child blocks), transform /
// transform_sparse (segment sums and a sort) and l1_scores /
// l1_scores_batch (sum_i min(q_i, d_i) over a dense [N, W] database).
//
// Bound on the H100: the assignment by operations (F x (G + 2 Cmax) XOR +
// popcount of 8 words: 2048 x 1088 x 16 ~ 36 M integer ops a keyframe); the
// scores by bytes (the whole [N, W] f32 database, 256 MB at 2048 x 32768,
// read once per query).
// Design: `vocab_assign` gives each descriptor one warp. Centres are packed
// LSB-first at load, like descriptors, so a distance is the popcount of an
// XOR. The lanes stride the group centres keeping a top-2 of 64-bit keys
// (distance << 32 | index: lower index first on ties, as lax.top_k), merged
// across the warp by shuffles; then each chosen group's child block is
// scanned in that order for its first minimum (jnp.argmin, padded children
// at 1 << 20), a later group replacing the best only when strictly nearer.
// Without a tree the lanes stride all W words. `vocab_hist` is one CTA a
// keyframe row (one for `transform`, B for `transform_batch`, whose B x F
// descriptors went through one `vocab_assign` launch): zero the [W] row (a
// database row, written in place), add 1 per valid feature with float
// atomics (integer counts, exact in any order), scale by idf and divide by
// the L1 norm from a fixed-order block reduction.
// `vocab_sparse` is one CTA that ranks the F words in shared memory (rank =
// smaller words + equal words before it: the stable sort), counts each
// run and writes the first of each run. `vocab_l1_scores` gives each
// (query, database row) one CTA reading the row with 16-byte loads and
// every row is scored, live or not.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ASSIGN_THREADS = 256;
constexpr int HIST_THREADS = 1024;
constexpr int SCORE_THREADS = 256;
constexpr int PAD_DIST = 1 << 20;

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4* b) {
    const uint4 b0 = b[0], b1 = b[1];
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
           __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ unsigned long long key(int d, int i) {
    return ((unsigned long long)(unsigned)d << 32) | (unsigned)i;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_down_sync(0xffffffffu, k, o);
        k = other < k ? other : k;
    }
    return __shfl_sync(0xffffffffu, k, 0);
}

__global__ void assign_kernel(const uint4* desc, int F, const uint4* words, int W,
                              const uint4* groups, int G, const int* child, int C, int top_g,
                              int* out) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= F) return;  // whole warps leave together
    const uint4 d0 = desc[2 * f], d1 = desc[2 * f + 1];
    const unsigned long long NONE = ~0ull;
    if (G == 0) {
        unsigned long long best = NONE;
        for (int w = lane; w < W; w += 32) {
            const unsigned long long k = key(hamming(d0, d1, words + 2 * w), w);
            best = k < best ? k : best;
        }
        best = warp_min(best);
        if (lane == 0) out[f] = (int)(best & 0xffffffffu);
        return;
    }
    unsigned long long k1 = NONE, k2 = NONE;  // lane's two smallest keys
    for (int g = lane; g < G; g += 32) {
        const unsigned long long k = key(hamming(d0, d1, groups + 2 * g), g);
        if (k < k1) {
            k2 = k1;
            k1 = k;
        } else if (k < k2) {
            k2 = k;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long o1 = __shfl_down_sync(0xffffffffu, k1, o);
        const unsigned long long o2 = __shfl_down_sync(0xffffffffu, k2, o);
        const unsigned long long lo = k1 < o1 ? k1 : o1, hi = k1 < o1 ? o1 : k1;
        const unsigned long long m2 = k2 < o2 ? k2 : o2;
        k1 = lo;
        k2 = hi < m2 ? hi : m2;
    }
    k1 = __shfl_sync(0xffffffffu, k1, 0);
    k2 = __shfl_sync(0xffffffffu, k2, 0);
    int best_d = PAD_DIST, best_w = 0;
    for (int r = 0; r < top_g; ++r) {
        const int g = (int)(((r == 0) ? k1 : k2) & 0xffffffffu);
        unsigned long long best = NONE;
        for (int j = lane; j < C; j += 32) {
            const int kid = child[g * C + j];
            const int d = kid >= 0 ? hamming(d0, d1, words + 2 * kid) : PAD_DIST;
            const unsigned long long k = key(d, j);
            best = k < best ? k : best;
        }
        best = warp_min(best);
        const int dmin = (int)(best >> 32), jmin = (int)(best & 0xffffffffu);
        if (dmin < best_d) {
            best_d = dmin;
            best_w = child[g * C + jmin];
        }
    }
    if (lane == 0) out[f] = best_w;
}

__device__ float block_sum(float v, float* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float u = lane < nw ? sh[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) u += __shfl_down_sync(0xffffffffu, u, o);
        if (lane == 0) sh[32] = u;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();
    return r;
}

__global__ void hist_kernel(const int* word, const bool* valid, int F, const float* idf, int W,
                            float* out) {
    __shared__ float sh[33];
    word += (size_t)blockIdx.x * F;  // this CTA's keyframe row
    valid += (size_t)blockIdx.x * F;
    out += (size_t)blockIdx.x * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) out[i] = 0.f;
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += blockDim.x)
        if (valid[f]) atomicAdd(&out[word[f]], 1.f);
    __syncthreads();
    float part = 0.f;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        const float v = __ldcg(out + i) * idf[i];
        out[i] = v;
        part += fabsf(v);
    }
    const float norm = fmaxf(block_sum(part, sh), 1e-9f);
    for (int i = threadIdx.x; i < W; i += blockDim.x) out[i] = out[i] / norm;
}

__global__ void sparse_kernel(const int* word, const bool* valid, int F, const float* idf, int W,
                              int* ids, float* vals) {
    extern __shared__ int shm[];
    int* wv = shm;         // [F] word or W (invalid)
    int* sw = shm + F;     // [F] sorted
    int* cnt = shm + 2 * F;  // [F] run length of sw[k]
    __shared__ float sh[33];
    for (int i = threadIdx.x; i < F; i += blockDim.x) wv[i] = valid[i] ? word[i] : W;
    __syncthreads();
    for (int i = threadIdx.x; i < F; i += blockDim.x) {
        const int x = wv[i];
        int less = 0, before = 0, eq = 0;
        for (int j = 0; j < F; ++j) {
            const int y = wv[j];
            less += y < x;
            eq += y == x;
            before += (y == x) & (j < i);
        }
        sw[less + before] = x;
        cnt[less + before] = eq;
    }
    __syncthreads();
    float part = 0.f;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
        const int x = sw[k];
        const bool first = k == 0 || sw[k - 1] != x;
        const int id = (first && x < W) ? x : -1;
        const float v = id >= 0 ? (float)cnt[k] * idf[id] : 0.f;
        ids[k] = id;
        vals[k] = v;
        part += fabsf(v);
    }
    const float norm = fmaxf(block_sum(part, sh), 1e-9f);
    for (int k = threadIdx.x; k < F; k += blockDim.x) vals[k] = vals[k] / norm;
}

__global__ void scores_kernel(const float* q, const float* db, int N, int W, float* out) {
    __shared__ float sh[33];
    const int n = blockIdx.x, qi = blockIdx.y;
    const float* d = db + (size_t)n * W;
    const float* qq = q + (size_t)qi * W;
    float part = 0.f;
    if ((W & 3) == 0) {
        const float4* d4 = reinterpret_cast<const float4*>(d);
        const float4* q4 = reinterpret_cast<const float4*>(qq);
        for (int i = threadIdx.x; i < W / 4; i += blockDim.x) {
            const float4 a = q4[i], b = __ldcs(d4 + i);
            part += fminf(a.x, b.x) + fminf(a.y, b.y) + fminf(a.z, b.z) + fminf(a.w, b.w);
        }
    } else {
        for (int i = threadIdx.x; i < W; i += blockDim.x) part += fminf(qq[i], d[i]);
    }
    const float s = block_sum(part, sh);
    if (threadIdx.x == 0) out[(size_t)qi * N + n] = s;
}

}  // namespace

// Word id of each of F packed descriptors; G = 0 for a flat vocabulary.
C_ENTRY int vocab_assign(const uint8_t* desc, int F, const uint8_t* words, int W,
                         const uint8_t* groups, int G, const int* child, int C, int top_g,
                         int* out, cudaStream_t stream) {
    const int blocks = (F * 32 + ASSIGN_THREADS - 1) / ASSIGN_THREADS;
    if (F > 0)
        assign_kernel<<<blocks, ASSIGN_THREADS, 0, stream>>>(
            reinterpret_cast<const uint4*>(desc), F, reinterpret_cast<const uint4*>(words), W,
            reinterpret_cast<const uint4*>(groups), G, child, C, top_g, out);
    return (int)cudaGetLastError();
}

// L1-normalized tf-idf histograms of B keyframe rows: words and valid
// [B, F] -> out [B, W], a CTA a row.
C_ENTRY int vocab_hist(const int* word, const bool* valid, int B, int F, const float* idf, int W,
                       float* out, cudaStream_t stream) {
    if (B > 0) hist_kernel<<<B, HIST_THREADS, 0, stream>>>(word, valid, F, idf, W, out);
    return (int)cudaGetLastError();
}

// Sparse form (ids [F], weights [F]) in sorted-word order; F <= 4096.
C_ENTRY int vocab_sparse(const int* word, const bool* valid, int F, const float* idf, int W,
                         int* ids, float* vals, cudaStream_t stream) {
    sparse_kernel<<<1, HIST_THREADS, (size_t)3 * F * sizeof(int), stream>>>(word, valid, F, idf,
                                                                           W, ids, vals);
    return (int)cudaGetLastError();
}

// [Q, N] scores of Q queries against every row of an [N, W] database.
C_ENTRY int vocab_l1_scores(const float* q, int Q, const float* db, int N, int W, float* out,
                            cudaStream_t stream) {
    if (N > 0 && Q > 0)
        scores_kernel<<<dim3(N, Q), SCORE_THREADS, 0, stream>>>(q, db, N, W, out);
    return (int)cudaGetLastError();
}
