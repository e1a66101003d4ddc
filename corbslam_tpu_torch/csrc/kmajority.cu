// K14 `kmajority`: binary k-majority clustering, the vocabulary's training.
//
// Replaces corbslam_tpu/place/vocab.py _kmajority (a lax.scan of a flat
// Hamming argmin as an int8 MXU product, two segment_sums and the majority
// vote), the chunked accumulations of train_chunked and of both levels of
// train_hierarchical (level 2: the argmin over the descriptor's own group
// block), the idf of train / train_chunked / train_hierarchical, and the
// k-majority of build_tree.
//
// Bound on the H100: the assignment by operations. Per iteration every
// descriptor meets every centre (flat) or its block of B: N x W XOR +
// popcount of 8 words, ~1.5 G 32-bit popcounts at N 480k x W 1024, a few
// milliseconds of the integer pipes; the vote moves N x 32 bytes in and
// at most N x 256 integer atomics, the majority W x 256 counts.
// Design: three launches an iteration, no host sync inside the loop. The
// flat assignment is K9's `vocab_assign` (one warp per descriptor, 64-bit
// (distance, index) keys, so the first minimum wins as jnp.argmin);
// `km_assign_block` is level 2: one warp per descriptor scans the B words
// of block grp[f] with the same keys. `km_vote` zeroes the tallies, then
// gives each descriptor one warp, lane l owning byte l: each set bit adds
// the row weight to ones[word][8 l + i] with an integer atomicAdd, lane 0
// adds it to counts[word]. Integer sums do not depend on order, so the
// tallies equal the plain version's and the reference's segment_sum bit for
// bit; contention on popular centres is what this costs. `km_majority` is
// one thread per (centre, byte): bit i is set when 2 ones > count (a tie
// gives 0); a centre with count 0 keeps its old byte. `km_idf` is one CTA:
// the total as an exact integer sum, then idf = log(total / max(count, 1))
// in f32, from the last iteration's counts.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARP_THREADS = 256;
constexpr int MAJ_THREADS = 256;
constexpr int IDF_THREADS = 1024;

__device__ __forceinline__ unsigned long long key(int d, int i) {
    return ((unsigned long long)(unsigned)d << 32) | (unsigned)i;
}

__global__ void assign_block_kernel(const uint4* desc, int N, const uint4* words, const int* grp,
                                    int B, int* out) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= N) return;  // whole warps leave together
    const uint4 a0 = desc[2 * f], a1 = desc[2 * f + 1];
    const int base = grp[f] * B;
    unsigned long long best = ~0ull;
    for (int j = lane; j < B; j += 32) {
        const uint4 b0 = words[2 * (base + j)], b1 = words[2 * (base + j) + 1];
        const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                      __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                      __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        const unsigned long long k = key(d, j);
        best = k < best ? k : best;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_down_sync(0xffffffffu, best, o);
        best = other < best ? other : best;
    }
    if (lane == 0) out[f] = base + (int)(best & 0xffffffffu);
}

__global__ void vote_kernel(const uint8_t* desc, const int* weight, const int* assign, int N,
                            int* ones, int* counts) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= N) return;
    const int w = weight ? weight[f] : 1;
    if (w == 0) return;
    const int a = assign[f];
    const unsigned b = desc[(size_t)f * 32 + lane];
    int* row = ones + (size_t)a * 256 + 8 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        if ((b >> i) & 1u) atomicAdd(row + i, w);
    if (lane == 0) atomicAdd(counts + a, w);
}

__global__ void majority_kernel(const int* ones, const int* counts, int W, uint8_t* words) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= W * 32) return;
    const int w = t >> 5, byte = t & 31;
    const int c = counts[w];
    if (c == 0) return;  // an empty centre keeps its bits
    const int* o = ones + (size_t)w * 256 + 8 * byte;
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) v |= (unsigned)(2 * o[i] > c) << i;
    words[t] = (uint8_t)v;
}

__global__ void idf_kernel(const int* counts, int W, float* idf) {
    __shared__ long long part[IDF_THREADS / 32];
    __shared__ long long total;
    long long s = 0;
    for (int i = threadIdx.x; i < W; i += blockDim.x) s += counts[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += part[k];
        total = t > 1 ? t : 1;
    }
    __syncthreads();
    const float n_total = (float)total;
    for (int i = threadIdx.x; i < W; i += blockDim.x)
        idf[i] = logf(__fdiv_rn(n_total, fmaxf((float)counts[i], 1.f)));
}

}  // namespace

// Level-2 assignment: the nearest of the B words of block grp[f] (global id).
C_ENTRY int km_assign_block(const uint8_t* desc, int N, const uint8_t* words, const int* grp,
                            int B, int* out, cudaStream_t stream) {
    if (N > 0)
        assign_block_kernel<<<(N * 32 + WARP_THREADS - 1) / WARP_THREADS, WARP_THREADS, 0,
                              stream>>>(reinterpret_cast<const uint4*>(desc), N,
                                        reinterpret_cast<const uint4*>(words), grp, B, out);
    return (int)cudaGetLastError();
}

// Tallies of one iteration: ones [W, 256] and counts [W], zeroed here, then
// each descriptor's bits times its weight (weight NULL: 1) into its word.
C_ENTRY int km_vote(const uint8_t* desc, const int* weight, const int* assign, int N, int W,
                    int* ones, int* counts, cudaStream_t stream) {
    cudaError_t e = cudaMemsetAsync(ones, 0, (size_t)W * 256 * sizeof(int), stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(counts, 0, (size_t)W * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    if (N > 0)
        vote_kernel<<<(N * 32 + WARP_THREADS - 1) / WARP_THREADS, WARP_THREADS, 0, stream>>>(
            desc, weight, assign, N, ones, counts);
    return (int)cudaGetLastError();
}

// The majority vote into the packed centres [W, 32] (in place).
C_ENTRY int km_majority(const int* ones, const int* counts, int W, uint8_t* words,
                        cudaStream_t stream) {
    if (W > 0)
        majority_kernel<<<(W * 32 + MAJ_THREADS - 1) / MAJ_THREADS, MAJ_THREADS, 0, stream>>>(
            ones, counts, W, words);
    return (int)cudaGetLastError();
}

// idf [W] = log(max(sum counts, 1) / max(count, 1)).
C_ENTRY int km_idf(const int* counts, int W, float* idf, cudaStream_t stream) {
    idf_kernel<<<1, IDF_THREADS, 0, stream>>>(counts, W, idf);
    return (int)cudaGetLastError();
}
