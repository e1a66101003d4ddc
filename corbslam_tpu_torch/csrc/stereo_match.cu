// K4 `stereo_match`: masked Hamming best match + SAD sub-pixel refinement +
// median cut, for every left feature of a stereo pair.
//
// Replaces corbslam_tpu/ops/stereo.py match_stereo_features together with
// the part of corbslam_tpu/ops/descriptors.py it uses (hamming_matrix,
// masked_hamming_matrix, best_match with ratio 1.0, popcount).
//
// Bound on the H100: integer work of the N x M candidate test (2048 x 2048
// pairs a frame, each a mask, 8 XORs and 8 popcounts); the bytes are small
// (64 KB of right descriptors, L2-resident, plus two 11-row windows per left
// feature), so the [N, M] distance matrix the reference materializes is the
// thing to avoid.
// Design: `stereo_best` is one 256-thread block per left feature. Threads
// stride over the right features, evaluate the row / disparity / octave /
// validity mask inline, take the distance as 8 x __popc of u32 XOR (512 when
// masked) and keep a running (distance, index) minimum — lower index on
// ties, as argmin/top_k order them — so nothing N x M is stored. The block
// then slides the 11x11 centre window of the left patch over the chosen
// right patch (11 shifts, partial sums in shared memory), takes the first
// minimum, and evaluates the parabola and u_right with explicitly rounded
// f32 operations in the reference's order (no fused multiply-add).
// `stereo_finish` is one block for the frame: it sees whether every feature
// passed (if not, the reference's median is NaN and the cut is a no-op),
// otherwise finds the two middle SADs by stable rank counting in shared
// memory and averages them as jnp.median does, then applies the 2.1 x
// median cut and writes depth = bf / max(disparity, 0.1) and u_right.
//
// `rgbd_stereo` replaces corbslam_tpu/ops/stereo.py compute_stereo_from_rgbd
// (B6's RGB-D half): one thread per feature rounds the raw keypoint half to
// even (rintf, as jnp.round), clamps it into the image, reads the registered
// depth map there and writes u_right = x_undistorted - bf / max(d, min_depth)
// and the depth, or -1 / 0 where the feature is invalid or d <= min_depth.
// Bound: bytes (a 4-byte gather and ~20 bytes of keypoint in and out per
// feature), so it is one launch with no shared memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int RAW = 32;
constexpr int C = RAW / 2;
constexpr int PW = 5;           // SAD half-window (11x11)
constexpr int SR = 5;           // +-5 px slide
constexpr int WIN = 2 * PW + 1;
constexpr int NS = 2 * SR + 1;  // 11 shifts
constexpr int INF_DIST = 512;

__device__ __forceinline__ bool better(int d, int j, int bd, int bj) {
    return d < bd || (d == bd && j < bj);
}

__global__ void __launch_bounds__(256) stereo_best_kernel(
        const float2* __restrict__ xy_l, const int* __restrict__ oct_l,
        const bool* __restrict__ valid_l, const uint4* __restrict__ desc_l,
        const float* __restrict__ patch_l, const float2* __restrict__ xy_r,
        const int* __restrict__ oct_r, const bool* __restrict__ valid_r,
        const uint4* __restrict__ desc_r, const float* __restrict__ patch_r,
        const float* __restrict__ scales, int M, float max_disp, int max_hamming,
        int* __restrict__ idx_out, int* __restrict__ dist_out, float* __restrict__ u_pre,
        float* __restrict__ disp_out, bool* __restrict__ ok_pre, float* __restrict__ sad_out) {
    __shared__ int red_d[8], red_j[8];
    __shared__ int s_best_j, s_best_d;
    __shared__ float Ls[WIN][WIN];
    __shared__ float Rs[WIN][WIN + 2 * SR];
    __shared__ float part[NS][WIN];
    __shared__ float sad[NS];
    const int i = blockIdx.x, t = threadIdx.x;
    const float2 pl = xy_l[i];
    const int ol = oct_l[i];
    const bool vl = valid_l[i];
    const uint4 a0 = desc_l[2 * i], a1 = desc_l[2 * i + 1];

    int bd = 0x7fffffff, bj = 0x7fffffff;
    for (int j = t; j < M; j += blockDim.x) {
        const float2 pr = xy_r[j];
        const int orr = oct_r[j];
        const float row_tol = 2.0f * scales[orr];
        const float disp = pl.x - pr.x;
        const bool m = vl && valid_r[j] && fabsf(pl.y - pr.y) <= row_tol && disp >= -1.0f &&
                       disp <= max_disp && abs(ol - orr) <= 1;
        int d = INF_DIST;
        if (m) {
            const uint4 b0 = desc_r[2 * j], b1 = desc_r[2 * j + 1];
            d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        }
        if (better(d, j, bd, bj)) { bd = d; bj = j; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const int od = __shfl_down_sync(0xffffffffu, bd, o);
        const int oj = __shfl_down_sync(0xffffffffu, bj, o);
        if (better(od, oj, bd, bj)) { bd = od; bj = oj; }
    }
    const int warp = t >> 5, lane = t & 31;
    if (lane == 0) { red_d[warp] = bd; red_j[warp] = bj; }
    __syncthreads();
    if (t == 0) {
        bd = red_d[0];
        bj = red_j[0];
        for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
            if (better(red_d[k], red_j[k], bd, bj)) { bd = red_d[k]; bj = red_j[k]; }
        s_best_d = bd;
        s_best_j = bj;
    }
    __syncthreads();
    const int j = s_best_j;

    const float* L = patch_l + (size_t)i * RAW * RAW;
    const float* R = patch_r + (size_t)j * RAW * RAW;
    for (int e = t; e < WIN * WIN; e += blockDim.x)
        Ls[e / WIN][e % WIN] = L[(C - PW + e / WIN) * RAW + C - PW + e % WIN];
    for (int e = t; e < WIN * (WIN + 2 * SR); e += blockDim.x) {
        const int r = e / (WIN + 2 * SR), c = e % (WIN + 2 * SR);
        Rs[r][c] = R[(C - PW + r) * RAW + C - SR - PW + c];
    }
    __syncthreads();
    if (t < NS * WIN) {
        const int s = t / WIN, r = t % WIN;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < WIN; ++c) acc += fabsf(Rs[r][c + s] - Ls[r][c]);
        part[s][r] = acc;
    }
    __syncthreads();
    if (t < NS) {
        float acc = 0.f;
        for (int r = 0; r < WIN; ++r) acc += part[t][r];
        sad[t] = acc;
    }
    __syncthreads();
    if (t == 0) {
        int best = 0;
        for (int s = 1; s < NS; ++s)
            if (sad[s] < sad[best]) best = s;
        const int bir = min(max(best, 1), NS - 2);
        const float s0 = sad[bir - 1], s1 = sad[bir], s2 = sad[bir + 1];
        const float denom = __fsub_rn(__fadd_rn(s0, s2), __fmul_rn(2.0f, s1));
        float delta = 0.f;
        if (fabsf(denom) > 1e-6f)
            delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(s0, s2)), fmaxf(denom, 1e-6f));
        delta = fminf(fmaxf(delta, -1.0f), 1.0f);
        const float shift = __fadd_rn((float)(bir - SR), delta);
        const float u = __fadd_rn(xy_r[j].x, __fmul_rn(shift, scales[oct_r[j]]));
        const float disparity = __fsub_rn(pl.x, u);
        idx_out[i] = j;
        dist_out[i] = s_best_d;
        u_pre[i] = u;
        disp_out[i] = disparity;
        ok_pre[i] = s_best_d <= max_hamming && disparity > 0.1f && disparity < max_disp;
        sad_out[i] = s1;
    }
}

__global__ void __launch_bounds__(1024) stereo_finish_kernel(
        const float* __restrict__ u_pre, const float* __restrict__ disp,
        const bool* __restrict__ ok_pre, const float* __restrict__ best_sad, int N, float bf,
        float* __restrict__ u_right, float* __restrict__ depth, bool* __restrict__ ok) {
    extern __shared__ float s[];
    __shared__ float lo_v, hi_v;
    const int t = threadIdx.x;
    int bad = 0;
    for (int i = t; i < N; i += blockDim.x) {
        s[i] = best_sad[i];
        bad |= !ok_pre[i];
    }
    const int any_bad = __syncthreads_or(bad);
    float med = INFINITY;  // jnp.median of a NaN-holding array -> NaN -> inf
    if (!any_bad) {
        const int lo = (N - 1) / 2, hi = N / 2;
        for (int i = t; i < N; i += blockDim.x) {
            const float v = s[i];
            int rank = 0;
            for (int k = 0; k < N; ++k) {
                const float u = s[k];
                rank += (u < v) | ((u == v) & (k < i));
            }
            if (rank == lo) lo_v = v;
            if (rank == hi) hi_v = v;
        }
        __syncthreads();
        med = __fmul_rn(__fadd_rn(lo_v, hi_v), 0.5f);
    }
    const float cut = __fadd_rn(__fmul_rn(2.1f, med), 1e-3f);
    for (int i = t; i < N; i += blockDim.x) {
        const bool o = ok_pre[i] && s[i] <= cut;
        ok[i] = o;
        depth[i] = o ? __fdiv_rn(bf, fmaxf(disp[i], 0.1f)) : 0.f;
        u_right[i] = o ? u_pre[i] : -1.0f;
    }
}

__global__ void rgbd_stereo_kernel(const float* __restrict__ depth_map, int h, int w,
                                   const float2* __restrict__ xy, const float* __restrict__ xy_und,
                                   const bool* __restrict__ valid, int N, float bf, float min_depth,
                                   float* __restrict__ u_right, float* __restrict__ depth,
                                   bool* __restrict__ ok) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const float2 p = xy[i];
    const int xi = min(max((int)rintf(p.x), 0), w - 1);
    const int yi = min(max((int)rintf(p.y), 0), h - 1);
    const float d = depth_map[(size_t)yi * w + xi];
    const bool o = valid[i] && d > min_depth;
    ok[i] = o;
    depth[i] = o ? d : 0.f;
    u_right[i] = o ? __fsub_rn(xy_und[2 * i], __fdiv_rn(bf, fmaxf(d, min_depth))) : -1.0f;
}

}  // namespace

// Best right match and refined u_right for each of N left features against
// M right features (pre-cut: ok_pre, best_sad).
C_ENTRY int stereo_best(const float* xy_l, const int* oct_l, const bool* valid_l,
                        const uint8_t* desc_l, const float* patch_l, const float* xy_r,
                        const int* oct_r, const bool* valid_r, const uint8_t* desc_r,
                        const float* patch_r, const float* scales, int N, int M, float max_disp,
                        int max_hamming, int* idx, int* dist, float* u_pre, float* disp,
                        bool* ok_pre, float* best_sad, cudaStream_t stream) {
    stereo_best_kernel<<<N, 256, 0, stream>>>(
        reinterpret_cast<const float2*>(xy_l), oct_l, valid_l,
        reinterpret_cast<const uint4*>(desc_l), patch_l, reinterpret_cast<const float2*>(xy_r),
        oct_r, valid_r, reinterpret_cast<const uint4*>(desc_r), patch_r, scales, M, max_disp,
        max_hamming, idx, dist, u_pre, disp, ok_pre, best_sad);
    return (int)cudaGetLastError();
}

// Median cut and final outputs for the frame (one block; N <= 12288).
C_ENTRY int stereo_finish(const float* u_pre, const float* disp, const bool* ok_pre,
                          const float* best_sad, int N, float bf, float* u_right, float* depth,
                          bool* ok, cudaStream_t stream) {
    stereo_finish_kernel<<<1, 1024, N * sizeof(float), stream>>>(u_pre, disp, ok_pre, best_sad,
                                                                 N, bf, u_right, depth, ok);
    return (int)cudaGetLastError();
}

// (u_right, depth, ok) of N features from a registered [h, w] depth map.
C_ENTRY int rgbd_stereo(const float* depth_map, int h, int w, const float* xy,
                        const float* xy_und, const bool* valid, int N, float bf, float min_depth,
                        float* u_right, float* depth, bool* ok, cudaStream_t stream) {
    if (N > 0)
        rgbd_stereo_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
            depth_map, h, w, reinterpret_cast<const float2*>(xy), xy_und, valid, N, bf,
            min_depth, u_right, depth, ok);
    return (int)cudaGetLastError();
}
