// K6 `pose_opt`: motion-only Levenberg-Marquardt of one SE(3) pose against
// fixed map points, all rounds and iterations in one cluster launch.
//
// Replaces corbslam_tpu/optim/pose_opt.py optimize_pose with the
// corbslam_tpu/optim/reproj.py linearize, chi2 and huber_weights it runs, and
// the se3.exp / retract / orthonormalize_fast of its update (4 rounds of 10
// iterations, Huber in rounds 0-1, chi2 re-classification between rounds).
//
// Bound on the H100: latency. The work is ~45 dependent passes over at most
// 8192 observations (a few hundred flops each) and a 6x6 solve per
// iteration: microseconds of arithmetic, while every pass waits for the
// pose that the previous one chose. What costs is the length of that chain:
// the time of one pass on the SMs that share it, the reduction of its 28
// sums, and the solve.
// Design: one cluster of 8 CTAs x 256 threads runs the whole optimisation.
// - Each CTA stages its slice of X, obs and inv_sigma2 into shared memory
//   once (cp.async), where it stays for every pass; each thread owns at
//   most 4 observations of the slice and keeps their stereo, valid, inlier
//   and active flags as bits in registers.
// - One pass per LM iteration. The reference's iteration linearizes at T,
//   solves, and evaluates the cost at T_new with T's active mask. Here the
//   pass at T_new does both that cost and the normal system at T_new (with
//   T_new's own depth test and Huber weights): on accept it is the next
//   iteration's system; on reject T, the inliers and the round are
//   unchanged, so the previous system is exactly the next iteration's. A
//   round boundary is one pass at T: the re-classification, then the new
//   round's start cost and system with the new inlier flags. 1 + 4 x 10 + 4
//   passes a call at the defaults.
// - A pass's 28 sums (21 of H, 6 of g, the cost) are reduced in a fixed
//   order: a transposing warp reduction (31 shuffles), the 8 warps in shared
//   memory, then each CTA stores its partials into every CTA's shared memory
//   (distributed shared memory) and, after the cluster barrier, every CTA
//   adds the 8 partials in rank order, so every CTA holds bit-identical
//   sums. The partials are double-buffered by pass parity: one cluster
//   barrier a pass.
// - Every thread then solves (H + lam diag(H) + 1e-10 I) d = g itself, in
//   registers (Gaussian elimination with partial pivoting, as the
//   reference's LU, unrolled over compile-time indices with row swaps as
//   selects), takes the accept decision, and forms exp(d) @ T with
//   se3.exp's small-angle branch: identical inputs give identical results
//   in every thread, so nothing is broadcast. Lambda halves or quadruples
//   (clamped to [1e-9, 1e4]) and restarts at 1e-3 each round.
// Two runs on one input are bit-equal.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OBS = 8192;
constexpr int PER_THREAD = MAX_OBS / (CLUSTER * THREADS);  // observations a thread owns
constexpr int NH = 21;                                     // unique entries of the symmetric 6x6 H
constexpr int NS = NH + 7;                                 // H, g, the robust cost
constexpr int COST = NS - 1;
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;

struct Cam {
    float fx, fy, cx, cy, bf;
};

struct Obs {
    float r[3];
    float J[3][6];
    float w[3];
    float c2;
    bool depth_ok;
};

// Residual, weights and chi2 (and with `jac` the pose Jacobian) of one
// observation at pose T (R row-major in T[0..8], t in T[9..11]).
template <bool JAC>
__device__ __forceinline__ void eval_obs(const float (&T)[12], const float* X, const float* ob,
                                         float is2, bool stereo, const Cam& c, Obs& o) {
    const float Xx = X[0], Xy = X[1], Xz = X[2];
    const float x = T[0] * Xx + T[1] * Xy + T[2] * Xz + T[9];
    const float y = T[3] * Xx + T[4] * Xy + T[5] * Xz + T[10];
    const float z = T[6] * Xx + T[7] * Xy + T[8] * Xz + T[11];
    o.depth_ok = z > 1e-3f;
    const float iz = 1.0f / (o.depth_ok ? z : 1.0f);
    const float iz2 = iz * iz;
    const float u = c.fx * x * iz + c.cx;
    const float v = c.fy * y * iz + c.cy;
    const float ur = u - c.bf * iz;
    o.r[0] = ob[0] - u;
    o.r[1] = ob[1] - v;
    o.r[2] = ob[2] - ur;
    const float wd = o.depth_ok ? is2 : 0.f;
    o.w[0] = wd;
    o.w[1] = wd;
    o.w[2] = stereo ? wd : 0.f;
    o.c2 = o.r[0] * o.r[0] * o.w[0] + o.r[1] * o.r[1] * o.w[1] + o.r[2] * o.r[2] * o.w[2];
    if (!JAC) return;
    // A = d pred / d p_cam; J = -A [I | -hat(p)] = [-A | A hat(p)].
    const float A[3][3] = {{c.fx * iz, 0.f, -c.fx * x * iz2},
                           {0.f, c.fy * iz, -c.fy * y * iz2},
                           {c.fx * iz, 0.f, -c.fx * x * iz2 + c.bf * iz2}};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        o.J[r][0] = -A[r][0];
        o.J[r][1] = -A[r][1];
        o.J[r][2] = -A[r][2];
        o.J[r][3] = A[r][1] * z - A[r][2] * y;
        o.J[r][4] = A[r][2] * x - A[r][0] * z;
        o.J[r][5] = A[r][0] * y - A[r][1] * x;
    }
}

__device__ __forceinline__ float robust(float c2, float d2, bool huber) {
    return (huber && c2 > d2) ? 2.0f * sqrtf(d2 * fmaxf(c2, 1e-12f)) - d2 : c2;
}

// Adds one observation's rows to the upper triangle of H and to g, each
// row weighted by w[r] times the robust weight rw.
__device__ __forceinline__ void add_system(const Obs& o, float rw, float (&acc)[NS]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float wr = o.w[r] * rw;
        int e = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            const float jw = o.J[r][i] * wr;
#pragma unroll
            for (int j = i; j < 6; ++j) acc[e++] += jw * o.J[r][j];
            acc[NH + i] -= jw * o.r[r];
        }
    }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// One step of the transposing warp reduction: lanes with bit S set keep
// the upper S of their 2S entries, the others the lower S, each adding its
// partner's copy of the entries it keeps.
template <int S>
__device__ __forceinline__ void fold(float (&x)[32], int lane) {
    const bool upper = lane & S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
        const float send = upper ? x[i] : x[i + S];
        const float keep = upper ? x[i + S] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
}

// Sums v[0..NS) over the cluster in a fixed order; every thread of every
// CTA gets the same sums in out[0..NS) (shared memory of its own CTA).
// red: [WARPS * 32]; part: [2][CLUSTER][32], where each CTA stores its
// partials into every CTA's slot of its rank (by parity) before the
// cluster barrier, so that after it all reads are local.
__device__ __forceinline__ void cluster_sum(float (&v)[NS], float* red, float* part, float* out,
                                            int& parity, cg::cluster_group& cluster) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // After the five folds lane L holds the warp's sum of entry L.
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = i < NS ? v[i] : 0.f;
    fold<16>(x, lane);
    fold<8>(x, lane);
    fold<4>(x, lane);
    fold<2>(x, lane);
    fold<1>(x, lane);
    red[warp * 32 + lane] = x[0];
    __syncthreads();
    float* buf = part + parity * CLUSTER * 32;
    if (t < NS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w * 32 + t];
        const int at = (int)cluster.block_rank() * 32 + t;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) cluster.map_shared_rank(buf, q)[at] = s;
    }
    cluster.sync();
    if (t < NS) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) s += buf[q * 32 + t];
        out[t] = s;
    }
    __syncthreads();
    parity ^= 1;
}

// d = (H + lam diag(H) + 1e-10 I)^-1 g, H given by its upper triangle:
// Gaussian elimination with partial pivoting (the first largest |pivot|)
// and one reciprocal a pivot, every index compile-time, so M lives in
// registers.
__device__ __forceinline__ void solve6(const float (&H)[NH], const float (&g)[6], float lam,
                                       float (&d)[6]) {
    float M[6][7], inv[6];
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
            M[i][j] = H[e];
            M[j][i] = H[e];
            ++e;
        }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        M[i][i] = M[i][i] + lam * M[i][i] + 1e-10f;
        M[i][6] = g[i];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        float best = fabsf(M[c][c]);
        int p = c;
#pragma unroll
        for (int r = c + 1; r < 6; ++r) {
            const float a = fabsf(M[r][c]);
            const bool gt = a > best;
            best = gt ? a : best;
            p = gt ? r : p;
        }
#pragma unroll
        for (int r = c + 1; r < 6; ++r) {
            const bool s = p == r;
#pragma unroll
            for (int k = c; k < 7; ++k) {
                const float a = M[c][k], b = M[r][k];
                M[c][k] = s ? b : a;
                M[r][k] = s ? a : b;
            }
        }
        inv[c] = 1.0f / M[c][c];
#pragma unroll
        for (int r = c + 1; r < 6; ++r) {
            const float f = M[r][c] * inv[c];
#pragma unroll
            for (int k = c + 1; k < 7; ++k) M[r][k] -= f * M[c][k];
        }
    }
#pragma unroll
    for (int r = 5; r >= 0; --r) {
        float s = M[r][6];
#pragma unroll
        for (int k = r + 1; k < 6; ++k) s -= M[r][k] * d[k];
        d[r] = s * inv[r];
    }
}

// Tn = exp(xi) @ T, xi = (rho, phi), with se3.exp's series below theta^2 =
// 1e-8. sincospif has no large-argument reduction, so no local memory.
__device__ __forceinline__ void retract(const float (&xi)[6], const float (&T)[12],
                                        float (&Tn)[12]) {
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float th2 = p0 * p0 + p1 * p1 + p2 * p2;
    float A, B, C;
    if (th2 < 1e-8f) {
        A = 1.0f - th2 / 6.0f;
        B = 0.5f - th2 / 24.0f;
        C = 1.0f / 6.0f - th2 / 120.0f;
    } else {
        const float th = sqrtf(th2);
        float s, c;
        sincospif(th * 0.318309886183790672f, &s, &c);
        A = s / th;
        B = (1.0f - c) / th2;
        C = (1.0f - A) / th2;
    }
    const float K[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};
    float K2[9], R[9], V[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
#pragma unroll
    for (int e = 0; e < 9; ++e) {
        const float I = (e % 4 == 0) ? 1.f : 0.f;
        R[e] = I + A * K[e] + B * K2[e];
        V[e] = I + B * K[e] + C * K2[e];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            Tn[i * 3 + j] = R[i * 3] * T[j] + R[i * 3 + 1] * T[3 + j] + R[i * 3 + 2] * T[6 + j];
        Tn[9 + i] = R[i * 3] * T[9] + R[i * 3 + 1] * T[10] + R[i * 3 + 2] * T[11] +
                    (V[i * 3] * xi[0] + V[i * 3 + 1] * xi[1] + V[i * 3 + 2] * xi[2]);
    }
}

__global__ void __launch_bounds__(THREADS, 1) pose_opt_kernel(
        const float* __restrict__ T_init, const float* __restrict__ Xs,
        const float* __restrict__ obss, const float* __restrict__ inv_s2,
        const bool* __restrict__ is_stereo, const bool* __restrict__ valid, int K, int S,
        int n_rounds, int n_iters, Cam cam, float* __restrict__ T_out, bool* __restrict__ inliers,
        int* __restrict__ n_inliers, float* __restrict__ cost_out) {
    extern __shared__ float stage[];  // X [S, 3], obs [S, 3], inv_sigma2 [S] of this CTA's slice
    __shared__ float red[WARPS * 32];
    __shared__ float part[2 * CLUSTER * 32];
    __shared__ float sums[32];
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x;
    const int k0 = (int)cluster.block_rank() * S;
    const int n = max(0, min(S, K - k0));
    float* sX = stage;
    float* sO = stage + 3 * S;
    float* sW = stage + 6 * S;
    for (int i = t; i < 3 * n; i += THREADS) {
        cp_async4(sX + i, Xs + 3 * (size_t)k0 + i);
        cp_async4(sO + i, obss + 3 * (size_t)k0 + i);
    }
    for (int i = t; i < n; i += THREADS) cp_async4(sW + i, inv_s2 + k0 + i);
    asm volatile("cp.async.commit_group;\n" ::);
    // Bit j of a mask: observation k0 + t + j * THREADS.
    unsigned st_bits = 0, va_bits = 0;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
        const int k = t + j * THREADS;
        if (k < n) {
            st_bits |= (unsigned)is_stereo[k0 + k] << j;
            va_bits |= (unsigned)valid[k0 + k] << j;
        }
    }
    float T[12], Tn[12], H[NH], g[6], d[6];
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = e < 9 ? T_init[(e / 3) * 4 + e % 3] : T_init[(e - 9) * 4 + 3];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    unsigned inl = va_bits, act = 0;
    float cost = 0.f;
    int parity = 0;
    Obs o;
    for (int rnd = 0; rnd < n_rounds; ++rnd) {
        const bool huber = rnd < 2;
        // Round start at T: re-classify (after round 0), then the round's
        // start cost and normal system with the new flags.
        float acc[NS];
#pragma unroll
        for (int e = 0; e < NS; ++e) acc[e] = 0.f;
        act = 0;
#pragma unroll 1
        for (int j = 0; j < PER_THREAD; ++j) {
            const int k = t + j * THREADS;
            if (k >= n) break;
            const bool st = (st_bits >> j) & 1u, va = (va_bits >> j) & 1u;
            eval_obs<true>(T, sX + 3 * k, sO + 3 * k, sW[k], st, cam, o);
            const float d2 = st ? CHI2_STEREO : CHI2_MONO;
            if (rnd > 0) {
                const bool in = va && o.depth_ok && o.c2 <= d2;
                inl = (inl & ~(1u << j)) | ((unsigned)in << j);
            }
            if (!(((inl >> j) & 1u) && va && o.depth_ok)) continue;
            act |= 1u << j;
            acc[COST] += robust(o.c2, d2, huber);
            add_system(o, (!huber || o.c2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(o.c2, 1e-12f)), acc);
        }
        cluster_sum(acc, red, part, sums, parity, cluster);
#pragma unroll
        for (int e = 0; e < NH; ++e) H[e] = sums[e];
#pragma unroll
        for (int i = 0; i < 6; ++i) g[i] = sums[NH + i];
        cost = sums[COST];
        float lam = 1e-3f;
        for (int it = 0; it < n_iters; ++it) {
            solve6(H, g, lam, d);
            retract(d, T, Tn);
            // At T_new: the cost with T's active flags, and T_new's own
            // system with its active flags (kept if T_new is accepted).
#pragma unroll
            for (int e = 0; e < NS; ++e) acc[e] = 0.f;
            unsigned cand = 0;
#pragma unroll 1
            for (int j = 0; j < PER_THREAD; ++j) {
                const int k = t + j * THREADS;
                if (k >= n) break;
                const bool st = (st_bits >> j) & 1u, va = (va_bits >> j) & 1u;
                eval_obs<true>(Tn, sX + 3 * k, sO + 3 * k, sW[k], st, cam, o);
                const float d2 = st ? CHI2_STEREO : CHI2_MONO;
                if ((act >> j) & 1u) acc[COST] += robust(o.c2, d2, huber);
                if (!(((inl >> j) & 1u) && va && o.depth_ok)) continue;
                cand |= 1u << j;
                add_system(o, (!huber || o.c2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(o.c2, 1e-12f)),
                           acc);
            }
            cluster_sum(acc, red, part, sums, parity, cluster);
            if (sums[COST] < cost) {
#pragma unroll
                for (int e = 0; e < 12; ++e) T[e] = Tn[e];
#pragma unroll
                for (int e = 0; e < NH; ++e) H[e] = sums[e];
#pragma unroll
                for (int i = 0; i < 6; ++i) g[i] = sums[NH + i];
                cost = sums[COST];
                act = cand;
                lam = fmaxf(lam * 0.5f, 1e-9f);
            } else {
                lam = fminf(lam * 4.0f, 1e4f);
            }
        }
    }

    // The last round's re-classification at T, and the inlier count.
    float acc[NS];
#pragma unroll
    for (int e = 0; e < NS; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int j = 0; j < PER_THREAD; ++j) {
        const int k = t + j * THREADS;
        if (k >= n) break;
        const bool st = (st_bits >> j) & 1u, va = (va_bits >> j) & 1u;
        bool in = (inl >> j) & 1u;
        if (n_rounds > 0) {
            eval_obs<false>(T, sX + 3 * k, sO + 3 * k, sW[k], st, cam, o);
            in = va && o.depth_ok && o.c2 <= (st ? CHI2_STEREO : CHI2_MONO);
        }
        inliers[k0 + k] = in;
        acc[0] += in ? 1.f : 0.f;
    }
    cluster_sum(acc, red, part, sums, parity, cluster);
    if (cluster.block_rank() == 0 && t == 0) {
        // orthonormalize_fast: R <- R (3I - R^T R) / 2, three times.
        float R[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) R[e] = T[e];
#pragma unroll
        for (int step = 0; step < 3; ++step) {
            float RtR[9], Rn[9];
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
                for (int j = 0; j < 3; ++j)
                    RtR[i * 3 + j] = R[i] * R[j] + R[3 + i] * R[3 + j] + R[6 + i] * R[6 + j];
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    float s = 0.f;
#pragma unroll
                    for (int k = 0; k < 3; ++k)
                        s += R[i * 3 + k] * (((k == j) ? 3.f : 0.f) - RtR[k * 3 + j]);
                    Rn[i * 3 + j] = 0.5f * s;
                }
#pragma unroll
            for (int e = 0; e < 9; ++e) R[e] = Rn[e];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) T_out[i * 4 + j] = R[i * 3 + j];
            T_out[i * 4 + 3] = T[9 + i];
        }
        T_out[12] = 0.f;
        T_out[13] = 0.f;
        T_out[14] = 0.f;
        T_out[15] = 1.f;
        n_inliers[0] = (int)sums[0];
        cost_out[0] = cost;
    }
    // No CTA may leave while another still reads its partials.
    cluster.sync();
}

}  // namespace

// One problem of K <= 8192 observations on one cluster of 8 CTAs (a cluster
// launch; an error, such as a cluster the card cannot place, is returned).
// Relocalization and loop closing check their candidates one at a time, so
// there is no batch axis.
C_ENTRY int pose_opt(const float* T_init, const float* X, const float* obs, const float* inv_s2,
                     const bool* is_stereo, const bool* valid, int K, int n_rounds, int n_iters,
                     float fx, float fy, float cx, float cy, float bf, float* T_out,
                     bool* inliers, int* n_inliers, float* cost, cudaStream_t stream) {
    if (K < 0 || K > MAX_OBS || n_rounds < 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
    const int S = (K + CLUSTER - 1) / CLUSTER;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)S * 7 * sizeof(float);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const Cam cam{fx, fy, cx, cy, bf};
    const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_opt_kernel, T_init, X, obs, inv_s2,
                                               is_stereo, valid, K, S, n_rounds, n_iters, cam,
                                               T_out, inliers, n_inliers, cost);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
}
