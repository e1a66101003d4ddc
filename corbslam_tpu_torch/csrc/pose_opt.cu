// K6 `pose_opt`: motion-only Levenberg-Marquardt of one SE(3) pose against
// fixed map points, all rounds and iterations in one launch.
//
// Replaces corbslam_tpu/optim/pose_opt.py optimize_pose with the
// corbslam_tpu/optim/reproj.py linearize, chi2 and huber_weights it runs, and
// the se3.exp / retract / orthonormalize_fast of its update (4 rounds of 10
// iterations, Huber in rounds 0-1, chi2 re-classification between rounds).
//
// Bound on the H100: latency. The work is ~88 passes over at most 2048
// observations (a few hundred flops each) and a 6x6 solve per iteration,
// about 25 MFLOP and 60 KB of inputs: microseconds of arithmetic, while the
// passes depend on each other through the pose. The reference scans ~80
// small XLA steps; launch and synchronisation count is what costs.
// Design: one 256-thread CTA per problem runs the whole optimisation. Each
// pass strides the observations over the threads, computes the residual,
// the analytic 3x6 pose Jacobian, the row weights (depth_ok = z > 1e-3,
// mono rows zero the u_right weight) and chi2, and accumulates the 21
// unique entries of H, the 6 of g or the robust cost in registers; a warp
// shuffle plus a shared-memory pass over the 8 warps reduces them in a fixed
// order. Thread 0 solves (H + lam diag(H) + 1e-10 I) d = g by Gaussian
// elimination with partial pivoting (the reference's jnp.linalg.solve is an
// LU), forms exp(d) @ T with se3.exp's small-angle branch, and after the
// cost pass at the new pose keeps it only if the cost dropped, halving or
// quadrupling lambda (clamped to [1e-9, 1e4], reset to 1e-3 each round).
// Each observation's active flag of the current iteration sits in shared
// memory, and its inlier flag in the output array, owned by one thread.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;  // unique entries of the symmetric 6x6 H
constexpr int NSYS = NH + 6;
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

// Residual, weights and chi2 (and with `jac` the pose Jacobian) of
// observation k at pose T (R row-major in T[0..8], t in T[9..11]).
__device__ __forceinline__ void eval_obs(const float* T, const float* X, const float* obs,
                                         float is2, bool stereo, const Cam& c, bool jac, Obs& o) {
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
    o.r[0] = obs[0] - u;
    o.r[1] = obs[1] - v;
    o.r[2] = obs[2] - ur;
    const float wd = o.depth_ok ? is2 : 0.f;
    o.w[0] = wd;
    o.w[1] = wd;
    o.w[2] = stereo ? wd : 0.f;
    o.c2 = o.r[0] * o.r[0] * o.w[0] + o.r[1] * o.r[1] * o.w[1] + o.r[2] * o.r[2] * o.w[2];
    if (!jac) return;
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

// Sum v[0..n) over the block in a fixed order; the result lands in out[0..n).
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* out) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
        for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
    }
    __syncthreads();
    if (t < N) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[w * N + t];
        out[t] = s;
    }
    __syncthreads();
}

// 3x3 row-major product C = A B.
__device__ void mat3(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j] + A[i * 3 + 2] * B[6 + j];
}

// Tn = exp(xi) @ T, xi = (rho, phi), with se3.exp's series below theta^2 = 1e-8.
__device__ void retract(const float* xi, const float* T, float* Tn) {
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float th2 = p0 * p0 + p1 * p1 + p2 * p2;
    float A, B, C;
    if (th2 < 1e-8f) {
        A = 1.0f - th2 / 6.0f;
        B = 0.5f - th2 / 24.0f;
        C = 1.0f / 6.0f - th2 / 120.0f;
    } else {
        const float th = sqrtf(th2);
        A = sinf(th) / th;
        B = (1.0f - cosf(th)) / th2;
        C = (1.0f - A) / th2;
    }
    const float K[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};
    float K2[9], R[9], V[9];
    mat3(K, K, K2);
    for (int e = 0; e < 9; ++e) {
        const float I = (e % 4 == 0) ? 1.f : 0.f;
        R[e] = I + A * K[e] + B * K2[e];
        V[e] = I + B * K[e] + C * K2[e];
    }
    float tt[3];
    for (int i = 0; i < 3; ++i) tt[i] = V[i * 3] * xi[0] + V[i * 3 + 1] * xi[1] + V[i * 3 + 2] * xi[2];
    mat3(R, T, Tn);
    for (int i = 0; i < 3; ++i)
        Tn[9 + i] = R[i * 3] * T[9] + R[i * 3 + 1] * T[10] + R[i * 3 + 2] * T[11] + tt[i];
}

// Solve the 6x6 system M d = g in place (Gaussian elimination, partial pivoting).
__device__ void solve6(float M[6][6], float g[6], float d[6]) {
    for (int c = 0; c < 6; ++c) {
        int p = c;
        for (int r = c + 1; r < 6; ++r)
            if (fabsf(M[r][c]) > fabsf(M[p][c])) p = r;
        if (p != c) {
            for (int k = 0; k < 6; ++k) {
                const float tmp = M[c][k];
                M[c][k] = M[p][k];
                M[p][k] = tmp;
            }
            const float tmp = g[c];
            g[c] = g[p];
            g[p] = tmp;
        }
        for (int r = c + 1; r < 6; ++r) {
            const float f = M[r][c] / M[c][c];
            for (int k = c; k < 6; ++k) M[r][k] -= f * M[c][k];
            g[r] -= f * g[c];
        }
    }
    for (int r = 5; r >= 0; --r) {
        float s = g[r];
        for (int k = r + 1; k < 6; ++k) s -= M[r][k] * d[k];
        d[r] = s / M[r][r];
    }
}

__global__ void __launch_bounds__(THREADS) pose_opt_kernel(
        const float* __restrict__ T_init, const float* __restrict__ Xs,
        const float* __restrict__ obss, const float* __restrict__ inv_s2,
        const bool* __restrict__ is_stereo, const bool* __restrict__ valid, int K, int n_rounds,
        int n_iters, Cam cam, float* __restrict__ T_out, bool* __restrict__ inliers,
        int* __restrict__ n_inliers, float* __restrict__ cost_out) {
    extern __shared__ unsigned char s_active[];  // [K] active flag of the current iteration
    __shared__ float sT[12], sTn[12];
    __shared__ float red[WARPS * NSYS];
    __shared__ float sums[NSYS];
    __shared__ float s_cost, s_lam;
    const int b = blockIdx.x, t = threadIdx.x;
    const float* X = Xs + (size_t)b * K * 3;
    const float* ob = obss + (size_t)b * K * 3;
    const float* is2 = inv_s2 + (size_t)b * K;
    const bool* st = is_stereo + (size_t)b * K;
    const bool* va = valid + (size_t)b * K;
    bool* inl = inliers + (size_t)b * K;
    if (t < 12) sT[t] = t < 9 ? T_init[b * 16 + (t / 3) * 4 + t % 3] : T_init[b * 16 + (t - 9) * 4 + 3];
    for (int k = t; k < K; k += THREADS) inl[k] = va[k];
    __syncthreads();

    Obs o;
    for (int rnd = 0; rnd < n_rounds; ++rnd) {
        const bool huber = rnd < 2;
        float c[1] = {0.f};
        for (int k = t; k < K; k += THREADS) {
            eval_obs(sT, X + 3 * k, ob + 3 * k, is2[k], st[k], cam, false, o);
            const float d2 = st[k] ? CHI2_STEREO : CHI2_MONO;
            if (inl[k] && va[k] && o.depth_ok) c[0] += robust(o.c2, d2, huber);
        }
        block_sum<1>(c, red, sums);
        if (t == 0) {
            s_cost = sums[0];
            s_lam = 1e-3f;
        }
        __syncthreads();
        for (int it = 0; it < n_iters; ++it) {
            float acc[NSYS];
#pragma unroll
            for (int e = 0; e < NSYS; ++e) acc[e] = 0.f;
            for (int k = t; k < K; k += THREADS) {
                eval_obs(sT, X + 3 * k, ob + 3 * k, is2[k], st[k], cam, true, o);
                const bool act = inl[k] && va[k] && o.depth_ok;
                s_active[k] = act;
                if (!act) continue;
                const float d2 = st[k] ? CHI2_STEREO : CHI2_MONO;
                const float rw = (!huber || o.c2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(o.c2, 1e-12f));
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
            block_sum<NSYS>(acc, red, sums);
            if (t == 0) {
                float M[6][6], g[6], d[6];
                int e = 0;
                for (int i = 0; i < 6; ++i)
                    for (int j = i; j < 6; ++j) M[i][j] = M[j][i] = sums[e++];
                for (int i = 0; i < 6; ++i) {
                    M[i][i] = M[i][i] + s_lam * M[i][i] + 1e-10f;
                    g[i] = sums[NH + i];
                }
                solve6(M, g, d);
                retract(d, sT, sTn);
            }
            __syncthreads();
            c[0] = 0.f;
            for (int k = t; k < K; k += THREADS) {
                if (!s_active[k]) continue;
                eval_obs(sTn, X + 3 * k, ob + 3 * k, is2[k], st[k], cam, false, o);
                c[0] += robust(o.c2, st[k] ? CHI2_STEREO : CHI2_MONO, huber);
            }
            block_sum<1>(c, red, sums);
            if (t == 0) {
                if (sums[0] < s_cost) {
                    for (int e = 0; e < 12; ++e) sT[e] = sTn[e];
                    s_lam = fmaxf(s_lam * 0.5f, 1e-9f);
                    s_cost = sums[0];
                } else {
                    s_lam = fminf(s_lam * 4.0f, 1e4f);
                }
            }
            __syncthreads();
        }
        for (int k = t; k < K; k += THREADS) {
            eval_obs(sT, X + 3 * k, ob + 3 * k, is2[k], st[k], cam, false, o);
            inl[k] = va[k] && o.depth_ok && o.c2 <= (st[k] ? CHI2_STEREO : CHI2_MONO);
        }
        __syncthreads();
    }

    float cnt[1] = {0.f};
    for (int k = t; k < K; k += THREADS) cnt[0] += inl[k] ? 1.f : 0.f;
    block_sum<1>(cnt, red, sums);
    if (t == 0) {
        // orthonormalize_fast: R <- R (3I - R^T R) / 2, three times.
        float R[9], RtR[9], Rt[9], S[9];
        for (int e = 0; e < 9; ++e) R[e] = sT[e];
        for (int step = 0; step < 3; ++step) {
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = R[j * 3 + i];
            mat3(Rt, R, RtR);
            for (int e = 0; e < 9; ++e) S[e] = ((e % 4 == 0) ? 3.f : 0.f) - RtR[e];
            mat3(R, S, RtR);
            for (int e = 0; e < 9; ++e) R[e] = 0.5f * RtR[e];
        }
        float* To = T_out + b * 16;
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) To[i * 4 + j] = R[i * 3 + j];
            To[i * 4 + 3] = sT[9 + i];
        }
        To[12] = 0.f;
        To[13] = 0.f;
        To[14] = 0.f;
        To[15] = 1.f;
        n_inliers[b] = (int)sums[0];
        cost_out[b] = s_cost;
    }
}

}  // namespace

// B independent problems of K observations each (one CTA per problem). The
// tracking step launches B = 1; the batch axis is for optimize_pose_batch
// (relocalization's candidate poses), which is not ported yet.
C_ENTRY int pose_opt(const float* T_init, const float* X, const float* obs, const float* inv_s2,
                     const bool* is_stereo, const bool* valid, int B, int K, int n_rounds,
                     int n_iters, float fx, float fy, float cx, float cy, float bf, float* T_out,
                     bool* inliers, int* n_inliers, float* cost, cudaStream_t stream) {
    const Cam cam{fx, fy, cx, cy, bf};
    pose_opt_kernel<<<B, THREADS, (size_t)K, stream>>>(T_init, X, obs, inv_s2, is_stereo, valid,
                                                       K, n_rounds, n_iters, cam, T_out, inliers,
                                                       n_inliers, cost);
    return (int)cudaGetLastError();
}
