// K10 `ransac`: Sim3 RANSAC (Horn on three correspondences, inliers in both
// cameras) with its iterative refinement, and PnP RANSAC (DLT on six).
//
// Replaces corbslam_tpu/solvers/sim3_solver.py horn_sim3 (vmapped over the
// hypotheses), solve_sim3_ransac and refine_sim3_iterative, and
// corbslam_tpu/solvers/pnp.py _dlt_pose (vmapped) and solve_pnp_ransac: the
// reference materializes [H, N, 3] transformed points and [H, N] errors.
//
// Bound on the H100: operations. H = 256 hypotheses x N <= 2048 matches x
// ~60 flops of the two-camera test is ~30 MFLOP with ~60 KB of inputs;
// each hypothesis's model (100 power iterations of a 4x4, or a 12x12
// Cholesky, 8 inverse iterations and 8 polar steps) is a few thousand
// dependent flops on one thread.
// Design: `*_hypotheses` runs one 256-thread CTA per hypothesis: thread 0
// solves the model into shared memory with the reference's arithmetic
// (Gershgorin-shifted power iteration; Hartley normalization, regularized
// Cholesky inverse iteration, det sign and cube-root scale, Cramer polar
// steps, the PnP model in double as its plain version), then every thread
// tests its strided matches and a block
// reduction counts the inliers exactly (integers). `*_select` is one CTA:
// the first maximum of the counts (jnp.argmax), then the winner's inlier
// mask by the same test. `sim3_refine` is one 1024-thread CTA for all
// rounds: each round reduces the 7x7 normal equations of the Huber
// reprojection error in both cameras in a fixed order, thread 0 solves by
// Cholesky and retracts (sim3.cuh), and the final classification keeps the
// refined model only if it has at least the input's inliers. The sample
// (which matches form each hypothesis) is an input, drawn by the caller.

#include "common.cuh"
#include "sim3.cuh"

namespace {

constexpr int HYP_THREADS = 256;
constexpr int SEL_THREADS = 1024;
constexpr float CHI2_SIM3 = 9.21f;

struct Cam {
    float fx, fy, cx, cy;
};

__device__ __forceinline__ void project(const Cam& c, float x, float y, float z, float& u,
                                        float& v) {
    const float inv_z = 1.f / (fabsf(z) < 1e-9f ? 1e-9f : z);
    u = c.fx * x * inv_z + c.cx;
    v = c.fy * y * inv_z + c.cy;
}

template <class T> __device__ T block_reduce_sum(T v, T* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        T u = lane < nw ? sh[lane] : T(0);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) u += __shfl_down_sync(0xffffffffu, u, o);
        if (lane == 0) sh[32] = u;
    }
    __syncthreads();
    const T r = sh[32];
    __syncthreads();
    return r;
}

// Sim3Solver::CheckInliers for match n under (R, t, s): both reprojection
// errors under 9.21 sigma^2, in front of both cameras.
__device__ bool sim3_inlier(const float* R, const float* t, float s, const float* p1,
                           const float* p2, const bool* valid, const float* s2_1,
                           const float* s2_2, int n, const Cam& c1, const Cam& c2) {
    const float x1 = p1[3 * n], y1 = p1[3 * n + 1], z1 = p1[3 * n + 2];
    const float x2 = p2[3 * n], y2 = p2[3 * n + 1], z2 = p2[3 * n + 2];
    float a[3], b[3];
    for (int i = 0; i < 3; ++i) a[i] = s * (R[3 * i] * x2 + R[3 * i + 1] * y2 + R[3 * i + 2] * z2) + t[i];
    const float s_inv = 1.f / fmaxf(s, 1e-12f);
    const float d0 = x1 - t[0], d1 = y1 - t[1], d2 = z1 - t[2];
    for (int i = 0; i < 3; ++i) b[i] = s_inv * (d0 * R[i] + d1 * R[3 + i] + d2 * R[6 + i]);
    float u, v, uo, vo;
    project(c1, a[0], a[1], a[2], u, v);
    project(c1, x1, y1, z1, uo, vo);
    const float e1 = (u - uo) * (u - uo) + (v - vo) * (v - vo);
    project(c2, b[0], b[1], b[2], u, v);
    project(c2, x2, y2, z2, uo, vo);
    const float e2 = (u - uo) * (u - uo) + (v - vo) * (v - vo);
    return e1 < CHI2_SIM3 * s2_1[n] && e2 < CHI2_SIM3 * s2_2[n] && valid[n] && a[2] > 0.f &&
           b[2] > 0.f;
}

// R_from_quat of v (w, x, y, z), normalized first.
__device__ void r_from_quat(const float* q0, float* R) {
    const float nrm = fmaxf(sqrtf(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2] + q0[3] * q0[3]),
                            SIM3_EPS);
    const float w = q0[0] / nrm, x = q0[1] / nrm, y = q0[2] / nrm, z = q0[3] / nrm;
    R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
    R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
    R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// horn_sim3 on K = 3 correspondences with unit weights.
__device__ void horn3(const float (*P1)[3], const float (*P2)[3], bool fix_scale, float* R,
                      float* t, float& s) {
    const float wn = 1.f / fmaxf(3.f, 1e-12f);
    const float sw = sqrtf(wn);
    float c1[3], c2[3], q1[3][3], q2[3][3];
    for (int i = 0; i < 3; ++i) {
        c1[i] = P1[0][i] * wn + P1[1][i] * wn + P1[2][i] * wn;
        c2[i] = P2[0][i] * wn + P2[1][i] * wn + P2[2][i] * wn;
    }
    for (int k = 0; k < 3; ++k)
        for (int i = 0; i < 3; ++i) {
            q1[k][i] = (P1[k][i] - c1[i]) * sw;
            q2[k][i] = (P2[k][i] - c2[i]) * sw;
        }
    float M[3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) M[i][j] = q2[0][i] * q1[0][j] + q2[1][i] * q1[1][j] + q2[2][i] * q1[2][j];
    const float Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
    const float Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
    const float Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
    float N[4][4] = {{Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
                     {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
                     {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
                     {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz}};
    float gmin = 0.f;
    for (int i = 0; i < 4; ++i) {
        const float rad = (fabsf(N[i][0]) + fabsf(N[i][1]) + fabsf(N[i][2]) + fabsf(N[i][3])) -
                          fabsf(N[i][i]);
        const float g = N[i][i] - rad;
        gmin = (i == 0) ? g : fminf(gmin, g);
    }
    const float shift = fmaxf(-gmin, 0.f);
    for (int i = 0; i < 4; ++i) N[i][i] += shift;
    float v[4] = {1.f, 1.f, 1.f, 1.f};
    for (int it = 0; it < 100; ++it) {
        float u[4];
        for (int i = 0; i < 4; ++i) u[i] = N[i][0] * v[0] + N[i][1] * v[1] + N[i][2] * v[2] + N[i][3] * v[3];
        const float nrm = fmaxf(sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + u[3] * u[3]), 1e-12f);
        for (int i = 0; i < 4; ++i) v[i] = u[i] / nrm;
    }
    r_from_quat(v, R);
    if (fix_scale) {
        s = 1.f;
    } else {
        float num = 0.f, den = 0.f;
        for (int k = 0; k < 3; ++k)
            for (int i = 0; i < 3; ++i) {
                const float r = R[3 * i] * q2[k][0] + R[3 * i + 1] * q2[k][1] + R[3 * i + 2] * q2[k][2];
                num += q1[k][i] * r;
                den += r * r;
            }
        s = num / fmaxf(den, 1e-12f);
    }
    for (int i = 0; i < 3; ++i) t[i] = c1[i] - s * (R[3 * i] * c2[0] + R[3 * i + 1] * c2[1] + R[3 * i + 2] * c2[2]);
}

__global__ void sim3_hyp_kernel(const float* p1, const float* p2, const bool* valid,
                                const float* s2_1, const float* s2_2, int N, const int* idx,
                                int fix_scale, Cam c1, Cam c2, float* hR, float* ht, float* hs,
                                int* counts) {
    __shared__ float model[13];
    __shared__ int sh[33];
    const int h = blockIdx.x;
    if (threadIdx.x == 0) {
        float P1[3][3], P2[3][3];
        for (int k = 0; k < 3; ++k) {
            const int n = idx[3 * h + k];
            for (int i = 0; i < 3; ++i) {
                P1[k][i] = p1[3 * n + i];
                P2[k][i] = p2[3 * n + i];
            }
        }
        float s;
        horn3(P1, P2, fix_scale != 0, model, model + 9, s);
        model[12] = s;
    }
    __syncthreads();
    int cnt = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        cnt += sim3_inlier(model, model + 9, model[12], p1, p2, valid, s2_1, s2_2, n, c1, c2);
    cnt = block_reduce_sum(cnt, sh);
    if (threadIdx.x == 0) counts[h] = cnt;
    if (threadIdx.x < 9) hR[9 * h + threadIdx.x] = model[threadIdx.x];
    if (threadIdx.x < 3) ht[3 * h + threadIdx.x] = model[9 + threadIdx.x];
    if (threadIdx.x == 0) hs[h] = model[12];
}

// First maximum of counts[0..H) (jnp.argmax), every thread gets it.
__device__ int first_argmax(const int* counts, int H, unsigned long long* sh) {
    unsigned long long best = 0;  // key = count << 32 | (2^32 - 1 - h): max = first max
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
        const unsigned long long k = ((unsigned long long)(unsigned)counts[h] << 32) |
                                     (0xffffffffu - (unsigned)h);
        best = k > best ? k : best;
    }
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_down_sync(0xffffffffu, best, o);
        best = other > best ? other : best;
    }
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if (lane == 0) sh[wid] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long b = sh[0];
        for (int w = 1; w < nw; ++w) b = sh[w] > b ? sh[w] : b;
        sh[32] = b;
    }
    __syncthreads();
    const int h = (int)(0xffffffffu - (unsigned)(sh[32] & 0xffffffffu));
    __syncthreads();
    return h;
}

__global__ void sim3_select_kernel(const float* p1, const float* p2, const bool* valid,
                                   const float* s2_1, const float* s2_2, int N, const float* hR,
                                   const float* ht, const float* hs, const int* counts, int H,
                                   int min_inliers, Cam c1, Cam c2, float* R, float* t, float* s,
                                   bool* inl, int* n_in, bool* ok) {
    __shared__ unsigned long long sh[33];
    const int b = first_argmax(counts, H, sh);
    const float* Rb = hR + 9 * b;
    const float* tb = ht + 3 * b;
    const float sb = hs[b];
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        inl[n] = sim3_inlier(Rb, tb, sb, p1, p2, valid, s2_1, s2_2, n, c1, c2);
    if (threadIdx.x < 9) R[threadIdx.x] = Rb[threadIdx.x];
    if (threadIdx.x < 3) t[threadIdx.x] = tb[threadIdx.x];
    if (threadIdx.x == 0) {
        *s = sb;
        *n_in = counts[b];
        *ok = counts[b] >= min_inliers;
    }
}

// smallmat.chol_unrolled / chol_solve_factored for an n x n system (n <= 12).
template <class Real>
__device__ void chol_n(const Real* A, Real* L, int n) {
    for (int i = 0; i < n; ++i)
        for (int j = 0; j <= i; ++j) {
            Real s = A[n * i + j];
            for (int k = 0; k < j; ++k) s -= L[n * i + k] * L[n * j + k];
            L[n * i + j] = (i == j) ? sqrt(fmax(s, (Real)1e-12)) : s / L[n * j + j];
        }
}

template <class Real>
__device__ void chol_solve_n(const Real* L, const Real* b, Real* x, int n) {
    Real y[12];
    for (int i = 0; i < n; ++i) {
        Real s = b[i];
        for (int k = 0; k < i; ++k) s -= L[n * i + k] * y[k];
        y[i] = s / L[n * i + i];
    }
    for (int i = n - 1; i >= 0; --i) {
        Real s = y[i];
        for (int k = i + 1; k < n; ++k) s -= L[n * k + i] * x[k];
        x[i] = s / L[n * i + i];
    }
}

// camera.solve3x3 (Cramer) of G x = b.
template <class Real>
__device__ void solve3x3(const Real* g, const Real* b, Real* x) {
    const Real c00 = g[4] * g[8] - g[5] * g[7];
    const Real c01 = g[5] * g[6] - g[3] * g[8];
    const Real c02 = g[3] * g[7] - g[4] * g[6];
    const Real det = g[0] * c00 + g[1] * c01 + g[2] * c02;
    const Real inv_det = (Real)1 / (fabs(det) < (Real)1e-20 ? (Real)1e-20 : det);
    const Real c10 = g[2] * g[7] - g[1] * g[8];
    const Real c11 = g[0] * g[8] - g[2] * g[6];
    const Real c12 = g[1] * g[6] - g[0] * g[7];
    const Real c20 = g[1] * g[5] - g[2] * g[4];
    const Real c21 = g[2] * g[3] - g[0] * g[5];
    const Real c22 = g[0] * g[4] - g[1] * g[3];
    x[0] = (c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det;
    x[1] = (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det;
    x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det;
}

// pnp._dlt_pose on K = 6 correspondences: (R, t), computed in double as
// the plain version computes it (a near-degenerate 12x12 normal matrix
// carries f32 rounding into the pose).
__device__ void dlt6(const float (*Xf)[3], const float (*uvf)[2], float* Rf, float* tf) {
    typedef double Real;
    constexpr int K = 6;
    Real X[K][3], uv[K][2];
    for (int k = 0; k < K; ++k) {
        for (int i = 0; i < 3; ++i) X[k][i] = Xf[k][i];
        uv[k][0] = uvf[k][0];
        uv[k][1] = uvf[k][1];
    }
    Real c[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < K; ++k) c[i] += X[k][i];
        c[i] = c[i] / (Real)K;
    }
    Real Xn[K][3], ss = 0;
    for (int k = 0; k < K; ++k) {
        Real r = 0;
        for (int i = 0; i < 3; ++i) {
            Xn[k][i] = X[k][i] - c[i];
            r += Xn[k][i] * Xn[k][i];
        }
        ss += r;
    }
    const Real sigma = fmax(sqrt(ss / (Real)K / (Real)3), (Real)1e-6);
    for (int k = 0; k < K; ++k)
        for (int i = 0; i < 3; ++i) Xn[k][i] = Xn[k][i] / sigma;
    Real AtA[144];
    for (int q = 0; q < 144; ++q) AtA[q] = 0;
    for (int r = 0; r < 2 * K; ++r) {
        const int k = r % K;
        const Real Xh[4] = {Xn[k][0], Xn[k][1], Xn[k][2], 1};
        const Real m = r < K ? uv[k][0] : uv[k][1];
        Real row[12];
        for (int q = 0; q < 4; ++q) {
            row[q] = r < K ? Xh[q] : 0;
            row[4 + q] = r < K ? 0 : Xh[q];
            row[8 + q] = -m * Xh[q];
        }
        for (int i = 0; i < 12; ++i)
            for (int j = 0; j < 12; ++j) AtA[12 * i + j] += row[i] * row[j];
    }
    Real tr = 0;
    for (int i = 0; i < 12; ++i) tr += AtA[13 * i];
    const Real eps = (Real)1e-7 * tr + (Real)1e-12;
    for (int i = 0; i < 12; ++i) AtA[13 * i] += eps;
    Real L[144], p[12], pn[12];
    chol_n(AtA, L, 12);
    for (int i = 0; i < 12; ++i) p[i] = (Real)1 / sqrt((Real)12);
    for (int it = 0; it < 8; ++it) {
        chol_solve_n(L, p, pn, 12);
        Real nr = 0;
        for (int i = 0; i < 12; ++i) nr += pn[i] * pn[i];
        nr = fmax(sqrt(nr), (Real)1e-20);
        for (int i = 0; i < 12; ++i) p[i] = pn[i] / nr;
    }
    // P = Pn @ [[I / sigma, -c / sigma], [0, 0, 0, 1]].
    Real P[12];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) P[4 * i + j] = p[4 * i + j] / sigma;
        P[4 * i + 3] = p[4 * i] * (-c[0] / sigma) + p[4 * i + 1] * (-c[1] / sigma) +
                       p[4 * i + 2] * (-c[2] / sigma) + p[4 * i + 3];
    }
    const Real detM = P[0] * (P[5] * P[10] - P[6] * P[9]) - P[1] * (P[4] * P[10] - P[6] * P[8]) +
                      P[2] * (P[4] * P[9] - P[5] * P[8]);
    const Real sign = detM < 0 ? -1 : 1;
    const Real scale = cbrt(fmax(fabs(detM), (Real)1e-20));
    Real M[9], t[3];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) M[3 * i + j] = (P[4 * i + j] * sign) / scale;
        t[i] = (P[4 * i + 3] * sign) / scale;
    }
    for (int it = 0; it < 8; ++it) {
        Real inv[9], col[3];
        for (int cidx = 0; cidx < 3; ++cidx) {
            const Real e[3] = {(Real)(cidx == 0), (Real)(cidx == 1), (Real)(cidx == 2)};
            solve3x3(M, e, col);
            for (int i = 0; i < 3; ++i) inv[3 * i + cidx] = col[i];
        }
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) M[3 * i + j] = (Real)0.5 * (M[3 * i + j] + inv[3 * j + i]);
    }
    for (int q = 0; q < 9; ++q) Rf[q] = (float)M[q];
    for (int i = 0; i < 3; ++i) tf[i] = (float)t[i];
}

__device__ bool pnp_inlier(const float* R, const float* t, const float* X, const float* uv,
                           const bool* valid, const float* sigma2, int n, const Cam& c,
                           float chi2) {
    const float x = X[3 * n], y = X[3 * n + 1], z = X[3 * n + 2];
    const float px = (R[0] * x + R[1] * y + R[2] * z) + t[0];
    const float py = (R[3] * x + R[4] * y + R[5] * z) + t[1];
    const float pz = (R[6] * x + R[7] * y + R[8] * z) + t[2];
    float u, v;
    project(c, px, py, pz, u, v);
    const float du = u - uv[2 * n], dv = v - uv[2 * n + 1];
    return (du * du + dv * dv) < chi2 * sigma2[n] && pz > 0.f && valid[n];
}

__global__ void pnp_hyp_kernel(const float* X, const float* uv, const bool* valid,
                               const float* sigma2, int N, const int* idx, Cam c, float chi2,
                               float* hR, float* ht, int* counts) {
    __shared__ float model[12];
    __shared__ int sh[33];
    const int h = blockIdx.x;
    if (threadIdx.x == 0) {
        float Xk[6][3], un[6][2];
        for (int k = 0; k < 6; ++k) {
            const int n = idx[6 * h + k];
            for (int i = 0; i < 3; ++i) Xk[k][i] = X[3 * n + i];
            un[k][0] = (uv[2 * n] - c.cx) / c.fx;
            un[k][1] = (uv[2 * n + 1] - c.cy) / c.fy;
        }
        dlt6(Xk, un, model, model + 9);
    }
    __syncthreads();
    int cnt = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        cnt += pnp_inlier(model, model + 9, X, uv, valid, sigma2, n, c, chi2);
    cnt = block_reduce_sum(cnt, sh);
    if (threadIdx.x == 0) counts[h] = cnt;
    if (threadIdx.x < 9) hR[9 * h + threadIdx.x] = model[threadIdx.x];
    if (threadIdx.x < 3) ht[3 * h + threadIdx.x] = model[9 + threadIdx.x];
}

__global__ void pnp_select_kernel(const float* X, const float* uv, const bool* valid,
                                  const float* sigma2, int N, const float* hR, const float* ht,
                                  const int* counts, int H, int min_inliers, Cam c, float chi2,
                                  float* T, bool* inl, int* n_in, bool* ok) {
    __shared__ unsigned long long sh[33];
    const int b = first_argmax(counts, H, sh);
    const float* Rb = hR + 9 * b;
    const float* tb = ht + 3 * b;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        inl[n] = pnp_inlier(Rb, tb, X, uv, valid, sigma2, n, c, chi2);
    if (threadIdx.x < 16) {
        const int i = threadIdx.x / 4, j = threadIdx.x % 4;
        T[threadIdx.x] = i == 3 ? (j == 3 ? 1.f : 0.f) : (j < 3 ? Rb[3 * i + j] : tb[i]);
    }
    if (threadIdx.x == 0) {
        *n_in = counts[b];
        *ok = counts[b] >= min_inliers;
    }
}

// Projection differential A (2x3) at q, z clamped at 1e-3.
__device__ void proj_diff(const Cam& c, const float* q, float* A) {
    const float z = fmaxf(q[2], 1e-3f);
    const float iz = 1.f / z, iz2 = iz * iz;
    A[0] = c.fx * iz; A[1] = 0.f; A[2] = -c.fx * q[0] * iz2;
    A[3] = 0.f; A[4] = c.fy * iz; A[5] = -c.fy * q[1] * iz2;
}

// [I | -hat(p) | p] (3x7).
__device__ void action_cols(const float* p, float* C) {
    const float x = p[0], y = p[1], z = p[2];
    const float rows[3][7] = {{1.f, 0.f, 0.f, 0.f, z, -y, x},
                              {0.f, 1.f, 0.f, -z, 0.f, x, y},
                              {0.f, 0.f, 1.f, y, -x, 0.f, z}};
    for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 7; ++k) C[7 * i + k] = rows[i][k];
}

__device__ __forceinline__ float huber_w(float c) {
    return c > CHI2_SIM3 ? sqrtf(CHI2_SIM3 / fmaxf(c, 1e-9f)) : 1.f;
}

constexpr int NSYS = 28 + 7;  // upper triangle of H, then g

__global__ void __launch_bounds__(SEL_THREADS)
sim3_refine_kernel(const float* p1, const float* p2, const bool* valid, const float* s2_1,
                   const float* s2_2, int N, const float* R0, const float* t0, const float* s0,
                   int fix_scale, int n_rounds, Cam c1, Cam c2, float* R_out, float* t_out,
                   float* s_out, bool* inl_out, int* n_out) {
    __shared__ float model[13];
    __shared__ float sys[NSYS];
    __shared__ float shf[33];
    __shared__ int shi[33];
    if (threadIdx.x < 9) model[threadIdx.x] = R0[threadIdx.x];
    if (threadIdx.x < 3) model[9 + threadIdx.x] = t0[threadIdx.x];
    if (threadIdx.x == 0) model[12] = *s0;
    int nv = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) nv += valid[n];
    nv = block_reduce_sum(nv, shi);
    for (int round = 0; round < n_rounds; ++round) {
        const float* R = model;
        const float* t = model + 9;
        const float s = model[12];
        const float s_inv = 1.f / fmaxf(s, 1e-12f);
        float acc[NSYS];
        for (int q = 0; q < NSYS; ++q) acc[q] = 0.f;
        for (int n = threadIdx.x; n < N; n += blockDim.x) {
            const float vf = valid[n] ? 1.f : 0.f;
            const float* a1 = p1 + 3 * n;
            const float* a2 = p2 + 3 * n;
            float q[3], pp[3], u, v, uo, vo;
            for (int i = 0; i < 3; ++i) q[i] = s * (R[3 * i] * a2[0] + R[3 * i + 1] * a2[1] + R[3 * i + 2] * a2[2]) + t[i];
            const float d0 = a1[0] - t[0], d1 = a1[1] - t[1], d2 = a1[2] - t[2];
            for (int i = 0; i < 3; ++i) pp[i] = s_inv * (d0 * R[i] + d1 * R[3 + i] + d2 * R[6 + i]);
            project(c1, q[0], q[1], q[2], u, v);
            project(c1, a1[0], a1[1], a1[2], uo, vo);
            const float r1[2] = {u - uo, v - vo};
            project(c2, pp[0], pp[1], pp[2], u, v);
            project(c2, a2[0], a2[1], a2[2], uo, vo);
            const float r2[2] = {u - uo, v - vo};
            const float i1 = 1.f / fmaxf(s2_1[n], 1e-9f), i2 = 1.f / fmaxf(s2_2[n], 1e-9f);
            const float cc1 = (r1[0] * r1[0] + r1[1] * r1[1]) * i1;
            const float cc2 = (r2[0] * r2[0] + r2[1] * r2[1]) * i2;
            const float w1 = vf * (q[2] > 1e-3f ? 1.f : 0.f) * huber_w(cc1) * i1;
            const float w2 = vf * (pp[2] > 1e-3f ? 1.f : 0.f) * huber_w(cc2) * i2;
            float A[6], C[21], J1[14], J2[14], Cp[21], Jp[21];
            proj_diff(c1, q, A);
            action_cols(q, C);
            for (int i = 0; i < 2; ++i)
                for (int k = 0; k < 7; ++k)
                    J1[7 * i + k] = A[3 * i] * C[k] + A[3 * i + 1] * C[7 + k] + A[3 * i + 2] * C[14 + k];
            action_cols(a1, Cp);
            for (int i = 0; i < 3; ++i)  // -s_inv R^T [I | -hat(p1) | p1]
                for (int k = 0; k < 7; ++k)
                    Jp[7 * i + k] = -s_inv * (R[i] * Cp[k] + R[3 + i] * Cp[7 + k] + R[6 + i] * Cp[14 + k]);
            proj_diff(c2, pp, A);
            for (int i = 0; i < 2; ++i)
                for (int k = 0; k < 7; ++k)
                    J2[7 * i + k] = A[3 * i] * Jp[k] + A[3 * i + 1] * Jp[7 + k] + A[3 * i + 2] * Jp[14 + k];
            int q_ = 0;
            for (int k = 0; k < 7; ++k)
                for (int l = k; l < 7; ++l, ++q_)
                    acc[q_] += (J1[k] * w1 * J1[l] + J1[7 + k] * w1 * J1[7 + l]) +
                               (J2[k] * w2 * J2[l] + J2[7 + k] * w2 * J2[7 + l]);
            for (int k = 0; k < 7; ++k)
                acc[28 + k] += (J1[k] * w1 * r1[0] + J1[7 + k] * w1 * r1[1]) +
                               (J2[k] * w2 * r2[0] + J2[7 + k] * w2 * r2[1]);
        }
        for (int q = 0; q < NSYS; ++q) {
            const float tot = block_reduce_sum(acc[q], shf);
            if (threadIdx.x == 0) sys[q] = tot;
        }
        if (threadIdx.x == 0) {
            float H[49], g[7], L[49], dx[7];
            int q_ = 0;
            for (int k = 0; k < 7; ++k)
                for (int l = k; l < 7; ++l, ++q_) H[7 * k + l] = H[7 * l + k] = sys[q_];
            for (int k = 0; k < 7; ++k) g[k] = sys[28 + k];
            if (fix_scale) {
                for (int k = 0; k < 7; ++k) H[7 * k + 6] = H[42 + k] = 0.f;
                g[6] = 0.f;
            }
            float dg[7];
            for (int k = 0; k < 7; ++k) dg[k] = H[8 * k];
            for (int k = 0; k < 7; ++k) H[8 * k] += 1e-4f * dg[k] + 1e-8f;
            chol_n(H, L, 7);
            chol_solve_n(L, g, dx, 7);
            bool fin = true;
            for (int k = 0; k < 7; ++k) {
                dx[k] = -dx[k];
                fin &= isfinite(dx[k]);
            }
            if (fin && nv >= 3) {
                float ER[9], Et[3], Es, Rn[9], tn[3], sn;
                sim3_exp(dx, ER, Et, Es);
                sim3_compose(ER, Et, Es, model, model + 9, model[12], Rn, tn, sn);
                for (int i = 0; i < 9; ++i) model[i] = Rn[i];
                for (int i = 0; i < 3; ++i) model[9 + i] = tn[i];
                model[12] = sn;
            }
        }
        __syncthreads();
    }
    int c_new = 0, c_old = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        c_new += sim3_inlier(model, model + 9, model[12], p1, p2, valid, s2_1, s2_2, n, c1, c2);
        c_old += sim3_inlier(R0, t0, *s0, p1, p2, valid, s2_1, s2_2, n, c1, c2);
    }
    c_new = block_reduce_sum(c_new, shi);
    c_old = block_reduce_sum(c_old, shi);
    const bool better = c_new >= c_old;
    const float* R = better ? model : R0;
    const float* t = better ? model + 9 : t0;
    const float s = better ? model[12] : *s0;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        inl_out[n] = sim3_inlier(R, t, s, p1, p2, valid, s2_1, s2_2, n, c1, c2);
    if (threadIdx.x < 9) R_out[threadIdx.x] = R[threadIdx.x];
    if (threadIdx.x < 3) t_out[threadIdx.x] = t[threadIdx.x];
    if (threadIdx.x == 0) {
        *s_out = s;
        *n_out = better ? c_new : c_old;
    }
}

}  // namespace

C_ENTRY int sim3_hypotheses(const float* p1, const float* p2, const bool* valid,
                            const float* s2_1, const float* s2_2, int N, const int* idx, int H,
                            int fix_scale, float fx1, float fy1, float cx1, float cy1, float fx2,
                            float fy2, float cx2, float cy2, float* hR, float* ht, float* hs,
                            int* counts, cudaStream_t stream) {
    sim3_hyp_kernel<<<H, HYP_THREADS, 0, stream>>>(p1, p2, valid, s2_1, s2_2, N, idx, fix_scale,
                                                   Cam{fx1, fy1, cx1, cy1},
                                                   Cam{fx2, fy2, cx2, cy2}, hR, ht, hs, counts);
    return (int)cudaGetLastError();
}

C_ENTRY int sim3_select(const float* p1, const float* p2, const bool* valid, const float* s2_1,
                        const float* s2_2, int N, const float* hR, const float* ht,
                        const float* hs, const int* counts, int H, int min_inliers, float fx1,
                        float fy1, float cx1, float cy1, float fx2, float fy2, float cx2,
                        float cy2, float* R, float* t, float* s, bool* inl, int* n_in, bool* ok,
                        cudaStream_t stream) {
    sim3_select_kernel<<<1, SEL_THREADS, 0, stream>>>(
        p1, p2, valid, s2_1, s2_2, N, hR, ht, hs, counts, H, min_inliers, Cam{fx1, fy1, cx1, cy1},
        Cam{fx2, fy2, cx2, cy2}, R, t, s, inl, n_in, ok);
    return (int)cudaGetLastError();
}

C_ENTRY int sim3_refine(const float* p1, const float* p2, const bool* valid, const float* s2_1,
                        const float* s2_2, int N, const float* R0, const float* t0,
                        const float* s0, int fix_scale, int n_rounds, float fx1, float fy1,
                        float cx1, float cy1, float fx2, float fy2, float cx2, float cy2,
                        float* R, float* t, float* s, bool* inl, int* n_in, cudaStream_t stream) {
    sim3_refine_kernel<<<1, SEL_THREADS, 0, stream>>>(
        p1, p2, valid, s2_1, s2_2, N, R0, t0, s0, fix_scale, n_rounds, Cam{fx1, fy1, cx1, cy1},
        Cam{fx2, fy2, cx2, cy2}, R, t, s, inl, n_in);
    return (int)cudaGetLastError();
}

C_ENTRY int pnp_hypotheses(const float* X, const float* uv, const bool* valid,
                           const float* sigma2, int N, const int* idx, int H, float fx, float fy,
                           float cx, float cy, float chi2, float* hR, float* ht, int* counts,
                           cudaStream_t stream) {
    pnp_hyp_kernel<<<H, HYP_THREADS, 0, stream>>>(X, uv, valid, sigma2, N, idx,
                                                  Cam{fx, fy, cx, cy}, chi2, hR, ht, counts);
    return (int)cudaGetLastError();
}

C_ENTRY int pnp_select(const float* X, const float* uv, const bool* valid, const float* sigma2,
                       int N, const float* hR, const float* ht, const int* counts, int H,
                       int min_inliers, float fx, float fy, float cx, float cy, float chi2,
                       float* T, bool* inl, int* n_in, bool* ok, cudaStream_t stream) {
    pnp_select_kernel<<<1, SEL_THREADS, 0, stream>>>(X, uv, valid, sigma2, N, hR, ht, counts, H,
                                                     min_inliers, Cam{fx, fy, cx, cy}, chi2, T,
                                                     inl, n_in, ok);
    return (int)cudaGetLastError();
}
