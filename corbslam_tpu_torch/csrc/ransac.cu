// K10 `ransac`: Sim3 RANSAC (Horn on three correspondences, inliers in both
// cameras) with its iterative refinement, and PnP RANSAC (DLT on six).
//
// Replaces corbslam_tpu/solvers/sim3_solver.py horn_sim3 (vmapped over the
// hypotheses), solve_sim3_ransac and refine_sim3_iterative, with their
// combine in corbslam_tpu/loop/loop_closing.py compute_sim3, and
// corbslam_tpu/solvers/pnp.py _dlt_pose (vmapped) and solve_pnp_ransac: the
// reference materializes [H, N, 3] transformed points and [H, N] errors.
//
// Bound on the H100: operations. H = 256 hypotheses x N <= 2048 matches x
// ~60 flops of the two-camera test is ~30 MFLOP with ~60 KB of inputs;
// each hypothesis's model (100 power iterations of a 4x4, or a 12x12
// Cholesky, 8 inverse iterations and 8 polar steps) is a few thousand
// dependent flops on one thread, and each refinement round ~1 KFLOP a
// match and a 7x7 solve.
// Design, Sim3: one launch an attempt (`sim3_attempt`) of 512-thread CTAs
// (up to 128 registers a thread: no spill). Each CTA takes 2 hypotheses:
// 4 lanes solve each model with the reference's arithmetic (horn3: the
// Gershgorin-shifted power iteration, a lane dividing each element) while
// the other warps project every observed point once into shared memory;
// then every thread tests its strided matches against both models, and the
// counts are exact integer sums. A CTA publishes its models and an
// atomicMax of the 64-bit key count << 32 | ~h (the first maximum, as
// jnp.argmax); the last CTA by an atomic ticket (a per-stream workspace it
// sets back to 0) takes the winner: its inlier mask, then the refinement
// rounds with the 7x7 normal equations of the Huber reprojection error in
// both cameras summed in the fixed order of the earlier 1024-thread
// kernel (each "thread" a column of matches c, c + 1024, ... summed in
// registers, its warp's 32 columns reduced by shfl_xor halving in the
// pairs of a shfl_down tree, then the tree of the 32 warp sums), thread 0's
// Cholesky solve in registers and retraction (sim3.cuh), the final
// classification that keeps the refined model only if it has at least the
// start's inliers, and compute_sim3's combine. The mode picks the RANSAC,
// the refinement from a given model, or both. PnP: `*_hypotheses` runs
// one 256-thread CTA per hypothesis: thread 0 solves the model into shared
// memory (Hartley normalization, regularized Cholesky inverse iteration,
// det sign and cube-root scale, Cramer polar steps, in double as its plain
// version), then every thread tests its strided matches and a block
// reduction counts the inliers; `pnp_select` is one CTA: the first maximum
// of the counts, then the winner's inlier mask by the same test. The
// sample (which matches form each hypothesis) is an input, drawn by the
// caller.

#include "common.cuh"
#define SIM3_SINCOSPI  // sincospif: no stack frame (sim3.cuh)
#include "sim3.cuh"

namespace {

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

// R_from_quat of v (w, x, y, z), normalized first.
__device__ void r_from_quat(const float* q0, float* R) {
    const float nrm = fmaxf(sqrtf(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2] + q0[3] * q0[3]),
                            SIM3_EPS);
    const float w = q0[0] / nrm, x = q0[1] / nrm, y = q0[2] / nrm, z = q0[3] / nrm;
    R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
    R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
    R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// horn_sim3 on K = 3 correspondences with unit weights, on a group of 4
// lanes (`mask`, the group's first lane `base`): every lane computes all of
// it but the power iteration's divisions, lane base + i dividing element i
// and the 4 quotients going round by shuffles (the same operations as one
// thread doing all four). Every lane gets the model.
__device__ void horn3(const float (*P1)[3], const float (*P2)[3], bool fix_scale, unsigned mask,
                      int base, int i4, float* R, float* t, float& s) {
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
        const float mine = (i4 == 0 ? u[0] : i4 == 1 ? u[1] : i4 == 2 ? u[2] : u[3]) / nrm;
        for (int i = 0; i < 4; ++i) v[i] = __shfl_sync(mask, mine, base + i);
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

// The Sim3 attempt, one launch: bits of `mode`.
constexpr int SIM3_RANSAC = 1, SIM3_REFINE = 2;
constexpr int SIM3_THREADS = 512;  // <= 128 registers a thread
constexpr int SIM3_HPC = 2;        // hypotheses a CTA
constexpr int MODEL = 13;          // R (9), t (3), s; s_* copies add 1 / max(s, 1e-12)
constexpr int COLS = 1024;         // the sums' columns: match n adds into column n % 1024
constexpr int SIM3_MAX_N = 4096;   // obs in shared memory (128 KB); a thread's flags in a byte
constexpr int OBS = 8;             // per-match constants: uo1, vo1, uo2, vo2, gate1, gate2, i1, i2
constexpr unsigned FULL = 0xffffffffu;

struct Sim3Args {
    const float* p1;
    const float* p2;
    const bool* valid;
    const float* s2_1;
    const float* s2_2;
    int N;
    const int* idx;  // [H, 3] the draw
    int H;
    const float* R0;  // the refinement's start without SIM3_RANSAC
    const float* t0;
    const float* s0;
    int mode, fix_scale, n_rounds, min_inliers;
    Cam c1, c2;
    unsigned long long* work;  // [best key, CTA ticket]: 0 on entry and on exit
    float* models;             // [H, 13] the hypotheses' models
    float* out_f;              // [3, 13] the RANSAC, refined and combined models
    int* out_i;                // [3] their inlier counts
    bool* ok;                  // RANSAC count >= min_inliers
    bool* inl_ransac;          // [N]
    bool* inl_ref;             // [N]
};

// Sim3Solver::CheckInliers for match n under model M (R, t, s, 1 / max(s,
// 1e-12)): both reprojection errors under 9.21 sigma^2, in front of both
// cameras. The observed points' projections and the gates come from `obs`
// ([OBS][N]: the same values the test computed for itself before).
__device__ bool sim3_inlier(const float* M, const Sim3Args& a, const float* obs, int n) {
    const float* R = M;
    const float* t = M + 9;
    const float s = M[12], s_inv = M[13];
    const int N = a.N;
    const float x1 = a.p1[3 * n], y1 = a.p1[3 * n + 1], z1 = a.p1[3 * n + 2];
    const float x2 = a.p2[3 * n], y2 = a.p2[3 * n + 1], z2 = a.p2[3 * n + 2];
    float p[3], b[3];
    for (int i = 0; i < 3; ++i) p[i] = s * (R[3 * i] * x2 + R[3 * i + 1] * y2 + R[3 * i + 2] * z2) + t[i];
    const float d0 = x1 - t[0], d1 = y1 - t[1], d2 = z1 - t[2];
    for (int i = 0; i < 3; ++i) b[i] = s_inv * (d0 * R[i] + d1 * R[3 + i] + d2 * R[6 + i]);
    float u, v;
    project(a.c1, p[0], p[1], p[2], u, v);
    const float uo = obs[n], vo = obs[N + n];
    const float e1 = (u - uo) * (u - uo) + (v - vo) * (v - vo);
    project(a.c2, b[0], b[1], b[2], u, v);
    const float uo2 = obs[2 * N + n], vo2 = obs[3 * N + n];
    const float e2 = (u - uo2) * (u - uo2) + (v - vo2) * (v - vo2);
    return e1 < obs[4 * N + n] && e2 < obs[5 * N + n] && a.valid[n] && p[2] > 0.f && b[2] > 0.f;
}

// obs[.][n] of match n.
__device__ __forceinline__ void observe(const Sim3Args& a, float* obs, int n) {
    const int N = a.N;
    const float* a1 = a.p1 + 3 * n;
    const float* a2 = a.p2 + 3 * n;
    project(a.c1, a1[0], a1[1], a1[2], obs[n], obs[N + n]);
    project(a.c2, a2[0], a2[1], a2[2], obs[2 * N + n], obs[3 * N + n]);
    obs[4 * N + n] = CHI2_SIM3 * a.s2_1[n];
    obs[5 * N + n] = CHI2_SIM3 * a.s2_2[n];
    obs[6 * N + n] = 1.f / fmaxf(a.s2_1[n], 1e-9f);
    obs[7 * N + n] = 1.f / fmaxf(a.s2_2[n], 1e-9f);
}

// Exact block sum of one int a thread (any order gives the same total).
__device__ int block_count(int v, int* sh) {
    if (threadIdx.x == 0) *sh = 0;
    __syncthreads();
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(sh, v);
    __syncthreads();
    const int r = *sh;
    __syncthreads();
    return r;
}

// One halving step of a warp reduction of NV values a lane: lanes with
// `bit` set keep the upper half and hand the lower half across, the
// others the reverse; v[0 .. NV / 2) then holds this lane's half. After
// the steps for bits 16, 8, 4, 2, 1 lane l holds value l's warp sum, each
// value having been added in the pairs of a shfl_down tree (the same sums,
// added in either order).
template <int NV>
__device__ __forceinline__ void halve(float (&v)[32], int lane, int bit) {
    const bool hi = (lane & bit) != 0;
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) {
        const float keep = hi ? v[j + NV / 2] : v[j];
        const float send = hi ? v[j] : v[j + NV / 2];
        v[j] = keep + __shfl_xor_sync(FULL, send, bit);
    }
}

// block_reduce_sum's warp tree written out over x[0..31]: lane i adding
// lane i + o for o = 16, 8, 4, 2, 1, lane 0's result.
__device__ __forceinline__ float tree32(const float* x) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = x[i] + x[i + 16];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] + v[i + 8];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = v[i] + v[i + 4];
    v[0] = v[0] + v[2];
    v[1] = v[1] + v[3];
    return v[0] + v[1];
}

// chol_n and chol_solve_n of the damped 7x7 system H dx = g, unrolled in
// registers (the same operations in the same order).
__device__ __forceinline__ void solve7(const float (&H)[49], const float (&g)[7], float (&x)[7]) {
    float L[49];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = H[7 * i + j];
#pragma unroll
            for (int k = 0; k < j; ++k) s -= L[7 * i + k] * L[7 * j + k];
            L[7 * i + j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[7 * j + j];
        }
#pragma unroll
    for (int i = 0; i < 7; ++i) {  // forward: y kept in x
        float s = g[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[7 * i + k] * x[k];
        x[i] = s / L[7 * i + i];
    }
#pragma unroll
    for (int i = 6; i >= 0; --i) {
        float s = x[i];
#pragma unroll
        for (int k = i + 1; k < 7; ++k) s -= L[7 * k + i] * x[k];
        x[i] = s / L[7 * i + i];
    }
}

// Adds match n's terms of the refinement's normal equations under model M
// (the upper triangle of H, then g) into acc.
__device__ __forceinline__ void add_match(const Sim3Args& a, const float* M, const float* obs,
                                          int n, float (&acc)[NSYS]) {
    const float* R = M;
    const float* t = M + 9;
    const float s = M[12], s_inv = M[13];
    const int N = a.N;
    const float vf = a.valid[n] ? 1.f : 0.f;
    const float* a1 = a.p1 + 3 * n;
    const float* a2 = a.p2 + 3 * n;
    float q[3], pp[3], u, v;
    for (int i = 0; i < 3; ++i) q[i] = s * (R[3 * i] * a2[0] + R[3 * i + 1] * a2[1] + R[3 * i + 2] * a2[2]) + t[i];
    const float d0 = a1[0] - t[0], d1 = a1[1] - t[1], d2 = a1[2] - t[2];
    for (int i = 0; i < 3; ++i) pp[i] = s_inv * (d0 * R[i] + d1 * R[3 + i] + d2 * R[6 + i]);
    project(a.c1, q[0], q[1], q[2], u, v);
    const float r1[2] = {u - obs[n], v - obs[N + n]};
    project(a.c2, pp[0], pp[1], pp[2], u, v);
    const float r2[2] = {u - obs[2 * N + n], v - obs[3 * N + n]};
    const float i1 = obs[6 * N + n], i2 = obs[7 * N + n];
    const float cc1 = (r1[0] * r1[0] + r1[1] * r1[1]) * i1;
    const float cc2 = (r2[0] * r2[0] + r2[1] * r2[1]) * i2;
    const float w1 = vf * (q[2] > 1e-3f ? 1.f : 0.f) * huber_w(cc1) * i1;
    const float w2 = vf * (pp[2] > 1e-3f ? 1.f : 0.f) * huber_w(cc2) * i2;
    float A[6], C[21], J1[14], J2[14], Cp[21], Jp[21];
    proj_diff(a.c1, q, A);
    action_cols(q, C);
    for (int i = 0; i < 2; ++i)
        for (int k = 0; k < 7; ++k)
            J1[7 * i + k] = A[3 * i] * C[k] + A[3 * i + 1] * C[7 + k] + A[3 * i + 2] * C[14 + k];
    action_cols(a1, Cp);
    for (int i = 0; i < 3; ++i)  // -s_inv R^T [I | -hat(p1) | p1]
        for (int k = 0; k < 7; ++k)
            Jp[7 * i + k] = -s_inv * (R[i] * Cp[k] + R[3 + i] * Cp[7 + k] + R[6 + i] * Cp[14 + k]);
    proj_diff(a.c2, pp, A);
    for (int i = 0; i < 2; ++i)
        for (int k = 0; k < 7; ++k)
            J2[7 * i + k] = A[3 * i] * Jp[k] + A[3 * i + 1] * Jp[7 + k] + A[3 * i + 2] * Jp[14 + k];
    int q_ = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k)
#pragma unroll
        for (int l = k; l < 7; ++l, ++q_)
            acc[q_] += (J1[k] * w1 * J1[l] + J1[7 + k] * w1 * J1[7 + l]) +
                       (J2[k] * w2 * J2[l] + J2[7 + k] * w2 * J2[7 + l]);
#pragma unroll
    for (int k = 0; k < 7; ++k)
        acc[28 + k] += (J1[k] * w1 * r1[0] + J1[7 + k] * w1 * r1[1]) +
                       (J2[k] * w2 * r2[0] + J2[7 + k] * w2 * r2[1]);
}

__device__ __forceinline__ void set_model(float* dst, const float* R, const float* t, float s) {
#pragma unroll
    for (int i = 0; i < 9; ++i) dst[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) dst[9 + i] = t[i];
    dst[12] = s;
    dst[13] = 1.f / fmaxf(s, 1e-12f);
}

__global__ void __launch_bounds__(SIM3_THREADS, 1) sim3_attempt_kernel(Sim3Args a) {
    extern __shared__ float obs[];  // [OBS][N]
    __shared__ float s_hyp[SIM3_HPC][MODEL + 1];
    __shared__ float s_start[MODEL + 1], s_cur[MODEL + 1];
    __shared__ float s_part[NSYS][33];  // the 32 warp sums of each entry
    __shared__ float s_sys[NSYS];
    __shared__ int s_cnt[SIM3_HPC], s_red, s_best_h, s_best_n;
    __shared__ bool s_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = a.N;
    const bool ransac = (a.mode & SIM3_RANSAC) != 0;

    if (ransac) {
        // Hypotheses 2b, 2b + 1 of CTA b: lanes 0-3 and 4-7 solve one model
        // each (horn3) while the other warps fill obs; then every thread
        // tests its strided matches against both.
        const int h0 = blockIdx.x * SIM3_HPC;
        const int nh = min(SIM3_HPC, a.H - h0);
        if (tid < SIM3_HPC) s_cnt[tid] = 0;
        if (tid < 4 * nh) {
            const int hh = tid >> 2;
            float P1[3][3], P2[3][3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int n = a.idx[3 * (h0 + hh) + k];
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    P1[k][i] = a.p1[3 * n + i];
                    P2[k][i] = a.p2[3 * n + i];
                }
            }
            float R[9], t[3], s;
            horn3(P1, P2, a.fix_scale != 0, (1u << (4 * nh)) - 1u, tid & ~3, tid & 3, R, t, s);
            if ((tid & 3) == 0) set_model(s_hyp[hh], R, t, s);
        }
        if (tid >= 32)
            for (int n = tid - 32; n < N; n += SIM3_THREADS - 32) observe(a, obs, n);
        __syncthreads();
        int cnt[SIM3_HPC] = {};
        for (int n = tid; n < N; n += SIM3_THREADS)
#pragma unroll
            for (int i = 0; i < SIM3_HPC; ++i)
                if (i < nh) cnt[i] += sim3_inlier(s_hyp[i], a, obs, n);
#pragma unroll
        for (int i = 0; i < SIM3_HPC; ++i) {
            const int c = __reduce_add_sync(FULL, cnt[i]);
            if (lane == 0 && c) atomicAdd(&s_cnt[i], c);
        }
        __syncthreads();
        // The first maximum by a 64-bit key (count << 32 | ~h); the last CTA
        // by an atomic ticket takes the winner.
        if (tid < nh) {
            const int h = h0 + tid;
#pragma unroll
            for (int q = 0; q < MODEL; ++q) a.models[MODEL * h + q] = s_hyp[tid][q];
            atomicMax(&a.work[0], ((unsigned long long)(unsigned)s_cnt[tid] << 32) |
                                      (0xffffffffu - (unsigned)h));
            __threadfence();
        }
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(&a.work[1], 1ull) == gridDim.x - 1;
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        if (tid == 0) {
            const unsigned long long best = atomicExch(&a.work[0], 0ull);
            atomicExch(&a.work[1], 0ull);
            s_best_h = (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
            s_best_n = (int)(best >> 32);
        }
        __syncthreads();
        if (tid < MODEL) s_start[tid] = __ldcg(a.models + MODEL * s_best_h + tid);
        __syncthreads();
        if (tid == 0) s_start[13] = 1.f / fmaxf(s_start[12], 1e-12f);
    } else {
        if (tid == 0) set_model(s_start, a.R0, a.t0, *a.s0);
        for (int n = tid; n < N; n += SIM3_THREADS) observe(a, obs, n);
    }
    __syncthreads();
    // The start's inliers (the RANSAC's mask), kept as bits (match
    // tid + 512 j in bit j), their count and the valid count.
    unsigned old_bits = 0;
    int c_old = 0, nv = 0;
    for (int n = tid, j = 0; n < N; n += SIM3_THREADS, ++j) {
        const bool b = sim3_inlier(s_start, a, obs, n);
        if (ransac) a.inl_ransac[n] = b;
        old_bits |= (unsigned)b << j;
        c_old += b;
        nv += a.valid[n];
    }
    if (ransac && tid < MODEL) a.out_f[tid] = s_start[tid];
    if (ransac && tid == 0) {
        a.out_i[0] = s_best_n;
        *a.ok = s_best_n >= a.min_inliers;
    }
    if (!(a.mode & SIM3_REFINE)) return;
    const int packed = block_count(c_old + (nv << 16), &s_red);  // each <= 4096
    c_old = packed & 0xffff;
    nv = packed >> 16;

    // Refinement from s_start: damped Gauss-Newton rounds on the Huber error
    // in both cameras, summed in the order of the earlier 1024-thread
    // kernel: "thread" (column) c adds matches c, c + 1024, ... in registers
    // (this CTA's thread t takes columns t and t + 512), the warp of 32
    // columns reduces them (halve: shfl_down-tree pairs), and the 32 warp
    // sums go through one more tree; thread 0 solves and retracts.
    if (tid < MODEL + 1) s_cur[tid] = s_start[tid];
    __syncthreads();
    for (int round = 0; round < a.n_rounds; ++round) {
#pragma unroll 1
        for (int g = 0; g < COLS / SIM3_THREADS; ++g) {
            float acc[NSYS];
#pragma unroll
            for (int q = 0; q < NSYS; ++q) acc[q] = 0.f;
            for (int n = SIM3_THREADS * g + tid; n < N; n += COLS) add_match(a, s_cur, obs, n, acc);
            float v[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) v[q] = acc[q];
            halve<32>(v, lane, 16);
            halve<16>(v, lane, 8);
            halve<8>(v, lane, 4);
            halve<4>(v, lane, 2);
            halve<2>(v, lane, 1);
            const int pw = (SIM3_THREADS / 32) * g + warp;  // the earlier kernel's warp
            s_part[lane][pw] = v[0];
#pragma unroll
            for (int q = 32; q < NSYS; ++q) {
                float x = acc[q];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
                if (lane == 0) s_part[q][pw] = x;
            }
        }
        __syncthreads();
        if (tid < NSYS) s_sys[tid] = tree32(s_part[tid]);
        __syncthreads();
        if (tid == 0) {
            float H[49], g[7], dx[7];
            int q_ = 0;
#pragma unroll
            for (int k = 0; k < 7; ++k)
#pragma unroll
                for (int l = k; l < 7; ++l, ++q_) H[7 * k + l] = H[7 * l + k] = s_sys[q_];
#pragma unroll
            for (int k = 0; k < 7; ++k) g[k] = s_sys[28 + k];
            if (a.fix_scale) {
#pragma unroll
                for (int k = 0; k < 7; ++k) H[7 * k + 6] = H[42 + k] = 0.f;
                g[6] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < 7; ++k) H[8 * k] += 1e-4f * H[8 * k] + 1e-8f;
            solve7(H, g, dx);
            bool fin = true;
#pragma unroll
            for (int k = 0; k < 7; ++k) {
                dx[k] = -dx[k];
                fin &= isfinite(dx[k]);
            }
            if (fin && nv >= 3) {
                float ER[9], Et[3], Es, Rn[9], tn[3], sn;
                sim3_exp(dx, ER, Et, Es);
                sim3_compose(ER, Et, Es, s_cur, s_cur + 9, s_cur[12], Rn, tn, sn);
                set_model(s_cur, Rn, tn, sn);
            }
        }
        __syncthreads();
    }
    // The refined model only if it classifies at least the start's inliers.
    unsigned new_bits = 0;
    int c_new = 0;
    for (int n = tid, j = 0; n < N; n += SIM3_THREADS, ++j) {
        const bool b = sim3_inlier(s_cur, a, obs, n);
        new_bits |= (unsigned)b << j;
        c_new += b;
    }
    c_new = block_count(c_new, &s_red);
    const bool better = c_new >= c_old;
    const float* M = better ? s_cur : s_start;
    const int n_ref = better ? c_new : c_old;
    const unsigned bits = better ? new_bits : old_bits;
    for (int n = tid, j = 0; n < N; n += SIM3_THREADS, ++j) a.inl_ref[n] = (bits >> j) & 1u;
    if (tid < MODEL) a.out_f[MODEL + tid] = M[tid];
    if (tid == 0) a.out_i[1] = n_ref;
    if (ransac) {  // compute_sim3's combine
        const bool use = s_best_n >= 3 && n_ref >= 3;
        if (tid < MODEL) a.out_f[2 * MODEL + tid] = use ? M[tid] : s_start[tid];
        if (tid == 0) a.out_i[2] = use ? max(n_ref, s_best_n) : s_best_n;
    }
}

// --- PnP RANSAC, one launch ---------------------------------------------

constexpr int PNP_THREADS = 256;
constexpr int PNP_HPC = 2;                               // hypotheses a CTA, a warp each
constexpr int PNP_STAGERS = PNP_THREADS - 32 * PNP_HPC;  // the other warps stage the matches
constexpr int PNP_MAX_N = 8192;                          // 6 staged floats a match: 192 KB
constexpr int STAMPS = 8;                                // workspace words 8..23 (KERNEL_STAMPS)

struct PnpArgs {
    const float* X;
    const float* uv;
    const bool* valid;
    const float* sigma2;
    int N;
    const int* idx;  // [H, 6] the draw
    int H;
    int min_inliers;
    Cam c;
    float chi2;
    unsigned long long* work;  // [best key, CTA ticket]: 0 on entry and on exit
    float* models;             // [H, 12] each hypothesis's R (row-major) and t
    float* T;
    bool* inl;
    int* n_in;
    bool* ok;
};

// Solves the upper-triangular L^T x = y after L y = b (smallmat's
// chol_solve_factored), L row-major in shared memory: the same operations
// in the same order as one thread.
__device__ __forceinline__ void chol_solve12(const double* L, const double (&b)[12],
                                             double (&x)[12]) {
    double y[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
        double s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[12 * i + k] * y[k];
        y[i] = s / L[13 * i];
    }
#pragma unroll
    for (int i = 11; i >= 0; --i) {
        double s = y[i];
#pragma unroll
        for (int k = i + 1; k < 12; ++k) s -= L[12 * k + i] * x[k];
        x[i] = s / L[13 * i];
    }
}

// pnp._dlt_pose on the K = 6 matches of `smp` (X, normalized uv: f32) in
// double on one warp: every lane runs the Hartley normalization, the
// inverse iterations and the polar steps (the same operations in the same
// order as one thread), lane i < 12 sums row i of the normal matrix and
// computes row i of its Cholesky factor, column by column (kept in `L`,
// 12 x 12 in shared memory; `xn` holds the normalized matches). Every lane
// returns the model.
__device__ void dlt6_warp(const float (*smp)[5], double (*xn)[5], double* L, int lane,
                          float* Rf, float* tf) {
    typedef double Real;
    constexpr int K = 6;
    Real c[3] = {0, 0, 0};
    Real sigma;
    {
        Real X[K][3];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < 3; ++i) X[k][i] = smp[k][i];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int k = 0; k < K; ++k) c[i] += X[k][i];
            c[i] = c[i] / (Real)K;
        }
        Real ss = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            Real r = 0;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                X[k][i] = X[k][i] - c[i];
                r += X[k][i] * X[k][i];
            }
            ss += r;
        }
        sigma = fmax(sqrt(ss / (Real)K / (Real)3), (Real)1e-6);
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int i = 0; i < 3; ++i) xn[k][i] = X[k][i] / sigma;
                xn[k][3] = smp[k][3];
                xn[k][4] = smp[k][4];
            }
        }
        __syncwarp();
    }
    // Row i of the normal matrix A^T A (12 rows of A in order), its trace
    // summed over the rows in order, the regularization.
    const int i = min(lane, 11);
    Real A[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) A[q] = 0;
#pragma unroll
    for (int r = 0; r < 2 * K; ++r) {
        const int k = r % K;
        const Real Xh[4] = {xn[k][0], xn[k][1], xn[k][2], 1};
        const Real m = r < K ? xn[k][3] : xn[k][4];
        Real row[12];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            row[q] = r < K ? Xh[q] : 0;
            row[4 + q] = r < K ? 0 : Xh[q];
            row[8 + q] = -m * Xh[q];
        }
        Real ri = row[0];
#pragma unroll
        for (int q = 1; q < 12; ++q) ri = i == q ? row[q] : ri;
#pragma unroll
        for (int j = 0; j < 12; ++j) A[j] += ri * row[j];
    }
    Real d = A[0];
#pragma unroll
    for (int q = 1; q < 12; ++q) d = i == q ? A[q] : d;
    Real tr = 0;
#pragma unroll
    for (int q = 0; q < 12; ++q) tr += __shfl_sync(FULL, d, q);
    const Real eps = (Real)1e-7 * tr + (Real)1e-12;
#pragma unroll
    for (int q = 0; q < 12; ++q)
        if (q == i) A[q] += eps;
    // chol_n, column j by lanes i >= j: the diagonal first, then the others
    // divide by it.
    Real Lr[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        Real s = A[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= Lr[k] * L[12 * j + k];
        if (lane == j) L[13 * j] = sqrt(fmax(s, (Real)1e-12));
        __syncwarp();
        Lr[j] = lane == j ? L[13 * j] : s / L[13 * j];
        if (lane > j && lane < 12) L[12 * lane + j] = Lr[j];
        __syncwarp();
    }
    Real p[12], pn[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) p[q] = (Real)1 / sqrt((Real)12);
#pragma unroll 1
    for (int it = 0; it < 8; ++it) {
        chol_solve12(L, p, pn);
        Real nr = 0;
#pragma unroll
        for (int q = 0; q < 12; ++q) nr += pn[q] * pn[q];
        nr = fmax(sqrt(nr), (Real)1e-20);
#pragma unroll
        for (int q = 0; q < 12; ++q) p[q] = pn[q] / nr;
    }
    // P = Pn @ [[I / sigma, -c / sigma], [0, 0, 0, 1]].
    Real P[12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j) P[4 * r + j] = p[4 * r + j] / sigma;
        P[4 * r + 3] = p[4 * r] * (-c[0] / sigma) + p[4 * r + 1] * (-c[1] / sigma) +
                       p[4 * r + 2] * (-c[2] / sigma) + p[4 * r + 3];
    }
    const Real detM = P[0] * (P[5] * P[10] - P[6] * P[9]) - P[1] * (P[4] * P[10] - P[6] * P[8]) +
                      P[2] * (P[4] * P[9] - P[5] * P[8]);
    const Real sign = detM < 0 ? -1 : 1;
    const Real scale = cbrt(fmax(fabs(detM), (Real)1e-20));
    Real M[9], t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j) M[3 * r + j] = (P[4 * r + j] * sign) / scale;
        t[r] = (P[4 * r + 3] * sign) / scale;
    }
#pragma unroll 1
    for (int it = 0; it < 8; ++it) {
        Real inv[9], col[3];
#pragma unroll
        for (int cidx = 0; cidx < 3; ++cidx) {
            const Real e[3] = {(Real)(cidx == 0), (Real)(cidx == 1), (Real)(cidx == 2)};
            solve3x3(M, e, col);
#pragma unroll
            for (int r = 0; r < 3; ++r) inv[3 * r + cidx] = col[r];
        }
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int j = 0; j < 3; ++j) M[3 * r + j] = (Real)0.5 * (M[3 * r + j] + inv[3 * j + r]);
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) Rf[q] = (float)M[q];
#pragma unroll
    for (int r = 0; r < 3; ++r) tf[r] = (float)t[r];
}

// The inlier test of match n (staged: x, y, z, u, v and the gate chi2
// sigma^2, -inf where the match is not valid) under model (R, t).
__device__ __forceinline__ bool pnp_inlier(const float* M, const float* st, int N, int n,
                                           const Cam& c) {
    const float* R = M;
    const float* t = M + 9;
    const float x = st[n], y = st[N + n], z = st[2 * N + n];
    const float px = (R[0] * x + R[1] * y + R[2] * z) + t[0];
    const float py = (R[3] * x + R[4] * y + R[5] * z) + t[1];
    const float pz = (R[6] * x + R[7] * y + R[8] * z) + t[2];
    float u, v;
    project(c, px, py, pz, u, v);
    const float du = u - st[3 * N + n], dv = v - st[4 * N + n];
    return (du * du + dv * dv) < st[5 * N + n] && pz > 0.f;
}

__global__ void __launch_bounds__(PNP_THREADS, 1) pnp_ransac_kernel(PnpArgs a) {
    extern __shared__ float st[];  // [6][N]: x, y, z, u, v, gate
    __shared__ double s_L[PNP_HPC][144];
    __shared__ double s_xn[PNP_HPC][6][5];
    __shared__ float s_smp[PNP_HPC][6][5];
    __shared__ float s_model[PNP_HPC][12];
    __shared__ int s_cnt[PNP_HPC], s_best_h, s_best_n;
    __shared__ bool s_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = a.N;
    const int h0 = blockIdx.x * PNP_HPC, nh = min(PNP_HPC, a.H - h0);
    unsigned long long* stamps = a.work + STAMPS;
    if (blockIdx.x == 0 && tid == 0) stamp(stamps, 0);
    if (tid < PNP_HPC) s_cnt[tid] = 0;
    if (warp < nh) {
        // Hypothesis h0 + warp: its 6 matches, the model on this warp.
        const int h = h0 + warp;
        if (lane < 6) {
            const int n = a.idx[6 * h + lane];
#pragma unroll
            for (int i = 0; i < 3; ++i) s_smp[warp][lane][i] = a.X[3 * n + i];
            s_smp[warp][lane][3] = (a.uv[2 * n] - a.c.cx) / a.c.fx;
            s_smp[warp][lane][4] = (a.uv[2 * n + 1] - a.c.cy) / a.c.fy;
        }
        __syncwarp();
        float R[9], t[3];
        dlt6_warp(s_smp[warp], s_xn[warp], s_L[warp], lane, R, t);
        if (lane == 0) {
#pragma unroll
            for (int q = 0; q < 9; ++q) s_model[warp][q] = R[q];
#pragma unroll
            for (int q = 0; q < 3; ++q) s_model[warp][9 + q] = t[q];
            stamp(stamps, 1);
        }
    } else if (warp >= PNP_HPC) {
        // Meanwhile the other warps stage every match once.
        for (int n = tid - 32 * PNP_HPC; n < N; n += PNP_STAGERS) {
#pragma unroll
            for (int i = 0; i < 3; ++i) st[i * N + n] = a.X[3 * n + i];
            st[3 * N + n] = a.uv[2 * n];
            st[4 * N + n] = a.uv[2 * n + 1];
            st[5 * N + n] = a.valid[n] ? a.chi2 * a.sigma2[n] : -INFINITY;
        }
        if (tid == 32 * PNP_HPC) stamp(stamps, 2);
    }
    __syncthreads();
    // Every thread tests its strided matches against the CTA's models; the
    // counts are exact integer sums.
    int cnt[PNP_HPC] = {};
    for (int n = tid; n < N; n += PNP_THREADS)
#pragma unroll
        for (int i = 0; i < PNP_HPC; ++i)
            if (i < nh) cnt[i] += pnp_inlier(s_model[i], st, N, n, a.c);
#pragma unroll
    for (int i = 0; i < PNP_HPC; ++i) {
        const int v = __reduce_add_sync(FULL, cnt[i]);
        if (lane == 0 && v) atomicAdd(&s_cnt[i], v);
    }
    __syncthreads();
    // The first maximum by a 64-bit key (count << 32 | ~h); the last CTA by
    // an atomic ticket takes the winner.
    if (tid < nh) {
        const int h = h0 + tid;
#pragma unroll
        for (int q = 0; q < 12; ++q) a.models[12 * h + q] = s_model[tid][q];
        atomicMax(&a.work[0], ((unsigned long long)(unsigned)s_cnt[tid] << 32) |
                                  (0xffffffffu - (unsigned)h));
        __threadfence();
    }
    if (tid == 0) stamp(stamps, 3);
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&a.work[1], 1ull) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (tid == 0) {
        stamp(stamps, 4);
        const unsigned long long best = atomicExch(&a.work[0], 0ull);
        atomicExch(&a.work[1], 0ull);
        s_best_h = (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
        s_best_n = (int)(best >> 32);
    }
    __syncthreads();
    if (tid < 12) s_model[0][tid] = __ldcg(a.models + 12 * s_best_h + tid);
    __syncthreads();
    for (int n = tid; n < N; n += PNP_THREADS) a.inl[n] = pnp_inlier(s_model[0], st, N, n, a.c);
    if (tid < 16) {
        const int r = tid / 4, j = tid % 4;
        a.T[tid] = r == 3 ? (j == 3 ? 1.f : 0.f)
                          : (j < 3 ? s_model[0][3 * r + j] : s_model[0][9 + r]);
    }
    if (tid == 0) {
        *a.n_in = s_best_n;
        *a.ok = s_best_n >= a.min_inliers;
    }
    __syncthreads();
    if (tid == 0) stamp(stamps, 5);
}

}  // namespace

// One Sim3 attempt on N <= 4096 matches: with SIM3_RANSAC (mode bit 1) the
// H hypotheses of draw idx [H, 3] (2 a CTA), the first maximum and the
// winner's inliers (out_f[0:13], out_i[0], ok, inl_ransac); with
// SIM3_REFINE (bit 2) the refinement from the winner, or from (R0, t0, s0)
// alone (one CTA), into out_f[13:26], out_i[1], inl_ref; with both, also
// their combine (out_f[26:39], out_i[2]). `work` holds 2 zero words between
// calls on a stream, `models` [H, 13] is scratch.
C_ENTRY int sim3_attempt(const float* p1, const float* p2, const bool* valid, const float* s2_1,
                         const float* s2_2, int N, const int* idx, int H, const float* R0,
                         const float* t0, const float* s0, int mode, int fix_scale, int n_rounds,
                         int min_inliers, float fx1, float fy1, float cx1, float cy1, float fx2,
                         float fy2, float cx2, float cy2, unsigned long long* work, float* models,
                         float* out_f, int* out_i, bool* ok, bool* inl_ransac, bool* inl_ref,
                         cudaStream_t stream) {
    if (mode < 1 || mode > 3 || N < 0 || N > SIM3_MAX_N || n_rounds < 0 ||
        ((mode & SIM3_RANSAC) && H < 1))
        return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(float) * OBS * N;
    static int attr = 0;
    if (smem > attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            sim3_attempt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        attr = smem;
    }
    const Sim3Args a{p1, p2, valid, s2_1, s2_2, N, idx, H, R0, t0, s0, mode, fix_scale,
                     n_rounds, min_inliers, Cam{fx1, fy1, cx1, cy1}, Cam{fx2, fy2, cx2, cy2},
                     work, models, out_f, out_i, ok, inl_ransac, inl_ref};
    const int grid = (mode & SIM3_RANSAC) ? (H + SIM3_HPC - 1) / SIM3_HPC : 1;
    sim3_attempt_kernel<<<grid, SIM3_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// PnP RANSAC on N <= 8192 matches in one launch: the H hypotheses of draw
// idx [H, 6] (2 a CTA), the first maximum of their inlier counts, its pose
// T [4, 4], inliers [N], count and ok (count >= min_inliers). `work` holds
// 2 zero words between calls on a stream (24 with KERNEL_STAMPS), `models`
// [H, 12] is scratch.
C_ENTRY int pnp_ransac(const float* X, const float* uv, const bool* valid, const float* sigma2,
                       int N, const int* idx, int H, int min_inliers, float fx, float fy,
                       float cx, float cy, float chi2, unsigned long long* work,
                       float* models, float* T, bool* inl, int* n_in, bool* ok,
                       cudaStream_t stream) {
    if (N < 0 || N > PNP_MAX_N || H < 1) return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(float) * 6 * N;
    static int attr = 0;
    if (smem > attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            pnp_ransac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        attr = smem;
    }
    const PnpArgs a{X, uv, valid, sigma2, N, idx, H, min_inliers, Cam{fx, fy, cx, cy}, chi2,
                    work, models, T, inl, n_in, ok};
    const int grid = (H + PNP_HPC - 1) / PNP_HPC;
    pnp_ransac_kernel<<<grid, PNP_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
