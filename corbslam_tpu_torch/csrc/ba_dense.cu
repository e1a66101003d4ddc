// K8 `ba_dense`: dense-plane Schur/PCG Levenberg-Marquardt bundle adjustment
// (the local-BA engine) and its point-major gather table.
//
// Replaces corbslam_tpu/optim/ba_dense.py build_point_major, _linearize,
// _chi2, lm_step_dense (single device) and optimize / optimize_core, with the
// optim/smallmat.py Cholesky recurrences and the se3.retract /
// orthonormalize_fast they run.
//
// Bound on the H100: latency. A local BA (C = 24 cameras x Fb = 2048 slots,
// P = 8192 points, K = 24) has ~16k active observations; one CG iteration is
// three passes over them and one over the points, a few MB of traffic and
// ~10 MFLOP, and the reference's iterations (5 LM x up to 16 CG) all depend
// on each other through a handful of scalars (rz, alpha, beta, the accepted
// cost). Microseconds of work per pass; what costs is a launch or a host
// sync per step.
// Design: option (b) of a persistent kernel, as one CTA of 768 threads that
// runs the whole LM loop: ba_optimize is one launch per `optimize`, with no
// host sync (CG exit, accept / reject and lambda live in shared memory), and
// ba_point_major is one launch per problem. One CTA, not a cooperative grid:
// every reduction is a fixed-order warp shuffle plus a shared-memory pass, so
// the result does not depend on scheduling, and no grid barrier is needed.
// Observation passes give each warp one camera row (camera sums are warp
// reductions); point passes give each thread points and walk their K table
// entries (gathers, no atomics). Per observation the linearize pass stores
// the camera-frame point, the two row weights (0 for inactive or behind the
// camera, so later passes skip those slots) and the residual; the Jacobians
// are recomputed from them in each pass instead of being stored (27 floats).
// Per point the 3x3 Cholesky factor is stored once per LM iteration. The
// cost is that one SM does the work; at the local-BA sizes that is tens of
// microseconds per CG iteration.
// ba_point_major builds the table as the reference's stable argsort does:
// counts per point, an exclusive scan, an atomic fill, a per-point insertion
// sort of the flat indices (so each segment is ascending), then the inactive
// slots in ascending order behind them; pm_src is then order[start + off]
// exactly, junk entries included, with the even-stride rule past K.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 768;
constexpr int WARPS = THREADS / 32;
constexpr int PM_THREADS = 1024;
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float CG_TOL2 = 0.03f * 0.03f;

struct Cam {
    float fx, fy, cx, cy, bf;
};

struct Problem {
    const float* Tcw;         // [C, 4, 4]
    const bool* pose_fixed;   // [C]
    const float* X;           // [P, 3]
    const bool* point_fixed;  // [P]
    const int* obs_mp;        // [C * Fb]
    const float* uvr;         // [3, C * Fb]
    const float* inv_s2;      // [C * Fb]
    const bool* stereo;       // [C * Fb]
    const bool* active;       // [C * Fb]
    const int* pm_src;        // [P, K]
    const bool* pm_ok;        // [P, K]
    int C, Fb, P, K;
};

// Per-observation and per-point work arrays in device memory.
struct Work {
    float *px, *py, *pz;   // camera-frame point at the linearization point
    float *wa, *ws;        // row weights (u, v) and u_right, robust and active folded in
    float *r0, *r1, *r2;   // residual
    float *c2o, *c2n;      // chi2 at the current and at the proposed state
    float *t0, *t1, *t2;   // per-observation 3-vectors summed per point
    float *L;              // [P, 6] Cholesky factor of the damped point block
    float *zp;             // [P, 3] point-side solve
    float *Xn;             // [P, 3] proposed points
    unsigned char* act;    // current active set
};

struct Proj {
    float x, y, z, iz, iz2, r[3], w[3], c2;
};

// The reference's _linearize residual part for one observation.
__device__ __forceinline__ void project(const float* T, const float* X, float u, float v, float ur,
                                        float is2, bool stereo, const Cam& k, Proj& o) {
    o.x = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[9];
    o.y = T[3] * X[0] + T[4] * X[1] + T[5] * X[2] + T[10];
    o.z = T[6] * X[0] + T[7] * X[1] + T[8] * X[2] + T[11];
    const bool depth_ok = o.z > 1e-3f;
    o.iz = 1.0f / (depth_ok ? o.z : 1.0f);
    o.iz2 = o.iz * o.iz;
    const float pu = k.fx * o.x * o.iz + k.cx;
    const float pv = k.fy * o.y * o.iz + k.cy;
    const float pur = pu - k.bf * o.iz;
    o.r[0] = u - pu;
    o.r[1] = v - pv;
    o.r[2] = ur - pur;
    const float wb = depth_ok ? is2 : 0.f;
    o.w[0] = wb;
    o.w[1] = wb;
    o.w[2] = stereo ? wb : 0.f;
    o.c2 = o.r[0] * o.r[0] * o.w[0] + o.r[1] * o.r[1] * o.w[1] + o.r[2] * o.r[2] * o.w[2];
}

// Pose (3x6) and point (3x3) Jacobians from the camera-frame point, in the
// reference's symbolic form (A the projection differential, R row-major).
__device__ __forceinline__ void jac_pose(const Cam& k, float x, float y, float z, float iz,
                                         float iz2, float J[3][6]) {
    const float a0 = k.fx * iz, a2 = -k.fx * x * iz2;
    const float b1 = k.fy * iz, b2 = -k.fy * y * iz2;
    const float c2 = a2 + k.bf * iz2;
    J[0][0] = -a0; J[0][1] = 0.f; J[0][2] = -a2;
    J[0][3] = -(a2 * y); J[0][4] = -(a0 * z - a2 * x); J[0][5] = a0 * y;
    J[1][0] = 0.f; J[1][1] = -b1; J[1][2] = -b2;
    J[1][3] = -(-b1 * z + b2 * y); J[1][4] = b2 * x; J[1][5] = -(b1 * x);
    J[2][0] = -a0; J[2][1] = 0.f; J[2][2] = -c2;
    J[2][3] = -(c2 * y); J[2][4] = -(a0 * z - c2 * x); J[2][5] = a0 * y;
}

__device__ __forceinline__ void jac_point(const Cam& k, float x, float y, float iz, float iz2,
                                          const float* R, float J[3][3]) {
    const float a0 = k.fx * iz, a2 = -k.fx * x * iz2;
    const float b1 = k.fy * iz, b2 = -k.fy * y * iz2;
    const float c2 = a2 + k.bf * iz2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        J[0][j] = -(a0 * R[j] + a2 * R[6 + j]);
        J[1][j] = -(b1 * R[3 + j] + b2 * R[6 + j]);
        J[2][j] = -(a0 * R[j] + c2 * R[6 + j]);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float robust(float c2, float d2, bool huber) {
    return (huber && c2 > d2) ? 2.0f * sqrtf(d2 * fmaxf(c2, 1e-12f)) - d2 : c2;
}

// 3x3 Cholesky of the symmetric (h00 h01 h02 h11 h12 h22) with the eps clamp;
// L as (l00 l10 l11 l20 l21 l22).
__device__ __forceinline__ void chol3(const float* h, float* L) {
    const float l00 = sqrtf(fmaxf(h[0], 1e-12f));
    const float l10 = h[1] / l00;
    const float l11 = sqrtf(fmaxf(h[3] - l10 * l10, 1e-12f));
    const float l20 = h[2] / l00;
    const float l21 = (h[4] - l20 * l10) / l11;
    const float l22 = sqrtf(fmaxf(h[5] - l20 * l20 - l21 * l21, 1e-12f));
    L[0] = l00; L[1] = l10; L[2] = l11; L[3] = l20; L[4] = l21; L[5] = l22;
}

__device__ __forceinline__ void solve3(const float* L, const float* b, float* x) {
    const float y0 = b[0] / L[0];
    const float y1 = (b[1] - L[1] * y0) / L[2];
    const float y2 = (b[2] - L[3] * y0 - L[4] * y1) / L[5];
    x[2] = y2 / L[5];
    x[1] = (y1 - L[4] * x[2]) / L[2];
    x[0] = (y0 - L[1] * x[1] - L[3] * x[2]) / L[0];
}

// Inverse of a symmetric 6x6 (21 upper entries, row-major i <= j) by the
// reference's Cholesky solve against each identity column.
__device__ void inv_spd6(const float* H, float* Mi) {
    float A[6][6], L[6][6];
    int e = 0;
    for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = H[e++];
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j <= i; ++j) {
            float s = A[i][j];
            for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
            L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
        }
    for (int col = 0; col < 6; ++col) {
        float y[6], x[6];
        for (int i = 0; i < 6; ++i) {
            float s = (i == col) ? 1.f : 0.f;
            for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
            y[i] = s / L[i][i];
        }
        for (int i = 5; i >= 0; --i) {
            float s = y[i];
            for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
            x[i] = s / L[i][i];
        }
        for (int i = 0; i < 6; ++i) Mi[i * 6 + col] = x[i];
    }
}

__device__ void mat3(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j] + A[i * 3 + 2] * B[6 + j];
}

// Tn = exp(xi) @ T, xi = (rho, phi), se3.exp with its series below 1e-8.
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

// Shared-memory layout of the per-camera state (floats), C cameras.
struct Smem {
    float *T, *Tn;            // [C, 12] R row-major then t
    float *H;                 // [C, 21] camera blocks (upper triangle)
    float *Mi;                // [C, 36] damped-block inverses
    float *x, *r, *p, *z, *Ap, *b, *dc, *v;  // [C, 6]
    float *free_c;            // [C]
};

struct Ctx {
    Problem pb;
    Cam cam;
    Work w;
    Smem s;
    float* X;                 // current points (the X output buffer)
    float* scal;              // shared scalars
    float* red;               // [WARPS] shared partial sums
};

enum Scalar { S_LAM = 0, S_COST_OLD, S_COST_NEW, S_DOT0, S_DOT1, S_DOT2, S_DOT3, S_ACCEPT, S_N };

// Sum of one value per thread in a fixed order; every thread gets the total.
__device__ float block_sum(float v, Ctx& c) {
    v = warp_sum(v);
    const int t = threadIdx.x;
    if ((t & 31) == 0) c.red[t >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += c.red[w];
    __syncthreads();
    return s;
}

// sum(a * b) over the [C, 6] vectors, computed by warp 0; every thread gets it.
__device__ float cam_dot(const float* a, const float* b, int n, float* slot) {
    if (threadIdx.x < 32) {
        float s = 0.f;
        for (int i = threadIdx.x; i < n; i += 32) s += a[i] * b[i];
        s = warp_sum(s);
        if (threadIdx.x == 0) *slot = s;
    }
    __syncthreads();
    return *slot;
}

// z = Minv r * free_c, one thread per camera.
__device__ void precond(const float* r, float* z, Ctx& c) {
    const int C = c.pb.C;
    for (int ci = threadIdx.x; ci < C; ci += blockDim.x) {
        const float* M = c.s.Mi + ci * 36;
        const float* rr = r + ci * 6;
        for (int i = 0; i < 6; ++i) {
            float s = 0.f;
            for (int j = 0; j < 6; ++j) s += M[i * 6 + j] * rr[j];
            z[ci * 6 + i] = s * c.s.free_c[ci];
        }
    }
    __syncthreads();
}

// Per observation t = Jp_w^T m, m = (Jc v if v) + (r if with_r); then per
// point out = -sign * free_p * Hpp_d^-1 sum_obs t (zp), or X + that (Xn).
__device__ void point_side(const float* v, bool with_r, bool to_points, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int C = pb.C, Fb = pb.Fb;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int ci = warp; ci < C; ci += WARPS) {
        const float* R = c.s.T + ci * 12;
        for (int f = lane; f < Fb; f += 32) {
            const int o = ci * Fb + f;
            const float wa = w.wa[o];
            if (wa == 0.f) continue;
            const float ws = w.ws[o];
            const float x = w.px[o], y = w.py[o], z = w.pz[o];
            const float iz = 1.0f / z, iz2 = iz * iz;
            float m[3] = {0.f, 0.f, 0.f};
            if (v) {
                float Jc[3][6];
                jac_pose(c.cam, x, y, z, iz, iz2, Jc);
                const float* vv = v + ci * 6;
#pragma unroll
                for (int rr = 0; rr < 3; ++rr) {
                    float s = 0.f;
#pragma unroll
                    for (int j = 0; j < 6; ++j) s += Jc[rr][j] * vv[j];
                    m[rr] = s;
                }
            }
            if (with_r) {
                m[0] += w.r0[o];
                m[1] += w.r1[o];
                m[2] += w.r2[o];
            }
            float Jp[3][3];
            jac_point(c.cam, x, y, iz, iz2, R, Jp);
            const float wr[3] = {wa, wa, ws};
            float t[3];
#pragma unroll
            for (int i = 0; i < 3; ++i)
                t[i] = Jp[0][i] * wr[0] * m[0] + Jp[1][i] * wr[1] * m[1] + Jp[2][i] * wr[2] * m[2];
            w.t0[o] = t[0];
            w.t1[o] = t[1];
            w.t2[o] = t[2];
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pb.P; p += blockDim.x) {
        float y[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < pb.K; ++k) {
            if (!pb.pm_ok[p * pb.K + k]) continue;
            const int o = pb.pm_src[p * pb.K + k];
            if (w.wa[o] == 0.f) continue;
            y[0] += w.t0[o];
            y[1] += w.t1[o];
            y[2] += w.t2[o];
        }
        float s[3] = {0.f, 0.f, 0.f};
        if (!pb.point_fixed[p]) solve3(w.L + p * 6, y, s);
        if (to_points) {
            for (int i = 0; i < 3; ++i) w.Xn[p * 3 + i] = c.X[p * 3 + i] - s[i];
        } else {
            for (int i = 0; i < 3; ++i) w.zp[p * 3 + i] = s[i];
        }
    }
    __syncthreads();
}

// out[c] = free_c * (sum_obs Jc_w^T (m - Jp zp) + damp * v), m = Jc v or r.
// With v (schur_mv) damp = lam * diag(Hcc) + 1e-8; with r (the RHS) the
// result is negated and undamped.
__device__ void camera_side(const float* v, float* out, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int C = pb.C, Fb = pb.Fb;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float lam = c.scal[S_LAM];
    for (int ci = warp; ci < C; ci += WARPS) {
        const float* R = c.s.T + ci * 12;
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int f = lane; f < Fb; f += 32) {
            const int o = ci * Fb + f;
            const float wa = w.wa[o];
            if (wa == 0.f) continue;
            const float ws = w.ws[o];
            const float x = w.px[o], y = w.py[o], z = w.pz[o];
            const float iz = 1.0f / z, iz2 = iz * iz;
            float Jc[3][6], Jp[3][3];
            jac_pose(c.cam, x, y, z, iz, iz2, Jc);
            jac_point(c.cam, x, y, iz, iz2, R, Jp);
            float m[3];
            if (v) {
                const float* vv = v + ci * 6;
#pragma unroll
                for (int rr = 0; rr < 3; ++rr) {
                    float s = 0.f;
#pragma unroll
                    for (int j = 0; j < 6; ++j) s += Jc[rr][j] * vv[j];
                    m[rr] = s;
                }
            } else {
                m[0] = w.r0[o];
                m[1] = w.r1[o];
                m[2] = w.r2[o];
            }
            const int pt = pb.obs_mp[o];
            const float* zp = w.zp + pt * 3;
            const float wr[3] = {wa, wa, ws};
#pragma unroll
            for (int rr = 0; rr < 3; ++rr) {
                const float d = m[rr] - (Jp[rr][0] * zp[0] + Jp[rr][1] * zp[1] + Jp[rr][2] * zp[2]);
#pragma unroll
                for (int j = 0; j < 6; ++j) acc[j] += Jc[rr][j] * wr[rr] * d;
            }
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[j] = warp_sum(acc[j]);  // totals in lane 0
        if (lane == 0) {
            const float fc = c.s.free_c[ci];
            const float* H = c.s.H + ci * 21;
            for (int j = 0; j < 6; ++j) {
                const int d = j * 6 - j * (j - 1) / 2;  // (j, j) in the upper triangle
                out[ci * 6 + j] = v ? (acc[j] + (lam * H[d] + 1e-8f) * v[ci * 6 + j]) * fc
                                    : -acc[j] * fc;
            }
        }
    }
    __syncthreads();
}

// S v in residual space (the reference's schur_mv); v is masked first.
__device__ void schur_mv(float* v, float* out, Ctx& c) {
    for (int e = threadIdx.x; e < c.pb.C * 6; e += blockDim.x) v[e] *= c.s.free_c[e / 6];
    __syncthreads();
    point_side(v, false, false, c);
    camera_side(v, out, c);
}

// Linearize at (T, X): residuals, weights (robust when `huber`), chi2 into
// c2o; with `build`, the camera blocks H into shared memory. Returns the
// robust cost over the active set.
__device__ float linearize(bool huber, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int C = pb.C, Fb = pb.Fb, O = C * Fb;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float cost = 0.f;
    for (int ci = warp; ci < C; ci += WARPS) {
        const float* T = c.s.T + ci * 12;
        float acc[21];
#pragma unroll
        for (int e = 0; e < 21; ++e) acc[e] = 0.f;
        for (int f = lane; f < Fb; f += 32) {
            const int o = ci * Fb + f;
            const bool st = pb.stereo[o];
            Proj q;
            project(T, c.X + 3 * pb.obs_mp[o], pb.uvr[o], pb.uvr[O + o], pb.uvr[2 * O + o],
                    pb.inv_s2[o], st, c.cam, q);
            const float d2 = st ? CHI2_STEREO : CHI2_MONO;
            const bool act = w.act[o];
            const float rw = (!huber || q.c2 <= d2) ? 1.f : sqrtf(d2 / fmaxf(q.c2, 1e-12f));
            const float af = act ? 1.f : 0.f;
            const float wa = q.w[0] * (rw * af), ws = q.w[2] * (rw * af);
            w.px[o] = q.x;
            w.py[o] = q.y;
            w.pz[o] = q.z;
            w.wa[o] = wa;
            w.ws[o] = ws;
            w.r0[o] = q.r[0];
            w.r1[o] = q.r[1];
            w.r2[o] = q.r[2];
            w.c2o[o] = q.c2;
            if (act) cost += robust(q.c2, d2, huber);
            if (wa == 0.f) continue;
            float J[3][6];
            jac_pose(c.cam, q.x, q.y, q.z, q.iz, q.iz2, J);
            const float wr[3] = {wa, wa, ws};
#pragma unroll
            for (int rr = 0; rr < 3; ++rr) {
                int e = 0;
#pragma unroll
                for (int i = 0; i < 6; ++i) {
                    const float jw = J[rr][i] * wr[rr];
#pragma unroll
                    for (int j = i; j < 6; ++j) acc[e++] += jw * J[rr][j];
                }
            }
        }
#pragma unroll
        for (int e = 0; e < 21; ++e) acc[e] = warp_sum(acc[e]);
        if (lane == 0)
            for (int e = 0; e < 21; ++e) c.s.H[ci * 21 + e] = acc[e];
    }
    return block_sum(cost, c);
}

// chi2 of every observation at (Tn, Xn) into c2n; returns the robust cost
// over the active set.
__device__ float evaluate(const float* Ts, const float* Xs, float* c2_out, bool huber, Ctx& c) {
    const Problem& pb = c.pb;
    const int C = pb.C, Fb = pb.Fb, O = C * Fb;
    float cost = 0.f;
    for (int o = threadIdx.x; o < O; o += blockDim.x) {
        const bool st = pb.stereo[o];
        Proj q;
        project(Ts + (o / Fb) * 12, Xs + 3 * pb.obs_mp[o], pb.uvr[o], pb.uvr[O + o],
                pb.uvr[2 * O + o], pb.inv_s2[o], st, c.cam, q);
        c2_out[o] = q.c2;
        if (c.w.act[o]) cost += robust(q.c2, st ? CHI2_STEREO : CHI2_MONO, huber);
    }
    return block_sum(cost, c);
}

__global__ void __launch_bounds__(THREADS) optimize_kernel(Problem pb, Cam cam, Work work,
                                                           int n_iters, int cg_iters,
                                                           int huber_iters, float* Tcw_out,
                                                           float* X_out, bool* inlier_out,
                                                           float* cost_out, int* trace) {
    extern __shared__ float sm[];
    __shared__ float red[WARPS];
    __shared__ float scal[S_N];
    const int C = pb.C, Fb = pb.Fb, P = pb.P, O = C * Fb;
    const int t = threadIdx.x;
    Ctx c;
    c.pb = pb;
    c.cam = cam;
    c.w = work;
    c.X = X_out;
    c.scal = scal;
    c.red = red;
    float* q = sm;
    c.s.T = q; q += C * 12;
    c.s.Tn = q; q += C * 12;
    c.s.H = q; q += C * 21;
    c.s.Mi = q; q += C * 36;
    c.s.x = q; q += C * 6;
    c.s.r = q; q += C * 6;
    c.s.p = q; q += C * 6;
    c.s.z = q; q += C * 6;
    c.s.Ap = q; q += C * 6;
    c.s.b = q; q += C * 6;
    c.s.dc = q; q += C * 6;
    c.s.v = q; q += C * 6;
    c.s.free_c = q;

    for (int e = t; e < C * 12; e += THREADS) {
        const int ci = e / 12, k = e % 12;
        c.s.T[e] = k < 9 ? pb.Tcw[ci * 16 + (k / 3) * 4 + k % 3] : pb.Tcw[ci * 16 + (k - 9) * 4 + 3];
    }
    for (int e = t; e < C * 6; e += THREADS) c.s.dc[e] = 0.f;
    for (int ci = t; ci < C; ci += THREADS) c.s.free_c[ci] = pb.pose_fixed[ci] ? 0.f : 1.f;
    for (int e = t; e < P * 3; e += THREADS) X_out[e] = pb.X[e];
    for (int o = t; o < O; o += THREADS) work.act[o] = pb.active[o];
    if (t == 0) scal[S_LAM] = 1e-4f;
    __syncthreads();

    for (int it = 0; it < n_iters; ++it) {
        const bool huber = it < huber_iters;
        const float lam = scal[S_LAM];
        const float cost_old = linearize(huber, c);

        // Damped point blocks, their factors and z_g = Hpp_d^-1 Jp^T w r.
        for (int p = t; p < P; p += THREADS) {
            float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
            for (int k = 0; k < pb.K; ++k) {
                if (!pb.pm_ok[p * pb.K + k]) continue;
                const int o = pb.pm_src[p * pb.K + k];
                const float wa = work.wa[o];
                if (wa == 0.f) continue;
                const float x = work.px[o], y = work.py[o], iz = 1.0f / work.pz[o];
                float Jp[3][3];
                jac_point(cam, x, y, iz, iz * iz, c.s.T + (o / Fb) * 12, Jp);
                const float wr[3] = {wa, wa, work.ws[o]};
                const float rr[3] = {work.r0[o], work.r1[o], work.r2[o]};
                int e = 0;
                for (int i = 0; i < 3; ++i) {
                    for (int j = i; j < 3; ++j)
                        h[e++] += Jp[0][i] * wr[0] * Jp[0][j] + Jp[1][i] * wr[1] * Jp[1][j] +
                                  Jp[2][i] * wr[2] * Jp[2][j];
                    g[i] += Jp[0][i] * wr[0] * rr[0] + Jp[1][i] * wr[1] * rr[1] +
                            Jp[2][i] * wr[2] * rr[2];
                }
            }
            h[0] += lam * h[0] + 1e-6f;
            h[3] += lam * h[3] + 1e-6f;
            h[5] += lam * h[5] + 1e-6f;
            float* L = work.L + p * 6;
            chol3(h, L);
            float s[3] = {0.f, 0.f, 0.f};
            if (!pb.point_fixed[p]) solve3(L, g, s);
            for (int i = 0; i < 3; ++i) work.zp[p * 3 + i] = s[i];
        }
        // Damped camera blocks -> block-Jacobi preconditioner.
        for (int ci = t; ci < C; ci += THREADS) {
            float Hd[21];
            int e = 0;
            for (int i = 0; i < 6; ++i)
                for (int j = i; j < 6; ++j, ++e)
                    Hd[e] = c.s.H[ci * 21 + e] + (i == j ? lam * c.s.H[ci * 21 + e] + 1e-8f : 0.f);
            inv_spd6(Hd, c.s.Mi + ci * 36);
        }
        __syncthreads();
        camera_side(nullptr, c.s.b, c);  // b = -Jc_w^T (r - Jp z_g)

        // Forcing threshold from b; warm start from the previous step.
        precond(c.s.b, c.s.z, c);
        const float threshold = CG_TOL2 * cam_dot(c.s.b, c.s.z, C * 6, scal + S_DOT0);
        for (int e = t; e < C * 6; e += THREADS) c.s.v[e] = c.s.dc[e];
        __syncthreads();
        schur_mv(c.s.v, c.s.Ap, c);  // v = xd (masked), Ap = A xd
        const float bAd = cam_dot(c.s.b, c.s.Ap, C * 6, scal + S_DOT1);
        const float AdAd = cam_dot(c.s.Ap, c.s.Ap, C * 6, scal + S_DOT2);
        const float a0 = bAd / fmaxf(AdAd, 1e-20f);
        for (int e = t; e < C * 6; e += THREADS) {
            c.s.x[e] = a0 * c.s.v[e];
            c.s.r[e] = c.s.b[e] - a0 * c.s.Ap[e];
        }
        __syncthreads();
        precond(c.s.r, c.s.z, c);
        float rz = cam_dot(c.s.r, c.s.z, C * 6, scal + S_DOT3);
        for (int e = t; e < C * 6; e += THREADS) c.s.p[e] = c.s.z[e];
        __syncthreads();
        int k = 0;
        while (k < cg_iters && rz > threshold) {
            schur_mv(c.s.p, c.s.Ap, c);
            const float pAp = cam_dot(c.s.p, c.s.Ap, C * 6, scal + S_DOT0);
            const float alpha = rz / (fabsf(pAp) < 1e-20f ? 1e-20f : pAp);
            for (int e = t; e < C * 6; e += THREADS) {
                c.s.x[e] += alpha * c.s.p[e];
                c.s.r[e] -= alpha * c.s.Ap[e];
            }
            __syncthreads();
            precond(c.s.r, c.s.z, c);
            const float rz_new = cam_dot(c.s.r, c.s.z, C * 6, scal + S_DOT1);
            const float beta = rz_new / (fabsf(rz) < 1e-20f ? 1e-20f : rz);
            for (int e = t; e < C * 6; e += THREADS) c.s.p[e] = c.s.z[e] + beta * c.s.p[e];
            __syncthreads();
            rz = rz_new;
            ++k;
        }

        // Back-substitution dp = -Hpp_d^-1 Jp^T w (r + Jc dc), retraction.
        point_side(c.s.x, true, true, c);
        for (int ci = t; ci < C; ci += THREADS) {
            float* Tn = c.s.Tn + ci * 12;
            if (c.s.free_c[ci] == 0.f) {
                for (int e = 0; e < 12; ++e) Tn[e] = c.s.T[ci * 12 + e];
            } else {
                retract(c.s.x + ci * 6, c.s.T + ci * 12, Tn);
            }
        }
        __syncthreads();
        const float cost_new = evaluate(c.s.Tn, work.Xn, work.c2n, huber, c);
        const bool accept = cost_new < cost_old;
        if (t == 0) {
            scal[S_LAM] = accept ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 5.0f, 1e3f);
            trace[it * 2] = k;
            trace[it * 2 + 1] = accept ? 1 : 0;
        }
        if (accept) {
            for (int e = t; e < C * 12; e += THREADS) c.s.T[e] = c.s.Tn[e];
            for (int e = t; e < P * 3; e += THREADS) X_out[e] = work.Xn[e];
        }
        if (it == huber_iters - 1) {
            const float* c2c = accept ? work.c2n : work.c2o;
            for (int o = t; o < O; o += THREADS)
                work.act[o] = work.act[o] && c2c[o] <= (pb.stereo[o] ? CHI2_STEREO : CHI2_MONO);
        }
        for (int e = t; e < C * 6; e += THREADS) c.s.dc[e] = c.s.x[e];
        __syncthreads();
    }

    // Final chi2, inliers of the original active set, plain cost.
    const float cost = evaluate(c.s.T, X_out, work.c2n, false, c);
    for (int o = t; o < O; o += THREADS)
        inlier_out[o] = pb.active[o] && work.c2n[o] <= (pb.stereo[o] ? CHI2_STEREO : CHI2_MONO);
    if (t == 0) *cost_out = cost;
    // orthonormalize_fast: R <- R (3I - R^T R) / 2, three times.
    for (int ci = t; ci < C; ci += THREADS) {
        float R[9], Rt[9], RtR[9], S[9];
        for (int e = 0; e < 9; ++e) R[e] = c.s.T[ci * 12 + e];
        for (int step = 0; step < 3; ++step) {
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = R[j * 3 + i];
            mat3(Rt, R, RtR);
            for (int e = 0; e < 9; ++e) S[e] = ((e % 4 == 0) ? 3.f : 0.f) - RtR[e];
            mat3(R, S, RtR);
            for (int e = 0; e < 9; ++e) R[e] = 0.5f * RtR[e];
        }
        float* To = Tcw_out + ci * 16;
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) To[i * 4 + j] = R[i * 3 + j];
            To[i * 4 + 3] = c.s.T[ci * 12 + 9 + i];
        }
        To[12] = 0.f;
        To[13] = 0.f;
        To[14] = 0.f;
        To[15] = 1.f;
    }
}

// Exclusive scan over a block of PM_THREADS threads; returns the exclusive
// prefix of v and writes the total to *total.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += u;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int y = s_warp[lane];
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, y, o);
            if (lane >= o) y += u;
        }
        s_warp[lane] = y;
    }
    __syncthreads();
    const int incl = x + (warp ? s_warp[warp - 1] : 0);
    if (t == PM_THREADS - 1) *total = incl;
    __syncthreads();
    return incl - v;
}

__global__ void __launch_bounds__(PM_THREADS) point_major_kernel(
        const int* __restrict__ obs_mp, const bool* __restrict__ active, int O, int P, int K,
        int* __restrict__ count, int* __restrict__ start, int* __restrict__ cursor,
        int* __restrict__ order, int* __restrict__ pm_src, bool* __restrict__ pm_ok,
        bool* __restrict__ active_out) {
    __shared__ int s_warp[32];
    __shared__ int s_total;
    const int t = threadIdx.x;
    for (int p = t; p < P; p += PM_THREADS) {
        count[p] = 0;
        cursor[p] = 0;
    }
    for (int o = t; o < O; o += PM_THREADS) active_out[o] = false;
    __syncthreads();
    for (int o = t; o < O; o += PM_THREADS) {
        const int id = obs_mp[o];
        if (active[o] && id >= 0 && id < P) atomicAdd(&count[id], 1);
    }
    __syncthreads();
    // Segment starts: each thread scans a contiguous chunk of points.
    const int pc = (P + PM_THREADS - 1) / PM_THREADS;
    const int p0 = min(t * pc, P), p1 = min(p0 + pc, P);
    int n = 0;
    for (int p = p0; p < p1; ++p) n += count[p];
    int s = block_exclusive_scan(n, s_warp, &s_total);
    const int n_active = s_total;
    for (int p = p0; p < p1; ++p) {
        start[p] = s;
        s += count[p];
    }
    __syncthreads();
    for (int o = t; o < O; o += PM_THREADS) {
        const int id = obs_mp[o];
        if (active[o] && id >= 0 && id < P) order[start[id] + atomicAdd(&cursor[id], 1)] = o;
    }
    // The rest (sort key P) behind the segments, in ascending flat order.
    const int oc = (O + PM_THREADS - 1) / PM_THREADS;
    const int o0 = min(t * oc, O), o1 = min(o0 + oc, O);
    int m = 0;
    for (int o = o0; o < o1; ++o) {
        const int id = obs_mp[o];
        m += !(active[o] && id >= 0 && id < P);
    }
    int r = n_active + block_exclusive_scan(m, s_warp, &s_total);
    for (int o = o0; o < o1; ++o) {
        const int id = obs_mp[o];
        if (!(active[o] && id >= 0 && id < P)) order[r++] = o;
    }
    __syncthreads();
    // Stable order inside each segment: insertion sort of its flat indices.
    for (int p = t; p < P; p += PM_THREADS) {
        int* seg = order + start[p];
        const int cnt = count[p];
        for (int i = 1; i < cnt; ++i) {
            const int key = seg[i];
            int j = i - 1;
            while (j >= 0 && seg[j] > key) {
                seg[j + 1] = seg[j];
                --j;
            }
            seg[j + 1] = key;
        }
    }
    __syncthreads();
    for (int p = t; p < P; p += PM_THREADS) {
        const int cnt = count[p];
        for (int k = 0; k < K; ++k) {
            // Past K observations, an even stride over the whole span.
            const int off = cnt > K ? (int)(((long long)k * cnt) / K) : k;
            const bool ok = off < cnt;
            const int slot = min(max(start[p] + off, 0), O - 1);
            pm_ok[p * K + k] = ok;
            pm_src[p * K + k] = order[slot];
            if (ok) active_out[order[slot]] = true;
        }
    }
}

}  // namespace

// Point-major table of a [C, Fb] problem: pm_src / pm_ok [P, K] and the
// active mask restricted to the observations it holds. work: 3 P + C Fb ints.
C_ENTRY int ba_point_major(const int* obs_mp, const bool* active, int C, int Fb, int P, int K,
                           int* work, int* pm_src, bool* pm_ok, bool* active_out,
                           cudaStream_t stream) {
    const int O = C * Fb;
    point_major_kernel<<<1, PM_THREADS, 0, stream>>>(obs_mp, active, O, P, K, work, work + P,
                                                     work + 2 * P, work + 3 * P, pm_src, pm_ok,
                                                     active_out);
    return (int)cudaGetLastError();
}

// The whole LM loop of `optimize` in one launch (C <= 256). scratch_f:
// 13 C Fb + 12 P floats; scratch_b: C Fb bytes; trace: [n_iters, 2] ints
// (CG iterations, accepted).
C_ENTRY int ba_optimize(const float* Tcw, const bool* pose_fixed, const float* X,
                        const bool* point_fixed, const int* obs_mp, const float* obs_uvr,
                        const float* inv_s2, const bool* stereo, const bool* active,
                        const int* pm_src, const bool* pm_ok, int C, int Fb, int P, int K,
                        int n_iters, int cg_iters, int huber_iters, float fx, float fy, float cx,
                        float cy, float bf, float* scratch_f, unsigned char* scratch_b,
                        float* Tcw_out, float* X_out, bool* inlier_out, float* cost_out,
                        int* trace, cudaStream_t stream) {
    if (C > 256) return (int)cudaErrorInvalidValue;
    const Problem pb{Tcw, pose_fixed, X, point_fixed, obs_mp, obs_uvr, inv_s2, stereo, active,
                     pm_src, pm_ok, C, Fb, P, K};
    const size_t O = (size_t)C * Fb;
    float* f = scratch_f;
    Work w;
    w.px = f; f += O;
    w.py = f; f += O;
    w.pz = f; f += O;
    w.wa = f; f += O;
    w.ws = f; f += O;
    w.r0 = f; f += O;
    w.r1 = f; f += O;
    w.r2 = f; f += O;
    w.c2o = f; f += O;
    w.c2n = f; f += O;
    w.t0 = f; f += O;
    w.t1 = f; f += O;
    w.t2 = f; f += O;
    w.L = f; f += (size_t)P * 6;
    w.zp = f; f += (size_t)P * 3;
    w.Xn = f;
    w.act = scratch_b;
    const Cam cam{fx, fy, cx, cy, bf};
    const size_t shm = (size_t)C * (12 + 12 + 21 + 36 + 8 * 6 + 1) * sizeof(float);
    if (shm > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            optimize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
        if (e != cudaSuccess) return (int)e;
    }
    optimize_kernel<<<1, THREADS, shm, stream>>>(pb, cam, w, n_iters, cg_iters, huber_iters,
                                                 Tcw_out, X_out, inlier_out, cost_out, trace);
    return (int)cudaGetLastError();
}
