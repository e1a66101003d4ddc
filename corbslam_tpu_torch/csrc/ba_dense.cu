// K8 `ba_dense`: dense-plane Schur/PCG Levenberg-Marquardt bundle adjustment
// (the local- and global-BA engine) and its point-major gather table.
//
// Replaces corbslam_tpu/optim/ba_dense.py build_point_major (:80), _linearize
// (:136), _chi2, lm_step_dense (:224, single device) and optimize /
// optimize_core (:434), with the optim/smallmat.py Cholesky recurrences and
// the se3.retract / orthonormalize_fast they run.
//
// Bound on the H100: latency. A local BA (C = 24 cameras x Fb = 2048 slots,
// P = 8192 points, K = 24) has ~16k active observations; one CG iteration is
// a pass over the observations, one over the points and one over the
// cameras, a few MB of traffic and ~10 MFLOP, and the reference's iterations
// (LM x up to 16 CG) all depend on each other through a handful of scalars
// (rz, alpha, beta, the accepted cost). Microseconds of work per pass; what
// costs is the chain of dependent passes, so the floor is the number of
// grid-wide barriers times a barrier's latency.
// Design: one persistent cooperative grid per `optimize` (one CTA of 256
// threads on each SM, launched with cudaLaunchCooperativeKernel; at most 128
// registers a thread, so a local BA's grid and global BA's, on their two
// streams, fit on every SM at once), no host sync. Every pass spreads over
// the whole grid: observation passes as warp tiles of (camera, 64-slot
// chunk), point passes one thread a point (gathering its K table entries),
// camera passes one warp a camera. All state lives in device memory (per
// observation, per point, and per camera: T twice, the 21 H entries, the 36
// of the block-Jacobi inverse, x r z b dc v Ap and the CG direction twice,
// the free flag: 136 floats), so C is bounded by memory alone. Camera sums:
// each tile writes its partial sums (21 of H, 6 of the RHS and of the warm
// start's product, 6 of a Schur product); after a barrier the camera's owner
// warp adds them in tile order.
// Scalars (costs, rz, alpha, beta, the warm start's dots, the CG exit,
// accept, lambda) are per-CTA partials in a fixed order, added by every CTA
// in the same order after a barrier: no float atomics, so a run repeats bit
// for bit on a given card. Data written inside the kernel is read with
// __ldcg (L2), never from a stale L1 line.
// Barriers (grid.sync): 1 to load; per LM iteration 7 + 3 per CG iteration
// (linearize | point factors, z_g, the warm start's point solve and the
// camera blocks' inverses | RHS and warm-start partials | b, A d, their dots
// | x0, r0, z0 | CG: point solve of A p | camera partials and p A p | alpha,
// x, r, z, rz | back-substitution and retraction | the new cost), 1 at the
// end. The CG direction p = z + beta p_prev is computed where it is read
// (both buffers stay readable), which saves a barrier per CG iteration; the
// accepted state is a swap of buffers, and the re-classification after the
// robust phase is applied by the next observation pass. Call a of a local BA
// (3 LM x <= 16 CG) thus needs <= 3 x 55 + 2 barriers.
// Per observation the linearize pass stores the camera-frame point, the two
// row weights (0 for inactive or behind the camera, so later passes skip
// those slots) and the residual; the Jacobians are recomputed from them in
// each pass instead of being stored (27 floats). Per point the 3x3 Cholesky
// factor is stored once per LM iteration.
// ba_point_major builds the table as the reference's stable argsort does:
// counts per point, an exclusive scan, an atomic fill, a per-point insertion
// sort of the flat indices (so each segment is ascending), then the inactive
// slots in ascending order behind them; pm_src is then order[start + off]
// exactly, junk entries included, with the even-stride rule past K. It runs
// on one CTA of 1024 threads.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;         // observation slots of a warp tile (two per lane)
constexpr int NPART = 21;        // floats of a tile's partial sums
constexpr int MAX_GRID = 1024;   // CTAs at most: the per-CTA partials' stride
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

// The kernel's state in device memory.
struct Work {
    float *px, *py, *pz;   // [O] camera-frame point at the linearization point
    float *wa, *ws;        // [O] row weights (u, v) and u_right, robust and active folded in
    float *r0, *r1, *r2;   // [O] residual
    float *c2o, *c2n;      // [O] chi2 at the current and at the proposed state
    float *L;              // [P, 6] Cholesky factor of the damped point block
    float *zp;             // [P, 3] point-side solve of g, then of each CG direction
    float *zv;             // [P, 3] point-side solve of the warm start
    float *Xw;             // [P, 3] a second writable point buffer (X_out is the first)
    float *T[2];           // [C, 12] R row-major then t: current and proposed
    float *H;              // [C, 21] camera blocks (upper triangle)
    float *Mi;             // [C, 36] damped-block inverses
    float *x, *r, *z, *b, *dc, *v, *Ap;  // [C, 6]
    float *pv[2];          // [C, 6] the CG direction, by parity of the iteration
    float *free_c;         // [C]
    float *part;           // [C * n_chunks, NPART] per-tile camera partial sums
    float *red;            // [N_SLOT, MAX_GRID] per-CTA scalar partials
    unsigned char* act;    // [O] current active set
};

// Per-CTA scalar partials. The costs are read after the last barrier of an
// LM iteration, so the next write of a cost's slot must lie behind another
// barrier: the old cost alternates by iteration, the final cost has its own.
enum Slot {
    R_COST_OLD0 = 0, R_COST_OLD1, R_COST_NEW, R_COST_FINAL, R_THR, R_BAD, R_ADAD, R_RZ, R_PAP,
    N_SLOT
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

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void load_T(const float* T, float* o) {
#pragma unroll
    for (int e = 0; e < 12; ++e) o[e] = ld(T + e);
}

// The CG direction of camera component e: p_0 as stored, p_k = z + beta p_(k-1).
__device__ __forceinline__ float pdir(const float* pcur, const float* pprev, const float* z,
                                      float beta, bool fresh, int e) {
    return fresh ? ld(pcur + e) : __fmaf_rn(beta, ld(pprev + e), ld(z + e));
}

struct Ctx {
    Problem pb;
    Cam cam;
    Work w;
    int n_chunks, n_tiles;
    int lane, warp, gw, nw, gt, nt;  // lane, warp in the CTA; global warp / thread and counts
    float* s_red;                    // [WARPS] shared
    float* s_bc;                     // shared broadcast slot
};

// This CTA's partial of one value per thread into red[slot], in a fixed order.
__device__ void cta_partial(float v, int slot, Ctx& c) {
    v = warp_sum(v);
    if (c.lane == 0) c.s_red[c.warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.f;
        for (int k = 0; k < WARPS; ++k) s += c.s_red[k];
        c.w.red[slot * MAX_GRID + blockIdx.x] = s;
    }
    __syncthreads();
}

// The grid's total of red[slot], added in the same order by every CTA.
__device__ float grid_total(int slot, Ctx& c) {
    if (c.warp == 0) {
        float s = 0.f;
        for (int i = c.lane; i < (int)gridDim.x; i += 32) s += ld(c.w.red + slot * MAX_GRID + i);
        s = warp_sum(s);
        if (c.lane == 0) *c.s_bc = s;
    }
    __syncthreads();
    const float t = *c.s_bc;
    __syncthreads();
    return t;
}

// Entry e of camera ci's tile partials, added in tile order.
__device__ float tile_sum(int ci, int e, const Ctx& c) {
    const float* q = c.w.part + (size_t)ci * c.n_chunks * NPART + e;
    float s = 0.f;
    for (int k = 0; k < c.n_chunks; ++k) s += ld(q + (size_t)k * NPART);
    return s;
}

// z_i = (Minv r)_i * free_c for the owner warp of a camera: lane i < 6 holds
// r_i and gets z_i (0 on the other lanes).
__device__ float precond(const float* Mi, float ri, float fc, int lane) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        const float rj = __shfl_sync(0xffffffffu, ri, j);
        if (lane < 6) s += ld(Mi + lane * 6 + j) * rj;
    }
    return lane < 6 ? s * fc : 0.f;
}

__device__ __forceinline__ int diag6(int j) { return j * 6 - j * (j - 1) / 2; }

__device__ __forceinline__ float gate(const Ctx& c, int o) {
    return c.pb.stereo[o] ? CHI2_STEREO : CHI2_MONO;
}

// The active flag of observation o, with a pending re-classification
// (1: by c2n, 2: by c2o) applied and stored.
__device__ __forceinline__ bool current_act(int o, int reclass, const Ctx& c) {
    bool a = __ldcg(c.w.act + o) != 0;
    if (reclass) {
        a = a && ld((reclass == 1 ? c.w.c2n : c.w.c2o) + o) <= gate(c, o);
        c.w.act[o] = a;
    }
    return a;
}

// Linearize at (T, X): residuals, weights (robust when `huber`), chi2 into
// c2o, each tile's 21 H partials; the robust cost over the active set into
// red[slot].
__device__ void pass_linearize(bool huber, int reclass, const float* T, const float* X, int slot,
                               Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int Fb = pb.Fb, O = pb.C * Fb;
    float cost = 0.f;
    for (int tile = c.gw; tile < c.n_tiles; tile += c.nw) {
        const int ci = tile / c.n_chunks, f0 = (tile % c.n_chunks) * TILE;
        float Tc[12];
        load_T(T + ci * 12, Tc);
        float acc[21];
#pragma unroll
        for (int e = 0; e < 21; ++e) acc[e] = 0.f;
        for (int f = f0 + c.lane; f < min(f0 + TILE, Fb); f += 32) {
            const int o = ci * Fb + f;
            const bool act = current_act(o, reclass, c);
            const bool st = pb.stereo[o];
            const float* Xp = X + 3 * pb.obs_mp[o];
            const float Xo[3] = {ld(Xp), ld(Xp + 1), ld(Xp + 2)};
            Proj q;
            project(Tc, Xo, pb.uvr[o], pb.uvr[O + o], pb.uvr[2 * O + o], pb.inv_s2[o], st, c.cam,
                    q);
            const float d2 = st ? CHI2_STEREO : CHI2_MONO;
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
        if (c.lane == 0)
            for (int e = 0; e < 21; ++e) w.part[(size_t)tile * NPART + e] = acc[e];
    }
    cta_partial(cost, slot, c);
}

// chi2 of every observation at (Ts, Xs) into c2n and the robust cost over the
// active set into red[slot]; with `inlier`, the final classification of the
// original active set.
__device__ void pass_evaluate(const float* Ts, const float* Xs, bool huber, int reclass,
                              bool* inlier, int slot, Ctx& c) {
    const Problem& pb = c.pb;
    const int Fb = pb.Fb, O = pb.C * Fb;
    float cost = 0.f;
    for (int tile = c.gw; tile < c.n_tiles; tile += c.nw) {
        const int ci = tile / c.n_chunks, f0 = (tile % c.n_chunks) * TILE;
        float Tc[12];
        load_T(Ts + ci * 12, Tc);
        for (int f = f0 + c.lane; f < min(f0 + TILE, Fb); f += 32) {
            const int o = ci * Fb + f;
            const bool act = current_act(o, reclass, c);
            const bool st = pb.stereo[o];
            const float* Xp = Xs + 3 * pb.obs_mp[o];
            const float Xo[3] = {ld(Xp), ld(Xp + 1), ld(Xp + 2)};
            Proj q;
            project(Tc, Xo, pb.uvr[o], pb.uvr[O + o], pb.uvr[2 * O + o], pb.inv_s2[o], st, c.cam,
                    q);
            c.w.c2n[o] = q.c2;
            const float d2 = st ? CHI2_STEREO : CHI2_MONO;
            if (act) cost += robust(q.c2, d2, huber);
            if (inlier) inlier[o] = pb.active[o] && q.c2 <= d2;
        }
    }
    cta_partial(cost, slot, c);
}

// Pose and point Jacobians of observation o from its stored camera-frame
// point; Rr is its camera's rotation (row-major, in registers).
struct ObsJ {
    float Jc[3][6], Jp[3][3], wr[3];
};

__device__ __forceinline__ void obs_jac(int o, const float* Rr, const Ctx& c, ObsJ& j) {
    const float x = ld(c.w.px + o), y = ld(c.w.py + o), z = ld(c.w.pz + o);
    const float iz = 1.0f / z, iz2 = iz * iz;
    jac_pose(c.cam, x, y, z, iz, iz2, j.Jc);
    jac_point(c.cam, x, y, iz, iz2, Rr, j.Jp);
    const float wa = ld(c.w.wa + o);
    j.wr[0] = wa;
    j.wr[1] = wa;
    j.wr[2] = ld(c.w.ws + o);
}

__device__ __forceinline__ void jc_dot(const ObsJ& j, const float* vv, float m[3]) {
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += j.Jc[rr][k] * vv[k];
        m[rr] = s;
    }
}

// Row k of Jp times the point vector z.
__device__ __forceinline__ float jp_row(const ObsJ& j, int k, const float z[3]) {
    return j.Jp[k][0] * z[0] + j.Jp[k][1] * z[1] + j.Jp[k][2] * z[2];
}

__device__ __forceinline__ void jp_t(const ObsJ& j, const float m[3], float t[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
        t[i] = j.Jp[0][i] * j.wr[0] * m[0] + j.Jp[1][i] * j.wr[1] * m[1] +
               j.Jp[2][i] * j.wr[2] * m[2];
}

// Point pass of an LM iteration: damped point blocks, their factors, z_g =
// Hpp_d^-1 Jp^T w r and the warm start's zv = Hpp_d^-1 Jp^T w Jc v (v = dc
// masked); owner warps: the camera blocks H and the preconditioner.
__device__ void pass_factor(float lam, const float* T, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    for (int ci = c.gw; ci < pb.C; ci += c.nw) {
        const float h = c.lane < 21 ? tile_sum(ci, c.lane, c) : 0.f;
        if (c.lane < 21) w.H[ci * 21 + c.lane] = h;
        float Hd[21];
        int e = 0;
        for (int i = 0; i < 6; ++i)
            for (int j = i; j < 6; ++j, ++e) {
                const float he = __shfl_sync(0xffffffffu, h, e);
                Hd[e] = he + (i == j ? lam * he + 1e-8f : 0.f);
            }
        if (c.lane == 0) inv_spd6(Hd, w.Mi + ci * 36);
    }
    for (int p = c.gt; p < pb.P; p += c.nt) {
        float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f},
              y[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < pb.K; ++k) {
            if (!pb.pm_ok[p * pb.K + k]) continue;
            const int o = pb.pm_src[p * pb.K + k];
            if (ld(w.wa + o) == 0.f) continue;
            const int ci = o / pb.Fb;
            float Rr[12];
            load_T(T + ci * 12, Rr);
            ObsJ j;
            obs_jac(o, Rr, c, j);
            const float rr[3] = {ld(w.r0 + o), ld(w.r1 + o), ld(w.r2 + o)};
            int e = 0;
            for (int a = 0; a < 3; ++a) {
                for (int b = a; b < 3; ++b)
                    h[e++] += j.Jp[0][a] * j.wr[0] * j.Jp[0][b] +
                              j.Jp[1][a] * j.wr[1] * j.Jp[1][b] + j.Jp[2][a] * j.wr[2] * j.Jp[2][b];
                g[a] += j.Jp[0][a] * j.wr[0] * rr[0] + j.Jp[1][a] * j.wr[1] * rr[1] +
                        j.Jp[2][a] * j.wr[2] * rr[2];
            }
            const float fc = ld(w.free_c + ci);
            float vv[6], m[3], t[3];
#pragma unroll
            for (int q = 0; q < 6; ++q) vv[q] = ld(w.dc + ci * 6 + q) * fc;
            jc_dot(j, vv, m);
            jp_t(j, m, t);
            y[0] += t[0];
            y[1] += t[1];
            y[2] += t[2];
        }
        h[0] += lam * h[0] + 1e-6f;
        h[3] += lam * h[3] + 1e-6f;
        h[5] += lam * h[5] + 1e-6f;
        float* L = w.L + p * 6;
        float Lr[6];
        chol3(h, Lr);
        for (int e = 0; e < 6; ++e) L[e] = Lr[e];
        float s[3] = {0.f, 0.f, 0.f}, sv[3] = {0.f, 0.f, 0.f};
        if (!pb.point_fixed[p]) {
            solve3(Lr, g, s);
            solve3(Lr, y, sv);
        }
        for (int i = 0; i < 3; ++i) {
            w.zp[p * 3 + i] = s[i];
            w.zv[p * 3 + i] = sv[i];
        }
    }
}

// Observation pass of the RHS and the warm start: per tile the partials of
// Jc_w^T (r - Jp z_g) (entries 0-5) and Jc_w^T (Jc v - Jp zv) (6-11).
__device__ void pass_rhs(const float* T, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int Fb = pb.Fb;
    for (int tile = c.gw; tile < c.n_tiles; tile += c.nw) {
        const int ci = tile / c.n_chunks, f0 = (tile % c.n_chunks) * TILE;
        const float fc = ld(w.free_c + ci);
        float Rr[12], vv[6], ab[6], av[6];
        load_T(T + ci * 12, Rr);
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            vv[q] = ld(w.dc + ci * 6 + q) * fc;
            ab[q] = 0.f;
            av[q] = 0.f;
        }
        for (int f = f0 + c.lane; f < min(f0 + TILE, Fb); f += 32) {
            const int o = ci * Fb + f;
            if (ld(w.wa + o) == 0.f) continue;
            ObsJ j;
            obs_jac(o, Rr, c, j);
            const int pt = pb.obs_mp[o];
            const float zp[3] = {ld(w.zp + pt * 3), ld(w.zp + pt * 3 + 1), ld(w.zp + pt * 3 + 2)};
            const float zv[3] = {ld(w.zv + pt * 3), ld(w.zv + pt * 3 + 1), ld(w.zv + pt * 3 + 2)};
            const float rr[3] = {ld(w.r0 + o), ld(w.r1 + o), ld(w.r2 + o)};
            float m[3];
            jc_dot(j, vv, m);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float db = rr[k] - jp_row(j, k, zp);
                const float dv = m[k] - jp_row(j, k, zv);
#pragma unroll
                for (int q = 0; q < 6; ++q) {
                    ab[q] += j.Jc[k][q] * j.wr[k] * db;
                    av[q] += j.Jc[k][q] * j.wr[k] * dv;
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            ab[q] = warp_sum(ab[q]);
            av[q] = warp_sum(av[q]);
        }
        if (c.lane == 0)
            for (int q = 0; q < 6; ++q) {
                w.part[(size_t)tile * NPART + q] = ab[q];
                w.part[(size_t)tile * NPART + 6 + q] = av[q];
            }
    }
}

// Camera pass: b = -Jc_w^T (r - Jp z_g), v = dc masked, A v (warm start),
// z = Minv b; partials of b.z, b.Av and Av.Av.
__device__ void pass_warm_dots(float lam, Ctx& c) {
    const Work& w = c.w;
    float thr = 0.f, bad = 0.f, adad = 0.f;
    for (int ci = c.gw; ci < c.pb.C; ci += c.nw) {
        const int j = c.lane;
        const float fc = ld(w.free_c + ci);
        float bj = 0.f, aj = 0.f;
        if (j < 6) {
            const float vj = ld(w.dc + ci * 6 + j) * fc;
            bj = -tile_sum(ci, j, c) * fc;
            aj = (tile_sum(ci, 6 + j, c) + (lam * ld(w.H + ci * 21 + diag6(j)) + 1e-8f) * vj) * fc;
            w.v[ci * 6 + j] = vj;
            w.b[ci * 6 + j] = bj;
            w.Ap[ci * 6 + j] = aj;
        }
        const float zj = precond(w.Mi + ci * 36, bj, fc, j);
        thr += bj * zj;
        bad += bj * aj;
        adad += aj * aj;
    }
    cta_partial(thr, R_THR, c);
    cta_partial(bad, R_BAD, c);
    cta_partial(adad, R_ADAD, c);
}

// Camera pass: x0 = a0 v, r0 = b - a0 A v, z0 = Minv r0 = p_0; partial of r0.z0.
__device__ void pass_warm_start(float a0, Ctx& c) {
    const Work& w = c.w;
    float rz = 0.f;
    for (int ci = c.gw; ci < c.pb.C; ci += c.nw) {
        const int j = c.lane;
        const float fc = ld(w.free_c + ci);
        float rj = 0.f;
        if (j < 6) {
            w.x[ci * 6 + j] = a0 * ld(w.v + ci * 6 + j);
            rj = ld(w.b + ci * 6 + j) - a0 * ld(w.Ap + ci * 6 + j);
            w.r[ci * 6 + j] = rj;
        }
        const float zj = precond(w.Mi + ci * 36, rj, fc, j);
        if (j < 6) {
            w.z[ci * 6 + j] = zj;
            w.pv[0][ci * 6 + j] = zj;
        }
        rz += rj * zj;
    }
    cta_partial(rz, R_RZ, c);
}

// CG, point pass: zp = Hpp_d^-1 Jp^T w Jc p_k (0 for fixed points); owner
// warps store p_k (k > 0) in its buffer.
__device__ void pass_cg_points(int k, float beta, const float* T, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const float* pcur = w.pv[k & 1];
    const float* pprev = w.pv[(k + 1) & 1];
    const bool fresh = k == 0;
    if (!fresh)
        for (int ci = c.gw; ci < pb.C; ci += c.nw)
            if (c.lane < 6)
                w.pv[k & 1][ci * 6 + c.lane] =
                    __fmaf_rn(beta, ld(pprev + ci * 6 + c.lane), ld(w.z + ci * 6 + c.lane));
    for (int p = c.gt; p < pb.P; p += c.nt) {
        float y[3] = {0.f, 0.f, 0.f};
        for (int kk = 0; kk < pb.K; ++kk) {
            if (!pb.pm_ok[p * pb.K + kk]) continue;
            const int o = pb.pm_src[p * pb.K + kk];
            if (ld(w.wa + o) == 0.f) continue;
            const int ci = o / pb.Fb;
            float Rr[12];
            load_T(T + ci * 12, Rr);
            ObsJ j;
            obs_jac(o, Rr, c, j);
            float vv[6], m[3], t[3];
#pragma unroll
            for (int q = 0; q < 6; ++q)
                vv[q] = pdir(pcur + ci * 6, pprev + ci * 6, w.z + ci * 6, beta, fresh, q);
            jc_dot(j, vv, m);
            jp_t(j, m, t);
            y[0] += t[0];
            y[1] += t[1];
            y[2] += t[2];
        }
        float s[3] = {0.f, 0.f, 0.f};
        if (!pb.point_fixed[p]) solve3(w.L + p * 6, y, s);
        for (int i = 0; i < 3; ++i) w.zp[p * 3 + i] = s[i];
    }
}

// CG, observation pass: per tile the partials of Jc_w^T (Jc p - Jp zp); the
// CTA's partial of p.A p (per observation (Jc p)^T w (Jc p - Jp zp), per
// owned camera the damping term).
__device__ void pass_cg_cameras(int k, float lam, const float* T, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    const int Fb = pb.Fb;
    const float* pk = w.pv[k & 1];
    float pap = 0.f;
    for (int tile = c.gw; tile < c.n_tiles; tile += c.nw) {
        const int ci = tile / c.n_chunks, f0 = (tile % c.n_chunks) * TILE;
        float Rr[12], vv[6], acc[6];
        load_T(T + ci * 12, Rr);
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            vv[q] = ld(pk + ci * 6 + q);
            acc[q] = 0.f;
        }
        for (int f = f0 + c.lane; f < min(f0 + TILE, Fb); f += 32) {
            const int o = ci * Fb + f;
            if (ld(w.wa + o) == 0.f) continue;
            ObsJ j;
            obs_jac(o, Rr, c, j);
            const int pt = pb.obs_mp[o];
            const float zp[3] = {ld(w.zp + pt * 3), ld(w.zp + pt * 3 + 1), ld(w.zp + pt * 3 + 2)};
            float m[3];
            jc_dot(j, vv, m);
#pragma unroll
            for (int kk = 0; kk < 3; ++kk) {
                const float d = m[kk] - jp_row(j, kk, zp);
                pap += m[kk] * j.wr[kk] * d;
#pragma unroll
                for (int q = 0; q < 6; ++q) acc[q] += j.Jc[kk][q] * j.wr[kk] * d;
            }
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) acc[q] = warp_sum(acc[q]);
        if (c.lane == 0)
            for (int q = 0; q < 6; ++q) w.part[(size_t)tile * NPART + q] = acc[q];
    }
    for (int ci = c.gw; ci < pb.C; ci += c.nw)
        if (c.lane < 6) {
            const float pj = ld(pk + ci * 6 + c.lane);
            pap += (lam * ld(w.H + ci * 21 + diag6(c.lane)) + 1e-8f) * pj * pj *
                   ld(w.free_c + ci);
        }
    cta_partial(pap, R_PAP, c);
}

// CG, camera pass: A p, x += alpha p, r -= alpha A p, z = Minv r; partial of r.z.
__device__ void pass_cg_update(int k, float lam, float alpha, Ctx& c) {
    const Work& w = c.w;
    const float* pk = w.pv[k & 1];
    float rz = 0.f;
    for (int ci = c.gw; ci < c.pb.C; ci += c.nw) {
        const int j = c.lane;
        const float fc = ld(w.free_c + ci);
        float rj = 0.f;
        if (j < 6) {
            const float pj = ld(pk + ci * 6 + j);
            const float apj =
                (tile_sum(ci, j, c) + (lam * ld(w.H + ci * 21 + diag6(j)) + 1e-8f) * pj) * fc;
            w.x[ci * 6 + j] = ld(w.x + ci * 6 + j) + alpha * pj;
            rj = ld(w.r + ci * 6 + j) - alpha * apj;
            w.r[ci * 6 + j] = rj;
        }
        const float zj = precond(w.Mi + ci * 36, rj, fc, j);
        if (j < 6) w.z[ci * 6 + j] = zj;
        rz += rj * zj;
    }
    cta_partial(rz, R_RZ, c);
}

// Back-substitution dp = -Hpp_d^-1 Jp^T w (r + Jc x) into Xn = X + dp; owner
// warps retract the free poses into Tn.
__device__ void pass_step(const float* T, float* Tn, const float* X, float* Xn, Ctx& c) {
    const Problem& pb = c.pb;
    const Work& w = c.w;
    for (int ci = c.gw; ci < pb.C; ci += c.nw)
        if (c.lane == 0) {
            float Tc[12], Tq[12], xi[6];
            load_T(T + ci * 12, Tc);
            if (ld(w.free_c + ci) == 0.f) {
                for (int e = 0; e < 12; ++e) Tq[e] = Tc[e];
            } else {
                for (int q = 0; q < 6; ++q) xi[q] = ld(w.x + ci * 6 + q);
                retract(xi, Tc, Tq);
            }
            for (int e = 0; e < 12; ++e) Tn[ci * 12 + e] = Tq[e];
        }
    for (int p = c.gt; p < pb.P; p += c.nt) {
        float y[3] = {0.f, 0.f, 0.f};
        for (int kk = 0; kk < pb.K; ++kk) {
            if (!pb.pm_ok[p * pb.K + kk]) continue;
            const int o = pb.pm_src[p * pb.K + kk];
            if (ld(w.wa + o) == 0.f) continue;
            const int ci = o / pb.Fb;
            float Rr[12];
            load_T(T + ci * 12, Rr);
            ObsJ j;
            obs_jac(o, Rr, c, j);
            float vv[6], m[3], t[3];
#pragma unroll
            for (int q = 0; q < 6; ++q) vv[q] = ld(w.x + ci * 6 + q);
            jc_dot(j, vv, m);
            m[0] += ld(w.r0 + o);
            m[1] += ld(w.r1 + o);
            m[2] += ld(w.r2 + o);
            jp_t(j, m, t);
            y[0] += t[0];
            y[1] += t[1];
            y[2] += t[2];
        }
        float s[3] = {0.f, 0.f, 0.f};
        if (!pb.point_fixed[p]) solve3(w.L + p * 6, y, s);
        for (int i = 0; i < 3; ++i) Xn[p * 3 + i] = ld(X + p * 3 + i) - s[i];
    }
}

__global__ void __launch_bounds__(THREADS, 2) optimize_kernel(Problem pb, Cam cam, Work work,
                                                           int n_chunks, int n_iters,
                                                           int cg_iters, int huber_iters,
                                                           float* Tcw_out, float* X_out,
                                                           bool* inlier_out, float* cost_out,
                                                           int* trace) {
    __shared__ float s_red[WARPS];
    __shared__ float s_bc;
    cg::grid_group grid = cg::this_grid();
    Ctx c;
    c.pb = pb;
    c.cam = cam;
    c.w = work;
    c.n_chunks = n_chunks;
    c.n_tiles = pb.C * n_chunks;
    c.lane = threadIdx.x & 31;
    c.warp = threadIdx.x >> 5;
    c.gw = blockIdx.x * WARPS + c.warp;
    c.nw = gridDim.x * WARPS;
    c.gt = blockIdx.x * THREADS + threadIdx.x;
    c.nt = gridDim.x * THREADS;
    c.s_red = s_red;
    c.s_bc = &s_bc;
    const Work& w = work;
    const int C = pb.C, O = pb.C * pb.Fb;

    for (int ci = c.gw; ci < C; ci += c.nw) {
        const int k = c.lane;
        if (k < 12)
            w.T[0][ci * 12 + k] =
                k < 9 ? pb.Tcw[ci * 16 + (k / 3) * 4 + k % 3] : pb.Tcw[ci * 16 + (k - 9) * 4 + 3];
        if (k < 6) w.dc[ci * 6 + k] = 0.f;
        if (k == 0) w.free_c[ci] = pb.pose_fixed[ci] ? 0.f : 1.f;
    }
    for (int o = c.gt; o < O; o += c.nt) w.act[o] = pb.active[o];
    grid.sync();

    int ti = 0, reclass = 0;
    const float* X = pb.X;  // the current points: pb.X until a step is accepted
    float lam = 1e-4f;
    for (int it = 0; it < n_iters; ++it) {
        const bool huber = it < huber_iters;
        const float* T = w.T[ti];
        const int cost_slot = R_COST_OLD0 + (it & 1);
        pass_linearize(huber, reclass, T, X, cost_slot, c);
        reclass = 0;
        grid.sync();
        pass_factor(lam, T, c);
        grid.sync();
        pass_rhs(T, c);
        grid.sync();
        pass_warm_dots(lam, c);
        grid.sync();
        const float threshold = CG_TOL2 * grid_total(R_THR, c);
        const float a0 = grid_total(R_BAD, c) / fmaxf(grid_total(R_ADAD, c), 1e-20f);
        pass_warm_start(a0, c);
        grid.sync();
        float rz = grid_total(R_RZ, c), beta = 0.f;
        int k = 0;
        while (k < cg_iters && rz > threshold) {
            pass_cg_points(k, beta, T, c);
            grid.sync();
            pass_cg_cameras(k, lam, T, c);
            grid.sync();
            const float pAp = grid_total(R_PAP, c);
            const float alpha = rz / (fabsf(pAp) < 1e-20f ? 1e-20f : pAp);
            pass_cg_update(k, lam, alpha, c);
            grid.sync();
            const float rz_new = grid_total(R_RZ, c);
            beta = rz_new / (fabsf(rz) < 1e-20f ? 1e-20f : rz);
            rz = rz_new;
            ++k;
        }
        float* Xn = X == X_out ? w.Xw : X_out;
        pass_step(T, w.T[ti ^ 1], X, Xn, c);
        grid.sync();
        pass_evaluate(w.T[ti ^ 1], Xn, huber, 0, nullptr, R_COST_NEW, c);
        grid.sync();
        const float cost_new = grid_total(R_COST_NEW, c);
        const bool accept = cost_new < grid_total(cost_slot, c);
        lam = accept ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 5.0f, 1e3f);
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            trace[it * 2] = k;
            trace[it * 2 + 1] = accept ? 1 : 0;
        }
        if (accept) {
            ti ^= 1;
            X = Xn;
        }
        if (it == huber_iters - 1) reclass = accept ? 1 : 2;
        for (int ci = c.gw; ci < C; ci += c.nw)
            if (c.lane < 6) w.dc[ci * 6 + c.lane] = ld(w.x + ci * 6 + c.lane);
    }

    // Final chi2, inliers of the original active set, plain cost; the points
    // into X_out, the orthonormalized poses into Tcw_out.
    pass_evaluate(w.T[ti], X, false, reclass, inlier_out, R_COST_FINAL, c);
    if (X != X_out)
        for (int e = c.gt; e < pb.P * 3; e += c.nt) X_out[e] = ld(X + e);
    for (int ci = c.gw; ci < C; ci += c.nw)
        if (c.lane == 0) {
            float Tc[12], R[9], Rt[9], RtR[9], S[9];
            load_T(w.T[ti] + ci * 12, Tc);
            for (int e = 0; e < 9; ++e) R[e] = Tc[e];
            // orthonormalize_fast: R <- R (3I - R^T R) / 2, three times.
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
                To[i * 4 + 3] = Tc[9 + i];
            }
            To[12] = 0.f;
            To[13] = 0.f;
            To[14] = 0.f;
            To[15] = 1.f;
        }
    grid.sync();
    const float cost = grid_total(R_COST_FINAL, c);
    if (blockIdx.x == 0 && threadIdx.x == 0) *cost_out = cost;
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

// The cooperative grid: one CTA on each SM (at most MAX_GRID), or -1 when
// the card cannot launch it. Measured once per process.
static int coop_grid() {
    static int grid = 0;
    if (grid == 0) {
        int dev = 0, sms = 0, coop = 0, per_sm = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, optimize_kernel, THREADS, 0) !=
                cudaSuccess ||
            !coop || per_sm < 1)
            return -1;
        grid = sms < MAX_GRID ? sms : MAX_GRID;
    }
    return grid;
}

// Floats of ba_optimize's scratch_f for a problem.
static size_t optimize_scratch(int C, int Fb, int P) {
    const size_t n_tiles = (size_t)C * ((Fb + TILE - 1) / TILE);
    return 10 * (size_t)C * Fb + 15 * (size_t)P + 136 * (size_t)C + NPART * n_tiles +
           (size_t)N_SLOT * MAX_GRID;
}

// The whole LM loop of `optimize` in one cooperative launch. scratch_f:
// scratch_floats >= 10 C Fb + 15 P + 136 C + 21 C ceil(Fb / 64) + 9 x 1024
// floats; scratch_b: C Fb bytes; trace: [n_iters, 2] ints (CG iterations,
// accepted). Fails (no launch) when the card cannot hold the grid at once.
C_ENTRY int ba_optimize(const float* Tcw, const bool* pose_fixed, const float* X,
                        const bool* point_fixed, const int* obs_mp, const float* obs_uvr,
                        const float* inv_s2, const bool* stereo, const bool* active,
                        const int* pm_src, const bool* pm_ok, int C, int Fb, int P, int K,
                        int n_iters, int cg_iters, int huber_iters, float fx, float fy, float cx,
                        float cy, float bf, float* scratch_f, int scratch_floats,
                        unsigned char* scratch_b, float* Tcw_out, float* X_out, bool* inlier_out,
                        float* cost_out, int* trace, cudaStream_t stream) {
    const int grid = coop_grid();
    if (grid < 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (optimize_scratch(C, Fb, P) > (size_t)scratch_floats) return (int)cudaErrorInvalidValue;
    const Problem pb{Tcw, pose_fixed, X, point_fixed, obs_mp, obs_uvr, inv_s2, stereo, active,
                     pm_src, pm_ok, C, Fb, P, K};
    const int n_chunks = (Fb + TILE - 1) / TILE;
    const size_t O = (size_t)C * Fb;
    float* f = scratch_f;
    auto take = [&f](size_t n) {
        float* q = f;
        f += n;
        return q;
    };
    Work w;
    w.px = take(O);
    w.py = take(O);
    w.pz = take(O);
    w.wa = take(O);
    w.ws = take(O);
    w.r0 = take(O);
    w.r1 = take(O);
    w.r2 = take(O);
    w.c2o = take(O);
    w.c2n = take(O);
    w.L = take((size_t)P * 6);
    w.zp = take((size_t)P * 3);
    w.zv = take((size_t)P * 3);
    w.Xw = take((size_t)P * 3);
    w.T[0] = take((size_t)C * 12);
    w.T[1] = take((size_t)C * 12);
    w.H = take((size_t)C * 21);
    w.Mi = take((size_t)C * 36);
    w.x = take((size_t)C * 6);
    w.r = take((size_t)C * 6);
    w.z = take((size_t)C * 6);
    w.b = take((size_t)C * 6);
    w.dc = take((size_t)C * 6);
    w.v = take((size_t)C * 6);
    w.Ap = take((size_t)C * 6);
    w.pv[0] = take((size_t)C * 6);
    w.pv[1] = take((size_t)C * 6);
    w.free_c = take(C);
    w.part = take((size_t)C * n_chunks * NPART);
    w.red = take((size_t)N_SLOT * MAX_GRID);
    w.act = scratch_b;
    const Cam cam{fx, fy, cx, cy, bf};
    void* args[] = {(void*)&pb,         (void*)&cam,    (void*)&w,         (void*)&n_chunks,
                    (void*)&n_iters,    (void*)&cg_iters, (void*)&huber_iters, (void*)&Tcw_out,
                    (void*)&X_out,      (void*)&inlier_out, (void*)&cost_out, (void*)&trace};
    return (int)cudaLaunchCooperativeKernel((const void*)optimize_kernel, dim3(grid),
                                            dim3(THREADS), args, 0, stream);
}
