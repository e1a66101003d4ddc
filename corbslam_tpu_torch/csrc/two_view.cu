// K12 `two_view`: the monocular two-view bootstrap — parallel F / H RANSAC,
// refit, model choice and reconstruction — in one launch, with no host sync.
//
// Replaces corbslam_tpu/solvers/initializer.py initialize_two_view with
// _normalize, _eight_point_F, _dlt_H, _score_F, _score_H and _check_rt, and
// the geometry/linalg3.py spectral ops they run (eigh3x3, svd3x3,
// smallest_eigvec_sym; here `linalg3.cuh` and the warp LU below): the
// reference solves every hypothesis of both models as batched 9x9 systems
// and verifies all 12 reconstruction candidates as one vmapped program.
//
// Bound on the H100: operations, and latency more than either. 2 x 256
// hypotheses each need a 9x9 normal matrix, an LU and 12 solves, and for F
// an SVD (a few thousand dependent flops), then a score over N <= 4096
// matches (~40 flops each): ~25 MFLOP with ~50 KB of inputs; after them,
// one refit of each model (the same chain again), the candidates and
// CheckRT.
// Design: one launch an attempt of 512-thread CTAs, 2 hypotheses a CTA
// (128 CTAs for 256: one wave). Every CTA stages the matches in shared
// memory and redoes the normalization in the order of the earlier
// 1024-thread kernel (each thread two of its columns, their warp trees,
// the 32 warp sums in order), so no CTA waits for another. Warps 0-3 each
// solve one (hypothesis, model): the normal matrix's entries by the lanes,
// the LU with partial pivoting a row a lane (the pivot by every lane's
// scan: the upper row on ties), 12 solves on every lane, svd3x3 and the
// denormalization. Then all 512 threads score the CTA's 4 models, summing
// as the earlier 256-thread score reduction did (each thread two of its
// columns). An atomicMax of the 64-bit key score bits << 32 | ~h a model
// gives the first maximum (scores are >= 0, so their bits order them); the
// last CTA by an atomic ticket (a per-stream workspace it sets back to 0)
// refits both winners over their inliers (the 45 sums in the earlier
// refit kernel's order: a model's 256 columns on 8 warps, shfl_xor halving
// in the pairs of its shfl_down trees), solves and rescores them, makes
// only the chosen model's candidates (E = K^T F K: 4; the Faugeras
// decomposition of K^-1 H K: 8; R * sign(det R) kept even where det R is
// 0), counts each one's good inliers with exact integer sums, takes the
// best and the runner-up, and writes the points and flags of the best
// alone. The sample is an input ([256, 8] match indices).

#include <math.h>

#include "common.cuh"
#include "linalg3.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int HPC = 2;         // hypotheses a CTA; warp w solves hypothesis w & 1 of model w >> 1
constexpr int NORM_COLS = 1024;  // the normalization's columns: two a thread
constexpr int COLS = 256;        // the score and refit sums' columns
static_assert(NORM_COLS == 2 * THREADS && COLS == THREADS / 2, "two columns a thread");
constexpr int TV_MAX_N = 4096;  // 39 bytes of every match in shared memory
constexpr float CHI2_F = 3.841f;
constexpr float CHI2_H = 5.991f;
constexpr float SCORE_TH = 5.991f;
constexpr int NS = 8;     // matches per hypothesis
constexpr int MS = 18;    // floats per stored model: M, then M^-1 (H)
constexpr int NSYM = 45;  // upper triangle of a 9x9
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
    float fx, fy, cx, cy;
};

struct TvArgs {
    const float2* xy1;
    const float2* xy2;
    const bool* valid;
    int N;
    const int* sample;  // [H, 8]
    int H;
    float inv_s2;
    int min_triangulated;
    Cam c;
    unsigned long long* work;  // [best F key, best H key, CTA ticket]: 0 on entry and on exit
    float* models;             // [2, H, 18] F then H hypotheses
    float* scores;             // [2, H]
    float* score_fh;           // [2] the refit models' scores (F, H)
    int* out_i;  // ok, used_H, n_good, best candidate, the chosen model's inliers, best F, best H
    float* R;
    float* t;
    float* X;     // [N, 3]
    bool* good;   // [N]
};

// T = [[s0, 0, -m0 s0], [0, s1, -m1 s1], [0, 0, 1]] from (m0, m1, s0, s1).
__device__ __forceinline__ void norm_matrix(const float* p, float* T) {
    T[0] = p[2]; T[1] = 0.f; T[2] = -p[0] * p[2];
    T[3] = 0.f; T[4] = p[3]; T[5] = -p[1] * p[3];
    T[6] = 0.f; T[7] = 0.f; T[8] = 1.f;
}

// One match's rows of the design matrix: F 1 row, H 2 rows.
__device__ __forceinline__ void design_rows(int model, float u1, float v1, float u2, float v2,
                                            float* r1, float* r2) {
    if (model == 0) {
        const float a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
        for (int i = 0; i < 9; ++i) r1[i] = a[i];
    } else {
        const float a[9] = {0.f, 0.f, 0.f, -u1, -v1, -1.f, v2 * u1, v2 * v1, v2};
        const float b[9] = {u1, v1, 1.f, 0.f, 0.f, 0.f, -u2 * u1, -u2 * v1, -u2};
        for (int i = 0; i < 9; ++i) {
            r1[i] = a[i];
            r2[i] = b[i];
        }
    }
}

// CheckFundamental / CheckHomography for one match: the score term and the
// inlier flag (valid is applied by the caller).
__device__ __forceinline__ float score_one(int model, const float* Mdl, float x1, float y1,
                                           float x2, float y2, float inv_s2, bool& inl) {
    float c1, c2, chi;
    if (model == 0) {
        const float* F = Mdl;
        const float l2[3] = {F[0] * x1 + F[1] * y1 + F[2], F[3] * x1 + F[4] * y1 + F[5],
                             F[6] * x1 + F[7] * y1 + F[8]};
        const float l1[3] = {F[0] * x2 + F[3] * y2 + F[6], F[1] * x2 + F[4] * y2 + F[7],
                             F[2] * x2 + F[5] * y2 + F[8]};
        const float n2 = l2[0] * x2 + l2[1] * y2 + l2[2];
        const float n1 = l1[0] * x1 + l1[1] * y1 + l1[2];
        c2 = n2 * n2 / fmaxf(l2[0] * l2[0] + l2[1] * l2[1], 1e-12f) * inv_s2;
        c1 = n1 * n1 / fmaxf(l1[0] * l1[0] + l1[1] * l1[1], 1e-12f) * inv_s2;
        chi = CHI2_F;
    } else {
        const float* H = Mdl;
        const float* Hi = Mdl + 9;
        float qx = H[0] * x1 + H[1] * y1 + H[2], qy = H[3] * x1 + H[4] * y1 + H[5];
        float qz = H[6] * x1 + H[7] * y1 + H[8];
        qz = fabsf(qz) < 1e-12f ? 1e-12f : qz;
        const float ex2 = qx / qz - x2, ey2 = qy / qz - y2;
        qx = Hi[0] * x2 + Hi[1] * y2 + Hi[2];
        qy = Hi[3] * x2 + Hi[4] * y2 + Hi[5];
        qz = Hi[6] * x2 + Hi[7] * y2 + Hi[8];
        qz = fabsf(qz) < 1e-12f ? 1e-12f : qz;
        const float ex1 = qx / qz - x1, ey1 = qy / qz - y1;
        c2 = (ex2 * ex2 + ey2 * ey2) * inv_s2;
        c1 = (ex1 * ex1 + ey1 * ey1) * inv_s2;
        chi = CHI2_H;
    }
    inl = c1 < chi && c2 < chi;
    return (c1 < chi ? SCORE_TH - c1 : 0.f) + (c2 < chi ? SCORE_TH - c2 : 0.f);
}

// A warp's scratch for one model solve.
struct Solve {
    float M[81];         // the normal matrix, then its LU factors
    float rows[2 * NS][9];  // the design rows of the sample
    float v[9];          // the inverse iteration's vector
    int perm[9];
    float out[MS];       // the model
};

// smallest_eigvec_sym<9> of s.M on one warp (lane i < 9 row i of the
// elimination; the pivot search, the 12 solves and the norms on every lane,
// in lu_factor's and lu_solve's order), then solve_model's rank-2 projection
// (F) or inverse (H) and denormalization by T1, T2 (`tp`): the model in
// s.out. Every lane of the warp calls it.
__device__ __forceinline__ void solve_model_warp(int model, Solve& s, const float* tp, int lane) {
    float tr = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) tr += s.M[10 * i];
    const float eps = 1e-9f * tr + 1e-30f;
    __syncwarp();
    if (lane < 9) {
        s.M[10 * lane] += eps;
        s.perm[lane] = lane;
        s.v[lane] = 1.f;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        int piv = k;
        float big = fabsf(s.M[k * 9 + k]);
#pragma unroll
        for (int i = k + 1; i < 9; ++i)
            if (fabsf(s.M[i * 9 + k]) > big) {
                big = fabsf(s.M[i * 9 + k]);
                piv = i;
            }
        __syncwarp();
        if (piv != k) {
            if (lane < 9) {
                const float t = s.M[k * 9 + lane];
                s.M[k * 9 + lane] = s.M[piv * 9 + lane];
                s.M[piv * 9 + lane] = t;
            }
            if (lane == 0) {
                const int t = s.perm[k];
                s.perm[k] = s.perm[piv];
                s.perm[piv] = t;
            }
            __syncwarp();
        }
        if (lane > k && lane < 9) {
            const float d = s.M[k * 9 + k];
            const float l = s.M[lane * 9 + k] / d;
            s.M[lane * 9 + k] = l;
#pragma unroll
            for (int j = k + 1; j < 9; ++j) s.M[lane * 9 + j] -= l * s.M[k * 9 + j];
        }
        __syncwarp();
    }
    // The 12 solves (lu_solve), the upper factor in registers.
    float LU[81];
    int perm[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = i; j < 9; ++j) LU[i * 9 + j] = s.M[i * 9 + j];
#pragma unroll
    for (int i = 0; i < 9; ++i) perm[i] = s.perm[i];
    float x[9];
#pragma unroll 1
    for (int it = 0; it < 12; ++it) {
        float y[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
            float a = s.v[perm[i]];
#pragma unroll
            for (int j = 0; j < i; ++j) a -= s.M[i * 9 + j] * y[j];
            y[i] = a;
        }
#pragma unroll
        for (int i = 8; i >= 0; --i) {
            float a = y[i];
#pragma unroll
            for (int j = i + 1; j < 9; ++j) a -= LU[i * 9 + j] * x[j];
            x[i] = a / LU[i * 9 + i];
        }
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 9; ++i) q += x[i] * x[i];
        const float d = fmaxf(sqrtf(q), 1e-30f);
#pragma unroll
        for (int i = 0; i < 9; ++i) x[i] = x[i] / d;
        __syncwarp();
        if (lane == 0)
#pragma unroll
            for (int i = 0; i < 9; ++i) s.v[i] = x[i];
        __syncwarp();
    }
    // solve_model's tail on the eigenvector f = x.
    float T1[9], T2[9], tmp[9], out[MS];
    norm_matrix(tp, T1);
    norm_matrix(tp + 4, T2);
    if (model == 0) {
        float U[9], sv[3], V[9];
        svd3x3(x, U, sv, V);
        const float u3[3] = {U[2], U[5], U[8]}, v3[3] = {V[2], V[5], V[8]};
        float sig3 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) sig3 += u3[i] * x[3 * i + j] * v3[j];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) x[3 * i + j] -= sig3 * u3[i] * v3[j];
        matmul3_tn(T2, x, tmp);
        matmul3(tmp, T1, out);
#pragma unroll
        for (int k = 9; k < MS; ++k) out[k] = 0.f;
    } else {
        float T2inv[9], Hb[9];
        inv3(T2, T2inv);
        matmul3(T2inv, x, tmp);
        matmul3(tmp, T1, out);
#pragma unroll
        for (int k = 0; k < 9; ++k) Hb[k] = out[k];
        Hb[0] += 1e-12f;
        Hb[4] += 1e-12f;
        Hb[8] += 1e-12f;
        inv3(Hb, out + 9);
    }
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < MS; ++k) s.out[k] = out[k];
    __syncwarp();
}

// block_sum's warp tree (shfl_down, lane 0's result).
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    return v;
}

// One halving step of a warp reduction of NV values a lane (as ransac.cu's):
// after the steps for bits 16, 8, 4, 2, 1 lane l holds value l's warp sum,
// added in the pairs of a shfl_down tree.
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

__device__ __forceinline__ float sign_of(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ void cand_origin(const float* R, const float* t, float* o2) {
    o2[0] = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
    o2[1] = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
    o2[2] = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
}

// Candidate i (lane i < 4 for F, < 8 for H) of the refit model, t
// normalized, into cand[i][0..11] (R row-major, t) and cand[i][12..14]
// (o2 = -R^T t): E = K^T F K's (R * sign(det R) for both W and W^T, t = +-u3)
// or the Faugeras decomposition of K^-1 H K. Every lane computes the SVD.
__device__ __forceinline__ void candidate(int model, const float* Mdl, const Cam& c, int i,
                                          float* cand) {
    const float K[9] = {c.fx, 0.f, c.cx, 0.f, c.fy, c.cy, 0.f, 0.f, 1.f};
    float tmp[9], A[9], U[9], s[3], V[9], R[9], ts[3];
    if (model == 0) {
        matmul3_tn(K, Mdl, tmp);
        matmul3(tmp, K, A);
        svd3x3(A, U, s, V);
        const float W[9] = {0.f, -1.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 1.f};
        const float Wt[9] = {0.f, 1.f, 0.f, -1.f, 0.f, 0.f, 0.f, 0.f, 1.f};
        float Ra[9], Rb[9];
        matmul3(U, W, tmp);
        matmul3_nt(tmp, V, Ra);
        matmul3(U, Wt, tmp);
        matmul3_nt(tmp, V, Rb);
        const float sa = sign_of(det3(Ra)), sb = sign_of(det3(Rb));
        float tu[3] = {U[2], U[5], U[8]};
        const float nt = fmaxf(norm3(tu), 1e-12f);
#pragma unroll
        for (int k = 0; k < 3; ++k) tu[k] /= nt;
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = i < 2 ? Ra[k] * sa : Rb[k] * sb;
#pragma unroll
        for (int k = 0; k < 3; ++k) ts[k] = (i & 1) ? -tu[k] : tu[k];
    } else {
        float Kinv[9];
        inv3(K, Kinv);
        matmul3(Kinv, Mdl, tmp);
        matmul3(tmp, K, A);
        svd3x3(A, U, s, V);
        const float sdet = det3(U) * det3(V);
        const float d1 = s[0], d2 = s[1], d3 = s[2];
        const float denom13 = fmaxf(d1 * d1 - d3 * d3, 1e-12f);
        const float aux1 = sqrtf(fmaxf(d1 * d1 - d2 * d2, 0.f) / denom13);
        const float aux3 = sqrtf(fmaxf(d2 * d2 - d3 * d3, 0.f) / denom13);
        const float root = sqrtf(fmaxf((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.f));
        const float st = root / fmaxf((d1 + d3) * d2, 1e-12f);
        const float ct = (d2 * d2 + d1 * d3) / fmaxf((d1 + d3) * d2, 1e-12f);
        const float sp = root / fmaxf((d1 - d3) * d2, 1e-12f);
        const float cp = (d1 * d3 - d2 * d2) / fmaxf((d1 - d3) * d2, 1e-12f);
        const int e = i & 3;
        const float x1s = e < 2 ? aux1 : -aux1;  // {aux1, aux1, -aux1, -aux1}[e]
        const float sg = (e & 1) ? -1.f : 1.f;   // {1, -1, 1, -1}[e]
        const float x3s = sg * aux3;
        float Rp[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float tp[3];
        if (i < 4) {  // d' = +d2
            Rp[0] = ct; Rp[4] = 1.f; Rp[8] = ct; Rp[2] = -sg * st; Rp[6] = sg * st;
            tp[0] = x1s * (d1 - d3); tp[1] = 0.f * (d1 - d3); tp[2] = -x3s * (d1 - d3);
        } else {      // d' = -d2
            Rp[0] = cp; Rp[4] = -1.f; Rp[8] = -cp; Rp[2] = sg * sp; Rp[6] = sg * sp;
            tp[0] = x1s * (d1 + d3); tp[1] = 0.f * (d1 + d3); tp[2] = x3s * (d1 + d3);
        }
        float UR[9], Rr[9];
        matmul3(U, Rp, UR);
        matmul3_nt(UR, V, Rr);
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = sdet * Rr[k];
#pragma unroll
        for (int r = 0; r < 3; ++r)
            ts[r] = U[3 * r] * tp[0] + U[3 * r + 1] * tp[1] + U[3 * r + 2] * tp[2];
    }
    const float nt = fmaxf(norm3(ts), 1e-12f);
#pragma unroll
    for (int k = 0; k < 9; ++k) cand[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) cand[9 + k] = ts[k] / nt;
    cand_origin(cand, cand + 9, cand + 12);
}

// CheckRT of one match under candidate (R, t) with o2 = -R^T t: the
// midpoint triangulation X and whether it passes the gates (`inl` is the
// match's inlier flag). `ray` holds ((x1 - cx) / fx, (y1 - cy) / fy,
// (x2 - cx) / fx, (y2 - cy) / fy).
__device__ __forceinline__ bool check_one(const float* R, const float* t, const float* o2,
                                          float4 ray, float2 p1, float2 p2, bool inl,
                                          float inv_s2, const Cam& c, float* X) {
    const float d1[3] = {ray.x, ray.y, 1.f};
    const float dc[3] = {ray.z, ray.w, 1.f};
    float d2[3];
    for (int k = 0; k < 3; ++k) d2[k] = R[k] * dc[0] + R[3 + k] * dc[1] + R[6 + k] * dc[2];
    const float a = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2];
    const float b = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2];
    const float cc = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2];
    const float e = d1[0] * o2[0] + d1[1] * o2[1] + d1[2] * o2[2];
    const float f = d2[0] * o2[0] + d2[1] * o2[1] + d2[2] * o2[2];
    float den = a * cc - b * b;
    den = fabsf(den) < 1e-12f ? 1e-12f : den;
    const float s1 = (cc * e - b * f) / den, s2 = (b * e - a * f) / den;
    float p2c[3], r2[3];
    for (int k = 0; k < 3; ++k) X[k] = 0.5f * (s1 * d1[k] + (o2[k] + s2 * d2[k]));
    for (int k = 0; k < 3; ++k) {
        p2c[k] = R[3 * k] * X[0] + R[3 * k + 1] * X[1] + R[3 * k + 2] * X[2] + t[k];
        r2[k] = X[k] - o2[k];
    }
    if (!(inl && X[2] > 0.f && p2c[2] > 0.f)) return false;  // the rest only for the gates
    const float cospar = (X[0] * r2[0] + X[1] * r2[1] + X[2] * r2[2]) /
                         fmaxf(norm3(X) * norm3(r2), 1e-12f);
    const float iz1 = 1.f / (fabsf(X[2]) < 1e-9f ? 1e-9f : X[2]);
    const float iz2 = 1.f / (fabsf(p2c[2]) < 1e-9f ? 1e-9f : p2c[2]);
    const float u1 = c.fx * X[0] * iz1 + c.cx - p1.x, v1 = c.fy * X[1] * iz1 + c.cy - p1.y;
    const float u2 = c.fx * p2c[0] * iz2 + c.cx - p2.x, v2 = c.fy * p2c[1] * iz2 + c.cy - p2.y;
    const float e1 = (u1 * u1 + v1 * v1) * inv_s2, e2 = (u2 * u2 + v2 * v2) * inv_s2;
    return inl && X[2] > 0.f && p2c[2] > 0.f && cospar < 0.99998f && e1 < 4.f && e2 < 4.f;
}


// The key of hypothesis h's score: its bits (>= 0 scores order as their
// bits), a NaN losing to every number except at h = 0, where the earlier
// scan `scores[h] > scores[b]` keeps it.
__device__ __forceinline__ unsigned long long score_key(float s, int h) {
    const unsigned bits =
        isnan(s) ? (h == 0 ? 0xffffffffu : 0u) : (s > 0.f ? __float_as_uint(s) : 0u);
    return ((unsigned long long)bits << 32) | (0xffffffffu - (unsigned)h);
}

__global__ void __launch_bounds__(THREADS, 1) two_view_kernel(TvArgs a) {
    // Dynamic: rays [N], inlier list [N] (last CTA), p1 [N], p2 [N], valid [N],
    // inlier flags [2][N] (last CTA).
    extern __shared__ float4 dyn[];
    const int N = a.N;
    float4* s_ray = dyn;
    float2* s_p1 = reinterpret_cast<float2*>(dyn + N);
    float2* s_p2 = s_p1 + N;
    int* s_list = reinterpret_cast<int*>(s_p2 + N);
    bool* s_valid = reinterpret_cast<bool*>(s_list + N);
    bool* s_inl = s_valid + N;
    __shared__ Solve s_solve[4];
    __shared__ float s_red[9][32];   // the normalization's 32 warp sums of each quantity
    __shared__ float s_tp[8];        // tparams: m1x, m1y, s1x, s1y, m2x, m2y, s2x, s2y
    __shared__ float s_part[2][8][NSYM];  // a model's 8 warp sums of each refit entry
    __shared__ float s_sc[4][8];     // a model's 8 warp sums of its score
    __shared__ float s_cand[8][15];  // R (row-major), t, o2 = -R^T t
    __shared__ int s_cnt[8], s_hyp[2], s_best, s_n_inl;
    __shared__ bool s_last, s_use_H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h0 = blockIdx.x * HPC;
    unsigned long long* stamps = a.work + 8;
    if (blockIdx.x == 0 && tid == 0) stamp(stamps, 0);

    // The normalization (tv_normalize's order: column v sums matches v,
    // v + 1024, ...; thread t holds columns t and t + 512), staging the
    // matches on the way.
    {
        float cnt[2] = {0.f, 0.f}, sum[2][4] = {};
        for (int base = 0; base < N; base += NORM_COLS)
#pragma unroll
            for (int c = 0; c < 2; ++c) {  // column tid + 512 c: matches base + tid + 512 c
                const int i = base + tid + THREADS * c;
                if (i >= N) continue;
                const float2 p = a.xy1[i], r = a.xy2[i];
                const bool v = a.valid[i];
                s_p1[i] = p;
                s_p2[i] = r;
                s_valid[i] = v;
                if (!v) continue;
                cnt[c] += 1.f;
                sum[c][0] += p.x;
                sum[c][1] += p.y;
                sum[c][2] += r.x;
                sum[c][3] += r.y;
            }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const float w0 = warp_tree(cnt[c]);
            float w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) w[k] = warp_tree(sum[c][k]);
            if (lane == 0) {
                s_red[0][warp + 16 * c] = w0;
#pragma unroll
                for (int k = 0; k < 4; ++k) s_red[1 + k][warp + 16 * c] = w[k];
            }
        }
        __syncthreads();
        float tot[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            tot[k] = 0.f;
            for (int w = 0; w < 32; ++w) tot[k] += s_red[k][w];
        }
        const float n = fmaxf(tot[0], 1.f);
        float mean[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) mean[k] = tot[1 + k] / n;
        float dev[2][4] = {};
        for (int base = 0; base < N; base += NORM_COLS)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int i = base + tid + THREADS * c;
                if (i >= N || !s_valid[i]) continue;
                const float2 p = s_p1[i], r = s_p2[i];
                dev[c][0] += fabsf(p.x - mean[0]);
                dev[c][1] += fabsf(p.y - mean[1]);
                dev[c][2] += fabsf(r.x - mean[2]);
                dev[c][3] += fabsf(r.y - mean[3]);
            }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) w[k] = warp_tree(dev[c][k]);
            if (lane == 0)
#pragma unroll
                for (int k = 0; k < 4; ++k) s_red[5 + k][warp + 16 * c] = w[k];
        }
        __syncthreads();
        if (tid == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                float t = 0.f;
                for (int w = 0; w < 32; ++w) t += s_red[5 + k][w];
                s_tp[k + (k < 2 ? 0 : 2)] = mean[k];
                s_tp[k + (k < 2 ? 2 : 4)] = 1.f / fmaxf(t / n, 1e-9f);
            }
        }
        __syncthreads();
    }
    if (blockIdx.x == 0 && tid == 0) stamp(stamps, 1);

    // Warps 0-3: hypothesis h0 + (warp & 1) of model warp >> 1.
    if (warp < 4 && h0 + (warp & 1) < a.H) {
        const int h = h0 + (warp & 1), model = warp >> 1;
        Solve& s = s_solve[warp];
        if (lane < NS) {
            const int i = a.sample[h * NS + lane];
            const float2 p = s_p1[i], r = s_p2[i];
            float r1[9], r2[9];
            design_rows(model, (p.x - s_tp[0]) * s_tp[2], (p.y - s_tp[1]) * s_tp[3],
                        (r.x - s_tp[4]) * s_tp[6], (r.y - s_tp[5]) * s_tp[7], r1, r2);
#pragma unroll
            for (int q = 0; q < 9; ++q) s.rows[lane][q] = r1[q];
            if (model == 1)
#pragma unroll
                for (int q = 0; q < 9; ++q) s.rows[NS + lane][q] = r2[q];
        }
        __syncwarp();
        const int nr = model == 0 ? NS : 2 * NS;
        for (int e = lane; e < 81; e += 32) {
            const int p = e / 9, q = e % 9;
            float m = 0.f;
            for (int r = 0; r < nr; ++r) m += s.rows[r][p] * s.rows[r][q];
            s.M[e] = m;
        }
        __syncwarp();
        solve_model_warp(model, s, s_tp, lane);
        if (lane == 0) stamp(stamps, 2);
    }
    __syncthreads();
    // Every thread scores one model over two columns of the 256-thread
    // reduction (columns u and u + 128 of model tid >> 7).
    {
        const int m = tid >> 7, u = tid & 127, model = m >> 1;
        const int h = h0 + (m & 1);
        float sc[2] = {0.f, 0.f};
        if (h < a.H) {
            const float* Mdl = s_solve[m].out;
#pragma unroll
            for (int c = 0; c < 2; ++c)
                for (int i = u + 128 * c; i < N; i += COLS) {
                    bool inl;
                    const float2 p = s_p1[i], r = s_p2[i];
                    const float v = score_one(model, Mdl, p.x, p.y, r.x, r.y, a.inv_s2, inl);
                    if (s_valid[i]) sc[c] += v;
                }
        }
        const float w0 = warp_tree(sc[0]), w1 = warp_tree(sc[1]);
        if (lane == 0) {
            s_sc[m][u >> 5] = w0;
            s_sc[m][4 + (u >> 5)] = w1;
        }
        __syncthreads();
        if (tid < 4 && h0 + (tid & 1) < a.H) {
            const int hh = h0 + (tid & 1), mm = tid >> 1;
            float tot = 0.f;
            for (int w = 0; w < 8; ++w) tot += s_sc[tid][w];
            float* dst = a.models + ((size_t)mm * a.H + hh) * MS;
#pragma unroll
            for (int k = 0; k < MS; ++k) dst[k] = s_solve[tid].out[k];
            a.scores[mm * a.H + hh] = tot;
            atomicMax(&a.work[mm], score_key(tot, hh));
            __threadfence();
        }
    }
    if (tid == 0) stamp(stamps, 3);
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&a.work[2], 1ull) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;

    // The last CTA: both models' best hypotheses, refit and rescored.
    __threadfence();
    if (tid == 0) {
        stamp(stamps, 4);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
            s_hyp[mm] =
                (int)(0xffffffffu - (unsigned)(atomicExch(&a.work[mm], 0ull) & 0xffffffffu));
        atomicExch(&a.work[2], 0ull);
    }
    for (int i = tid; i < N; i += THREADS) {
        const float2 p = s_p1[i], r = s_p2[i];
        s_ray[i] = make_float4((p.x - a.c.cx) / a.c.fx, (p.y - a.c.cy) / a.c.fy,
                               (r.x - a.c.cx) / a.c.fx, (r.y - a.c.cy) / a.c.fy);
    }
    __syncthreads();
    if (tid < 2 * MS) {
        const int mm = tid / MS, k = tid % MS;
        s_solve[mm].out[k] = __ldcg(a.models + ((size_t)mm * a.H + s_hyp[mm]) * MS + k);
    }
    __syncthreads();
    // The normal matrix over the best hypothesis's inliers: tv_refit's
    // 256 columns of model tid >> 8, then their 8 warp sums.
    {
        const int model = tid >> 8, v = tid & 255;
        const float* Mdl = s_solve[model].out;
        float acc[NSYM];
#pragma unroll
        for (int k = 0; k < NSYM; ++k) acc[k] = 0.f;
        for (int i = v; i < N; i += COLS) {
            bool inl;
            const float2 p = s_p1[i], r = s_p2[i];
            score_one(model, Mdl, p.x, p.y, r.x, r.y, a.inv_s2, inl);
            if (!(inl && s_valid[i])) continue;
            float r1[9], r2[9];
            design_rows(model, (p.x - s_tp[0]) * s_tp[2], (p.y - s_tp[1]) * s_tp[3],
                        (r.x - s_tp[4]) * s_tp[6], (r.y - s_tp[5]) * s_tp[7], r1, r2);
            // tv_refit's acc[k] += r1[p] r1[q] + (model == 1 ? r2[p] r2[q] : 0): an
            // fma onto the selected product, then the add.
            int k = 0;
            if (model == 0) {
#pragma unroll
                for (int pp = 0; pp < 9; ++pp)
#pragma unroll
                    for (int q = pp; q < 9; ++q, ++k) acc[k] += __fmaf_rn(r1[pp], r1[q], 0.f);
            } else {
#pragma unroll
                for (int pp = 0; pp < 9; ++pp)
#pragma unroll
                    for (int q = pp; q < 9; ++q, ++k)
                        acc[k] += __fmaf_rn(r1[pp], r1[q], __fmul_rn(r2[pp], r2[q]));
            }
        }
        float hv[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) hv[k] = acc[k];
        halve<32>(hv, lane, 16);
        halve<16>(hv, lane, 8);
        halve<8>(hv, lane, 4);
        halve<4>(hv, lane, 2);
        halve<2>(hv, lane, 1);
        const int w = v >> 5;
        s_part[model][w][lane] = hv[0];
#pragma unroll
        for (int k = 32; k < NSYM; ++k) {
            const float x = warp_tree(acc[k]);
            if (lane == 0) s_part[model][w][k] = x;
        }
    }
    __syncthreads();
    if (warp < 2) {  // warp m refits model m
        Solve& s = s_solve[2 + warp];
        for (int k = lane; k < NSYM; k += 32) {
            int p = 0, r = k;
            while (r >= 9 - p) {
                r -= 9 - p;
                ++p;
            }
            const int q = p + r;
            float v = 0.f;
            for (int w = 0; w < 8; ++w) v += s_part[warp][w][k];
            s.M[9 * p + q] = v;
            s.M[9 * q + p] = v;
        }
        __syncwarp();
        if (lane == 0) stamp(stamps, 5);
        solve_model_warp(warp, s, s_tp, lane);
        if (lane == 0) stamp(stamps, 6);
    }
    __syncthreads();
    // The rescore with the refit models, their inlier masks.
    {
        const int model = tid >> 8, v = tid & 255;
        const float* Mdl = s_solve[2 + model].out;
        float sc = 0.f;
        for (int i = v; i < N; i += COLS) {
            bool inl;
            const float2 p = s_p1[i], r = s_p2[i];
            const float val = score_one(model, Mdl, p.x, p.y, r.x, r.y, a.inv_s2, inl);
            s_inl[model * N + i] = inl && s_valid[i];
            if (s_valid[i]) sc += val;
        }
        const float w = warp_tree(sc);
        if (lane == 0) s_sc[model][v >> 5] = w;
    }
    __syncthreads();
    if (tid == 0) stamp(stamps, 7);
    if (warp == 0) {
        float sf = 0.f, sh = 0.f;
        for (int w = 0; w < 8; ++w) {
            sf += s_sc[0][w];
            sh += s_sc[1][w];
        }
        const bool use_H = sh / fmaxf(sh + sf, 1e-9f) > 0.40f;
        if (lane < (use_H ? 8 : 4))
            candidate(use_H, s_solve[2 + use_H].out, a.c, lane, s_cand[lane]);
        if (lane == 0) {
            a.score_fh[0] = sf;
            a.score_fh[1] = sh;
            s_use_H = use_H;
            s_n_inl = 0;
        }
        if (lane < 8) s_cnt[lane] = 0;
    }
    __syncthreads();
    if (tid == 0) stamp(stamps, 8);
    // CheckRT: the chosen model's inliers listed (in any order: the counts
    // are exact integer sums), then each candidate's good ones.
    const bool use_H = s_use_H;
    const int nc = use_H ? 8 : 4;
    const bool* inl_m = s_inl + (use_H ? N : 0);
    for (int i0 = 0; i0 < N; i0 += THREADS) {
        const int i = i0 + tid;
        const bool f = i < N && inl_m[i];
        const unsigned m = __ballot_sync(FULL, f);
        int base = 0;
        if (lane == 0 && m) base = atomicAdd(&s_n_inl, __popc(m));
        base = __shfl_sync(FULL, base, 0);
        if (f) s_list[base + __popc(m & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    {
        const int n_inl = s_n_inl;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            if (c >= nc) break;
            int cnt = 0;
            for (int j = tid; j < n_inl; j += THREADS) {
                const int i = s_list[j];
                float X[3];
                cnt += check_one(s_cand[c], s_cand[c] + 9, s_cand[c] + 12, s_ray[i], s_p1[i],
                                 s_p2[i], true, a.inv_s2, a.c, X);
            }
            cnt = __reduce_add_sync(FULL, cnt);
            if (lane == 0 && cnt) atomicAdd(&s_cnt[c], cnt);
        }
    }
    __syncthreads();
    if (tid == 0) {
        stamp(stamps, 9);
        // tv_final: the first maximum of the 12 counts (-1 for the other
        // model's candidates), the runner-up, the acceptance test.
        int ng[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) ng[k] = ((k >= 4) == use_H) ? s_cnt[use_H ? k - 4 : k] : -1;
        int b = 0, nb = ng[0];
#pragma unroll
        for (int k = 1; k < 12; ++k)
            if (ng[k] > nb) {
                b = k;
                nb = ng[k];
            }
        int second = -1;
#pragma unroll
        for (int k = 0; k < 12; ++k)
            if (k != b) second = max(second, ng[k]);
        const bool ok = nb >= a.min_triangulated && (float)nb > 0.5f * (float)s_n_inl &&
                        0.75f * (float)nb > (float)max(second, 0);
        a.out_i[0] = ok;
        a.out_i[1] = use_H;
        a.out_i[2] = nb;
        a.out_i[3] = b;
        a.out_i[4] = s_n_inl;
        a.out_i[5] = s_hyp[0];
        a.out_i[6] = s_hyp[1];
        s_best = use_H ? b - 4 : b;
    }
    __syncthreads();
    // The best candidate's points and flags, every match.
    const float* Rb = s_cand[s_best];
    if (tid < 9) a.R[tid] = Rb[tid];
    if (tid < 3) a.t[tid] = Rb[9 + tid];
    for (int i = tid; i < N; i += THREADS) {
        float X[3];
        a.good[i] = check_one(Rb, Rb + 9, Rb + 12, s_ray[i], s_p1[i], s_p2[i], inl_m[i],
                              a.inv_s2, a.c, X);
#pragma unroll
        for (int k = 0; k < 3; ++k) a.X[3 * i + k] = X[k];
    }
    __syncthreads();
    if (tid == 0) stamp(stamps, 10);
}

}  // namespace

// One two-view attempt on N <= 4096 matches xy1, xy2 [N, 2] (valid [N]) from
// sample [H, 8]: out_i (ok, used_H, n_good, best, the chosen model's
// inliers, the best F and H hypotheses), R [3, 3], t [3], X [N, 3],
// good [N], score_fh (F, H). `work` holds 3 zero words between calls on a
// stream (24 with KERNEL_STAMPS); models [2, H, 18] and scores [2, H] are
// scratch.
C_ENTRY int two_view(const float* xy1, const float* xy2, const bool* valid, int N,
                     const int* sample, int H, float inv_s2, int min_triangulated, float fx,
                     float fy, float cx, float cy, unsigned long long* work, float* models,
                     float* scores, float* score_fh, int* out_i, float* R, float* t, float* X,
                     bool* good, cudaStream_t stream) {
    if (N < 0 || N > TV_MAX_N || H < 1) return (int)cudaErrorInvalidValue;
    const int smem = N * (16 + 8 + 8 + 4 + 1 + 2);
    static int attr = 0;
    if (smem > attr) {
        const cudaError_t err = cudaFuncSetAttribute(
            two_view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        attr = smem;
    }
    const TvArgs a{reinterpret_cast<const float2*>(xy1), reinterpret_cast<const float2*>(xy2),
                   valid, N, sample, H, inv_s2, min_triangulated, Cam{fx, fy, cx, cy}, work,
                   models, scores, score_fh, out_i, R, t, X, good};
    two_view_kernel<<<(H + HPC - 1) / HPC, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
