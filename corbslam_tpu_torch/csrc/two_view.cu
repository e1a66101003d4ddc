// K12 `two_view`: the monocular two-view bootstrap — parallel F / H RANSAC,
// refit, model choice and reconstruction — with no host sync.
//
// Replaces corbslam_tpu/solvers/initializer.py initialize_two_view with
// _normalize, _eight_point_F, _dlt_H, _score_F, _score_H and _check_rt, and
// the geometry/linalg3.py spectral ops they run (eigh3x3, svd3x3,
// smallest_eigvec_sym; here `linalg3.cuh`): the reference solves every
// hypothesis of both models as batched 9x9 systems and verifies all 12
// reconstruction candidates as one vmapped program.
//
// Bound on the H100: operations, and latency more than either. 2 x 256
// hypotheses each need a 9x9 normal matrix, an LU and 12 solves, and for F
// an SVD (a few thousand dependent flops on one thread), then a score over
// N <= 2048 matches (~40 flops each): ~25 MFLOP with ~50 KB of inputs.
// Design: `tv_normalize` is one CTA (fixed-order block sums of the
// normalization). `tv_hypotheses` is one 256-thread CTA per (hypothesis,
// model): thread 0 builds the normal matrix from the 8 sampled matches
// (F: 8 rows; H: all 8 matches, a 16-row DLT, as the reference slices
// x1n[idx, :4] along the coordinate axis), runs inverse iteration with an LU
// with partial pivoting (jnp.linalg.solve's factorization), projects F to
// rank 2 through svd3x3 and denormalizes (H: its inverse too); the CTA then
// scores every match with a fixed-order block reduction. `tv_refit` is one
// CTA per model: the first maximum of the scores (jnp.argmax), that
// hypothesis's inliers, the 9x9 normal matrix over all of them (a fixed-order
// block reduction of its 45 entries), the refit, the rescore with the final
// inlier mask, and the model's reconstruction candidates (svd3x3 of E = K^T F
// K: 4; the Faugeras decomposition of K^-1 H K: 8; R * sign(det R) kept even
// where det R is 0). `tv_check` is one CTA per candidate: the choice
// RH = SH / (SH + SF) > 0.40, then, for the chosen model's candidates, the
// midpoint triangulation and CheckRT's gates over every inlier and the
// count; the other model's candidates count -1. `tv_final` is one CTA: the
// first maximum of the counts, the runner-up, the acceptance test and the
// outputs. The sample is an input ([256, 8] match indices).

#include <math.h>

#include "common.cuh"
#include "linalg3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float CHI2_F = 3.841f;
constexpr float CHI2_H = 5.991f;
constexpr float SCORE_TH = 5.991f;
constexpr int NS = 8;    // matches per hypothesis
constexpr int MS = 18;   // floats per stored model: M, then M^-1 (H)
constexpr int NSYM = 45;  // upper triangle of a 9x9

struct Cam {
    float fx, fy, cx, cy;
};

// Fixed-order block sum (warp shuffles, then warp partials in order).
template <class T> __device__ T block_sum(T v, T* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    T r = T(0);
    for (int k = 0; k < nw; ++k) r += sh[k];
    __syncthreads();
    return r;
}

// T = [[s0, 0, -m0 s0], [0, s1, -m1 s1], [0, 0, 1]] from (m0, m1, s0, s1).
__device__ void norm_matrix(const float* p, float* T) {
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

// The model from its normal matrix M (9x9, overwritten): F projected to
// rank 2, both denormalized (x2^T F x1 = 0 / x2 ~ H x1); out[9..17] = H^-1.
__device__ void solve_model(int model, float* M, const float* tparams, float* out) {
    float f[9], T1[9], T2[9], tmp[9];
    smallest_eigvec_sym<9>(M, f);
    norm_matrix(tparams, T1);
    norm_matrix(tparams + 4, T2);
    if (model == 0) {
        float U[9], s[3], V[9];
        svd3x3(f, U, s, V);
        const float u3[3] = {U[2], U[5], U[8]}, v3[3] = {V[2], V[5], V[8]};
        float sig3 = 0.f;
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) sig3 += u3[i] * f[3 * i + j] * v3[j];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) f[3 * i + j] -= sig3 * u3[i] * v3[j];
        matmul3_tn(T2, f, tmp);
        matmul3(tmp, T1, out);
        for (int k = 9; k < MS; ++k) out[k] = 0.f;
    } else {
        float T2inv[9], Hb[9];
        inv3(T2, T2inv);
        matmul3(T2inv, f, tmp);
        matmul3(tmp, T1, out);
        for (int k = 0; k < 9; ++k) Hb[k] = out[k];
        Hb[0] += 1e-12f;
        Hb[4] += 1e-12f;
        Hb[8] += 1e-12f;
        inv3(Hb, out + 9);
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

__global__ void __launch_bounds__(1024) tv_normalize_kernel(
        const float2* __restrict__ xy1, const float2* __restrict__ xy2,
        const bool* __restrict__ valid, int N, float* __restrict__ tparams,
        float2* __restrict__ xn) {
    __shared__ float sh[32];
    __shared__ float mean[4];
    float c = 0.f, s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        if (!valid[i]) continue;
        c += 1.f;
        s[0] += xy1[i].x;
        s[1] += xy1[i].y;
        s[2] += xy2[i].x;
        s[3] += xy2[i].y;
    }
    const float n = fmaxf(block_sum(c, sh), 1.f);
    for (int k = 0; k < 4; ++k) {
        const float t = block_sum(s[k], sh);
        if (threadIdx.x == 0) mean[k] = t / n;
    }
    __syncthreads();
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        if (!valid[i]) continue;
        d[0] += fabsf(xy1[i].x - mean[0]);
        d[1] += fabsf(xy1[i].y - mean[1]);
        d[2] += fabsf(xy2[i].x - mean[2]);
        d[3] += fabsf(xy2[i].y - mean[3]);
    }
    __shared__ float scale[4];
    for (int k = 0; k < 4; ++k) {
        const float t = block_sum(d[k], sh);
        if (threadIdx.x == 0) scale[k] = 1.f / fmaxf(t / n, 1e-9f);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        tparams[0] = mean[0]; tparams[1] = mean[1]; tparams[2] = scale[0]; tparams[3] = scale[1];
        tparams[4] = mean[2]; tparams[5] = mean[3]; tparams[6] = scale[2]; tparams[7] = scale[3];
    }
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        xn[i] = make_float2((xy1[i].x - mean[0]) * scale[0], (xy1[i].y - mean[1]) * scale[1]);
        xn[N + i] = make_float2((xy2[i].x - mean[2]) * scale[2], (xy2[i].y - mean[3]) * scale[3]);
    }
}

__global__ void __launch_bounds__(THREADS) tv_hypotheses_kernel(
        const float2* __restrict__ xn, const float* __restrict__ tparams,
        const int* __restrict__ sample, int H, const float2* __restrict__ xy1,
        const float2* __restrict__ xy2, const bool* __restrict__ valid, int N, float inv_s2,
        float* __restrict__ models, float* __restrict__ scores) {
    __shared__ float mdl[MS];
    __shared__ float sh[32];
    const int h = blockIdx.x, model = blockIdx.y;
    if (threadIdx.x == 0) {
        float M[81];
        for (int k = 0; k < 81; ++k) M[k] = 0.f;
        float r1[9], r2[9];
        for (int pass = 0; pass < (model == 0 ? 1 : 2); ++pass)
            for (int k = 0; k < NS; ++k) {
                const int i = sample[h * NS + k];
                const float2 a = xn[i], b = xn[N + i];
                design_rows(model, a.x, a.y, b.x, b.y, r1, r2);
                const float* r = pass == 0 ? r1 : r2;
                for (int p = 0; p < 9; ++p)
                    for (int q = 0; q < 9; ++q) M[9 * p + q] += r[p] * r[q];
            }
        float out[MS];
        solve_model(model, M, tparams, out);
        for (int k = 0; k < MS; ++k) {
            mdl[k] = out[k];
            models[((size_t)model * H + h) * MS + k] = out[k];
        }
    }
    __syncthreads();
    float sc = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        bool inl;
        const float v = score_one(model, mdl, xy1[i].x, xy1[i].y, xy2[i].x, xy2[i].y, inv_s2, inl);
        if (valid[i]) sc += v;
    }
    const float tot = block_sum(sc, sh);
    if (threadIdx.x == 0) scores[model * H + h] = tot;
}

__device__ float sign_of(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

// The (R, t) candidates of the refit model, t normalized.
__device__ void candidates(int model, const float* Mdl, const Cam& c, float* cand) {
    const float K[9] = {c.fx, 0.f, c.cx, 0.f, c.fy, c.cy, 0.f, 0.f, 1.f};
    float tmp[9], A[9], U[9], s[3], V[9];
    float Rs[8][9], ts[8][3];
    int n;
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
        for (int i = 0; i < 3; ++i) tu[i] /= nt;
        for (int k = 0; k < 9; ++k) {
            Rs[0][k] = Rs[1][k] = Ra[k] * sa;
            Rs[2][k] = Rs[3][k] = Rb[k] * sb;
        }
        for (int i = 0; i < 3; ++i) {
            ts[0][i] = ts[2][i] = tu[i];
            ts[1][i] = ts[3][i] = -tu[i];
        }
        n = 4;
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
        const float x1s[4] = {aux1, aux1, -aux1, -aux1};
        const float sg[4] = {1.f, -1.f, 1.f, -1.f};
        for (int i = 0; i < 8; ++i) {
            const int e = i & 3;
            const bool pos = i < 4;
            const float x3s = sg[e] * aux3;
            float Rp[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            float tp[3];
            if (pos) {
                Rp[0] = ct; Rp[4] = 1.f; Rp[8] = ct; Rp[2] = -sg[e] * st; Rp[6] = sg[e] * st;
                tp[0] = x1s[e] * (d1 - d3); tp[1] = 0.f * (d1 - d3); tp[2] = -x3s * (d1 - d3);
            } else {
                Rp[0] = cp; Rp[4] = -1.f; Rp[8] = -cp; Rp[2] = sg[e] * sp; Rp[6] = sg[e] * sp;
                tp[0] = x1s[e] * (d1 + d3); tp[1] = 0.f * (d1 + d3); tp[2] = x3s * (d1 + d3);
            }
            float UR[9], R[9];
            matmul3(U, Rp, UR);
            matmul3_nt(UR, V, R);
            for (int k = 0; k < 9; ++k) Rs[i][k] = sdet * R[k];
            for (int r = 0; r < 3; ++r)
                ts[i][r] = U[3 * r] * tp[0] + U[3 * r + 1] * tp[1] + U[3 * r + 2] * tp[2];
        }
        n = 8;
    }
    for (int i = 0; i < n; ++i) {
        const float nt = fmaxf(norm3(ts[i]), 1e-12f);
        for (int k = 0; k < 9; ++k) cand[12 * i + k] = Rs[i][k];
        for (int k = 0; k < 3; ++k) cand[12 * i + 9 + k] = ts[i][k] / nt;
    }
}

__global__ void __launch_bounds__(THREADS) tv_refit_kernel(
        const float2* __restrict__ xn, const float* __restrict__ tparams,
        const float2* __restrict__ xy1, const float2* __restrict__ xy2,
        const bool* __restrict__ valid, int N, float inv_s2, const float* __restrict__ models,
        const float* __restrict__ scores, int H, Cam cam, float* __restrict__ score_fh,
        bool* __restrict__ inl_out, float* __restrict__ cand) {
    __shared__ float mdl[MS];
    __shared__ float part[THREADS / 32][NSYM];
    __shared__ float sh[32];
    __shared__ int s_best;
    const int model = blockIdx.x, lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
        int b = 0;
        for (int h = 1; h < H; ++h)
            if (scores[model * H + h] > scores[model * H + b]) b = h;
        s_best = b;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < MS; k += blockDim.x)
        mdl[k] = models[((size_t)model * H + s_best) * MS + k];
    __syncthreads();
    // Normal matrix over the best hypothesis's inliers.
    float acc[NSYM];
    for (int k = 0; k < NSYM; ++k) acc[k] = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        bool inl;
        score_one(model, mdl, xy1[i].x, xy1[i].y, xy2[i].x, xy2[i].y, inv_s2, inl);
        if (!(inl && valid[i])) continue;
        float r1[9], r2[9];
        const float2 a = xn[i], b = xn[N + i];
        design_rows(model, a.x, a.y, b.x, b.y, r1, r2);
        int k = 0;
        for (int p = 0; p < 9; ++p)
            for (int q = p; q < 9; ++q, ++k)
                acc[k] += r1[p] * r1[q] + (model == 1 ? r2[p] * r2[q] : 0.f);
    }
    for (int k = 0; k < NSYM; ++k) {
        float v = acc[k];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) part[wid][k] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float M[81];
        int k = 0;
        for (int p = 0; p < 9; ++p)
            for (int q = p; q < 9; ++q, ++k) {
                float v = 0.f;
                for (int w = 0; w < THREADS / 32; ++w) v += part[w][k];
                M[9 * p + q] = M[9 * q + p] = v;
            }
        float out[MS];
        solve_model(model, M, tparams, out);
        for (int j = 0; j < MS; ++j) mdl[j] = out[j];
    }
    __syncthreads();
    float sc = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        bool inl;
        const float v = score_one(model, mdl, xy1[i].x, xy1[i].y, xy2[i].x, xy2[i].y, inv_s2, inl);
        inl_out[(size_t)model * N + i] = inl && valid[i];
        if (valid[i]) sc += v;
    }
    const float tot = block_sum(sc, sh);
    if (threadIdx.x == 0) {
        score_fh[model] = tot;
        candidates(model, mdl, cam, cand + (model == 0 ? 0 : 4 * 12));
    }
}

__device__ __forceinline__ bool chose_H(const float* score_fh) {
    return score_fh[1] / fmaxf(score_fh[1] + score_fh[0], 1e-9f) > 0.40f;
}

__global__ void __launch_bounds__(THREADS) tv_check_kernel(
        const float2* __restrict__ xy1, const float2* __restrict__ xy2, int N, float inv_s2,
        Cam c, const float* __restrict__ score_fh, const bool* __restrict__ inl_all,
        const float* __restrict__ cand, int* __restrict__ n_good, bool* __restrict__ good,
        float* __restrict__ X_all) {
    __shared__ int sh[32];
    const int ci = blockIdx.x;
    const bool use_H = chose_H(score_fh);
    if ((ci >= 4) != use_H) {
        if (threadIdx.x == 0) n_good[ci] = -1;
        return;
    }
    const bool* inl = inl_all + (use_H ? N : 0);
    const float* R = cand + 12 * ci;
    const float* t = R + 9;
    const float o2[3] = {-(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]),
                         -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]),
                         -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2])};
    int cnt = 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const float d1[3] = {(xy1[i].x - c.cx) / c.fx, (xy1[i].y - c.cy) / c.fy, 1.f};
        const float dc[3] = {(xy2[i].x - c.cx) / c.fx, (xy2[i].y - c.cy) / c.fy, 1.f};
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
        float X[3], p2[3], r2[3];
        for (int k = 0; k < 3; ++k) X[k] = 0.5f * (s1 * d1[k] + (o2[k] + s2 * d2[k]));
        for (int k = 0; k < 3; ++k) {
            p2[k] = R[3 * k] * X[0] + R[3 * k + 1] * X[1] + R[3 * k + 2] * X[2] + t[k];
            r2[k] = X[k] - o2[k];
        }
        const float cospar = (X[0] * r2[0] + X[1] * r2[1] + X[2] * r2[2]) /
                             fmaxf(norm3(X) * norm3(r2), 1e-12f);
        const float iz1 = 1.f / (fabsf(X[2]) < 1e-9f ? 1e-9f : X[2]);
        const float iz2 = 1.f / (fabsf(p2[2]) < 1e-9f ? 1e-9f : p2[2]);
        const float u1 = c.fx * X[0] * iz1 + c.cx - xy1[i].x, v1 = c.fy * X[1] * iz1 + c.cy - xy1[i].y;
        const float u2 = c.fx * p2[0] * iz2 + c.cx - xy2[i].x, v2 = c.fy * p2[1] * iz2 + c.cy - xy2[i].y;
        const float e1 = (u1 * u1 + v1 * v1) * inv_s2, e2 = (u2 * u2 + v2 * v2) * inv_s2;
        const bool g = inl[i] && X[2] > 0.f && p2[2] > 0.f && cospar < 0.99998f && e1 < 4.f &&
                       e2 < 4.f;
        good[(size_t)ci * N + i] = g;
        for (int k = 0; k < 3; ++k) X_all[((size_t)ci * N + i) * 3 + k] = X[k];
        cnt += g;
    }
    const int tot = block_sum(cnt, sh);
    if (threadIdx.x == 0) n_good[ci] = tot;
}

__global__ void __launch_bounds__(THREADS) tv_final_kernel(
        int N, int min_triangulated, const float* __restrict__ score_fh,
        const bool* __restrict__ inl_all, const float* __restrict__ cand,
        const int* __restrict__ n_good, const bool* __restrict__ good_all,
        const float* __restrict__ X_all, int* __restrict__ out_i, float* __restrict__ R,
        float* __restrict__ t, float* __restrict__ X, bool* __restrict__ good) {
    __shared__ int sh[32];
    __shared__ int s_best;
    const bool use_H = chose_H(score_fh);
    const bool* inl = inl_all + (use_H ? N : 0);
    int cnt = 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) cnt += inl[i];
    const int n_inl = block_sum(cnt, sh);
    if (threadIdx.x == 0) {
        int b = 0;
        for (int k = 1; k < 12; ++k)
            if (n_good[k] > n_good[b]) b = k;
        int second = -1;
        for (int k = 0; k < 12; ++k)
            if (k != b) second = max(second, n_good[k]);
        const int nb = n_good[b];
        const bool ok = nb >= min_triangulated && (float)nb > 0.5f * (float)n_inl &&
                        0.75f * (float)nb > (float)max(second, 0);
        out_i[0] = ok;
        out_i[1] = use_H;
        out_i[2] = nb;
        out_i[3] = b;
        for (int k = 0; k < 9; ++k) R[k] = cand[12 * b + k];
        for (int k = 0; k < 3; ++k) t[k] = cand[12 * b + 9 + k];
        s_best = b;
    }
    __syncthreads();
    const int b = s_best;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        good[i] = good_all[(size_t)b * N + i];
        for (int k = 0; k < 3; ++k) X[3 * i + k] = X_all[((size_t)b * N + i) * 3 + k];
    }
}

}  // namespace

// Normalization of both point sets: tparams (m1x, m1y, s1x, s1y, m2x, m2y,
// s2x, s2y) and xn [2, N, 2].
C_ENTRY int tv_normalize(const float* xy1, const float* xy2, const bool* valid, int N,
                         float* tparams, float* xn, cudaStream_t stream) {
    tv_normalize_kernel<<<1, 1024, 0, stream>>>(reinterpret_cast<const float2*>(xy1),
                                                reinterpret_cast<const float2*>(xy2), valid, N,
                                                tparams, reinterpret_cast<float2*>(xn));
    return (int)cudaGetLastError();
}

// H hypotheses of each model from sample [H, 8]: models [2, H, 18], scores [2, H].
C_ENTRY int tv_hypotheses(const float* xn, const float* tparams, const int* sample, int H,
                          const float* xy1, const float* xy2, const bool* valid, int N,
                          float inv_s2, float* models, float* scores, cudaStream_t stream) {
    tv_hypotheses_kernel<<<dim3(H, 2), THREADS, 0, stream>>>(
        reinterpret_cast<const float2*>(xn), tparams, sample, H,
        reinterpret_cast<const float2*>(xy1), reinterpret_cast<const float2*>(xy2), valid, N,
        inv_s2, models, scores);
    return (int)cudaGetLastError();
}

// Refit of each model's best hypothesis: score_fh [2] (F, H), inliers
// [2, N], candidates [12, 12] (R row-major, t).
C_ENTRY int tv_refit(const float* xn, const float* tparams, const float* xy1, const float* xy2,
                     const bool* valid, int N, float inv_s2, const float* models,
                     const float* scores, int H, float fx, float fy, float cx, float cy,
                     float* score_fh, bool* inl, float* cand, cudaStream_t stream) {
    tv_refit_kernel<<<2, THREADS, 0, stream>>>(
        reinterpret_cast<const float2*>(xn), tparams, reinterpret_cast<const float2*>(xy1),
        reinterpret_cast<const float2*>(xy2), valid, N, inv_s2, models, scores, H,
        Cam{fx, fy, cx, cy}, score_fh, inl, cand);
    return (int)cudaGetLastError();
}

// CheckRT of the chosen model's candidates: n_good [12], good [12, N], X [12, N, 3].
C_ENTRY int tv_check(const float* xy1, const float* xy2, int N, float inv_s2, float fx,
                     float fy, float cx, float cy, const float* score_fh, const bool* inl,
                     const float* cand, int* n_good, bool* good, float* X, cudaStream_t stream) {
    tv_check_kernel<<<12, THREADS, 0, stream>>>(
        reinterpret_cast<const float2*>(xy1), reinterpret_cast<const float2*>(xy2), N, inv_s2,
        Cam{fx, fy, cx, cy}, score_fh, inl, cand, n_good, good, X);
    return (int)cudaGetLastError();
}

// The best candidate and the acceptance test: out_i (ok, used_H, n_good,
// best), R [3, 3], t [3], X [N, 3], good [N].
C_ENTRY int tv_final(int N, int min_triangulated, const float* score_fh, const bool* inl,
                     const float* cand, const int* n_good, const bool* good_all,
                     const float* X_all, int* out_i, float* R, float* t, float* X, bool* good,
                     cudaStream_t stream) {
    tv_final_kernel<<<1, THREADS, 0, stream>>>(N, min_triangulated, score_fh, inl, cand, n_good,
                                               good_all, X_all, out_i, R, t, X, good);
    return (int)cudaGetLastError();
}
