// K13 `triangulate`: new landmarks between a keyframe and its covisible
// neighbours — the midpoint triangulation of each epipolar match, the gates
// and the per-feature choice of neighbour.
//
// Replaces corbslam_tpu/mapping/triangulation.py create_new_points (its
// vmapped per-neighbour program after the search, and the argmin over
// neighbours) and triangulate_midpoint. The search itself
// (search_for_triangulation with epipolar_band_mask, which the reference
// runs as a dense [K, F, F] candidacy mask and distance matrix, 33.5 M
// entries at K 8, F 2048) is K5's band mode, one batch per neighbour
// (match_masked.cu); its accepted matches [K, F] are this kernel's input.
//
// Bound on the H100: ~150 f32 operations of triangulation and gates per
// (neighbour, feature) with a match; the bytes (the keyframe's and its
// neighbours' keypoints and octaves, the matches, the outputs: ~0.3 MB) are
// small.
// Design: `tri_points` is one thread per feature: for each neighbour in
// order, its match (none for a padded neighbour, one that fails the baseline
// test, or a feature without a mutual match under th_low), the two rays,
// their midpoint and the gates (cheirality, parallax, chi2 5.991 sigma^2 in
// both views, the scale band), each in the same f32 operations and order as
// the plain version (explicitly rounded, no FMA), and the first neighbour
// with the least summed error; no neighbour gives create = false.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int POINT_THREADS = 128;
constexpr int NBP = 15;  // per neighbour: R2 (9), t2 (3), o2 (3)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

struct Cam {
    float fx, fy, cx, cy;
};

// R^T ((u - cx) / fx, (v - cy) / fy, 1): a unit-depth ray in the world frame.
__device__ __forceinline__ void ray_world(const Cam& c, const float* R, float2 p, float* d) {
    const float x = __fdiv_rn(sub(p.x, c.cx), c.fx), y = __fdiv_rn(sub(p.y, c.cy), c.fy);
    for (int i = 0; i < 3; ++i) d[i] = add(add(mul(R[i], x), mul(R[3 + i], y)), R[6 + i]);
}

__device__ __forceinline__ void transform(const float* R, const float* t, const float* X,
                                          float* p) {
    for (int i = 0; i < 3; ++i)
        p[i] = add(add(add(mul(R[3 * i], X[0]), mul(R[3 * i + 1], X[1])), mul(R[3 * i + 2], X[2])),
                   t[i]);
}

// Squared reprojection error of camera point p against pixel o.
__device__ __forceinline__ float reproj2(const Cam& c, const float* p, float2 o) {
    const float inv_z = __fdiv_rn(1.f, fabsf(p[2]) < 1e-9f ? 1e-9f : p[2]);
    const float du = sub(add(mul(mul(c.fx, p[0]), inv_z), c.cx), o.x);
    const float dv = sub(add(mul(mul(c.fy, p[1]), inv_z), c.cy), o.y);
    return add(mul(du, du), mul(dv, dv));
}

__global__ void __launch_bounds__(POINT_THREADS) tri_points_kernel(
        const float2* __restrict__ xy_q, const int* __restrict__ oct_q,
        const float2* __restrict__ xy_t, const int* __restrict__ oct_t, int F, int K,
        const int* __restrict__ match, const float* __restrict__ nbp,
        const float* __restrict__ kfp, const float* __restrict__ scales, Cam c, float sf,
        bool* __restrict__ create, int* __restrict__ k_out, int* __restrict__ f2_out,
        float* __restrict__ X_out, float* __restrict__ dist_out) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const float* R1 = kfp;
    const float* t1 = kfp + 9;
    const float* o1 = kfp + 12;
    const float2 p1 = xy_q[f];
    const float s1c = scales[oct_q[f]];
    const float chi1 = mul(5.991f, mul(s1c, s1c));
    float d1[3];
    ray_world(c, R1, p1, d1);
    const float n1 = sqrtf(dot3(d1, d1));
    float best_err = INFINITY, bX[3] = {0.f, 0.f, 0.f}, bdist = 0.f;
    int bk = 0, bj = 0;
    for (int k = 0; k < K; ++k) {
        const int j = match[(size_t)k * F + f];
        if (j < 0) continue;
        const float* P = nbp + k * NBP;
        const float *R2 = P, *t2 = P + 9, *o2 = P + 12;
        const size_t r = (size_t)k * F + j;
        const float2 p2 = xy_t[r];
        const float s2c = scales[oct_t[r]];
        float d2[3];
        ray_world(c, R2, p2, d2);
        float rr[3];
        for (int i = 0; i < 3; ++i) rr[i] = sub(o2[i], o1[i]);
        const float a = dot3(d1, d1), b = dot3(d1, d2), cc = dot3(d2, d2);
        const float e = dot3(d1, rr), g = dot3(d2, rr);
        float den = sub(mul(a, cc), mul(b, b));
        den = fabsf(den) < 1e-12f ? 1e-12f : den;
        const float s1 = __fdiv_rn(sub(mul(cc, e), mul(b, g)), den);
        const float s2 = __fdiv_rn(sub(mul(b, e), mul(a, g)), den);
        float X[3], pc1[3], pc2[3], v1[3], v2[3];
        for (int i = 0; i < 3; ++i)
            X[i] = mul(0.5f, add(add(o1[i], mul(s1, d1[i])), add(o2[i], mul(s2, d2[i]))));
        transform(R1, t1, X, pc1);
        transform(R2, t2, X, pc2);
        const float cospar = __fdiv_rn(dot3(d1, d2), fmaxf(mul(n1, sqrtf(dot3(d2, d2))), 1e-9f));
        const float e1 = reproj2(c, pc1, p1), e2 = reproj2(c, pc2, p2);
        for (int i = 0; i < 3; ++i) {
            v1[i] = sub(X[i], o1[i]);
            v2[i] = sub(X[i], o2[i]);
        }
        const float dist1 = sqrtf(dot3(v1, v1)), dist2 = sqrtf(dot3(v2, v2));
        const float ratio_d = __fdiv_rn(dist1, fmaxf(dist2, 1e-9f));
        const float ratio_o = __fdiv_rn(s2c, s1c);
        const bool ok = pc1[2] > 0.f && pc2[2] > 0.f && cospar < 0.9998f && e1 < chi1 &&
                        e2 < mul(5.991f, mul(s2c, s2c)) &&
                        ratio_d < mul(mul(ratio_o, 1.5f), sf) &&
                        mul(mul(ratio_d, 1.5f), sf) > ratio_o;
        if (!ok) continue;
        const float err = add(e1, e2);
        if (err < best_err) {
            best_err = err;
            bk = k;
            bj = j;
            bdist = dist1;
            for (int i = 0; i < 3; ++i) bX[i] = X[i];
        }
    }
    const bool made = best_err < INFINITY;
    create[f] = made;
    k_out[f] = bk;
    f2_out[f] = made ? bj : 0;
    dist_out[f] = bdist;
    for (int i = 0; i < 3; ++i) X_out[3 * f + i] = bX[i];
}

}  // namespace

// Triangulation, gates and the neighbour choice of each of the F features of
// the keyframe (xy_q, oct_q [F]) against its K neighbours (xy_t, oct_t
// [K, F]), from the accepted matches `match` [K, F] (-1: none).
C_ENTRY int tri_points(const float* xy_q, const int* oct_q, const float* xy_t, const int* oct_t,
                       int F, int K, const int* match, const float* nbp, const float* kfp,
                       const float* scales, float fx, float fy, float cx, float cy, float sf,
                       bool* create, int* k_out, int* f2_out, float* X_out, float* dist_out,
                       cudaStream_t stream) {
    tri_points_kernel<<<(F + POINT_THREADS - 1) / POINT_THREADS, POINT_THREADS, 0, stream>>>(
        reinterpret_cast<const float2*>(xy_q), oct_q, reinterpret_cast<const float2*>(xy_t),
        oct_t, F, K, match, nbp, kfp, scales, Cam{fx, fy, cx, cy}, sf, create, k_out, f2_out,
        X_out, dist_out);
    return (int)cudaGetLastError();
}
