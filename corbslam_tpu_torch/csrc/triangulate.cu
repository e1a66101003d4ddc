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
// small, so the kernel is latency-bound: each pair is a dependent chain of
// ~150 operations with 7 IEEE divisions and 3 square roots.
// Design: `tri_points` gives each (neighbour slot, feature) pair a lane: the
// 8 slots of a feature are 8 adjacent lanes of a warp (4 features a warp,
// 16 a 128-thread CTA, so F 2048 gives 128 CTAs), and with K > 8 lane g
// also takes slots g + 8, g + 16, ... Each lane evaluates its pair's match
// (none for a padded neighbour, one that fails the baseline test, or a
// feature without a mutual match under th_low), the two rays, their
// midpoint and the gates (cheirality, parallax, chi2 5.991 sigma^2 in both
// views, the scale band) in the same f32 operations and order as the plain
// version (explicitly rounded, no FMA). The choice of neighbour is a
// shuffle reduction over the 8 lanes on the 64-bit key (error bits, slot),
// failed pairs +inf: the least summed error and the lower slot on ties,
// torch.argmin's first minimum. The lane that holds the winning slot
// writes the outputs; no winner gives create = false and zeros. Poses are
// read straight from the map's [N, 4, 4] Tcw by row (the keyframe's row q
// and each slot's neighbour row), the keyframe's keypoints and octaves from
// row q of the map's [N, F] tables, the camera centres from the set-up's
// o1 [3] and o2 [K, 3]; the outputs are one packed buffer of F x 25 bytes
// (X [F, 3] and dist [F] f32, k and f2 [F] i32, create [F] bool).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int POINT_THREADS = 128;
constexpr int GROUP = 8;  // lanes a feature: its neighbour slots, strided by 8 beyond 8
constexpr int FEATS = POINT_THREADS / GROUP;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

struct Cam {
    float fx, fy, cx, cy;
};

// R^T ((u - cx) / fx, (v - cy) / fy, 1): a unit-depth ray in the world frame
// (T: a row-major 4x4 pose, R its upper-left 3x3).
__device__ __forceinline__ void ray_world(const Cam& c, const float* T, float2 p, float* d) {
    const float x = __fdiv_rn(sub(p.x, c.cx), c.fx), y = __fdiv_rn(sub(p.y, c.cy), c.fy);
    for (int i = 0; i < 3; ++i) d[i] = add(add(mul(T[i], x), mul(T[4 + i], y)), T[8 + i]);
}

// R X + t of pose T.
__device__ __forceinline__ void transform(const float* T, const float* X, float* p) {
    for (int i = 0; i < 3; ++i)
        p[i] = add(add(add(mul(T[4 * i], X[0]), mul(T[4 * i + 1], X[1])),
                       mul(T[4 * i + 2], X[2])),
                   T[4 * i + 3]);
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
        const int* __restrict__ match, const float* __restrict__ Tcw,
        const int* __restrict__ nb_rows, int q, const float* __restrict__ o1g,
        const float* __restrict__ o2g, const float* __restrict__ scales, Cam c, float sf,
        unsigned char* __restrict__ out) {
    const int g = threadIdx.x % GROUP;
    const int f = blockIdx.x * FEATS + threadIdx.x / GROUP;
    const bool live = f < F;
    // Best (error bits << 32 | slot) of this lane's slots: errors are sums of
    // squares, so their f32 bits order as the values; failed pairs are +inf.
    unsigned long long best = ~0ull;
    float bX[3] = {0.f, 0.f, 0.f}, bdist = 0.f;
    int bj = 0;
    if (live) {
        xy_q += (size_t)q * F;
        oct_q += (size_t)q * F;
        const float* T1 = Tcw + (size_t)q * 16;
        const float o1[3] = {o1g[0], o1g[1], o1g[2]};
        const float2 p1 = xy_q[f];
        const float s1c = scales[oct_q[f]];
        const float chi1 = mul(5.991f, mul(s1c, s1c));
        float d1[3];
        ray_world(c, T1, p1, d1);
        const float n1 = sqrtf(dot3(d1, d1));
        for (int k = g; k < K; k += GROUP) {
            const int j = match[(size_t)k * F + f];
            if (j < 0) continue;
            const float* T2 = Tcw + (size_t)nb_rows[k] * 16;
            const float o2[3] = {o2g[3 * k], o2g[3 * k + 1], o2g[3 * k + 2]};
            const size_t r = (size_t)k * F + j;
            const float2 p2 = xy_t[r];
            const float s2c = scales[oct_t[r]];
            float d2[3];
            ray_world(c, T2, p2, d2);
            float rr[3];
            for (int i = 0; i < 3; ++i) rr[i] = sub(o2[i], o1[i]);
            const float a = dot3(d1, d1), b = dot3(d1, d2), cc = dot3(d2, d2);
            const float e = dot3(d1, rr), gg = dot3(d2, rr);
            float den = sub(mul(a, cc), mul(b, b));
            den = fabsf(den) < 1e-12f ? 1e-12f : den;
            const float s1 = __fdiv_rn(sub(mul(cc, e), mul(b, gg)), den);
            const float s2 = __fdiv_rn(sub(mul(b, e), mul(a, gg)), den);
            float X[3], pc1[3], pc2[3], v1[3], v2[3];
            for (int i = 0; i < 3; ++i)
                X[i] = mul(0.5f, add(add(o1[i], mul(s1, d1[i])), add(o2[i], mul(s2, d2[i]))));
            transform(T1, X, pc1);
            transform(T2, X, pc2);
            const float cospar =
                __fdiv_rn(dot3(d1, d2), fmaxf(mul(n1, sqrtf(dot3(d2, d2))), 1e-9f));
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
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(add(e1, e2)) << 32) | (unsigned int)k;
            if (key < best) {  // a lane's slots rise, so a tie keeps the lower slot
                best = key;
                bj = j;
                bdist = dist1;
                for (int i = 0; i < 3; ++i) bX[i] = X[i];
            }
        }
    }
    unsigned long long win = best;
#pragma unroll
    for (int o = GROUP / 2; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, win, o);
        win = other < win ? other : win;
    }
    if (!live) return;
    const bool made = win != ~0ull;
    // The lane that holds the winning slot writes; lane 0 of the group when
    // no slot passed.
    if (made ? win != best : g != 0) return;
    float* X_out = reinterpret_cast<float*>(out);
    float* dist_out = X_out + 3 * (size_t)F;
    int* k_out = reinterpret_cast<int*>(dist_out + F);
    int* f2_out = k_out + F;
    bool* create = reinterpret_cast<bool*>(f2_out + F);
    create[f] = made;
    k_out[f] = made ? (int)(win & 0xffffffffu) : 0;
    f2_out[f] = made ? bj : 0;
    dist_out[f] = bdist;
    for (int i = 0; i < 3; ++i) X_out[3 * f + i] = bX[i];
}

}  // namespace

// Triangulation, gates and the neighbour choice of each of the F features of
// keyframe row q (row q of the map's xy_q, oct_q [N, F]) against its K
// neighbours (rows nb_rows [K]; their features xy_t, oct_t [K, F]), from the
// accepted matches `match` [K, F] (-1: none); poses from the map's Tcw
// [N, 4, 4], camera centres o1 [3] and o2 [K, 3]. out: F x 25 bytes, X [F, 3] and dist [F] f32, k and f2 [F] i32,
// create [F] bool, in that order.
C_ENTRY int tri_points(const float* xy_q, const int* oct_q, const float* xy_t, const int* oct_t,
                       int F, int K, const int* match, const float* Tcw, const int* nb_rows,
                       int q, const float* o1, const float* o2, const float* scales, float fx,
                       float fy, float cx, float cy, float sf, unsigned char* out,
                       cudaStream_t stream) {
    if (F < 0 || K < 0 || q < 0) return (int)cudaErrorInvalidValue;
    if (F > 0)
        tri_points_kernel<<<(F + FEATS - 1) / FEATS, POINT_THREADS, 0, stream>>>(
            reinterpret_cast<const float2*>(xy_q), oct_q, reinterpret_cast<const float2*>(xy_t),
            oct_t, F, K, match, Tcw, nb_rows, q, o1, o2, scales, Cam{fx, fy, cx, cy}, sf, out);
    return (int)cudaGetLastError();
}
