// Closed-form small-matrix spectral ops as device functions (the port of
// corbslam_tpu/geometry/linalg3.py: eigh3x3, svd3x3; its smallest_eigvec_sym
// is K12's warp LU in two_view.cu), for one thread: row-major float arrays,
// the reference's operations in its order, every index known at compile
// time (no local memory). `geometry/linalg3.py` is the plain PyTorch version.
#pragma once

#include <math.h>

namespace {

__device__ __forceinline__ float det3(const float* a) {
    return a[0] * a[4] * a[8] + a[1] * a[5] * a[6] + a[2] * a[3] * a[7] - a[2] * a[4] * a[6] -
           a[0] * a[5] * a[7] - a[1] * a[3] * a[8];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float norm3(const float* v) {
    return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// A^T B
__device__ __forceinline__ void matmul3_tn(const float* A, const float* B, float* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

// A B^T
__device__ __forceinline__ void matmul3_nt(const float* A, const float* B, float* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] +
                           A[3 * i + 2] * B[3 * j + 2];
}

// Inverse of a 3x3 by the adjugate.
__device__ __forceinline__ void inv3(const float* a, float* r) {
    const float c00 = a[4] * a[8] - a[5] * a[7], c01 = a[5] * a[6] - a[3] * a[8],
                c02 = a[3] * a[7] - a[4] * a[6];
    const float inv_det = 1.f / (a[0] * c00 + a[1] * c01 + a[2] * c02);
    r[0] = c00 * inv_det;
    r[1] = (a[2] * a[7] - a[1] * a[8]) * inv_det;
    r[2] = (a[1] * a[5] - a[2] * a[4]) * inv_det;
    r[3] = c01 * inv_det;
    r[4] = (a[0] * a[8] - a[2] * a[6]) * inv_det;
    r[5] = (a[2] * a[3] - a[0] * a[5]) * inv_det;
    r[6] = c02 * inv_det;
    r[7] = (a[1] * a[6] - a[0] * a[7]) * inv_det;
    r[8] = (a[0] * a[4] - a[1] * a[3]) * inv_det;
}

// Unit eigenvector of symmetric A for eigenvalue lam: the longest cross
// product of two rows of (A - lam I) (the first on ties), e1 when all vanish.
__device__ __forceinline__ void eigvec3(const float* A, float lam, float* v) {
    float M[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) M[k] = A[k];
    M[0] -= lam;
    M[4] -= lam;
    M[8] -= lam;
    float c[3][3];
    cross3(M, M + 3, c[0]);
    cross3(M, M + 6, c[1]);
    cross3(M + 3, M + 6, c[2]);
    float best[3] = {c[0][0], c[0][1], c[0][2]};
    float bn = norm3(c[0]);
#pragma unroll
    for (int k = 1; k < 3; ++k) {
        const float n = norm3(c[k]);
        if (n > bn) {
            bn = n;
#pragma unroll
            for (int i = 0; i < 3; ++i) best[i] = c[k][i];
        }
    }
    if (bn > 1e-12f) {
        const float d = fmaxf(bn, 1e-30f);
#pragma unroll
        for (int i = 0; i < 3; ++i) v[i] = best[i] / d;
    } else {
        v[0] = 1.f;
        v[1] = 0.f;
        v[2] = 0.f;
    }
}

// Eigenvalues ascending (w) and eigenvectors as columns of V (row-major).
__device__ __forceinline__ void eigh3x3(const float* Ain, float* w, float* V) {
    float A[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) A[3 * i + j] = 0.5f * (Ain[3 * i + j] + Ain[3 * j + i]);
    const float q = (A[0] + A[4] + A[8]) / 3.f;
    float B[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) B[k] = A[k];
    B[0] -= q;
    B[4] -= q;
    B[8] -= q;
    float p2 = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) p2 += B[k] * B[k];
    p2 /= 6.f;
    const float p = sqrtf(fmaxf(p2, 1e-30f));
    float Bn[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Bn[k] = B[k] / p;
    const float r = fminf(fmaxf(det3(Bn) / 2.f, -1.f), 1.f);
    const float phi = acosf(r) / 3.f;
    // phi lies in [0, pi / 3] (r is clamped, so never NaN): cosf never takes
    // its Payne-Hanek path for |x| >= 105615 (CUDART_TRIG_PLOSS_F), whose
    // 28-byte array would give the kernel a stack frame. Saying so removes
    // that path and changes no value.
    const float a2 = phi, a0 = phi + 2.0943951023931953f;
    __builtin_assume(!(fabsf(a2) >= 105615.0f));
    __builtin_assume(!(fabsf(a0) >= 105615.0f));
    w[2] = q + 2.f * p * cosf(a2);
    w[0] = q + 2.f * p * cosf(a0);
    w[1] = 3.f * q - w[0] - w[2];
    float v0[3], v1[3], v2[3];
    eigvec3(A, w[0], v0);
    eigvec3(A, w[2], v2);
    cross3(v2, v0, v1);
    const float n1 = norm3(v1);
    if (n1 > 1e-12f) {
        const float d = fmaxf(n1, 1e-30f);
#pragma unroll
        for (int i = 0; i < 3; ++i) v1[i] /= d;
    } else {
        eigvec3(A, w[1], v1);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        V[3 * i] = v0[i];
        V[3 * i + 1] = v1[i];
        V[3 * i + 2] = v2[i];
    }
}

// M = U diag(s) V^T, s descending.
__device__ __forceinline__ void svd3x3(const float* M, float* U, float* s, float* V) {
    float MtM[9], w[3], Va[9];
    matmul3_tn(M, M, MtM);
    eigh3x3(MtM, w, Va);
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = sqrtf(fmaxf(w[2 - k], 0.f));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) V[3 * i + k] = Va[3 * i + 2 - k];
    float MV[9];
    matmul3(M, V, MV);
    float u0[3], u1[3], u2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        u0[i] = MV[3 * i] / fmaxf(s[0], 1e-12f);
        u1[i] = MV[3 * i + 1] / fmaxf(s[1], 1e-12f);
    }
    const float n0 = fmaxf(norm3(u0), 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) u0[i] /= n0;
    const float d01 = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] -= d01 * u0[i];
    const float n1 = fmaxf(norm3(u1), 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] /= n1;
    cross3(u0, u1, u2);
    const float dot = u2[0] * MV[2] + u2[1] * MV[5] + u2[2] * MV[8];
    const float sgn = dot > 0.f ? 1.f : (dot < 0.f ? -1.f : 1.f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        U[3 * i] = u0[i];
        U[3 * i + 1] = u1[i];
        U[3 * i + 2] = u2[i] * sgn;
    }
}

}  // namespace
