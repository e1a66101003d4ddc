// Sim(3) / SO(3) arithmetic shared by K10 (`ransac.cu`) and K11
// (`pose_graph.cu`), written once over a scalar type T: `float`, or `Dual`
// (a value and one forward-mode derivative). The formulas, their order and
// their branch thresholds are those of corbslam_tpu/geometry/{se3,sim3}.py;
// a branch is chosen on the value, as jax.jacfwd differentiates the branch
// its `where` takes. `dmax(x, c)` gives a tie half the derivative, as
// lax.max does.
#pragma once

#include <math.h>

struct Dual {
    float v, d;
};

__device__ __forceinline__ Dual mk(float v, float d) { return Dual{v, d}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
    const float q = a.v / b.v;
    return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
    const float q = a / b.v;
    return {q, -q * b.d / b.v};
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
template <class T> __device__ __forceinline__ T cst(float c);
template <> __device__ __forceinline__ float cst<float>(float c) { return c; }
template <> __device__ __forceinline__ Dual cst<Dual>(float c) { return {c, 0.f}; }

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual dsqrt(Dual x) {
    const float r = sqrtf(x.v);
    return {r, x.d / (2.f * r)};
}
// sin and cos: sinf / cosf, or with SIM3_SINCOSPI defined before this
// header sincospif(x / pi), which has no large-argument reduction and so no
// local-memory stack frame (within an ulp of sinf / cosf).
#ifdef SIM3_SINCOSPI
__device__ __forceinline__ float sin_(float x) {
    float s, c;
    sincospif(x * 0.318309886183790672f, &s, &c);
    return s;
}
__device__ __forceinline__ float cos_(float x) {
    float s, c;
    sincospif(x * 0.318309886183790672f, &s, &c);
    return c;
}
#else
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
#endif
__device__ __forceinline__ float dsin(float x) { return sin_(x); }
__device__ __forceinline__ Dual dsin(Dual x) { return {sin_(x.v), cos_(x.v) * x.d}; }
__device__ __forceinline__ float dcos(float x) { return cos_(x); }
__device__ __forceinline__ Dual dcos(Dual x) { return {cos_(x.v), -sin_(x.v) * x.d}; }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ Dual dexp(Dual x) {
    const float e = expf(x.v);
    return {e, e * x.d};
}
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ Dual dlog(Dual x) { return {logf(x.v), x.d / x.v}; }
__device__ __forceinline__ float dacos(float x) { return acosf(x); }
__device__ __forceinline__ Dual dacos(Dual x) {
    return {acosf(x.v), -x.d / sqrtf(1.f - x.v * x.v)};
}
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ Dual dabs(Dual x) {
    return {fabsf(x.v), x.v > 0.f ? x.d : (x.v < 0.f ? -x.d : 0.f)};
}
// max(x, c) / min(x, c) with a constant c: a tie takes half the derivative.
__device__ __forceinline__ float dmax(float x, float c) { return fmaxf(x, c); }
__device__ __forceinline__ Dual dmax(Dual x, float c) {
    return {fmaxf(x.v, c), x.v > c ? x.d : (x.v == c ? 0.5f * x.d : 0.f)};
}
__device__ __forceinline__ float dmin(float x, float c) { return fminf(x, c); }
__device__ __forceinline__ Dual dmin(Dual x, float c) {
    return {fminf(x.v, c), x.v < c ? x.d : (x.v == c ? 0.5f * x.d : 0.f)};
}
template <class T> __device__ __forceinline__ T sel(bool c, T a, T b) { return c ? a : b; }

constexpr float SIM3_EPS = 1e-8f;

// R = R_a R_b (row-major 3x3).
template <class T> __device__ void mat3_mul(const T* A, const T* B, T* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <class T> __device__ void mat3_vec(const T* A, const T* x, T* y) {
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

template <class T> __device__ void hat3(const T* p, T* K) {
    const T z = cst<T>(0.f);
    K[0] = z; K[1] = -p[2]; K[2] = p[1];
    K[3] = p[2]; K[4] = z; K[5] = -p[0];
    K[6] = -p[1]; K[7] = p[0]; K[8] = z;
}

// se3._sinc_coeffs: A = sin t / t, B = (1 - cos t) / t^2 (series below 1e-8).
template <class T> __device__ void sinc_ab(T theta2, T& A, T& B) {
    const bool small = val(theta2) < 1e-8f;
    const T t2s = sel(small, cst<T>(1.f), theta2);
    const T th = dsqrt(t2s);
    A = sel(small, 1.f - theta2 / 6.f, dsin(th) / th);
    B = sel(small, 0.5f - theta2 / 24.f, (1.f - dcos(th)) / t2s);
}

template <class T> __device__ void so3_exp(const T* phi, T* R) {
    const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    T A, B;
    sinc_ab(theta2, A, B);
    T K[9], K2[9];
    hat3(phi, K);
    mat3_mul(K, K, K2);
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = ((i % 4 == 0) ? cst<T>(1.f) : cst<T>(0.f)) + A * K[i] + B * K2[i];
}

// se3.so3_log with its two branches (small angle, near pi).
template <class T> __device__ void so3_log(const T* R, T* phi) {
    const T trace = R[0] + R[4] + R[8];
    const T cos_t = dmin(dmax((trace - 1.f) * 0.5f, -1.f), 1.f);
    T w[3] = {(R[7] - R[5]) * 0.5f, (R[2] - R[6]) * 0.5f, (R[3] - R[1]) * 0.5f};
    const bool small = val(cos_t) > 1.f - 1e-6f;
    const T cos_gen = sel(small, cst<T>(0.5f), cos_t);
    const T theta_gen = dacos(cos_gen);
    const T theta = sel(small, dsqrt(dmax(2.f * (1.f - cos_t), 1e-24f)), theta_gen);
    const T scale = sel(small, 1.f + (1.f - cos_t) / 3.f, theta_gen / dmax(dsin(theta_gen), SIM3_EPS));
    if (!(val(theta) > 3.f)) {
#pragma unroll
        for (int i = 0; i < 3; ++i) phi[i] = scale * w[i];
        return;
    }
    T axis2[3], axis[3];
    const T diag[3] = {R[0], R[4], R[8]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        axis2[i] = dmax((diag[i] - cos_t) / dmax(1.f - cos_t, SIM3_EPS), 0.f);
        axis[i] = dsqrt(dmax(axis2[i], 1e-24f));
    }
    // k = argmax (first maximum); the row of each k is formed with constant
    // indices and the one of k selected, so no array is indexed at run time.
    const bool k1 = val(axis2[1]) > val(axis2[0]);
    const bool k2 = val(axis2[2]) > (k1 ? val(axis2[1]) : val(axis2[0]));
    T row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        T rk[3];
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
            rk[kk] = (j == kk) ? axis2[kk] : (R[3 * kk + j] + R[3 * j + kk]) * 0.5f;
        row[j] = k2 ? rk[2] : (k1 ? rk[1] : rk[0]);
    }
    T ap[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float r = val(row[j]);
        const float sg = fabsf(r) < SIM3_EPS ? 1.f : (r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f));
        ap[j] = axis[j] * sg;
    }
    const T nrm = dmax(dsqrt(ap[0] * ap[0] + ap[1] * ap[1] + ap[2] * ap[2]), SIM3_EPS);
#pragma unroll
    for (int j = 0; j < 3; ++j) ap[j] = ap[j] / nrm;
    const float dot_w = val(ap[0] * w[0] + ap[1] * w[1] + ap[2] * w[2]);
    const float flip = dot_w < 0.f ? -1.f : 1.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) phi[j] = theta * (ap[j] * flip);
}

// sim3 W-matrix coefficients; `exact_c` is exp's small-angle C, else log's.
template <class T> __device__ void w_coeffs(T theta2, T sigma, T s, bool exact_c, T& A, T& B, T& C) {
    const T theta = dsqrt(dmax(theta2, SIM3_EPS * SIM3_EPS));
    const T sig2 = sigma * sigma;
    const bool small_sig = fabsf(val(sigma)) < 1e-5f;
    const bool small_th = val(theta) < 1e-5f;
    const T one = cst<T>(1.f);
    A = sel(small_sig, 1.f + sigma / 2.f + sig2 / 6.f, (s - 1.f) / sel(small_sig, one, sigma));
    const T denom = dmax(sig2 + theta2, SIM3_EPS);
    const T s_cos = s * dcos(theta);
    const T s_sin = s * dsin(theta);
    if (small_th) {
        B = sel(small_sig, 0.5f + sigma / 3.f,
                (s * (1.f - sigma) - 1.f + sig2 * A) / sel(small_sig, one, denom));
        if (small_sig) {
            C = 1.f / 6.f + sigma / 8.f;
        } else if (exact_c) {
            C = (A - sigma * (s - 1.f - sig2 * A) / sel(small_sig, one, denom)) / dmax(theta2, 1.f);
        } else {
            C = A * 0.f + 1.f / 6.f;
        }
    } else {
        B = (sigma * s_sin + theta * (1.f - s_cos)) / (dmax(theta, SIM3_EPS) * denom);
        C = (A - ((s_cos - 1.f) * sigma + s_sin * theta) / denom) / dmax(theta2, SIM3_EPS);
    }
}

template <class T> __device__ void w_matrix(const T* phi, T sigma, T s, bool exact_c, T* W) {
    const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    T A, B, C;
    w_coeffs(theta2, sigma, s, exact_c, A, B, C);
    T K[9], K2[9];
    hat3(phi, K);
    mat3_mul(K, K, K2);
#pragma unroll
    for (int i = 0; i < 9; ++i) W[i] = ((i % 4 == 0) ? A : A * 0.f) + B * K[i] + C * K2[i];
}

// sim3.exp: xi = (rho, phi, sigma) -> (R, t, s).
template <class T> __device__ void sim3_exp(const T* xi, T* R, T* t, T& s) {
    s = dexp(xi[6]);
    T W[9];
    w_matrix(xi + 3, xi[6], s, true, W);
    so3_exp(xi + 3, R);
    mat3_vec(W, xi, t);
}

// A o B.
template <class T>
__device__ void sim3_compose(const T* Ra, const T* ta, T sa, const T* Rb, const T* tb, T sb, T* R,
                             T* t, T& s) {
    T Rt[9], v[3];
    mat3_mul(Ra, Rb, Rt);
    mat3_vec(Ra, tb, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = sa * v[i] + ta[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Rt[i];
    s = sa * sb;
}

template <class T> __device__ void sim3_inverse(const T* R, const T* t, T s, T* Ri, T* ti, T& si) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
    si = 1.f / dmax(s, SIM3_EPS);
    T v[3];
    mat3_vec(Ri, t, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) ti[i] = -si * v[i];
}

// Solve W x = b (3x3) by Gaussian elimination with partial pivoting (the
// reference's jnp.linalg.solve is an LU). For Dual, the derivative solves
// W x' = b' - W' x with the same pivots, as the jvp of solve does.
__device__ inline void solve3_f(const float* W, const float* b, float* x) {
    float A[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        A[i][0] = W[3 * i]; A[i][1] = W[3 * i + 1]; A[i][2] = W[3 * i + 2]; A[i][3] = b[i];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        // The pivot row p (first largest |A[r][c]|), swapped in with constant
        // indices under a condition: no array is indexed at run time.
        int p = c;
        float big = fabsf(A[c][c]);
#pragma unroll
        for (int r = c + 1; r < 3; ++r)
            if (fabsf(A[r][c]) > big) {
                big = fabsf(A[r][c]);
                p = r;
            }
#pragma unroll
        for (int r = c + 1; r < 3; ++r)
            if (p == r)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float tmp = A[c][k]; A[c][k] = A[r][k]; A[r][k] = tmp;
                }
#pragma unroll
        for (int r = c + 1; r < 3; ++r) {
            const float f = A[r][c] / A[c][c];
#pragma unroll
            for (int k = c; k < 4; ++k) A[r][k] -= f * A[c][k];
        }
    }
#pragma unroll
    for (int i = 2; i >= 0; --i) {
        float v = A[i][3];
#pragma unroll
        for (int k = i + 1; k < 3; ++k) v -= A[i][k] * x[k];
        x[i] = v / A[i][i];
    }
}

__device__ inline void solve3(const float* W, const float* b, float* x) { solve3_f(W, b, x); }
__device__ inline void solve3(const Dual* W, const Dual* b, Dual* x) {
    float Wv[9], bv[3], xv[3], rd[3], xd[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Wv[i] = W[i].v;
#pragma unroll
    for (int i = 0; i < 3; ++i) bv[i] = b[i].v;
    solve3_f(Wv, bv, xv);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        rd[i] = b[i].d - (W[3 * i].d * xv[0] + W[3 * i + 1].d * xv[1] + W[3 * i + 2].d * xv[2]);
    solve3_f(Wv, rd, xd);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = Dual{xv[i], xd[i]};
}

// sim3.log: (R, t, s) -> (rho, phi, sigma).
template <class T> __device__ void sim3_log(const T* R, const T* t, T s, T* xi) {
    so3_log(R, xi + 3);
    xi[6] = dlog(dmax(s, SIM3_EPS));
    T W[9];
    w_matrix(xi + 3, xi[6], s, false, W);
    solve3(W, t, xi);
}
