// K11 `pose_graph`: the essential graph's Sim3 pose graph (linearization and
// Gauss-Newton with block-Jacobi PCG) and the [N, N] covisibility count it
// is built from.
//
// Replaces corbslam_tpu/optim/pose_graph.py linearize_edges (jax.jacfwd of
// log(S_m o retract(S_i) o retract(S_j)^-1) per edge) and optimize (20
// Gauss-Newton iterations x 40 CG iterations from loop_closing.py:443,
// block-Jacobi 7x7 inverses, the final polar projection), and
// corbslam_tpu/mapstate/covisibility.py obs_matrix + covis_matrix (an int8
// MXU product of the materialized [N, M] incidence).
//
// Bound on the H100: latency for the pose graph. Per closure the work is
// 20 x (E x 14 dual evaluations, ~2 KFLOP each) plus 800 CG passes over E
// edges of 2 x 49 MACs: ~1 GFLOP and a few MB, a millisecond of the card's
// arithmetic, while every CG pass depends on the previous one through two
// dot products. The covisibility count is bound by bytes: one read of the
// [N, F] observation table and one write of the [N, N] counts.
// Design: `pg_linearize` runs one thread per (edge, tangent direction):
// the residual's code in sim3.cuh over a one-direction dual number gives
// column k of the edge's 7x14 Jacobian, the same forward-mode derivative
// jacfwd takes, branch for branch. `pg_step` is one 1024-thread CTA per
// Gauss-Newton iteration (launched back to back, no host sync): it builds
// each vertex's 7x7 block and gradient from a vertex-major incidence list
// ordered (vertex, side, edge), so the i-side terms add in edge order, then
// the j-side terms, as the reference's two segment sums do, with no float
// atomics; inverts the blocks by Cholesky; runs the PCG with fixed-order
// block reductions for its dot products; retracts the free vertices, writes
// the iteration's cost and, on the last iteration, takes two polar steps of
// every rotation. The incidence list holds only the weighted edges (an
// edge of weight 0 adds exactly 0), and a fixed vertex's gradient, search
// direction and product are exactly 0 (the reference multiplies them by
// its free mask), so its block is neither built nor inverted. The
// covisibility count groups each point's observers (count, exclusive scan,
// fill), sorts each point's list in place and adds one per distinct
// observer pair with an integer atomic: exact in any order, and no [N, M]
// matrix.

#include "common.cuh"
#include "sim3.cuh"

namespace {

constexpr int STEP_THREADS = 1024;
constexpr int LIN_THREADS = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return __shfl_sync(0xffffffffu, v, 0);
}

// Sum over the CTA in a fixed order (lanes, then warps); every thread gets it.
__device__ float block_sum(float v, float* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
    v = warp_sum(v);
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float u = lane < nw ? sh[lane] : 0.f;
        u = warp_sum(u);
        if (lane == 0) sh[32] = u;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();
    return r;
}

__global__ void linearize_kernel(const float* R, const float* t, const float* s, const int* e_i,
                                 const int* e_j, const float* mR, const float* mt,
                                 const float* ms, int E, float* r_out, float* J_out) {
    const int task = blockIdx.x * blockDim.x + threadIdx.x;
    if (task >= E * 14) return;
    const int e = task / 14, k = task % 14;
    const int vi = e_i[e], vj = e_j[e];
    Dual Ri[9], ti[3], Rj[9], tj[3], Rm[9], tm[3];
    for (int q = 0; q < 9; ++q) {
        Ri[q] = mk(R[9 * vi + q], 0.f);
        Rj[q] = mk(R[9 * vj + q], 0.f);
        Rm[q] = mk(mR[9 * e + q], 0.f);
    }
    for (int q = 0; q < 3; ++q) {
        ti[q] = mk(t[3 * vi + q], 0.f);
        tj[q] = mk(t[3 * vj + q], 0.f);
        tm[q] = mk(mt[3 * e + q], 0.f);
    }
    const Dual si = mk(s[vi], 0.f), sj = mk(s[vj], 0.f), sm = mk(ms[e], 0.f);
    Dual xi_i[7], xi_j[7];
    for (int q = 0; q < 7; ++q) {
        xi_i[q] = mk(0.f, (k < 7 && q == k) ? 1.f : 0.f);
        xi_j[q] = mk(0.f, (k >= 7 && q == k - 7) ? 1.f : 0.f);
    }
    // retract(S, xi) = exp(xi) o S, for both ends.
    Dual ER[9], Et[3], Es, Ri2[9], ti2[3], si2, Rj2[9], tj2[3], sj2;
    sim3_exp(xi_i, ER, Et, Es);
    sim3_compose(ER, Et, Es, Ri, ti, si, Ri2, ti2, si2);
    sim3_exp(xi_j, ER, Et, Es);
    sim3_compose(ER, Et, Es, Rj, tj, sj, Rj2, tj2, sj2);
    // r = log(Sm o (Si o Sj^-1)).
    Dual Rji[9], tji[3], sji, Rc[9], tc[3], sc, Rr[9], tr[3], sr, xi[7];
    sim3_inverse(Rj2, tj2, sj2, Rji, tji, sji);
    sim3_compose(Ri2, ti2, si2, Rji, tji, sji, Rc, tc, sc);
    sim3_compose(Rm, tm, sm, Rc, tc, sc, Rr, tr, sr);
    sim3_log(Rr, tr, sr, xi);
    const int side = k / 7, col = k % 7;
    float* Je = J_out + (size_t)(2 * e + side) * 49;
    for (int q = 0; q < 7; ++q) Je[7 * q + col] = xi[q].d;
    if (k == 0)
        for (int q = 0; q < 7; ++q) r_out[7 * e + q] = xi[q].v;
}

// Cholesky factor of SPD A (7x7) with smallmat.chol_unrolled's pivot clamp.
__device__ void chol7(const float* A, float* L) {
    for (int i = 0; i < 7; ++i)
        for (int j = 0; j <= i; ++j) {
            float s = A[7 * i + j];
            for (int k = 0; k < j; ++k) s -= L[7 * i + k] * L[7 * j + k];
            L[7 * i + j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[7 * j + j];
        }
}

__device__ void chol7_solve(const float* L, const float* b, float* x) {
    float y[7];
    for (int i = 0; i < 7; ++i) {
        float s = b[i];
        for (int k = 0; k < i; ++k) s -= L[7 * i + k] * y[k];
        y[i] = s / L[7 * i + i];
    }
    for (int i = 6; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 7; ++k) s -= L[7 * k + i] * x[k];
        x[i] = s / L[7 * i + i];
    }
}

struct StepArgs {
    float *R, *t, *s;
    const bool* fixed;
    int N;
    const int *e_i, *e_j;
    const float* w;
    int E;
    const int *off, *inc;
    const float *r, *J;
    int cg_iters;
    float lam, damp;
    int last;
    float *Minv, *x, *rr, *p, *z, *Ap, *a;
    float* cost;
};

__device__ __forceinline__ void precond(const StepArgs& A, int v, float fr) {
    if (fr == 0.f) {  // M^-1 r x free: 0 for a fixed vertex
        for (int i = 0; i < 7; ++i) A.z[7 * v + i] = 0.f;
        return;
    }
    const float* M = A.Minv + 49 * v;
    for (int i = 0; i < 7; ++i) {
        float s = 0.f;
        for (int j = 0; j < 7; ++j) s += M[7 * i + j] * A.rr[7 * v + j];
        A.z[7 * v + i] = s * fr;
    }
}

__global__ void __launch_bounds__(STEP_THREADS) step_kernel(StepArgs A) {
    __shared__ float sh[33];
    const int tid = threadIdx.x, nt = blockDim.x;
    const int N = A.N, E = A.E;
    // Blocks, their inverses, the gradient.
    float part = 0.f;
    for (int v = tid; v < N; v += nt) {
        if (A.fixed[v]) {
            for (int i = 0; i < 7; ++i)
                A.rr[7 * v + i] = A.x[7 * v + i] = A.z[7 * v + i] = A.p[7 * v + i] = 0.f;
            continue;
        }
        float H[2][49], b[2][7];
        for (int q = 0; q < 49; ++q) H[0][q] = H[1][q] = 0.f;
        for (int q = 0; q < 7; ++q) b[0][q] = b[1][q] = 0.f;
        for (int k = A.off[v]; k < A.off[v + 1]; ++k) {
            const int code = A.inc[k];
            const int side = code >= E ? 1 : 0, e = code - side * E;
            const float we = A.w[e];
            if (we == 0.f) continue;
            const float* Je = A.J + (size_t)(2 * e + side) * 49;
            const float* re = A.r + 7 * e;
            for (int i = 0; i < 7; ++i) {
                for (int j = 0; j < 7; ++j) {
                    float s = 0.f;
                    for (int q = 0; q < 7; ++q) s += (Je[7 * q + i] * we) * Je[7 * q + j];
                    H[side][7 * i + j] += s;
                }
                float g = 0.f;
                for (int q = 0; q < 7; ++q) g += (Je[7 * q + i] * we) * re[q];
                b[side][i] += g;
            }
        }
        float Hd[49], L[49], col[7], e[7];
        for (int q = 0; q < 49; ++q) Hd[q] = H[0][q] + H[1][q];
        for (int i = 0; i < 7; ++i) {
            Hd[8 * i] = (Hd[8 * i] + A.lam) + 1e-8f;
            Hd[8 * i] += 1e-6f;
        }
        chol7(Hd, L);
        for (int c = 0; c < 7; ++c) {
            for (int i = 0; i < 7; ++i) e[i] = (i == c) ? 1.f : 0.f;
            chol7_solve(L, e, col);
            for (int i = 0; i < 7; ++i) A.Minv[49 * v + 7 * i + c] = col[i];
        }
        const float fr = A.fixed[v] ? 0.f : 1.f;
        for (int i = 0; i < 7; ++i) {
            const float bi = -(b[0][i] + b[1][i]) * fr;
            A.rr[7 * v + i] = bi;
            A.x[7 * v + i] = 0.f;
        }
        precond(A, v, fr);
        for (int i = 0; i < 7; ++i) {
            A.p[7 * v + i] = A.z[7 * v + i];
            part += A.rr[7 * v + i] * A.z[7 * v + i];
        }
    }
    float rz = block_sum(part, sh);
    for (int it = 0; it < A.cg_iters; ++it) {
        for (int e = tid; e < E; e += nt) {
            const float we = A.w[e];
            if (we == 0.f) continue;
            const int vi = A.e_i[e], vj = A.e_j[e];
            const float fi = A.fixed[vi] ? 0.f : 1.f, fj = A.fixed[vj] ? 0.f : 1.f;
            const float* Ji = A.J + (size_t)(2 * e) * 49;
            const float* Jj = Ji + 49;
            for (int q = 0; q < 7; ++q) {
                float si = 0.f, sj = 0.f;
                for (int c = 0; c < 7; ++c) {
                    si += Ji[7 * q + c] * (A.p[7 * vi + c] * fi);
                    sj += Jj[7 * q + c] * (A.p[7 * vj + c] * fj);
                }
                A.a[7 * e + q] = (si + sj) * we;
            }
        }
        __syncthreads();
        part = 0.f;
        for (int v = tid; v < N; v += nt) {
            if (A.fixed[v]) {
                for (int i = 0; i < 7; ++i) A.Ap[7 * v + i] = 0.f;
                continue;
            }
            float o[2][7];
            for (int q = 0; q < 7; ++q) o[0][q] = o[1][q] = 0.f;
            for (int k = A.off[v]; k < A.off[v + 1]; ++k) {
                const int code = A.inc[k];
                const int side = code >= E ? 1 : 0, e = code - side * E;
                if (A.w[e] == 0.f) continue;
                const float* Je = A.J + (size_t)(2 * e + side) * 49;
                for (int i = 0; i < 7; ++i) {
                    float s = 0.f;
                    for (int q = 0; q < 7; ++q) s += Je[7 * q + i] * A.a[7 * e + q];
                    o[side][i] += s;
                }
            }
            const float fr = A.fixed[v] ? 0.f : 1.f;
            for (int i = 0; i < 7; ++i) {
                const float pv = A.p[7 * v + i];
                const float ap = ((o[0][i] + o[1][i]) + A.damp * (pv * fr)) * fr;
                A.Ap[7 * v + i] = ap;
                part += pv * ap;
            }
        }
        const float pAp = block_sum(part, sh);
        const float alpha = rz / (fabsf(pAp) < 1e-20f ? 1e-20f : pAp);
        part = 0.f;
        for (int v = tid; v < N; v += nt) {
            const float fr = A.fixed[v] ? 0.f : 1.f;
            for (int i = 0; i < 7; ++i) {
                A.x[7 * v + i] += alpha * A.p[7 * v + i];
                A.rr[7 * v + i] -= alpha * A.Ap[7 * v + i];
            }
            precond(A, v, fr);
            for (int i = 0; i < 7; ++i) part += A.rr[7 * v + i] * A.z[7 * v + i];
        }
        const float rz2 = block_sum(part, sh);
        const float beta = rz2 / (fabsf(rz) < 1e-20f ? 1e-20f : rz);
        for (int v = tid; v < N; v += nt)
            for (int i = 0; i < 7; ++i)
                A.p[7 * v + i] = A.z[7 * v + i] + beta * A.p[7 * v + i];
        rz = rz2;
        __syncthreads();
    }
    // Retract the free vertices; the iteration's cost; the polar steps.
    for (int v = tid; v < N; v += nt) {
        float Rv[9], tv[3], sv = A.s[v];
        for (int q = 0; q < 9; ++q) Rv[q] = A.R[9 * v + q];
        for (int q = 0; q < 3; ++q) tv[q] = A.t[3 * v + q];
        if (!A.fixed[v]) {
            float ER[9], Et[3], Es, R2[9], t2[3], s2;
            sim3_exp(A.x + 7 * v, ER, Et, Es);
            sim3_compose(ER, Et, Es, Rv, tv, sv, R2, t2, s2);
            for (int q = 0; q < 9; ++q) Rv[q] = R2[q];
            for (int q = 0; q < 3; ++q) tv[q] = t2[q];
            sv = s2;
        }
        if (A.last) {
            for (int rep = 0; rep < 2; ++rep) {
                float RtR[9], Rt[9], M[9], Rn[9];
                for (int i = 0; i < 3; ++i)
                    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = Rv[3 * j + i];
                mat3_mul(Rt, Rv, RtR);
                for (int q = 0; q < 9; ++q) M[q] = ((q % 4 == 0) ? 3.f : 0.f) - RtR[q];
                mat3_mul(Rv, M, Rn);
                for (int q = 0; q < 9; ++q) Rv[q] = 0.5f * Rn[q];
            }
        }
        for (int q = 0; q < 9; ++q) A.R[9 * v + q] = Rv[q];
        for (int q = 0; q < 3; ++q) A.t[3 * v + q] = tv[q];
        A.s[v] = sv;
    }
    part = 0.f;
    for (int e = tid; e < E; e += nt) {
        const float we = A.w[e];
        for (int q = 0; q < 7; ++q) {
            const float rq = A.r[7 * e + q];
            part += (rq * rq) * (we * we);
        }
    }
    const float cost = block_sum(part, sh);
    if (tid == 0) *A.cost = cost;
}

// Covisibility count: observers per point.
__global__ void covis_count_kernel(const int* mp_idx, const bool* fvalid, const bool* kvalid,
                                   int N, int F, int M, int* cnt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N * F) return;
    const int p = mp_idx[i];
    if (p >= 0 && p < M && fvalid[i] && kvalid[i / F]) atomicAdd(&cnt[p], 1);
}

__global__ void covis_fill_kernel(const int* mp_idx, const bool* fvalid, const bool* kvalid,
                                  int N, int F, int M, const int* offs, int* cursor, int* lists) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N * F) return;
    const int p = mp_idx[i];
    if (p >= 0 && p < M && fvalid[i] && kvalid[i / F])
        lists[offs[p] + atomicAdd(&cursor[p], 1)] = i / F;
}

// One thread per point: sort its observers, then one count per distinct pair.
__global__ void covis_pairs_kernel(const int* offs, int* lists, int M, int N, int* W) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= M) return;
    const int lo = offs[p], hi = offs[p + 1];
    for (int i = lo + 1; i < hi; ++i) {
        const int x = lists[i];
        int j = i - 1;
        while (j >= lo && lists[j] > x) {
            lists[j + 1] = lists[j];
            --j;
        }
        lists[j + 1] = x;
    }
    for (int i = lo; i < hi; ++i) {
        const int a = lists[i];
        if (i > lo && lists[i - 1] == a) continue;
        for (int j = lo; j < hi; ++j) {
            const int b = lists[j];
            if (j > lo && lists[j - 1] == b) continue;
            atomicAdd(&W[(size_t)a * N + b], 1);
        }
    }
}

}  // namespace

// Residuals [E, 7] and Jacobians [E, 2, 7, 7] (side 0: tangent of e_i).
C_ENTRY int pg_linearize(const float* R, const float* t, const float* s, const int* e_i,
                         const int* e_j, const float* mR, const float* mt, const float* ms, int E,
                         float* r, float* J, cudaStream_t stream) {
    if (E > 0)
        linearize_kernel<<<(E * 14 + LIN_THREADS - 1) / LIN_THREADS, LIN_THREADS, 0, stream>>>(
            R, t, s, e_i, e_j, mR, mt, ms, E, r, J);
    return (int)cudaGetLastError();
}

// One Gauss-Newton iteration in place on (R, t, s); `work` holds
// N * (49 + 42) + E * 7 floats of scratch; writes the iteration's cost.
C_ENTRY int pg_step(float* R, float* t, float* s, const bool* fixed, int N, const int* e_i,
                    const int* e_j, const float* w, int E, const int* off, const int* inc,
                    const float* r, const float* J, int cg_iters, float lam, int last,
                    float* work, float* cost, cudaStream_t stream) {
    StepArgs A;
    A.R = R; A.t = t; A.s = s; A.fixed = fixed; A.N = N; A.e_i = e_i; A.e_j = e_j; A.w = w;
    A.E = E; A.off = off; A.inc = inc; A.r = r; A.J = J; A.cg_iters = cg_iters; A.lam = lam;
    A.damp = (float)((double)lam + 1e-8);
    A.last = last;
    A.Minv = work;
    A.x = work + (size_t)49 * N;
    A.rr = A.x + 7 * N;
    A.p = A.rr + 7 * N;
    A.z = A.p + 7 * N;
    A.Ap = A.z + 7 * N;
    A.a = A.Ap + 7 * N + 7 * N;
    A.cost = cost;
    step_kernel<<<1, STEP_THREADS, 0, stream>>>(A);
    return (int)cudaGetLastError();
}

C_ENTRY int covis_count(const int* mp_idx, const bool* fvalid, const bool* kvalid, int N, int F,
                        int M, int* cnt, cudaStream_t stream) {
    covis_count_kernel<<<(N * F + 255) / 256, 256, 0, stream>>>(mp_idx, fvalid, kvalid, N, F, M,
                                                                cnt);
    return (int)cudaGetLastError();
}

C_ENTRY int covis_fill(const int* mp_idx, const bool* fvalid, const bool* kvalid, int N, int F,
                       int M, const int* offs, int* cursor, int* lists, cudaStream_t stream) {
    covis_fill_kernel<<<(N * F + 255) / 256, 256, 0, stream>>>(mp_idx, fvalid, kvalid, N, F, M,
                                                               offs, cursor, lists);
    return (int)cudaGetLastError();
}

C_ENTRY int covis_pairs(const int* offs, int* lists, int M, int N, int* W, cudaStream_t stream) {
    covis_pairs_kernel<<<(M + 255) / 256, 256, 0, stream>>>(offs, lists, M, N, W);
    return (int)cudaGetLastError();
}
