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
// dot products. The covisibility count is bound by bytes: the N validity
// flags, one read of the live rows' observations (5 bytes each) and one
// write of the [N, N] counts, which dominates.
// Design: `pg_optimize` is one cooperative launch for the whole of
// `optimize` (cudaLaunchCooperativeKernel, one 256-thread CTA on each SM,
// grid.sync() between dependent phases). Each CTA owns a contiguous range
// of edges and one of vertices. Per Gauss-Newton iteration it linearizes
// its edges, one task per (edge, tangent direction): the residual's code
// in sim3.cuh over a one-direction dual number gives column k of the edge's
// 7x14 Jacobian, the same forward-mode derivative jacfwd takes, branch for
// branch (the end whose tangent is 0 is the end itself: exp(0) is exactly
// the identity). The Jacobians and residuals land in the CTA's shared
// memory (past its capacity, in device memory) and stay there for the
// iteration's 40 CG passes, so a pass reads no Jacobian from L2. Each
// weighted edge writes its two ends' 7x7 block terms (lower triangle) and
// gradient terms; after a grid barrier each vertex's owner adds them from a
// vertex-major incidence list ordered (vertex, side, edge), so the i-side
// terms add in edge order, then the j-side terms, as the reference's two
// segment sums do, with no float atomics, and inverts the damped block by
// Cholesky (a thread per column). A CG pass is three phases and three grid
// barriers: the edge phase forms p = z + beta p for its edges' ends (every
// CTA computes the same value from the same operands, so the direction is
// never written before it is read), a_e = w (J_i p_i + J_j p_j) and each
// side's J_s^T a_e into device memory; the vertex phase adds its vertices'
// terms in incidence order (A p and the p.Ap partial); the update phase
// forms alpha, x, r, z = M^-1 r and the r.z partial. Each dot product is
// the per-CTA partials added in CTA order, so two runs are bit-equal. Then
// the free vertices retract, the iteration's cost (sum r^2 w^2, from the
// linearization) is written and, on the last iteration, every rotation
// takes two polar steps. Edges of weight 0 are in no incidence list and
// add nothing, and a fixed vertex's gradient, direction and product are
// exactly 0 (the reference multiplies them by its free mask), so its block
// is neither built nor inverted. `pg_linearize` runs the same linearization
// alone (`linearize_edges`).
// The covisibility count is two launches and no [N, M] matrix, each a
// 1024-thread CTA a row (two on each SM). `covis_push`: a live keyframe
// (dead rows are never read) keeps, by a hash set of its points in shared
// memory, one of its observations of each point, whose row is appended to
// the point's observer list (an integer atomic a point gives its slot: the
// first 16 slots inline, the rest on a chain) and whose first observer
// records the point as touched. `covis_rows`: a live row adds, for each of
// its distinct points, one to its shared-memory count of every other
// observer of that point (one atomic a distinct row a warp,
// __match_any_sync), its own count of distinct points is the diagonal,
// and it writes its row of W once; a dead row writes zeros, so W needs no
// fill and each entry is written once. The
// last CTA (an atomic ticket) clears the touched points' counts and
// chains, which stay zero from call to call. Integer counts: exact in any
// order.

#include <cooperative_groups.h>

#include "common.cuh"
#define SIM3_SINCOSPI  // no large-argument reduction: no stack frame
#include "sim3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LIN_THREADS = 128;
constexpr int OPT_THREADS = 256;
constexpr int MAX_GRID = 1024;                // per-CTA partial slots
constexpr int EDGE_FLOATS = 2 * 49 + 7;       // an edge's two Jacobians and its residual
constexpr int HTERMS = 35;                    // 28 lower-triangle block terms, 7 gradient terms
constexpr int EDGE_CHUNK = 256;               // edges of a CG edge phase at a time
constexpr int SMEM_BUDGET = 200 * 1024;       // dynamic shared memory of a CTA at most
constexpr int GATHER = 4096;                  // floats of incidence terms gathered at a time
constexpr int GATHER_LOADS = 8;               // their loads a thread has in flight
constexpr int VERTEX_FLOATS = 49 + 5 * 7 + 2 * HTERMS;  // an owned vertex's state
enum Slot { SLOT_COST = 0, SLOT_RZ, SLOT_PAP, N_SLOT };

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

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

// Packed lower triangle: entry (i, j), j <= i, at i (i + 1) / 2 + j.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Column k of an edge's 7x14 Jacobian (k < 7: tangent k of S_i, else tangent
// k - 7 of S_j) and the residual r = log(Sm o (Si o Sj^-1)) at tangent 0.
__device__ __forceinline__ void linearize_column(const float* R, const float* t, const float* s,
                                                 int vi, int vj, const float* mR,
                                                 const float* mt, const float* ms, int e, int k,
                                                 float* col, float* res) {
    const int side = k >= 7 ? 1 : 0, dir = k - 7 * side;
    const int va = side ? vj : vi, vo = side ? vi : vj;
    Dual Ra[9], ta[3], Ro[9], to[3], Rm[9], tm[3];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        Ra[q] = mk(ld(R + 9 * va + q), 0.f);
        Ro[q] = mk(ld(R + 9 * vo + q), 0.f);
        Rm[q] = mk(mR[9 * e + q], 0.f);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        ta[q] = mk(ld(t + 3 * va + q), 0.f);
        to[q] = mk(ld(t + 3 * vo + q), 0.f);
        tm[q] = mk(mt[3 * e + q], 0.f);
    }
    const Dual sa = mk(ld(s + va), 0.f), so = mk(ld(s + vo), 0.f), sm = mk(ms[e], 0.f);
    Dual xi[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) xi[q] = mk(0.f, q == dir ? 1.f : 0.f);
    // retract(S, xi) = exp(xi) o S of the end that carries the direction.
    Dual ER[9], Et[3], Es, R2[9], t2[3], s2;
    sim3_exp(xi, ER, Et, Es);
    sim3_compose(ER, Et, Es, Ra, ta, sa, R2, t2, s2);
    Dual Ri[9], ti[3], Rj[9], tj[3];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        Ri[q] = side ? Ro[q] : R2[q];
        Rj[q] = side ? R2[q] : Ro[q];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        ti[q] = side ? to[q] : t2[q];
        tj[q] = side ? t2[q] : to[q];
    }
    const Dual si = side ? so : s2, sj = side ? s2 : so;
    // r = log(Sm o (Si o Sj^-1)).
    Dual Rji[9], tji[3], sji, Rc[9], tc[3], sc, Rr[9], tr[3], sr, out[7];
    sim3_inverse(Rj, tj, sj, Rji, tji, sji);
    sim3_compose(Ri, ti, si, Rji, tji, sji, Rc, tc, sc);
    sim3_compose(Rm, tm, sm, Rc, tc, sc, Rr, tr, sr);
    sim3_log(Rr, tr, sr, out);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
        col[q] = out[q].d;
        res[q] = out[q].v;
    }
}

__global__ void linearize_kernel(const float* R, const float* t, const float* s, const int* e_i,
                                 const int* e_j, const float* mR, const float* mt,
                                 const float* ms, int E, float* r_out, float* J_out) {
    const int task = blockIdx.x * blockDim.x + threadIdx.x;
    if (task >= E * 14) return;
    const int e = task / 14, k = task % 14;
    float col[7], res[7];
    linearize_column(R, t, s, e_i[e], e_j[e], mR, mt, ms, e, k, col, res);
    const int side = k / 7, c = k % 7;
    float* Je = J_out + (size_t)(2 * e + side) * 49;
#pragma unroll
    for (int q = 0; q < 7; ++q) Je[7 * q + c] = col[q];
    if (k == 0)
#pragma unroll
        for (int q = 0; q < 7; ++q) r_out[7 * e + q] = res[q];
}

// Column c of the inverse of the damped block (packed lower triangle H):
// (H + lam) + 1e-8, then + 1e-6 on the diagonal; Cholesky with
// smallmat.chol_unrolled's pivot clamp, then L L^T x = e_c.
__device__ __forceinline__ void block_inverse_column(const float* H, float lam, int c, float* x) {
    float A[28], L[28];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float h = H[tri(i, j)];
            if (i == j) {
                h = (h + lam) + 1e-8f;
                h += 1e-6f;
            }
            A[tri(i, j)] = h;
        }
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float v = A[tri(i, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) v -= L[tri(i, k)] * L[tri(j, k)];
            L[tri(i, j)] = (i == j) ? sqrtf(fmaxf(v, 1e-12f)) : v / L[tri(j, j)];
        }
    float y[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        float v = (i == c) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < i; ++k) v -= L[tri(i, k)] * y[k];
        y[i] = v / L[tri(i, i)];
    }
#pragma unroll
    for (int i = 6; i >= 0; --i) {
        float v = y[i];
#pragma unroll
        for (int k = i + 1; k < 7; ++k) v -= L[tri(k, i)] * x[k];
        x[i] = v / L[tri(i, i)];
    }
}

struct OptArgs {
    float *R, *t, *s;  // [N, 9], [N, 3], [N], in place
    const bool* fixed;
    int N;
    const int *e_i, *e_j;
    const float *mR, *mt, *ms, *w;
    int E;
    const int *off, *inc;  // incidence list: off [N + 1], inc (side * E + edge)
    int n_iters, cg_iters;
    float lam, damp;
    float* costs;  // [n_iters]
    // Device-memory scratch.
    float* gJ;    // [E, EDGE_FLOATS]: edges past a CTA's shared capacity
    float* hcon;  // [E, 2, HTERMS]: each side's block and gradient terms
    float* con;   // [E, 2, 7]: each side's J^T a of a CG pass
    float* z;     // [N, 7]: M^-1 r, read by the edge phases
    float* pbuf;  // [2, N, 7]: the CG direction of even and odd passes
    float* red;   // [N_SLOT, MAX_GRID]: per-CTA partials
    int vpt;       // vertices a CTA owns at most
    int sh_edges;  // edges a CTA keeps in shared memory
};

// Size of OptArgs' scratch in floats (the C entry refuses a smaller one).
size_t opt_scratch(int N, int E) {
    return (size_t)E * (EDGE_FLOATS + 2 * HTERMS + 14) + (size_t)N * 21 +
           (size_t)N_SLOT * MAX_GRID;
}

// The per-CTA partials of `slot` added in CTA order; every thread gets it.
__device__ float grid_total(const OptArgs& A, int slot, float* sh) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
        float v = 0.f;
        for (int i = lane; i < (int)gridDim.x; i += 32) v += ld(A.red + slot * MAX_GRID + i);
        v = warp_sum(v);
        if (lane == 0) sh[32] = v;
    }
    __syncthreads();
    const float r = sh[32];
    __syncthreads();
    return r;
}

// The i-side and j-side sums, in incidence order, of `stride` terms per
// incidence of this CTA's vertices [v0, v0 + nv) from src [E, 2, stride],
// into acc0 / acc1 [nv, stride] (added to what they hold). The CTA's
// incidences are one run of the list; they are gathered into buf a chunk
// at a time, GATHER_LOADS loads a thread in flight.
__device__ void gather_sums(const OptArgs& A, const float* src, int stride, int v0, int nv,
                           float* buf, float* acc0, float* acc1) {
    const int tid = threadIdx.x, nt = OPT_THREADS, E = A.E;
    const int ib = A.off[v0], ie = A.off[v0 + nv], per = GATHER / stride;
    for (int c = ib; c < ie; c += per) {
        const int n = min(per, ie - c) * stride;
        for (int t0 = tid; t0 < n; t0 += nt * GATHER_LOADS) {
            float val[GATHER_LOADS];
#pragma unroll
            for (int u = 0; u < GATHER_LOADS; ++u) {
                const int t = t0 + u * nt;
                val[u] = 0.f;
                if (t < n) {
                    const int code = __ldg(A.inc + c + t / stride);
                    const int side = code >= E ? 1 : 0;
                    val[u] = ld(src + ((size_t)(code - side * E) * 2 + side) * stride + t % stride);
                }
            }
#pragma unroll
            for (int u = 0; u < GATHER_LOADS; ++u)
                if (t0 + u * nt < n) buf[t0 + u * nt] = val[u];
        }
        __syncthreads();
        for (int task = tid; task < nv * stride; task += nt) {
            const int v = v0 + task / stride, f = task % stride;
            if (A.fixed[v]) continue;
            const int lo = max(A.off[v], c), hi = min(A.off[v + 1], c + per);
            float a0 = acc0[task], a1 = acc1[task];
            for (int k = lo; k < hi; ++k) {
                const float u = buf[(k - c) * stride + f];
                if (__ldg(A.inc + k) >= E) a1 += u; else a0 += u;
            }
            acc0[task] = a0;
            acc1[task] = a1;
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(OPT_THREADS, 1) pg_optimize_kernel(OptArgs A) {
    extern __shared__ float smem[];
    __shared__ float sh[33];
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x, nt = OPT_THREADS, b = blockIdx.x, G = gridDim.x;
    const int N = A.N, E = A.E;
    const int ept = (E + G - 1) / G;
    const int e0 = min(E, b * ept), ne = min(E, e0 + ept) - e0;
    const int v0 = min(N, b * A.vpt), nv = min(N, v0 + A.vpt) - v0;
    const int chunk = min(max(ept, 1), EDGE_CHUNK);
    // Shared memory: the owned vertices' state, the edges' Jacobians and
    // residuals, a CG edge phase's staging, the incidence gathers.
    float* sMinv = smem;                        // [vpt, 49]
    float* sX = sMinv + (size_t)A.vpt * 49;     // [vpt, 7] each: x, r, z, A p, p
    float* sR = sX + (size_t)A.vpt * 7;
    float* sZ = sR + (size_t)A.vpt * 7;
    float* sAp = sZ + (size_t)A.vpt * 7;
    float* sPo = sAp + (size_t)A.vpt * 7;
    float* sAcc0 = sPo + (size_t)A.vpt * 7;     // [vpt, 35] i-side sums
    float* sAcc1 = sAcc0 + (size_t)A.vpt * HTERMS;  // [vpt, 35] j-side sums
    float* sE = sAcc1 + (size_t)A.vpt * HTERMS;     // [sh_edges, EDGE_FLOATS]
    float* sP = sE + (size_t)A.sh_edges * EDGE_FLOATS;  // [chunk, 14]: p x free of both ends
    float* sA = sP + (size_t)chunk * 14;                // [chunk, 7]
    float* sBuf = sA + (size_t)chunk * 7;               // [GATHER]
    int* sEnd = reinterpret_cast<int*>(sBuf + GATHER);  // [ept, 2]: the edges' ends
    float* sFree = reinterpret_cast<float*>(sEnd + 2 * (size_t)ept);  // [ept, 2]
    for (int t = tid; t < 2 * ne; t += nt) {
        const int e = e0 + t / 2, v = (t & 1) ? A.e_j[e] : A.e_i[e];
        sEnd[t] = v;
        sFree[t] = A.fixed[v] ? 0.f : 1.f;
    }
    auto edge = [&](int le) -> float* {
        return le < A.sh_edges ? sE + (size_t)le * EDGE_FLOATS
                               : A.gJ + (size_t)(e0 + le) * EDGE_FLOATS;
    };

    for (int it = 0; it < A.n_iters; ++it) {
        // Linearize this CTA's edges (an edge of weight 0 only for its residual).
        for (int task = tid; task < ne * 14; task += nt) {
            const int le = task / 14, k = task - 14 * le, e = e0 + le;
            if (k > 0 && A.w[e] == 0.f) continue;
            float col[7], res[7];
            linearize_column(A.R, A.t, A.s, A.e_i[e], A.e_j[e], A.mR, A.mt, A.ms, e, k, col,
                             res);
            float* Je = edge(le);
            const int side = k >= 7 ? 1 : 0, c = k - 7 * side;
#pragma unroll
            for (int q = 0; q < 7; ++q) Je[49 * side + 7 * q + c] = col[q];
            if (k == 0)
#pragma unroll
                for (int q = 0; q < 7; ++q) Je[98 + q] = res[q];
        }
        for (int task = tid; task < nv * HTERMS; task += nt) sAcc0[task] = sAcc1[task] = 0.f;
        __syncthreads();
        // The cost partial and each weighted edge's block and gradient terms.
        float part = 0.f;
        for (int le = tid; le < ne; le += nt) {
            const float we = A.w[e0 + le];
            const float* re = edge(le) + 98;
#pragma unroll
            for (int q = 0; q < 7; ++q) part += (re[q] * re[q]) * (we * we);
        }
        part = block_sum(part, sh);
        if (tid == 0) A.red[SLOT_COST * MAX_GRID + b] = part;
        for (int task = tid; task < ne * 2 * HTERMS; task += nt) {
            const int le = task / (2 * HTERMS), rem = task - 2 * HTERMS * le;
            const int side = rem / HTERMS, item = rem - HTERMS * side, e = e0 + le;
            const float we = A.w[e];
            if (we == 0.f) continue;
            const float* Je = edge(le) + 49 * side;
            float v = 0.f;
            if (item < 28) {
                int i = 0;
                while (tri(i + 1, 0) <= item) ++i;
                const int j = item - tri(i, 0);
#pragma unroll
                for (int q = 0; q < 7; ++q) v += (Je[7 * q + i] * we) * Je[7 * q + j];
            } else {
                const int i = item - 28;
                const float* re = edge(le) + 98;
#pragma unroll
                for (int q = 0; q < 7; ++q) v += (Je[7 * q + i] * we) * re[q];
            }
            A.hcon[((size_t)e * 2 + side) * HTERMS + item] = v;
        }
        grid.sync();
        if (b == 0) {
            const float cost = grid_total(A, SLOT_COST, sh);
            if (tid == 0) A.costs[it] = cost;
        }
        // Each free vertex's block and gradient, in incidence order; the
        // damped blocks' inverses (a thread a column); r, x, z.
        gather_sums(A, A.hcon, HTERMS, v0, nv, sBuf, sAcc0, sAcc1);
        for (int task = tid; task < nv * HTERMS; task += nt) sAcc0[task] += sAcc1[task];
        __syncthreads();
        for (int task = tid; task < nv * 7; task += nt) {
            const int lv = task / 7, c = task - 7 * lv;
            if (A.fixed[v0 + lv]) continue;
            float col[7];
            block_inverse_column(sAcc0 + (size_t)lv * HTERMS, A.lam, c, col);
#pragma unroll
            for (int i = 0; i < 7; ++i) sMinv[lv * 49 + 7 * i + c] = col[i];
        }
        for (int task = tid; task < nv * 7; task += nt) {
            const int lv = task / 7, i = task % 7;
            sX[task] = 0.f;
            sR[task] = A.fixed[v0 + lv] ? 0.f : -sAcc0[lv * HTERMS + 28 + i];
        }
        __syncthreads();
        part = 0.f;
        for (int task = tid; task < nv * 7; task += nt) {
            const int lv = task / 7, i = task % 7;
            float zi = 0.f;
            if (!A.fixed[v0 + lv]) {
                const float* M = sMinv + lv * 49 + 7 * i;
#pragma unroll
                for (int j = 0; j < 7; ++j) zi += M[j] * sR[7 * lv + j];
            }
            sZ[task] = zi;
            A.z[7 * v0 + task] = zi;
            part += sR[task] * zi;
        }
        part = block_sum(part, sh);
        if (tid == 0) A.red[SLOT_RZ * MAX_GRID + b] = part;
        grid.sync();
        float rz = grid_total(A, SLOT_RZ, sh), beta = 0.f;

        for (int k = 0; k < A.cg_iters; ++k) {
            const float* pprev = A.pbuf + (size_t)((k + 1) & 1) * N * 7;
            float* pcur = A.pbuf + (size_t)(k & 1) * N * 7;
            // Edge phase: p = z (first pass) or z + beta p of the previous
            // pass, here for this CTA's vertices and for its edges' ends.
            for (int task = tid; task < nv * 7; task += nt) {
                const float pv = k == 0 ? sZ[task] : __fmaf_rn(beta, sPo[task], sZ[task]);
                sPo[task] = pv;
                pcur[7 * v0 + task] = pv;
                sAcc0[task] = sAcc1[task] = 0.f;
            }
            for (int c0 = 0; c0 < ne; c0 += chunk) {
                const int nc = min(chunk, ne - c0);
                for (int t0 = tid; t0 < nc * 14; t0 += nt * GATHER_LOADS) {
                    float zz[GATHER_LOADS], pp[GATHER_LOADS];
#pragma unroll
                    for (int u = 0; u < GATHER_LOADS; ++u) {
                        const int task = t0 + u * nt;
                        zz[u] = pp[u] = 0.f;
                        if (task < nc * 14) {
                            const int lc = task / 14, rem = task - 14 * lc;
                            const int o = 7 * sEnd[2 * (c0 + lc) + rem / 7] + rem % 7;
                            zz[u] = ld(A.z + o);
                            if (k > 0) pp[u] = ld(pprev + o);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < GATHER_LOADS; ++u) {
                        const int task = t0 + u * nt;
                        if (task >= nc * 14) continue;
                        const int lc = task / 14, rem = task - 14 * lc;
                        const float pv = k == 0 ? zz[u] : __fmaf_rn(beta, pp[u], zz[u]);
                        sP[task] = pv * sFree[2 * (c0 + lc) + rem / 7];
                    }
                }
                __syncthreads();
                for (int task = tid; task < nc * 7; task += nt) {
                    const int lc = task / 7, q = task - 7 * lc, e = e0 + c0 + lc;
                    const float we = A.w[e];
                    if (we == 0.f) continue;
                    const float* Ji = edge(c0 + lc);
                    const float* pe = sP + 14 * lc;
                    float si = 0.f, sj = 0.f;
#pragma unroll
                    for (int c = 0; c < 7; ++c) {
                        si += Ji[7 * q + c] * pe[c];
                        sj += Ji[49 + 7 * q + c] * pe[7 + c];
                    }
                    sA[task] = (si + sj) * we;
                }
                __syncthreads();
                for (int task = tid; task < nc * 14; task += nt) {
                    const int lc = task / 14, rem = task - 14 * lc, e = e0 + c0 + lc;
                    const int side = rem / 7, i = rem - 7 * side;
                    if (A.w[e] == 0.f) continue;
                    const float* Je = edge(c0 + lc) + 49 * side;
                    const float* ae = sA + 7 * lc;
                    float v = 0.f;
#pragma unroll
                    for (int q = 0; q < 7; ++q) v += Je[7 * q + i] * ae[q];
                    A.con[((size_t)e * 2 + side) * 7 + i] = v;
                }
                __syncthreads();
            }
            grid.sync();
            // Vertex phase: A p of this CTA's vertices and the p.Ap partial.
            gather_sums(A, A.con, 7, v0, nv, sBuf, sAcc0, sAcc1);
            part = 0.f;
            for (int task = tid; task < nv * 7; task += nt) {
                const float pv = sPo[task];
                const float ap =
                    A.fixed[v0 + task / 7] ? 0.f : (sAcc0[task] + sAcc1[task]) + A.damp * pv;
                sAp[task] = ap;
                part += pv * ap;
            }
            part = block_sum(part, sh);
            if (tid == 0) A.red[SLOT_PAP * MAX_GRID + b] = part;
            grid.sync();
            // Update phase: alpha, x, r, z and the r.z partial.
            const float pAp = grid_total(A, SLOT_PAP, sh);
            const float alpha = rz / (fabsf(pAp) < 1e-20f ? 1e-20f : pAp);
            for (int task = tid; task < nv * 7; task += nt) {
                if (A.fixed[v0 + task / 7]) continue;
                sX[task] += alpha * sPo[task];
                sR[task] -= alpha * sAp[task];
            }
            __syncthreads();
            part = 0.f;
            for (int task = tid; task < nv * 7; task += nt) {
                const int lv = task / 7, i = task % 7;
                float zi = 0.f;
                if (!A.fixed[v0 + lv]) {
                    const float* M = sMinv + lv * 49 + 7 * i;
#pragma unroll
                    for (int j = 0; j < 7; ++j) zi += M[j] * sR[7 * lv + j];
                }
                sZ[task] = zi;
                A.z[7 * v0 + task] = zi;
                part += sR[task] * zi;
            }
            part = block_sum(part, sh);
            if (k == A.cg_iters - 1) break;  // the last pass's beta is not used
            if (tid == 0) A.red[SLOT_RZ * MAX_GRID + b] = part;
            grid.sync();
            const float rz2 = grid_total(A, SLOT_RZ, sh);
            beta = rz2 / (fabsf(rz) < 1e-20f ? 1e-20f : rz);
            rz = rz2;
        }
        __syncthreads();
        // Retract the free vertices; on the last iteration two polar steps
        // of every rotation.
        const bool last = it == A.n_iters - 1;
        for (int lv = tid; lv < nv; lv += nt) {
            const int v = v0 + lv;
            float Rv[9], tv[3], sv = ld(A.s + v);
#pragma unroll
            for (int q = 0; q < 9; ++q) Rv[q] = ld(A.R + 9 * v + q);
#pragma unroll
            for (int q = 0; q < 3; ++q) tv[q] = ld(A.t + 3 * v + q);
            if (!A.fixed[v]) {
                float xv[7], ER[9], Et[3], Es, R2[9], t2[3], s2;
#pragma unroll
                for (int q = 0; q < 7; ++q) xv[q] = sX[7 * lv + q];
                sim3_exp(xv, ER, Et, Es);
                sim3_compose(ER, Et, Es, Rv, tv, sv, R2, t2, s2);
#pragma unroll
                for (int q = 0; q < 9; ++q) Rv[q] = R2[q];
#pragma unroll
                for (int q = 0; q < 3; ++q) tv[q] = t2[q];
                sv = s2;
            }
            if (last)
#pragma unroll
                for (int rep = 0; rep < 2; ++rep) {
                    float RtR[9], Rt[9], M[9], Rn[9];
#pragma unroll
                    for (int i = 0; i < 3; ++i)
#pragma unroll
                        for (int j = 0; j < 3; ++j) Rt[3 * i + j] = Rv[3 * j + i];
                    mat3_mul(Rt, Rv, RtR);
#pragma unroll
                    for (int q = 0; q < 9; ++q) M[q] = ((q % 4 == 0) ? 3.f : 0.f) - RtR[q];
                    mat3_mul(Rv, M, Rn);
#pragma unroll
                    for (int q = 0; q < 9; ++q) Rv[q] = 0.5f * Rn[q];
                }
#pragma unroll
            for (int q = 0; q < 9; ++q) A.R[9 * v + q] = Rv[q];
#pragma unroll
            for (int q = 0; q < 3; ++q) A.t[3 * v + q] = tv[q];
            A.s[v] = sv;
        }
        grid.sync();
    }
}

// Covisibility count (`covis_push`, `covis_rows`).
constexpr int COV_THREADS = 1024;
constexpr int COV_INLINE = 16;  // observers of a point kept inline; the rest chained

struct CovArgs {
    const int* mp_idx;  // [N, F]
    const bool* fvalid; // [N, F]
    const bool* kvalid; // [N]
    int N, F, M, log2_table;
    int* cnt;           // [M] observers of each point (workspace: zero between calls)
    int* head;          // [M] chain head + 1 of its overflow observers (workspace)
    int* ctl;           // [2] touched points, CTA ticket (workspace)
    int* inl;           // [M, COV_INLINE] the first observers' rows
    int* nxt;           // [N F] the next chained observation + 1
    uint8_t* first;     // [N F] the observation that stands for its (row, point)
    int* touched;       // [min(M, N F)] points with an observer
    int* W;             // [N, N]
};

// One observation of a live row: its point when valid and the first of the
// row's observations of it (the row's hash set), else -1.
__device__ __forceinline__ int first_point(const CovArgs& a, int* table, int T, int p, bool ok) {
    if (!ok || p < 0 || p >= a.M) return -1;
    unsigned h = ((unsigned)p * 2654435761u) >> (32 - a.log2_table);
    while (true) {
        const int old = atomicCAS(table + h, 0, p + 1);
        if (old == 0) return p;
        if (old == p + 1) return -1;
        h = (h + 1) & (T - 1);
    }
}

// Push: live row r's distinct points onto their observer lists. Each
// thread takes observations f and f + COV_THREADS of a round of
// 2 COV_THREADS: both loads first, then both slots, then one range of the
// touched list for the round's new points.
__device__ void push_row(const CovArgs& a, int r, int* table, int* s_new, int* s_base) {
    const int T = 1 << a.log2_table;
    for (int i = threadIdx.x; i < T; i += COV_THREADS) table[i] = 0;
    if (threadIdx.x == 0) *s_new = 0;
    __syncthreads();
    for (int f0 = 0; f0 < a.F; f0 += 2 * COV_THREADS) {
        int o[2], p[2], local[2] = {-1, -1};
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int f = f0 + u * COV_THREADS + threadIdx.x;
            o[u] = r * a.F + f;
            ok[u] = f < a.F && a.fvalid[o[u]];
            p[u] = f < a.F ? a.mp_idx[o[u]] : -1;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int f = f0 + u * COV_THREADS + threadIdx.x;
            p[u] = first_point(a, table, T, p[u], ok[u]);
            if (f < a.F) a.first[o[u]] = p[u] >= 0;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            if (p[u] < 0) continue;
            const int slot = atomicAdd(a.cnt + p[u], 1);
            if (slot == 0) local[u] = atomicAdd(s_new, 1);
            if (slot < COV_INLINE) a.inl[(size_t)p[u] * COV_INLINE + slot] = r;
            else a.nxt[o[u]] = atomicExch(a.head + p[u], o[u] + 1);
        }
        __syncthreads();  // the round's new points: one range of the touched list
        if (threadIdx.x == 0) {
            *s_base = *s_new ? atomicAdd(a.ctl, *s_new) : 0;
            *s_new = 0;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (local[u] >= 0) a.touched[*s_base + local[u]] = p[u];
    }
    __syncthreads();
}

// Row r of W from the observer lists: for each of its distinct points, one
// to its shared-memory count of every other observer (one atomic a
// distinct row a warp); its own count of distinct points on the diagonal.
__device__ void count_row(const CovArgs& a, int r, int* acc, int* s_self) {
    const int N = a.N, lane = threadIdx.x & 31;
    for (int j = threadIdx.x; j < N; j += COV_THREADS) acc[j] = 0;
    if (threadIdx.x == 0) *s_self = 0;
    __syncthreads();
    int own = 0;
    for (int f0 = 0; f0 < a.F; f0 += 2 * COV_THREADS) {
        // Two observations a thread, every load of both issued first: the
        // flag and point, then the point's count and inline observers.
        bool fi[2];
        int p[2], k[2] = {0, 0};
        int4 v[2][COV_INLINE / 4] = {};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int f = f0 + u * COV_THREADS + threadIdx.x, o = r * a.F + f;
            fi[u] = f < a.F && __ldcg(a.first + o);
            p[u] = f < a.F ? a.mp_idx[o] : 0;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            if (!fi[u]) continue;
            const int4* q = reinterpret_cast<const int4*>(a.inl + (size_t)p[u] * COV_INLINE);
#pragma unroll
            for (int i = 0; i < COV_INLINE / 4; ++i) v[u][i] = __ldcg(q + i);
            k[u] = __ldcg(a.cnt + p[u]);
            ++own;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int kk = min(k[u], COV_INLINE), kmax = __reduce_max_sync(0xffffffffu, kk);
#pragma unroll
            for (int s = 0; s < COV_INLINE; ++s) {
                if (s >= kmax) break;
                const int4 w4 = v[u][s / 4];
                int j = (s & 3) == 0 ? w4.x : (s & 3) == 1 ? w4.y : (s & 3) == 2 ? w4.z : w4.w;
                if (s >= kk || j == r) j = -1;
                const unsigned act = __ballot_sync(0xffffffffu, j >= 0);
                if (j >= 0) {
                    const unsigned peers = __match_any_sync(act, j);
                    if (lane == __ffs(peers) - 1) atomicAdd(acc + j, __popc(peers));
                }
            }
            // The chained observers, k - COV_INLINE of them.
            for (int c = k[u] > COV_INLINE ? __ldcg(a.head + p[u]) : 0, left = k[u] - COV_INLINE;
                 c != 0 && left > 0; c = __ldcg(a.nxt + c - 1), --left)
                if ((c - 1) / a.F != r) atomicAdd(acc + (c - 1) / a.F, 1);
        }
    }
    own = __reduce_add_sync(0xffffffffu, own);
    if (lane == 0 && own) atomicAdd(s_self, own);
    __syncthreads();
    int* out = a.W + (size_t)r * N;
    for (int j = threadIdx.x; j < N; j += COV_THREADS) out[j] = j == r ? *s_self : acc[j];
    __syncthreads();
}

// The validity of the CTA's rows blockIdx.x + k gridDim.x, all loaded at once.
__device__ __forceinline__ void load_rows_valid(const CovArgs& a, bool* v) {
    for (int k = threadIdx.x; blockIdx.x + k * gridDim.x < (unsigned)a.N; k += COV_THREADS)
        v[k] = a.kvalid[blockIdx.x + k * gridDim.x];
    __syncthreads();
}

// Launch 1: a CTA a live row, pushed.
__global__ void __launch_bounds__(COV_THREADS) covis_push_kernel(CovArgs a) {
    extern __shared__ int table[];  // the row's hash set; row flags
    __shared__ int s_new, s_base;
    bool* valid = reinterpret_cast<bool*>(table + (1 << a.log2_table));
    load_rows_valid(a, valid);
    for (int r = blockIdx.x, k = 0; r < a.N; r += gridDim.x, ++k)
        if (valid[k]) push_row(a, r, table, &s_new, &s_base);
}

// Launch 2: a CTA a row: a live row counted, a dead row zeros; the last
// CTA (an atomic ticket) clears the touched points, so the next call
// starts from zero.
__global__ void __launch_bounds__(COV_THREADS) covis_rows_kernel(CovArgs a) {
    extern __shared__ int acc[];  // [N] a row's counts; row flags
    __shared__ int s_self;
    __shared__ bool last;
    const int N = a.N;
    bool* valid = reinterpret_cast<bool*>(acc + N);
    load_rows_valid(a, valid);
    for (int r = blockIdx.x, k = 0; r < N; r += gridDim.x, ++k) {
        if (valid[k]) {
            count_row(a, r, acc, &s_self);
            continue;
        }
        int* out = a.W + (size_t)r * N;  // a dead row: zeros
        if ((N & 3) == 0)
            for (int j = threadIdx.x; j < N / 4; j += COV_THREADS)
                reinterpret_cast<int4*>(out)[j] = make_int4(0, 0, 0, 0);
        else
            for (int j = threadIdx.x; j < N; j += COV_THREADS) out[j] = 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(a.ctl + 1, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int n = __ldcg(a.ctl);
    for (int i = threadIdx.x; i < n; i += COV_THREADS) {
        const int p = __ldcg(a.touched + i);
        a.cnt[p] = 0;
        a.head[p] = 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a.ctl[0] = 0;
        a.ctl[1] = 0;
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

// The whole of `optimize` in one cooperative launch: n_iters Gauss-Newton
// iterations of cg_iters PCG passes in place on (R, t, s), the cost of each
// iteration into costs [n_iters]. w [E] is the edge weight (0: left out),
// (off [N + 1], inc) the incidence list of the weighted edges ordered
// (vertex, side, edge), inc holding side * E + edge. work: at least
// E (2 * 49 + 7 + 70 + 14) + 21 N + 3 * 1024 floats. Fails (no launch) when
// the card cannot hold one CTA on each SM at once, or a CTA's vertices
// (N / SMs of them, ~600 bytes each) leave no room in its shared memory.
C_ENTRY int pg_optimize(float* R, float* t, float* s, const bool* fixed, int N, const int* e_i,
                        const int* e_j, const float* mR, const float* mt, const float* ms,
                        const float* w, int E, const int* off, const int* inc, int n_iters,
                        int cg_iters, float lam, float* costs, float* work, int work_floats,
                        cudaStream_t stream) {
    if (N <= 0 || E < 0 || opt_scratch(N, E) > (size_t)work_floats)
        return (int)cudaErrorInvalidValue;
    static int sms = 0;
    if (sms == 0) {
        int dev = 0, coop = 0, n = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess ||
            !coop)
            return (int)cudaErrorCooperativeLaunchTooLarge;
        sms = n;
    }
    const int G = sms < MAX_GRID ? sms : MAX_GRID;
    const int ept = (E + G - 1) / G, vpt = (N + G - 1) / G;
    const int chunk = ept < 1 ? 1 : (ept < EDGE_CHUNK ? ept : EDGE_CHUNK);
    // Floats of shared memory besides the edges' Jacobians; the edges take
    // what the budget leaves (the rest live in device memory).
    const int fixed_floats = vpt * VERTEX_FLOATS + chunk * 21 + GATHER + 4 * ept;
    const int cap = (SMEM_BUDGET / (int)sizeof(float) - fixed_floats) / EDGE_FLOATS;
    if (cap < 0) return (int)cudaErrorInvalidValue;  // N beyond ~50 000 at 132 SMs
    const int sh_edges = ept < cap ? ept : cap;
    const size_t smem = ((size_t)sh_edges * EDGE_FLOATS + fixed_floats) * sizeof(float);
    int per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(pg_optimize_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pg_optimize_kernel, OPT_THREADS,
                                                            smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    OptArgs A;
    A.R = R; A.t = t; A.s = s; A.fixed = fixed; A.N = N; A.e_i = e_i; A.e_j = e_j;
    A.mR = mR; A.mt = mt; A.ms = ms; A.w = w; A.E = E; A.off = off; A.inc = inc;
    A.n_iters = n_iters; A.cg_iters = cg_iters; A.lam = lam;
    A.damp = (float)((double)lam + 1e-8);
    A.costs = costs;
    float* f = work;
    auto take = [&f](size_t n) {
        float* q = f;
        f += n;
        return q;
    };
    A.gJ = take((size_t)E * EDGE_FLOATS);
    A.hcon = take((size_t)E * 2 * HTERMS);
    A.con = take((size_t)E * 14);
    A.z = take((size_t)N * 7);
    A.pbuf = take((size_t)N * 14);
    A.red = take((size_t)N_SLOT * MAX_GRID);
    A.vpt = vpt;
    A.sh_edges = sh_edges;
    void* args[] = {(void*)&A};
    return (int)cudaLaunchCooperativeKernel((const void*)pg_optimize_kernel, dim3(G),
                                            dim3(OPT_THREADS), args, smem, stream);
}

// The covisibility count's state: work [2 M + 2] ints (zero between calls;
// the launches leave it so), scratch at least
// `covisibility.covis_scratch_ints` ints.
static CovArgs covis_args(const int* mp_idx, const bool* fvalid, const bool* kvalid, int N, int F,
                          int M, int* work, int* scratch, int* W) {
    CovArgs a;
    a.mp_idx = mp_idx; a.fvalid = fvalid; a.kvalid = kvalid; a.N = N; a.F = F; a.M = M;
    int lt = 6;
    while ((1 << lt) < 2 * F) ++lt;
    a.log2_table = lt;
    a.cnt = work;
    a.head = work + M;
    a.ctl = work + 2 * (size_t)M;
    const size_t nf = (size_t)N * F;
    a.inl = scratch;
    a.nxt = scratch + (size_t)M * COV_INLINE;
    a.touched = a.nxt + nf;
    a.first = reinterpret_cast<uint8_t*>(a.touched + (nf < (size_t)M ? nf : (size_t)M));
    a.W = W;
    return a;
}

static int covis_grid(int N) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            sms = 132;
    }
    return N < 2 * sms ? N : 2 * sms;
}

static int covis_launch(const void* kernel, const CovArgs& a, size_t smem, cudaStream_t stream) {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&a};
    e = cudaLaunchKernel(kernel, dim3(covis_grid(a.N)), dim3(COV_THREADS), args, smem, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Launch 1: each live row's distinct points onto their observer lists.
C_ENTRY int covis_push(const int* mp_idx, const bool* fvalid, const bool* kvalid, int N, int F,
                       int M, int* work, int* scratch, int* W, cudaStream_t stream) {
    if (N <= 0) return 0;
    const CovArgs a = covis_args(mp_idx, fvalid, kvalid, N, F, M, work, scratch, W);
    const int grid = covis_grid(N);
    return covis_launch((const void*)covis_push_kernel, a,
                        (sizeof(int) << a.log2_table) + (N + grid - 1) / grid, stream);
}

// Launch 2: W [N, N], every entry written: the live rows from the observer
// lists, the dead rows zeros; clears the state for the next call.
C_ENTRY int covis_rows(const int* mp_idx, const bool* fvalid, const bool* kvalid, int N, int F,
                       int M, int* work, int* scratch, int* W, cudaStream_t stream) {
    if (N <= 0) return 0;
    const CovArgs a = covis_args(mp_idx, fvalid, kvalid, N, F, M, work, scratch, W);
    const int grid = covis_grid(N);
    return covis_launch((const void*)covis_rows_kernel, a,
                        sizeof(int) * (size_t)N + (N + grid - 1) / grid, stream);
}
