// K14 `kmajority`: binary k-majority clustering, the vocabulary's training.
//
// Replaces corbslam_tpu/place/vocab.py _kmajority (a lax.scan of a flat
// Hamming argmin as an int8 MXU product, two segment_sums and the majority
// vote), the chunked accumulations of train_chunked and of both levels of
// train_hierarchical (level 2: the argmin over the descriptor's own group
// block), the idf of train / train_chunked / train_hierarchical, and the
// k-majority of build_tree.
//
// Bound on the H100: the assignment by operations. Per iteration every
// descriptor meets every centre (flat) or the B centres of its block: an
// inner product of 256 bits, 1.67 T int8 operations over 8 iterations of
// N 398k x W 1024, ~0.84 ms at the dense int8 peak; the vote reads each
// descriptor's 32 bytes once an iteration (12.7 MB there, in L2).
// Design: `km_train` is one cooperative launch for a whole call
// (cudaLaunchCooperativeKernel; 256-thread CTAs of at most 128 registers,
// two on each SM from 32768 rows, else one; grid.sync() between dependent
// phases; one instance each for level 2 and for row weights), four phases
// an iteration (a fifth barrier beyond 4096 centres) and no [W, 256]
// tally in device memory; no atomic adds a bit.
// - Assign: Hamming(a, c) = popc(a) + popc(c) - 2 <a, c>, and popc(a) is
//   the same for every centre, so the nearest centre has the least key
//   ((popc(c) + 256 - 2 <a, c>) << 16 | c): one 32-bit min a centre, and
//   the first minimum wins as jnp.argmin. <a, c> is an exact integer
//   product on the tensor cores: mma.sync m16n8k256 .b1 with .and.popc
//   straight on the packed LSB-first rows (A: 16 descriptors, B: 8
//   centres, 256 bits deep; on the H100 it issues at s8 m16n8k32's
//   instruction rate, so 8x its inner-product bits a second). Flat: a
//   warp a tile of 16 descriptors against the centres staged in shared
//   memory, 1024 at a time (words interleaved so that a lane's two B words
//   are one 64-bit load; a wider vocabulary keeps each row's key between
//   passes). Level 2: the descriptors are
//   grouped by their block once a call (count, scan, scatter), and a warp
//   takes 16 members of one block against its B words. Each tile's 16
//   assignments then take their rank inside their centre by one integer
//   atomic a distinct centre (__match_any_sync): the member count. Fewer
//   tiles than warps (a small corpus) take a CTA a tile, its warps
//   splitting the centres.
// - Scan: CTA b owns a segment of the centres; it adds up the members,
//   tally items and partial slots of the centres before its segment (of
//   more than 4096 centres: each CTA its segment's totals, then after a
//   grid barrier those of the segments before it), then scans its own: each
//   centre's offset, its tally items (max(32, ceil(n / 512)) members
//   each, so no centre waits on one warp) and, for a centre of several
//   items, its first partial slot. An empty centre's count is 0 and it
//   keeps its bits.
// - Scatter: each member's id to offs[centre] + rank.
// - Tally: a warp takes 2 items at once, a half-warp each; lane h of a
//   half owns 16 bit positions of every member row and loads them for 8
//   members at a time. Without row weights the counts go through 5 bit
//   planes (a carry-save add of two members' slices in 15 operations, the
//   planes added into integer sums every 31 pairs); with weights each
//   position adds the member's weight (a row of weight 0 is a member that
//   adds nothing). A centre's only item takes the majority (bit set when
//   2 ones > count, a tie gives 0, a count of 0 keeps the bits) and writes
//   its 32 bytes, count and key constant; the items of a larger centre
//   write their 256 sums to their slots, and the last of them (an atomic
//   ticket) adds them up and takes the majority. Integer sums do not
//   depend on order, so centres and counts equal the plain version's and
//   the reference's segment_sum bit for bit.
// A final assignment against the finished centres serves `assign_flat`.
// `km_idf` is one CTA: the total as an exact integer sum, then idf =
// log(total / max(count, 1)) in f32, from the last iteration's counts.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int IDF_THREADS = 1024;
constexpr int KM_THREADS = 256;
constexpr int KM_WARPS = KM_THREADS / 32;
constexpr int TILE_C = 1024;          // centres staged in shared memory at a time (flat)
constexpr int MAX_W = 1 << 16;        // centre ids fit the key's low 16 bits
constexpr int CH_MIN = 32;            // members of a tally item, at least
constexpr int MAX_GRID = 4096;        // CTAs of the cooperative grid, at most
constexpr int SMALL_W = 4096;         // up to this many centres the scan takes one phase
constexpr int MAX_ITEMS = 512;        // tally items of one centre, at most
constexpr unsigned NO_KEY = 0xFFFFFFFFu;
// Phases timed by a -DKERNEL_STAMPS build (workspace words 9.., word 8 kept 0).
enum Phase { PH_PROLOGUE = 0, PH_ASSIGN, PH_SCAN, PH_SCATTER, PH_TALLY, PH_FINAL };

__device__ __forceinline__ unsigned ldcg(const unsigned* p) { return __ldcg(p); }
__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }

// The tile product of 16 descriptors (A) and 8 centres (B) kept packed (32
// bytes a row, LSB-first; bit i of 32-bit word j is position 32 j + i):
// b1 m16n8k256 with .and.popc, the inner products of their 0/1 bits. Lane
// (g, t) = (lane / 4, lane % 4) holds c[0..3] = rows g, g, g + 8, g + 8 and
// columns 2 t, 2 t + 1, 2 t, 2 t + 1 of the tile.
__device__ __forceinline__ void mma_b1(int c[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// km_train
// ---------------------------------------------------------------------------

struct KmArgs {
    const uint8_t* desc;     // [N, 32]
    const int* weight;       // [N] or NULL (all 1)
    const int* group;        // [N] block of each descriptor, or NULL (flat)
    int N, W, B, G, n_iters;
    uint8_t* words;          // [W, 32] centres, in place
    int* counts;             // [W] the last iteration's counts
    int* assign_out;         // [N] the assignment against the final centres, or NULL
    unsigned long long* stamps;
    // scratch
    int* part;               // [slots, 256] bit sums of a centre's tally item
    int* psw;                // [slots] the item's weight sum
    int4* items;             // [items] tally items: centre, first and end entry, slot or -1
    unsigned* kconst;        // [W] (popc + 256) << 16 | id
    unsigned* key;           // [N] a row's best key between passes of a wide flat vocabulary
    int* assign;             // [N]
    int* rank;               // [N] place among its centre's members
    int* cnt;                // [W] members (zero between iterations)
    int* tick;               // [W] items of a centre tallied (zero between iterations)
    int* offs;               // [W + 1] members' offsets
    int* pslot;              // [W] the first partial slot of a centre of several items
    int* segtot;             // [3 MAX_GRID] the scan's segment totals
    int* n_items;            // [1]
    int* lists;              // [N] member ids, sorted by centre
    int* gcnt;               // [G] level 2: members of each block
    int* goffs;              // [G + 1]
    int* toffs;              // [G + 1] tiles of 16 members' offsets
    int* grank;              // [N]
    int* glist;              // [N] descriptor ids by block
    int* tile_g;             // [tiles] the block of each tile
};

__host__ __device__ inline size_t km_slots(int N) { return (size_t)N / 16 + 1; }
__host__ __device__ inline size_t km_items(int N, int W) { return (size_t)N / CH_MIN + W + 1; }
__host__ __device__ inline size_t km_tiles(int N, int G) { return (size_t)N / 16 + G + 1; }

// Ints of scratch (the layout of `carve`; `vocab.km_scratch_ints` mirrors it).
size_t km_scratch(int N, int W, int G) {
    size_t n = km_slots(N) * 257 + km_items(N, W) * 4 + (size_t)W * 5 + (size_t)N * 4 + 2 +
               3 * MAX_GRID;
    if (G > 0) n += (size_t)G + (size_t)(G + 1) * 2 + (size_t)N * 2 + km_tiles(N, G);
    return n;
}

void carve(KmArgs& a, int* s) {
    auto take = [&s](size_t n) {
        int* q = s;
        s += n;
        return q;
    };
    const int N = a.N, W = a.W, G = a.G;
    a.part = take(km_slots(N) * 256);  // first two: 16-byte aligned
    a.items = reinterpret_cast<int4*>(take(km_items(N, W) * 4));
    a.psw = take(km_slots(N));
    a.kconst = reinterpret_cast<unsigned*>(take(W));
    a.key = reinterpret_cast<unsigned*>(take(N));
    a.assign = take(N);
    a.rank = take(N);
    a.cnt = take(W);
    a.tick = take(W);
    a.offs = take(W + 1);
    a.pslot = take(W);
    a.segtot = take(3 * MAX_GRID);
    a.n_items = take(1);
    a.lists = take(N);
    if (G > 0) {
        a.gcnt = take(G);
        a.goffs = take(G + 1);
        a.toffs = take(G + 1);
        a.grank = take(N);
        a.glist = take(N);
        a.tile_g = take(km_tiles(N, G));
    }
}

// A centre of n members is tallied in items of chunk_len(n) members: at
// least CH_MIN, at most MAX_ITEMS items.
__device__ __forceinline__ int chunk_len(int n) {
    const int c = (n + MAX_ITEMS - 1) / MAX_ITEMS;
    return c > CH_MIN ? c : CH_MIN;
}

__device__ __forceinline__ int n_chunks(int n) {
    return n ? (n + chunk_len(n) - 1) / chunk_len(n) : 0;
}

__device__ __forceinline__ unsigned centre_key(const uint8_t* words, int c) {
    const uint4* w = reinterpret_cast<const uint4*>(words) + 2 * c;
    const uint4 x = __ldcg(w), y = __ldcg(w + 1);
    const int p = __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w) + __popc(y.x) +
                  __popc(y.y) + __popc(y.z) + __popc(y.w);
    return ((unsigned)(p + 256) << 16) | (unsigned)c;
}

// Exclusive scan of one int over the CTA (thread order); returns the
// thread's prefix, the total in *total. sh: 33 ints.
__device__ __forceinline__ int block_exscan(int v, int* sh, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh[wid] = x;
    __syncthreads();
    if (wid == 0) {
        int s = lane < KM_WARPS ? sh[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        if (lane < KM_WARPS) sh[lane] = s;  // inclusive warp totals
    }
    __syncthreads();
    const int before = (wid > 0 ? sh[wid - 1] : 0) + x - v;
    *total = sh[KM_WARPS - 1];
    __syncthreads();
    return before;
}

// The running best of one tile product: lane (g, t) folds c[0..3] into the
// keys of rows g (b0) and g + 8 (b1) with column constants k0 (2 t), k1.
__device__ __forceinline__ void fold(const int c[4], unsigned k0, unsigned k1, unsigned& b0,
                                     unsigned& b1) {
    b0 = min(b0, min(k0 - ((unsigned)c[0] << 17), k1 - ((unsigned)c[1] << 17)));
    b1 = min(b1, min(k0 - ((unsigned)c[2] << 17), k1 - ((unsigned)c[3] << 17)));
}

// One tile product against 8 centres (B words bw, key constants kk), folded.
__device__ __forceinline__ void product(unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                        uint2 bw, uint2 kk, unsigned& b0, unsigned& b1) {
    int c[4] = {0, 0, 0, 0};
    mma_b1(c, a0, a1, a2, a3, bw.x, bw.y);
    fold(c, kk.x, kk.y, b0, b1);
}

__device__ __forceinline__ void quad_min(unsigned& b0, unsigned& b1) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        b0 = min(b0, __shfl_xor_sync(0xffffffffu, b0, o));
        b1 = min(b1, __shfl_xor_sync(0xffffffffu, b1, o));
    }
}

// The 16 rows of a tile, lane i < 16 holding row `row` (-1: none), take
// their centres from the quads' keys: the assignment (or the final one)
// and, while training, their rank among the centre's members (one atomic a
// distinct centre; rows of weight 0 are members that add nothing).
__device__ __forceinline__ void finish_tile(const KmArgs& a, unsigned b0, unsigned b1, int row,
                                            bool train) {
    const int lane = threadIdx.x & 31;
    const unsigned k0 = __shfl_sync(0xffffffffu, b0, 4 * (lane & 7));
    const unsigned k1 = __shfl_sync(0xffffffffu, b1, 4 * (lane & 7));
    const bool own = lane < 16 && row >= 0;
    const int c = (int)((lane < 8 ? k0 : k1) & 0xffffu);
    if (!train) {
        if (own) a.assign_out[row] = c;
        return;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, own);
    if (own) {
        a.assign[row] = c;
        const unsigned peers = __match_any_sync(mask, c);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(a.cnt + c, __popc(peers));
        base = __shfl_sync(peers, base, leader);
        a.rank[row] = base + __popc(peers & ((1u << lane) - 1));
    }
}

// Flat assignment against centres staged in shared memory, TILE_C at a
// time: a warp a tile of 16 rows, or, when there are fewer tiles than
// warps, a CTA a tile with its warps splitting the centres (their keys
// meet in shared memory).
__device__ __forceinline__ void assign_flat(const KmArgs& a, bool train, unsigned* s_w,
                                            unsigned* s_k, unsigned* s_best) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wid = threadIdx.x >> 5;
    const int nw = gridDim.x * KM_WARPS;
    const int n_mt = (a.N + 15) / 16;
    const bool split = n_mt < nw;
    if ((split ? (int)blockIdx.x : (int)blockIdx.x * KM_WARPS) >= n_mt) return;  // uniform
    const uint2* sw2 = reinterpret_cast<const uint2*>(s_w);
    const unsigned* d = reinterpret_cast<const unsigned*>(a.desc);
    for (int base = 0; base < a.W; base += TILE_C) {
        const int nc = min(TILE_C, a.W - base), ntl = (nc + 7) / 8;
        const bool last = base + TILE_C >= a.W;
        __syncthreads();
        for (int j = threadIdx.x; j < ntl * 8; j += KM_THREADS) {
            uint4 x = make_uint4(0, 0, 0, 0), y = x;
            unsigned k = NO_KEY;
            if (j < nc) {
                const uint4* w = reinterpret_cast<const uint4*>(a.words) + 2 * (base + j);
                x = __ldcg(w);
                y = __ldcg(w + 1);
                k = ldcg(a.kconst + base + j);
            }
            // Words (0, 4, 1, 5, 2, 6, 3, 7): lane t's B pair is one 64-bit load.
            reinterpret_cast<uint4*>(s_w)[2 * j] = make_uint4(x.x, y.x, x.y, y.y);
            reinterpret_cast<uint4*>(s_w)[2 * j + 1] = make_uint4(x.z, y.z, x.w, y.w);
            s_k[j] = k;
        }
        __syncthreads();
        const int m0 = split ? blockIdx.x : blockIdx.x * KM_WARPS + wid;
        const int mstep = split ? gridDim.x : nw;
        for (int mt = m0; mt < n_mt; mt += mstep) {
            const int r0 = mt * 16 + g, r1 = r0 + 8;
            const bool v0 = r0 < a.N, v1 = r1 < a.N;
            const unsigned a0 = v0 ? d[8 * r0 + t] : 0u, a2 = v0 ? d[8 * r0 + 4 + t] : 0u;
            const unsigned a1 = v1 ? d[8 * r1 + t] : 0u, a3 = v1 ? d[8 * r1 + 4 + t] : 0u;
            unsigned b0 = NO_KEY, b1 = NO_KEY;
            if (base > 0 && !split) {
                if (r0 < a.N) b0 = ldcg(a.key + r0);
                if (r1 < a.N) b1 = ldcg(a.key + r1);
            }
            if (split && threadIdx.x < 16) {
                const int r = mt * 16 + threadIdx.x;
                s_best[threadIdx.x] = base > 0 && r < a.N ? ldcg(a.key + r) : NO_KEY;
            }
            const uint2* sk2 = reinterpret_cast<const uint2*>(s_k);
            if (split) {
                for (int nt = wid; nt < ntl; nt += KM_WARPS)
                    product(a0, a1, a2, a3, sw2[(nt * 8 + g) * 4 + t], sk2[nt * 4 + t], b0, b1);
            } else {
#pragma unroll 4
                for (int nt = 0; nt < ntl; ++nt)
                    product(a0, a1, a2, a3, sw2[(nt * 8 + g) * 4 + t], sk2[nt * 4 + t], b0, b1);
            }
            quad_min(b0, b1);
            if (split) {
                __syncthreads();
                if (t == 0) {
                    atomicMin(s_best + g, b0);
                    atomicMin(s_best + g + 8, b1);
                }
                __syncthreads();
                if (wid == 0) {
                    b0 = s_best[g];
                    b1 = s_best[g + 8];
                }
                __syncthreads();
                if (wid != 0) continue;
            }
            if (last) {
                const int row = mt * 16 + (lane & 15);
                finish_tile(a, b0, b1, lane < 16 && row < a.N ? row : -1, train);
            } else if (t == 0) {
                if (r0 < a.N) a.key[r0] = b0;
                if (r1 < a.N) a.key[r1] = b1;
            }
        }
    }
}

// Level-2 assignment: a warp a tile of 16 members of one block against its
// B centres.
__device__ __forceinline__ void assign_block(const KmArgs& a, bool train) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int nw = gridDim.x * KM_WARPS;
    const int n_tiles = ldcg(a.toffs + a.G);
    const unsigned* d = reinterpret_cast<const unsigned*>(a.desc);
    const unsigned* wd = reinterpret_cast<const unsigned*>(a.words);
    const int ntl = (a.B + 7) / 8;
    for (int q = blockIdx.x * KM_WARPS + (threadIdx.x >> 5); q < n_tiles; q += nw) {
        const int grp = ldcg(a.tile_g + q);
        const int lo = ldcg(a.goffs + grp), n = ldcg(a.goffs + grp + 1) - lo;
        const int i0 = (q - ldcg(a.toffs + grp)) * 16;
        const int mine = lane < 16 && i0 + lane < n ? ldcg(a.glist + lo + i0 + lane) : -1;
        const int r0 = __shfl_sync(0xffffffffu, mine, g);
        const int r1 = __shfl_sync(0xffffffffu, mine, g + 8);
        const unsigned a0 = r0 >= 0 ? d[8 * r0 + t] : 0u, a2 = r0 >= 0 ? d[8 * r0 + 4 + t] : 0u;
        const unsigned a1 = r1 >= 0 ? d[8 * r1 + t] : 0u, a3 = r1 >= 0 ? d[8 * r1 + 4 + t] : 0u;
        unsigned b0 = NO_KEY, b1 = NO_KEY;
        const int cb = grp * a.B;
        for (int nt = 0; nt < ntl; ++nt) {
            const int col = nt * 8 + g, k0c = nt * 8 + 2 * t;
            const unsigned w0 = col < a.B ? ldcg(wd + 8 * (cb + col) + t) : 0u;
            const unsigned w1 = col < a.B ? ldcg(wd + 8 * (cb + col) + 4 + t) : 0u;
            const unsigned k0 = k0c < a.B ? ldcg(a.kconst + cb + k0c) : NO_KEY;
            const unsigned k1 = k0c + 1 < a.B ? ldcg(a.kconst + cb + k0c + 1) : NO_KEY;
            int c[4] = {0, 0, 0, 0};
            mma_b1(c, a0, a1, a2, a3, w0, w1);
            fold(c, k0, k1, b0, b1);
        }
        quad_min(b0, b1);
        finish_tile(a, b0, b1, mine, train);
    }
}

template <bool BLOCK>
__device__ __forceinline__ void assign_phase(const KmArgs& a, bool train, unsigned* s_w,
                                             unsigned* s_k, unsigned* s_best) {
    if (BLOCK) assign_block(a, train);
    else assign_flat(a, train, s_w, s_k, s_best);
}

// Scan, in two phases over CTA segments of the centres. Each centre adds
// its members, its tally items and, when it has several items, their
// partial slots.
__device__ __forceinline__ int3 centre_sizes(int n) {
    const int k = n_chunks(n);
    return make_int3(n, k, k > 1 ? k : 0);
}

// CTA b's segment [lo, hi) of the centres (kept in shared memory: s_seg),
// and this thread's part [c0, c1) of it.
__device__ __forceinline__ void segment_of(const int* s_seg, int& lo, int& hi, int& c0, int& c1) {
    lo = s_seg[0];
    hi = s_seg[1];
    const int per = (hi - lo + KM_THREADS - 1) / KM_THREADS;
    c0 = min(hi, lo + (int)threadIdx.x * per);
    c1 = min(hi, c0 + per);
}

// Phase 1: each CTA's segment totals.
__device__ __forceinline__ void scan_totals(const KmArgs& a, int* sh, const int* s_seg) {
    int lo, hi, c0, c1;
    segment_of(s_seg, lo, hi, c0, c1);
    int3 m = make_int3(0, 0, 0);
    for (int c = c0; c < c1; ++c) {
        const int3 z = centre_sizes(ldcg(a.cnt + c));
        m.x += z.x;
        m.y += z.y;
        m.z += z.z;
    }
    int t0, t1, t2;
    block_exscan(m.x, sh, &t0);
    block_exscan(m.y, sh, &t1);
    block_exscan(m.z, sh, &t2);
    if (threadIdx.x == 0) {
        a.segtot[3 * blockIdx.x] = t0;
        a.segtot[3 * blockIdx.x + 1] = t1;
        a.segtot[3 * blockIdx.x + 2] = t2;
    }
}

// Phase 2: the totals of the CTAs before this one, then a scan of its
// segment: each centre's offset, first slot and tally items (an empty
// centre's count is 0); the last CTA writes the totals.
__device__ __forceinline__ void scan_segment(const KmArgs& a, int* sh, const int* s_seg) {
    int lo, hi, c0, c1;
    segment_of(s_seg, lo, hi, c0, c1);
    int pn = 0, pi = 0, pp = 0;
    if (a.W > SMALL_W) {
        for (int b = threadIdx.x; b < (int)blockIdx.x; b += KM_THREADS) {
            pn += ldcg(a.segtot + 3 * b);
            pi += ldcg(a.segtot + 3 * b + 1);
            pp += ldcg(a.segtot + 3 * b + 2);
        }
    } else {  // few centres: every CTA adds up those before its segment
        for (int c = threadIdx.x; c < lo; c += KM_THREADS) {
            const int3 z = centre_sizes(ldcg(a.cnt + c));
            pn += z.x;
            pi += z.y;
            pp += z.z;
        }
    }
    block_exscan(pn, sh, &pn);
    block_exscan(pi, sh, &pi);
    block_exscan(pp, sh, &pp);
    int3 m = make_int3(0, 0, 0);
    for (int c = c0; c < c1; ++c) {
        const int3 z = centre_sizes(ldcg(a.cnt + c));
        m.x += z.x;
        m.y += z.y;
        m.z += z.z;
    }
    int t;
    int on = pn + block_exscan(m.x, sh, &t), oi = pi + block_exscan(m.y, sh, &t);
    int op = pp + block_exscan(m.z, sh, &t);
    for (int c = c0; c < c1; ++c) {
        const int n = ldcg(a.cnt + c), k = n_chunks(n), ch = chunk_len(n);
        a.offs[c] = on;
        a.pslot[c] = op;
        if (n == 0) a.counts[c] = 0;
        for (int j = 0; j < k; ++j)
            a.items[oi + j] = make_int4(c, on + j * ch, min(on + (j + 1) * ch, on + n),
                                        k > 1 ? op + j : -1);
        on += n;
        oi += k;
        op += k > 1 ? k : 0;
    }
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x == KM_THREADS - 1) {
        a.offs[a.W] = on;
        *a.n_items = oi;
    }
}

// The majority of centre c from its half-warp's sums (lane h of the half:
// bits 16 h .. 16 h + 15 of the row), written when the weights add to more
// than 0; its count in any case.
__device__ __forceinline__ void take_majority(const KmArgs& a, int c, const int sum[16], int wsum,
                                              unsigned hmask) {
    const int h = threadIdx.x & 15;
    if (h == 0) a.counts[c] = wsum;
    if (wsum == 0) return;  // keeps its bits
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) v |= (unsigned)(2 * (long long)sum[b] > (long long)wsum) << b;
    reinterpret_cast<uint16_t*>(a.words)[(size_t)c * 16 + h] = (uint16_t)v;
    int p = __popc(v);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) p += __shfl_xor_sync(hmask, p, o, 16);
    if (h == 0) a.kconst[c] = ((unsigned)(p + 256) << 16) | (unsigned)c;
}

// Unweighted sums as bit planes: plane k holds bit k of each position's
// count, the low and high halves of a word counting two members' 16-bit
// slices apiece; a carry-save add takes 15 operations for 2 members'
// 16 positions, and every 31 pairs the planes go into the integer sums.
constexpr int PLANES = 5;

__device__ __forceinline__ void plane_add(unsigned pl[PLANES], unsigned x) {
#pragma unroll
    for (int k = 0; k < PLANES; ++k) {
        const unsigned t = pl[k] & x;
        pl[k] ^= x;
        x = t;
    }
}

__device__ __forceinline__ void plane_flush(unsigned pl[PLANES], int sum[16]) {
#pragma unroll
    for (int b = 0; b < 16; ++b) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < PLANES; ++k)
            v += (int)(((pl[k] >> b) & 1u) + ((pl[k] >> (b + 16)) & 1u)) << k;
        sum[b] += v;
    }
#pragma unroll
    for (int k = 0; k < PLANES; ++k) pl[k] = 0;
}

// Tally: a warp takes 2 items at once, a half-warp each; lane h of a half
// owns 16 bit positions (bytes 2 h, 2 h + 1) of every member row and loads
// them for 8 members at a time. Without row weights the counts go
// through bit planes (`plane_add`); with them each position adds the
// member's weight. A centre's only item takes the majority; the items of a
// larger centre write their 256 sums to their slots, and the last of them
// (an atomic ticket) adds them up.
template <bool WEIGHTED>
__device__ __forceinline__ void tally(const KmArgs& a) {
    const int lane = threadIdx.x & 31, h = lane & 15, half = lane >> 4;
    const unsigned hmask = 0xFFFFu << (16 * half);
    const int nw = gridDim.x * KM_WARPS, n_items = ldcg(a.n_items);
    const uint16_t* rows = reinterpret_cast<const uint16_t*>(a.desc);
    for (int q0 = (blockIdx.x * KM_WARPS + (threadIdx.x >> 5)) * 2; q0 < n_items; q0 += 2 * nw) {
        const int q = q0 + half;
        const int4 it = q < n_items ? __ldcg(a.items + q) : make_int4(-1, 0, 0, -1);
        int sum[16], wsum = 0, pairs = 0;
        unsigned pl[PLANES] = {0, 0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < 16; ++b) sum[b] = 0;
        const int rmax = __reduce_max_sync(0xffffffffu, (it.z - it.y + 15) / 16);
        for (int r = 0; r < rmax; ++r) {
            const int j = it.y + 16 * r, nb = min(16, it.z - j);
            const int id = h < nb ? ldcg(a.lists + j + h) : 0;
            const int wl = WEIGHTED && h < nb ? a.weight[id] : 0;
#pragma unroll
            for (int u0 = 0; u0 < 16; u0 += 8) {
                unsigned hw[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int f = __shfl_sync(0xffffffffu, id, u0 + u, 16);
                    hw[u] = u0 + u < nb ? rows[(size_t)f * 16 + h] : 0u;
                }
                if (WEIGHTED) {
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        const int w = __shfl_sync(0xffffffffu, wl, u0 + u, 16);  // 0 past nb
                        wsum += w;
#pragma unroll
                        for (int b = 0; b < 16; ++b) sum[b] += ((hw[u] >> b) & 1u) ? w : 0;
                    }
                } else {
                    if (pairs > 27) {  // the planes hold counts up to 31
                        plane_flush(pl, sum);
                        pairs = 0;
                    }
#pragma unroll
                    for (int u = 0; u < 8; u += 2) plane_add(pl, hw[u] | (hw[u + 1] << 16));
                    pairs += 4;
                }
            }
            if (!WEIGHTED) wsum += max(nb, 0);
        }
        plane_flush(pl, sum);
        if (it.x < 0) continue;
        const int c = it.x;
        if (it.w < 0) {
            take_majority(a, c, sum, wsum, hmask);
            continue;
        }
        int4* pp = reinterpret_cast<int4*>(a.part + (size_t)it.w * 256 + 16 * h);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            pp[k] = make_int4(sum[4 * k], sum[4 * k + 1], sum[4 * k + 2], sum[4 * k + 3]);
        if (h == 0) a.psw[it.w] = wsum;
        __threadfence();
        __syncwarp(hmask);
        const int k = n_chunks(ldcg(a.offs + c + 1) - ldcg(a.offs + c));
        int done = 0;
        if (h == 0) done = atomicAdd(a.tick + c, 1);
        if (__shfl_sync(hmask, done, 0, 16) != k - 1) continue;
        __threadfence();
        const int s0 = ldcg(a.pslot + c);
#pragma unroll
        for (int b = 0; b < 16; ++b) sum[b] = 0;
        wsum = 0;
        for (int r = 0; r < k; ++r) {
            const int4* qp =
                reinterpret_cast<const int4*>(a.part + (size_t)(s0 + r) * 256 + 16 * h);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int4 x = __ldcg(qp + m);
                sum[4 * m] += x.x;
                sum[4 * m + 1] += x.y;
                sum[4 * m + 2] += x.z;
                sum[4 * m + 3] += x.w;
            }
            wsum += __ldcg(a.psw + s0 + r);
        }
        if (h == 0) a.tick[c] = 0;
        take_majority(a, c, sum, wsum, hmask);
    }
}

__device__ __forceinline__ void lap(const KmArgs& a, unsigned long long& t0, int phase) {
#ifdef KERNEL_STAMPS
    if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        a.stamps[9 + phase] += t - t0;
        t0 = t;
    }
#endif
}

// BLOCK: level 2 (group given); WEIGHTED: row weights given.
template <bool BLOCK, bool WEIGHTED>
__global__ void __launch_bounds__(KM_THREADS, 2) km_train_kernel(KmArgs a) {
    __shared__ __align__(16) unsigned s_w[TILE_C * 8];
    __shared__ __align__(16) unsigned s_k[TILE_C];
    __shared__ unsigned s_best[16];
    __shared__ int s_scan[33], s_seg[2];
    cg::grid_group grid = cg::this_grid();
    if (threadIdx.x == 0) {  // this CTA's segment of the centres in the scans
        const int seg = (a.W + gridDim.x - 1) / gridDim.x;
        s_seg[0] = min(a.W, (int)blockIdx.x * seg);
        s_seg[1] = min(a.W, s_seg[0] + seg);
    }
    const int gt = blockIdx.x * KM_THREADS + threadIdx.x, nt = gridDim.x * KM_THREADS;
    const int lane = threadIdx.x & 31, gw = gt >> 5, nw = nt >> 5;
    unsigned long long t0 = 0;
#ifdef KERNEL_STAMPS
    if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0)
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#endif
    for (int c = gt; c < a.W; c += nt) {
        a.cnt[c] = 0;
        a.tick[c] = 0;
        a.kconst[c] = centre_key(a.words, c);
    }
    for (int g = gt; g < a.G; g += nt) a.gcnt[g] = 0;
    grid.sync();
    if (BLOCK) {  // level 2: the descriptors grouped by block, once
        for (int f = gt; f < a.N; f += nt) a.grank[f] = atomicAdd(a.gcnt + a.group[f], 1);
        grid.sync();
        if (blockIdx.x == 0) {
            const int seg = (a.G + KM_THREADS - 1) / KM_THREADS;
            const int lo = min(a.G, (int)threadIdx.x * seg), hi = min(a.G, lo + seg);
            int s_n = 0, s_t = 0;
            for (int g = lo; g < hi; ++g) {
                const int n = ldcg(a.gcnt + g);
                s_n += n;
                s_t += (n + 15) / 16;
            }
            int tn, tt;
            int o_n = block_exscan(s_n, s_scan, &tn), o_t = block_exscan(s_t, s_scan, &tt);
            for (int g = lo; g < hi; ++g) {
                const int n = ldcg(a.gcnt + g);
                a.goffs[g] = o_n;
                a.toffs[g] = o_t;
                o_n += n;
                o_t += (n + 15) / 16;
            }
            if (threadIdx.x == 0) {
                a.goffs[a.G] = tn;
                a.toffs[a.G] = tt;
            }
        }
        grid.sync();
        for (int f = gt; f < a.N; f += nt)
            a.glist[ldcg(a.goffs + a.group[f]) + ldcg(a.grank + f)] = f;
        for (int g = gw; g < a.G; g += nw)
            for (int q = ldcg(a.toffs + g) + lane; q < ldcg(a.toffs + g + 1); q += 32)
                a.tile_g[q] = g;
        grid.sync();
    }
    lap(a, t0, PH_PROLOGUE);
    for (int it = 0; it < a.n_iters; ++it) {
        assign_phase<BLOCK>(a, true, s_w, s_k, s_best);
        grid.sync();
        lap(a, t0, PH_ASSIGN);
        if (a.W > SMALL_W) {
            scan_totals(a, s_scan, s_seg);
            grid.sync();
        }
        scan_segment(a, s_scan, s_seg);
        grid.sync();
        lap(a, t0, PH_SCAN);
        for (int f = gt; f < a.N; f += nt)
            a.lists[ldcg(a.offs + ldcg(a.assign + f)) + ldcg(a.rank + f)] = f;
        grid.sync();
        lap(a, t0, PH_SCATTER);
        for (int c = gt; c < a.W; c += nt) a.cnt[c] = 0;
        tally<WEIGHTED>(a);
        grid.sync();
        lap(a, t0, PH_TALLY);
    }
    if (a.assign_out) {
        assign_phase<BLOCK>(a, false, s_w, s_k, s_best);
        lap(a, t0, PH_FINAL);
    }
}

__global__ void idf_kernel(const int* counts, int W, float* idf) {
    __shared__ long long part[IDF_THREADS / 32];
    __shared__ long long total;
    long long s = 0;
    for (int i = threadIdx.x; i < W; i += blockDim.x) s += counts[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += part[k];
        total = t > 1 ? t : 1;
    }
    __syncthreads();
    const float n_total = (float)total;
    for (int i = threadIdx.x; i < W; i += blockDim.x)
        idf[i] = logf(__fdiv_rn(n_total, fmaxf((float)counts[i], 1.f)));
}

}  // namespace

// A whole k-majority call in one cooperative launch: n_iters iterations
// from the centres in `words` [W, 32] (in place), the last iteration's
// counts into counts [W]. weight [N] (NULL: 1) scales a row's vote; with
// group [N] a row's argmin runs over the B centres of block group[f] (W =
// G B). assign_out [N] (or NULL): the nearest centre of every row after the
// last iteration. scratch: at least km_scratch(N, W, G) ints
// (`vocab.km_scratch_ints`). stamps: a
// -DKERNEL_STAMPS build adds each phase's nanoseconds to words 9.. (NULL:
// none). Fails (no launch) beyond 65536 centres or when the card cannot
// hold one CTA on each SM at once.
C_ENTRY int km_train(const uint8_t* desc, const int* weight, const int* group, int N, int W,
                     int B, int n_iters, uint8_t* words, int* counts, int* assign_out,
                     int* scratch, int scratch_ints, unsigned long long* stamps,
                     cudaStream_t stream) {
    if (W <= 0 || W > MAX_W || N < 0 || (group && (B <= 0 || W % B)))
        return (int)cudaErrorInvalidValue;
    KmArgs a;
    a.desc = desc; a.weight = weight; a.group = group; a.N = N; a.W = W;
    a.B = group ? B : 0; a.G = group ? W / B : 0; a.n_iters = n_iters;
    a.words = words; a.counts = counts; a.assign_out = assign_out; a.stamps = stamps;
    if ((size_t)scratch_ints < km_scratch(N, W, a.G)) return (int)cudaErrorInvalidValue;
    carve(a, scratch);
    const int inst = (group ? 2 : 0) + (weight ? 1 : 0);
    void (*const kernels[4])(KmArgs) = {km_train_kernel<false, false>, km_train_kernel<false, true>,
                                        km_train_kernel<true, false>, km_train_kernel<true, true>};
    static int sms = 0, per_sm[4] = {0, 0, 0, 0};
    if (per_sm[inst] == 0) {
        int dev = 0, coop = 0, n = 0, p = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernels[inst], KM_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        if (!coop || p < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        sms = n;
        per_sm[inst] = p;
    }
    // Small calls take one CTA an SM: fewer CTAs make each grid barrier shorter.
    const int blocks = sms * (N >= 32768 ? per_sm[inst] : 1);
    if (blocks > MAX_GRID) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {(void*)&a};
    return (int)cudaLaunchCooperativeKernel((const void*)kernels[inst], dim3(blocks),
                                            dim3(KM_THREADS), args, 0, stream);
}

// idf [W] = log(max(sum counts, 1) / max(count, 1)).
C_ENTRY int km_idf(const int* counts, int W, float* idf, cudaStream_t stream) {
    idf_kernel<<<1, IDF_THREADS, 0, stream>>>(counts, W, idf);
    return (int)cudaGetLastError();
}
