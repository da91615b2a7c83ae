// Discriminator 2-D conv in bf16, forward and input gradient (kernel K4's
// bf16 form) for Hopper: warpgroup MMA (wgmma) with both operands in shared
// memory, fed by two producer warpgroups, in persistent CTAs.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_conv2d_v2.py `_kernel` in its bf16
// form (the TPU kernel runs in its input's dtype: bf16 scratch, f32
// accumulation, bf16 out, pallas_conv2d_v2.py:159, :189, :241, :287). The
// convs and the correlation they reduce to are those of the f32 form
// (csrc/disc_conv.cu, head comment): with (S, OS) = (sf, 1) forward and (1,
// sf) for dx, per phase r
//
//     out[b, o, t, q*OS + ooff[r]] = sum_{c, mt, j} in[b, c, t + t_off + mt*dt, q*S + col_off + j]
//                                    * wk[r][c][mt][j][o]
//
// Numerics: bf16 x bf16 products, exact in f32, summed in f32 by the tensor
// cores, the sum rounded to nearest even to bf16; the bias, when given, is
// added after that rounding, in bf16 (round(round(acc) + bias)), as the JAX
// package's conv adds it (ops/conv.py:263). No atomics and no split K: the
// same input gives the same bits on every call.
//
// What bounds it on this card: operations and bytes about equally. The 12
// convs of a 24 kHz disc call are 219 GFLOP in bf16 (0.22 ms at 989 TFLOP/s)
// and move x and y once in about as long (a 3x9 F-stride-2 conv does ~290
// operations a byte of x, the card's ridge); so the design keeps the tensor
// cores fed while x streams through once, with nothing of the copy on the
// MMA warps' path. As built, the producers bound it
// (scripts/probe_torch_disc_conv_bf16.py on an H100): per 8-channel chunk
// of a tile, issuing the 16-byte copies takes 2200-3100 cycles and the
// layout 1300-3100, and without them the kernel takes 0.56-0.72 of its time.
//
// Design:
// - M = output positions, N = 32 output channels (a grid row a tile of 32),
//   K = channels x taps in chunks of 8 channels. A k-step of 16 is the 8
//   channels at two taps (k 0-7 the first, 8-15 the second), the taps taken
//   in the order of their staged addresses (ops/disc_conv_kernel.py
//   `bf16_steps`), an odd count padded by a zero-weight tap.
// - A CTA tile is 32 output rows x 16 output columns of one image (at sf 2
//   for dx: 8 columns of the correlation in both phases, 16 output columns):
//   eight m64 tiles of 8 rows x 8 columns, four a consumer warpgroup, whose
//   k-steps are issued interleaved so that four accumulator chains are in
//   flight (a lone m64n32k16 chain keeps the tensor cores a fraction busy).
//   No wgmma sits under a branch (ptxas serializes every wgmma of a kernel
//   that issues one conditionally): edge tiles compute on zeros and store
//   nothing.
// - Products: wgmma.mma_async m64n32k16 bf16 with A and B both read from
//   shared memory by descriptor (K-major, no swizzle). The input window is
//   staged channels-last, 16 bytes (8 channels) a position, so eight
//   neighbouring output positions at any tap are one 128-byte core matrix:
//   the A descriptor of a k-step is the window's address at its first tap,
//   its leading byte offset the distance to the second tap, its stride byte
//   offset one staged row. The taps are compile-time constants and cost no
//   registers. At F-stride 2 a staged row keeps the even input columns, then
//   the odd ones, so that neighbouring output columns read neighbouring
//   positions.
// - Weights: each k-step's B image (32 channels x 16 k, 1 KB) is laid out
//   once a call by disc_conv_bf16_pack_kernel (14 KB a chunk of 8 summed
//   channels at 3x9 forward and at the dx at sf 2). Where they fit beside
//   the stages (32 summed channels: 56 KB), a CTA copies its output tile's
//   images into shared memory once, by TMA bulk copies, and keeps them for
//   all its tiles; otherwise (more channels) each chunk's images ride with
//   its laid-out stage, in a weight ring of as many stages, copied by one
//   bulk copy that completes on the stage's own mbarrier.
// - Two producer warpgroups stream the input: rows of 2^k + 1 bf16 are only
//   2-byte aligned (no TMA box, no 16-byte copy of a row segment), so they
//   copy the 16-byte-aligned pieces that hold each (channel, row) segment by
//   cp.async into a raw ring (2 stages, one chunk in flight ahead of the one
//   being laid out; a raw row an odd number of 16-byte units, so that the
//   32 rows a warp copies into start in distinct bank groups), then lay the
//   chunk out channels-last (the 8 channels of a position into one 16-byte
//   store, zeros outside `in`) into one of 3 stages (2 where 3 do not fit),
//   and signal the consumers by an mbarrier; the consumers free a stage by
//   another, one wgmma group (one chunk) still in flight. No CTA-wide
//   barrier after the prologue.
// - Persistent CTAs (one an SM) walk the tiles, so the producers lay out
//   the next tile's first chunks while the consumers finish the current one.
// - The epilogue goes through shared memory: each output row's 16 columns
//   are written by one half-warp, 32 contiguous bytes, instead of 2-byte
//   stores scattered over four rows an instruction (at sf 2 the two phases'
//   columns interleave; with each half written apart, the stores alone took
//   as long as the products).
// - dx at sf 2: both phases of a column block in one CTA (they read the same
//   window of g), each with its own k-steps: phase 1 of a 3x5 dx has 4 real
//   taps a row, 6 k-steps, not 8.
// Only the discriminator's tap counts are built (3x9 forward at F-stride 2,
// 3x3 forward and dx at F-stride 1, 3x5 dx at sf 2); others return
// cudaErrorInvalidValue, as does a time dilation whose stages do not fit in
// shared memory (any channel count fits).
#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int ROWS = 32;             // output rows a tile (four groups of 8)
constexpr int CC = 8;                // summed channels a chunk
constexpr int OT = 32;               // output channels a grid row (wgmma N)
constexpr int NCONS = 256;           // two consumer warpgroups
constexpr int NPROD = 256;           // two producer warpgroups
constexpr int THREADS = NCONS + NPROD;
constexpr int NR = 2;                // raw stages
constexpr int MAX_NP = 3;            // laid-out stages: 3 where they fit, else 2
constexpr int BIMG = 512;            // bf16 of a B image (32 channels x 16 k)
constexpr int MAX_DEVICES = 64;

// Compile-time shape of a tap class: F-stride S of the correlation, KT x NJ
// taps, P phases (2: dx at sf 2, whose phase 1 has no tap j = 0).
template <int S, int KT, int NJ, int P>
struct Plan {
    static constexpr int QC = 16 / P;                      // correlation columns a tile
    static constexpr int W = (QC - 1) * S + NJ;            // window columns
    static constexpr int HALF = S == 2 ? (W + 1) / 2 : W;  // even columns first at S 2
    static constexpr int WS = W;                           // staged positions a row
    static constexpr int NPIECE = (W + 14) / 8;            // 16-byte pieces a raw row
    // bf16 a raw row: an odd number of 16-byte units, so that the rows the
    // lanes of a warp copy into start in distinct bank groups
    static constexpr int RAWW = 8 * (NPIECE | 1);

    __host__ __device__ static constexpr int scol(int j) {
        return S == 1 ? j : j / 2 + (j % 2) * HALF;
    }
    __host__ __device__ static constexpr bool has(int r, int j) {
        return !(P == 2 && r == 1 && j == 0);
    }
    __host__ __device__ static constexpr int ntaps(int r) {
        return KT * NJ - (P == 2 && r == 1 ? KT : 0);
    }
    __host__ __device__ static constexpr int nsteps(int r) { return (ntaps(r) + 1) / 2; }
    static constexpr int NSA = nsteps(0);                  // k-steps of tile 0 (phase 0)
    static constexpr int NSB = nsteps(P == 2 ? 1 : 0);     // of tile 1 (phase 1 at P 2)
    static constexpr int STEPS = NSA + (P == 2 ? NSB : 0); // B images a chunk

    // tap i of phase r in staged-address order (row, then staged column), as
    // mt * 64 + j; -1 past the last (a padding tap)
    __host__ __device__ static constexpr int tap(int r, int i) {
        int n = 0;
        for (int mt = 0; mt < KT; ++mt)
            for (int sc = 0; sc < WS; ++sc)
                for (int j = 0; j < NJ; ++j)
                    if (scol(j) == sc && has(r, j)) {
                        if (n == i) return mt * 64 + j;
                        ++n;
                    }
        return -1;
    }
};

struct Geo {
    int B, C, O;                 // batch, channels summed over, channels written
    int Tin, Fin, Tout, Fout;    // `in` and `out`
    int dt, t_off, col_off, OS;  // in row = t + t_off + mt*dt; in col = q*S + col_off + j
    int qlo[2], qhi[2], ooff[2]; // per phase: valid q in [qlo, qhi), out col = q*OS + ooff
    int q_start, n_qb, n_tb, n_chunks;
    int tiles;                   // B * n_tb * n_qb
    int R;                       // staged rows: ROWS + (KT-1)*dt
    int np;                      // laid-out stages
    int wres;                    // 1: every chunk's weights resident; 0: a weight ring of np
    int base_e;                  // (address of `in` / 2) % 8
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void producer_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NPROD) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");
}

// generic-proxy stores to shared memory, visible to wgmma's reads after this
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a shared-memory matrix descriptor, K-major without swizzle; all in 16-byte
// units: the start, the distance between the two core matrices along K
// (leading byte offset) and between neighbouring ones along M or N (stride)
__device__ __forceinline__ uint64_t desc(uint32_t start16, uint32_t lbo16, uint32_t sbo16) {
    return (uint64_t)(start16 & 0x3FFF) | ((uint64_t)lbo16 << 16) | ((uint64_t)sbo16 << 32);
}

// d[64 x 32] (+)= a[64 x 16] * b[16 x 32], bf16 operands from shared memory,
// f32 accumulators; scale_d 0 ignores d's old value
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

// round(round_bf16(acc) + bias) in bf16, as bits
__device__ __forceinline__ uint16_t bf16_out(float acc, float bias, bool has_bias) {
    __nv_bfloat16 y = __float2bfloat16_rn(acc);
    if (has_bias) y = __float2bfloat16_rn(__bfloat162float(y) + bias);
    return __bfloat16_as_ushort(y);
}

// k-step S_ (and then the rest) on a consumer warpgroup's four m64 tiles:
// tiles 0 and 2 (column block 0, or phase 0) take their phase's step S_,
// tiles 1 and 3 (column block 1, or phase 1 with its own B images) theirs,
// interleaved so that four accumulator chains are in flight. A at a16[v] (the tile's first
// staged position) plus the step's first tap, its leading byte offset the
// distance to the second tap (0 at a padding tap); B image S_ at b16[sp];
// all in 16-byte units, dtws = one tap row (dt staged rows). The taps are
// constants: no instruction computes them. `first`: the tile's first chunk,
// whose first product overwrites the accumulators.
template <typename L, int P, int S_>
__device__ __forceinline__ void mma_step(float (&acc)[4][16], const uint32_t (&a16)[4],
                                         const uint32_t (&b16)[2], uint32_t dtws, bool first) {
    const int scale = first && S_ == 0 ? 0 : 1;
    if constexpr (S_ < L::NSA) {
        constexpr int t0 = L::tap(0, 2 * S_), t1 = L::tap(0, 2 * S_ + 1);
        const uint32_t o0 = (t0 >> 6) * dtws + L::scol(t0 & 63);
        const uint32_t lbo = t1 < 0 ? 0u : (t1 >> 6) * dtws + L::scol(t1 & 63) - o0;
        const uint64_t db = desc(b16[0] + S_ * (BIMG * 2 / 16), 8, 16);
        wgmma_ss(acc[0], desc(a16[0] + o0, lbo, L::WS), db, scale);
        wgmma_ss(acc[2], desc(a16[2] + o0, lbo, L::WS), db, scale);
    }
    if constexpr (S_ < L::NSB) {
        constexpr int R1 = P == 2 ? 1 : 0;
        constexpr int t0 = L::tap(R1, 2 * S_), t1 = L::tap(R1, 2 * S_ + 1);
        const uint32_t o0 = (t0 >> 6) * dtws + L::scol(t0 & 63);
        const uint32_t lbo = t1 < 0 ? 0u : (t1 >> 6) * dtws + L::scol(t1 & 63) - o0;
        const uint64_t db = desc(b16[1] + S_ * (BIMG * 2 / 16), 8, 16);
        wgmma_ss(acc[1], desc(a16[1] + o0, lbo, L::WS), db, scale);
        wgmma_ss(acc[3], desc(a16[3] + o0, lbo, L::WS), db, scale);
    }
    if constexpr (S_ + 1 < (L::NSA > L::NSB ? L::NSA : L::NSB))
        mma_step<L, P, S_ + 1>(acc, a16, b16, dtws, first);
}

struct Tile {
    int b, t0, q0;
};

template <int QC>
__device__ __forceinline__ Tile tile_at(const Geo& g, int tile) {
    const int qb = tile % g.n_qb;
    const int rest = tile / g.n_qb;
    return Tile{rest / g.n_tb, (rest % g.n_tb) * ROWS, g.q_start + qb * QC};
}

constexpr int OUT_COLS = 16;                 // output columns a tile
constexpr int OUT_CH = ROWS * OUT_COLS + 8;  // a staged output channel (padded: banks)

// Shared memory: the output tile's weights [n_chunks or NP][STEPS][BIMG], NP
// laid-out windows [R][WS] x 16 bytes, NR raw windows [CC][R][RAWW] bf16, the
// output tile [OT][ROWS][OUT_COLS] bf16 (channels OUT_CH apart), then the
// mbarriers (full[NP], empty[NP], weights).
template <int S, int KT, int NJ, int P>
size_t smem_bytes(int n_chunks, int dt, int np, int wres) {
    using L = Plan<S, KT, NJ, P>;
    const size_t R = ROWS + (KT - 1) * dt;
    return (size_t)(wres ? n_chunks : np) * L::STEPS * BIMG * 2 + np * R * L::WS * 16
           + NR * (size_t)CC * R * L::RAWW * 2 + (size_t)OT * OUT_CH * 2 + (2 * MAX_NP + 1) * 8;
}

template <int S, int KT, int NJ, int P>
__global__ void __launch_bounds__(THREADS, 1)
disc_conv_bf16_kernel(const uint16_t* __restrict__ in, const uint16_t* __restrict__ wk,
                      const uint16_t* __restrict__ bias, uint16_t* __restrict__ out, Geo g) {
    using L = Plan<S, KT, NJ, P>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int R = g.R;
    constexpr int CHUNK_W = L::STEPS * BIMG * 2;              // a chunk's weight bytes
    const int NP = g.np;
    const int wbytes = (g.wres ? g.n_chunks : NP) * CHUNK_W;
    const int pair_units = R * L::WS;                         // 16-byte units a stage
    const int raw_elems = CC * R * L::RAWW;
    unsigned char* wsm = smem;
    uint4* pairs = reinterpret_cast<uint4*>(smem + wbytes);
    uint16_t* raws = reinterpret_cast<uint16_t*>(smem + wbytes + NP * pair_units * 16);
    uint16_t* otile = raws + NR * raw_elems;
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(otile + OT * OUT_CH);
    unsigned long long* full = bars;
    unsigned long long* empty = bars + NP;
    unsigned long long* wbar = bars + 2 * MAX_NP;

    const int tid = threadIdx.x;
    const int ot = blockIdx.y;
    if (tid == 0) {
        for (int s = 0; s < NP; ++s) {   // with a weight ring, one more arrival: its copy's
            mbar_init(&full[s], NPROD / 32 + (g.wres ? 0 : 1));
            mbar_init(&empty[s], NCONS / 32);
        }
        mbar_init(wbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int my_tiles = g.tiles > (int)blockIdx.x
                             ? (g.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                             : 0;
    const int total = my_tiles * g.n_chunks;                  // chunks this CTA lays out

    if (tid >= NCONS) {
        // ---------------------------------------------------------- producer
        const int pt = tid - NCONS;
        const uint16_t* wsrc = wk + (size_t)ot * g.n_chunks * L::STEPS * BIMG;
        if (pt == 0 && g.wres) {
            mbar_expect(wbar, wbytes);
            for (int c = 0; c < g.n_chunks; ++c)
                bulk_copy(wsm + (size_t)c * CHUNK_W, wsrc + (size_t)c * L::STEPS * BIMG, CHUNK_W,
                          wbar);
        }
        // with a weight ring, flat chunk i's weights into weight stage i % NP
        // (free once the consumers free laid-out stage i % NP)
        auto load_weights = [&](int i) {
            if (pt != 0 || g.wres) return;
            mbar_expect(&full[i % NP], CHUNK_W);
            bulk_copy(wsm + (size_t)(i % NP) * CHUNK_W,
                      wsrc + (size_t)(i % g.n_chunks) * L::STEPS * BIMG, CHUNK_W, &full[i % NP]);
        };
        const int plane7 = (g.Tin * g.Fin) & 7;     // element offsets mod 8 set alignment
        const int fin7 = g.Fin & 7;
        // the raw pieces of flat chunk i into raw stage i % NR: a thread a
        // (channel, row) segment, its 16-byte pieces that hold any column of
        // the row, in one burst (a warp's copies spread over 32 rows issue
        // faster than the same pieces laid out by lanes along each row)
        auto issue = [&](int i) {
            const Tile tl = tile_at<L::QC>(g, blockIdx.x + (i / g.n_chunks) * gridDim.x);
            const int ch0 = (i % g.n_chunks) * CC;
            const int wbase = tl.q0 * S + g.col_off;
            uint16_t* raw = raws + (i % NR) * raw_elems;
            for (int row_id = pt; row_id < CC * R; row_id += NPROD) {
                const int r = row_id % R;                    // row_id = c * R + r
                const int ch = ch0 + row_id / R, row = tl.t0 + g.t_off + r;
                if (ch >= g.C || row < 0 || row >= g.Tin) continue;
                const uint16_t* p =
                    in + (((size_t)tl.b * g.C + ch) * g.Tin + row) * g.Fin + wbase;
                const int shift = (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
                uint16_t* dst = raw + row_id * L::RAWW;
#pragma unroll
                for (int pc = 0; pc < L::NPIECE; ++pc) {
                    const int col0 = wbase - shift + 8 * pc;  // the piece's first column
                    if (col0 < g.Fin && col0 + 8 > 0) cp_async16(dst + 8 * pc, p - shift + 8 * pc);
                }
            }
            cp_async_commit();
        };
        // raw stage i % NR laid out channels-last into stage i % NP: a thread
        // an item of NG staged columns of one row, the row's 8 channel
        // offsets (each channel row's alignment, (address / 2) % 8) computed
        // once for them
        constexpr int NG = 3;
        constexpr int GROUPS = (L::WS + NG - 1) / NG;
        auto layout = [&](int i) {
            const Tile tl = tile_at<L::QC>(g, blockIdx.x + (i / g.n_chunks) * gridDim.x);
            const int ch0 = (i % g.n_chunks) * CC;
            const int nch = g.C - ch0;                       // channels of the chunk in `in`
            const int wbase = tl.q0 * S + g.col_off;
            const int k0 = g.base_e + wbase + ((tl.b * g.C + ch0) & 7) * plane7;
            const uint16_t* raw = raws + (i % NR) * raw_elems;
            uint4* dst = pairs + (i % NP) * pair_units;
            for (int e = pt; e < R * GROUPS; e += NPROD) {
                const int r = e / GROUPS, sc0 = (e % GROUPS) * NG;
                const int row = tl.t0 + g.t_off + r;
                const bool row_ok = row >= 0 && row < g.Tin;
                const int s0 = (k0 + (row & 7) * fin7) & 7;
                int off[CC];
#pragma unroll
                for (int c = 0; c < CC; ++c)
                    off[c] = (c * R + r) * L::RAWW + ((s0 + c * plane7) & 7);
#pragma unroll
                for (int n = 0; n < NG; ++n) {
                    const int sc = sc0 + n;
                    if (sc >= L::WS) break;
                    const int col_rel =
                        S == 2 ? (sc < L::HALF ? 2 * sc : 2 * (sc - L::HALF) + 1) : sc;
                    const int col = wbase + col_rel;
                    uint32_t v[4] = {0u, 0u, 0u, 0u};
                    if (row_ok && col >= 0 && col < g.Fin) {
#pragma unroll
                        for (int c = 0; c < CC; ++c) {
                            const uint32_t val = c < nch ? raw[off[c] + col_rel] : 0u;
                            v[c >> 1] |= val << (16 * (c & 1));
                        }
                    }
                    dst[r * L::WS + sc] = make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
        };
        if (total > 0) issue(0);
        for (int i = 0; i < total; ++i) {
            if (i + 1 < total) issue(i + 1);
            else cp_async_commit();
            cp_async_wait<1>();
            producer_sync();                 // every producer's copies of chunk i are in
            const int st = i % NP;
            mbar_wait(&empty[st], ((i / NP) & 1) ^ 1);
            load_weights(i);
            layout(i);
            fence_proxy_async();
            __syncwarp();
            if ((pt & 31) == 0) mbar_arrive(&full[st]);
            producer_sync();                 // raw stage i % NR is free for chunk i + NR
        }
        return;
    }

    // -------------------------------------------------------------- consumers
    // warpgroup u, tile v: rows 8 (2u + v / 2).. of the tile and, at P 1,
    // columns 8 (v % 2)..; at P 2 all 8 columns of phase v % 2
    const int warp = tid >> 5, lane = tid & 31;
    const int u = warp >> 2;
    const int wq = warp & 3;
    const int gq = lane >> 2, qq = lane & 3;
    const uint32_t w16 = smem_u32(wsm) >> 4;
    const uint32_t p16 = smem_u32(pairs) >> 4;
    uint32_t a_tile[4];                      // each tile's first staged position in a stage
#pragma unroll
    for (int v = 0; v < 4; ++v)
        a_tile[v] = 8 * (2 * u + v / 2) * L::WS + (P == 2 ? 0 : 8 * (v % 2));
    float acc[4][16];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[v][i] = 0.f;
    // the bias of the thread's 8 output channels (8 (jj >> 1) + 2qq + (jj & 1))
    const bool has_bias = bias != nullptr;
    float bias_f[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
        const int o = ot * OT + 8 * (jj >> 1) + 2 * qq + (jj & 1);
        bias_f[jj] = has_bias && o < g.O ? __bfloat162float(__ushort_as_bfloat16(bias[o])) : 0.f;
    }
    if (g.wres) mbar_wait(wbar, 0);
    const uint32_t dtws = g.dt * L::WS;       // one tap row: dt staged rows
    // the staged output tile's rows go out a share a chunk, behind the next
    // tile's products: half-warp h writes rows 2h and 2h + 1 of the channels
    // [o_lo, o_hi) of the tile staged last
    const int h = tid >> 4, lc = tid & 15;
    const int n_o = min(OT, g.O - ot * OT);
    Tile staged{0, 0, 0};
    auto store_rows = [&](int o_lo, int o_hi) {
        const int f = staged.q0 * g.OS + g.ooff[0] + lc;
        const int t = staged.t0 + 2 * h;
        if (f < 0 || f >= g.Fout || t >= g.Tout) return;
        const bool two = t + 1 < g.Tout;
        const size_t plane = (size_t)g.Tout * g.Fout;
        uint16_t* dst =
            out + (((size_t)staged.b * g.O + ot * OT + o_lo) * g.Tout + t) * g.Fout + f;
        const uint16_t* src = otile + o_lo * OUT_CH + 2 * h * OUT_COLS + lc;
        for (int o = o_lo; o < o_hi; ++o, dst += plane, src += OUT_CH) {
            dst[0] = src[0];
            if (two) dst[g.Fout] = src[OUT_COLS];
        }
    };
    for (int k = 0, i = 0; k < my_tiles; ++k) {
        for (int chunk = 0; chunk < g.n_chunks; ++chunk, ++i) {
            const int st = i % NP;
            mbar_wait(&full[st], (i / NP) & 1);
            const uint32_t stage16 = p16 + st * pair_units;
            const uint32_t chunk16 = w16 + (g.wres ? chunk : st) * (CHUNK_W / 16);
            const uint32_t a16[4] = {stage16 + a_tile[0], stage16 + a_tile[1],
                                     stage16 + a_tile[2], stage16 + a_tile[3]};
            const uint32_t b16[2] = {chunk16, chunk16 + (P == 2 ? L::NSA : 0) * (BIMG * 2 / 16)};
            wgmma_fence();
            mma_step<L, P, 0>(acc, a16, b16, dtws, chunk == 0);
            wgmma_commit();
            if (k > 0)   // the previous tile's share of rows, while the tensor cores work
                store_rows(n_o * chunk / g.n_chunks, n_o * (chunk + 1) / g.n_chunks);
            // one group in flight: the previous chunk's is done, its stage free
            wgmma_wait<1>();
            __syncwarp();
            if (chunk > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % NP]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
            for (int j = 0; j < 16; ++j) keep(acc[v][j]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % NP]);

        // epilogue: accumulator j of tile v is output channel 8 (j >> 2) +
        // 2qq + (j & 1), row 8 (2u + v / 2) + 2wq + ((j >> 1) & 1) of the tile,
        // column 8 (v % 2) + gq (P 1) or 2 gq + v % 2 (P 2: the phases'
        // columns interleave). The tile is staged in shared memory, and each
        // output row's 16 columns are written by one half-warp during the
        // next tile.
        consumer_sync();                     // the previous tile's rows are out
        uint16_t* mine = otile + 2 * qq * OUT_CH + (16 * u + 2 * wq) * OUT_COLS
                         + (P == 2 ? 2 * gq : gq);
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float b = bias_f[2 * (j >> 2) + (j & 1)];
                mine[8 * (v / 2) * OUT_COLS + (P == 2 ? v % 2 : 8 * (v % 2))
                     + (8 * (j >> 2) + (j & 1)) * OUT_CH + ((j >> 1) & 1) * OUT_COLS] =
                    bf16_out(acc[v][j], b, has_bias);
            }
        consumer_sync();
        staged = tile_at<L::QC>(g, blockIdx.x + k * gridDim.x);
    }
    if (my_tiles > 0) store_rows(0, n_o);
}

// The B images (ops/disc_conv_kernel.py `pack_weight_bf16` is its plain
// version; the bits are the same): out [ceil(O/32)][ceil(C/8)][STEPS][BIMG],
// element (n, k) of a k-step at (n / 8) * 128 + (k / 8) * 64 + (n % 8) * 8 +
// k % 8, the weight of summed channel 8 * chunk + k % 8 at the k-step's tap
// k / 8 for output channel 32 * tile + n. Forward (dx = 0): tap (mt, j) is
// w[o, c, mt, j]; input gradient: w[c, o, KT-1-mt, r + sf*(NJ-1-j)], zero
// past KF. One thread an element; bf16 in, no rounding.
template <int S, int KT, int NJ, int P>
__global__ void disc_conv_bf16_pack_kernel(const uint16_t* __restrict__ w,
                                           uint16_t* __restrict__ out, int Cout, int Cin, int KF,
                                           int sf, int dx, int total) {
    using L = Plan<S, KT, NJ, P>;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int C = dx ? Cout : Cin, O = dx ? Cin : Cout;
    const int chunks = (C + CC - 1) / CC;
    const int e = idx % BIMG;
    const int step = (idx / BIMG) % L::STEPS;
    const int chunk = (idx / (BIMG * L::STEPS)) % chunks;
    const int tile = idx / (BIMG * L::STEPS * chunks);
    const int n = (e / 128) * 8 + (e / 8) % 8, k = ((e / 64) % 2) * 8 + e % 8;
    const int r = P == 2 && step >= L::NSA ? 1 : 0;
    const int t = L::tap(r, 2 * (step - (r ? L::NSA : 0)) + k / 8);
    const int c = chunk * CC + k % 8, o = tile * OT + n;
    uint16_t v = 0;
    if (t >= 0 && c < C && o < O) {
        const int mt = t >> 6, j = t & 63;
        if (!dx) {
            v = w[(((size_t)o * Cin + c) * KT + mt) * KF + j];
        } else {
            const int kf = r + sf * (NJ - 1 - j);
            if (kf < KF) v = w[(((size_t)c * Cin + o) * KT + (KT - 1 - mt)) * KF + kf];
        }
    }
    out[idx] = v;
}

int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

cudaError_t use_device(int device) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return err;
}

// The device's opt-in shared-memory limit and SM count, read once per device.
cudaError_t device_limits(int device, int* smem, int* sms) {
    static std::atomic<int> cached_smem[MAX_DEVICES], cached_sms[MAX_DEVICES];
    int v = cached_smem[device].load(std::memory_order_relaxed);
    int n = cached_sms[device].load(std::memory_order_relaxed);
    if (v == 0 || n == 0) {
        cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                                 device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        cached_smem[device].store(v, std::memory_order_relaxed);
        cached_sms[device].store(n, std::memory_order_relaxed);
    }
    *smem = v;
    *sms = n;
    return cudaSuccess;
}

struct Conv {
    int B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf;
};

// The forward (dx = 0) or the input gradient (dx = 1) as the correlation's
// geometry.
Geo geometry(const Conv& c, int dx, int qc, const void* in) {
    Geo g{};
    const int To = c.T + 2 * c.pt - (c.KT - 1) * c.dt;
    const int Fo = (c.F + 2 * c.pf - c.KF) / c.sf + 1;
    g.B = c.B;
    g.dt = c.dt;
    if (!dx) {
        g.C = c.Cin; g.O = c.Cout;
        g.Tin = c.T; g.Fin = c.F; g.Tout = To; g.Fout = Fo;
        g.t_off = -c.pt; g.col_off = -c.pf; g.OS = 1;
        g.qlo[0] = g.qlo[1] = 0; g.qhi[0] = g.qhi[1] = Fo; g.ooff[0] = g.ooff[1] = 0;
    } else {
        const int NJ = (c.KF + c.sf - 1) / c.sf;
        g.C = c.Cout; g.O = c.Cin;
        g.Tin = To; g.Fin = Fo; g.Tout = c.T; g.Fout = c.F;
        g.t_off = c.pt - (c.KT - 1) * c.dt; g.col_off = -(NJ - 1); g.OS = c.sf;
        for (int r = 0; r < 2; ++r) {
            const int rr = r < c.sf ? r : 0;
            // f = q*sf + r - pf must lie in [0, F)
            g.qlo[r] = -floor_div(rr - c.pf, c.sf);
            g.qhi[r] = floor_div(c.F - 1 + c.pf - rr, c.sf) + 1;
            g.ooff[r] = rr - c.pf;
        }
    }
    const int phases = dx ? c.sf : 1;
    int lo = g.qlo[0], hi = g.qhi[0];
    for (int r = 1; r < phases; ++r) {
        lo = g.qlo[r] < lo ? g.qlo[r] : lo;
        hi = g.qhi[r] > hi ? g.qhi[r] : hi;
    }
    g.q_start = lo;
    g.n_qb = hi > lo ? (hi - lo + qc - 1) / qc : 0;
    g.n_tb = (g.Tout + ROWS - 1) / ROWS;
    g.n_chunks = (g.C + CC - 1) / CC;
    g.tiles = g.B * g.n_tb * g.n_qb;
    g.R = ROWS + (c.KT - 1) * c.dt;
    g.base_e = (int)((reinterpret_cast<uintptr_t>(in) >> 1) & 7);
    return g;
}

template <int S, int KT, int NJ, int P>
cudaError_t run(const Conv& c, int dx, const uint16_t* in, const uint16_t* wk,
                const uint16_t* bias, uint16_t* out, int device, cudaStream_t stream) {
    Geo g = geometry(c, dx, Plan<S, KT, NJ, P>::QC, in);
    const int o_tiles = (g.O + OT - 1) / OT;
    if (g.tiles == 0 || g.Tout <= 0 || g.Fout <= 0) return cudaSuccess;
    int max_smem = 0, sms = 0;
    cudaError_t err = device_limits(device, &max_smem, &sms);
    if (err != cudaSuccess) return err;
    // resident weights first, then a weight ring; 3 laid-out stages, else 2
    size_t smem = 0;
    for (int mode = 0; mode < 4; ++mode) {
        g.wres = mode < 2;
        g.np = mode % 2 ? 2 : MAX_NP;
        smem = smem_bytes<S, KT, NJ, P>(g.n_chunks, c.dt, g.np, g.wres);
        if (smem <= (size_t)max_smem) break;
    }
    if (smem > (size_t)max_smem || o_tiles > 65535) return cudaErrorInvalidValue;
    static std::atomic<bool> configured[MAX_DEVICES];
    if (!configured[device].load(std::memory_order_relaxed)) {
        err = cudaFuncSetAttribute(disc_conv_bf16_kernel<S, KT, NJ, P>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        if (err != cudaSuccess) return err;
        configured[device].store(true, std::memory_order_relaxed);
    }
    const dim3 grid(g.tiles < sms ? g.tiles : sms, o_tiles);
    disc_conv_bf16_kernel<S, KT, NJ, P><<<grid, THREADS, smem, stream>>>(in, wk, bias, out, g);
    return cudaGetLastError();
}

// The discriminator's tap classes: 3x9 forward at F-stride 2, 3x3 forward
// and dx at F-stride 1, 3x5 dx (two phases) of the 3x9 convs.
int dispatch(const Conv& c, int dx, const void* in, const void* wk, const void* bias, void* out,
             int device, void* stream) {
    if ((c.sf != 1 && c.sf != 2) || c.dt < 1 || c.pt < 0 || c.pf < 0) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    if (c.B <= 0) return cudaSuccess;
    auto s = static_cast<cudaStream_t>(stream);
    auto i = static_cast<const uint16_t*>(in);
    auto k = static_cast<const uint16_t*>(wk);
    auto bp = static_cast<const uint16_t*>(bias);
    auto o = static_cast<uint16_t*>(out);
    if (c.KT == 3 && c.KF == 9 && c.sf == 2)
        return dx ? run<1, 3, 5, 2>(c, 1, i, k, nullptr, o, device, s)
                  : run<2, 3, 9, 1>(c, 0, i, k, bp, o, device, s);
    if (c.KT == 3 && c.KF == 3 && c.sf == 1)
        return run<1, 3, 3, 1>(c, dx, i, k, dx ? nullptr : bp, o, device, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// Forward. x [B, Cin, T, F] bf16 (as bits); wk the B images of w [Cout,
// Cin, KT, KF], [ceil(Cout/32)][ceil(Cin/8)][steps][512]
// (encodec_disc_conv_pack_bf16); bias [Cout] or null; y [B, Cout, To, Fo]
// with To = T + 2*pt - (KT-1)*dt and Fo = (F + 2*pf - KF) / sf + 1. Returns a
// CUDA error code (0 = launched).
extern "C" int encodec_disc_conv_fwd_bf16(const uint16_t* x, const uint16_t* wk,
                                          const uint16_t* bias, uint16_t* y, int B, int Cin,
                                          int Cout, int T, int F, int KT, int KF, int sf, int dt,
                                          int pt, int pf, int device, void* stream) {
    return dispatch(Conv{B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf}, 0, x, wk, bias, y, device,
                    stream);
}

// Input gradient. gy [B, Cout, To, Fo] (the output's cotangent); wk
// [ceil(Cin/32)][ceil(Cout/8)][steps][512], the B images of the correlation
// of gy with w[co, ci, KT-1-m, r + sf*(NJ-1-j)], NJ = ceil(KF / sf), per
// phase r; dx [B, Cin, T, F]. Every element of dx is written.
extern "C" int encodec_disc_conv_dx_bf16(const uint16_t* gy, const uint16_t* wk, uint16_t* dx,
                                         int B, int Cin, int Cout, int T, int F, int KT, int KF,
                                         int sf, int dt, int pt, int pf, int device,
                                         void* stream) {
    return dispatch(Conv{B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf}, 1, gy, wk, nullptr, dx,
                    device, stream);
}

// The B images alone (dx = 0: the forward's, 1: the input gradient's) from w
// [Cout, Cin, KT, KF] into out. Returns a CUDA error code (0 = launched).
extern "C" int encodec_disc_conv_pack_bf16(const uint16_t* w, uint16_t* out, int Cout, int Cin,
                                           int KT, int KF, int sf, int dx, int device,
                                           void* stream) {
    if (sf != 1 && sf != 2) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const int C = dx ? Cout : Cin, O = dx ? Cin : Cout;
    const long long total_base = (long long)((O + OT - 1) / OT) * ((C + CC - 1) / CC) * BIMG;
    auto s = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel, int steps) {
        const long long total = total_base * steps;
        if (total > (1LL << 30)) return cudaErrorInvalidValue;
        if (total == 0) return cudaSuccess;
        kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(w, out, Cout, Cin, KF, sf, dx,
                                                               (int)total);
        return cudaGetLastError();
    };
    if (KT == 3 && KF == 9 && sf == 2)
        return dx ? launch(disc_conv_bf16_pack_kernel<1, 3, 5, 2>, Plan<1, 3, 5, 2>::STEPS)
                  : launch(disc_conv_bf16_pack_kernel<2, 3, 9, 1>, Plan<2, 3, 9, 1>::STEPS);
    if (KT == 3 && KF == 3 && sf == 1)
        return launch(disc_conv_bf16_pack_kernel<1, 3, 3, 1>, Plan<1, 3, 3, 1>::STEPS);
    return cudaErrorInvalidValue;
}
