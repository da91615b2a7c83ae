// Discriminator im2col conv in bf16, forward (kernel K5's bf16 form) for
// Hopper: warpgroup MMA (wgmma) with both operands in shared memory, fed by
// producer warps that turn NCHW rows into a channels-last window, in
// persistent CTAs.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_conv2d.py `_kernel` in its bf16
// form (the TPU kernel takes its input's dtype: bf16 scratch, f32
// accumulation, bf16 out, pallas_conv2d.py:71, :86, :99-102, :152). It
// computes the forward of the MS-STFT discriminator's 32 -> 32, 3x9,
// F-stride-2 convs (conv_1..conv_3 of each scale), NCHW with H = STFT frames
// (time) and W = frequency bins, time stride 1, time dilation DT (1, 2 or 4,
// a template parameter), zero padding (pt, pf):
//
//     y[b, co, t, f] = bias[co] + sum_{ci, mt, mf} W[co, ci, mt, mf] * x[b, ci, t + mt*DT - pt, 2f + mf - pf]
//
// the TPU kernel's GEMM W[32, 864] @ X[864, N] as an implicit GEMM.
// Numerics: bf16 x bf16 products, exact in f32, summed in f32 by the tensor
// cores, the sum rounded to nearest even to bf16, the bias added after that
// rounding in bf16 (round(round(acc) + bias), ops/conv.py:263). No atomics
// and no split K: the same input gives the same bits on every call.
//
// What bounds it on this card: bytes by a hair, operations almost as
// closely. A 3x9 F-stride-2 32 -> 32 conv does 2 * 864 operations an output
// and, with x read once and y written once, moves 4 bytes of x (two bf16
// input columns an output column, over as many channels) and 2 of y an
// output: 1728 / 6 = 288 operations a byte, just under the card's bf16 ridge
// (989 TFLOP/s / 3.35 TB/s = 295).
// At the 48 kHz training call (B 32, 48000 stereo, the 9 convs of its three
// scales) that is 439.4 GFLOP (0.444 ms at 989 TFLOP/s) against 1.52 GB
// (0.454 ms at 3.35 TB/s). As built, what bounds it is the SM's shared
// memory: a wgmma m64n32k16 with both operands there reads 3 KB (A 2 KB, B
// 1 KB) for 32K multiply-adds, so a chunk's 112 take ~2700 cycles of shared
// bandwidth alone (the consumers' issue time with no producer loads, below),
// and the producers' loads and stores and the output stores share it.
//
// What held the earlier form back (csrc/disc_im2col.cu before this file:
// one 16-row x 32-column tile a CTA, two CTAs an SM, 4.064 ms for the 9
// convs), and what this design does about it:
// 1. Its window was staged through registers on the MMA warps' path, between
//    a block barrier and the chunk's products. Here eight producer warps
//    stage it while two consumer warpgroups compute: a ring of 4 window
//    stages beside the resident weights, full and empty mbarriers between
//    the two sides, no CTA-wide barrier after the prologue.
// 2. A came from registers, four 32-bit shared loads a wgmma, with at most
//    two wgmmas in flight a warpgroup. Here A and B are both read by the
//    tensor cores from shared memory by descriptor, and each consumer
//    warpgroup keeps four independent accumulator chains (four m64 tiles)
//    in flight, issued interleaved, a chunk's 56 wgmmas one commit group.
// 3. Its grid was one CTA a tile, each starting cold on 4 chunks. Here one
//    CTA an SM walks the (batch, row block, column block) tiles, and the
//    producers stage the next tile's chunks during the current one's last
//    chunks and epilogue.
// 4. Its epilogue was 2-byte stores scattered over two rows and 8 channel
//    planes a thread. Here the tile is staged in shared memory (channels
//    last, a channel pair a 32-bit store), and each output row's 16 columns
//    go out as one 32-byte segment by a half-warp, a quarter of the tile
//    after each chunk's wgmmas of the next tile.
// 5. Its weights were packed on every call; they still are (one launch of
//    pack_weight_bf16_kernel, a 57 KB write: the weights change every
//    training step, and no cache keyed on the tensor could tell), but the
//    packed images are copied once a CTA by TMA bulk copies and stay
//    resident (56 KB), instead of a chunk's images a chunk.
//
// Design:
// - M = output positions, N = the 32 output channels, K = 32 channels x 27
//   taps in 4 chunks of 8 channels; a k-step of 16 is the chunk's 8 channels
//   at two taps, the taps paired in the order of their staged addresses
//   (tap_at), so that the A descriptor's leading byte offset (the distance
//   to the second tap) is never negative; 14 k-steps a chunk, the 28th tap a
//   zero-weight one.
// - A CTA tile is 32 output rows x 16 output columns of one image: eight m64
//   tiles of 8 rows x 8 columns, four a consumer warpgroup. No wgmma sits
//   under a branch (ptxas serializes every wgmma of a kernel that issues one
//   conditionally): edge tiles compute on zeros and store nothing.
// - The window of a chunk: R = 32 + 2*DT staged rows x RS slots of 16 bytes
//   (8 channels of one input position, channels-last). A staged row keeps
//   the even input columns first (slots 0..19) and the odd ones from slot
//   OB = 21 on, so that eight neighbouring output columns read eight
//   neighbouring slots at every tap: a core matrix of wgmma's K-major
//   layout. OB is odd, so that the two halves of a unit's positions fall in
//   different bank groups (a stmatrix store is at most 2-way conflicted). A k-step's A descriptor is the window's address at its first
//   tap, its leading byte offset the distance to the second, its stride
//   byte offset one staged row; every tap offset is a compile-time constant.
// - The producer path (the crux: x's rows of 2^k + 1 bf16 are only 2-byte
//   aligned, which rules out TMA boxes and 16-byte copies of row segments).
//   A unit is 8 consecutive input columns of one staged row; a producer
//   warp takes 4 units for all 8 channels at once, lane 4c + q holding
//   channel c of unit q: two 16-byte loads of the aligned pieces that cover
//   its 16 bytes (a piece is read only if it holds an element of the row in
//   x), then a shift by the row's alignment (two selects and a funnel shift
//   a word), zeros outside x. The warp's four units x 8 channels are four 8
//   x 8 bf16 matrices (channels x positions) in exactly the register
//   fragment that `stmatrix.sync.aligned.m8n8.x4.trans.b16` stores
//   transposed: each stored 16-byte row is one position's 8 channels, at an
//   address each lane computes, so the even/odd split is only in the store
//   addresses. The loads are software-pipelined by a chunk: iteration j of
//   chunk i + 1 is loaded right after iteration j of chunk i is laid out,
//   into the same registers, so their latency hides behind a chunk.
//
// What the stamps showed (scripts/probe_torch_disc_im2col_bf16.py, clock64
// stamps a chunk, B 32 at the 9 shapes, NVIDIA H100 80GB HBM3, 700 W): the
// consumers bound it. A chunk's loop takes ~5380-5980 cycles; the
// consumers spend ~3100-3350 of it issuing the 112 wgmmas (2680-2830 with
// the producers' loads taken out), ~1100-1400 storing rows and ~420-440 (a
// quarter of the epilogue); the producers lay a chunk out in ~4440-4770 and
// then wait ~650-710 for a free stage. With the wgmmas taken out the loop
// is ~3500-3950 cycles a chunk, with the loads taken out ~4200-4330.
// Tried and measured with the probe, and not kept: TMA bulk copies of the
// rows' pieces into a raw ring, then the same transpose from shared memory
// (the issue's second candidate): the TMA unit takes ~11 cycles a copy of
// 80-96 bytes, so issuing a chunk's ~300 copies took ~3300-4700 cycles, and
// the kernel 2.53 ms against this form's ~1.95; the output stores
// interleaved one channel a k-step between the wgmmas (each store stalls
// the issue: 2.35 ms), written straight from the accumulators (the LSU
// queue fills: 2.15 ms), or handed to the producers (they lag and the
// consumers wait for the output tile: 2.24 ms); all but the first timed by
// the probe's library line, which then included the wrapper's host work.
// With --variants it times kept-source forms in turns: 3 or 5 window stages
// and a consumer warpgroup a chunk behind the other change nothing, 4 or 12
// producer warps are slower.
#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

// clock64 stamps and the probe's variants, for
// scripts/probe_torch_disc_im2col_bf16.py, which builds this file with
// K5_STAMPS (and K5_NO_MMA or K5_NO_COPY) defined; the library has none
#ifdef K5_STAMPS
__device__ unsigned long long k5_stamps[16];
#define K5_CLOCK(v) const long long v = clock64()
#define K5_ADD(acc, from, to) acc += (to) - (from)
#else
#define K5_CLOCK(v) \
    do {            \
    } while (0)
#define K5_ADD(acc, from, to) \
    do {                      \
    } while (0)
#endif

namespace {

constexpr int CI = 32, CO = 32;         // input and output channels
constexpr int KT = 3, KF = 9, TAPS = KT * KF;
constexpr int CC = 8;                   // input channels a chunk (16 bytes a position)
constexpr int NCHUNK = CI / CC;
constexpr int NSTEP = (TAPS + 1) / 2;   // k-steps a chunk
constexpr int ROWS = 32;                // output rows a tile
constexpr int FT = 16;                  // output columns a tile
constexpr int NT = 4;                   // m64 tiles a consumer warpgroup
constexpr int WIN = 2 * (FT - 1) + KF;  // input columns a tile reads
constexpr int G = (WIN + 7) / 8;        // units (8 input columns) a staged row
constexpr int HALF = FT + (KF - 1) / 2; // even columns a staged row
constexpr int OB = HALF + 1;            // first odd slot (odd: see the head note)
constexpr int RS = OB + HALF;           // slots a staged row (16 bytes each)
constexpr int NCONS = 256;              // two consumer warpgroups
constexpr int NPROD = 256;              // eight producer warps
constexpr int THREADS = NCONS + NPROD;
constexpr int NPW = NPROD / 32;
constexpr int NP = 4;                   // window stages
constexpr int BIMG = 512;               // bf16 of a B image (32 channels x 16 k)
constexpr int CHUNK_W = NSTEP * BIMG * 2;            // bytes of a chunk's B images
constexpr int WBYTES = NCHUNK * CHUNK_W;             // all of them, resident
constexpr int OCS = CO + 2;             // bf16 a staged output position (padded: banks)
constexpr int MAX_DEVICES = 64;
static_assert(HALF % 2 == 0 && OB % 2 == 1 && RS >= OB + HALF, "staged row layout");

// The window of a chunk at time dilation DT: staged rows, units, producer
// warp iterations (4 units each), the rows allocated (the last iteration's
// spare units land in the spare row), bytes a stage.
template <int DT>
struct Win {
    static constexpr int R = ROWS + (KT - 1) * DT;
    static constexpr int NU = R * G;
    static constexpr int NIT = (NU + 3) / 4;
    static constexpr int RA = (4 * NIT + G - 1) / G;
    static constexpr int STAGE = RA * RS * 16;
    static constexpr int PER_WARP = (NIT + NPW - 1) / NPW;
};

// tap i of the 28 in staged-address order (mt, then the even mf, then the
// odd), as mt * 16 + mf; -1 for the padding tap
__host__ __device__ constexpr int tap_at(int i) {
    if (i >= TAPS) return -1;
    const int mt = i / KF, j = i % KF;
    return mt * 16 + (j < (KF + 1) / 2 ? 2 * j : 2 * (j - (KF + 1) / 2) + 1);
}

// slot of input column mf of a staged row (relative to the tile's first)
__host__ __device__ constexpr int slot(int mf) { return mf % 2 ? OB + mf / 2 : mf / 2; }

// a tap's offset in a stage, in 16-byte units
template <int DT>
__host__ __device__ constexpr int tap_off(int t) {
    return (t >> 4) * DT * RS + slot(t & 15);
}

struct Geo {
    int T, F, To, Fo, pt, pf;
    int n_tb, n_cb, tiles;   // row blocks, column blocks, B * n_tb * n_cb
};

struct Tile {
    int b, t0, f0;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int tile) {
    const int cb = tile % g.n_cb;
    const int rest = tile / g.n_cb;
    return Tile{rest / g.n_tb, (rest % g.n_tb) * ROWS, cb * FT};
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
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

// four 8 x 8 bf16 matrices from the warp's fragments (lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of each, in r[m]), stored transposed:
// the 16-byte row i of matrix m (column i of the fragment) at the address
// lane 8m + i gives
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
}

__device__ __forceinline__ uint4 ldg16(uintptr_t a) {
    return __ldg(reinterpret_cast<const uint4*>(a));
}

// round(round_bf16(acc) + bias) in bf16, for two neighbouring channels
__device__ __forceinline__ __nv_bfloat162 bf16x2_out(float a0, float a1, float b0, float b1,
                                                     bool has_bias) {
    __nv_bfloat162 y = __floats2bfloat162_rn(a0, a1);
    if (has_bias) {
        const float2 f = __bfloat1622float2(y);
        y = __floats2bfloat162_rn(f.x + b0, f.y + b1);
    }
    return y;
}

// k-step S_ (and then the rest) of a chunk on a consumer warpgroup's four
// m64 tiles, interleaved so that four accumulator chains are in flight; A at
// a16[v] (the tile's first staged position) plus the step's first tap, B
// image S_ of the chunk at b16; all in 16-byte units, every offset a
// constant. `first`: the tile's first chunk, whose first product overwrites
// the accumulators.
template <int DT, int S_>
__device__ __forceinline__ void mma_step(float (&acc)[NT][16], const uint32_t (&a16)[NT],
                                         uint32_t b16, bool first) {
    constexpr int t0 = tap_at(2 * S_), t1 = tap_at(2 * S_ + 1);
    constexpr uint32_t o0 = tap_off<DT>(t0);
    constexpr uint32_t lbo = t1 < 0 ? 0u : tap_off<DT>(t1) - o0;
    static_assert(t1 < 0 || tap_off<DT>(t1) >= tap_off<DT>(t0), "taps in address order");
    const int scale = first && S_ == 0 ? 0 : 1;
    const uint64_t db = desc(b16 + S_ * (BIMG * 2 / 16), 8, 16);
#pragma unroll
    for (int v = 0; v < NT; ++v) wgmma_ss(acc[v], desc(a16[v] + o0, lbo, RS), db, scale);
    if constexpr (S_ + 1 < NSTEP) mma_step<DT, S_ + 1>(acc, a16, b16, first);
}

// Shared memory: the B images [NCHUNK][NSTEP][BIMG], NP window stages, the
// output tile [ROWS * FT][OCS] bf16 (channels last), then the mbarriers
// (full[NP], empty[NP], weights).
template <int DT>
constexpr size_t smem_bytes() {
    return (size_t)WBYTES + (size_t)NP * Win<DT>::STAGE + (size_t)ROWS * FT * OCS * 2
           + (2 * NP + 1) * 8;
}

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
disc_im2col_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wk,
                        const uint16_t* __restrict__ bias, uint16_t* __restrict__ y, Geo g) {
    using Wn = Win<DT>;
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* wsm = smem;
    unsigned char* stages = smem + WBYTES;
    uint16_t* otile = reinterpret_cast<uint16_t*>(stages + NP * Wn::STAGE);
    unsigned long long* full = reinterpret_cast<unsigned long long*>(otile + ROWS * FT * OCS);
    unsigned long long* empty = full + NP;
    unsigned long long* wbar = full + 2 * NP;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    if (tid == 0) {
        for (int s = 0; s < NP; ++s) {
            mbar_init(&full[s], NPW);
            mbar_init(&empty[s], NCONS / 32);
        }
        mbar_init(wbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int my_tiles = (g.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int total = my_tiles * NCHUNK;                   // chunks this CTA stages

    if (tid >= NCONS) {
        // ---------------------------------------------------------- producer
        const int pw = (tid - NCONS) >> 5;
        if (pw == 0 && lane == 0) {
            mbar_expect(wbar, WBYTES);
            for (int c = 0; c < NCHUNK; ++c)
                bulk_copy(wsm + c * CHUNK_W, wk + (size_t)c * CHUNK_W / 2, CHUNK_W, wbar);
        }
        const int c = lane >> 2, q = lane & 3;          // the channel and unit this lane loads
        const int mm = lane >> 3, rr = lane & 7;        // the matrix row this lane addresses
        const uint32_t st0 = smem_u32(stages);
        // this lane's units of the warp's iterations of a chunk: the loads
        // (two 16-byte pieces each) and the row's alignment (bits 0-2) with
        // the unit's valid elements [lo, hi); software-pipelined by a chunk:
        // iteration j of chunk i + 1 is loaded right after iteration j of
        // chunk i is laid out, into the same registers
        uint4 p0[Wn::PER_WARP], p1[Wn::PER_WARP];
        int sh[Wn::PER_WARP];
        auto load_chunk_iter = [&](int i, int row0, int col0, uintptr_t plane, int j) {
            const int u = 4 * (pw + j * NPW) + q;
            const int r = u / G, cg = u - (u / G) * G;
            const int row = row0 + r, col = col0 + 8 * cg;
            const bool ok = i < total && u < Wn::NU && row >= 0 && row < g.T;
            const uintptr_t a = plane + 2 * ((ptrdiff_t)row * g.F + col);
            const int s = (int)((a >> 1) & 7);
            const uintptr_t a16 = a & ~(uintptr_t)15;
            // each piece is read only if it holds an element of the unit in x
            const bool ld0 = ok && col < g.F && col + 7 - s >= 0;
            const bool ld1 = ok && s > 0 && col + 8 - s < g.F && col + 7 >= 0;
#ifndef K5_NO_COPY
            p0[j] = ld0 ? ldg16(a16) : make_uint4(0, 0, 0, 0);
            p1[j] = ld1 ? ldg16(a16 + 16) : make_uint4(0, 0, 0, 0);
#else
            p0[j] = p1[j] = make_uint4(0, 0, 0, 0);
            (void)ld0;
            (void)ld1;
#endif
            const int lo = min(max(-col, 0), 8), hi = ok ? min(max(g.F - col, 0), 8) : 0;
            sh[j] = s | (lo << 4) | (hi << 8);
        };
        // chunk i's origin in x: its first staged row and column, and this
        // lane's channel plane
        auto origin = [&](int i, int& row0, int& col0, uintptr_t& plane) {
            const Tile tl = tile_at(g, blockIdx.x + (i / NCHUNK) * gridDim.x);
            row0 = tl.t0 - g.pt;
            col0 = 2 * tl.f0 - g.pf;
            plane = reinterpret_cast<uintptr_t>(
                x + ((size_t)tl.b * CI + (i % NCHUNK) * CC + c) * g.T * g.F);
        };
        int row0, col0;
        uintptr_t plane;
        origin(0, row0, col0, plane);
#pragma unroll
        for (int j = 0; j < Wn::PER_WARP; ++j) load_chunk_iter(0, row0, col0, plane, j);
#ifdef K5_STAMPS
        unsigned long long t_wait = 0, t_layout = 0;
#endif
        for (int i = 0; i < total; ++i) {
            K5_CLOCK(c0);
            if (i + 1 < total) origin(i + 1, row0, col0, plane);
            const int st = i % NP;
            mbar_wait(&empty[st], ((i / NP) & 1) ^ 1);
            K5_CLOCK(c1);
            const uint32_t base = st0 + st * Wn::STAGE;
#pragma unroll
            for (int j = 0; j < Wn::PER_WARP; ++j) {
                const int it = pw + j * NPW;
                if (it >= Wn::NIT) break;                // the same for the whole warp
                const uint32_t w[8] = {p0[j].x, p0[j].y, p0[j].z, p0[j].w,
                                       p1[j].x, p1[j].y, p1[j].z, p1[j].w};
                const int s = sh[j] & 7, lo = (sh[j] >> 4) & 15, hi = sh[j] >> 8;
                // elements s.. of the two pieces: by 4, 2, then 1 element
                uint32_t a[6], bw[5], r[4];
#pragma unroll
                for (int k = 0; k < 6; ++k) a[k] = s & 4 ? w[k + 2] : w[k];
#pragma unroll
                for (int k = 0; k < 5; ++k) bw[k] = s & 2 ? a[k + 1] : a[k];
#pragma unroll
                for (int k = 0; k < 4; ++k) r[k] = __funnelshift_r(bw[k], bw[k + 1], (s & 1) * 16);
                if (lo != 0 || hi != 8) {                // zeros outside x
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const uint32_t m = (2 * k >= lo && 2 * k < hi ? 0xFFFFu : 0u)
                                           | (2 * k + 1 >= lo && 2 * k + 1 < hi ? 0xFFFF0000u : 0u);
                        r[k] &= m;
                    }
                }
                // matrix mm's row rr: unit q' = rr / 2 of this iteration, its
                // input column 2 mm + rr % 2, at that column's slot
                const int u = 4 * it + (rr >> 1);
                const int sr = u / G, cg = u - (u / G) * G;
                const int col = 8 * cg + 2 * mm + (rr & 1);
                stmatrix_x4_trans(base + (uint32_t)(sr * RS + slot(col)) * 16, r);
                load_chunk_iter(i + 1, row0, col0, plane, j);
            }
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(&full[st]);
            K5_CLOCK(c2);
            K5_ADD(t_wait, c0, c1);
            K5_ADD(t_layout, c1, c2);
        }
#ifdef K5_STAMPS
        if (pw == 0 && lane == 0) {
            atomicAdd(&k5_stamps[0], t_wait);
            atomicAdd(&k5_stamps[1], t_layout);
            atomicAdd(&k5_stamps[3], (unsigned long long)total);
        }
#endif
        return;
    }

    // -------------------------------------------------------------- consumers
    // warpgroup u, tile v: rows 8 (2u + v / 2).. of the tile, columns 8 (v % 2)..
    const int warp = tid >> 5;
    const int u = warp >> 2, wq = warp & 3;
    const int gq = lane >> 2, qq = lane & 3;
    const uint32_t w16 = smem_u32(wsm) >> 4;
    const uint32_t s16 = smem_u32(stages) >> 4;
    uint32_t a_tile[NT];
#pragma unroll
    for (int v = 0; v < NT; ++v) a_tile[v] = 8 * (2 * u + v / 2) * RS + 8 * (v % 2);
    float acc[NT][16];
#pragma unroll
    for (int v = 0; v < NT; ++v)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[v][i] = 0.f;
    // the bias of the thread's 8 output channels (8 (jj >> 1) + 2qq + (jj & 1))
    const bool has_bias = bias != nullptr;
    float bias_f[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
        bias_f[jj] = has_bias
                         ? __bfloat162float(__ushort_as_bfloat16(bias[8 * (jj >> 1) + 2 * qq + (jj & 1)]))
                         : 0.f;
    mbar_wait(wbar, 0);
    // the staged output tile's rows go out a quarter a chunk, behind the next
    // tile's products: half-warp h writes rows 2h and 2h + 1 of the tile
    // staged last, one column a lane
    const int h = tid >> 4, lc = tid & 15;
    Tile staged{0, 0, 0};
    uint16_t* dst = y;          // channel 0 of the staged tile at this lane's first row
    bool st_one = false, st_two = false;
    const size_t oplane = (size_t)g.To * g.Fo;
    // channels [o0, o0 + 8): their 16 values read first, then written
    auto store_share = [&](int o0) {
        const uint16_t* src = otile + (2 * h * FT + lc) * OCS + o0;
        uint32_t v[CO / NCHUNK];
#pragma unroll
        for (int o = 0; o < CO / NCHUNK; ++o) v[o] = src[o] | ((uint32_t)src[o + FT * OCS] << 16);
        uint16_t* d = dst + o0 * oplane;
#pragma unroll
        for (int o = 0; o < CO / NCHUNK; ++o, d += oplane) {
            if (st_one) d[0] = (uint16_t)v[o];
            if (st_two) d[g.Fo] = (uint16_t)(v[o] >> 16);
        }
    };
#ifdef K5_STAMPS
    unsigned long long t_full = 0, t_mma = 0, t_store = 0, t_drain = 0, t_epi = 0;
    K5_CLOCK(k_start);
#endif
    for (int k = 0, i = 0; k < my_tiles; ++k) {
        for (int chunk = 0; chunk < NCHUNK; ++chunk, ++i) {
            const int st = i % NP;
            K5_CLOCK(d0);
            mbar_wait(&full[st], (i / NP) & 1);
            K5_CLOCK(d1);
            const uint32_t stage16 = s16 + st * (Wn::STAGE / 16);
            const uint32_t a16[NT] = {stage16 + a_tile[0], stage16 + a_tile[1],
                                      stage16 + a_tile[2], stage16 + a_tile[3]};
            wgmma_fence();
#ifndef K5_NO_MMA
            mma_step<DT, 0>(acc, a16, w16 + chunk * (CHUNK_W / 16), chunk == 0);
#endif
            wgmma_commit();
            K5_CLOCK(d2);
            if (k > 0)   // the previous tile's share of rows, while the tensor cores work
                store_share(CO / NCHUNK * chunk);
            K5_CLOCK(d3);
            // one group in flight: the previous chunk's is done, its stage free
            wgmma_wait<1>();
            __syncwarp();
            if (chunk > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % NP]);
            K5_CLOCK(d4);
            K5_ADD(t_full, d0, d1);
            K5_ADD(t_mma, d1, d2);
            K5_ADD(t_store, d2, d3);
            K5_ADD(t_drain, d3, d4);
        }
        K5_CLOCK(e0);
        wgmma_wait<0>();
#pragma unroll
        for (int v = 0; v < NT; ++v)
#pragma unroll
            for (int j = 0; j < 16; ++j) keep(acc[v][j]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % NP]);

        // epilogue: accumulator j of tile v is output channel 8 (j >> 2) +
        // 2qq + (j & 1), row 8 (2u + v / 2) + 2wq + ((j >> 1) & 1) of the
        // tile, column 8 (v % 2) + gq; the channel pair (j, j + 1) is one
        // 32-bit store
        consumer_sync();                     // the previous tile's rows are out
        uint16_t* mine = otile + ((16 * u + 2 * wq) * FT + gq) * OCS + 2 * qq;
#pragma unroll
        for (int v = 0; v < NT; ++v)
#pragma unroll
            for (int j = 0; j < 16; j += 2) {
                *reinterpret_cast<__nv_bfloat162*>(
                    mine + ((8 * (v / 2) + ((j >> 1) & 1)) * FT + 8 * (v % 2)) * OCS
                    + 8 * (j >> 2)) = bf16x2_out(acc[v][j], acc[v][j + 1], bias_f[2 * (j >> 2)],
                                                 bias_f[2 * (j >> 2) + 1], has_bias);
            }
        consumer_sync();
        staged = tile_at(g, blockIdx.x + k * gridDim.x);
        {
            const int f = staged.f0 + lc, t = staged.t0 + 2 * h;
            st_one = f < g.Fo && t < g.To;
            st_two = st_one && t + 1 < g.To;
            dst = y + ((size_t)staged.b * CO * g.To + t) * g.Fo + f;
        }
        K5_CLOCK(e1);
        K5_ADD(t_epi, e0, e1);
    }
#pragma unroll 1
    for (int o0 = 0; o0 < CO; o0 += CO / NCHUNK) store_share(o0);
#ifdef K5_STAMPS
    K5_CLOCK(k_end);
    if (tid == 0) {
        atomicAdd(&k5_stamps[4], t_full);
        atomicAdd(&k5_stamps[5], t_mma);
        atomicAdd(&k5_stamps[6], t_store);
        atomicAdd(&k5_stamps[7], t_drain);
        atomicAdd(&k5_stamps[8], t_epi);
        atomicAdd(&k5_stamps[9], (unsigned long long)(k_end - k_start));
        atomicAdd(&k5_stamps[10], (unsigned long long)my_tiles);
        atomicAdd(&k5_stamps[11], 1ull);
    }
#endif
}

// The B images (ops/disc_im2col_kernel.py `pack_weight_bf16` is its plain
// version; the bits are the same): out [NCHUNK][NSTEP][BIMG] bf16; element
// (co, k) of k-step s of chunk c sits at (co / 8) * 128 + (k / 8) * 64 +
// (co % 8) * 8 + k % 8 (core matrices of 8 channels x 8 k, the two
// K-adjacent ones 128 bytes apart, the N-adjacent ones 256) and is w[co, 8c
// + k % 8, mt, mf] at tap_at(2s + k / 8) = (mt, mf), zero at the padding tap.
// One thread an element; bf16 in, no rounding.
__global__ void pack_weight_bf16_kernel(const uint16_t* __restrict__ w,
                                        uint16_t* __restrict__ out) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= NCHUNK * NSTEP * BIMG) return;
    const int e = idx % BIMG, s = (idx / BIMG) % NSTEP, c = idx / (BIMG * NSTEP);
    const int co = (e / 128) * 8 + (e / 8) % 8;
    const int ci = c * CC + e % 8;
    const int t = tap_at(2 * s + (e / 64) % 2);
    out[idx] = t < 0 ? 0 : w[((co * CI + ci) * KT + (t >> 4)) * KF + (t & 15)];
}

// The device's SM count, with the shared-memory limit of every
// instantiation raised, once per device.
template <int DT>
cudaError_t raise_limit() {
    cudaError_t err = cudaFuncSetAttribute(disc_im2col_bf16_kernel<DT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes<DT>());
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(disc_im2col_bf16_kernel<DT>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

cudaError_t prepare_device(int* sms_out) {
    static std::atomic<int> sms[MAX_DEVICES];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int n = sms[device].load(std::memory_order_relaxed);
    if (n == 0) {
        int limit = 0;
        err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        if ((size_t)limit < smem_bytes<4>()) return cudaErrorInvalidValue;
        if ((err = raise_limit<1>()) != cudaSuccess || (err = raise_limit<2>()) != cudaSuccess
            || (err = raise_limit<4>()) != cudaSuccess)
            return err;
        sms[device].store(n, std::memory_order_relaxed);
    }
    *sms_out = n;
    return cudaSuccess;
}

template <int DT>
cudaError_t launch(const Geo& g, int sms, cudaStream_t stream, const uint16_t* x,
                   const uint16_t* wk, const uint16_t* bias, uint16_t* y) {
    const int grid = g.tiles < sms ? g.tiles : sms;
    disc_im2col_bf16_kernel<DT><<<grid, THREADS, smem_bytes<DT>(), stream>>>(x, wk, bias, y, g);
    return cudaGetLastError();
}

}  // namespace

#ifdef K5_STAMPS
// the stamps summed over CTAs since the last call (then set to 0): 0-1 the
// cycles of producer warp 0 waiting for a free stage and laying out (the
// next chunk's loads issued between), 3 chunks; 4-8 the cycles of consumer
// thread 0 waiting for a laid-out stage, issuing the wgmmas, storing the
// previous tile's share of rows, waiting for the group before, and in the
// epilogue; 9 the cycles of the CTAs' loops, 10 tiles, 11 CTAs
extern "C" int encodec_k5_stamps(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, k5_stamps, sizeof(k5_stamps));
    const unsigned long long zero[16] = {};
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(k5_stamps, zero, sizeof(zero));
    return (int)err;
}
#endif

// Forward in bf16. x [B, Cin, T, F] bf16 (as bits); wk the B images as
// encodec_disc_im2col_pack_bf16 writes them; bias [Cout] or null; y [B,
// Cout, To, Fo] with To = T + 2*pt - 2*dt and Fo = (F + 2*pf - 9) / 2 + 1.
// Built for Cin = Cout = 32, 3x9 taps and dt 1, 2 or 4 only; anything else
// returns cudaErrorInvalidValue. Returns a CUDA error code (0 = launched).
extern "C" int encodec_disc_im2col_fwd_bf16(const uint16_t* x, const uint16_t* wk,
                                            const uint16_t* bias, uint16_t* y, int B, int Cin,
                                            int Cout, int T, int F, int kt, int kf, int dt,
                                            int pt, int pf, void* stream) {
    if (Cin != CI || Cout != CO || kt != KT || kf != KF || (dt != 1 && dt != 2 && dt != 4)
        || pt < 0 || pf < 0)
        return cudaErrorInvalidValue;
    const int To = T + 2 * pt - (KT - 1) * dt;
    if (B <= 0 || To <= 0 || F + 2 * pf < KF) return cudaSuccess;
    Geo g{};
    g.T = T;
    g.F = F;
    g.To = To;
    g.Fo = (F + 2 * pf - KF) / 2 + 1;
    g.pt = pt;
    g.pf = pf;
    g.n_tb = (To + ROWS - 1) / ROWS;
    g.n_cb = (g.Fo + FT - 1) / FT;
    const long long tiles = (long long)B * g.n_tb * g.n_cb;
    if (tiles > (1LL << 30)) return cudaErrorInvalidValue;
    g.tiles = (int)tiles;
    int sms = 0;
    const cudaError_t err = prepare_device(&sms);
    if (err != cudaSuccess) return err;
    auto s = static_cast<cudaStream_t>(stream);
    return dt == 1 ? launch<1>(g, sms, s, x, wk, bias, y)
           : dt == 2 ? launch<2>(g, sms, s, x, wk, bias, y)
                     : launch<4>(g, sms, s, x, wk, bias, y);
}

// The bf16 B images from w [32, 32, 3, 9] bf16; out holds NCHUNK * NSTEP *
// BIMG = 28672 bf16. Returns a CUDA error code (0 = launched).
extern "C" int encodec_disc_im2col_pack_bf16(const uint16_t* w, uint16_t* out, void* stream) {
    const int total = NCHUNK * NSTEP * BIMG, threads = 256;
    pack_weight_bf16_kernel<<<(total + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(w, out);
    return cudaGetLastError();
}
