// Discriminator im2col conv, forward (kernel K5) for Hopper: f32 in and out,
// the products on the tensor cores in 3xTF32 by warpgroup MMA (wgmma). The
// bf16 form is csrc/disc_im2col_bf16.cu.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_conv2d.py `_kernel` (reached
// through `conv2d_im2col`). It computes the forward of the MS-STFT
// discriminator's 32 -> 32, 3x9, F-stride-2 convs (conv_1..conv_3 of each
// scale), NCHW with H = STFT frames (time) and W = frequency bins, time
// stride 1, time dilation dt, zero padding (pt, pf):
//
//     y[b, co, t, f] = bias[co] + sum_{ci, mt, mf} W[co, ci, mt, mf] * x[b, ci, t + mt*dt - pt, 2f + mf - pf]
//
// the TPU kernel's GEMM W[32, 864] @ X[864, N] (K = 32 channels x 27 taps,
// N = output positions), as an implicit GEMM: no im2col matrix in device
// memory.
//
// What bounds it on this card: operations. The 9 such convs of one
// discriminator call at the 48 kHz training config (B 32, 48000 stereo
// samples) are 439.4 GFLOP: 6.56 ms at the f32 CUDA-core peak (67 TFLOP/s),
// 2.66 ms as three TF32 products at the tensor cores' 495 TFLOP/s. The bytes
// (x read once, y written once) take at most a third of the latter per conv,
// so the design has to keep the tensor cores fed while reading x about once.
//
// Numerics, 3xTF32 (the rule K4, csrc/disc_conv.cu, follows): each operand is
// split as hi = rna_tf32(v), lo = rna_tf32(v - hi), with rna_tf32 the
// rounding of cvt.rna.tf32.f32 (to 10 mantissa bits, to nearest, ties away
// from zero), and each term is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed in
// f32. No single-pass TF32 product. As in K4, a k-step's three products are
// summed from zero (wgmma's scale-d 0 on the first) into a partial sum of
// their own, which a rounding f32 add puts into the tile's running sum: the
// tensor cores add products to an accumulator with the bits below the
// largest term's precision dropped, a bias toward zero, and summed onto the
// running sum that bias grew with it (outputs 2.2e-6 to 5.9e-6 from float64
// by relative norm at the 48 kHz call's 9 convs, every one shrunk; summed
// from zero 7.7e-8 to 2.0e-7, under cuDNN's 1.8e-7 to 5.0e-7, for 35 % more
// time; scripts/probe_torch_disc_conv_accuracy.py on an NVIDIA H100 80GB
// HBM3, 700 W).
//
// Design:
// - M = output positions, N = all 32 output channels, K = 864 in chunks of
//   CC = 4 input channels (8 chunks); a k-step of 8 is the chunk's 4
//   channels at two taps (k 0-3 tap 2s, k 4-7 tap 2s+1), 14 k-steps a chunk
//   (the 28th tap has zero weights).
// - A block of 2 warpgroups (256 threads) owns TT = 16 output rows x FT = 32
//   output columns; warpgroup g owns rows 8g..8g+7 as four m64 tiles (one a
//   group of 8 columns); within a tile, warp w holds rows 2w and 2w+1 of the
//   8, as the 16 rows of wgmma's per-warp A fragment (row r < 8 = column r
//   of the first row, r >= 8 the same column of the second). The last
//   column of blocks is a second launch of the kernel built for as many
//   tiles as it has columns (one at Fo = 2^k + 1), so the ragged tail costs
//   one 8-column tile, not a 32-column one; rows past To are computed and
//   not stored. No wgmma sits under a branch: ptxas serializes every wgmma
//   of a kernel that issues one conditionally.
// - Products: wgmma.mma_async m64n32k8 .tf32, A (positions x k) from
//   registers, gathered from the staged window, and B (k x 32 channels) from
//   shared memory, K-major without swizzle, three wgmmas a tile and k-step.
//   Each tile's three are one commit group, and the groups alternate between
//   two sets of A registers and two partial sums: before a set is written,
//   wgmma.wait_group 1 retires the group before last, which read it, and
//   that group's partial sum goes into its tile's running sum, so a
//   warpgroup gathers and splits the next tile's operand while its last
//   group runs. The two partial sums cost spills at four tiles (~600 bytes
//   a thread at two blocks an SM); one block an SM, without spills, was
//   slower.
// - A is split in registers right after its gather, by integer operations
//   that give cvt.rna.tf32's bits (add half of the 13 dropped bits, then
//   clear them), not by cvt, whose issue rate is a quarter of the integer
//   units'. Splitting the staged window once a chunk in shared memory
//   instead (~10x fewer splits) was slower, both as a pass between two
//   barriers (it stalls the block; the gathers read twice the bytes; two
//   blocks an SM fit only with one weight buffer) and by a producer
//   warpgroup beside two consumer warpgroups (one block an SM: its stage,
//   wait and split a chunk starved them).
// - The weights are split once a call (pack_weight_kernel, cvt.rna) into
//   each k-step's B image, hi then lo, 1 KB each: a chunk's 14 k-steps are
//   28 KB, contiguous and 16-byte aligned, copied by one TMA bulk copy
//   completing on an mbarrier, into one of two buffers.
// - The input window of a chunk (TT + 2dt rows x 4 channels x the 71
//   columns that 4 tiles read, 23 for the one tile of a 2^k + 1 tail) comes
//   by 4-byte cp.async with zero fill (rows of 2^k + 1 floats are not
//   16-byte aligned, nor describable by TMA), into the other of two buffers
//   while the current chunk is computed on: one barrier a chunk. At stride
//   2 a staged row keeps even columns first, then odd, so neighbouring
//   positions' taps are neighbouring words, and the channel stride is 8 mod
//   32 words: a warp's gather (8 positions x 4 channels) hits 32 banks.
// - Shared memory: 56 KB of weights and 42-56 KB of window at dt 1-4, so
//   two blocks (16 warps) share an SM and one block's barrier and staging
//   overlap the other's products. No atomics and no split K: the same input
//   gives the same bits on every call.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int CI = 32;                     // input channels
constexpr int CO = 32;                     // output channels (all, a block)
constexpr int KT = 3, KF = 9;              // taps along T and F
constexpr int TAPS = KT * KF;
constexpr int NWG = 2;                     // warpgroups a block
constexpr int THREADS = NWG * 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TT = 8 * NWG;                // output rows a block
constexpr int FT = 32;                     // output columns a block
constexpr int NTILE = FT / 8;              // m64 tiles a warpgroup
constexpr int CC = 4;                      // input channels a chunk
constexpr int NCHUNK = CI / CC;
constexpr int NSTEP = (TAPS + 1) / 2;      // k-steps a chunk
constexpr int W = 2 * (FT - 1) + KF;       // window columns
constexpr int HALF = (W + 1) / 2;          // even columns first, then odd
constexpr int RS = 2 * HALF;               // words a staged row
constexpr int BIMG = 256;                  // floats of one B image (32 channels x 8 k)
constexpr int WCHUNK = NSTEP * 2 * BIMG;   // floats of a chunk's weights (hi, lo a k-step)
constexpr int MAX_DT = 16;
constexpr int MAX_DEVICES = 64;
// B in wgmma's K-major layout without swizzle: core matrices of 8 channels x
// 4 k (16 bytes a channel); the two K-adjacent ones 128 bytes apart (the
// descriptor's leading byte offset), the four N-adjacent ones 256 bytes
// apart (its stride byte offset)
constexpr int B_KSTRIDE = 128, B_NSTRIDE = 256;

// Words from one staged channel to the next: at least R rows, and 8 mod 32.
__host__ __device__ inline int chan_stride(int R) {
    const int cs = R * RS;
    return cs + (40 - cs % 32) % 32;
}

// two weight buffers, two window buffers, then the two mbarriers
size_t smem_bytes(int dt) {
    return sizeof(float) * (2 * (size_t)WCHUNK + 2 * (size_t)CC * chan_stride(TT + (KT - 1) * dt))
           + 2 * sizeof(unsigned long long);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32's bits by integer operations (finite v)
__device__ __forceinline__ uint32_t rna_tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t cvt_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// pin an accumulator's register at this point (no reads of it may move above
// the wgmma.wait_group before)
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

// the descriptor of a B image at `p` (16-byte aligned shared memory)
__device__ __forceinline__ uint64_t b_desc(const float* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(B_KSTRIDE >> 4) << 16)
           | ((uint64_t)(B_NSTRIDE >> 4) << 32);
}

// d[64 x 32] = SCALE_D * d + a[64 x 8] * b[8 x 32], TF32 operands, f32
// accumulators (SCALE_D 0 or 1); a from registers (lane 4g + q of warp w:
// rows 16w + g and 16w + g + 8, k q and q + 4)
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(SCALE_D));
}

// staged column of window column j: even columns first, then odd
__host__ __device__ constexpr int col_slot(int j) { return (j >> 1) + (j & 1) * HALF; }

// NT = the tiles of 8 columns a block computes: 4, or fewer in the last
// column of blocks (launched apart, so that no wgmma is issued under a branch:
// ptxas serializes every wgmma of a function that has one)
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
disc_im2col_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int T, int F, int To, int Fo, int dt, int pt, int pf, int f_base) {
    extern __shared__ __align__(128) float smem[];
    const int R = TT + (KT - 1) * dt;           // staged rows
    const int CS = chan_stride(R);
    float* wbuf = smem;                         // [2][WCHUNK] weights
    float* win = smem + 2 * WCHUNK;             // [2][CC][CS] input window
    // CS is even, so the barriers are 8-byte aligned
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(win + 2 * CC * CS);

    const int b = blockIdx.z;
    const int t0 = blockIdx.y * TT;
    const int f0 = f_base + blockIdx.x * FT;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wg = warp >> 2;
    const int g = lane >> 2, q = lane & 3;
    const float* xb = x + (size_t)b * CI * T * F;
    const int row0 = t0 - pt, col0 = 2 * f0 - pf;

    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        mbar_fence_init();
    }
    __syncthreads();

    // chunk k's weights (one bulk copy by thread 0) and window (every thread)
    // into buffer k & 1
    auto stage = [&](int k) {
        const int buf = k & 1;
        if (tid == 0) {
            mbar_expect(&bars[buf], WCHUNK * sizeof(float));
            bulk_copy(wbuf + buf * WCHUNK, wk + (size_t)k * WCHUNK, WCHUNK * sizeof(float),
                      &bars[buf]);
        }
        float* xs = win + buf * CC * CS;
        constexpr int WN = 2 * (8 * NT - 1) + KF;   // the columns NT tiles read
        for (int c = 0; c < CC; ++c) {
            const float* plane = xb + (size_t)(k * CC + c) * T * F;
            for (int r = warp; r < R; r += NWARPS) {
                const int row = row0 + r;
                const bool row_ok = row >= 0 && row < T;
                const float* src = row_ok ? plane + (size_t)row * F : x;
                float* dst = xs + c * CS + r * RS;
#pragma unroll
                for (int j = lane; j < WN; j += 32) {
                    const int col = col0 + j;
                    const bool ok = row_ok && col >= 0 && col < F;
                    cp_async4(dst + col_slot(j), ok ? src + col : x, ok);
                }
            }
        }
    };

    float acc[NT][16];
    float part[2][16] = {};        // two groups' partial sums in flight
    uint32_t ah[2][4], al[2][4];   // two groups' A operand in flight, hi and lo
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[j][i] = 0.f;
    int mt_off[KT];
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) mt_off[mt] = mt * dt * RS;
    // this thread's A rows: column g of the warp's first row, in the first tile
    const int abase = q * CS + (8 * wg + 2 * (warp & 3)) * RS + g;

    stage(0);
    cp_async_commit();
    for (int k = 0; k < NCHUNK; ++k) {
        cp_async_wait_all();
        __syncthreads();   // chunk k is in; every warpgroup is done with buffer (k+1) & 1
        if (k + 1 < NCHUNK) stage(k + 1);
        cp_async_commit();
        mbar_wait(&bars[k & 1], (k >> 1) & 1);
        const float* xw = win + (k & 1) * CC * CS + abase;
        const uint64_t dbase = b_desc(wbuf + (k & 1) * WCHUNK);
#pragma unroll
        for (int s = 0; s < NSTEP; ++s) {
            const int tap0 = 2 * s, tap1 = 2 * s + 1;
            const bool has1 = tap1 < TAPS;              // constant once unrolled
            const int off0 = mt_off[tap0 / KF] + col_slot(tap0 % KF);
            const int off1 = has1 ? mt_off[tap1 / KF] + col_slot(tap1 % KF) : 0;
            // descriptors count 16-byte units: a B image is 64 of them
            const uint64_t d_hi = dbase + (uint64_t)(2 * s) * (BIMG * 4 / 16);
            const uint64_t d_lo = d_hi + BIMG * 4 / 16;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const float* xf = xw + 8 * j;
                float v[4] = {xf[off0], xf[off0 + RS], 0.f, 0.f};
                if (has1) {
                    v[2] = xf[off1];
                    v[3] = xf[off1 + RS];
                }
                // groups alternate between the two register sets; the group
                // before last, which read this one, is done: its partial sum
                // goes into its tile's running sum
                const int n = s * NT + j;                   // constant once unrolled
                wgmma_wait<1>();
                if (n >= 2) {
#pragma unroll
                    for (int i = 0; i < 16; ++i) acc[(n - 2) % NT][i] += part[n & 1][i];
                }
                uint32_t (&h)[4] = ah[n & 1];
                uint32_t (&l)[4] = al[n & 1];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    h[i] = rna_tf32(v[i]);
                    l[i] = rna_tf32(v[i] - __uint_as_float(h[i]));
                }
                wgmma_fence();
                wgmma_tf32<0>(part[n & 1], l, d_hi);
                wgmma_tf32<1>(part[n & 1], h, d_lo);
                wgmma_tf32<1>(part[n & 1], h, d_hi);
                wgmma_commit();
            }
        }
        wgmma_wait<0>();
        constexpr int last = NSTEP * NT - 1;   // the chunk's last two groups
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            acc[(last - 1) % NT][i] += part[(last - 1) & 1][i];
            acc[last % NT][i] += part[last & 1][i];
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) keep(acc[j][i]);

    // accumulator i of tile j: row g + 8 * ((i >> 1) & 1) (the warp's first or
    // second output row), channel 8 * (i >> 2) + 2q + (i & 1), column 8j + g
    const int t_first = t0 + 8 * wg + 2 * (warp & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int f = f0 + 8 * j + g;
        if (f >= Fo) continue;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int t = t_first + ((i >> 1) & 1);
            const int co = 8 * (i >> 2) + 2 * q + (i & 1);
            if (t >= To) continue;
            const float bv = bias ? bias[co] : 0.f;
            y[(((size_t)b * CO + co) * To + t) * Fo + f] = acc[j][i] + bv;
        }
    }
}

// The weights' B images (ops/disc_im2col_kernel.py `pack_weight` is its plain
// version; the bits are the same): out [NCHUNK][NSTEP][2][BIMG], part 0 hi and
// 1 lo; element (co, k) of k-step s of chunk c sits at (co / 8) * 64 +
// (k / 4) * 32 + (co % 8) * 4 + k % 4 and is w[co, 4c + k % 4, tap / 9, tap % 9]
// with tap = 2s + k / 4 (zero at tap 27). One thread an element.
__global__ void pack_weight_kernel(const float* __restrict__ w, float* __restrict__ out) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= NCHUNK * NSTEP * BIMG) return;
    const int e = idx % BIMG, s = (idx / BIMG) % NSTEP, c = idx / (BIMG * NSTEP);
    const int co = (e / 64) * 8 + (e / 4) % 8;
    const int ci = c * CC + e % 4;
    const int tap = 2 * s + (e / 32) % 2;
    const float v = tap < TAPS ? w[((co * CI + ci) * KT + tap / KF) * KF + tap % KF] : 0.f;
    const uint32_t hi = cvt_tf32(v);
    const uint32_t lo = cvt_tf32(v - __uint_as_float(hi));
    float* dst = out + ((size_t)(c * NSTEP + s) * 2) * BIMG + e;
    dst[0] = __uint_as_float(hi);
    dst[BIMG] = __uint_as_float(lo);
}

cudaError_t raise_smem_limit(const void* kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

template <int NT>
cudaError_t raise_smem_limits(int bytes) {
    return raise_smem_limit(reinterpret_cast<const void*>(disc_im2col_kernel<NT>), bytes);
}

// The current device's opt-in shared-memory limit, with every instantiation's
// limit raised to it, once per device.
cudaError_t prepare_device(int* limit_out) {
    static std::atomic<int> limit[MAX_DEVICES];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int v = limit[device].load(std::memory_order_relaxed);
    if (v == 0) {
        err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err == cudaSuccess) err = raise_smem_limits<1>(v);
        if (err == cudaSuccess) err = raise_smem_limits<2>(v);
        if (err == cudaSuccess) err = raise_smem_limits<3>(v);
        if (err == cudaSuccess) err = raise_smem_limits<4>(v);
        if (err != cudaSuccess) return err;
        limit[device].store(v, std::memory_order_relaxed);
    }
    *limit_out = v;
    return cudaSuccess;
}

// One column of blocks (or all the full ones) from output column f_base on.
cudaError_t launch(int nt, dim3 grid, size_t smem, cudaStream_t stream, const float* x,
                   const float* wk, const float* bias, float* y, int Tn, int F, int To, int Fo,
                   int dt, int pt, int pf, int f_base) {
    auto kernel = nt == 1 ? disc_im2col_kernel<1>
                  : nt == 2 ? disc_im2col_kernel<2>
                  : nt == 3 ? disc_im2col_kernel<3> : disc_im2col_kernel<4>;
    kernel<<<grid, THREADS, smem, stream>>>(x, wk, bias, y, Tn, F, To, Fo, dt, pt, pf, f_base);
    return cudaGetLastError();
}

int forward(const float* x, const float* wk, const float* bias, float* y, int B, int Cin,
            int Cout, int Tn, int F, int kt, int kf, int dt, int pt, int pf, void* stream) {
    if (Cin != CI || Cout != CO || kt != KT || kf != KF || dt < 1 || dt > MAX_DT || pt < 0 ||
        pf < 0)
        return cudaErrorInvalidValue;
    const int To = Tn + 2 * pt - (KT - 1) * dt;
    if (B <= 0 || To <= 0 || F + 2 * pf < KF) return cudaSuccess;
    const int Fo = (F + 2 * pf - KF) / 2 + 1;
    const size_t smem = smem_bytes(dt);
    int limit = 0;
    const cudaError_t err = prepare_device(&limit);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    const int rows = (To + TT - 1) / TT;
    if (rows > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
    auto s = static_cast<cudaStream_t>(stream);
    // the blocks of 32 full columns, then one column of blocks for the rest
    const int full = Fo / FT, rest = Fo - full * FT;
    cudaError_t e = cudaSuccess;
    if (full > 0)
        e = launch(NTILE, dim3(full, rows, B), smem, s, x, wk, bias, y, Tn, F, To, Fo, dt, pt,
                   pf, 0);
    if (e == cudaSuccess && rest > 0)
        e = launch((rest + 7) / 8, dim3(1, rows, B), smem, s, x, wk, bias, y, Tn, F, To, Fo,
                   dt, pt, pf, full * FT);
    return e;
}

}  // namespace

// Forward. x [B, Cin, T, F]; wk the weights' B images as
// encodec_disc_im2col_pack_f32 writes them; bias [Cout] or null;
// y [B, Cout, To, Fo] with To = T + 2*pt - (KT-1)*dt and
// Fo = (F + 2*pf - KF) / 2 + 1. Built for Cin = Cout = 32 and 3x9 taps only;
// anything else returns cudaErrorInvalidValue. Returns a CUDA error code
// (0 = launched).
extern "C" int encodec_disc_im2col_fwd_f32(const float* x, const float* wk, const float* bias,
                                           float* y, int B, int Cin, int Cout, int T, int F,
                                           int kt, int kf, int dt, int pt, int pf,
                                           void* stream) {
    return forward(x, wk, bias, y, B, Cin, Cout, T, F, kt, kf, dt, pt, pf, stream);
}

// The weights' B images, split into hi and lo, from w [32, 32, 3, 9] (torch's
// layout); out holds NCHUNK * NSTEP * 2 * BIMG = 57344 floats. Returns a CUDA
// error code (0 = launched).
extern "C" int encodec_disc_im2col_pack_f32(const float* w, float* out, void* stream) {
    const int total = NCHUNK * NSTEP * BIMG, threads = 256;
    pack_weight_kernel<<<(total + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, out);
    return cudaGetLastError();
}
