// Discriminator 2-D conv, forward and input gradient (kernel K4) for Hopper,
// on the tensor cores: f32 in and out in 3xTF32.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_conv2d_v2.py `_kernel` (entries
// `conv2d_v2` forward and `conv2d_v2_dx` input gradient, wrapped by the
// custom VJP `conv2d_v2_op`). The class of convs it takes is that of the
// discriminator's conv_1..conv_4: NCHW with H = STFT frames (time) and
// W = frequency bins, time stride 1, time dilation dt, frequency stride sf,
// no frequency dilation, zero padding (pt, pf):
//
//     y[b, co, t, fo] = bias[co] + sum_{ci, mt, kf} x[b, ci, t + mt*dt - pt, fo*sf + kf - pf]
//                                                   * w[co, ci, mt, kf]
//
// and the input gradient of the same conv in gather form (no atomics, so
// every run gives the same bits):
//
//     dx[b, ci, t, f] = sum_{co, mt, kf : (f + pf - kf) % sf == 0}
//                       g[b, co, t + pt - mt*dt, (f + pf - kf) / sf] * w[co, ci, mt, kf]
//
// Both are one correlation kernel. Write f + pf = q*sf + r (phase r); the
// valid taps are kf = r + sf*j, so for a fixed phase dx is a stride-1
// correlation of g along F with NJ = ceil(KF / sf) taps and, along T, with
// the taps reversed. The kernel computes
//
//     out[b, o, t, p*OS + ooff] = sum_{c, mt, j} in[b, c, t + t_off + mt*dt, p*S + col_off + j]
//                                 * wk[phase][c][mt][j][o]
//
// with (S, OS) = (sf, 1) forward and (1, sf) for dx. Rows and columns that
// fall outside `in` read as zeros: that is the padding.
//
// What bounds it on this card: operations. The 12 convs of one 24 kHz disc
// call are 261 GFLOP: 3.90 ms at the f32 CUDA-core peak (67 TFLOP/s), 1.58 ms
// as three TF32 products at the tensor cores' 495 TFLOP/s. The bytes (x read
// once, y written once) take a tenth of that.
//
// Numerics, 3xTF32: every operand is split into a TF32 high part and a TF32
// low part with round-to-nearest (hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v -
// hi), so hi + lo keeps ~22 bits of v), and each term is a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi accumulated in f32 (a_lo*b_lo, below f32's rounding, is left
// out). The result holds the plain f32 conv to ~1e-6 of max|y|: this is not
// the single-pass TF32 that the port keeps off in cuDNN and cuBLAS. The
// weights are split once a call (pack_weight_kernel below); the input is
// split in registers.
//
// Design: an implicit GEMM with warp-level mma.sync.m16n8k8 (TF32 in, f32
// accumulators). M = output positions of one (b, phase), N = output channels,
// K = summed channels x taps.
// - A block of 256 threads owns TT = 16 output rows x FT = 32 output columns
//   (512 positions) and OT = 32 output channels. Warp w owns rows 2w, 2w+1:
//   four m-fragments, each 8 columns x 2 rows (fragment row g is column g of
//   the first row, row g+8 the same column of the second), times four
//   n-fragments of 8 channels: 64 accumulators a thread. Fragments of 8
//   columns keep the ragged tail of F = 2^k + 1 bins cheap: a fragment past
//   the last column is skipped by its warp.
// - K runs in chunks of CC = 4 summed channels. A k-step of 8 is the 4
//   channels at two taps (slots 0-3 tap 2s, slots 4-7 tap 2s+1), so a chunk
//   is ceil(taps / 2) k-steps (14 at 3x9, 5 at 3x3, 8 at 3x5; an odd tap count
//   pads one tap with zero weights).
// - The weights are packed once a call, by a launch of pack_weight_kernel,
//   into fragment order, per chunk [k-step][n-fragment][lane] x (hi b0,
//   hi b1, lo b0, lo b1): one 16-byte shared load a lane gives its B
//   fragments in both parts.
// - The input window of a chunk (each distinct input row once: TT + (KT-1)*dt
//   rows, (FT-1)*S + NJ columns) and the chunk's weights are staged with
//   cp.async into one of two buffers while the other is computed on: one
//   barrier a chunk. Rows and columns come from nested loops (no div/mod),
//   4-byte copies for the window (rows of 2^k + 1 floats are not 16-byte
//   aligned, nor describable by TMA), zero-filled outside `in`, and 16-byte
//   copies for the weights.
// - Shared layout: at S = 2 a staged row keeps even columns first, then odd,
//   so the stride-2 columns of neighbouring fragment rows are neighbouring
//   words; the channel stride is 8 mod 32 words, so the 4 channels x 8
//   columns that a warp's A load reads fall in 32 distinct banks.
// - Only the discriminator's tap counts are built (3x9 at F-stride 2, 3x3 at
//   F-stride 1, 3x5 for dx of the 3x9 convs); others return
//   cudaErrorInvalidValue. `wgmma` is a later step: with N = 32 and a
//   gathered A, its shared-memory operand layout buys little yet.
//
// The bf16 form is a kernel of its own, csrc/disc_conv_bf16.cu.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int TT = 2 * NWARPS;  // output rows a block (2 a warp)
constexpr int FT = 32;          // output columns a block (4 m-fragments of 8)
constexpr int OT = 32;          // output channels a block (4 n-fragments of 8)
constexpr int CC = 4;           // summed channels a chunk
constexpr int MAX_DEVICES = 64;

struct Geometry {
    int B, C, O;             // batch, channels summed over, channels written
    int Tin, Fin;            // rows and columns of `in`
    int Tout, Fout;          // rows and columns of `out`
    int KT, NJ, dt;          // taps along T and F, T dilation
    int t_off, col_off;      // in row = t + t_off + mt*dt; in col = p*S + col_off + j
    int OS;                  // out col = p*OS + ooff[phase]
    int n_phase, o_tiles, n_chunks;
    int p_lo[2], np[2], ooff[2];
};

// Compile-time shape of a tap class.
template <int S, int KT, int NJ>
struct Taps {
    static constexpr int TAPS = KT * NJ;
    static constexpr int NS = (TAPS + 1) / 2;         // k-steps a chunk
    static constexpr int W = (FT - 1) * S + NJ;       // input columns a tile
    static constexpr int HALF = S == 2 ? (W + 1) / 2 : W;
    static constexpr int RS = S == 2 ? 2 * HALF : W;  // row stride in shared memory
    static constexpr int WCH = NS * 4 * 32 * 4;       // weight floats a chunk
};

// Words from one staged channel to the next: at least R rows, and 8 mod 32,
// so that the 4 channels of a k-step land in distinct banks.
__host__ __device__ inline int chan_stride(int R, int RS) {
    const int cs = R * RS;
    return cs + (40 - cs % 32) % 32;
}

template <int S, int KT, int NJ>
size_t smem_bytes(int dt) {
    using P = Taps<S, KT, NJ>;
    const int R = TT + (KT - 1) * dt;
    return 2 * sizeof(float) * ((size_t)P::WCH + (size_t)CC * chan_stride(R, P::RS));
}

// Where staged column `col` of a row lives (S = 2: even columns, then odd).
template <int S, int HALF>
__device__ __forceinline__ int xs_col(int col) {
    return S == 2 ? ((col & 1) ? HALF + (col >> 1) : (col >> 1)) : col;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// d += a * b for one m16n8k8 fragment, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k8 (lane = 4*g + q): A a0 (row g, k q), a1 (row
// g+8, k q), a2 (row g, k q+4), a3 (row g+8, k q+4); B b0 (k q, col g), b1
// (k q+4, col g); C c0, c1 (row g, cols 2q, 2q+1), c2, c3 (row g+8, the same).
template <int S, int KT, int NJ>
__global__ void __launch_bounds__(THREADS, 2)
disc_conv_kernel(const float* __restrict__ in, const float* __restrict__ wk,
                 const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
    using P = Taps<S, KT, NJ>;
    extern __shared__ __align__(16) float smem[];
    const int R = TT + (KT - 1) * g.dt;          // staged input rows
    const int CS = chan_stride(R, P::RS);
    const int BUF = P::WCH + CC * CS;            // floats a stage buffer

    int z = blockIdx.z;
    const int phase = z % g.n_phase;
    z /= g.n_phase;
    const int ot = z % g.o_tiles;
    const int b = z / g.o_tiles;
    const int t0 = blockIdx.y * TT;
    // per-phase values picked without a dynamic index into `g`, which would
    // put the struct in local memory
    const int p_lo = phase ? g.p_lo[1] : g.p_lo[0];
    const int np = phase ? g.np[1] : g.np[0];
    const int ooff = phase ? g.ooff[1] : g.ooff[0];
    const int pt0 = blockIdx.x * FT;             // tile start within this phase's columns
    if (pt0 >= np) return;                       // the whole block: before any barrier
    const int wbase = (p_lo + pt0) * S + g.col_off;   // `in` column of staged column 0
    const int rbase = t0 + g.t_off;                   // `in` row of staged row 0
    const float* wsrc = wk + (size_t)(phase * g.o_tiles + ot) * g.n_chunks * P::WCH;
    const float* in_b = in + (size_t)b * g.C * g.Tin * g.Fin;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gq = lane >> 2;                    // fragment row / column group
    const int q = lane & 3;                      // k slot (a summed channel)

    auto stage = [&](int k, float* buf) {
        const float* src = wsrc + (size_t)k * P::WCH;
        for (int i = tid; i < P::WCH / 4; i += THREADS) cp_async16(buf + 4 * i, src + 4 * i);
        float* xs = buf + P::WCH;
        for (int c = 0; c < CC; ++c) {
            const int ch = k * CC + c;
            for (int r = warp; r < R; r += NWARPS) {
                const int row = rbase + r;
                const bool row_ok = ch < g.C && row >= 0 && row < g.Tin;
                const float* src_row = row_ok ? in_b + ((size_t)ch * g.Tin + row) * g.Fin : in;
                float* dst = xs + c * CS + r * P::RS;
                for (int col = lane; col < P::W; col += 32) {
                    const int f = wbase + col;
                    const bool ok = row_ok && f >= 0 && f < g.Fin;
                    cp_async4(dst + xs_col<S, P::HALF>(col), ok ? src_row + f : in, ok);
                }
            }
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[f][n][i] = 0.f;

    const int row0 = 2 * warp;                         // the warp's first row in the tile
    const bool live = t0 + row0 < g.Tout;              // warp-uniform
    const int frags = min(4, (np - pt0 + 7) / 8);      // live m-fragments, block-uniform
    int mt_off[KT];
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) mt_off[mt] = mt * g.dt * P::RS;

    stage(0, smem);
    cp_async_commit();
    for (int k = 0; k < g.n_chunks; ++k) {
        cp_async_wait_all();
        __syncthreads();   // chunk k is in; every warp is done with chunk k-1's buffer
        if (k + 1 < g.n_chunks) stage(k + 1, smem + ((k + 1) & 1) * BUF);
        cp_async_commit();
        if (!live) continue;
        const float* buf = smem + (k & 1) * BUF;
        const float4* wf = reinterpret_cast<const float4*>(buf) + lane;
        const float* xw = buf + P::WCH + q * CS + row0 * P::RS + gq;
#pragma unroll
        for (int s = 0; s < P::NS; ++s) {
            const int tap0 = 2 * s, tap1 = 2 * s + 1;
            const bool has1 = tap1 < P::TAPS;            // constant once unrolled
            const int j0 = tap0 % NJ, j1 = tap1 % NJ;
            const int off0 = mt_off[tap0 / NJ] + (S == 2 ? (j0 >> 1) + (j0 & 1) * P::HALF : j0);
            const int off1 = has1 ? mt_off[tap1 / NJ]
                                        + (S == 2 ? (j1 >> 1) + (j1 & 1) * P::HALF : j1)
                                  : 0;
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const float4 v = wf[(s * 4 + n) * 32];
                bh[n][0] = __float_as_uint(v.x);
                bh[n][1] = __float_as_uint(v.y);
                bl[n][0] = __float_as_uint(v.z);
                bl[n][1] = __float_as_uint(v.w);
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                if (f < frags) {
                    const float* xf = xw + f * 8;
                    float a[4];
                    a[0] = xf[off0];
                    a[1] = xf[off0 + P::RS];
                    a[2] = has1 ? xf[off1] : 0.f;
                    a[3] = has1 ? xf[off1 + P::RS] : 0.f;
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        ah[i] = to_tf32(a[i]);
                        al[i] = to_tf32(a[i] - __uint_as_float(ah[i]));
                    }
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        mma_tf32(acc[f][n], al, bh[n][0], bh[n][1]);
                        mma_tf32(acc[f][n], ah, bl[n][0], bl[n][1]);
                        mma_tf32(acc[f][n], ah, bh[n][0], bh[n][1]);
                    }
                }
            }
        }
    }
    if (!live) return;

#pragma unroll
    for (int f = 0; f < 4; ++f) {
        const int p = pt0 + f * 8 + gq;
        if (p >= np) continue;
        const int col = (p_lo + p) * g.OS + ooff;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = t0 + row0 + (i >> 1);
                const int o = ot * OT + n * 8 + 2 * q + (i & 1);
                if (t >= g.Tout || o >= g.O) continue;
                const float bv = bias ? bias[o] : 0.f;
                out[(((size_t)b * g.O + o) * g.Tout + t) * g.Fout + col] = acc[f][n][i] + bv;
            }
        }
    }
}

// The weight operand in fragment order (ops/disc_conv_kernel.py
// `pack_weight` is its plain version; the bits are the same): one thread a
// lane's float4 (hi b0, hi b1, lo b0, lo b1) of output
// [P][ceil(O/32)][ceil(C/4)][steps][4][32][4], read from w [Cout, Cin, KT, KF]
// in torch's layout. Forward (dx = 0): P = 1, C = Cin, O = Cout, NJ = KF and
// tap (mt, j) is w[o, c, mt, j]. Input gradient: P = sf, C = Cout, O = Cin,
// NJ = ceil(KF / sf) and tap (m, j) of phase r is w[c, o, KT-1-m, r +
// sf*(NJ-1-j)], zero past KF.
__global__ void pack_weight_kernel(const float* __restrict__ w, float4* __restrict__ out,
                                   int Cout, int Cin, int KT, int KF, int sf, int dx,
                                   int total) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int C = dx ? Cout : Cin, O = dx ? Cin : Cout;
    const int NJ = dx ? (KF + sf - 1) / sf : KF;
    const int taps = KT * NJ, steps = (taps + 1) / 2;
    const int chunks = (C + CC - 1) / CC, tiles = (O + OT - 1) / OT;
    int rest = idx;
    const int lane = rest % 32; rest /= 32;
    const int n = rest % 4; rest /= 4;
    const int step = rest % steps; rest /= steps;
    const int chunk = rest % chunks; rest /= chunks;
    const int tile = rest % tiles;
    const int phase = rest / tiles;
    const int c = chunk * CC + (lane & 3), o = tile * OT + n * 8 + (lane >> 2);
    float hi[2], lo[2];
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
        const int tap = 2 * step + pair;
        float v = 0.f;
        if (c < C && o < O && tap < taps) {
            const int mt = tap / NJ, j = tap % NJ;
            if (!dx) {
                v = w[(((size_t)o * Cin + c) * KT + mt) * KF + j];
            } else {
                const int kf = phase + sf * (NJ - 1 - j);
                if (kf < KF) v = w[(((size_t)c * Cin + o) * KT + (KT - 1 - mt)) * KF + kf];
            }
        }
        const uint32_t h = to_tf32(v);
        hi[pair] = __uint_as_float(h);
        lo[pair] = __uint_as_float(to_tf32(v - hi[pair]));
    }
    out[idx] = make_float4(hi[0], hi[1], lo[0], lo[1]);
}

// The device's opt-in shared-memory limit, read once per device.
int max_smem_optin(int device) {
    static std::atomic<int> cached[MAX_DEVICES];
    int v = cached[device].load(std::memory_order_relaxed);
    if (v == 0 && cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
                      == cudaSuccess)
        cached[device].store(v, std::memory_order_relaxed);
    return v;
}

// One tap class: the kernel's shared memory raised to the opt-in limit once
// per device and instantiation, then the grid.
template <int S, int KT, int NJ>
cudaError_t launch_taps(const float* in, const float* wk, const float* bias, float* out,
                        const Geometry& g, int device, cudaStream_t stream) {
    const size_t smem = smem_bytes<S, KT, NJ>(g.dt);
    const void* kernel = reinterpret_cast<const void*>(disc_conv_kernel<S, KT, NJ>);
    const int max_smem = max_smem_optin(device);
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    static std::atomic<bool> configured[MAX_DEVICES];
    if (!configured[device].load(std::memory_order_relaxed)) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               max_smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        configured[device].store(true, std::memory_order_relaxed);
    }
    int np_max = g.np[0];
    for (int i = 1; i < g.n_phase; ++i) np_max = g.np[i] > np_max ? g.np[i] : np_max;
    const long long z = (long long)g.B * g.o_tiles * g.n_phase;
    if (z > 65535) return cudaErrorInvalidConfiguration;
    dim3 grid((np_max + FT - 1) / FT, (g.Tout + TT - 1) / TT, (unsigned)z);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    disc_conv_kernel<S, KT, NJ><<<grid, THREADS, smem, stream>>>(in, wk, bias, out, g);
    return cudaGetLastError();
}

// The discriminator's tap counts: 3x9 forward at F-stride 2, 3x3 forward and
// dx at F-stride 1, 3x5 dx of the 3x9 convs. No other is built.
cudaError_t launch(int S, const float* in, const float* wk, const float* bias, float* out,
                   const Geometry& g, int device, cudaStream_t stream) {
    if (S == 2 && g.KT == 3 && g.NJ == 9)
        return launch_taps<2, 3, 9>(in, wk, bias, out, g, device, stream);
    if (S == 1 && g.KT == 3 && g.NJ == 3)
        return launch_taps<1, 3, 3>(in, wk, bias, out, g, device, stream);
    if (S == 1 && g.KT == 3 && g.NJ == 5)
        return launch_taps<1, 3, 5>(in, wk, bias, out, g, device, stream);
    return cudaErrorInvalidValue;
}

int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

cudaError_t use_device(int device) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return err;
}

// The forward as the correlation kernel's geometry, cc summed channels a chunk.
Geometry forward_geometry(int B, int Cin, int Cout, int T, int F, int KT, int KF, int sf, int dt,
                          int pt, int pf, int cc) {
    Geometry g{};
    g.B = B; g.C = Cin; g.O = Cout;
    g.Tin = T; g.Fin = F;
    g.Tout = T + 2 * pt - (KT - 1) * dt;
    g.Fout = (F + 2 * pf - KF) / sf + 1;
    g.KT = KT; g.NJ = KF; g.dt = dt;
    g.t_off = -pt; g.col_off = -pf; g.OS = 1;
    g.n_phase = 1; g.o_tiles = (Cout + OT - 1) / OT; g.n_chunks = (Cin + cc - 1) / cc;
    g.p_lo[0] = 0; g.np[0] = g.Fout; g.ooff[0] = 0;
    return g;
}

// The input gradient as the correlation kernel's geometry: sf phases, each a
// stride-1 correlation of the cotangent.
Geometry input_grad_geometry(int B, int Cin, int Cout, int T, int F, int KT, int KF, int sf,
                             int dt, int pt, int pf, int cc) {
    Geometry g{};
    const int NJ = (KF + sf - 1) / sf;
    g.B = B; g.C = Cout; g.O = Cin;
    g.Tin = T + 2 * pt - (KT - 1) * dt;
    g.Fin = (F + 2 * pf - KF) / sf + 1;
    g.Tout = T; g.Fout = F;
    g.KT = KT; g.NJ = NJ; g.dt = dt;
    g.t_off = pt - (KT - 1) * dt; g.col_off = -(NJ - 1); g.OS = sf;
    g.n_phase = sf; g.o_tiles = (Cin + OT - 1) / OT; g.n_chunks = (Cout + cc - 1) / cc;
    for (int r = 0; r < sf; ++r) {
        // f = q*sf + r - pf must lie in [0, F)
        const int q_lo = -floor_div(r - pf, sf);          // ceil((pf - r) / sf)
        const int q_hi = floor_div(F - 1 + pf - r, sf);
        g.p_lo[r] = q_lo;
        g.np[r] = q_hi >= q_lo ? q_hi - q_lo + 1 : 0;
        g.ooff[r] = r - pf;
    }
    return g;
}

int forward(const float* x, const float* wk, const float* bias, float* y, int B, int Cin,
            int Cout, int T, int F, int KT, int KF, int sf, int dt, int pt, int pf, int device,
            void* stream) {
    if (sf != 1 && sf != 2) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const Geometry g = forward_geometry(B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf, CC);
    if (B <= 0 || g.Tout <= 0 || g.Fout <= 0) return cudaSuccess;
    return launch(sf, x, wk, bias, y, g, device, static_cast<cudaStream_t>(stream));
}

int input_grad(const float* gy, const float* wk, float* dx, int B, int Cin, int Cout, int T,
               int F, int KT, int KF, int sf, int dt, int pt, int pf, int device, void* stream) {
    if (sf != 1 && sf != 2) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const Geometry g = input_grad_geometry(B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf, CC);
    if (B <= 0 || T <= 0 || F <= 0) return cudaSuccess;
    return launch(1, gy, wk, nullptr, dx, g, device, static_cast<cudaStream_t>(stream));
}

int pack(const float* w, float* out, int Cout, int Cin, int KT, int KF, int sf, int dx,
         int device, void* stream) {
    if (sf != 1 && sf != 2) return cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return err;
    const int C = dx ? Cout : Cin, O = dx ? Cin : Cout;
    const int NJ = dx ? (KF + sf - 1) / sf : KF;
    // a float4 a thread, 128 a k-step
    const long long total = (long long)(dx ? sf : 1) * ((O + OT - 1) / OT) * ((C + CC - 1) / CC)
                            * ((KT * NJ + 1) / 2) * 128;
    if (total <= 0) return cudaSuccess;
    if (total > (1LL << 30)) return cudaErrorInvalidValue;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    pack_weight_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        w, reinterpret_cast<float4*>(out), Cout, Cin, KT, KF, sf, dx, (int)total);
    return cudaGetLastError();
}

}  // namespace

// Forward. x [B, Cin, T, F]; wk the weights in fragment order,
// [1][ceil(Cout/32)][ceil(Cin/4)][ceil(KT*KF/2)][4][32][4] (hi, lo), as
// ops/disc_conv_kernel.py `pack_weight` writes them; bias [Cout] or null;
// y [B, Cout, To, Fo] with To = T + 2*pt - (KT-1)*dt and
// Fo = (F + 2*pf - KF) / sf + 1. Returns a CUDA error code (0 = launched).
extern "C" int encodec_disc_conv_fwd_f32(const float* x, const float* wk, const float* bias,
                                         float* y, int B, int Cin, int Cout, int T, int F,
                                         int KT, int KF, int sf, int dt, int pt, int pf,
                                         int device, void* stream) {
    return forward(x, wk, bias, y, B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf, device, stream);
}

// Input gradient. gy [B, Cout, To, Fo] (the output's cotangent); wk the
// per-phase weights in fragment order, [sf][ceil(Cin/32)][ceil(Cout/4)]
// [ceil(KT*NJ/2)][4][32][4] with NJ = ceil(KF / sf), packed from
// w[co, ci, KT-1-m, r + sf*(NJ-1-j)] (0 past KF) for phase r;
// dx [B, Cin, T, F]. Every element of dx is written.
extern "C" int encodec_disc_conv_dx_f32(const float* gy, const float* wk, float* dx, int B,
                                        int Cin, int Cout, int T, int F, int KT, int KF,
                                        int sf, int dt, int pt, int pf, int device,
                                        void* stream) {
    return input_grad(gy, wk, dx, B, Cin, Cout, T, F, KT, KF, sf, dt, pt, pf, device, stream);
}

// The weight operand of the forward (dx = 0) or of the input gradient
// (dx = 1) in fragment order, from w [Cout, Cin, KT, KF] (see
// pack_weight_kernel); out holds P * ceil(O/32) * ceil(C/4) * steps * 512
// floats. Returns a CUDA error code (0 = launched).
extern "C" int encodec_disc_conv_pack_f32(const float* w, float* out, int Cout, int Cin, int KT,
                                          int KF, int sf, int dx, int device, void* stream) {
    return pack(w, out, Cout, Cin, KT, KF, sf, dx, device, stream);
}
