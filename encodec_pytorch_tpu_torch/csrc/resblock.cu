// Fused SEANet residual block (kernel K3) for Hopper, f32.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_resblock.py `_resblock_kernel`
// (wrapper `resblock_pallas`). For x [B, C, T] (torch's NCT layout) and the
// materialised weights in torch's conv layout, k1 [H, C, 3], k2 [C, H],
// ks [C, C], it computes per output column t
//
//     a(p)     = ELU(xpad(p))          xpad: causal 2d left pad, else d each side
//     y1[h, t] = ELU(b1[h] + sum_{c, j} k1[h, c, j] * a(t + j*d))
//     out[c, t] = (b2[c] + sum_h k2[c, h] * y1[h, t]) + (bs[c] + sum_c' ks[c, c'] * x[c', t])
//
// with reflect padding (with the short-input guard of ops/pad.py: zeros are
// appended before reflecting when T <= the pad) or zero padding. A streaming
// caller passes `left` [B, C, 2d]: the previous chunk's last 2d inputs of the
// k3 conv, already activated (the carry of streaming.py `_stream_conv`); they
// replace the left pad and are not activated again. `carry_out` [B, C, 2d],
// when given, receives the last 2d activated inputs of [left, x], the next
// chunk's `left`.
//
// What bounds it on this card: operations. A block costs 6*C^2 FLOP a column
// (3C*H + H*C + C*C multiply-adds at H = C/2) against 8 bytes a column and
// channel moved, so from C = 32 on it sits above the f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP a byte). f32 on CUDA cores (no TF32, no fast math:
// the block is held to its cuDNN sequence at 1e-5 relative). At the mux tick
// (B 16, 32 to 1280 columns) the work is small and the time is how many SMs
// take part and how long each waits for its operands.
//
// Design. A unit of work is one (time tile of N columns, batch row); its
// output rows are split over a thread-block cluster of CL CTAs (CL 2 / 2 / 4
// / 8 at C 32 / 64 / 128 / 256, and 8 for the wider blocks up to C 512), so
// the tick's B 16 grid puts >= 128 CTAs on the card:
// - Weights. A CTA needs only its H/CL rows of k1 and C/CL rows of k2 and ks.
//   They stream through two shared buffers in chunks of KC1 (k1) or KC2 (k2,
//   ks) reduction columns: one TMA tensor copy a chunk (a box of the CTA's
//   rows x the chunk's columns, zeros past the matrix), issued by one thread
//   a chunk ahead and completing on an mbarrier, also across products and
//   units. So no global load is synchronous in a product. Up to C 256 a CTA's
//   shared memory (at most ~108 KB) leaves room for two CTAs an SM; at C 512
//   one CTA (~205 KB) takes an SM.
// - The grid is persistent: as many clusters as fit on the card at once,
//   each looping over units.
// - Input. Each CTA stages the unit's raw tile, xr [C][N] (16-byte cp.async,
//   every chunk in flight at once; the shortcut reads it), activates its own
//   C/CL channels with their halos (ELU by expm1f, as nn.ELU; the halo from
//   `left` is activated already) and stores them into every CTA's
//   as [C][N + 2d] through distributed shared memory; `cluster.sync()`. Each
//   sample is activated once a cluster, and remote stores need no round trip.
// - It computes its H/CL rows of y1 = ELU(K1 * A + b1) and stores them into
//   every CTA's y1 [H][N]; `cluster.sync()`; then its C/CL rows of
//   K2 * y1 + b2 and the shortcut Ks * x + bs, and writes their sum. A CTA
//   writes into a peer only after the barrier that the peer passes once it
//   is done reading what is overwritten (the activations after the last
//   unit's y1 barrier, y1 after the next unit's activation barrier).
// - Each product is register-tiled: a thread owns RH rows x RT columns
//   (columns strided by the column groups, so a warp's lanes read
//   neighbouring words; a warp shares its rows, so the weights' float4 loads
//   along the reduction are broadcasts).
// - Every output sums its terms in one fixed order (taps in k1's own order
//   c*3 + j, then bias; y2 over h and the shortcut over c', then their sum)
//   that does not depend on the tile or the cluster rank: the bits equal the
//   one-block-per-tile kernel this replaces, and a streamed chunk gives the
//   same bits as the offline call.
// - int8 weights (encodec_resblock_i8w, the int8 twin of prepare.py): k1, k2
//   and ks arrive as int8 in the same layouts with an f32 scale a row. The
//   chunks stream as bytes: 8-bit TMA tensor copies where every row of the
//   three matrices is a multiple of 16 bytes (C and H multiples of 16: rows
//   of 3C, H and C bytes; the boxes' 192 / 96 / 48 columns are too), plain
//   loads of the int8 bytes otherwise. A chunk being 4x smaller, the ring
//   has 4 stages (3 chunks in flight) in the shared memory the f32 ring's 2
//   take. When a chunk has landed, the CTA dequantizes it once into one f32
//   buffer, __fmul_rn((float)q, scale[row]) an element (the product torch's
//   and the JAX package's dequantization compute), and the products read
//   that buffer exactly as the f32 kernel reads its chunk: the scale is not
//   factored out of the sums, so the bits are the f32 kernel's on the
//   dequantized weights.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

// Weight chunks in shared memory: f32, one in use and the next in flight;
// int8 (a quarter of the bytes), one in use and three in flight, in the room
// of the f32 ring with the chunk's dequantized f32 copy beside them.
template <typename W>
__host__ __device__ constexpr int stages() { return sizeof(W) == 1 ? 4 : 2; }

template <typename W>
__host__ __device__ constexpr bool is_int8() { return std::is_same<W, int8_t>::value; }

// Elements of a ring buffer of W: the larger chunk, rounded to 128 bytes (a
// TMA destination's alignment)
template <typename W>
__host__ __device__ constexpr int wbuf(int a, int b) {
    constexpr int unit = 128 / sizeof(W);
    return ((a > b ? a : b) + unit - 1) / unit * unit;
}

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// Raw input at logical time q (any integer) under the block's padding.
__device__ __forceinline__ float padded_input(const float* xrow, int q, int T, int reflect,
                                              int maxpad) {
    if (q >= 0 && q < T) return xrow[q];
    if (!reflect) return 0.f;
    // ops/pad.py: when T <= maxpad, zeros are appended until the reflection fits
    const int Tp = T > maxpad ? T : maxpad + 1;
    const int r = q < 0 ? -q : (q >= Tp ? 2 * (Tp - 1) - q : q);
    return (r >= 0 && r < T) ? xrow[r] : 0.f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
    return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// A tile of N columns; a thread owns RT columns (RT * 32 <= N) and RH1 rows
// of y1, RH2 rows of the output; CL CTAs a cluster; weight chunks of KC1
// columns of k1 (a multiple of 12: 4 channels x 3 taps) and KC2 of k2 and ks
// (a multiple of 4). W is the weights' type: float, or int8_t with the row
// scales s1 [H], s2 [C], ss [C].
template <typename W, int N, int RT, int CL, int RH1, int RH2, int KC1, int KC2>
__global__ void __launch_bounds__(THREADS, 2)   // two CTAs an SM: registers <= 128
resblock_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
                const __grid_constant__ CUtensorMap map3, const float* __restrict__ x,
                const float* __restrict__ left,
                const W* __restrict__ k1, const float* __restrict__ s1,
                const float* __restrict__ b1,
                const W* __restrict__ k2, const float* __restrict__ s2,
                const float* __restrict__ b2,
                const W* __restrict__ ks, const float* __restrict__ ss,
                const float* __restrict__ bs,
                float* __restrict__ out, float* __restrict__ carry_out,
                int C, int H, int T, int d, int causal, int reflect, int vec, int units,
                int tiles) {
    constexpr int STAGES = stages<W>();
    constexpr int CGN = N / RT;            // column groups (>= 32: a warp shares its rows)
    constexpr int RGN = THREADS / CGN;     // row groups
    constexpr int P1 = RGN * RH1, P2 = RGN * RH2;   // weight rows held, zeros past H or C
    static_assert(CGN >= 32 && THREADS % CGN == 0, "a warp must share its rows");
    static_assert(KC1 % 12 == 0 && KC2 % 4 == 0, "whole float4s of whole channels");
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x;
    const int cg_ = tid % CGN, rg = tid / CGN;
    const int padL = causal ? 2 * d : d, padR = causal ? 0 : d;
    // a row of `as`: left halo, the tile from a 16-byte boundary, right halo
    const int OFF = (padL + 3) & ~3, LDX = OFF + N + ((padR + 3) & ~3);
    const int C4 = (C + 3) & ~3, H4 = (H + 3) & ~3;   // rows past C and H are zeros
    constexpr int WBUF = wbuf<W>(P1 * KC1, P2 * KC2);
    const int HS = (H + CL - 1) / CL, CS = (C + CL - 1) / CL;   // rows a CTA
    const int h0 = rank * HS, c0 = rank * CS;
    const int hv = max(0, min(HS, H - h0)), cv = max(0, min(CS, C - c0));
    const int n1 = (3 * C + KC1 - 1) / KC1, n2 = (H + KC2 - 1) / KC2, n3 = (C + KC2 - 1) / KC2;
    const int per_unit = n1 + n2 + n3;
    const int first_unit = blockIdx.x / CL, stride = gridDim.x / CL;
    const int total = (units - first_unit + stride - 1) / stride * per_unit;   // chunks

    extern __shared__ float4 smem4[];
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);   // [STAGES]
    // the chunks: 128-byte aligned for TMA (the launch adds the slack)
    char* wbase = reinterpret_cast<char*>(bars + STAGES);
    wbase += (128 - (smem_u32(wbase) & 127)) & 127;
    W* ws = reinterpret_cast<W*>(wbase);               // [STAGES][WBUF] as they arrive
    float* wf = reinterpret_cast<float*>(ws + STAGES * WBUF);   // int8: [WBUF] dequantized
    float* yf = wf + (is_int8<W>() ? WBUF : 0);        // [H4][N] y1, every CTA's rows
    float* xr = yf + (size_t)H4 * N;                   // [C4][N] the tile's raw input
    float* as = xr + (size_t)C4 * N;                   // [C4][LDX] activated, with halo

    // chunk g (g % per_unit: k1's column chunks, then k2's, then ks's) of the
    // weight rows this CTA needs, [rows][KC], into buffer g % STAGES: with
    // `vec` one TMA box copy (zeros past the matrix) by thread 0, completing
    // on bars[g % STAGES]; otherwise plain loads by every thread (C or H not
    // a multiple of 4, off the main path)
    auto issue = [&](int g) {
        const int q = g % per_unit, buf = g % STAGES;
        const CUtensorMap* map;
        const W* src;
        int R, KC, Ktot, k0, row0, valid;
        if (q < n1) {
            map = &map1; src = k1; R = P1; KC = KC1; Ktot = 3 * C; k0 = q * KC1; row0 = h0;
            valid = hv;
        } else if (q < n1 + n2) {
            map = &map2; src = k2; R = P2; KC = KC2; Ktot = H; k0 = (q - n1) * KC2; row0 = c0;
            valid = cv;
        } else {
            map = &map3; src = ks; R = P2; KC = KC2; Ktot = C; k0 = (q - n1 - n2) * KC2;
            row0 = c0; valid = cv;
        }
        W* dst = ws + buf * WBUF;
        if (vec) {
            if (tid == 0) {
                mbar_expect(&bars[buf], (unsigned)(R * KC * sizeof(W)));
                tensor_copy(dst, map, k0, row0, &bars[buf]);
            }
        } else {
            for (int i = tid; i < R * KC; i += THREADS) {
                const int r = i / KC, k = k0 + i - r * KC;
                dst[i] = (r < valid && k < Ktot) ? src[(size_t)(row0 + r) * Ktot + k] : W(0);
            }
        }
    };
    // int8: chunk g, landed, into wf as f32, an element q * scale[row] (rows
    // past the matrix are zeros, as in the f32 ring)
    auto dequantize = [&](int g) {
        const int q = g % per_unit;
        const float* scale = q < n1 ? s1 : (q < n1 + n2 ? s2 : ss);
        const int R = q < n1 ? P1 : P2, KC = q < n1 ? KC1 : KC2;
        const int row0 = q < n1 ? h0 : c0, rows = q < n1 ? H : C;
        const W* src = ws + (g % STAGES) * WBUF;
        for (int i = 4 * tid; i < R * KC; i += 4 * THREADS) {   // KC % 4 == 0: one row
            const int row = row0 + i / KC;
            const float sc = row < rows ? scale[row] : 0.f;
            const char4 v = *reinterpret_cast<const char4*>(src + i);
            *reinterpret_cast<float4*>(wf + i) =
                make_float4(__fmul_rn((float)v.x, sc), __fmul_rn((float)v.y, sc),
                            __fmul_rn((float)v.z, sc), __fmul_rn((float)v.w, sc));
        }
    };
    // before chunk g is used: the chunk STAGES - 1 ahead starts loading into
    // the buffer the last chunk freed, and chunk g must have landed (int8:
    // and been dequantized); returns chunk g as the products read it
    auto begin_chunk = [&](int g) -> const float* {
        if (g + STAGES - 1 < total) issue(g + STAGES - 1);
        if (vec) mbar_wait(&bars[g % STAGES], (g / STAGES) & 1);
        if constexpr (is_int8<W>()) {
            dequantize(g);
            __syncthreads();
            return wf;
        } else {
            __syncthreads();
            return ws + (g % STAGES) * WBUF;
        }
    };

    if (vec && tid == 0) {
        for (int i = 0; i < STAGES; ++i) mbar_init(&bars[i], 1);
        mbar_fence_init();
    }
    for (int g = 0; g < STAGES - 1 && g < total; ++g) issue(g);
    for (int i = tid; i < (C4 - C) * N; i += THREADS) xr[C * N + i] = 0.f;
    for (int i = tid; i < (C4 - C) * LDX; i += THREADS) as[(size_t)C * LDX + i] = 0.f;
    for (int i = tid; i < (H4 - H) * N; i += THREADS) yf[(size_t)H * N + i] = 0.f;
    cluster.sync();   // every CTA runs (and its barriers are initialised)
    const int xvec = (T % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0) ? 1 : 0;

    int g = 0;   // chunks used so far
    for (int u = first_unit; u < units; u += stride) {
        const int b = u / tiles, tile = u - b * tiles;
        const int t0 = tile * N;
        const float* xb = x + (size_t)b * C * T;

        // stage the unit's raw input: the tile by 16-byte cp.async where it
        // lies inside [0, T), the ragged end by plain loads under the padding
        for (int i = tid; i < C * (N / 4); i += THREADS) {
            const int c = i / (N / 4), n = (i - c * (N / 4)) * 4;
            const int q = t0 + n;
            float* dst = xr + (size_t)c * N + n;
            const float* xrow = xb + (size_t)c * T;
            if (xvec && q + 4 <= T) {
                cp_async16(dst, xrow + q);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) dst[e] = padded_input(xrow, q + e, T, reflect, padL);
            }
        }
        cp_async_commit();
        if (carry_out != nullptr && tile == 0 && rank == 0) {
            const int L = 2 * d;
            for (int i = tid; i < C * L; i += THREADS) {
                const int c = i / L, q = T - L + i % L;
                float v = 0.f;   // (the wrapper asks for T >= 2d when there is no left)
                if (q >= 0) v = elu(xb[(size_t)c * T + q]);
                else if (left != nullptr) v = left[((size_t)b * C + c) * L + q + L];
                carry_out[((size_t)b * C + c) * L + i % L] = v;
            }
        }
        cp_async_wait_all();
        __syncthreads();
        // activate this CTA's channels and write them into every CTA's `as`:
        // the tile a float4 at a time, then the halos (from `left`, activated
        // already, or from the input under the padding)
        for (int i = tid; i < cv * (N / 4); i += THREADS) {
            const int r = i / (N / 4), n = (i - r * (N / 4)) * 4;
            float4 v = *reinterpret_cast<const float4*>(xr + (size_t)(c0 + r) * N + n);
            v.x = elu(v.x);
            v.y = elu(v.y);
            v.z = elu(v.z);
            v.w = elu(v.w);
            const size_t at = (size_t)(c0 + r) * LDX + OFF + n;
#pragma unroll
            for (int q = 0; q < CL; ++q)
                *reinterpret_cast<float4*>(cluster.map_shared_rank(as, q) + at) = v;
        }
        for (int i = tid; i < cv * (padL + padR); i += THREADS) {
            const int r = i / (padL + padR), p = i - r * (padL + padR), c = c0 + r;
            const int q = p < padL ? t0 - padL + p : t0 + N + p - padL;
            const float v = (left != nullptr && q < 0)
                                ? left[((size_t)b * C + c) * padL + q + padL]
                                : elu(padded_input(xb + (size_t)c * T, q, T, reflect, padL));
            const size_t at = (size_t)c * LDX + (p < padL ? OFF - padL + p : OFF + N + p - padL);
#pragma unroll
            for (int k = 0; k < CL; ++k) cluster.map_shared_rank(as, k)[at] = v;
        }
        cluster.sync();   // every CTA's `as` holds every channel

        // y1 = ELU(K1 * A + b1): reduction index k = c*3 + j, k1's own order
        {
            float acc[RH1][RT];
#pragma unroll
            for (int r = 0; r < RH1; ++r)
#pragma unroll
                for (int n = 0; n < RT; ++n) acc[r][n] = 0.f;
            const float* abase = as + OFF - padL + cg_;
            for (int q = 0; q < n1; ++q, ++g) {
                const float* wr = begin_chunk(g) + rg * RH1 * KC1;
                const int kb = q * KC1;
                const int kc = min(KC1, (3 * C - kb + 11) / 12 * 12);   // past 3C the weights are 0
                for (int kk = 0; kk < kc; kk += 12) {
                    float4 wv[RH1][3];
#pragma unroll
                    for (int r = 0; r < RH1; ++r)
#pragma unroll
                        for (int v = 0; v < 3; ++v)
                            wv[r][v] = *reinterpret_cast<const float4*>(wr + r * KC1 + kk + 4 * v);
                    // 4 channels x 3 taps; past C the rows and the weights are 0
                    const float* arow = abase + (size_t)((kb + kk) / 3) * LDX;
#pragma unroll
                    for (int e = 0; e < 12; ++e) {
                        if (e % 3 == 0 && e > 0) arow += LDX;
                        float a[RT];
#pragma unroll
                        for (int n = 0; n < RT; ++n) a[n] = arow[(e % 3) * d + CGN * n];
#pragma unroll
                        for (int r = 0; r < RH1; ++r) {
                            const float w = lane_of(wv[r][e / 4], e % 4);
#pragma unroll
                            for (int n = 0; n < RT; ++n) acc[r][n] = fmaf(w, a[n], acc[r][n]);
                        }
                    }
                }
                __syncthreads();   // the buffer is free for the copy STAGES chunks on
            }
            // this CTA's rows of y1, into every CTA's yf
#pragma unroll
            for (int r = 0; r < RH1; ++r) {
                const int hr = rg * RH1 + r, h = h0 + hr;
                if (hr < hv) {
#pragma unroll
                    for (int n = 0; n < RT; ++n) {
                        const float v = elu(acc[r][n] + b1[h]);
#pragma unroll
                        for (int q = 0; q < CL; ++q)
                            cluster.map_shared_rank(yf, q)[(size_t)h * N + cg_ + CGN * n] = v;
                    }
                }
            }
        }
        cluster.sync();   // every CTA's yf holds every row of y1

        // out = (K2 * y1 + b2) + (Ks * x + bs)
        {
            float acc[RH2][RT], sc[RH2][RT];
#pragma unroll
            for (int r = 0; r < RH2; ++r)
#pragma unroll
                for (int n = 0; n < RT; ++n) acc[r][n] = sc[r][n] = 0.f;
            for (int q = 0; q < n2; ++q, ++g) {
                const float* wr = begin_chunk(g) + rg * RH2 * KC2;
                const int kb = q * KC2, kc = min(KC2, (H - kb + 3) & ~3);
                for (int kk = 0; kk < kc; kk += 4) {
                    float4 wv[RH2];
#pragma unroll
                    for (int r = 0; r < RH2; ++r)
                        wv[r] = *reinterpret_cast<const float4*>(wr + r * KC2 + kk);
                    const float* ybase = yf + (size_t)(kb + kk) * N + cg_;   // past H: 0
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float* yrow = ybase + e * N;
                        float a[RT];
#pragma unroll
                        for (int n = 0; n < RT; ++n) a[n] = yrow[CGN * n];
#pragma unroll
                        for (int r = 0; r < RH2; ++r) {
                            const float w = lane_of(wv[r], e);
#pragma unroll
                            for (int n = 0; n < RT; ++n) acc[r][n] = fmaf(w, a[n], acc[r][n]);
                        }
                    }
                }
                __syncthreads();
            }
            for (int q = 0; q < n3; ++q, ++g) {
                const float* wr = begin_chunk(g) + rg * RH2 * KC2;
                const int kb = q * KC2, kc = min(KC2, (C - kb + 3) & ~3);
                for (int kk = 0; kk < kc; kk += 4) {
                    float4 wv[RH2];
#pragma unroll
                    for (int r = 0; r < RH2; ++r)
                        wv[r] = *reinterpret_cast<const float4*>(wr + r * KC2 + kk);
                    const float* xbase = xr + (size_t)(kb + kk) * N + cg_;   // past C: 0
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float* xrow = xbase + e * N;
                        float a[RT];
#pragma unroll
                        for (int n = 0; n < RT; ++n) a[n] = xrow[CGN * n];
#pragma unroll
                        for (int r = 0; r < RH2; ++r) {
                            const float w = lane_of(wv[r], e);
#pragma unroll
                            for (int n = 0; n < RT; ++n) sc[r][n] = fmaf(w, a[n], sc[r][n]);
                        }
                    }
                }
                __syncthreads();
            }
#pragma unroll
            for (int r = 0; r < RH2; ++r) {
                const int cr = rg * RH2 + r, m = c0 + cr;
                if (cr < cv) {
                    float* orow = out + ((size_t)b * C + m) * T;
#pragma unroll
                    for (int n = 0; n < RT; ++n) {
                        const int t = t0 + cg_ + CGN * n;
                        if (t < T) orow[t] = (acc[r][n] + b2[m]) + (sc[r][n] + bs[m]);
                    }
                }
            }
        }
        __syncthreads();   // xr is free for the next unit
    }
    // (no CTA writes into another after the last unit's y1 barrier, so each
    // may leave)
}

constexpr int MAX_DEVICES = 64;

// The device's opt-in shared-memory limit, read once per device.
int max_smem_optin(int device) {
    static std::atomic<int> cached[MAX_DEVICES];
    int v = cached[device].load(std::memory_order_relaxed);
    if (v == 0 && cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
                      == cudaSuccess)
        cached[device].store(v, std::memory_order_relaxed);
    return v;
}

template <typename W, int N, int RT, int CL, int RH1, int RH2, int KC1, int KC2>
cudaError_t launch(const float* x, const float* left, const W* k1, const float* s1,
                   const float* b1, const W* k2, const float* s2, const float* b2, const W* ks,
                   const float* ss, const float* bs, float* out, float* carry_out, int B, int C,
                   int H, int T, int d, int causal, int reflect, int device,
                   cudaStream_t stream) {
    constexpr int STAGES = stages<W>();
    constexpr int RGN = THREADS / (N / RT);
    constexpr int P1 = RGN * RH1, P2 = RGN * RH2;
    auto kernel = resblock_kernel<W, N, RT, CL, RH1, RH2, KC1, KC2>;
    if ((H + CL - 1) / CL > P1 || (C + CL - 1) / CL > P2) return cudaErrorInvalidValue;
    const int padL = causal ? 2 * d : d, padR = causal ? 0 : d;
    const int LDX = ((padL + 3) & ~3) + N + ((padR + 3) & ~3);
    constexpr int WBUF = wbuf<W>(P1 * KC1, P2 * KC2);
    const size_t C4 = (C + 3) & ~3, H4 = (H + 3) & ~3;
    const size_t smem = 8 * STAGES + 128   // the barriers, the chunks' alignment
                        + sizeof(W) * (size_t)STAGES * WBUF
                        + sizeof(float) * ((is_int8<W>() ? WBUF : 0) + H4 * N + C4 * N + C4 * LDX);
    const int max_smem = max_smem_optin(device);
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    static std::atomic<bool> configured[MAX_DEVICES];
    if (!configured[device].load(std::memory_order_relaxed)) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        if (err != cudaSuccess) return err;
        configured[device].store(true, std::memory_order_relaxed);
    }
    const auto aligned = [](const W* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
    // TMA: every global row a multiple of 16 bytes (3C, H and C elements)
    constexpr int ALIGN = 16 / sizeof(W);
    const int vec = (C % ALIGN == 0 && H % ALIGN == 0 && aligned(k1) && aligned(k2)
                     && aligned(ks)) ? 1 : 0;
    const long long tiles = (T + N - 1) / N, units = tiles * B;
    if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
    // the weights in boxes of a chunk's columns x the rows a CTA holds
    CUtensorMap map1{}, map2{}, map3{};
    if (vec) {
        cudaError_t err = encodec_tensor_map_2d(k1, H, 3 * C, P1, KC1, false, &map1);
        if (err == cudaSuccess) err = encodec_tensor_map_2d(k2, C, H, P2, KC2, false, &map2);
        if (err == cudaSuccess) err = encodec_tensor_map_2d(ks, C, C, P2, KC2, false, &map3);
        if (err != cudaSuccess) return err;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // persistent clusters: as many as fit on the card at once (asked once
    // per device and shared-memory size), each looping over units
    static std::mutex lock;
    static int fit_device = -1, fit = 0;
    static size_t fit_smem = 0;
    int clusters;
    {
        std::lock_guard<std::mutex> guard(lock);
        if (fit_device != device || fit_smem != smem) {
            cfg.gridDim = dim3(CL, 1, 1);
            const cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
            if (err != cudaSuccess) return err;
            fit_device = device;
            fit_smem = smem;
        }
        clusters = fit;
    }
    if (clusters <= 0) return cudaErrorInvalidConfiguration;
    if ((long long)clusters > units) clusters = static_cast<int>(units);
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * CL), 1, 1);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map1, map2, map3, x, left, k1, s1,
                                               b1, k2, s2, b2, ks, ss, bs, out, carry_out, C, H,
                                               T, d, causal, reflect, vec,
                                               static_cast<int>(units),
                                               static_cast<int>(tiles));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The width class of a block: by the wider of C and 2H (H = C/2 in SEANet);
// 0 past 512, where the input tile no longer fits a CTA's shared memory.
int width_class(int C, int H) {
    const int w = C > 2 * H ? C : 2 * H;
    return w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : w <= 256 ? 256 : w <= 512 ? 512 : 0;
}

}  // namespace

// The launch shape of a block of C channels and H hidden: the cluster size
// and the columns of a tile (0 and 0: wider than the kernel takes).
extern "C" void encodec_resblock_config(int C, int H, int* cluster, int* tile) {
    *cluster = 0;
    *tile = 0;
    switch (width_class(C, H)) {
        case 32: *cluster = 2; *tile = 256; break;
        case 64: *cluster = 2; *tile = 128; break;
        case 128: *cluster = 4; *tile = 64; break;
        case 256: case 512: *cluster = 8; *tile = 32; break;
        default: break;
    }
}

namespace {

template <typename W>
cudaError_t block(const float* x, const float* left, const W* k1, const float* s1,
                  const float* b1, const W* k2, const float* s2, const float* b2, const W* ks,
                  const float* ss, const float* bs, float* out, float* carry_out, int B, int C,
                  int H, int T, int d, int causal, int reflect, int device, void* stream) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (B <= 0 || T <= 0) return cudaSuccess;
    if (C <= 0 || H <= 0 || d <= 0 || (left != nullptr && !causal)) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESBLOCK_LAUNCH(...)                                                              \
    return launch<W, __VA_ARGS__>(x, left, k1, s1, b1, k2, s2, b2, ks, ss, bs, out, carry_out, \
                                  B, C, H, T, d, causal, reflect, device, s)
    // <N, RT, CL, RH1, RH2, KC1, KC2>: N / RT column groups, 256 / (N / RT) row
    // groups; at C 512 half-width chunks keep the shared memory under 227 KB
    switch (width_class(C, H)) {
        case 32: RESBLOCK_LAUNCH(256, 2, 2, 4, 8, 192, 96);
        case 64: RESBLOCK_LAUNCH(128, 2, 2, 4, 8, 192, 96);
        case 128: RESBLOCK_LAUNCH(64, 1, 4, 4, 8, 192, 96);
        case 256: RESBLOCK_LAUNCH(32, 1, 8, 2, 4, 192, 96);
        case 512: RESBLOCK_LAUNCH(32, 1, 8, 4, 8, 96, 48);
        default: return cudaErrorInvalidValue;
    }
#undef RESBLOCK_LAUNCH
}

}  // namespace

// x [B, C, T], k1 [H, C, 3], b1 [H], k2 [C, H], b2 [C], ks [C, C], bs [C] (f32,
// contiguous, on `device`; C and 2H at most 512); left and carry_out
// [B, C, 2d] or null (left only when causal). Writes out [B, C, T]. Launches
// on `stream`; returns a cudaError_t (a refused cluster launch included).
extern "C" int encodec_resblock_f32(const float* x, const float* left, const float* k1,
                                    const float* b1, const float* k2, const float* b2,
                                    const float* ks, const float* bs, float* out,
                                    float* carry_out, int B, int C, int H, int T, int d,
                                    int causal, int reflect, int device, void* stream) {
    return block<float>(x, left, k1, nullptr, b1, k2, nullptr, b2, ks, nullptr, bs, out,
                        carry_out, B, C, H, T, d, causal, reflect, device, stream);
}

// The same with k1, k2 and ks int8 and their f32 scales a row, s1 [H], s2 [C],
// ss [C] (the int8 twin's weights): the f32 entry's output on q * scale, bit
// for bit.
extern "C" int encodec_resblock_i8w(const float* x, const float* left, const int8_t* k1,
                                    const float* s1, const float* b1, const int8_t* k2,
                                    const float* s2, const float* b2, const int8_t* ks,
                                    const float* ss, const float* bs, float* out,
                                    float* carry_out, int B, int C, int H, int T, int d,
                                    int causal, int reflect, int device, void* stream) {
    return block<int8_t>(x, left, k1, s1, b1, k2, s2, b2, ks, ss, bs, out, carry_out, B, C, H,
                         T, d, causal, reflect, device, stream);
}
