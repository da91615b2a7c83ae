// RVQ nearest-code cascade (kernel K1) for Hopper, f32 on the CUDA cores.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_vq.py `_rvq_group_kernel` (entry
// `rvq_encode_pallas`). For every row r of the input and every stage k:
//
//     scores = 2 * dot(r, E_k[n]) - esq_k[n]      n = 0 .. N-1
//     idx_k  = argmax(scores)                      first maximum wins
//     r      = r - E_k[idx_k]
//
// What bounds it on this card: at the codec's large M, arithmetic (a row
// costs N*D FMAs a stage: 10 s of 24 kHz audio at B = 16 and n_q = 32 is about
// 100 GFLOP of f32). At the serving path's M (64 rows a mux tick, 8 a join)
// the work is tiny and the time is latency: one stage cannot start before the
// last one's code is known, so a launch costs K times (score a slice, merge,
// gather a row).
//
// Design: the bins of every stage are split over a thread-block cluster.
// - The grid is (row tiles) x (a cluster of CL = 8 CTAs). A CTA owns
//   NS = ceil(N / CL) consecutive bins of every stage and all K stages of its
//   tile of TM rows, in one launch. TM is chosen from M (64 rows down to 1) so
//   that even M = 8 puts 64 CTAs on the card.
// - Codebooks do not depend on the residual, so a CTA's slice of stage k + 1
//   is copied into the second of two shared buffers while stage k is scored:
//   TMA tensor copies of boxes of 32 columns x the slice's bins (4 copies of
//   16 KB at D 128, 128 bins), issued by one thread and completing on an
//   mbarrier (TMA's cost is largely per request, so a few large boxes beat
//   a copy a row). The boxes land in TMA's 128-byte swizzle, which puts the
//   float4 loads of 8 neighbouring bins at one d in 8 different 16-byte bank
//   groups, free of conflicts. Each thread's esq values are loaded into
//   registers while the copy is awaited.
// - The score keeps the sequential f32 FMA chain over d = 0 .. D-1 and
//   2*dot - esq (esq precomputed per stage; a literal |r - e|^2 rounds
//   differently and flips near-ties). No TF32 and no split of D: every score
//   is bit-equal to the one-block-per-tile kernel this replaces. Each thread
//   scans its bins in increasing order with a strict `>`.
// - The merge: threads by warp shuffles, warps through shared memory, then
//   each CTA writes its per-row best (score, index) into its own shared
//   memory, `cluster.sync()`, and every CTA reads all CL peers' pairs through
//   distributed shared memory. The higher score wins and the lower index wins
//   a tie, so all CTAs agree on argmax's first-max code without a round trip
//   through device memory. The pair slots alternate by stage, so stage k+1's
//   writes never overtake a peer's reads of stage k.
// - Every CTA then updates its own copy of the residual tile with E_k[idx]
//   (a 4*D-byte row gathered from L2), the same f32 subtraction in every CTA,
//   so all copies stay identical. Rank 0 writes the codes.
// - x may be strided: [B, T, D] with any strides (the encoder's latents
//   arrive transposed), so the caller needs no copy.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;           // CTAs of a cluster: the bins of a stage are split CL ways
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GATHER = 8;       // codebook loads a thread has in flight in the update

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the higher score wins, the lower index on an equal score
__device__ __forceinline__ void take(float& s, int& i, float os, int oi) {
    if (os > s || (os == s && oi < i)) {
        s = os;
        i = oi;
    }
}

// RPT rows a thread; WB warps share a row group and split its bins, so a tile
// holds TM = RPT * WARPS / WB rows; a buffer holds up to NSC bins, of which a
// thread scores up to BPT.
template <int RPT, int WB, int NSC>
__global__ void __launch_bounds__(THREADS, NSC == 64 ? 2 : 1)
rvq_cascade_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                   long long sb, long long st, long long sd, int T,
                   const float* __restrict__ embed, const float* __restrict__ esq,
                   int* __restrict__ codes, int M, int K, int N, int D, int NS, int nsc, int vec) {
    constexpr int TM = RPT * WARPS / WB;
    constexpr int BL = 32 * WB;                         // threads across a buffer's bins
    constexpr int BPT = (NSC + BL - 1) / BL;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int m0 = (blockIdx.x / CL) * TM;
    const int Dp = (D + 3) & ~3, ld = Dp + 4;
    // a buffer is nbox boxes of 32 columns x nsc bins, 128 B a bin, in TMA's
    // 128-byte swizzle: the 16-byte chunk c of bin b sits at chunk c ^ (b & 7)
    const int nbox = (D + 31) / 32, boxf = ((nsc + 7) & ~7) * 32, buff = nbox * boxf;

    extern __shared__ float4 smem4[];
    // the swizzled buffers need 1024-byte alignment (the launch adds 1 KB)
    float* e_s = reinterpret_cast<float*>(smem4) + ((1024 - (smem_u32(smem4) & 1023)) & 1023) / 4;
    float* r_s = e_s + 2 * buff;                        // [TM][ld] residual tile
    float2* pair = reinterpret_cast<float2*>(r_s + TM * ld);   // [2][TM] cluster merge slots
    float2* part = pair + 2 * TM;                       // [WB][TM] warp merge
    int* idx_s = reinterpret_cast<int*>(part + WB * TM);       // [TM] chosen codes
    // [2] a buffer's tensor copies have landed (8-byte aligned: TM is even or 1)
    unsigned long long* full = reinterpret_cast<unsigned long long*>(idx_s + (TM + 1) / 2 * 2);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rg = warp / WB, wb = warp % WB;
    const int bl = wb * 32 + lane;
    const int bin0 = rank * NS;
    const int nbins = max(0, min(NS, N - bin0));        // this CTA's bins of a stage
    const int nch = (NS + nsc - 1) / nsc;               // buffers a stage
    const int total = K * nch;

    // one buffer of codebook rows into shared memory: with `vec`, one TMA
    // tensor copy a box, issued by one thread and completing on full[buf];
    // otherwise plain loads into the same layout (D % 4 != 0 only, off the
    // main path)
    auto issue = [&](int i) {
        const int k = i / nch, c = i % nch, buf = i & 1;
        const int row = k * N + bin0 + c * nsc;
        float* dst = e_s + buf * buff;
        if (vec) {
            if (tid == 0) {
                mbar_expect(&full[buf], (unsigned)(nbox * nsc * 128));
                for (int bx = 0; bx < nbox; ++bx)
                    tensor_copy(dst + bx * boxf, &map, bx * 32, row, &full[buf]);
            }
        } else {
            const int nb = max(0, min(nsc, nbins - c * nsc));
            for (int j = tid; j < nsc * nbox * 32; j += THREADS) {
                const int b = j / (nbox * 32), d = j - b * nbox * 32;
                const float v = (b < nb && d < D) ? embed[(size_t)(row + b) * D + d] : 0.f;
                dst[(d >> 5) * boxf + b * 32 + ((((d & 31) >> 2) ^ (b & 7)) << 2) + (d & 3)] = v;
            }
        }
    };

    if (tid == 0) {
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        mbar_fence_init();
    }
    __syncthreads();
    // the residual tile by cp.async (rows past M and columns past D are
    // zeros), then the first slice
    for (int i = tid; i < TM * Dp; i += THREADS) {
        const int r = i / Dp, d = i - r * Dp;
        const int m = m0 + r;
        if (m < M && d < D)
            cp_async4(r_s + r * ld + d, x + (long long)(m / T) * sb + (long long)(m % T) * st
                                            + (long long)d * sd);
        else
            r_s[r * ld + d] = 0.f;
    }
    cp_async_commit();
    issue(0);

    float best_s[RPT];
    int best_i[RPT];
    cp_async_wait_all();
    for (int i = 0; i < total; ++i) {
        const int k = i / nch, c = i % nch, buf = i & 1;
        const int nb = min(nsc, nbins - c * nsc);
        if (i + 1 < total) issue(i + 1);    // the next slice loads while this one is scored
        float q[BPT];                       // this thread's esq, in flight during the wait
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
            const int b = bl + BL * j;
            q[j] = b < nb ? esq[(size_t)k * N + bin0 + c * nsc + b] : 0.f;
        }
        if (vec) mbar_wait(&full[buf], (i >> 1) & 1);
        __syncthreads();
        if (c == 0) {
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                best_s[r] = -INFINITY;
                best_i[r] = 0;
            }
        }

        float acc[RPT][BPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int j = 0; j < BPT; ++j) acc[r][j] = 0.f;
        const float* rows = r_s + rg * RPT * ld;
        const float* eb = e_s + buf * buff;
        int eoff[BPT], eswz[BPT];   // each bin's row in a box and its swizzle
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
            const int b = min(bl + BL * j, nsc - 1);
            eoff[j] = b * 32;
            eswz[j] = b & 7;
        }
        for (int d = 0; d < Dp; d += 4) {
            float4 a[RPT], e[BPT];
            const float* box = eb + (d >> 5) * boxf;
            const int chunk = (d & 31) >> 2;
#pragma unroll
            for (int r = 0; r < RPT; ++r) a[r] = *reinterpret_cast<const float4*>(rows + r * ld + d);
#pragma unroll
            for (int j = 0; j < BPT; ++j)
                e[j] = *reinterpret_cast<const float4*>(box + eoff[j] + ((chunk ^ eswz[j]) << 2));
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int j = 0; j < BPT; ++j) {
                    acc[r][j] = fmaf(a[r].x, e[j].x, acc[r][j]);
                    acc[r][j] = fmaf(a[r].y, e[j].y, acc[r][j]);
                    acc[r][j] = fmaf(a[r].z, e[j].z, acc[r][j]);
                    acc[r][j] = fmaf(a[r].w, e[j].w, acc[r][j]);
                }
        }
#pragma unroll
        for (int j = 0; j < BPT; ++j) {      // this thread's bins, increasing
            const int b = bl + BL * j;
            if (b < nb) {
                const int bin = bin0 + c * nsc + b;
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    const float s = 2.f * acc[r][j] - q[j];
                    if (s > best_s[r]) {
                        best_s[r] = s;
                        best_i[r] = bin;
                    }
                }
            }
        }

        if (c == nch - 1) {   // the stage's last buffer: merge, pick, update
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    const float os = __shfl_xor_sync(0xffffffffu, best_s[r], off);
                    const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
                    take(best_s[r], best_i[r], os, oi);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int r = 0; r < RPT; ++r)
                    part[wb * TM + rg * RPT + r] = make_float2(best_s[r], __int_as_float(best_i[r]));
            }
            __syncthreads();
            float2* slot = pair + (k & 1) * TM;
            if (tid < TM) {
                float s = -INFINITY;
                int bi = 0;
                for (int w = 0; w < WB; ++w) {
                    const float2 p = part[w * TM + tid];
                    take(s, bi, p.x, __float_as_int(p.y));
                }
                slot[tid] = make_float2(s, __int_as_float(bi));
            }
            cluster.sync();   // every CTA's pairs of stage k are written
            // CL lanes a row each read one CTA's pair through distributed
            // shared memory, all at once, and merge by shuffles
            for (int j0 = 0; j0 < TM * CL; j0 += THREADS) {
                const int j = j0 + tid, r = j / CL, q = j % CL;
                float s = -INFINITY;
                int bi = 0x7fffffff;
                if (j < TM * CL) {
                    const float2 p = *cluster.map_shared_rank(slot + r, q);
                    s = p.x;
                    bi = __float_as_int(p.y);
                }
#pragma unroll
                for (int off = CL / 2; off > 0; off >>= 1) {
                    const float os = __shfl_xor_sync(0xffffffffu, s, off);
                    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
                    take(s, bi, os, oi);
                }
                if (j < TM * CL && q == 0) {
                    idx_s[r] = bi;
                    if (rank == 0 && m0 + r < M) codes[(size_t)k * M + m0 + r] = bi;
                }
            }
            __syncthreads();
            // r -= E_k[idx]: every gathered load of a pass in flight before
            // the first subtraction
            const float* ek = embed + (size_t)k * N * D;
            if (vec) {
                const int per = D >> 2;
                for (int j0 = 0; j0 < TM * per; j0 += GATHER * THREADS) {
                    float4 g[GATHER];
#pragma unroll
                    for (int u = 0; u < GATHER; ++u) {
                        const int j = j0 + u * THREADS + tid;
                        if (j < TM * per) {
                            const int r = j / per, d = (j - r * per) << 2;
                            g[u] = *reinterpret_cast<const float4*>(ek + (size_t)idx_s[r] * D + d);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < GATHER; ++u) {
                        const int j = j0 + u * THREADS + tid;
                        if (j < TM * per) {
                            const int r = j / per, d = (j - r * per) << 2;
                            float* rp = r_s + r * ld + d;
                            rp[0] -= g[u].x;
                            rp[1] -= g[u].y;
                            rp[2] -= g[u].z;
                            rp[3] -= g[u].w;
                        }
                    }
                }
            } else {
                for (int j0 = 0; j0 < TM * D; j0 += GATHER * THREADS) {
                    float g[GATHER];
#pragma unroll
                    for (int u = 0; u < GATHER; ++u) {
                        const int j = j0 + u * THREADS + tid;
                        if (j < TM * D) {
                            const int r = j / D;
                            g[u] = ek[(size_t)idx_s[r] * D + j - r * D];
                        }
                    }
#pragma unroll
                    for (int u = 0; u < GATHER; ++u) {
                        const int j = j0 + u * THREADS + tid;
                        if (j < TM * D) {
                            const int r = j / D;
                            r_s[r * ld + j - r * D] -= g[u];
                        }
                    }
                }
            }
        }
        __syncthreads();   // the buffer is free for the copy after next
    }
    cluster.sync();        // no CTA leaves while a peer may still read its pairs
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

// rows a tile: the most (64 down to 1) that still leave 8 tiles, so that
// small M spreads over 64 SMs or more
int auto_rows(int M) {
    int tm = 64;
    while (tm > 1 && (M + tm - 1) / tm < 8) tm >>= 1;
    return tm;
}

// bins a buffer: a stage's whole slice (128 at N 1024) while the grid fits the
// card at one CTA an SM; past that half of it, so that two CTAs share an SM
int auto_bins(int M, int rows) { return (M + rows - 1) / rows * CL <= 128 ? 128 : 64; }

template <int RPT, int WB, int NSC>
cudaError_t launch(const float* x, long long sb, long long st, long long sd, int T,
                   const float* embed, const float* esq, int* codes, int M, int K, int N, int D,
                   int device, cudaStream_t stream) {
    constexpr int TM = RPT * WARPS / WB;
    const int NS = (N + CL - 1) / CL;
    const int nsc = NS < NSC ? NS : NSC;
    const int Dp = (D + 3) & ~3, ld = Dp + 4;
    const int buff = (D + 31) / 32 * ((nsc + 7) & ~7) * 32;
    const size_t smem = 1024 + sizeof(float) * ((size_t)2 * buff + (size_t)TM * ld)
                        + sizeof(float2) * (2 + WB) * TM + sizeof(int) * ((TM + 1) / 2 * 2)
                        + 2 * sizeof(unsigned long long);
    const int max_smem = max_smem_optin(device);
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    // the kernel may take up to the opt-in limit: set once per device
    static std::atomic<bool> configured[MAX_DEVICES];
    if (!configured[device].load(std::memory_order_relaxed)) {
        const cudaError_t e = cudaFuncSetAttribute(
            rvq_cascade_kernel<RPT, WB, NSC>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        if (e != cudaSuccess) return e;
        configured[device].store(true, std::memory_order_relaxed);
    }
    const long long tiles = (M + TM - 1) / TM;
    if (tiles * CL > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vec = (D % 4 == 0 && reinterpret_cast<size_t>(embed) % 16 == 0) ? 1 : 0;
    CUtensorMap map{};
    if (vec) {
        // codebooks [K * N rows][D] in boxes of nsc bins x 32 columns, swizzled
        const cudaError_t e = encodec_tensor_map_2d(embed, K * N, D, nsc, 32, true, &map);
        if (e != cudaSuccess) return e;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(tiles * CL), 1, 1);
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
    const cudaError_t err = cudaLaunchKernelEx(&cfg, rvq_cascade_kernel<RPT, WB, NSC>, map, x, sb,
                                               st, sd, T, embed, esq, codes, M, K, N, D, NS, nsc,
                                               vec);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// The launch shape for M rows and N bins: the cluster size, the rows of a tile
// and the bins of one shared buffer.
extern "C" void encodec_rvq_config(int M, int N, int* cluster, int* rows, int* buffer_bins) {
    *cluster = CL;
    *rows = auto_rows(M);
    const int NS = (N + CL - 1) / CL, width = auto_bins(M, *rows);
    *buffer_bins = NS < width ? (NS > 0 ? NS : 1) : width;
}

// x: row m = b*T + t, column d at x[b*sb + t*st + d*sd] (M = B*T rows, any
// strides, in elements); embed [K, N, D], esq [K, N] (f32, contiguous, on
// `device`); writes codes [K, M] int32. Launches on `stream`; returns a
// cudaError_t (a refused cluster launch included).
extern "C" int encodec_rvq_encode_f32(const float* x, long long sb, long long st, long long sd,
                                      int T, const float* embed, const float* esq, int* codes,
                                      int M, int K, int N, int D, int device, void* stream) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (M <= 0 || K <= 0) return cudaSuccess;
    if (N <= 0 || D <= 0 || T <= 0) return cudaErrorInvalidValue;
    const int tm = auto_rows(M);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RVQ_LAUNCH(RPT, WB, NSC) \
    return launch<RPT, WB, NSC>(x, sb, st, sd, T, embed, esq, codes, M, K, N, D, device, s)
    // <RPT, WB, NSC>: the half-slice buffers come only with 64 rows a tile
    if (auto_bins(M, tm) == 64) RVQ_LAUNCH(8, 1, 64);
    switch (tm) {
        case 64: RVQ_LAUNCH(8, 1, 128);
        case 32: RVQ_LAUNCH(4, 1, 128);
        case 16: RVQ_LAUNCH(2, 1, 128);
        case 8: RVQ_LAUNCH(1, 1, 128);
        case 4: RVQ_LAUNCH(1, 2, 128);
        case 2: RVQ_LAUNCH(1, 4, 128);
        default: RVQ_LAUNCH(1, 8, 128);
    }
#undef RVQ_LAUNCH
}
