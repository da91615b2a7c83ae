// LSTM recurrence (kernel K2) for Hopper, f32.
//
// Replaces: encodec_pytorch_tpu/ops/pallas_lstm.py `_lstm_kernel` (entry
// `lstm_layer_pallas`). Given the input projection xp [T, B, 4H] (x @ W_ih^T
// plus both biases, computed outside the kernel) and W_hh [4H, H] in torch's
// layout, it runs from h0 and c0 [B, H] (zero when null; the streaming codec
// carries them from chunk to chunk) and writes the final cell state c_T when
// asked (h_T is out[T-1]):
//
//     gates = xp[t] + h @ W_hh^T         torch gate order i, f, g, o
//     c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h     = sigmoid(o) * tanh(c)       out[t] = h
//
// What bounds it on this card: latency. The T steps are sequential, and each
// needs all of h from the step before. A step is only 4H*H FMAs a batch row
// (1M at H = 512), but W_hh is 4 MB in f32 at H = 512: far more than one SM
// holds, and rereading it from L2 each step would cost tens of microseconds.
// So a step costs a grid barrier, one round trip to L2 for h, and the dot,
// which is the only part that grows with B.
//
// Design: a persistent cooperative kernel. The TPU kernel kept h and c in
// scratch between grid steps, which run in order on one core; CUDA blocks run
// in parallel and in no order, so the time loop lives inside the kernel and
// the blocks meet at a grid-wide barrier once per step.
// - Block j owns U consecutive hidden units (U = ceil(H / #SMs): 4 at H = 512
//   on 132 SMs, so 128 blocks) and their R = 4U gate rows, a warp a pair of
//   rows (256 threads at U = 4). Lane l keeps both rows' K-slice
//   k = 128i + 4l + {0..3} of W_hh in registers for the whole sequence (32
//   floats at H = 512), and the block's cells' c stay in shared memory.
// - Each step a block copies h[t-1] (the previous output rows, nb*H floats,
//   contiguous, read past L1 with __ldcg because other SMs wrote them) into
//   shared memory as 16-byte loads, up to 8 in flight a thread before any
//   store (8 a thread at B = 16: one round trip to L2, not 32 in series).
//   Its slice of xp[t+1] does not depend on h, so it is fetched with
//   cp.async during step t into the other of two buffers.
// - The dot: each W_hh element is read once a step (it is in registers) and
//   reused over up to 16 batch rows at a time, and each h value read from
//   shared memory (a warp reads 32 neighbouring float4s, no word twice)
//   feeds both of the thread's rows. A thread keeps one partial sum a (row,
//   batch row); the warp's 32 slices are reduced by a transposing butterfly
//   (rounds that halve the values a lane keeps, 31 shuffles at 16 batch
//   rows), after which lane l holds one (row, batch row) sum and writes it:
//   no serial stores. A pass over fewer batch rows runs a narrower copy of
//   the dot (1, 2, 4 or 8 rows), so B = 1 pays for one row.
// - Then the cell update for the block's U units, a write of h[t] to `out`,
//   and grid.sync().
// - Every step runs the same code in the same order whatever t is, so a run
//   split into chunks with a carried (h, c) gives the bits of one call.
// - It must be launched with cudaLaunchCooperativeKernel, and every block must
//   be resident at once or the barrier deadlocks. The host entry checks
//   co-residency (an occupancy query, cached per device and shared-memory
//   size) and returns cudaErrorCooperativeLaunchTooLarge rather than launch.
// - Batch rows that would overflow shared memory are split into sequential
//   launches (none below ~100 rows at H = 512).
// - expf/tanhf, never the fast intrinsics: the result is held to the plain
//   recurrence at 1e-4 after hundreds of steps.
// - Forward only: training's backward recomputes the recurrence with the
//   plain PyTorch loop (ops/lstm.py `_Recurrence`), as the JAX package does.
// - int8 weights (encodec_lstm_recurrence_i8w, the int8 twin of prepare.py):
//   W_hh arrives as int8 [4H, H] with an f32 scale a gate row. The kernel is
//   the same template with the weight type int8: each lane loads its int8
//   K-slice once a launch and forms __fmul_rn((float)q, scale[row]), the
//   product torch's and the JAX package's dequantization compute, into the
//   registers the f32 entry fills, so everything after the load, and the
//   bits, are the f32 kernel's on the dequantized matrix. A launch reads 1 MB
//   of W_hh instead of 4 at H = 512: the carried serving call (T 4, B 16)
//   reloads it every tick.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int SLICES = 32;       // K-slices a pair of gate rows: one warp
constexpr int BG = 16;           // batch rows a pass of the dot (x 2 gate rows = 32 lanes)
constexpr int LB = 8;            // 16-byte loads in flight a thread when staging h
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

// One round of the half-warp's transposing reduction: lanes s and s ^ O
// swap half of their 2*O partial sums and add, so that afterwards lane s
// keeps O sums, those of the batch rows whose bit O equals that of s.
template <int O, int N>
__device__ __forceinline__ void reduce_round(float (&acc)[N], int s) {
    const bool upper = s & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
        const float send = upper ? acc[i] : acc[i + O];
        const float keep = upper ? acc[i + O] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
}

// The dot of a thread's two gate rows with NB batch rows of h (hb: row 0 at
// this thread's K-slice, rows HS apart), summed over the warp's 32 slices:
// lane l returns the sum for gate row l / NB % 2 and batch row l % NB. Every
// W_hh element is read once (from registers) for all NB rows, and every h
// value loaded feeds both gate rows.
template <int NB, int KMAX>
__device__ __forceinline__ float gate_dot(const float4 (&w)[2][KMAX], int KI, const float* hb,
                                          int HS, int lane) {
    float acc[2 * NB];
#pragma unroll
    for (int j = 0; j < 2 * NB; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
        if (i < KI) {
            float4 h[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j)
                h[j] = *reinterpret_cast<const float4*>(hb + (size_t)j * HS + 4 * SLICES * i);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    float& a = acc[r * NB + j];
                    a = fmaf(w[r][i].x, h[j].x, a);
                    a = fmaf(w[r][i].y, h[j].y, a);
                    a = fmaf(w[r][i].z, h[j].z, a);
                    a = fmaf(w[r][i].w, h[j].w, a);
                }
            }
        }
    }
    // transposing rounds over the lane bits below 2*NB, then a butterfly over the rest
    if constexpr (NB >= 16) reduce_round<16>(acc, lane);
    if constexpr (NB >= 8) reduce_round<8>(acc, lane);
    if constexpr (NB >= 4) reduce_round<4>(acc, lane);
    if constexpr (NB >= 2) reduce_round<2>(acc, lane);
    reduce_round<1>(acc, lane);
    float v = acc[0];
#pragma unroll
    for (int off = 2 * NB; off < SLICES; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Threads a block of the KMAX instantiation may have: a warp a pair of gate rows.
template <int KMAX>
constexpr int max_threads() { return KMAX > 4 ? 512 : 256; }

// W_hh element k of a row, in f32: the element itself, or an int8 one times
// the row's scale (the dequantization, one rounding)
__device__ __forceinline__ float weight_at(const float* row, int k, float) { return row[k]; }
__device__ __forceinline__ float weight_at(const int8_t* row, int k, float scale) {
    return __fmul_rn(static_cast<float>(row[k]), scale);
}

// KMAX bounds the float4s of a thread's K-slice: H <= 128 * KMAX. W is the
// type W_hh arrives in: float, or int8_t with `scale` (a gate row each).
template <int KMAX, typename W>
__global__ void __launch_bounds__(max_threads<KMAX>())
lstm_recurrence_kernel(const float* __restrict__ xp, const W* __restrict__ whh,
                       const float* __restrict__ scale,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* out, float* c_out, int T, int B, int H, int U, int b0, int nb,
                       unsigned long long* prof) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) float smem[];
    const int R = 4 * U;                     // gate rows of this block
    const int KI = (H + 4 * SLICES - 1) / (4 * SLICES);   // float4s of a K-slice
    const int HS = 4 * SLICES * KI;          // h row stride in shared memory (zero past H)
    const int nbp = (nb + BG - 1) / BG * BG; // rows of h_s: whole passes of the dot
    float* h_s = smem;                       // [nbp][HS] h of the previous step
    float* x_s = h_s + (size_t)nbp * HS;     // [2][nb][R] slices of xp[t]
    float* g_s = x_s + 2 * (size_t)nb * R;   // [nb][R] gate pre-activations
    float* c_s = g_s + (size_t)nb * R;       // [nb][U] cell state

    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int lane = tid % SLICES;           // K-slice k = 128i + 4*lane + (0..3)
    const int row0 = 2 * (tid / SLICES);     // the warp's gate rows row0, row0 + 1 (q*U + u)
    const int u0 = blockIdx.x * U;
    const int nu = min(U, H - u0);
    const size_t H4 = 4 * (size_t)H;
    // h rows move as float4 when they are 16-byte aligned
    const bool vec = (H & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(h0) & 15) == 0;

    float4 w[2][KMAX];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = (row0 + r) / U, u = (row0 + r) % U;
        const size_t grow = (size_t)q * H + u0 + u;   // the gate row of W_hh
        const W* wr = whh + grow * H;
        const float ws = (scale != nullptr && u < nu) ? scale[grow] : 0.f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = 4 * SLICES * i + 4 * lane + e;
                v[e] = (u < nu && k < H) ? weight_at(wr, k, ws) : 0.f;
            }
            w[r][i] = make_float4(v[0], v[1], v[2], v[3]);
        }
    }
    for (int i = tid; i < nb * (HS - H); i += nthr) {
        const int b = i / (HS - H);
        h_s[(size_t)b * HS + H + (i - b * (HS - H))] = 0.f;
    }
    for (int i = tid; i < nb * U; i += nthr) {
        const int b = i / U, u = i % U;
        c_s[i] = (c0 != nullptr && u < nu) ? c0[(size_t)(b0 + b) * H + u0 + u] : 0.f;
    }

    // xp[t]'s slice for this block's rows, fetched without waiting
    auto prefetch = [&](int t, float* dst) {
        for (int i = tid; i < nb * R; i += nthr) {
            const int b = i / R, r = i - b * R;
            const int q = r / U, u = r - q * U;
            const bool ok = u < nu;
            cp_async4(dst + i, ok ? xp + ((size_t)t * B + b0 + b) * H4 + (size_t)q * H + u0 + u
                                  : xp, ok);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    // nb rows of H contiguous floats (or zeros) into h_s
    auto stage_h = [&](const float* src) {
        if (src == nullptr) {
            for (int i = tid; i < nb * H; i += nthr) h_s[(size_t)(i / H) * HS + i % H] = 0.f;
        } else if (vec) {
            const float4* src4 = reinterpret_cast<const float4*>(src);
            const int n4 = nb * (H / 4), Hq = H / 4;
            for (int base = tid; base < n4; base += LB * nthr) {
                float4 v[LB];
#pragma unroll
                for (int j = 0; j < LB; ++j) {
                    const int i = base + j * nthr;
                    if (i < n4) v[j] = __ldcg(src4 + i);
                }
#pragma unroll
                for (int j = 0; j < LB; ++j) {
                    const int i = base + j * nthr;
                    if (i < n4) {
                        const int b = HS == H ? 0 : i / Hq;
                        *reinterpret_cast<float4*>(h_s + (size_t)b * HS + 4 * (i - b * Hq)) = v[j];
                    }
                }
            }
        } else {
            const int n = nb * H;
            for (int base = tid; base < n; base += LB * nthr) {
                float v[LB];
#pragma unroll
                for (int j = 0; j < LB; ++j) {
                    const int i = base + j * nthr;
                    if (i < n) v[j] = __ldcg(src + i);
                }
#pragma unroll
                for (int j = 0; j < LB; ++j) {
                    const int i = base + j * nthr;
                    if (i < n) h_s[(size_t)(i / H) * HS + i % H] = v[j];
                }
            }
        }
    };

    const bool stamp = prof != nullptr && blockIdx.x == 0 && tid == 0;
    unsigned long long st[4] = {0, 0, 0, 0}, s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    const unsigned long long start = clock64();

    prefetch(0, x_s);
    for (int t = 0; t < T; ++t) {
        if (stamp) { s0 = clock64(); if (t) st[3] += s0 - s3; }
        stage_h(t ? out + ((size_t)(t - 1) * B + b0) * H
                  : (h0 != nullptr ? h0 + (size_t)b0 * H : nullptr));
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // xp[t] is in
        __syncthreads();
        if (stamp) { s1 = clock64(); st[0] += s1 - s0; }
        if (t + 1 < T) prefetch(t + 1, x_s + (size_t)((t + 1) & 1) * nb * R);

        const float* xc = x_s + (size_t)(t & 1) * nb * R;
        for (int bg = 0; bg < nb; bg += BG) {
            // a pass over up to 16 batch rows, at the next power of two
            const int nbg = min(BG, nb - bg);
            const float* hb = h_s + (size_t)bg * HS + 4 * lane;
            float v;
            int width;
            if (nbg > 8) { v = gate_dot<16>(w, KI, hb, HS, lane); width = 16; }
            else if (nbg > 4) { v = gate_dot<8>(w, KI, hb, HS, lane); width = 8; }
            else if (nbg > 2) { v = gate_dot<4>(w, KI, hb, HS, lane); width = 4; }
            else if (nbg > 1) { v = gate_dot<2>(w, KI, hb, HS, lane); width = 2; }
            else { v = gate_dot<1>(w, KI, hb, HS, lane); width = 1; }
            const int b = bg + lane % width;
            const int row = row0 + lane / width % 2;
            if (lane < 2 * width && b < nb) g_s[b * R + row] = v + xc[b * R + row];
        }
        __syncthreads();
        if (stamp) { s2 = clock64(); st[1] += s2 - s1; }

        for (int i = tid; i < nb * U; i += nthr) {
            const int b = i / U, u = i % U;
            if (u < nu) {
                const float* g = g_s + b * R;
                const float ig = sigmoid(g[u]);
                const float fg = sigmoid(g[U + u]);
                const float gg = tanhf(g[2 * U + u]);
                const float og = sigmoid(g[3 * U + u]);
                const float c = fg * c_s[i] + ig * gg;
                c_s[i] = c;
                out[((size_t)t * B + b0 + b) * H + u0 + u] = og * tanhf(c);
            }
        }
        if (stamp) { s3 = clock64(); st[2] += s3 - s2; }
        grid.sync();
    }
    if (c_out != nullptr) {   // each thread writes the cells it updated
        for (int i = tid; i < nb * U; i += nthr) {
            const int b = i / U, u = i % U;
            if (u < nu) c_out[(size_t)(b0 + b) * H + u0 + u] = c_s[i];
        }
    }
    if (stamp) {
        const unsigned long long end = clock64();
        st[3] += end - s3;
        for (int i = 0; i < 4; ++i) prof[i] += st[i];
        prof[4] += end - start;
    }
}

// What the host entry needs to know of a device, read once per device: the
// SM count, cooperative-launch support and the opt-in shared-memory limit.
struct DeviceInfo {
    int sms = 0, coop = 0, max_smem = 0;
};

std::mutex info_mutex;
DeviceInfo infos[MAX_DEVICES];

cudaError_t device_info(int device, DeviceInfo* out) {
    std::lock_guard<std::mutex> lock(info_mutex);
    DeviceInfo& d = infos[device];
    if (d.sms == 0) {
        DeviceInfo n;
        cudaError_t err;
        if ((err = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, device)) ||
            (err = cudaDeviceGetAttribute(&n.coop, cudaDevAttrCooperativeLaunch, device)) ||
            (err = cudaDeviceGetAttribute(&n.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                          device)))
            return err;
        d = n;
    }
    *out = d;
    return cudaSuccess;
}

// Raises the instantiation's shared-memory attribute to the opt-in limit
// once per device, then answers how many blocks of `threads` threads and
// `smem` bytes an SM holds, each answer cached per device.
template <int KMAX, typename W>
cudaError_t blocks_per_sm(int device, const DeviceInfo& d, int threads, size_t smem,
                          int* per_sm) {
    static std::mutex mutex;
    static bool configured[MAX_DEVICES];
    static std::map<std::pair<int, size_t>, int> cache[MAX_DEVICES];
    std::lock_guard<std::mutex> lock(mutex);
    if (!configured[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            lstm_recurrence_kernel<KMAX, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            d.max_smem);
        if (err != cudaSuccess) return err;
        configured[device] = true;
    }
    const auto key = std::make_pair(threads, smem);
    auto it = cache[device].find(key);
    if (it == cache[device].end()) {
        int n = 0;
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, lstm_recurrence_kernel<KMAX, W>, threads, smem);
        if (err != cudaSuccess) return err;
        it = cache[device].emplace(key, n).first;
    }
    *per_sm = it->second;
    return cudaSuccess;
}

template <int KMAX, typename W>
cudaError_t launch(const float* xp, const W* whh, const float* scale, const float* h0,
                   const float* c0, float* out, float* c_out, int T, int B, int H, int device,
                   const DeviceInfo& d, cudaStream_t stream, unsigned long long* prof) {
    const int U = (H + d.sms - 1) / d.sms;
    const int blocks = (H + U - 1) / U;
    const int threads = SLICES * 2 * U;   // a warp a pair of the 4U gate rows
    if (threads > max_threads<KMAX>()) return cudaErrorInvalidValue;
    // h_s holds whole passes of BG rows; the rest of the shared memory is per row
    const size_t h_row =
        sizeof(float) * 4 * SLICES * (size_t)((H + 4 * SLICES - 1) / (4 * SLICES));
    const size_t per_row = h_row + sizeof(float) * 13 * (size_t)U;
    const int nb_max = (int)((size_t)d.max_smem / per_row) / BG * BG;
    if (nb_max < BG) return cudaErrorInvalidValue;

    for (int b0 = 0; b0 < B; b0 += nb_max) {
        int nb = B - b0 < nb_max ? B - b0 : nb_max;
        const size_t smem = nb * per_row + (size_t)((nb + BG - 1) / BG * BG - nb) * h_row;
        int per_sm = 0;
        cudaError_t err = blocks_per_sm<KMAX, W>(device, d, threads, smem, &per_sm);
        if (err != cudaSuccess) return err;
        if (per_sm * d.sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
        int T_ = T, B_ = B, H_ = H, U_ = U, b0_ = b0, nb_ = nb;
        void* args[] = {(void*)&xp, (void*)&whh, (void*)&scale, (void*)&h0, (void*)&c0,
                        (void*)&out, (void*)&c_out, &T_, &B_, &H_, &U_, &b0_, &nb_,
                        (void*)&prof};
        err = cudaLaunchCooperativeKernel((void*)lstm_recurrence_kernel<KMAX, W>, dim3(blocks),
                                          dim3(threads), args, smem, stream);
        if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
}

template <typename W>
cudaError_t recurrence(const float* xp, const W* whh, const float* scale, const float* h0,
                       const float* c0, float* out, float* c_out, int T, int B, int H,
                       int device, void* stream, unsigned long long* prof) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (T <= 0 || B <= 0) return cudaSuccess;   // the wrapper handles T = 0
    if (H <= 0 || H > 1024) return cudaErrorInvalidValue;
    DeviceInfo d;
    if ((err = device_info(device, &d))) return err;
    if (!d.coop) return cudaErrorNotSupported;
    const auto s = static_cast<cudaStream_t>(stream);
    const int ki = (H + 4 * SLICES - 1) / (4 * SLICES);
#define LSTM_LAUNCH(KMAX) \
    return launch<KMAX, W>(xp, whh, scale, h0, c0, out, c_out, T, B, H, device, d, s, prof)
    if (ki <= 1) LSTM_LAUNCH(1);
    if (ki <= 2) LSTM_LAUNCH(2);
    if (ki <= 4) LSTM_LAUNCH(4);
    LSTM_LAUNCH(8);
#undef LSTM_LAUNCH
}

}  // namespace

// xp [T, B, 4H], whh [4H, H], h0 and c0 [B, H] or null (f32, contiguous, on
// `device`; H <= 1024); writes out [T, B, H] and, when c_out is not null,
// c_out [B, H]. prof, when not null, is 5 counters of SM clock cycles that
// block 0 adds to: staging h[t-1] (and waiting for xp[t]), the gate dot, the
// cell update, the wait at the grid barrier, and the whole kernel (a step's
// breakdown; null on the main path). Launches on `stream`; returns a
// cudaError_t.
extern "C" int encodec_lstm_recurrence_f32(const float* xp, const float* whh, const float* h0,
                                           const float* c0, float* out, float* c_out,
                                           int T, int B, int H, int device, void* stream,
                                           unsigned long long* prof) {
    return recurrence<float>(xp, whh, nullptr, h0, c0, out, c_out, T, B, H, device, stream,
                             prof);
}

// The same with W_hh int8 [4H, H] and its f32 scale a gate row [4H] (the
// int8 twin's weights): the f32 kernel's output on q * scale, bit for bit.
extern "C" int encodec_lstm_recurrence_i8w(const float* xp, const int8_t* whh,
                                           const float* scale, const float* h0,
                                           const float* c0, float* out, float* c_out,
                                           int T, int B, int H, int device, void* stream,
                                           unsigned long long* prof) {
    return recurrence<int8_t>(xp, whh, scale, h0, c0, out, c_out, T, B, H, device, stream,
                              prof);
}
