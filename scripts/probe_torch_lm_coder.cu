// Instruments for scripts/probe_torch_lm_coder.py, built by it alone (never
// into the library): the kernel K6 with its clock64 stamps on, a check of
// its branch-free quantization against IEEE division, a microbenchmark of
// dependent-operation latencies for one warp, and an encode as two launches
// at any length (to time against K6's one launch of a short encode).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -shared -o libk6_probe.so scripts/probe_torch_lm_coder.cu
#define K6_STAMPS
#include "../encodec_pytorch_tpu_torch/csrc/lm_coder.cu"

namespace {

// quantize_fast against quantize on `count` float32 bit patterns from
// `first`, at `scale`, for the bins where !needs_exact: the mismatches into
// `bad`, the lowest such pattern into `example`
__global__ void check_quantize_kernel(unsigned first, unsigned long long count, float scale,
                                      unsigned long long* bad, unsigned* example) {
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
        const unsigned bits = first + (unsigned)i;
        const float p = __uint_as_float(bits);
        if (needs_exact(p)) continue;
        if (quantize_fast(p, scale) != quantize(p, scale)) {
            atomicAdd(bad, 1ull);
            atomicMin(example, bits);
        }
    }
}

// One warp's cycles for `iters` links of a dependent chain of one kind of
// operation: 0 integer add, 1 32 x 32 -> 64-bit product, 2 shared load
// (pointer chase), 3 shuffle, 4 ballot + popc, 5 a stamp, 6 clz, 7 acquire
// load from shared memory, 8 uint64 product, 9 float multiply, 10 an add
// and a uniform branch taken every link
template <int OP>
__global__ void latency_kernel(int iters, int seed, long long* out) {
    __shared__ int chase[64];
    const int lane = threadIdx.x;
    for (int i = lane; i < 64; i += 32) chase[i] = (i + 1) & 63;
    __syncwarp();
    int x = seed + lane;
    u64 y = (u64)seed + 3;
    float f = 1.0f + seed;
    const long long start = clock64();
#pragma unroll 8
    for (int i = 0; i < iters; ++i) {
        if (OP == 0) x = x + (x >> 3) + 1;
        if (OP == 1) y = (u64)(unsigned)y * (unsigned)(y >> 7 | 1);
        if (OP == 2) x = chase[x & 63];
        if (OP == 3) x = __shfl_sync(FULL, x, (x + 1) & 31);
        if (OP == 4) x = __popc(__ballot_sync(FULL, x > lane));
        if (OP == 5) K6_STAMP(120);
        if (OP == 6) x = __clz(x) + 1;
        if (OP == 7) x = load_acquire(&chase[x & 63]);
        if (OP == 8) y = y * (y | 1);
        if (OP == 9) f = f * 1.0000001f;
        if (OP == 10) {
            x = x + 1;
            if (x & seed) x ^= 5;     // uniform (seed 1: every other link)
        }
    }
    const long long end = clock64();
    if (lane == 0) out[0] = end - start, out[1] = x + (long long)y + (long long)f;
}

}  // namespace

// the stamps of the last decode launch: [0] the CTA's start, [1] the coder's,
// [2] the coder's state and window loaded, [3] its end, [4 + 2r] row r built
// (its wait over), [5 + 2r] row r coded (r < 18), [64 + r] / [96 + r] a
// producer starting / ending row r (r < 32)
extern "C" int encodec_lm_coder_stamps(long long* out) {
    return cudaMemcpyFromSymbol(out, k6_stamps, sizeof(k6_stamps));
}

// the mismatches of quantize_fast against quantize over every float32 bit
// pattern at `scale` (and the lowest pattern that mismatches), synchronously
extern "C" int encodec_lm_coder_check_quantize(float scale, unsigned long long* bad,
                                               unsigned* example) {
    unsigned long long* d_bad = nullptr;
    unsigned* d_example = nullptr;
    cudaError_t err = cudaMalloc(&d_bad, sizeof(*d_bad));
    if (err == cudaSuccess) err = cudaMalloc(&d_example, sizeof(*d_example));
    if (err == cudaSuccess) err = cudaMemset(d_bad, 0, sizeof(*d_bad));
    if (err == cudaSuccess) err = cudaMemset(d_example, 0xff, sizeof(*d_example));
    if (err == cudaSuccess) {
        check_quantize_kernel<<<132 * 8, 256>>>(0u, 1ull << 32, scale, d_bad, d_example);
        err = cudaDeviceSynchronize();
    }
    if (err == cudaSuccess) err = cudaMemcpy(bad, d_bad, sizeof(*bad), cudaMemcpyDeviceToHost);
    if (err == cudaSuccess)
        err = cudaMemcpy(example, d_example, sizeof(*example), cudaMemcpyDeviceToHost);
    cudaFree(d_bad);
    cudaFree(d_example);
    return err;
}

// the cycles of latency_kernel's chain of `iters` links of kind `op`, synchronously
extern "C" int encodec_lm_coder_latency(int op, int iters, long long* cycles) {
    long long* d = nullptr;
    cudaError_t err = cudaMalloc(&d, 2 * sizeof(long long));
    if (err == cudaSuccess) {
        void (*kernels[])(int, int, long long*) = {
            latency_kernel<0>, latency_kernel<1>, latency_kernel<2>, latency_kernel<3>,
            latency_kernel<4>, latency_kernel<5>, latency_kernel<6>, latency_kernel<7>,
            latency_kernel<8>, latency_kernel<9>, latency_kernel<10>};
        if (op < 0 || op > 10) return cudaErrorInvalidValue;
        kernels[op]<<<1, 32>>>(iters, 1, d);
        err = cudaDeviceSynchronize();
    }
    if (err == cudaSuccess) err = cudaMemcpy(cycles, d, sizeof(long long), cudaMemcpyDeviceToHost);
    cudaFree(d);
    return err;
}

// An encode of `rows` symbols as two launches whatever their number: the CDF
// pairs into `scratch` (int32 [rows, 2]) on many CTAs, then one coder warp,
// as K6 encodes more than ENCODE_FUSED_ROWS symbols
extern "C" int encodec_lm_coder_encode_two(const float* pdfs, int rows, int card, float scale,
                                           const int* syms, long long* state,
                                           unsigned char* bits, long long cap_bits, int finish,
                                           int* scratch, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    int2* pairs = reinterpret_cast<int2*>(scratch);
    const bool vec = (reinterpret_cast<uintptr_t>(pdfs) & 15) == 0 && card % 4 == 0;
    const int grid = (rows + PAIR_WARPS - 1) / PAIR_WARPS;
    if (rows > 0 && vec)
        pairs_kernel<true><<<grid, 32 * PAIR_WARPS, 0, s>>>(pdfs, rows, card, scale, syms, pairs,
                                                             state);
    else if (rows > 0)
        pairs_kernel<false><<<grid, 32 * PAIR_WARPS, 0, s>>>(pdfs, rows, card, scale, syms,
                                                              pairs, state);
    encode_kernel<<<1, 32, 0, s>>>(pairs, rows, state, bits, cap_bits, finish);
    return cudaGetLastError();
}
