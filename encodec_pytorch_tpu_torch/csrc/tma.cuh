// Hopper's asynchronous copies, shared by the kernels: mbarriers, TMA bulk
// copies (1-D) and tensor copies (2-D boxes through a CUtensorMap).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// make the barriers' initialisation visible to the TMA unit and the cluster
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global into
// this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// the 2-D box of `map` at (column x0, row y0) into this CTA's shared memory
// (128-byte aligned; 1024 with the 128-byte swizzle), completing on `bar`;
// the parts of the box outside the tensor are zeros
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x0, int y0,
                                            unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(x0), "r"(y0),
          "r"(smem_u32(bar))
        : "memory");
}

// The tensor map of a row-major matrix [rows][cols] of elem_bytes-byte
// elements (4: f32; 1: int8, copied as its bytes) (16-byte aligned, rows of
// a multiple of 16 bytes) read in boxes of box_cols x box_rows (box_cols x
// elem_bytes a multiple of 16), with or without the 128-byte swizzle. Maps
// are kept by (base, element size, shape, box, swizzle), so a caller that
// hands in the same cached weights call after call encodes once
// (csrc/common.cu).
cudaError_t encodec_tensor_map_2d_bytes(const void* base, int elem_bytes, int rows, int cols,
                                        int box_rows, int box_cols, bool swizzle128,
                                        CUtensorMap* out);

inline cudaError_t encodec_tensor_map_2d(const float* base, int rows, int cols, int box_rows,
                                         int box_cols, bool swizzle128, CUtensorMap* out) {
    return encodec_tensor_map_2d_bytes(base, 4, rows, cols, box_rows, box_cols, swizzle128,
                                       out);
}

inline cudaError_t encodec_tensor_map_2d(const int8_t* base, int rows, int cols, int box_rows,
                                         int box_cols, bool swizzle128, CUtensorMap* out) {
    return encodec_tensor_map_2d_bytes(base, 1, rows, cols, box_rows, box_cols, swizzle128,
                                       out);
}
