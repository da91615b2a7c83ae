// Shared entry points of the port's kernel library: CUDA error strings, and
// the tensor maps the kernels' TMA copies read (tma.cuh).
#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

#include "tma.cuh"

extern "C" const char* encodec_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

// cuTensorMapEncodeTiled, a libcuda function, found through the runtime (no link to
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    static std::once_flag once;
    std::call_once(once, [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
                == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    });
    return fn;
}

}  // namespace

cudaError_t encodec_tensor_map_2d_bytes(const void* base, int elem_bytes, int rows, int cols,
                                        int box_rows, int box_cols, bool swizzle128,
                                        CUtensorMap* out) {
    struct Entry {
        const void* base;
        int elem_bytes, rows, cols, box_rows, box_cols;
        bool swizzle128;
        CUtensorMap map;
    };
    // the 24 kHz model's 8 resblocks x 3 maps, f32 and int8 twins, and K1's
    constexpr int SLOTS = 96;
    static Entry cache[SLOTS];
    static int used = 0, next = 0;
    static std::mutex lock;
    std::lock_guard<std::mutex> guard(lock);
    for (int i = 0; i < used; ++i) {
        const Entry& e = cache[i];
        if (e.base == base && e.elem_bytes == elem_bytes && e.rows == rows && e.cols == cols
            && e.box_rows == box_rows && e.box_cols == box_cols && e.swizzle128 == swizzle128) {
            *out = e.map;
            return cudaSuccess;
        }
    }
    if (elem_bytes != 4 && elem_bytes != 1) return cudaErrorInvalidValue;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    Entry e{base, elem_bytes, rows, cols, box_rows, box_cols, swizzle128, {}};
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t steps[2] = {1, 1};
    if (encode(&e.map,
               elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
               2, const_cast<void*>(base), dims, strides, box, steps,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
        != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    cache[next] = e;
    next = (next + 1) % SLOTS;
    if (used < SLOTS) ++used;
    *out = e.map;
    return cudaSuccess;
}
