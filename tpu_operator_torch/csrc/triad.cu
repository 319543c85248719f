// Kernel B1: the STREAM triad a = a + alpha * b, written in place over a.
//
// Replaces tpu_operator/workloads/pallas_probe.py `_triad_kernel` / `triad`,
// the Pallas kernel that streams row blocks HBM -> VMEM with its output
// aliased over `a` (input_output_aliases={0: 0}).
//
// Bound: device memory. Each element reads a and b and writes a, 12 bytes
// for one fused multiply-add, far below the ~295 operations per byte where
// an H100 stops being memory-bound. At the validator's 512 MB shape
// ([31232, 4096] f32, 127.9M elements) one launch moves 1.535 GB: about
// 0.46 ms at the H100 SXM's 3.35 TB/s.
//
// What the design does about that bound:
// - wide, coalesced accesses: each thread moves one 16-byte float4 of a and
//   of b, neighbouring threads on neighbouring addresses, and the grid
//   covers the whole array, so every SM keeps as many loads in flight as
//   its thread slots allow (a grid capped at a few blocks per SM, each
//   thread looping, was slower on the H100);
// - in place: the result goes back over a, so there is no third buffer to
//   read or write, and chained launches need no copy.
// A scalar loop takes a ragged tail, and the whole array when either
// pointer is not 16-byte aligned. The TPU kernel's `cols % 128` and
// `block_rows % 8` checks are tiling artefacts and are not carried over:
// any contiguous f32 length is taken.
//
// Rounding: __fmaf_rn(alpha, b, a), one rounding. That is what the Pallas
// kernel gives (checked in interpret mode) and what torch's
// a.add_(b, alpha=alpha) gives; a + alpha * b rounded twice differs.
//
// Launches on the caller's stream and does not synchronise. The C entry
// point returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x limit

// Both kernels loop over a grid stride only past kMaxBlocks * kThreads
// elements; below that each thread handles one element (or float4).

__global__ void __launch_bounds__(kThreads)
triad_vec4(float4* __restrict__ a, const float4* __restrict__ b,
           float alpha, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 x = a[i];
    const float4 y = b[i];
    x.x = __fmaf_rn(alpha, y.x, x.x);
    x.y = __fmaf_rn(alpha, y.y, x.y);
    x.z = __fmaf_rn(alpha, y.z, x.z);
    x.w = __fmaf_rn(alpha, y.w, x.w);
    a[i] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
triad_scalar(float* __restrict__ a, const float* __restrict__ b,
             float alpha, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    a[i] = __fmaf_rn(alpha, b[i], a[i]);
  }
}

unsigned grid_for(int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < kMaxBlocks ? need : kMaxBlocks);
}

}  // namespace

// a[0:n] = fma(alpha, b[0:n], a[0:n]) on `stream`; returns a cudaError_t.
extern "C" int triad_f32(void* a, const void* b, float alpha, int64_t n,
                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(a);
  const float* pb = static_cast<const float*>(b);
  int64_t done = 0;
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(pa) |
                              reinterpret_cast<uintptr_t>(pb);
  if ((addr_bits & 15) == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      triad_vec4<<<grid_for(n4), kThreads, 0, s>>>(
          reinterpret_cast<float4*>(pa), reinterpret_cast<const float4*>(pb),
          alpha, n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    triad_scalar<<<grid_for(n - done), kThreads, 0, s>>>(
        pa + done, pb + done, alpha, n - done);
  }
  return static_cast<int>(cudaGetLastError());
}
