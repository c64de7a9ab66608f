// Blocked int4 dequantize-then-dot GeMM for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel repro/kernels/int4_matmul.py::int4_matmul_pallas (its
// fused grid, _kernel_fused, and, with the identity epilogue, its legacy
// grid, _kernel_legacy; both share _dequant_dot).  The design and its
// bound are described in repro_torch/kernels/int4_matmul.py.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libint4_matmul.so int4_matmul.cu
// Plain C interface, loaded with ctypes.
//
// Work split.  A block of 8 warps owns 32 output rows (4 per warp) and TB
// batch columns.  It walks k in tiles of tk (a multiple of 256): the x tile
// goes to shared memory once, permuted so that lane L's codes read
// consecutive words; then for every 256 codes of the tile each lane loads
// 4 packed bytes (8 codes) of each of its warp's 4 rows and, per code,
//   w = b(code) * scale[row, k / scale_block]     (scale before the dot)
//   acc[row][col] = acc + w * x[k][col]           (separate _rn mul, add)
// Lane L thus sums the codes k = 256*S + 8*L + t (t = 0..7) in k order.
// The 32 lane sums are added by an xor-shuffle tree (16, 8, 4, 2, 1), and
// lane 0 applies the epilogue cast(act(acc + bias) + residual).  The plain
// PyTorch version repeats exactly these sums, so the two agree bit for bit
// except inside gelu/silu's tanh/exp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

struct Params {
  const uint8_t* u8;     // (m, kb) packed codes, kb = ceil(k / 2)
  const float* scales;   // (m, nsb) row-major
  const float* x;        // x[row * xs_k + col * xs_b], row < k
  const float* bias;     // (m,) or null
  const float* res;      // res[row * rs_m + col * rs_b] or null
  void* out;             // out[row * os_m + col * os_b]
  int m, k, kb, b, nsb, scale_block, tk;
  long long xs_k, xs_b, rs_m, rs_b, os_m, os_b;
  int act, out_type;
};

// 4 packed bytes of a row starting at byte jb, zero past the row's end
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int jb,
                                              int kb) {
  if (VEC && jb + 4 <= kb) {
    return __ldg(reinterpret_cast<const uint32_t*>(row + jb));
  }
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (jb + q < kb) w |= static_cast<uint32_t>(__ldg(row + jb + q)) << (8 * q);
  }
  return w;
}

template <int TB, bool VEC>
__global__ void __launch_bounds__(kThreads)
int4_kernel(const Params p) {
  extern __shared__ __align__(16) float xs[];  // [TB][tk/256][8][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int col0 = blockIdx.y * TB;

  float acc[kRowsPerWarp][TB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < TB; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = 0; t0 < p.k; t0 += p.tk) {
    const int tlen = min(p.tk, p.k - t0);
    __syncthreads();  // the previous tile is consumed
    // x tile, permuted: element (S, t, L) holds local k = 256 S + 8 L + t
    for (int e = threadIdx.x; e < TB * p.tk; e += kThreads) {
      const int c = e / p.tk;
      const int rem = e - c * p.tk;
      const int kl = (rem & ~255) + ((rem & 31) << 3) + ((rem >> 5) & 7);
      const int col = col0 + c;
      xs[e] = (kl < tlen && col < p.b)
                  ? p.x[(t0 + kl) * p.xs_k + col * p.xs_b] : 0.0f;
    }
    __syncthreads();
    for (int s = 0; s * 256 < tlen; ++s) {
      const int kbase = t0 + s * 256 + lane * 8;  // this lane's first code
      uint32_t word[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = row0 + r;
        word[r] = row < p.m
            ? load_word<VEC>(p.u8 + static_cast<long long>(row) * p.kb,
                             kbase >> 1, p.kb)
            : 0u;
      }
      if (kbase >= p.k) continue;
      int si = kbase / p.scale_block;
      int bound = (si + 1) * p.scale_block;
      float sc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = row0 + r;
        sc[r] = row < p.m ? p.scales[static_cast<long long>(row) * p.nsb + si]
                          : 0.0f;
      }
      const float* xt = xs + s * 256 + lane;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int kk = kbase + t;
        if (kk >= p.k) break;
        if (kk >= bound) {  // the next scale block starts inside the word
          ++si;
          bound += p.scale_block;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const int row = row0 + r;
            sc[r] = row < p.m
                ? p.scales[static_cast<long long>(row) * p.nsb + si] : 0.0f;
          }
        }
        float xv[TB];
#pragma unroll
        for (int c = 0; c < TB; ++c) xv[c] = xt[c * p.tk + t * 32];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int byte = (word[r] >> (8 * (t >> 1))) & 0xFF;
          const int code = (t & 1) ? (byte & 15) : (byte >> 4);  // hi first
          const float w = __fmul_rn(
              static_cast<float>(code <= 7 ? code : code - 16), sc[r]);
#pragma unroll
          for (int c = 0; c < TB; ++c) {
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(w, xv[c]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < TB; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[r][c] = __fadd_rn(acc[r][c],
                              __shfl_xor_sync(0xffffffffu, acc[r][c], o));
      }
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= p.m) continue;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      const int col = col0 + c;
      if (col >= p.b) continue;
      epi::finish(acc[r][c], p.bias != nullptr, p.bias ? p.bias[row] : 0.0f,
                  p.act, p.res != nullptr,
                  p.res ? p.res[row * p.rs_m + col * p.rs_b] : 0.0f, p.out,
                  row * p.os_m + col * p.os_b, p.out_type);
    }
  }
}

template <int TB>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TB) * p.tk * sizeof(float);
  void (*kern)(const Params) =
      vec ? &int4_kernel<TB, true> : &int4_kernel<TB, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.m + kRowsPerBlock - 1) / kRowsPerBlock,
                  (p.b + TB - 1) / TB);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int4_matmul_launch(
    const uint8_t* u8, const float* scales, const float* x, const float* bias,
    const float* res, void* out, int m, int k, int kb, int b, int nsb,
    int scale_block, int tk, int tb, int vec, long long xs_k, long long xs_b,
    long long rs_m, long long rs_b, long long os_m, long long os_b, int act,
    int out_type, void* stream) {
  Params p{u8, scales, x, bias, res, out, m, k, kb, b, nsb, scale_block, tk,
           xs_k, xs_b, rs_m, rs_b, os_m, os_b, act, out_type};
  if (tk <= 0 || tk % 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tb) {
    case 1: err = launch<1>(p, vec != 0, s); break;
    case 2: err = launch<2>(p, vec != 0, s); break;
    case 4: err = launch<4>(p, vec != 0, s); break;
    case 8: err = launch<8>(p, vec != 0, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
