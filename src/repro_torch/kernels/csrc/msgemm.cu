// msGeMM for Hopper (sm_90a): paper Eq. 5 with §3.3 factored scales and a
// fused epilogue.  Replaces the Pallas TPU kernel
// repro/kernels/msgemm.py::msgemm_pallas (both its fused and its legacy
// grid; with the identity epilogue this kernel computes the legacy one).
// The design and its bound are described in repro_torch/kernels/msgemm.py.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libmsgemm.so msgemm.cu
// Plain C interface, loaded with ctypes.
//
// Work split.  A block owns TM = 256*RPT output rows, TB batch columns and
// a contiguous range of `split_chunks` LUT chunks (a whole number of scale
// blocks).  For each chunk j of its range it
//   1. builds the LUT column tile L[n, c] = sum_r C(code_r(n)) * x[j*d+r, c]
//      (16^d entries x TB columns) once, in shared memory (device-memory
//      scratch for d = 4, whose 16^4 table does not fit),
//   2. lets every row gather L[idx[row, j], :] into its running block sum,
//   3. at the end of each scale block multiplies that sum once by the
//      block's scale and adds it into the row's f32 accumulator.
// With one split the epilogue runs at the end of the block; with several,
// each split writes its partial sums and a second kernel adds them in split
// (= j) order and applies the epilogue.
//
// Op order per output element, kept bit-identical to the plain PyTorch
// version by using the _rn intrinsics (no FMA contraction):
//   entry = ((C0*x0) + C1*x1) + ...          in r order
//   part  = ((0 + g_0) + g_1) + ...          gathers of one scale block
//   acc   = acc + part * scale               once per scale block
//   total = ((acc_split0 + acc_split1) + ...)
//   out   = cast(act(total + bias) + residual)

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  const int32_t* idx;     // (m, kc) row-major LUT indices
  const float* x;         // x[row * xs_k + col * xs_b], row < k
  const float* scales;    // (m, nsb) row-major
  const float* values;    // (16,) code -> value (int4 grid or codebook)
  const float* bias;      // (m,) or null
  const float* res;       // res[row * rs_m + col * rs_b] or null
  void* out;              // out[row * os_m + col * os_b]
  float* ws;              // (nsplit, m, b) partial sums when nsplit > 1
  float* lut_scratch;     // one 16^d x TB table per block when d == 4
  int m, k, kc, b, cpb, nsb, split_chunks, nsplit;
  long long xs_k, xs_b, rs_m, rs_b, os_m, os_b;
  int act, out_type;
};

__device__ __forceinline__ void finish(const Params& p, int row, int col,
                                       float acc) {
  epi::finish(acc, p.bias != nullptr, p.bias ? p.bias[row] : 0.0f, p.act,
              p.res != nullptr,
              p.res ? p.res[row * p.rs_m + col * p.rs_b] : 0.0f, p.out,
              row * p.os_m + col * p.os_b, p.out_type);
}

template <int D, int TB, int RPT, bool SMEM_LUT>
__global__ void __launch_bounds__(kThreads)
msgemm_kernel(const Params p) {
  constexpr int N = 1 << (4 * D);
  extern __shared__ __align__(16) float smem[];
  float* prod = smem;  // [D][16][TB]: C(code) * x[j*D + r, col0 + c]
  float* lut;
  if constexpr (SMEM_LUT) {
    lut = smem + D * 16 * TB;
  } else {
    const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y +
                        blockIdx.y) * gridDim.x + blockIdx.x;
    lut = p.lut_scratch + blk * N * TB;
  }

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kThreads * RPT;
  const int split = blockIdx.y;
  const int col0 = blockIdx.z * TB;
  const int j_begin = split * p.split_chunks;
  const int j_end = min(j_begin + p.split_chunks, p.kc);

  float acc[RPT][TB];
  float part[RPT][TB];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      acc[r][c] = 0.0f;
      part[r][c] = 0.0f;
    }
  }

  for (int j = j_begin; j < j_end; ++j) {
    // ---- produce: the D x 16 x TB products, then the 16^D x TB table
    for (int e = tid; e < D * 16 * TB; e += kThreads) {
      const int c = e % TB;
      const int code = (e / TB) % 16;
      const int r = e / (16 * TB);
      const int xr = j * D + r;
      const int col = col0 + c;
      const float xv = (xr < p.k && col < p.b)
                           ? p.x[xr * p.xs_k + col * p.xs_b] : 0.0f;
      prod[e] = __fmul_rn(p.values[code], xv);
    }
    __syncthreads();
    for (int e = tid; e < N * TB; e += kThreads) {
      const int c = e % TB;
      const int n = e / TB;
      float v = prod[((n >> (4 * (D - 1))) & 15) * TB + c];
#pragma unroll
      for (int r = 1; r < D; ++r) {
        v = __fadd_rn(v, prod[(r * 16 + ((n >> (4 * (D - 1 - r))) & 15)) * TB + c]);
      }
      lut[e] = v;
    }
    __syncthreads();

    // ---- consume: every row of the tile gathers from the shared table
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = m0 + r * kThreads + tid;
      if (row < p.m) {
        const int n = __ldg(p.idx + static_cast<long long>(row) * p.kc + j);
        const float* ent = lut + n * TB;
        if constexpr (TB % 4 == 0) {
#pragma unroll
          for (int q = 0; q < TB / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(ent)[q];
            part[r][4 * q + 0] = __fadd_rn(part[r][4 * q + 0], v.x);
            part[r][4 * q + 1] = __fadd_rn(part[r][4 * q + 1], v.y);
            part[r][4 * q + 2] = __fadd_rn(part[r][4 * q + 2], v.z);
            part[r][4 * q + 3] = __fadd_rn(part[r][4 * q + 3], v.w);
          }
        } else {
#pragma unroll
          for (int c = 0; c < TB; ++c) part[r][c] = __fadd_rn(part[r][c], ent[c]);
        }
      }
    }
    // ---- §3.3: one scale multiply per scale block
    if ((j + 1) % p.cpb == 0 || j + 1 == p.kc) {
      const int blk = j / p.cpb;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = m0 + r * kThreads + tid;
        if (row < p.m) {
          const float s = p.scales[static_cast<long long>(row) * p.nsb + blk];
#pragma unroll
          for (int c = 0; c < TB; ++c) {
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(part[r][c], s));
            part[r][c] = 0.0f;
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites prod and lut
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = m0 + r * kThreads + tid;
    if (row >= p.m) continue;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      const int col = col0 + c;
      if (col >= p.b) continue;
      if (p.nsplit == 1) {
        finish(p, row, col, acc[r][c]);
      } else {
        p.ws[(static_cast<long long>(split) * p.m + row) * p.b + col] = acc[r][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const Params p) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long mb = static_cast<long long>(p.m) * p.b;
  if (e >= mb) return;
  float t = p.ws[e];
  for (int s = 1; s < p.nsplit; ++s) t = __fadd_rn(t, p.ws[s * mb + e]);
  finish(p, static_cast<int>(e / p.b), static_cast<int>(e % p.b), t);
}

template <int D, int TB, int RPT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr bool kSmem = D < 4;
  constexpr int N = 1 << (4 * D);
  const size_t smem = (static_cast<size_t>(D) * 16 * TB + (kSmem ? N * TB : 0)) * sizeof(float);
  auto kern = msgemm_kernel<D, TB, RPT, kSmem>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.m + kThreads * RPT - 1) / (kThreads * RPT), p.nsplit,
                  (p.b + TB - 1) / TB);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int TB>
cudaError_t launch_rpt(const Params& p, int rpt, cudaStream_t stream) {
  if (rpt == 2) return launch<D, TB, 2>(p, stream);
  if (rpt == 8) return launch<D, TB, 8>(p, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tb(const Params& p, int tb, int rpt, cudaStream_t stream) {
  if (tb == 1) return launch_rpt<D, 1>(p, rpt, stream);
  if (tb == 4) return launch_rpt<D, 4>(p, rpt, stream);
  if (tb == 8) return launch_rpt<D, 8>(p, rpt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int msgemm_launch(
    const int32_t* idx, const float* x, const float* scales,
    const float* values, const float* bias, const float* res, void* out,
    float* ws, float* lut_scratch, int m, int k, int kc, int b, int d,
    int cpb, int nsb, int split_chunks, int nsplit, int tb, int rpt,
    long long xs_k, long long xs_b, long long rs_m, long long rs_b,
    long long os_m, long long os_b, int act, int out_type, void* stream) {
  Params p{idx, x, scales, values, bias, res, out, ws, lut_scratch,
           m, k, kc, b, cpb, nsb, split_chunks, nsplit,
           xs_k, xs_b, rs_m, rs_b, os_m, os_b, act, out_type};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 1: err = launch_tb<1>(p, tb, rpt, s); break;
    case 2: err = launch_tb<2>(p, tb, rpt, s); break;
    case 3: err = launch_tb<3>(p, tb, rpt, s); break;
    case 4: err = launch_tb<4>(p, tb, rpt, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsplit > 1) {
    const long long mb = static_cast<long long>(m) * b;
    reduce_kernel<<<static_cast<unsigned>((mb + kThreads - 1) / kThreads), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
