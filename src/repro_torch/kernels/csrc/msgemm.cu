// msGeMM for Hopper (sm_90a): paper Eq. 5 with §3.3 factored scales and a
// fused epilogue.  Replaces the Pallas TPU kernel
// repro/kernels/msgemm.py::msgemm_pallas (both its fused and its legacy
// grid; with the identity epilogue this kernel computes the legacy one).
// What bounds it and why the design looks as it does is in
// repro_torch/kernels/msgemm.py.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libmsgemm.so msgemm.cu
// Plain C interface, loaded with ctypes.
//
// Work split.  A block of 512 threads owns R = 512*RPT output rows, TB
// batch columns and a contiguous range of LUT chunks (a whole number of
// scale blocks, one contraction split).  For each chunk j it builds the
// table L[n, c] = sum_r C(code_r(n)) * x[j*D+r, c] (16^D entries x TB
// columns) once in shared memory for all its R rows, as the TPU kernel
// builds it on the first m-step only.  Per chunk:
//   produce  each thread builds the entries n = tid + 512*i, whose last
//            two codes are fixed by tid: their products are taken
//            once a chunk, the rest of the sum in registers, one float4
//            store an entry, neighbouring threads on neighbouring entries;
//   consume  every row gathers L[idx[row, j], :] into its block sum; the
//            indices come from a staged (R x stage) tile in shared memory
//            that 16-byte cp.async copies (L2 only) fill a stage ahead,
//            neighbouring lanes on neighbouring vectors of one row; x of a
//            stage is staged beside it, in f32;
//   scale    at the end of each scale block the sum is multiplied once by
//            the block's scale (fetched a scale block ahead) and added
//            into the row's f32 accumulator.
// The table is double-buffered: chunk j+1's is built while chunk j's is
// gathered, one block barrier per chunk.  d = 4's 16^4 table does not fit
// shared memory; it is built in a device-memory scratch per block.  With
// one split the epilogue runs at the end of the block; with several, each
// split writes its partial sums and a second kernel adds them in split
// (= j) order and applies the epilogue.
//
// Op order per output element, kept bit-identical to the plain PyTorch
// version by using the _rn intrinsics (no FMA contraction):
//   entry = ((C0*x0) + C1*x1) + ...          in r order
//   part  = ((0 + g_0) + g_1) + ...          gathers of one scale block
//   acc   = acc + part * scale               once per scale block
//   total = ((acc_split0 + acc_split1) + ...)
//   out   = cast(act(total + bias) + residual)
// x and the residual are read in their own type (f32, bf16 or f16) and
// widened to f32, which is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 512;

struct Params {
  const int32_t* idx;     // (m, kc) row-major LUT indices
  const void* x;          // x[row * xs_k + col * xs_b], row < k, x_type
  const float* scales;    // (m, nsb) row-major
  const float* values;    // (16,) code -> value (int4 grid or codebook)
  const float* bias;      // (m,) or null
  const void* res;        // res[row * rs_m + col * rs_b] or null, res_type
  void* out;              // out[row * os_m + col * os_b]
  float* ws;              // (nsplit, b, m) partial sums when nsplit > 1
  float* lut_scratch;     // two 16^d x TB tables per block when d == 4
  int m, k, kc, b, cpb, nsb, split_chunks, nsplit, stage_log2;
  long long xs_k, xs_b, rs_m, rs_b, os_m, os_b;
  int act, out_type, x_type, res_type;
};

// Shared memory of one block, in 4-byte words: two tables (d < 4),
// two staged x tiles (stage x d x tb), the 16 code values, two staged
// index tiles (rows of stage + 4 words, 16-byte aligned).
// repro_torch/kernels/msgemm.py::smem_bytes mirrors this formula.
__host__ __device__ constexpr long long table_words(int d, int tb) {
  return d < 4 ? 2LL * (1LL << (4 * d)) * tb : 0;
}
__host__ __device__ constexpr long long idx_tile_words(int rows, int stage) {
  return static_cast<long long>(rows) * (stage + 4);
}
long long smem_bytes(int d, int tb, int rows, int stage) {
  return 4 * (table_words(d, tb) + 2LL * stage * d * tb + 16 +
              2 * idx_tile_words(rows, stage));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float load_x(const Params& p, int row, int col) {
  return (row < p.k && col < p.b)
             ? epi::load(p.x, row * p.xs_k + col * p.xs_b, p.x_type)
             : 0.0f;
}

template <int D, int TB, int RPT, bool SMEM_LUT>
__global__ void __launch_bounds__(kThreads, 1)
msgemm_kernel(const Params p) {
  constexpr int N = 1 << (4 * D);
  constexpr int R = kThreads * RPT;
  constexpr int XW = D * TB;  // x words of one chunk
  extern __shared__ __align__(16) float smem[];
  const int sh = p.stage_log2;
  const int S = 1 << sh;
  const int pitch = S + 4;
  const int nv = S / 4 + 1;  // 16-byte vectors a row of an index tile
  float* xs = smem + table_words(D, TB);                  // [2][S][D][TB]
  float* vals = xs + 2 * S * XW;                          // [16]
  int* ibuf = reinterpret_cast<int*>(vals + 16);          // [2] tiles
  const long long tile_words = idx_tile_words(R, S);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * R;
  const int split = blockIdx.y;
  const int col0 = blockIdx.z * TB;
  const int j_begin = split * p.split_chunks;
  const int nq = min(p.split_chunks, p.kc - j_begin);
  const int nstages = (nq + S - 1) >> sh;
  const long long total = static_cast<long long>(p.m) * p.kc;
  float* table = smem;  // [2][N][TB]
  if constexpr (!SMEM_LUT) {
    const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y +
                        blockIdx.y) * gridDim.x + blockIdx.x;
    table = p.lut_scratch + blk * 2 * N * TB;
  }

  // ---- the staged index tile of stage st into slot st & 1: each row's
  // words from the 16-byte boundary at or below its first chunk
  auto stage_idx = [&](int st) {
    if (st < nstages) {
      int* tile = ibuf + (st & 1) * tile_words;
      const int q0 = st << sh;
      for (int e = tid; e < R * nv; e += kThreads) {
        const int rl = e / nv;
        const int v = e - rl * nv;
        const int row = m0 + rl;
        const long long w =
            ((static_cast<long long>(row) * p.kc + j_begin + q0) & ~3LL) + 4 * v;
        const long long left = total - w;
        const int bytes = row < p.m ? (left >= 4 ? 16 : left > 0 ? 4 * static_cast<int>(left) : 0)
                                    : 0;
        cp_async16(tile + rl * pitch + 4 * v, bytes ? p.idx + w : p.idx, bytes);
      }
    }
    cp_async_commit();
  };

  // ---- x of stage st: fetched into a register, stored a stage later
  auto x_fetch = [&](int st) {
    float v = 0.0f;
    if (st < nstages && tid < S * XW) {
      const int jj = tid / XW;
      const int r = (tid / TB) % D;
      if ((st << sh) + jj < nq) {
        v = load_x(p, (j_begin + (st << sh) + jj) * D + r, col0 + tid % TB);
      }
    }
    return v;
  };
  auto x_store = [&](int st, float v) {
    if (tid < S * XW) xs[(st & 1) * S * XW + tid] = v;
  };

  // ---- chunk q's table
  auto make_entries = [&](int q) {
    const float* xq = xs + ((q >> sh) & 1) * S * XW + (q & (S - 1)) * XW;
    float ql[TB], q2[TB], xr[D > 2 ? D - 2 : 1][TB];
    const float c_last = vals[tid & 15];         // n & 15
    const float c_next = vals[(tid >> 4) & 15];  // (n >> 4) & 15
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      ql[c] = __fmul_rn(c_last, xq[(D - 1) * TB + c]);
      q2[c] = D > 1 ? __fmul_rn(c_next, xq[(D > 1 ? D - 2 : 0) * TB + c]) : 0.0f;
#pragma unroll
      for (int r = 0; r < D - 2; ++r) xr[r][c] = xq[r * TB + c];
    }
    float* tab = table + (q & 1) * N * TB;
#pragma unroll 4
    for (int n = tid; n < N; n += kThreads) {
      float v[TB];
#pragma unroll
      for (int c = 0; c < TB; ++c) {
        if constexpr (D == 1) {
          v[c] = ql[c];
        } else if constexpr (D == 2) {
          v[c] = __fadd_rn(q2[c], ql[c]);
        } else {
          float s = __fmul_rn(vals[(n >> (4 * (D - 1))) & 15], xr[0][c]);
#pragma unroll
          for (int r = 1; r < D - 2; ++r) {
            s = __fadd_rn(s, __fmul_rn(vals[(n >> (4 * (D - 1 - r))) & 15], xr[r][c]));
          }
          v[c] = __fadd_rn(__fadd_rn(s, q2[c]), ql[c]);
        }
      }
      float* t = tab + static_cast<long long>(n) * TB;
      if constexpr (TB == 4) {
        *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        t[0] = v[0];
      }
    }
  };

  float acc[RPT][TB];
  float part[RPT][TB];
  float sc[RPT], scn[RPT];
  int off[RPT];  // the row's first chunk in an index tile
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rl = i * kThreads + tid;
    off[i] = rl * pitch +
             static_cast<int>((static_cast<long long>(m0 + rl) * p.kc + j_begin) & 3);
    sc[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      acc[i][c] = 0.0f;
      part[i][c] = 0.0f;
    }
  }
  auto fetch_scales = [&](int blk) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = m0 + i * kThreads + tid;
      scn[i] = row < p.m ? __ldg(p.scales + static_cast<long long>(row) * p.nsb + blk)
                         : 0.0f;
    }
  };

  // ---- prologue: index stages 0 and 1 in flight, x of stages 0 and 1
  // staged, of stage 2 fetched, chunk 0's table built
  stage_idx(0);
  stage_idx(1);
  if (tid < 16) vals[tid] = p.values[tid];
  x_store(0, x_fetch(0));
  x_store(1, x_fetch(1));
  float xreg = x_fetch(2);
  fetch_scales(j_begin / p.cpb);
  __syncthreads();
  make_entries(0);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // stage 0
  __syncthreads();

  for (int q = 0; q < nq; ++q) {
    const int j = j_begin + q;
    if (j % p.cpb == 0) {  // a scale block starts: fetch the next one's
      const int blk = j / p.cpb;
#pragma unroll
      for (int i = 0; i < RPT; ++i) sc[i] = scn[i];
      if ((blk + 1) * p.cpb < j_begin + nq) fetch_scales(blk + 1);
    }
    if (q + 1 < nq) make_entries(q + 1);

    // ---- consume chunk q: all RPT gathers issued, then added
    {
      const int* tile = ibuf + ((q >> sh) & 1) * tile_words + (q & (S - 1));
      const float* tab = table + (q & 1) * N * TB;
      float4 g[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        g[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (m0 + i * kThreads + tid >= p.m) continue;
        const int n = tile[off[i]];
        if constexpr (TB == 4) {
          g[i] = *reinterpret_cast<const float4*>(tab + static_cast<long long>(n) * 4);
        } else {
          g[i].x = tab[n];
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (m0 + i * kThreads + tid >= p.m) continue;
        part[i][0] = __fadd_rn(part[i][0], g[i].x);
        if constexpr (TB == 4) {
          part[i][1] = __fadd_rn(part[i][1], g[i].y);
          part[i][2] = __fadd_rn(part[i][2], g[i].z);
          part[i][3] = __fadd_rn(part[i][3], g[i].w);
        }
      }
    }
    // ---- §3.3: one scale multiply per scale block
    if ((j + 1) % p.cpb == 0 || j + 1 == p.kc) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int c = 0; c < TB; ++c) {
          acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(part[i][c], sc[i]));
          part[i][c] = 0.0f;
        }
      }
    }
    if (q + 1 == nq) break;
    const bool stage_end = ((q + 1) & (S - 1)) == 0;
    if (stage_end) cp_async_wait_all();  // the next stage's indices landed
    // chunk q+1's table is complete, and every thread is done with chunk
    // q's table and (at a stage end) index tile
    __syncthreads();
    if (stage_end) {
      const int st = (q + 1) >> sh;
      stage_idx(st + 1);
      x_store(st + 1, xreg);
      xreg = x_fetch(st + 2);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = m0 + i * kThreads + tid;
    if (row >= p.m) continue;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      const int col = col0 + c;
      if (col >= p.b) continue;
      if (p.nsplit == 1) {
        epi::finish(acc[i][c], p.bias != nullptr, p.bias ? p.bias[row] : 0.0f,
                    p.act, p.res != nullptr,
                    p.res ? epi::load(p.res, row * p.rs_m + col * p.rs_b, p.res_type)
                          : 0.0f,
                    p.out, row * p.os_m + col * p.os_b, p.out_type);
      } else {
        p.ws[(static_cast<long long>(split) * p.b + col) * p.m + row] = acc[i][c];
      }
    }
  }
}

// the splits' partial sums added in split (= j) order, then the epilogue
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const Params p) {
  const long long e = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const long long mb = static_cast<long long>(p.m) * p.b;
  if (e >= mb) return;
  const int row = static_cast<int>(e % p.m);
  const int col = static_cast<int>(e / p.m);
  float t = p.ws[e];
#pragma unroll 8
  for (int s = 1; s < p.nsplit; ++s) t = __fadd_rn(t, p.ws[s * mb + e]);
  epi::finish(t, p.bias != nullptr, p.bias ? p.bias[row] : 0.0f, p.act,
              p.res != nullptr,
              p.res ? epi::load(p.res, row * p.rs_m + col * p.rs_b, p.res_type)
                    : 0.0f,
              p.out, row * p.os_m + col * p.os_b, p.out_type);
}

template <int D, int TB, int RPT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr bool kSmem = D < 4;
  const int rows = kThreads * RPT;
  const long long smem = smem_bytes(D, TB, rows, 1 << p.stage_log2);
  auto kern = msgemm_kernel<D, TB, RPT, kSmem>;
  static long long allowed = 48 * 1024;  // raised once per variant
  cudaError_t err;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((p.m + rows - 1) / rows, p.nsplit, (p.b + TB - 1) / TB);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int TB>
cudaError_t launch_rpt(const Params& p, int rpt, cudaStream_t s) {
  switch (rpt) {
    case 1: return launch<D, TB, 1>(p, s);
    case 2: return launch<D, TB, 2>(p, s);
    case 4: return launch<D, TB, 4>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The variants built; d = 4 at TB = 1 only (its table lives in device
// memory).  repro_torch/kernels/msgemm.py::check_tiles lists the same.
template <int D>
cudaError_t launch_tb(const Params& p, int tb, int rpt, cudaStream_t s) {
  if (tb == 1) return launch_rpt<D, 1>(p, rpt, s);
  if constexpr (D < 4) {
    if (tb == 4) return launch_rpt<D, 4>(p, rpt, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// shared memory bytes a block of the given variant asks for
extern "C" long long msgemm_smem_bytes(int d, int tb, int rows, int stage) {
  return smem_bytes(d, tb, rows, stage);
}

extern "C" int msgemm_launch(
    const int32_t* idx, const void* x, const float* scales,
    const float* values, const float* bias, const void* res, void* out,
    float* ws, float* lut_scratch, int m, int k, int kc, int b, int d,
    int cpb, int nsb, int split_chunks, int nsplit, int tb, int rpt,
    int stage_log2, long long xs_k, long long xs_b, long long rs_m,
    long long rs_b, long long os_m, long long os_b, int act, int out_type,
    int x_type, int res_type, void* stream) {
  Params p{idx, x, scales, values, bias, res, out, ws, lut_scratch,
           m, k, kc, b, cpb, nsb, split_chunks, nsplit, stage_log2,
           xs_k, xs_b, rs_m, rs_b, os_m, os_b, act, out_type, x_type, res_type};
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
    reduce_kernel<<<static_cast<unsigned>((mb + kReduceThreads - 1) / kReduceThreads),
                    kReduceThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
