// Flash attention for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (_kernel,
// pallas_call at line 104).
//
// Bound.  At prefill shapes it is bound by operations: 4*dh FLOPs per
// (query head, visible (q, k) pair) against one read of q, k, v and one
// write of the output (gemma-2b, 8k tokens, bf16: 2.75e11 FLOPs, 0.28 ms
// on the bf16 tensor cores, against 75 MB, 0.023 ms).
//
// Design.  The TPU kernel holds a kv head's whole (Skv, dh) K and V per
// grid step; here one block owns kTQ = 64 query rows of one (batch, query
// head) and streams kTK = 64-key tiles of K and V through shared memory,
// in a loop that replaces the TPU's fori_loop.  The loop runs from the
// tile holding the lowest window start of the block's rows to the causal
// diagonal (the Pallas kernel bounds only the diagonal; the tiles below
// the window are masked for every row and change no bit, see
// repro_torch/kernels/flash_attention.py), and the grid runs the longest
// causal rows first.  Both products are register-blocked f32 FMA on
// tiles converted to f32 in shared memory, 4 x 4 outputs a thread; m, l
// and the (64, dh) accumulator stay in registers.  Tensor cores, TMA and
// warp specialisation, which the operation bound asks for, come later.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libflash_attention.so flash_attention.cu
// Plain C interface, loaded with ctypes.
//
// Per key tile j of a block (thread (ty, tx) of a 16 x 16 grid owns query
// rows ty + 16*i and keys tx + 16*c, i, c < 4, and the float4 columns
// tx + 16*cc of the accumulator):
//   1. K and V rows [64j, 64j + 64) of the kv head h / (H / Hk) into
//      shared memory as f32 (rows past Skv and columns past dh are 0);
//   2. s = (q * dh^-0.5) . k, then softcap c*tanh(s/c), then the mask
//      kpos <= qpos (causal) and kpos > qpos - window, masked entries set
//      to the finite -1e30; keys past Skv do not exist and get -inf, so
//      probability exactly 0 whatever the row sees;
//   3. the online-softmax update, row statistics reduced over the 16
//      threads of a row with shuffles:
//        m' = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m');
//        l' = corr*l + sum_j p;  acc' = corr*acc + p @ v
// and the block writes acc / max(l, 1e-30) in q's dtype.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 64;   // query rows per block
constexpr int kTK = 64;   // keys per streamed tile
constexpr int kMaxDh = 256;
constexpr int kCols = kMaxDh / 64;  // float4 accumulator columns a thread
constexpr int kPStride = kTK + 4;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;  // (B, H, Sq, dh) in q_dtype
  const void* k;  // (B, Hk, Skv, dh) in k_dtype
  const void* v;  // (B, Hk, Skv, dh) in v_dtype
  void* out;      // (B, H, Sq, dh) in q_dtype
  int B, H, Hk, Sq, Skv, dh;
  int dp;  // shared row stride in floats: dh rounded up to 4, plus 4
  int causal, window, q_dtype, k_dtype, v_dtype;
  float softcap, scale;
};

// rows [r0, r0 + rows) of one head's (S, dh) matrix at `base` into a
// shared tile of stride dp, as f32 times `mul` (rows past S and columns
// past dh are 0)
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          long long base, int r0, int rows,
                                          int S, int dh, int dp, int dtype,
                                          float mul, bool scaled) {
  for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
    const int r = e / dp;
    const int d = e - r * dp;
    float x = 0.0f;
    if (r0 + r < S && d < dh) {
      x = epi::load(src, base + static_cast<long long>(r0 + r) * dh + d,
                    dtype);
      if (scaled) x = __fmul_rn(x, mul);
    }
    dst[e] = x;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [kTQ][dp], pre-scaled
  float* k_s = q_s + kTQ * p.dp;   // [kTK][dp]
  float* v_s = k_s + kTK * p.dp;   // [kTK][dp]
  float* p_s = v_s + kTK * p.dp;   // [kTQ][kPStride] probabilities

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hk);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = iq * kTQ;
  const int dp4 = (p.dh + 3) / 4;
  const int nk = (p.Skv + kTK - 1) / kTK;
  const int lo = p.window ? max(0, q0 - p.window + 1) / kTK : 0;
  const int hi = p.causal ? min((q0 + kTQ + kTK - 1) / kTK, nk) : nk;
  const long long q_base =
      (static_cast<long long>(b) * p.H + h) * p.Sq * p.dh;
  const long long kv_base =
      (static_cast<long long>(b) * p.Hk + hk) * p.Skv * p.dh;

  load_rows(q_s, p.q, q_base, q0, kTQ, p.Sq, p.dh, p.dp, p.q_dtype, p.scale,
            true);

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][cc][e] = 0.0f;
    }
  }

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kTK;
    __syncthreads();  // the last tile's products are done with k_s, v_s, p_s
    load_rows(k_s, p.k, kv_base, k0, kTK, p.Skv, p.dh, p.dp, p.k_dtype,
              1.0f, false);
    load_rows(v_s, p.v, kv_base, k0, kTK, p.Skv, p.dh, p.dp, p.v_dtype,
              1.0f, false);
    __syncthreads();

    // 2. scores of rows ty + 16i against keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    }
    for (int d4 = 0; d4 < dp4; ++d4) {
      float4 a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * p.dp +
                                                4 * d4);
        kb[i] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * i) * p.dp +
                                                 4 * d4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[i][c];
          t = fmaf(a[i].x, kb[c].x, t);
          t = fmaf(a[i].y, kb[c].y, t);
          t = fmaf(a[i].z, kb[c].z, t);
          t = fmaf(a[i].w, kb[c].w, t);
          s[i][c] = t;
        }
      }
    }

    // 3. online softmax, one row's 64 keys over the 16 threads tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[i][c];
        if (p.softcap != 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = true;
        if (p.causal) ok = kpos <= qpos;
        if (p.window) ok = ok && kpos > qpos - p.window;
        x = ok ? x : kNegInf;
        if (kpos >= p.Skv) x = -INFINITY;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[i][c] - m_new);
        p_s[r * kPStride + tx + 16 * c] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][cc][e] *= corr;
      }
    }
    __syncthreads();

    // acc += p @ v over the tile's keys
    for (int jj = 0; jj < kTK; ++jj) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty + 16 * i) * kPStride + jj];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int c4 = tx + 16 * cc;
        if (c4 < dp4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + jj * p.dp + 4 * c4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][cc][0] = fmaf(pr[i], vv.x, acc[i][cc][0]);
            acc[i][cc][1] = fmaf(pr[i], vv.y, acc[i][cc][1]);
            acc[i][cc][2] = fmaf(pr[i], vv.z, acc[i][cc][2]);
            acc[i][cc][3] = fmaf(pr[i], vv.w, acc[i][cc][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long off = q_base + static_cast<long long>(row) * p.dh;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * cc) + e;
        if (d < p.dh) {
          epi::store(p.out, off + d, p.q_dtype, acc[i][cc][e] / denom);
        }
      }
    }
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hk, int Sq, int Skv, int dh,
                                      int causal, int window, int q_dtype,
                                      int k_dtype, int v_dtype, float softcap,
                                      float scale, void* stream) {
  if (dh <= 0 || dh > kMaxDh || Hk <= 0 || H % Hk != 0 || Sq <= 0 ||
      B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = 4 * ((dh + 3) / 4) + 4;
  Params p{q,       k,       v,       out,     B,      H,     Hk,
           Sq,      Skv,     dh,      dp,      causal, window, q_dtype,
           k_dtype, v_dtype, softcap, scale};
  const size_t smem =
      static_cast<size_t>(kTQ * dp + 2 * kTK * dp + kTQ * kPStride) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
