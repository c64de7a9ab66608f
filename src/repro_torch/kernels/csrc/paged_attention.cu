// Paged attention over the quantized KV block pool for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention_pallas (_kernel,
// _decode_block).  The design and its bound are described in
// repro_torch/kernels/paged_attention.py.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libpaged_attention.so paged_attention.cu
// Plain C interface, loaded with ctypes.
//
// Work split.  A block owns one batch row b, one kv head and up to kRows
// of that head's query rows (row = c * g + head-in-group, g = H / Hk), so
// each K/V block of the view is read and dequantized once for all the
// query heads that share it (gemma-2b: g = 8 heads on its one kv head).
// The block walks its row's block table in order:
//   1. dequantize the block's K and V rows (codes * per-slot scale) into
//      shared memory, f32;
//   2. one warp per (query row, slot) pair: s = (q * dh^-0.5) . k, then
//      softcap c*tanh(s/c), then the mask kvpos <= qpos (and kvpos >
//      qpos - window), masked entries set to the finite NEG_INF = -1e30;
//   3. per query row the flash online-softmax update
//        m' = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m');
//        l' = corr*l + sum_j p;  acc' = corr*acc + p @ v
//      with m, l, acc kept in shared memory across blocks;
// and writes acc / max(l, 1e-30) in q's dtype.  The walk stops after the
// block holding the row's largest query position: every later slot is
// masked, contributes exactly 0 and leaves m, l and acc unchanged, so the
// early end changes no bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // query rows per block
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;          // (B, C, H, dh) in q_dtype
  const uint8_t* kc;      // (nb, bs, Hk, dhp) codes
  const float* ks;        // (nb, bs, Hk) per-slot scales
  const uint8_t* vc;
  const float* vs;
  const int32_t* bt;      // (B, nseq) block ids
  const int32_t* pos;     // (B, C) query positions
  const float* codebook;  // (16,) code -> value at 4 bits, or null
  void* out;              // (B, C, H, dh) in q_dtype
  int B, C, H, Hk, dh, dhp, bs, nseq, bits, window, q_dtype;
  float softcap, scale;
};

// the grid or codebook value of element d of one head's code row
__device__ __forceinline__ float decode(const uint8_t* row, int d, int bits,
                                        const float* table) {
  if (bits == 8) return static_cast<float>(static_cast<int8_t>(row[d]));
  const int byte = row[d >> 1];  // hi nibble first
  return table[(d & 1) ? (byte & 15) : (byte >> 4)];
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nblk_s;
  const int g = p.H / p.Hk;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.C * g - r0);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;                    // [kRows][dh], pre-scaled
  float* k_s = q_s + kRows * p.dh;      // [bs][dh]
  float* v_s = k_s + p.bs * p.dh;       // [bs][dh]
  float* acc = v_s + p.bs * p.dh;       // [kRows][dh]
  float* s_s = acc + kRows * p.dh;      // [kRows][bs] scores, then p
  float* m_s = s_s + kRows * p.bs;      // [kRows] running max
  float* l_s = m_s + kRows;             // [kRows] running denominator
  float* corr_s = l_s + kRows;          // [kRows]
  float* table = corr_s + kRows;        // [16] 4-bit code -> value
  int* qpos_s = reinterpret_cast<int*>(table + 16);  // [kRows]

  if (tid < 16) {
    table[tid] = p.codebook ? p.codebook[tid]
                            : static_cast<float>(tid <= 7 ? tid : tid - 16);
  }
  for (int e = tid; e < rows * p.dh; e += kThreads) {
    const int r = e / p.dh;
    const int d = e - r * p.dh;
    const int row = r0 + r;
    const int c = row / g;
    const int h = hk * g + (row - c * g);
    const long long off =
        ((static_cast<long long>(b) * p.C + c) * p.H + h) * p.dh + d;
    q_s[e] = __fmul_rn(epi::load(p.q, off, p.q_dtype), p.scale);
    acc[e] = 0.0f;
  }
  if (tid < rows) {
    qpos_s[tid] = p.pos[b * p.C + (r0 + tid) / g];
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  if (tid == 0) {  // blocks up to the row's largest query position
    int mx = 0;
    for (int c = 0; c < p.C; ++c) mx = max(mx, p.pos[b * p.C + c]);
    nblk_s = min(p.nseq, mx / p.bs + 1);
  }
  __syncthreads();
  const int nblk = nblk_s;

  for (int i = 0; i < nblk; ++i) {
    const long long blk = p.bt[static_cast<long long>(b) * p.nseq + i];
    // 1. dequantize the block's K and V rows of this kv head
    for (int e = tid; e < p.bs * p.dh; e += kThreads) {
      const int j = e / p.dh;
      const int d = e - j * p.dh;
      const long long slot = (blk * p.bs + j) * p.Hk + hk;
      k_s[e] = __fmul_rn(decode(p.kc + slot * p.dhp, d, p.bits, table),
                         p.ks[slot]);
      v_s[e] = __fmul_rn(decode(p.vc + slot * p.dhp, d, p.bits, table),
                         p.vs[slot]);
    }
    __syncthreads();
    // 2. masked, soft-capped scores, one warp per (row, slot)
    for (int pr = warp; pr < rows * p.bs; pr += kWarps) {
      const int r = pr / p.bs;
      const int j = pr - r * p.bs;
      const float* qr = q_s + r * p.dh;
      const float* kr = k_s + j * p.dh;
      float dot = 0.0f;
      for (int d = lane; d < p.dh; d += 32) dot = fmaf(qr[d], kr[d], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (lane == 0) {
        float s = dot;
        if (p.softcap != 0.0f) s = p.softcap * tanhf(s / p.softcap);
        const int kvpos = i * p.bs + j;
        const int qp = qpos_s[r];
        bool ok = kvpos <= qp;
        if (p.window) ok = ok && kvpos > qp - p.window;
        s_s[pr] = ok ? s : kNegInf;
      }
    }
    __syncthreads();
    // 3. online-softmax statistics, one thread per row
    if (tid < rows) {
      float* sr = s_s + tid * p.bs;
      const float m = m_s[tid];
      float mx = sr[0];
      for (int j = 1; j < p.bs; ++j) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(m, mx);
      float sum = 0.0f;
      for (int j = 0; j < p.bs; ++j) {
        const float e = expf(sr[j] - m_new);
        sr[j] = e;
        sum += e;
      }
      const float corr = expf(m - m_new);
      l_s[tid] = corr * l_s[tid] + sum;
      m_s[tid] = m_new;
      corr_s[tid] = corr;
    }
    __syncthreads();
    for (int e = tid; e < rows * p.dh; e += kThreads) {
      const int r = e / p.dh;
      const int d = e - r * p.dh;
      const float* pr = s_s + r * p.bs;
      float pv = 0.0f;
      for (int j = 0; j < p.bs; ++j) pv = fmaf(pr[j], v_s[j * p.dh + d], pv);
      acc[e] = corr_s[r] * acc[e] + pv;
    }
    __syncthreads();  // the next block overwrites k_s, v_s and s_s
  }

  for (int e = tid; e < rows * p.dh; e += kThreads) {
    const int r = e / p.dh;
    const int d = e - r * p.dh;
    const int row = r0 + r;
    const int c = row / g;
    const int h = hk * g + (row - c * g);
    const long long off =
        ((static_cast<long long>(b) * p.C + c) * p.H + h) * p.dh + d;
    epi::store(p.out, off, p.q_dtype, acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, const uint8_t* kc, const float* ks, const uint8_t* vc,
    const float* vs, const int32_t* bt, const int32_t* pos,
    const float* codebook, void* out, int B, int C, int H, int Hk, int dh,
    int dhp, int bs, int nseq, int bits, int window, int q_dtype,
    float softcap, float scale, void* stream) {
  Params p{q, kc, ks, vc, vs, bt, pos, codebook, out,
           B, C, H, Hk, dh, dhp, bs, nseq, bits, window, q_dtype,
           softcap, scale};
  const size_t smem =
      static_cast<size_t>(2 * kRows * dh + 2 * bs * dh + kRows * bs +
                          3 * kRows + 16) * sizeof(float) +
      kRows * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int g = H / Hk;
  const dim3 grid((C * g + kRows - 1) / kRows, Hk, B);
  paged_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
