// Paged attention over the quantized KV block pool for Hopper (sm_90a),
// split over the sequence.
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
// Work split.  A row's view (nseq blocks of bs slots) is cut into chunks
// of a fixed number of slots, `chunk`; chunk c holds view slots
// [c*chunk, (c+1)*chunk), whatever the batch, the positions or nseq.  One
// CUDA block owns one (batch row b, kv head, group of up to RB query rows,
// chunk); a query row is (query c, head in the kv head's group), so each
// K/V slot is read and dequantized once for all RB query rows of a block
// (gemma-2b: 8 heads on its one kv head).  The wrapper picks RB from the
// shape (paged_attention.rows_per_block): the most rows, up to 8, that
// still give every SM a block, fewer where the grid would be small
// (short views), as the kernel is latency-bound there.  Rows need the chunks
// [lo, hi): hi ends at the block that holds the row's largest query
// position, lo is the chunk of the lowest window start (0 without a
// window); a block outside them returns at once.  Inside a chunk, with
// every slot at once:
//   1. the pool rows of the chunk's slots from the block table, then
//      16-byte cp.async copies of all their K codes, then of all their V
//      codes (per-slot scales beside them), so the whole chunk's loads are
//      in flight together and V's overlap the scores;
//   2. scores: each slot's codes dequantized in registers (code * scale)
//      and dotted with every query row (q pre-scaled by dh^-0.5), a short
//      chunk's slots split over P threads summed through shared memory;
//      then softcap c*tanh(s/c)
//      and the mask kvpos <= qpos (and kvpos > qpos - window), masked
//      entries the finite NEG_INF = -1e30;
//   3. one warp a row: m = max_j s, p = exp(s - m), l = sum_j p;
//   4. acc = p @ v, V dequantized in registers, four columns a thread and
//      the slots split over SG threads reduced by shuffles.
// A view of one chunk writes acc / max(l, 1e-30) in q's dtype at once.
// Otherwise the block writes its partial (m, l, acc) to scratch and
// paged_combine_kernel merges a row's needed chunks in chunk order:
//   M = max_i m_i;  w_i = exp(m_i - M);
//   out = sum_i w_i*acc_i / max(sum_i w_i*l_i, 1e-30)
// A chunk whose slots are all masked for a query has m_i = -1e30 and so
// w_i = 0 exactly for any query that sees a key elsewhere; the chunks past
// the row's end or wholly below its windows would add exactly 0, which is
// why skipping them changes no bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
  float* part_ml;         // (B, Hk, rows, nchunks, 2) chunk m, l
  float* part_acc;        // (B, Hk, rows, nchunks, dh) chunk acc
  int B, C, H, Hk, dh, dhp, bs, nseq, window, q_dtype;
  int chunk, nchunks, rows, groups;  // rows = C * (H / Hk) query rows
  int units;  // 16-byte code units of a slot row, ceil(dhp / 16)
  int vec;    // codes load as 16-byte cp.async copies (dhp % 16 == 0)
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout of a chunk block, in bytes (the Python mirror is
// paged_attention.smem_bytes): K and V code rows of units*16 + 16 bytes
// (the 16-byte pad keeps eight neighbouring rows' vector loads on
// distinct banks), K and V scales, q [rb][dpad] f32, scores
// [rb][chunk] f32, the score parts [256 threads][rb] f32, the chunk's
// pool rows.
__host__ __device__ inline int code_stride(int units) {
  return units * 16 + 16;
}

__host__ __device__ inline int dpad_of(int units, int bits) {
  return units * (bits == 8 ? 16 : 32);
}

__host__ __device__ inline long long smem_total(int units, int bits,
                                                int chunk, int rb) {
  return 2LL * chunk * code_stride(units) + 2LL * chunk * 4 +
         4LL * rb * dpad_of(units, bits) + 4LL * rb * chunk +
         4LL * rb * kThreads + 4LL * chunk;
}

// the chunks [lo, hi) row b needs, and the view slots it reaches
// [0, hi_slot); computed by warp 0 into lo_hi[3]
__device__ __forceinline__ void live_chunks(const Params& p, int b,
                                            int* lo_hi) {
  if (threadIdx.x >= 32) return;
  int mx = INT_MIN, mn = INT_MAX;
  for (int i = threadIdx.x; i < p.C; i += 32) {
    const int v = p.pos[static_cast<long long>(b) * p.C + i];
    mx = max(mx, v);
    mn = min(mn, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  if (threadIdx.x == 0) {
    const int hi_slot = min(p.nseq, max(mx, 0) / p.bs + 1) * p.bs;
    const int hi = (hi_slot + p.chunk - 1) / p.chunk;
    const int lo = p.window ? max(0, mn - p.window + 1) / p.chunk : 0;
    lo_hi[0] = min(lo, hi - 1);
    lo_hi[1] = hi;
    lo_hi[2] = hi_slot;
  }
}

// the values of the 16 (8 bits) or 32 (4 bits, hi nibble first) codes in
// one 16-byte unit
template <int BITS>
__device__ __forceinline__ void decode_unit(
    const uint4 raw, const float* table, float (&out)[BITS == 8 ? 16 : 32]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
    if constexpr (BITS == 8) {
      out[i] = static_cast<float>(static_cast<int8_t>(byte));
    } else {
      out[2 * i] = table[byte >> 4];
      out[2 * i + 1] = table[byte & 15u];
    }
  }
}

// the values of the four codes at columns 4*quad .. 4*quad + 3 of a row
template <int BITS>
__device__ __forceinline__ void decode_quad(const uint8_t* row, int quad,
                                            const float* table,
                                            float (&out)[4]) {
  if constexpr (BITS == 8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * quad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
    }
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + 2 * quad);
    out[0] = table[(w >> 4) & 15u];
    out[1] = table[w & 15u];
    out[2] = table[(w >> 12) & 15u];
    out[3] = table[(w >> 8) & 15u];
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// The kernel runs one pass over its code per block, so its code is kept
// small: q's type is a template argument, and the per-row work that is
// not arithmetic (soft-cap and mask, the output) runs as loops over
// elements.
template <int RB, int BITS, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const Params p) {
  constexpr int EPT = BITS == 8 ? 16 : 32;  // code values a 16-byte unit
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lo_hi[3];
  __shared__ int qpos_s[RB];
  __shared__ float table[16], m_s[RB], l_s[RB];
  const int c = blockIdx.x;
  const int hk = blockIdx.y / p.groups;
  const int r0 = (blockIdx.y - hk * p.groups) * RB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = p.H / p.Hk;
  const int cs = code_stride(p.units);
  const int dpad = p.units * EPT;
  const QT* qg = reinterpret_cast<const QT*>(p.q);

  uint8_t* k_s = smem;                                     // [chunk][cs]
  uint8_t* v_s = k_s + p.chunk * cs;                       // [chunk][cs]
  float* ksc = reinterpret_cast<float*>(v_s + p.chunk * cs);  // [chunk]
  float* vsc = ksc + p.chunk;                              // [chunk]
  float* q_s = vsc + p.chunk;  // [RB][dpad] q, then the output rows
  float* s_s = q_s + RB * dpad;                            // [RB][chunk]
  float* red_s = s_s + RB * p.chunk;                       // [P][RB][S]
  int* row_s = reinterpret_cast<int*>(red_s + RB * kThreads);  // [chunk]

  // 1. what the block reads before the codes, all issued together: q
  //    (into registers, element tid + 256 i of the [RB][dpad] tile), the
  //    positions (the live range) and the chunk's block-table entries
  float qv[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int e = tid + kThreads * i;
    const int r = e / dpad;
    const int d = e - r * dpad;
    const int rr = r0 + r;
    qv[i] = 0.0f;
    if (e < RB * dpad && rr < p.rows && d < p.dh) {
      const int cq = rr / g;
      const int h = hk * g + (rr - cq * g);
      qv[i] = to_f32(
          qg[((static_cast<long long>(b) * p.C + cq) * p.H + h) * p.dh + d]);
    }
  }
  live_chunks(p, b, lo_hi);
  if (tid < 16) {
    table[tid] = p.codebook ? p.codebook[tid]
                            : static_cast<float>(tid <= 7 ? tid : tid - 16);
  }
  if (tid < RB) {
    const int rr = min(r0 + tid, p.rows - 1);
    qpos_s[tid] = p.pos[static_cast<long long>(b) * p.C + rr / g];
  }
  const int j0 = c * p.chunk;
  for (int j = tid; j < p.chunk && j0 + j < p.nseq * p.bs; j += kThreads) {
    const int s = j0 + j;
    const long long blk = p.bt[static_cast<long long>(b) * p.nseq + s / p.bs];
    row_s[j] = static_cast<int>((blk * p.bs + s % p.bs) * p.Hk + hk);
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int e = tid + kThreads * i;
    if (e < RB * dpad) q_s[e] = __fmul_rn(qv[i], p.scale);
  }
  __syncthreads();
  if (c < lo_hi[0] || c >= lo_hi[1]) return;  // the combine skips it
  const int n = min(p.chunk, lo_hi[2] - j0);  // slots of this chunk, >= 1

  // then every K and V code row of the chunk in flight
  const uint8_t* codes[2] = {p.kc, p.vc};
  const float* scales[2] = {p.ks, p.vs};
  uint8_t* dst[2] = {k_s, v_s};
  float* sdst[2] = {ksc, vsc};
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    if (p.vec) {
      for (int e = tid; e < n * p.units; e += kThreads) {
        const int j = e / p.units;
        const int u = e - j * p.units;
        cp_async16(dst[kv] + j * cs + 16 * u,
                   codes[kv] + static_cast<long long>(row_s[j]) * p.dhp +
                       16 * u);
      }
    } else {  // rows not 16-byte aligned: byte copies, zero past dhp
      for (int e = tid; e < n * p.units * 16; e += kThreads) {
        const int j = e / (p.units * 16);
        const int x = e - j * p.units * 16;
        dst[kv][j * cs + x] =
            x < p.dhp ? codes[kv][static_cast<long long>(row_s[j]) * p.dhp + x]
                      : 0;
      }
    }
    for (int j = tid; j < n; j += kThreads) {
      cp_async4(sdst[kv] + j, scales[kv] + row_s[j]);
    }
    cp_async_commit();
  }

  // 2. q . k: a slot's units split over P parts; the S = 256 / P threads
  //    of a part take consecutive slots, so a warp reads one q unit (a
  //    broadcast) against 32 K rows (distinct banks)
  cp_async_wait<1>();
  __syncthreads();
  int P = 32;
  while (P > 1 && n * P > kThreads) P >>= 1;
  const int S = kThreads / P;
  const int part = tid / S;
  const int js = tid - part * S;
  for (int jb = 0; jb < n; jb += S) {  // one pass when P > 1
    const int j = jb + js;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    if (j < n) {
      const float sc = ksc[j];
      for (int u = part; u < p.units; u += P) {
        float kv[EPT];
        decode_unit<BITS>(
            *reinterpret_cast<const uint4*>(k_s + j * cs + 16 * u), table, kv);
#pragma unroll
        for (int e = 0; e < EPT; ++e) kv[e] = __fmul_rn(kv[e], sc);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4* qr =
              reinterpret_cast<const float4*>(q_s + r * dpad + u * EPT);
#pragma unroll
          for (int e4 = 0; e4 < EPT / 4; ++e4) {
            const float4 qq = qr[e4];
            acc[r] = fmaf(qq.x, kv[4 * e4], acc[r]);
            acc[r] = fmaf(qq.y, kv[4 * e4 + 1], acc[r]);
            acc[r] = fmaf(qq.z, kv[4 * e4 + 2], acc[r]);
            acc[r] = fmaf(qq.w, kv[4 * e4 + 3], acc[r]);
          }
        }
      }
    }
    if (P > 1) {  // sum the parts, in part order
#pragma unroll
      for (int r = 0; r < RB; ++r) red_s[(part * RB + r) * S + js] = acc[r];
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float t = red_s[r * S + js];
          for (int pp = 1; pp < P; ++pp) t += red_s[(pp * RB + r) * S + js];
          acc[r] = t;
        }
      }
    }
    if (j < n && part == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) s_s[r * p.chunk + j] = acc[r];
    }
  }
  __syncthreads();
  // soft-cap and mask, masked entries the finite NEG_INF
  for (int e = tid; e < RB * n; e += kThreads) {
    const int r = e / n;
    const int j = e - r * n;
    float s = s_s[r * p.chunk + j];
    if (p.softcap != 0.0f) s = p.softcap * tanhf(s / p.softcap);
    const int kvpos = j0 + j;
    const int qp = qpos_s[r];
    bool ok = kvpos <= qp;
    if (p.window) ok = ok && kvpos > qp - p.window;
    s_s[r * p.chunk + j] = ok ? s : kNegInf;
  }
  __syncthreads();

  // 3. the chunk's softmax, one warp a row
  for (int r = warp; r < RB; r += kWarps) {
    float* sr = s_s + r * p.chunk;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. acc = p @ v: four columns a thread, slots over SG threads
  const int nq = dpad / 4;
  int SG = 32;
  while (SG > 1 && nq * SG > kThreads) SG >>= 1;
  const int sg = tid % SG;
  const int quad = tid / SG;
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
  }
  if (quad < nq) {
    for (int j = sg; j < n; j += SG) {
      float vv[4];
      decode_quad<BITS>(v_s + j * cs, quad, table, vv);
      const float sc = vsc[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = __fmul_rn(vv[i], sc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pr = s_s[r * p.chunk + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
  }
  for (int o = SG / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
      }
    }
  }
  float* o_s = q_s;  // q is no longer read: the output rows go there
  if (sg == 0 && quad < nq) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      *reinterpret_cast<float4*>(o_s + r * dpad + 4 * quad) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();

  // the output rows (one chunk) or the chunk's partial, coalesced
  const long long prow0 = (static_cast<long long>(b) * p.Hk + hk) * p.rows;
  if (p.nchunks > 1 && tid < RB && r0 + tid < p.rows) {
    const long long at = ((prow0 + r0 + tid) * p.nchunks + c) * 2;
    p.part_ml[at] = m_s[tid];
    p.part_ml[at + 1] = l_s[tid];
  }
  for (int e = tid; e < RB * p.dh; e += kThreads) {
    const int r = e / p.dh;
    const int d = e - r * p.dh;
    const int rr = r0 + r;
    if (rr >= p.rows) break;
    const float x = o_s[r * dpad + d];
    if (p.nchunks > 1) {
      p.part_acc[((prow0 + rr) * p.nchunks + c) * p.dh + d] = x;
    } else {
      const int cq = rr / g;
      const int h = hk * g + (rr - cq * g);
      reinterpret_cast<QT*>(p.out)[((static_cast<long long>(b) * p.C + cq) *
                                        p.H + h) * p.dh + d] =
          from_f32<QT>(x / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// One block per (query row, kv head, batch row): the row's needed chunks
// merged in chunk order, their weights staged in shared memory.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const Params p) {
  extern __shared__ float ml_s[];  // [2][chunks needed]: m then w, l
  __shared__ int lo_hi[3];
  __shared__ float red_s[kWarps + 1];
  const int rr = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  live_chunks(p, b, lo_hi);
  __syncthreads();
  const int lo = lo_hi[0], nc = lo_hi[1] - lo_hi[0];
  const long long prow =
      ((static_cast<long long>(b) * p.Hk + hk) * p.rows + rr) * p.nchunks +
      lo;
  float mx = -INFINITY;
  for (int i = tid; i < nc; i += kThreads) {
    const float m = p.part_ml[(prow + i) * 2];
    ml_s[i] = m;
    ml_s[nc + i] = p.part_ml[(prow + i) * 2 + 1];
    mx = fmaxf(mx, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((tid & 31) == 0) red_s[tid >> 5] = mx;
  __syncthreads();
  float M = red_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_s[w]);
  for (int i = tid; i < nc; i += kThreads) ml_s[i] = expf(ml_s[i] - M);
  __syncthreads();
  if (tid == 0) {  // sum_i w_i l_i in chunk order
    float den = 0.0f;
    for (int i = 0; i < nc; ++i) {
      den = __fadd_rn(den, __fmul_rn(ml_s[i], ml_s[nc + i]));
    }
    red_s[kWarps] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const float den = red_s[kWarps];
  const int g = p.H / p.Hk;
  const int cq = rr / g;
  const int h = hk * g + (rr - cq * g);
  const long long off =
      ((static_cast<long long>(b) * p.C + cq) * p.H + h) * p.dh;
  for (int d = tid; d < p.dh; d += kThreads) {
    const float* acc = p.part_acc + prow * p.dh + d;
    float num = 0.0f;
#pragma unroll 8
    for (int i = 0; i < nc; ++i) {
      num = __fadd_rn(num, __fmul_rn(ml_s[i], acc[static_cast<long long>(i) *
                                                  p.dh]));
    }
    reinterpret_cast<QT*>(p.out)[off + d] = from_f32<QT>(num / den);
  }
}

template <int RB, int BITS, typename QT>
int launch_chunks(const Params& p, cudaStream_t stream) {
  const long long smem = smem_total(p.units, BITS, p.chunk, RB);
  auto kernel = paged_chunk_kernel<RB, BITS, QT>;
  static long long allowed = 48 * 1024;  // raised once per size needed
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(p.nchunks, p.Hk * p.groups, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nchunks == 1) return static_cast<int>(err);
  const int combine_smem = 2 * p.nchunks * static_cast<int>(sizeof(float));
  if (combine_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  paged_combine_kernel<QT>
      <<<dim3(p.rows, p.Hk, p.B), kThreads, combine_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename QT>
int launch_rows(const Params& p, int rb, cudaStream_t stream) {
  switch (rb) {
    case 1:
      return launch_chunks<1, BITS, QT>(p, stream);
    case 2:
      return launch_chunks<2, BITS, QT>(p, stream);
    case 4:
      return launch_chunks<4, BITS, QT>(p, stream);
    default:
      return launch_chunks<8, BITS, QT>(p, stream);
  }
}

template <int BITS>
int launch_bits(const Params& p, int rb, cudaStream_t stream) {
  if (p.q_dtype == epi::BF16) {
    return launch_rows<BITS, __nv_bfloat16>(p, rb, stream);
  }
  if (p.q_dtype == epi::F16) return launch_rows<BITS, __half>(p, rb, stream);
  return launch_rows<BITS, float>(p, rb, stream);
}

}  // namespace

extern "C" long long paged_attention_smem_bytes(int dhp, int bits, int chunk,
                                                int rb) {
  return smem_total((dhp + 15) / 16, bits, chunk, rb);
}

extern "C" int paged_attention_launch(
    const void* q, const uint8_t* kc, const float* ks, const uint8_t* vc,
    const float* vs, const int32_t* bt, const int32_t* pos,
    const float* codebook, void* out, float* part_ml, float* part_acc, int B,
    int C, int H, int Hk, int dh, int dhp, int bs, int nseq, int bits,
    int window, int q_dtype, float softcap, float scale, int chunk, int rb,
    void* stream) {
  if (B <= 0 || C <= 0 || Hk <= 0 || H % Hk != 0 || dh <= 0 || dh > 256 ||
      bs <= 0 || nseq <= 0 || chunk <= 0 || chunk % 16 != 0 ||
      (bits != 8 && bits != 4) || (rb != 1 && rb != 2 && rb != 4 && rb != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = C * (H / Hk);
  const int nchunks = (nseq * bs + chunk - 1) / chunk;
  if (nchunks > 1 && (part_ml == nullptr || part_acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(kc) |
                          reinterpret_cast<uintptr_t>(vc);
  Params p{q,     kc,    ks,   vc,       vs,      bt,     pos,   codebook,
           out,   part_ml, part_acc, B,  C,       H,      Hk,    dh,
           dhp,   bs,    nseq, window,   q_dtype, chunk,  nchunks, rows,
           (rows + rb - 1) / rb, (dhp + 15) / 16,
           dhp % 16 == 0 && align % 16 == 0, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 8 ? launch_bits<8>(p, rb, st) : launch_bits<4>(p, rb, st);
}
