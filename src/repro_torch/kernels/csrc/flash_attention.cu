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
// Two routes, picked by the input types:
//
// * bf16 or f16 q, k and v (all one type): the tensor cores.  One block
//   owns TQ query rows of one (batch, query head), one warp 16 of them,
//   and streams TK-key tiles of K and V through a ring of STAGES buffers
//   in shared memory, filled with 16-byte cp.async copies (zero-filled
//   past Skv) so the next tiles' loads overlap this tile's products.
//   Rows are padded to DP + 8 elements (DP: the head dim rounded up to a
//   power-of-two class, the padding zero), which makes every ldmatrix of
//   8 rows hit 8 distinct 16-byte bank groups.  Both products are
//   mma.sync.m16n8k16 with f32 accumulation: s = q . k from ldmatrix
//   fragments of q and k in their own type, then the dh^-0.5 scale on s
//   in f32; the soft-cap, the mask and the online softmax run on the
//   accumulator fragments in registers, each row's max and sum reduced
//   over the 4 threads of a quad with shuffles.  p feeds p . v from
//   registers as the A operand, split in two: p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi) (f16 for f16 inputs), two mma against each V fragment
//   (ldmatrix.trans).  One rounding of p to bf16, as FlashAttention-2 and
//   sdpa do, puts the bf16 outputs tens of ulps from the f32 result; the
//   split keeps them within one, at 1.5x the mma work of one product
//   pair.  The tile shapes are template arguments; flash_attention.py
//   lists the compiled ones and picks one per head-dim class.
// * anything else (f32 inputs or mixed types): register-blocked f32 FMA
//   on 64 x 64 tiles converted to f32 in shared memory, with q scaled
//   before the dot, unchanged from the first port.
//
// Both routes run from the tile holding the lowest window start of the
// block's rows to the causal diagonal (the Pallas kernel bounds only the
// diagonal; the tiles below the window are masked for every row and
// change no bit, see repro_torch/kernels/flash_attention.py), and the
// grid runs the longest causal rows first.
//
// Build (repro_torch/kernels/nvcc.py): nvcc -gencode
//   arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//   -I csrc -o libflash_attention.so flash_attention.cu
// Plain C interface, loaded with ctypes.
//
// Per key tile, either route:
//   s = q . k (scaled before or after the dot, see above), then softcap
//   c*tanh(s/c), then the mask kpos <= qpos (causal) and kpos > qpos -
//   window, masked entries set to the finite -1e30; keys past Skv do not
//   exist and get -inf, so probability exactly 0 whatever the row sees;
//   then the online-softmax update
//     m' = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m');
//     l' = corr*l + sum_j p;  acc' = corr*acc + p @ v
// and the block writes acc / max(l, 1e-30) in q's dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;  // (B, H, Sq, dh) in q_dtype
  const void* k;  // (B, Hk, Skv, dh) in k_dtype
  const void* v;  // (B, Hk, Skv, dh) in v_dtype
  void* out;      // (B, H, Sq, dh) in q_dtype
  int B, H, Hk, Sq, Skv, dh;
  int dp;  // FMA route: shared row stride in floats (dh rounded up to 4,
           // plus 4)
  int causal, window, q_dtype, k_dtype, v_dtype;
  float softcap, scale;
  int vec;  // tensor-core route: rows load as 16-byte cp.async copies
};

// the key tiles [lo, hi) a block of tq rows starting at q0 visits
__device__ __forceinline__ void tile_range(const Params& p, int q0, int tq,
                                           int tk, int* lo, int* hi) {
  const int nk = (p.Skv + tk - 1) / tk;
  *lo = p.window ? max(0, q0 - p.window + 1) / tk : 0;
  *hi = p.causal ? min((q0 + tq + tk - 1) / tk, nk) : nk;
}

// soft-cap and mask of one score (both routes)
__device__ __forceinline__ float mask_score(const Params& p, float x,
                                            int qpos, int kpos) {
  if (p.softcap != 0.0f) x = p.softcap * tanhf(x / p.softcap);
  bool ok = true;
  if (p.causal) ok = kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  x = ok ? x : kNegInf;
  if (kpos >= p.Skv) x = -INFINITY;
  return x;
}

// ------------------------------------------------------------ FMA route
constexpr int kThreads = 256;
constexpr int kTQ = 64;   // query rows per block
constexpr int kTK = 64;   // keys per streamed tile
constexpr int kCols = kMaxDh / 64;  // float4 accumulator columns a thread
constexpr int kPStride = kTK + 4;

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
flash_fma_kernel(const Params p) {
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
  int lo, hi;
  tile_range(p, q0, kTQ, kTK, &lo, &hi);
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

    // scores of rows ty + 16i against keys tx + 16c
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

    // online softmax, one row's 64 keys over the 16 threads tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = mask_score(p, s[i][c], qpos, k0 + tx + 16 * c);
        mx = fmaxf(mx, s[i][c]);
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

// ---------------------------------------------------- tensor-core route
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared, the bytes past src_bytes zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// the element type's mma, the rounding of a float to it and back, and
// the packing of two floats (lower column first) into an A register
template <typename T>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kDType = epi::BF16;
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elt<__half> {
  static constexpr int kDType = epi::F16;
  __device__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// p0, p1 (neighbouring keys of one row) as the hi and lo A registers
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const float h0 = Elt<T>::round(p0);
  const float h1 = Elt<T>::round(p1);
  hi = Elt<T>::pack(h0, h1);
  lo = Elt<T>::pack(p0 - h0, p1 - h1);
}

// shared-memory bytes of a tensor-core block
__host__ __device__ constexpr int mma_smem_bytes(int dp, int tq, int tk,
                                                 int stages) {
  return (tq + 2 * stages * tk) * (dp + 8) * 2;
}

// rows [r0, r0 + rows) of one head's (S, dh) matrix at `src` into a
// shared tile of row stride DS elements: 16-byte cp.async copies when
// `vec` (dh % 8 == 0, 16-byte aligned rows; rows past S zero-filled,
// columns past dh left as the kernel's zero fill), else element by
// element, every column of the tile written
template <int DP, int NT>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           int r0, int rows, int S, int dh,
                                           bool vec) {
  constexpr int DS = DP + 8;
  if (vec) {
    const int cpr = dh / 8;
    for (int e = threadIdx.x; e < rows * cpr; e += NT) {
      const int r = e / cpr;
      const int c = e - r * cpr;
      const bool ok = r0 + r < S;
      const uint16_t* s =
          src + static_cast<long long>(ok ? r0 + r : 0) * dh + 8 * c;
      cp_async16(dst + r * DS + 8 * c, s, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += NT) {
      const int r = e / DP;
      const int d = e - r * DP;
      uint16_t x = 0;
      if (r0 + r < S && d < dh) {
        x = src[static_cast<long long>(r0 + r) * dh + d];
      }
      dst[r * DS + d] = x;
    }
  }
}

template <typename T, int DP, int TQ, int TK, int STAGES>
__global__ void __launch_bounds__(TQ * 2, 1)
flash_mma_kernel(const Params p) {
  constexpr int NT = TQ * 2;  // threads: one warp per 16 query rows
  constexpr int DS = DP + 8;  // shared row stride, elements
  constexpr int NK = TK / 8;  // n-tiles of s a warp holds
  constexpr int ND = DP / 8;  // n-tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16 or f16 bits, moved and read as 16-bit words
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);  // [TQ][DS]
  uint16_t* k_s = q_s + TQ * DS;               // [STAGES][TK][DS]
  uint16_t* v_s = k_s + STAGES * TK * DS;      // [STAGES][TK][DS]

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // the fragment's row group
  const int tg = lane & 3;   // the thread within the quad
  const int q0 = iq * TQ;
  int lo, hi;
  tile_range(p, q0, TQ, TK, &lo, &hi);
  const uint16_t* qh = reinterpret_cast<const uint16_t*>(p.q) +
                (static_cast<long long>(b) * p.H + h) * p.Sq * p.dh;
  const long long kv_base =
      (static_cast<long long>(b) * p.Hk + hk) * p.Skv * p.dh;
  const uint16_t* kh = reinterpret_cast<const uint16_t*>(p.k) + kv_base;
  const uint16_t* vh = reinterpret_cast<const uint16_t*>(p.v) + kv_base;
  const bool vec = p.vec != 0;

  // zero the tiles once: the padding columns are never written again
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    constexpr int n16 = mma_smem_bytes(DP, TQ, TK, STAGES) / 16;
    for (int e = threadIdx.x; e < n16; e += NT) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // q and the first STAGES - 1 tiles, one cp.async group each
  stage_rows<DP, NT>(q_s, qh, q0, TQ, p.Sq, p.dh, vec);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (lo + st < hi) {
      stage_rows<DP, NT>(k_s + st * TK * DS, kh, (lo + st) * TK, TK,
                            p.Skv, p.dh, vec);
      stage_rows<DP, NT>(v_s + st * TK * DS, vh, (lo + st) * TK, TK,
                            p.Skv, p.dh, vec);
    }
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  const int row_a = q0 + warp * 16 + g;  // rows of fragment halves 0, 1
  const int row_b = row_a + 8;

  for (int j = lo; j < hi; ++j) {
    const int it = j - lo;
    // tile j + STAGES - 1 goes where tile j - 1 was: all warps are done
    __syncthreads();
    if (j + STAGES - 1 < hi) {
      const int st = (it + STAGES - 1) % STAGES;
      stage_rows<DP, NT>(k_s + st * TK * DS, kh, (j + STAGES - 1) * TK,
                            TK, p.Skv, p.dh, vec);
      stage_rows<DP, NT>(v_s + st * TK * DS, vh, (j + STAGES - 1) * TK,
                            TK, p.Skv, p.dh, vec);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile j (and q) have landed
    __syncthreads();
    const uint16_t* kt = k_s + (it % STAGES) * TK * DS;
    const uint16_t* vt = v_s + (it % STAGES) * TK * DS;
    const int k0 = j * TK;

    // s = q . k for the warp's 16 rows and the tile's TK keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * DS + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        Elt<T>::mma(s[2 * np], a, bk[0], bk[1]);
        Elt<T>::mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, soft-cap, mask; the online softmax of rows row_a and row_b
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * tg + (e & 1);
        const float x = mask_score(p, __fmul_rn(s[n][e], p.scale),
                                   e < 2 ? row_a : row_b, kpos);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        sum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = corr[hh] * l[hh] + sum[hh];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p_hi @ v + p_lo @ v, 16 keys a step
#pragma unroll
    for (int t = 0; t < TK / 16; ++t) {
      uint32_t ahi[4], alo[4];
      split_pair<T>(s[2 * t][0], s[2 * t][1], ahi[0], alo[0]);
      split_pair<T>(s[2 * t][2], s[2 * t][3], ahi[1], alo[1]);
      split_pair<T>(s[2 * t + 1][0], s[2 * t + 1][1], ahi[2], alo[2]);
      split_pair<T>(s[2 * t + 1][2], s[2 * t + 1][3], ahi[3], alo[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   DS + dp * 16 + (lane >> 4) * 8);
        Elt<T>::mma(acc[2 * dp], ahi, bv[0], bv[1]);
        Elt<T>::mma(acc[2 * dp], alo, bv[0], bv[1]);
        Elt<T>::mma(acc[2 * dp + 1], ahi, bv[2], bv[3]);
        Elt<T>::mma(acc[2 * dp + 1], alo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  const long long o_base =
      (static_cast<long long>(b) * p.H + h) * p.Sq * p.dh;
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int d = n * 8 + 2 * tg + (e & 1);
      if (row < p.Sq && d < p.dh) {
        epi::store(p.out, o_base + static_cast<long long>(row) * p.dh + d,
                   Elt<T>::kDType, acc[n][e] / den[e >> 1]);
      }
    }
  }
}

template <typename T, int DP, int TQ, int TK, int STAGES>
int launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(DP, TQ, TK, STAGES);
  auto kernel = flash_mma_kernel<T, DP, TQ, TK, STAGES>;
  static bool allowed = smem <= 48 * 1024;  // set once per variant
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const dim3 grid((p.Sq + TQ - 1) / TQ, p.H, p.B);
  kernel<<<grid, TQ * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The compiled tensor-core variants (dtype, head-dim class, tq, tk,
// stages); repro_torch/kernels/flash_attention.py keeps the same list.
#define FLASH_MMA_VARIANTS(X)          \
  X(__nv_bfloat16, epi::BF16, 16, 128, 64, 2)  \
  X(__nv_bfloat16, epi::BF16, 32, 128, 64, 2)  \
  X(__nv_bfloat16, epi::BF16, 64, 128, 64, 2)  \
  X(__nv_bfloat16, epi::BF16, 128, 128, 64, 2) \
  X(__nv_bfloat16, epi::BF16, 256, 128, 64, 2) \
  X(__nv_bfloat16, epi::BF16, 256, 64, 64, 2)  \
  X(__nv_bfloat16, epi::BF16, 256, 64, 32, 2)  \
  X(__nv_bfloat16, epi::BF16, 256, 128, 32, 2) \
  X(__nv_bfloat16, epi::BF16, 256, 64, 32, 3)  \
  X(__nv_bfloat16, epi::BF16, 256, 128, 32, 3) \
  X(__half, epi::F16, 16, 128, 64, 2)          \
  X(__half, epi::F16, 32, 128, 64, 2)          \
  X(__half, epi::F16, 64, 128, 64, 2)          \
  X(__half, epi::F16, 128, 128, 64, 2)         \
  X(__half, epi::F16, 256, 128, 64, 2)

}  // namespace

// the head-dim class of the tensor-core route: dh rounded up to a power
// of two, at least 16
static int dh_class(int dh) {
  int c = 16;
  while (c < dh) c *= 2;
  return c;
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hk, int Sq, int Skv, int dh,
                                      int causal, int window, int q_dtype,
                                      int k_dtype, int v_dtype, float softcap,
                                      float scale, int tq, int tk, int stages,
                                      void* stream) {
  if (dh <= 0 || dh > kMaxDh || Hk <= 0 || H % Hk != 0 || Sq <= 0 ||
      B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{q,       k,       v,       out,     B,      H,      Hk,
           Sq,      Skv,     dh,      0,       causal, window, q_dtype,
           k_dtype, v_dtype, softcap, scale,   0};
  const bool tensor_core = q_dtype != epi::F32 && q_dtype == k_dtype &&
                           q_dtype == v_dtype;
  if (tensor_core) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    p.vec = dh % 8 == 0 && bits % 16 == 0;
    const int dc = dh_class(dh);
#define FLASH_MMA_DISPATCH(T, DT, DP, TQ, TK, ST)                   \
  if (q_dtype == DT && dc == DP && tq == TQ && tk == TK && stages == ST) \
    return launch_mma<T, DP, TQ, TK, ST>(p, st);
    FLASH_MMA_VARIANTS(FLASH_MMA_DISPATCH)
#undef FLASH_MMA_DISPATCH
    return static_cast<int>(cudaErrorInvalidValue);  // not compiled
  }
  if (tq != kTQ || tk != kTK) return static_cast<int>(cudaErrorInvalidValue);
  p.dp = 4 * ((dh + 3) / 4) + 4;
  const size_t smem = static_cast<size_t>(kTQ * p.dp + 2 * kTK * p.dp +
                                          kTQ * kPStride) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_fma_kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
