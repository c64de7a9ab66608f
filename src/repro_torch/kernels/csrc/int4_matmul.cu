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
// Work split.  The grid is (row tiles, contraction splits, experts x
// column tiles): a stack of E experts' linears (the MoE block's, one
// launch for all of them) runs as E independent GeMMs whose operands sit
// at per-expert strides; a plain linear is E = 1.
// A block of 8 warps owns RPW output rows a warp (4; 2 at TB = 8, where
// the accumulators of 4 would not fit the registers), TB batch columns
// and one split: a range of whole 256-code steps of k, as many splits as
// it takes for the grid to fill the card (ops.int4_tiles).  It walks its
// range in tiles of tk codes (a multiple of 256): the tile's x goes to
// shared memory once, widened to f32 from x's own type and laid out
// [step][t][col / 4][lane][col % 4], so a lane reads 4 columns of one
// code with one conflict-free vector load, and every x value read there
// serves RPW rows; the scales of the tile's scale blocks for the block's
// rows go beside it.  For every 256 codes each lane takes 4 packed bytes
// (8 codes) of each of its warp's rows, loaded one step ahead.  A code
// becomes its float without a conversion instruction: the nibble, xor 8,
// is the low byte of 2^23's bit pattern (one byte permute), and
// subtracting 2^23 + 8 leaves its two's-complement value.
// Lane L thus sums the codes k = 256*S + 8*L + t (t = 0..7) in k order:
//   seg = seg + b(code) * x[k][col]     within one scale block
//   acc = acc + seg * scale[row, blk]   when the lane's scale block ends
// (the scale after each segment, not before each product).  With bf16 or
// f16 x the product is exact in f32 (4 bits times an 8- or 11-bit
// significand), so the segment step is one fma with the bits of a
// separate multiply and add; with f32 x it is __fmul_rn then __fadd_rn.
// A segment also ends where the block's split ends.  The 32 lane sums are
// added by an xor-shuffle tree (16, 8, 4, 2, 1).  With one split, lane 0
// applies the epilogue cast(act(acc + bias) + residual); with several,
// each split writes its partial sums to a (nsplit, b, m) workspace and a
// second kernel adds them in split order, then applies the epilogue (the
// workspace is per expert, (E, nsplit, b, m)).  No
// atomics: the result does not depend on which block ends first.  The
// plain PyTorch version repeats exactly these sums, so the two agree bit
// for bit except inside gelu/silu's tanh/exp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 256;  // codes of one step: 32 lanes x 8
constexpr int kStageBatch = 8;  // loads in flight a thread while staging

// output rows a warp: the accumulators, 2 x RPW x TB registers, stay in
// registers at three blocks an SM
__host__ __device__ constexpr int rows_per_warp(int tb) {
  return tb == 8 ? 2 : 4;
}

struct Params {
  const uint8_t* u8;     // (m, kb) packed codes, kb = ceil(k / 2)
  const float* scales;   // (m, nsb) row-major
  const void* x;         // x[row * xs_k + col * xs_b], row < k, x's type
  const float* bias;     // (m,) or null
  const void* res;       // res[row * rs_m + col * rs_b] or null, res_type
  void* out;             // out[row * os_m + col * os_b]
  float* ws;             // (E, nsplit, b, m) partial sums when nsplit > 1
  int m, k, kb, b, nsb, scale_block, tk, sc_pitch, split_steps, nsplit;
  long long xs_k, xs_b, rs_m, rs_b, os_m, os_b;
  int experts, col_tiles;  // the stack's E; ceil(b / TB)
  long long u8_e, sc_e, xs_e, os_e;  // per-expert strides (elements)
  int act, out_type, res_type;
  unsigned sb_magic;     // floor(2^32 / scale_block) + 1; 0 for 1
  int x_vec;             // x's k stride 1 and its columns 16-byte aligned
};

// kk / scale_block for kk * scale_block < 2^32 (the wrapper checks)
__device__ __forceinline__ int block_of(const Params& p, int kk) {
  return p.sb_magic ? static_cast<int>(__umulhi(kk, p.sb_magic)) : kk;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// 8 consecutive values of x from a 16-byte aligned address, widened
template <typename XT>
__device__ __forceinline__ void load8(const XT* src, float* v) {
  if constexpr (std::is_same_v<XT, float>) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
    const XT* h = reinterpret_cast<const XT*>(&a);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = widen(h[i]);
  }
}

// seg + c * x, rounded as a separate multiply and add
template <typename XT>
__device__ __forceinline__ float seg_add(float seg, float c, float x) {
  if constexpr (std::is_same_v<XT, float>) {
    return __fadd_rn(seg, __fmul_rn(c, x));
  } else {  // c * x is exact: the fma rounds once, as the add would
    return __fmaf_rn(c, x, seg);
  }
}

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

// code t of a word as a float: nib = (code ^ 8) sits in byte t/2 of hi
// (t even: the high nibble) or lo (t odd); placed as the low byte of
// 0x4B000000 (2^23) it reads 2^23 + nib, and 2^23 + 8 less is the
// two's-complement value, exactly.  t is a constant once unrolled.
__device__ __forceinline__ float code_value(uint32_t hi, uint32_t lo, int t) {
  return __int_as_float(__byte_perm((t & 1) ? lo : hi, 0x4B000000u,
                                    0x7540u | (t >> 1))) -
         8388616.0f;
}

template <typename XT, int TB, bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
int4_kernel(const Params p) {
  constexpr int RPW = rows_per_warp(TB);
  constexpr int CW = TB < 4 ? TB : 4;  // columns of one vector load
  constexpr int NH = TB / CW;
  // [tk/256][8][NH][32][CW] x, then [rows][sc_pitch] scales
  extern __shared__ __align__(16) float xs[];
  float* ss = xs + TB * p.tk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int brow = blockIdx.x * kWarps * RPW;  // the block's first row
  const int row0 = brow + warp * RPW;
  const int split = blockIdx.y;
  const int ex = blockIdx.z / p.col_tiles;  // the expert
  const int col0 = (blockIdx.z - ex * p.col_tiles) * TB;
  const int k_begin = split * p.split_steps * kStep;
  const int k_end = min(p.k, k_begin + p.split_steps * kStep);
  // the expert's operands
  const XT* x = static_cast<const XT*>(p.x) + ex * p.xs_e;
  const uint8_t* u8 = p.u8 + ex * p.u8_e;
  const float* scales = p.scales + ex * p.sc_e;
  const long long out0 = ex * p.os_e;

  float acc[RPW][TB], seg[RPW][TB], sc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    sc[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < TB; ++c) acc[r][c] = seg[r][c] = 0.0f;
  }
  // the current segment: scale block si, which ends before code seg_end
  int si = 0;
  int seg_end = 0;
  int blk0 = 0;  // the tile's first scale block
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int c = 0; c < TB; ++c) {
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(seg[r][c], sc[r]));
        seg[r][c] = 0.0f;
      }
    }
  };
  auto take_scales = [&]() {  // block si's, from the tile's
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      sc[r] = ss[(warp * RPW + r) * p.sc_pitch + si - blk0];
    }
  };
  // the words of the step whose first code (for this lane) is kb0
  uint32_t next[RPW];
  auto fetch = [&](int kb0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      next[r] = row < p.m
          ? load_word<VEC>(u8 + static_cast<long long>(row) * p.kb,
                           kb0 >> 1, p.kb)
          : 0u;
    }
  };
  fetch(k_begin + lane * 8);

  for (int t0 = k_begin; t0 < k_end; t0 += p.tk) {
    const int tlen = min(p.tk, k_end - t0);
    blk0 = block_of(p, t0);
    __syncthreads();  // the previous tile is consumed
    // x: element (((S * 8 + t) * NH + h) * 32 + L) * CW + cc holds
    // x[t0 + kl][h * CW + cc] with kl = 256 S + 8 L + t.  A thread takes
    // lane L's 8 codes of one column at a time (one or two 16-byte loads
    // where x's k stride is 1); neighbouring threads take neighbouring
    // columns, then lanes, so the stores do not share banks
    for (int u = threadIdx.x; u < (p.tk / kStep) * 32 * TB; u += kThreads) {
      const int c = u % TB;
      const int lv = (u / TB) & 31;
      const int st = u / (32 * TB);  // step S of the tile
      const int kl = st * kStep + lv * 8;
      const int col = col0 + c;
      float v[8];
      if (p.x_vec && kl + 8 <= tlen && col < p.b) {
        load8<XT>(x + (t0 + kl) + col * p.xs_b, v);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[t] = (kl + t < tlen && col < p.b)
                     ? widen(x[(t0 + kl + t) * p.xs_k + col * p.xs_b]) : 0.0f;
        }
      }
      float* dst = xs + ((st * 8 * NH + c / CW) * 32 + lv) * CW + c % CW;
#pragma unroll
      for (int t = 0; t < 8; ++t) dst[t * NH * 32 * CW] = v[t];
    }
    // scales: element r * sc_pitch + j holds scale[brow + r, blk0 + j]
    const int ns = kWarps * RPW * p.sc_pitch;
    for (int e0 = threadIdx.x; e0 < ns; e0 += kThreads * kStageBatch) {
      float v[kStageBatch];
#pragma unroll
      for (int i = 0; i < kStageBatch; ++i) {
        const int e = e0 + i * kThreads;
        const int r = e / p.sc_pitch;
        const int blk = blk0 + e - r * p.sc_pitch;
        const int row = brow + r;
        v[i] = (e < ns && row < p.m && blk < p.nsb)
                   ? __ldg(scales + static_cast<long long>(row) * p.nsb + blk)
                   : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kStageBatch; ++i) {
        if (e0 + i * kThreads < ns) ss[e0 + i * kThreads] = v[i];
      }
    }
    __syncthreads();
    for (int s = 0; s * kStep < tlen; ++s) {
      const int kbase = t0 + s * kStep + lane * 8;  // this lane's first code
      uint32_t hi[RPW], lo[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const uint32_t f = next[r] ^ 0x88888888u;
        hi[r] = (f >> 4) & 0x0F0F0F0Fu;
        lo[r] = f & 0x0F0F0F0Fu;
      }
      if (kbase + kStep < k_end) fetch(kbase + kStep);  // one step ahead
      if (kbase >= p.k) continue;
      if (kbase >= seg_end) {  // the lane's first code of a scale block
        flush();
        si = block_of(p, kbase);
        seg_end = (si + 1) * p.scale_block;
        take_scales();
      }
      const float* xt = xs + (s * 8 * NH * 32 + lane) * CW;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int kk = kbase + t;
        if (kk >= p.k) break;
        if (t > 0 && kk >= seg_end) {  // the next scale block starts here
          flush();
          ++si;
          seg_end += p.scale_block;
          take_scales();
        }
        float xv[TB];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float* src = xt + (t * NH + h) * 32 * CW;
          if constexpr (CW == 4) {
            const float4 q = *reinterpret_cast<const float4*>(src);
            xv[4 * h] = q.x; xv[4 * h + 1] = q.y;
            xv[4 * h + 2] = q.z; xv[4 * h + 3] = q.w;
          } else if constexpr (CW == 2) {
            const float2 q = *reinterpret_cast<const float2*>(src);
            xv[0] = q.x; xv[1] = q.y;
          } else {
            xv[0] = src[0];
          }
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float cv = code_value(hi[r], lo[r], t);
#pragma unroll
          for (int c = 0; c < TB; ++c) {
            seg[r][c] = seg_add<XT>(seg[r][c], cv, xv[c]);
          }
        }
      }
    }
  }
  flush();  // the split's last segment

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
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
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= p.m) continue;
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      const int col = col0 + c;
      if (col >= p.b) continue;
      if (p.nsplit == 1) {
        epi::finish(acc[r][c], p.bias != nullptr, p.bias ? p.bias[row] : 0.0f,
                    p.act, p.res != nullptr,
                    p.res ? epi::load(p.res, row * p.rs_m + col * p.rs_b,
                                      p.res_type)
                          : 0.0f,
                    p.out, out0 + row * p.os_m + col * p.os_b, p.out_type);
      } else {
        p.ws[((static_cast<long long>(ex) * p.nsplit + split) * p.b + col) *
                 p.m + row] = acc[r][c];
      }
    }
  }
}

// the splits' partial sums added in split order, then the epilogue; one
// thread an (expert, column, row)
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const Params p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const long long mb = static_cast<long long>(p.m) * p.b;
  if (i >= mb * p.experts) return;
  const long long ex = i / mb;
  const long long e = i - ex * mb;
  const int row = static_cast<int>(e % p.m);
  const int col = static_cast<int>(e / p.m);
  const float* ws = p.ws + ex * p.nsplit * mb;
  float t = ws[e];
  for (int s = 1; s < p.nsplit; ++s) t = __fadd_rn(t, ws[s * mb + e]);
  epi::finish(t, p.bias != nullptr, p.bias ? p.bias[row] : 0.0f, p.act,
              p.res != nullptr,
              p.res ? epi::load(p.res, row * p.rs_m + col * p.rs_b, p.res_type)
                    : 0.0f,
              p.out, ex * p.os_e + row * p.os_m + col * p.os_b, p.out_type);
}

// shared memory of a block: the x tile and the tile's scales
// (repro_torch/kernels/int4_matmul.py::smem_bytes mirrors it)
long long smem_bytes(int tb, int tk, int sc_pitch) {
  return 4LL * (static_cast<long long>(tb) * tk +
                static_cast<long long>(kWarps) * rows_per_warp(tb) * sc_pitch);
}

template <typename XT, int TB>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  // at most 48 KiB (int4_matmul.py::stage_codes), no opt-in needed
  const size_t smem = static_cast<size_t>(smem_bytes(TB, p.tk, p.sc_pitch));
  void (*kern)(const Params) =
      vec ? &int4_kernel<XT, TB, true> : &int4_kernel<XT, TB, false>;
  constexpr int rows = kWarps * rows_per_warp(TB);
  const dim3 grid((p.m + rows - 1) / rows, p.nsplit,
                  static_cast<unsigned>(p.experts) * p.col_tiles);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_tb(const Params& p, int tb, bool vec, cudaStream_t s) {
  switch (tb) {
    case 1: return launch<XT, 1>(p, vec, s);
    case 2: return launch<XT, 2>(p, vec, s);
    case 4: return launch<XT, 4>(p, vec, s);
    case 8: return launch<XT, 8>(p, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// shared memory bytes a block of the given variant asks for
extern "C" long long int4_smem_bytes(int tb, int tk, int sc_pitch) {
  return smem_bytes(tb, tk, sc_pitch);
}

extern "C" int int4_matmul_launch(
    const uint8_t* u8, const float* scales, const void* x, const float* bias,
    const void* res, void* out, float* ws, int m, int k, int kb, int b,
    int nsb, int scale_block, int tk, int sc_pitch, int split_steps,
    int nsplit, int tb,
    int vec, long long xs_k, long long xs_b, long long rs_m, long long rs_b,
    long long os_m, long long os_b, int act, int out_type, int x_type,
    int res_type, unsigned sb_magic, int x_vec, int experts,
    long long xs_e, long long os_e, void* stream) {
  const int col_tiles = tb > 0 ? (b + tb - 1) / tb : 0;
  Params p{u8, scales, x, bias, res, out, ws, m, k, kb, b, nsb, scale_block,
           tk, sc_pitch, split_steps, nsplit, xs_k, xs_b, rs_m, rs_b, os_m,
           os_b, experts, col_tiles,
           static_cast<long long>(m) * kb, static_cast<long long>(m) * nsb,
           xs_e, os_e, act, out_type, res_type, sb_magic, x_vec};
  if (tk <= 0 || tk % kStep || split_steps <= 0 || nsplit <= 0 ||
      sc_pitch < tk / scale_block + 2 || (nsplit > 1 && ws == nullptr) ||
      experts <= 0 || tb <= 0 ||
      static_cast<long long>(experts) * col_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  cudaError_t err;
  switch (x_type) {
    case epi::F32: err = launch_tb<float>(p, tb, v, s); break;
    case epi::BF16: err = launch_tb<__nv_bfloat16>(p, tb, v, s); break;
    case epi::F16: err = launch_tb<__half>(p, tb, v, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsplit > 1) {
    const long long mb = static_cast<long long>(m) * b * experts;
    reduce_kernel<<<static_cast<unsigned>((mb + kReduceThreads - 1) /
                                          kReduceThreads),
                    kReduceThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
