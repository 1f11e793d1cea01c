// Fused LayerNorm + matmul + bias + activation: out = act(LN(x) @ W + b).
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/fused_block.py:
// _kernel (its pallas_call in _fwd_call). That kernel keeps a whole
// (256, d) block of x in VMEM across an inner sweep over column tiles of W.
// A Hopper block has far less fast memory (the (64, d) normalized tile is
// 160 KB in bf16 and 320 KB in f32 at d = 1280), so this one is a GEMM whose
// A-tile loader is the LayerNorm: each block first takes its rows' mean and
// variance (f32, two passes over d, as jnp.var), then walks d in k-chunks of
// 32, normalizing each chunk of x as it stages it in shared memory. Every d
// the model family uses works the same way, and nothing of the normalized
// tensor reaches device memory.
//
// Numerics follow the Pallas kernel: x is read in its own dtype and widened,
// y = (x - mean) * rsqrt(var + 1e-5) * g + beta in f32, rounded to W's dtype
// before the product; the product accumulates in f32; + b in f32, then the
// activation (erf gelu, tanh gelu or none) in f32, then one cast to the
// output dtype. Rows beyond N and columns beyond E are masked, so N needs no
// padding to a tile multiple.
//
// What bounds it on an H100: 2*N*d*E operations against (N*d + d*E + N*E)
// elements, so operations at the model's widths. bf16 runs the product on
// the tensor cores with mma.sync (m16n8k16, f32 accumulators), one 32x32
// warp tile per warp, no software pipeline: a first version bound by
// shared-memory staging and load latency, well below the bf16 bound; wgmma,
// TMA and a persistent schedule are later work. f32 is true f32 (no TF32) on
// the CUDA cores, 4x8 outputs per thread.
//
// Layout: x (N, d) with row stride ldx, the last axis contiguous; W passed
// as W^T, (E, d) row-major with row stride ldw (k contiguous: the nn.Linear
// weight layout, so the model's weights are read in place); g, beta (d,) and
// b (E,) f32; out (N, E) contiguous. d, ldx and ldw are multiples of 8 and the
// pointers 16-byte aligned (the wrapper checks), so every 8-wide k-group of
// a row is one aligned 16-byte load.
#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // depth of one k-chunk
constexpr int THREADS = 256;  // 8 warps
constexpr float EPS = 1e-5f;

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2 };

struct Args {
  const void* x;
  const float* g;
  const float* beta;
  const void* w;
  const float* b;  // nullptr: no bias
  void* out;
  int N, d, E;
  long long ldx, ldw;
  int act;
};

// jax.nn.gelu: exact 0.5 x erfc(-x / sqrt 2), or the tanh approximation
__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_GELU) return 0.5f * v * erfcf(-v * 0.70710678118654752f);
  if (act == ACT_GELU_TANH) {
    const float c = 0.79788456080286536f;  // sqrt(2 / pi)
    return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * v * v * v))));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Mean and 1/sqrt(var + eps) of the block's BM rows, one warp per row at a
// time; rows beyond N get zeros (their outputs are never written).
template <typename T>
__device__ void row_stats(const Args& a, int m0, float* mean_s, float* rstd_s) {
  const T* x = static_cast<const T*>(a.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < a.N) {
      const T* xr = x + row * a.ldx;
      float s = 0.f;
      for (int k = lane; k < a.d; k += 32) s += to_f32(xr[k]);
      mean = warp_sum(s) / a.d;
      float v = 0.f;
      for (int k = lane; k < a.d; k += 32) {
        const float t = to_f32(xr[k]) - mean;
        v = fmaf(t, t, v);
      }
      rstd = rsqrtf(warp_sum(v) / a.d + EPS);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

__device__ __forceinline__ float normalize(float xv, float mean, float rstd, const Args& a,
                                           int k) {
  return (xv - mean) * rstd * __ldg(a.g + k) + __ldg(a.beta + k);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ void store_out(const Args& a, int row, int col, float v) {
  if (row >= a.N || col >= a.E) return;
  if (a.b != nullptr) v += a.b[col];
  static_cast<T*>(a.out)[static_cast<long long>(row) * a.E + col] =
      from_f32<T>(activate(v, a.act));
}

// bf16: 8 warps as 2 (rows) x 4 (columns), each a 32x32 tile of 2 x 4 mma
// tiles. Shared tiles are k-contiguous with a row stride of 40 elements (80
// bytes), so the fragment reads (8 rows x 4 words per instruction) hit 32
// distinct banks.
__global__ void __launch_bounds__(THREADS) ln_matmul_bf16(Args a) {
  constexpr int SK = BK + 8;
  __shared__ __align__(16) __nv_bfloat16 as[BM * SK];
  __shared__ __align__(16) __nv_bfloat16 bs[BN * SK];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // mma group, thread in group
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;

  row_stats<__nv_bfloat16>(a, m0, mean_s, rstd_s);
  __syncthreads();

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int ar = tid >> 2, ak = (tid & 3) * 8;  // this thread's 8 values of the A chunk
  const int arow = m0 + ar;
  const float amean = mean_s[ar], arstd = rstd_s[ar];

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < a.d; k0 += BK) {
    {  // A chunk: LayerNorm of x, rounded to bf16
      const int k = k0 + ak;
      uint4 y = make_uint4(0u, 0u, 0u, 0u);
      if (arow < a.N && k < a.d) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + arow * a.ldx + k);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 v = unpack_bf16(words[j]);
          packed[j] = pack_bf16(normalize(v.x, amean, arstd, a, k + 2 * j),
                                normalize(v.y, amean, arstd, a, k + 2 * j + 1));
        }
        y = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      *reinterpret_cast<uint4*>(as + ar * SK + ak) = y;
    }
    for (int i = tid; i < BN * BK / 8; i += THREADS) {  // B chunk: W^T rows
      const int n = i >> 2, kk = (i & 3) * 8;
      const int col = n0 + n, k = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < a.E && k < a.d) v = *reinterpret_cast<const uint4*>(w + col * a.ldw + k);
      *reinterpret_cast<uint4*>(bs + n * SK + kk) = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = as + (wm + mt * 16 + gq) * SK + ks + tq * 2;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * SK);
        af[mt][2] = ld32(p + 8);
        af[mt][3] = ld32(p + 8 * SK + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = bs + (wn + nt * 8 + gq) * SK + ks + tq * 2;
        bf[nt][0] = ld32(p);
        bf[nt][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();  // the chunk is consumed before the next one is staged
  }

  // accumulator (mt, nt, e): row gq (+8 for e >= 2), column tq*2 + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out<__nv_bfloat16>(a, m0 + wm + mt * 16 + gq + (e >> 1) * 8,
                                 n0 + wn + nt * 8 + tq * 2 + (e & 1), acc[mt][nt][e]);
}

// f32: 16 x 16 threads, each 4 rows x 8 columns (two groups of 4, 64 apart,
// so a half-warp's float4 reads of a B row are contiguous). Shared tiles are
// k-major: as[k][m], bs[k][n].
__global__ void __launch_bounds__(THREADS) ln_matmul_f32(Args a) {
  constexpr int SA = BM + 4, SB = BN + 4;
  __shared__ __align__(16) float as[BK * SA];
  __shared__ __align__(16) float bs[BK * SB];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  row_stats<float>(a, m0, mean_s, rstd_s);
  __syncthreads();

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.d; k0 += BK) {
    for (int i = tid; i < BM * BK / 4; i += THREADS) {  // A chunk: LayerNorm of x
      const int r = i >> 3, kk = (i & 7) * 4;
      const int row = m0 + r, k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.N && k < a.d) {
        v = *reinterpret_cast<const float4*>(x + row * a.ldx + k);
        const float mean = mean_s[r], rstd = rstd_s[r];
        v = make_float4(normalize(v.x, mean, rstd, a, k), normalize(v.y, mean, rstd, a, k + 1),
                        normalize(v.z, mean, rstd, a, k + 2),
                        normalize(v.w, mean, rstd, a, k + 3));
      }
      as[(kk + 0) * SA + r] = v.x;
      as[(kk + 1) * SA + r] = v.y;
      as[(kk + 2) * SA + r] = v.z;
      as[(kk + 3) * SA + r] = v.w;
    }
    for (int i = tid; i < BN * BK / 4; i += THREADS) {  // B chunk: W^T rows
      const int n = i >> 3, kk = (i & 7) * 4;
      const int col = n0 + n, k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < a.E && k < a.d) v = *reinterpret_cast<const float4*>(w + col * a.ldw + k);
      bs[(kk + 0) * SB + n] = v.x;
      bs[(kk + 1) * SB + n] = v.y;
      bs[(kk + 2) * SB + n] = v.z;
      bs[(kk + 3) * SB + n] = v.w;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * SA + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * SB + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * SB + 64 + tx * 4);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_out<float>(a, m0 + ty * 4 + i, n0 + (j >> 2) * 64 + tx * 4 + (j & 3), acc[i][j]);
}

}  // namespace

// out = act(LN(x) @ W + b). x (N, d) and W^T (E, d) of one dtype (f32 or
// bf16) with row strides ldx and ldw in elements; g, beta, b f32 (b may be
// null); act 0 none, 1 gelu (erf), 2 gelu (tanh). Needs d % 8 == 0.
WCB_EXPORT int wcb_fused_ln_matmul(int dtype, const void* x, const float* g,
                                   const float* beta, const void* w, const float* b,
                                   void* out, int N, int d, int E, long long ldx,
                                   long long ldw, int act, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || E <= 0 || d % 8 != 0 || act < ACT_NONE || act > ACT_GELU_TANH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, g, beta, w, b, out, N, d, E, ldx, ldw, act};
  const dim3 grid((E + BN - 1) / BN, (N + BM - 1) / BM);
  if (dtype == WCB_BF16)
    ln_matmul_bf16<<<grid, THREADS, 0, stream>>>(a);
  else if (dtype == WCB_F32)
    ln_matmul_f32<<<grid, THREADS, 0, stream>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
