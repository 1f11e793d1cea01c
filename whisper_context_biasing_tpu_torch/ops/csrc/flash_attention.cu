// Flash attention forward, full or causal, with a key-length mask.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/flash_attention.py:
// _fwd_kernel (its pallas_call in _flash_fwd_call). That kernel holds a whole
// (BQ, Tk) f32 score block in VMEM and takes one softmax over it; a Hopper
// block has far less fast memory, so this one walks the keys in tiles of 64
// with an online softmax (running row max and row sum, the output rescaled
// as the max grows). It also writes the per-row logsumexp, which the flash
// backward (flash_attention_bwd.cu) reads.
//
// Causal (decoder self-attention, Tq == Tk): key j is masked for query row i
// when j > i, as in _masked_scores. BQ == BK, so a block stops at the tile
// holding its diagonal, and every tile it visits has at least one unmasked
// key in each row: no row ever takes exp(0) of a fully masked tile.
//
// What bounds it on an H100: the two products, 4*T*T*64 operations per
// head, against 4*T*64 elements of q, k, v and o: operations, by far. This
// first version computes in float32 on the CUDA cores (exact products for
// bf16 inputs, f32 sums), 4x4 outputs per thread from float4 reads of
// shared memory, so it is bound by the f32 rate and shared-memory traffic,
// well below the bf16 tensor-core bound; wgmma and TMA are later work.
//
// Numerics follow the Pallas kernel: scores are (q.k) * scale in f32, keys
// at or beyond kv_len get the f32 minimum (not -inf), the probabilities are
// cast to the input dtype before P.V, and the output is normalised after it.
//
// Layout: q (B, Tq, H, 64), k and v (B, Tk, H, 64) with any batch, row and
// head strides (the last axis contiguous), so merged-head (B, T, H*64)
// activations are read in place; o (B, Tq, H, 64) and lse (B, H, Tq) f32.
#include "common.cuh"

namespace {

constexpr int D = 64;    // head dim
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS_STRIDE = BK + 4;

struct Strides {
  long long b, t, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int kv_len,
                     float scale, int causal, Strides sq, Strides sk, Strides sv,
                     Strides so) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D][BQ]  q, transposed
  float* ks = qs + D * BQ;                      // [D][BK]  k tile, transposed
  float* vs = ks + D * BK;                      // [BK][D]  v tile
  float* ps = vs + BK * D;                      // [BQ][PS_STRIDE] probabilities

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // owns columns tx*4 .. tx*4+3

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // lanes walk rows, so the transposed shared-memory writes do not conflict
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int d = i / BQ;
    const int r = i - d * BQ;
    qs[d * BQ + r] = (q0 + r < Tq) ? to_f32(qb[(q0 + r) * sq.t + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q0 / BK + 1);  // tiles up to the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int d = i / BK;
      const int c = i - d * BK;
      ks[d * BK + c] = (k0 + c < kv_len) ? to_f32(kb[(k0 + c) * sk.t + d]) : 0.f;
    }
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      const int d = i - c * D;
      vs[c * D + d] = (k0 + c < kv_len) ? to_f32(vb[(k0 + c) * sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * BQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax; a row's 64 columns live in the 16 lanes of one
    // half-warp, so xor-shuffles below 16 reduce exactly one row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool keep = col < kv_len && (!causal || col <= q0 + ty * 4 + i);
        s[i][j] = keep ? s[i][j] * scale : -FLT_MAX;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * PS_STRIDE + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(vs + c * D + tx * 4);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * PS_STRIDE + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    T* orow = o + b * so.b + r * so.t + h * so.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[j] = from_f32<T>(acc[i][j] / l_i[i]);
    if (tx == 0) lse[static_cast<long long>(bh) * Tq + r] = m_i[i] + logf(l_i[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int kv_len, float scale, int causal, Strides sq,
           Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D * BQ + D * BK + BK * D + BQ * PS_STRIDE);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Tq, kv_len, scale, causal, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements. kv_len <= Tk keys are attended; causal needs Tq == Tk.
WCB_EXPORT int wcb_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Tq, int kv_len,
                             float scale, int causal, long long sqb, long long sqt,
                             long long sqh,
                             long long skb, long long skt, long long skh,
                             long long svb, long long svt, long long svh,
                             long long sob, long long sot, long long soh,
                             cudaStream_t stream) {
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh}, so{sob, sot, soh};
  if (dtype == WCB_F32)
    return launch<float>(q, k, v, o, lse, B, H, Tq, kv_len, scale, causal, sq, sk, sv, so,
                         stream);
  if (dtype == WCB_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, kv_len, scale, causal, sq, sk,
                                 sv, so, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
