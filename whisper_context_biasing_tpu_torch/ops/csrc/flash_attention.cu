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
// What bounds it on an H100: the two products, 4*Tq*Tk*64 operations per
// head, against 2*(Tq + Tk)*64 elements of q, k, v and o: operations, by far
// (the short causal decoder shape alone is bound by its bytes). Measured with
// parts of the kernel taken out, the products are the smaller share of its
// time; the softmax arithmetic (an exponential per score on the
// special-function unit) and the per-chunk copy work for the K and V tiles
// are the larger, so the design keeps both short and the tensor cores
// asynchronous.
//
// bf16 (flash_fwd_bf16_kernel) runs both products on the tensor cores with
// wgmma (m64n64k16, f32 accumulators; the blocks are in mma_tiles.cuh). One
// block of two warpgroups takes 128 query rows of one (batch, head), 64 a
// warpgroup, 16 a warp. Q, K and V tiles stay bf16 in shared memory in the
// 128-byte-swizzled layout wgmma reads, filled by 16-byte cp.async copies
// along the head dim (each thread's chunk addresses are fixed before the
// loop, so a tile costs it two copies each of K and V); K and V run through
// a ring of three stages, so a tile's copy has a whole tile of arithmetic
// to land and the loop has one barrier a tile. S = Q K^T reads both operands
// from shared memory into accumulator registers; the masks and the online
// softmax work on those registers, a row's max reduced over the 4 lanes that
// hold it; P is rounded to bf16 in registers, which are the A operand of
// P V (V read across its rows through the transpose flag), so P never
// touches shared memory. 64 KB of shared memory a block. Causal: tiles above
// the diagonal are skipped per block and per warpgroup, and the q-tiles with
// the most keys launch first. TMA copies started by a producer warp, and the
// next tile's S in flight under this tile's softmax, are the rungs after
// this one (the second was tried and lost to its register cost).
//
// f32 (flash_fwd_f32_kernel) is true f32 on the CUDA cores, 4x4 outputs a
// thread from float4 reads of f32 tiles in shared memory: TF32 would keep
// three decimal digits, and the f32 path is what holds the port to its plain
// versions at 2e-5.
//
// Causal (decoder self-attention, Tq == Tk): key j is masked for query row i
// when j > i, as in _masked_scores. Every row has an unmasked key in the
// first tile it visits, so no row ever takes exp(0) of a fully masked tile.
//
// Numerics follow the Pallas kernel: scores are (q.k) * scale in f32, keys
// at or beyond kv_len get the f32 minimum (not -inf), the probabilities are
// cast to the input dtype before P.V, the row sum is taken before that cast,
// and the output is normalised after the product. The bf16 kernel alone
// takes its exponentials as 2^x with scale * log2(e) folded into one
// multiply-add per score (the special-function unit's ex2, about 2 ulp;
// the running max is kept of the raw scores), and turns the logsumexp back
// to natural units at the end; it stays within 1e-4 of the plain version's.
//
// Layout: q (B, Tq, H, 64), k and v (B, Tk, H, 64) with any batch, row and
// head strides (the last axis contiguous), so merged-head (B, T, H*64)
// activations are read in place; bf16 needs 16-byte aligned pointers and
// strides that are multiples of 8 elements (the wrapper checks); o
// (B, Tq, H, 64) and lse (B, H, Tq) f32.
#include "mma_tiles.cuh"

namespace {

constexpr int D = TILE_D;  // head dim
constexpr int BK = 64;     // keys per tile, both kernels

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS_STRIDE = BK + 4;
constexpr size_t SMEM_F32 = sizeof(float) * (D * BQ + D * BK + BK * D + BQ * PS_STRIDE);

__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  // lanes walk rows, so the transposed shared-memory writes do not conflict
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int d = i / BQ;
    const int r = i - d * BQ;
    qs[d * BQ + r] = (q0 + r < Tq) ? qb[(q0 + r) * sq.t + d] : 0.f;
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
      ks[d * BK + c] = (k0 + c < kv_len) ? kb[(k0 + c) * sk.t + d] : 0.f;
    }
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      const int d = i - c * D;
      vs[c * D + d] = (k0 + c < kv_len) ? vb[(k0 + c) * sv.t + d] : 0.f;
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
        s[i][j] = p;
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
    float* orow = o + b * so.b + r * so.t + h * so.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[j] = acc[i][j] / l_i[i];
    if (tx == 0) lse[static_cast<long long>(bh) * Tq + r] = m_i[i] + logf(l_i[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_WG = 2;                 // warpgroups per block, 64 query rows each
constexpr int TC_BQ = 64 * TC_WG;        // query rows per block
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_STAGES = 3;             // K/V tiles in flight
// the Q tiles, then TC_STAGES each of the K and V tiles
constexpr size_t SMEM_BF16 = sizeof(__nv_bfloat16) * (TC_WG + 2 * TC_STAGES) * SWZ_TILE;
// on the way out each warp stages its 16 output rows in the K stages
static_assert(TC_THREADS / 32 * 16 * TILE_LD <= TC_STAGES * SWZ_TILE, "output staging");

__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Tq, int kv_len, float scale,
                          int causal, Strides sq, Strides sk, Strides sv, Strides so) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [TC_WG] tiles
  __nv_bfloat16* ks = qs + TC_WG * SWZ_TILE;                      // [TC_STAGES] tiles
  __nv_bfloat16* vs = ks + TC_STAGES * SWZ_TILE;                  // [TC_STAGES] tiles

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  // the last q-tile first: causal, it visits the most key tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * 16;  // the warp's rows: row_lo + gid and + 8

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + TC_BQ) / BK);  // tiles up to the diagonal

  const TileCopy<TC_THREADS> copy_q(qb, sq.t), copy_k(kb, sk.t), copy_v(vb, sv.t);
  auto load_kv = [&](int kt) {
    copy_k(ks + (kt % TC_STAGES) * SWZ_TILE, kt * BK, kv_len);
    copy_v(vs + (kt % TC_STAGES) * SWZ_TILE, kt * BK, kv_len);
  };
#pragma unroll
  for (int g = 0; g < TC_WG; ++g) copy_q(qs + g * SWZ_TILE, q0 + g * 64, Tq);
  load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  const uint64_t q_desc = smem_desc(qs + wg * SWZ_TILE, 16, 1024);
  // exp(s * scale - m * scale) = 2^(s * scale2 - m * scale2): one multiply-add a score
  const float scale2 = scale * LOG2E;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores, rows gid, gid + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the running row sums
  float acc[8][4];                       // 16 x 64 of the output, 8 n-tiles over the head dim
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // tile kt is in once all but the newest copy group are; past the barrier
    // every warp is done with tile kt - 1, whose stage tile kt + 2 takes
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();
    if (kt + 2 < n_tiles) load_kv(kt + 2);
    cp_async_commit();
    // causal: a warpgroup whose last row lies before the tile's first key has
    // nothing to add (its earlier tiles gave every row a finite max)
    if (causal && k0 > q0 + wg * 64 + 63) continue;
    const uint64_t k_desc = smem_desc(ks + (kt % TC_STAGES) * SWZ_TILE, 16, 1024);
    const uint64_t v_desc = smem_desc(vs + (kt % TC_STAGES) * SWZ_TILE, 8192, 1024);

    float s[8][4];  // 16 x 64 scores, 8 n-tiles over the keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss(s, q_desc + kc * DESC_K16_ALONG_ROWS, k_desc + kc * DESC_K16_ALONG_ROWS, kc > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    if (k0 + BK > kv_len || (causal && k0 + BK - 1 > row_lo)) {  // a tile on an edge
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          const int row = row_lo + gid + (e >> 1) * 8;
          if (col >= kv_len || (causal && col > row)) s[j][e] = -FLT_MAX;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // a row's 64 scores sit in the 4 lanes of one group
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2((m0 - mn0) * scale2);
    const float alpha1 = fast_exp2((m1 - mn1) * scale2);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = -mn0 * scale2, ms1 = -mn1 * scale2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], scale2, ms0));
      s[j][1] = fast_exp2(fmaf(s[j][1], scale2, ms0));
      s[j][2] = fast_exp2(fmaf(s[j][2], scale2, ms1));
      s[j][3] = fast_exp2(fmaf(s[j][3], scale2, ms1));
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;  // the four lanes' shares are added at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
    // P (bf16, in registers) times V: 16 keys at a time
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) c_to_a(pa[t], s[2 * t], s[2 * t + 1]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs_bt(acc, pa[t], v_desc + t * DESC_K16_ACROSS_ROWS);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] /= l0;
    acc[j][1] /= l0;
    acc[j][2] /= l1;
    acc[j][3] /= l1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last tile: the K stages are free
  store_tile_16x64(acc, ks + warp * 16 * TILE_LD, o + b * so.b + h * so.h, so.t, row_lo, Tq,
                   lane);
  if (tig == 0) {
    float* lrow = lse + static_cast<long long>(bh) * Tq;
    if (row_lo + gid < Tq) lrow[row_lo + gid] = (m0 * scale2 + log2f(l0)) * LN2;
    if (row_lo + gid + 8 < Tq) lrow[row_lo + gid + 8] = (m1 * scale2 + log2f(l1)) * LN2;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Tq, int kv_len, float scale, int causal, Strides sq, Strides sk, Strides sv,
               Strides so, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_F32));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_f32_kernel<<<grid, THREADS, SMEM_F32, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, kv_len, scale, causal,
      sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int Tq, int kv_len, float scale, int causal, Strides sq, Strides sk, Strides sv,
                Strides so, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BF16));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + TC_BQ - 1) / TC_BQ, B * H);
  flash_fwd_bf16_kernel<<<grid, TC_THREADS, SMEM_BF16, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, Tq, kv_len,
      scale, causal, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements. kv_len <= Tk keys are attended; causal needs Tq == Tk.
// bf16 needs 16-byte aligned q, k, v, o and strides that are multiples of 8.
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
    return launch_f32(q, k, v, o, lse, B, H, Tq, kv_len, scale, causal, sq, sk, sv, so,
                      stream);
  if (dtype == WCB_BF16)
    return launch_bf16(q, k, v, o, lse, B, H, Tq, kv_len, scale, causal, sq, sk, sv, so,
                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..4]: registers, shared memory bytes (static + dynamic), local memory
// bytes, resident blocks per SM and threads per block of the dtype's kernel.
WCB_EXPORT int wcb_flash_fwd_info(int dtype, int* out) {
  if (dtype == WCB_F32) return kernel_info(flash_fwd_f32_kernel, THREADS, SMEM_F32, out);
  if (dtype == WCB_BF16) return kernel_info(flash_fwd_bf16_kernel, TC_THREADS, SMEM_BF16, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
