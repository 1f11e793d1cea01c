// Fused LayerNorm + matmul + bias + activation: out = act(LN(x) @ W + b).
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/fused_block.py:
// _kernel (its pallas_call in _fwd_call). That kernel keeps a whole
// (256, d) block of x in VMEM across an inner sweep over column tiles of W;
// nothing of the normalized tensor reaches device memory. Both kernels here
// keep that property.
//
// Numerics follow the Pallas kernel: x is read in its own dtype and widened,
// the row's mean and variance in f32 (two passes, as jnp.var), y = (x - mean)
// * rsqrt(var + 1e-5) * g + beta in f32, rounded to W's dtype before the
// product; the product accumulates in f32; + b in f32, then the activation
// (erf gelu, tanh gelu or none) in f32, then one cast to the output dtype.
// Rows beyond N and columns beyond E are masked, so N needs no padding to a
// tile multiple.
//
// What bounds it on an H100: 2*N*d*E operations against (N*d + d*E + N*E)
// elements, so operations at the model's widths.
//
// bf16 (ln_matmul_bf16) normalizes once and keeps it, as the Pallas kernel
// does: a block owns 128 rows (two warpgroups of 64; one of 64 above d =
// 512, where the tile would not leave room for the ring), reads them once (a
// warp a row, 16 bytes a lane, the row held in registers for all three
// passes, g and beta held in registers for all its rows), and writes the
// normalized bf16 (rows, d) tile into shared memory as d/64 slabs in the
// 128-byte-swizzled layout wgmma reads (128 KB at 128 x 512, 160 KB at 64 x
// 1,280). It then sweeps a contiguous group of 128-column tiles of W against
// that resident tile: (128, 64) slabs of W^T arrive by 16-byte cp.async
// through a 4-stage ring (3 at d = 1,280) shared by the warpgroups, one
// barrier a slab, the copy of slab i + 2 and the products of slab i - 1
// still in flight under the products of slab i; every product is wgmma
// m64n64k16 from shared-memory descriptors with f32 accumulators in
// registers. The epilogue loads b under the tile's last products, applies
// the activation on the accumulators, rounds, stages each warp's 16 rows in
// shared memory and writes 16 bytes a lane. The LayerNorm costs ~10
// instructions an element and the erf gelu about as many instruction slots
// as the products take tensor-core cycles, and with one block an SM neither
// runs under another block's products: what a later design can still win.
// The launcher's caller picks the number of column tiles a block sweeps so
// that the grid fills the card in whole waves; the normalization is redone
// once per group of tiles.
//
// f32 (ln_matmul_f32) is true f32 (no TF32) on the CUDA cores: a GEMM whose
// A-tile loader is the LayerNorm, k-chunks of 32 normalized as they are
// staged, 4x8 outputs per thread.
//
// Layout: x (N, d) with row stride ldx, the last axis contiguous; W passed
// as W^T, (E, d) row-major with row stride ldw (k contiguous: the nn.Linear
// weight layout, so the model's weights are read in place); g, beta (d,) and
// b (E,) f32; out (N, E) contiguous. d, ldx and ldw are multiples of 8 and the
// pointers 16-byte aligned (the wrapper checks), so every 8-wide k-group of
// a row is one aligned 16-byte load; bf16 also needs d a multiple of 64 up
// to 1,280, E a multiple of 8 and 16-byte aligned g, beta and b.
#include "mma_tiles.cuh"

namespace {

// the f32 kernel's tile
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

// The same activations for the bf16 kernel's epilogue, which applies one to
// 64 accumulators a thread: compile-time choice, a few instructions each.
// erf gelu as 0.5 v erfc(-v / sqrt 2) with erfc(x >= 0) from Abramowitz and
// Stegun 7.1.26 (|error| <= 1.5e-7, f32's own rounding level; the erfc form
// on both sides of 0 keeps the tail free of cancellation); tanh as
// 1 - 2 / (e^2u + 1) on the special-function unit (~1e-6).
template <int ACT>
__device__ __forceinline__ float activate_fast(float v) {
  if (ACT == ACT_GELU) {
    const float x = fabsf(v) * 0.70710678118654752f;
    const float t = __fdividef(1.f, fmaf(0.3275911f, x, 1.f));
    float p = fmaf(1.061405429f, t, -1.453152027f);
    p = fmaf(p, t, 1.421413741f);
    p = fmaf(p, t, -0.284496736f);
    p = fmaf(p, t, 0.254829592f);
    const float erfc_x = p * t * __expf(-x * x);
    return 0.5f * v * (v >= 0.f ? 2.f - erfc_x : erfc_x);
  }
  if (ACT == ACT_GELU_TANH) {
    const float u = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    const float th = 1.f - __fdividef(2.f, __expf(2.f * u) + 1.f);
    return v * (0.5f * (1.f + th));
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

template <typename T>
__device__ __forceinline__ void store_out(const Args& a, int row, int col, float v) {
  if (row >= a.N || col >= a.E) return;
  if (a.b != nullptr) v += a.b[col];
  static_cast<T*>(a.out)[static_cast<long long>(row) * a.E + col] =
      from_f32<T>(activate(v, a.act));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_BN = 128;       // output columns per tile: two 64-column halves
constexpr int TC_MAX_D = 1280;

// Warpgroups per block (64 rows each) and stages of the W ring at width d:
// the widest tile that leaves room for the ring in a block's 227 KB.
constexpr int tc_warpgroups(int d) { return d <= 512 ? 2 : 1; }
constexpr int tc_stages(int d) { return d <= 1024 ? 4 : 3; }

// the normalized (64 WG, d) tile, the ring, and 16 staging rows per warp
constexpr size_t smem_bf16(int d) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(64 * tc_warpgroups(d)) * d +
                                  tc_stages(d) * 2 * SWZ_TILE +
                                  4 * tc_warpgroups(d) * 16 * TILE_LD);
}

// NC: 16-byte chunks of a row per lane, at least ceil(d / 256); WG warpgroups, each
// owning 64 of the block's rows; STAGES slabs of W in the ring. Grid (column
// groups, row blocks): block x sweeps column tiles [x * tiles_per_group, ...).
template <int NC, int WG, int STAGES, int ACT>
__global__ void __launch_bounds__(128 * WG) ln_matmul_bf16(Args a, int tiles_per_group) {
  constexpr int BM_TC = 64 * WG, THREADS_TC = 128 * WG;
  constexpr int AHEAD = STAGES - 2;  // slabs whose copies run ahead of the products
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [d / 64] slabs of [BM][64]
  __nv_bfloat16* ws = as + BM_TC * a.d;                           // [STAGES] slabs of [128][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* stage = ws + STAGES * 2 * SWZ_TILE + warp * 16 * TILE_LD;

  const int m0 = blockIdx.y * BM_TC;
  const int n_slabs_k = a.d >> 6;
  const int n_tiles = (a.E + TC_BN - 1) / TC_BN;
  const int tile0 = blockIdx.x * tiles_per_group;
  const int total = (min(n_tiles, tile0 + tiles_per_group) - tile0) * n_slabs_k;  // slabs
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  // This thread's part of a (128, 64) slab of W^T: the 16-byte chunks
  // tid + n * THREADS (row chunk / 8, column chunk % 8), swizzled as
  // TileCopy does. Its source pointer moves 64 columns a slab and 128 rows a
  // tile; which of its rows lie below E changes only with the tile.
  constexpr int COPIES = 128 * 8 / THREADS_TC, ROW_STEP = THREADS_TC / 8;
  const int copy_row = threadIdx.x >> 3, copy_c8 = threadIdx.x & 7;
  const int copy_dst = copy_row * 64 + ((copy_c8 ^ (copy_row & 7)) << 3);
  const __nv_bfloat16* const w = static_cast<const __nv_bfloat16*>(a.w);
  const long long row_step = ROW_STEP * a.ldw;
  const __nv_bfloat16* copy_src = w + (tile0 * TC_BN + copy_row) * a.ldw + copy_c8 * 8;
  int load_k = 0, load_row = tile0 * TC_BN + copy_row;  // of the next slab to ask for
  auto load_next = [&](int s) {
    __nv_bfloat16* dst = ws + (s % STAGES) * 2 * SWZ_TILE + copy_dst;
#pragma unroll
    for (int n = 0; n < COPIES; ++n) {
      const bool in = load_row + n * ROW_STEP < a.E;
      cp_async_16(dst + n * ROW_STEP * 64, in ? copy_src + n * row_step : w, in);
    }
    copy_src += 64;
    if (++load_k == n_slabs_k) {
      load_k = 0;
      load_row += TC_BN;
      copy_src += TC_BN * a.ldw - a.d;
    }
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < total) load_next(s);
    cp_async_commit();
  }

  {  // LayerNorm of the block's rows into the resident tile, a warp a row
    const int n_chunks = a.d >> 3;
    float gr[NC][8], br[NC][8];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int chunk = lane + 32 * c;
      const bool in = chunk < n_chunks;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 g0 = in ? *reinterpret_cast<const float4*>(a.g + chunk * 8) : z;
      const float4 g1 = in ? *reinterpret_cast<const float4*>(a.g + chunk * 8 + 4) : z;
      const float4 b0 = in ? *reinterpret_cast<const float4*>(a.beta + chunk * 8) : z;
      const float4 b1 = in ? *reinterpret_cast<const float4*>(a.beta + chunk * 8 + 4) : z;
      gr[c][0] = g0.x, gr[c][1] = g0.y, gr[c][2] = g0.z, gr[c][3] = g0.w;
      gr[c][4] = g1.x, gr[c][5] = g1.y, gr[c][6] = g1.z, gr[c][7] = g1.w;
      br[c][0] = b0.x, br[c][1] = b0.y, br[c][2] = b0.z, br[c][3] = b0.w;
      br[c][4] = b1.x, br[c][5] = b1.y, br[c][6] = b1.z, br[c][7] = b1.w;
    }
    // rows whose loads are in flight together: 32 to 64 registers of raw x
    constexpr int ROWS = NC <= 2 ? 8 : NC <= 4 ? 4 : 2;
    for (int i0 = 0; i0 < 16; i0 += ROWS) {
      uint4 raw[ROWS][NC];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int row = m0 + warp * 16 + i0 + j, chunk = lane + 32 * c;
          raw[j][c] = (row < a.N && chunk < n_chunks)
                          ? *reinterpret_cast<const uint4*>(x + row * a.ldx + chunk * 8)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      // every step over all ROWS rows at once: their sums, shuffles and
      // square roots are independent chains the scheduler can interleave
      float mean[ROWS], rstd[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t words[4] = {raw[j][c].x, raw[j][c].y, raw[j][c].z, raw[j][c].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(words[e]);
            lo += f.x;
            hi += f.y;
          }
        }
        mean[j] = lo + hi;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) mean[j] += __shfl_xor_sync(0xffffffffu, mean[j], off);
      const float inv_d = 1.f / a.d;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        mean[j] *= inv_d;
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (lane + 32 * c < n_chunks) {
            const uint32_t words[4] = {raw[j][c].x, raw[j][c].y, raw[j][c].z, raw[j][c].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(words[e]);
              lo = fmaf(f.x - mean[j], f.x - mean[j], lo);
              hi = fmaf(f.y - mean[j], f.y - mean[j], hi);
            }
          }
        rstd[j] = lo + hi;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) rstd[j] += __shfl_xor_sync(0xffffffffu, rstd[j], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        rstd[j] = rsqrtf(rstd[j] * inv_d + EPS);
        const int r = warp * 16 + i0 + j;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int chunk = lane + 32 * c;
          if (chunk < n_chunks) {
            const uint32_t words[4] = {raw[j][c].x, raw[j][c].y, raw[j][c].z, raw[j][c].w};
            uint32_t y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(words[e]);
              y[e] = pack_bf16((f.x - mean[j]) * rstd[j] * gr[c][2 * e] + br[c][2 * e],
                               (f.y - mean[j]) * rstd[j] * gr[c][2 * e + 1] + br[c][2 * e + 1]);
            }
            // chunk c8 of row r of slab chunk / 8, at chunk c8 ^ (r & 7)
            *reinterpret_cast<uint4*>(as + (chunk >> 3) * (BM_TC * 64) + r * 64 +
                                      (((chunk & 7) ^ (r & 7)) << 3)) =
                make_uint4(y[0], y[1], y[2], y[3]);
          }
        }
      }
    }
  }
  const int tig = lane & 3;
  const int wg = warp >> 2;
  float acc[2][8][4] = {};  // the warp's 16 x 128 of the output tile: 2 halves of 8 n-tiles
  int s = 0;                // slabs done
  for (int tile = tile0; s < total; ++tile) {
    for (int ks = 0; ks < n_slabs_k; ++ks, ++s) {
      // slab s is in once all but the newest AHEAD - 1 copy groups are; the
      // fence also covers the tile the LayerNorm wrote. Past the barrier every
      // warp has waited for the products of slab s - 2, whose stage slab
      // s + AHEAD takes
      cp_async_wait<AHEAD - 1>();
      fence_async_proxy();
      __syncthreads();
      if (s + AHEAD < total) load_next(s + AHEAD);
      cp_async_commit();
      const __nv_bfloat16* wslab = ws + (s % STAGES) * 2 * SWZ_TILE;
      const uint64_t a_desc = smem_desc(as + ks * (BM_TC * 64) + wg * SWZ_TILE, 16, 1024);
      const uint64_t w_desc0 = smem_desc(wslab, 16, 1024);
      const uint64_t w_desc1 = smem_desc(wslab + SWZ_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wgmma_ss(acc[0], a_desc + kc * DESC_K16_ALONG_ROWS, w_desc0 + kc * DESC_K16_ALONG_ROWS,
                 (ks | kc) != 0);
        wgmma_ss(acc[1], a_desc + kc * DESC_K16_ALONG_ROWS, w_desc1 + kc * DESC_K16_ALONG_ROWS,
                 (ks | kc) != 0);
      }
      wgmma_commit();
      wgmma_wait_pending<1>();  // slab s - 1 is done; slab s runs under the next barrier
    }
    // the tile's bias while its last products finish
    float2 bias[2][8];
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile * TC_BN + nh * 64 + j * 8 + tig * 2;  // even; E % 8 == 0
        bias[nh][j] = (a.b != nullptr && col < a.E)
                          ? __ldg(reinterpret_cast<const float2*>(a.b + col))
                          : make_float2(0.f, 0.f);
      }
    wgmma_wait();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      const int n0 = tile * TC_BN + nh * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[nh][j][0] = activate_fast<ACT>(acc[nh][j][0] + bias[nh][j].x);
        acc[nh][j][1] = activate_fast<ACT>(acc[nh][j][1] + bias[nh][j].y);
        acc[nh][j][2] = activate_fast<ACT>(acc[nh][j][2] + bias[nh][j].x);
        acc[nh][j][3] = activate_fast<ACT>(acc[nh][j][3] + bias[nh][j].y);
      }
      if (n0 < a.E)
        store_tile_16x64(acc[nh], stage, static_cast<__nv_bfloat16*>(a.out) + n0, a.E,
                         m0 + warp * 16, a.N, lane, a.E - n0);
    }
  }
}

template <int NC, int D_CLASS, int ACT>
int launch_bf16_act(const Args& a, int tiles_per_group, cudaStream_t stream) {
  constexpr int WG = tc_warpgroups(D_CLASS), STAGES = tc_stages(D_CLASS);
  const size_t smem = smem_bf16(a.d);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_bf16<NC, WG, STAGES, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (a.E + TC_BN - 1) / TC_BN;
  const dim3 grid((n_tiles + tiles_per_group - 1) / tiles_per_group,
                  (a.N + 64 * WG - 1) / (64 * WG));
  ln_matmul_bf16<NC, WG, STAGES, ACT><<<grid, 128 * WG, smem, stream>>>(a, tiles_per_group);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int D_CLASS>
int launch_bf16(const Args& a, int tiles_per_group, cudaStream_t stream) {
  if (a.act == ACT_GELU) return launch_bf16_act<NC, D_CLASS, ACT_GELU>(a, tiles_per_group, stream);
  if (a.act == ACT_GELU_TANH)
    return launch_bf16_act<NC, D_CLASS, ACT_GELU_TANH>(a, tiles_per_group, stream);
  return launch_bf16_act<NC, D_CLASS, ACT_NONE>(a, tiles_per_group, stream);
}

template <int NC, int D_CLASS>
int info_bf16(int d, int* out) {  // of the erf gelu instance, the largest
  constexpr int WG = tc_warpgroups(D_CLASS), STAGES = tc_stages(D_CLASS);
  return kernel_info(ln_matmul_bf16<NC, WG, STAGES, ACT_GELU>, 128 * WG, smem_bf16(d), out);
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
// null); act 0 none, 1 gelu (erf), 2 gelu (tanh). Needs d % 8 == 0; bf16
// needs d % 64 == 0, d <= 1280, E % 8 == 0 and tiles_per_group >= 1, the
// number of 128-column tiles one block sweeps (f32 ignores it).
WCB_EXPORT int wcb_fused_ln_matmul(int dtype, const void* x, const float* g,
                                   const float* beta, const void* w, const float* b,
                                   void* out, int N, int d, int E, long long ldx,
                                   long long ldw, int act, int tiles_per_group,
                                   cudaStream_t stream) {
  if (N <= 0 || d <= 0 || E <= 0 || d % 8 != 0 || act < ACT_NONE || act > ACT_GELU_TANH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, g, beta, w, b, out, N, d, E, ldx, ldw, act};
  if (dtype == WCB_BF16) {
    if (d % 64 != 0 || d > TC_MAX_D || E % 8 != 0 || tiles_per_group < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    // by width class (the family's 384 and 512; 768 and 1,024; 1,280): every d
    // of a class shares the chunks a lane, warpgroups and stages of its upper end
    if (d <= 512) return launch_bf16<2, 512>(a, tiles_per_group, stream);
    if (d <= 1024) return launch_bf16<4, 1024>(a, tiles_per_group, stream);
    return launch_bf16<5, 1280>(a, tiles_per_group, stream);
  }
  if (dtype != WCB_F32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((E + BN - 1) / BN, (N + BM - 1) / BM);
  ln_matmul_f32<<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4]: registers, shared memory bytes (static + dynamic), local memory
// bytes, resident blocks per SM and threads per block of the dtype's kernel
// at width d.
WCB_EXPORT int wcb_fused_ln_matmul_info(int dtype, int d, int* out) {
  if (dtype == WCB_F32) return kernel_info(ln_matmul_f32, THREADS, 0, out);
  if (dtype != WCB_BF16 || d <= 0 || d % 64 != 0 || d > TC_MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 512) return info_bf16<2, 512>(d, out);
  if (d <= 1024) return info_bf16<4, 1024>(d, out);
  return info_bf16<5, 1280>(d, out);
}
