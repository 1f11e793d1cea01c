// Tensor-core tile building blocks shared by the bf16 flash-attention
// kernels (flash_attention.cu, flash_attention_bwd.cu) and the bf16 fused
// LayerNorm+matmul (fused_ln_matmul.cu).
//
// A tile is 64 x 64 bf16 values: 64 rows of a (T, 64) head slice, or of 64
// columns of a wider matrix, 128 bytes a row. Tiles arrive in shared memory
// by 16-byte cp.async copies along the head dim (eight lanes cover one
// 128-byte row: coalesced), rows past the end zero-filled, into the
// 128-byte-swizzled layout that wgmma reads without bank conflicts. Products
// run on wgmma m64n64k16 (bf16 in, f32 accumulators): one warpgroup of 4
// warps multiplies a 64-row tile, B always from shared memory, A from shared
// memory or from registers.
//
// Register layouts, lane = gid * 4 + tig, warp w of the warpgroup owning
// rows 16 w .. 16 w + 15 of the 64:
//   accumulator, n-tile j (8 columns): c0, c1 (row gid, columns 8 j + 2 tig
//                    and + 1), c2, c3 (row gid + 8, same columns)
//   A over 16 of k:  a0 (gid, 2 tig..+1), a1 (gid + 8, same), a2 (gid,
//                    2 tig + 8..), a3 (gid + 8, same)
// so the accumulators of two adjacent n-tiles, rounded to bf16, are the A
// operand of the next product over those 16 columns: P and dS never leave
// registers.
#pragma once

#include "common.cuh"

constexpr int TILE_D = 64;   // head dim
constexpr int TILE_LD = 72;  // row stride, in elements, of the padded tile an output is staged in
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, t, h;  // batch, row and head strides in elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (about 2 ulp); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

// A fragment over 16 columns from the f32 C fragments of their two n-tiles
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c_lo, const float* c_hi) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// 16- and 4-byte asynchronous copies global -> shared; !valid fills zeros
// and reads nothing (src must still be an address inside the tensor)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A warp's 16 x 64 accumulator tile (8 n-tiles) out to global rows
// [row0, row0 + 16) below n as bf16: through 16 rows of shared memory that
// are the warp's own (`stage`, TILE_LD elements a row: the 16 bytes of
// padding keep the 4-byte stores off each other's banks), so that each lane
// stores 16 bytes and eight lanes cover one 128-byte row. Only the first
// n_cols columns (a multiple of 8) are written.
__device__ __forceinline__ void store_tile_16x64(const float (*acc)[4], __nv_bfloat16* stage,
                                                 __nv_bfloat16* __restrict__ base, long long st,
                                                 int row0, int n, int lane, int n_cols = 64) {
  const int gid = lane >> 2, tig = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + gid * TILE_LD + j * 8 + tig * 2) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (gid + 8) * TILE_LD + j * 8 + tig * 2) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    if (row0 + r < n && c < n_cols)
      *reinterpret_cast<uint4*>(base + (row0 + r) * st + c) =
          *reinterpret_cast<const uint4*>(stage + r * TILE_LD + c);
  }
}

// ---------------------------------------------------------------------------
// tiles in shared memory, and wgmma over them
// ---------------------------------------------------------------------------

constexpr int SWZ_TILE = 64 * 64;  // elements of a swizzled 64 x 64 tile (8 KB, no padding)

// The tile layout wgmma reads: [64][64] bf16, rows of 128 bytes, the 16-byte
// chunk c8 of row r stored at chunk c8 ^ (r & 7) (the 128-byte swizzle), the
// tile on a 1,024-byte boundary.
//
// TileCopy is one thread's part in copying 64-row tiles of one (T, 64) head
// slice (row stride st elements) into such tiles: the 16-byte chunks
// tid + n * THREADS (row chunk / 8, column chunk % 8). Their source offsets
// and destinations are fixed at construction, so a copy inside a loop costs
// an add and a compare a chunk. The caller commits the cp.async group.
template <int THREADS>
struct TileCopy {
  static constexpr int N = 64 * 8 / THREADS;
  const __nv_bfloat16* base;
  long long st;
  long long src[N];
  int row[N], dst[N];

  __device__ __forceinline__ TileCopy(const __nv_bfloat16* base_, long long st_)
      : base(base_), st(st_) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = threadIdx.x + n * THREADS;
      const int r = i >> 3, c8 = i & 7;
      row[n] = r;
      src[n] = r * st + c8 * 8;
      dst[n] = r * 64 + ((c8 ^ (r & 7)) << 3);
    }
  }

  // rows [r0, r0 + 64) of the slice into `tile`; rows at or past n_rows are zero
  __device__ __forceinline__ void operator()(__nv_bfloat16* tile, int r0, int n_rows) const {
    const __nv_bfloat16* from = base + r0 * st;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool in = r0 + row[n] < n_rows;
      cp_async_16(tile + dst[n], in ? from + src[n] : base, in);
    }
  }
};

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: the address,
// the leading and stride byte offsets (each in 16-byte units, 14 bits) and
// the swizzle mode. A tile read along its rows (k = the head dim: Q, K as
// [n][k]) has 8-row groups 1,024 bytes apart (sbo) and no use for lbo; 16
// more of k is 32 bytes further. A tile read across its rows (k = the row:
// V, K as [k][n], with wgmma's transpose-B flag) has its 8-row
// groups of k 1,024 bytes apart too (sbo), lbo would step to the next 64 of
// n (there is none); 16 more of k is 2,048 bytes further.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}
constexpr int DESC_K16_ALONG_ROWS = 32 >> 4;     // descriptor step for 16 more of k
constexpr int DESC_K16_ACROSS_ROWS = 2048 >> 4;

// Shared-memory writes of this thread (cp.async included) become visible to
// the asynchronous proxy, through which wgmma reads; before the barrier
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Before the first wgmma, and after other code wrote its registers
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for every committed wgmma of this warpgroup; then pin the
// accumulator's reads behind the wait with fence_regs
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A 64 x 64 f32 accumulator: d[j][e] is C fragment e of n-tile j of the
// warp's 16 rows (rows 16 * (warp % 4) + gid and + 8). This tells the
// compiler the registers change here, so no read of them moves above the
// wait that precedes it.
__device__ __forceinline__ void fence_regs(float (*d)[4]) {
  asm volatile(""
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      :: "memory");
}

// d = A B (scale_d == 0) or d += A B: A 64 x 16 and B 16 x 64 both read
// along their rows from shared memory
__device__ __forceinline__ void wgmma_ss(float (*d)[4], uint64_t a_desc, uint64_t b_desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// d += A B: A 64 x 16 from registers (each warp its 16 rows), B 16 x 64 read
// across its rows from shared memory (the transpose-B flag)
__device__ __forceinline__ void wgmma_rs_bt(float (*d)[4], const uint32_t* a, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

