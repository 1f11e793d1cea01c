// Log-mel frontend kernel: framing, Hann window, 400-point real FFT, power
// and the sparse mel projection, in one pass over the audio.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/mel_kernel.py:
// _mel_kernel (its pallas_call in log_mel_spectrogram_fused), which takes
// (B*T, 400) frames gathered outside it and multiplies them by a dense
// Hann-folded DFT basis and a dense filterbank on the MXU.
//
// What bounds it on an H100: bytes. At Whisper's window (batch 8 x 480000
// samples, 80 mels) the function reads 15.4 MB of audio and writes 7.7 MB
// of energies: 0.0069 ms at 3.35 TB/s. Its arithmetic, done as an FFT, is
// ~4,300 operations a frame plus ~800 for the filterbank's ~400 nonzeros,
// about 0.12 GFLOP in all, under 2 us at the card's f32 rate. A dense DFT
// needs 160,800 multiply-adds a frame, ~37x the FFT's operations, and puts
// the f32 rate, not memory, in charge.
//
// Why not the tensor cores: the frontend's dynamic range (quiet mel bins
// 8 decades under the loudest) needs true f32; TF32 keeps ~3 digits, and a
// 3xTF32 split would triple a product that the FFT already makes ~37x
// smaller. So the kernel runs on the CUDA cores, in f32, and keeps every
// intermediate in shared memory:
//
//  * frames: a block owns FRAMES consecutive frames of one clip and loads
//    the sample span they cover, (FRAMES-1)*160 + 400 samples, once, with
//    16-byte loads and the reflect padding folded into the index (the
//    frames overlap 2.5x; each sample is read from device memory once);
//  * real FFT: the 400 windowed samples of a frame are packed as 200
//    complex values z[n] = x[2n] + i x[2n+1] (the window applied as they
//    are read from the span), transformed by a mixed-radix 200 = 8 x 5 x 5
//    complex FFT (one radix-8 pass, then two radix-5 passes, each in
//    registers between shared-memory exchanges), and split into the 201
//    bins of the real input with the W_400^k post-twiddle;
//  * twiddles: every one is a power of W_400 = exp(-2 pi i / 400), read
//    from a 400-entry table computed on the host in float64 and rounded
//    once to f32 (no __sinf/__cosf);
//  * power and mel: the 201 powers stay in shared memory; each mel filter
//    walks only its own nonzero bins (first bin, count and f32 weights,
//    the values the dense filterbank holds), and the (frames, n_mels) tile
//    is written as one contiguous run.
//
// The plain torch version (ops/mel_kernel.py: mel_energies_plain) is the
// dense DFT product: a different algorithm, held to this kernel by a
// tolerance (1e-4 on log-mel), not by matching sum orders.
// The log/clamp tail stays in torch, as it stays in XLA in the JAX package.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_BINS = N_FFT / 2 + 1;  // 201
constexpr int N_CPX = N_FFT / 2;       // 200-point complex FFT
constexpr int PW_STRIDE = N_BINS;      // powers of one frame
constexpr int THREADS = 256;
// frames a block owns: the fastest of 8, 16, 32 and 64 on an H100 (PERF.md)
constexpr int FRAMES = 8;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return {fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x)};
}
__device__ __forceinline__ float2 mul_minus_i(float2 a) { return {a.y, -a.x}; }  // -i a

// In-place 8-point DFT, natural order in and out; w8 = W_8, w83 = W_8^3.
__device__ __forceinline__ void dft8(float2 (&a)[8], float2 w8, float2 w83) {
  float2 e[4], o[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // 4-point DFTs of the even (h 0) and odd (h 1) samples
    const float2 t0 = cadd(a[h], a[h + 4]), t1 = csub(a[h], a[h + 4]);
    const float2 t2 = cadd(a[h + 2], a[h + 6]), t3 = csub(a[h + 2], a[h + 6]);
    float2* x = h ? o : e;
    x[0] = cadd(t0, t2);
    x[2] = csub(t0, t2);
    x[1] = cadd(t1, mul_minus_i(t3));
    x[3] = csub(t1, mul_minus_i(t3));
  }
  o[1] = cmul(o[1], w8);
  o[2] = mul_minus_i(o[2]);
  o[3] = cmul(o[3], w83);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = cadd(e[k], o[k]);
    a[k + 4] = csub(e[k], o[k]);
  }
}

// In-place 5-point DFT, natural order in and out; w1 = W_5, w2 = W_5^2.
__device__ __forceinline__ void dft5(float2 (&x)[5], float2 w1, float2 w2) {
  const float2 s1 = cadd(x[1], x[4]), d1 = csub(x[1], x[4]);
  const float2 s2 = cadd(x[2], x[3]), d2 = csub(x[2], x[3]);
  // W_5^k = c_k - i s_k with c_k = w_k.x, s_k = -w_k.y
  const float c1 = w1.x, c2 = w2.x, sn1 = -w1.y, sn2 = -w2.y;
  const float2 a1 = {x[0].x + c1 * s1.x + c2 * s2.x, x[0].y + c1 * s1.y + c2 * s2.y};
  const float2 a2 = {x[0].x + c2 * s1.x + c1 * s2.x, x[0].y + c2 * s1.y + c1 * s2.y};
  const float2 b1 = {sn1 * d1.x + sn2 * d2.x, sn1 * d1.y + sn2 * d2.y};
  const float2 b2 = {sn2 * d1.x - sn1 * d2.x, sn2 * d1.y - sn1 * d2.y};
  x[0] = cadd(x[0], cadd(s1, s2));
  x[1] = cadd(a1, mul_minus_i(b1));
  x[4] = csub(a1, mul_minus_i(b1));
  x[2] = cadd(a2, mul_minus_i(b2));
  x[3] = csub(a2, mul_minus_i(b2));
}

// Where bin k of the 200-point FFT sits in a frame's buffer after the three
// in-place passes: k = k1 + 8 (c + 5 d) lives at slot 25 k1 + 5 c + d.
__device__ __forceinline__ int fft_slot(int k) {
  const int m = k >> 3;
  return (k & 7) * 25 + 5 * (m % 5) + m / 5;
}

constexpr int SPAN = (FRAMES - 1) * HOP + N_FFT;  // samples a block reads
// the span is dead once the FFT has read it; the powers reuse its room
constexpr int REGION = SPAN > FRAMES * PW_STRIDE ? SPAN : FRAMES * PW_STRIDE;
constexpr size_t SMEM_FIXED = sizeof(float2) * (N_FFT + 200 + 26)  // twiddle tables
                              + sizeof(float) * N_FFT            // window
                              + sizeof(float2) * FRAMES * N_CPX  // FFT buffers
                              + sizeof(float) * REGION;          // span, then powers

// + the filterbank: (first, count, offset) per filter and its nonzeros
size_t smem_bytes(int n_mels, int nnz) {
  return SMEM_FIXED + ((sizeof(int) * 3 * n_mels + sizeof(float) * nnz + 15) / 16) * 16;
}

__global__ void __launch_bounds__(THREADS)
    mel_fft_kernel(const float* __restrict__ audio, int n_samples, int n_frames, int vec_loads,
                   const float2* __restrict__ twiddles,  // (400,) W_400^k
                   const float* __restrict__ window,     // (400,) periodic Hann
                   const int* __restrict__ ranges,       // (n_mels, 3): first bin, count, offset
                   const float* __restrict__ weights,    // (nnz,) nonzeros of the filterbank
                   int n_mels, int nnz, float* __restrict__ out) {  // (B, n_frames, n_mels)
  extern __shared__ float4 smem4[];
  float2* tw = reinterpret_cast<float2*>(smem4);                 // [400] W_400^k
  float2* tw1 = tw + N_FFT;                                      // [8][25] W_200^(n2 k1)
  float2* tw2 = tw1 + 200;                                       // [5][5] W_25^(b c), 1 pad
  float* win = reinterpret_cast<float*>(tw2 + 26);
  float2* buf = reinterpret_cast<float2*>(win + N_FFT);          // [FRAMES][200]
  float* span = reinterpret_cast<float*>(buf + FRAMES * N_CPX);  // 16-byte aligned
  float* pw = span;                                              // [FRAMES][201], later
  int* fb_ranges = reinterpret_cast<int*>(span + REGION);
  float* fb_weights = reinterpret_cast<float*>(fb_ranges + 3 * n_mels);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const int tid = threadIdx.x;
  const float* x = audio + static_cast<size_t>(b) * n_samples;

  // the twiddles each pass reads, laid out in the order its threads read them
  for (int i = tid; i < N_FFT; i += THREADS) {
    tw[i] = twiddles[i];
    win[i] = window[i];
    if (i < 200) tw1[i] = twiddles[2 * (i % 25) * (i / 25)];
    if (i < 25) tw2[i] = twiddles[16 * (i % 5) * (i / 5)];
  }
  for (int i = tid; i < 3 * n_mels; i += THREADS) fb_ranges[i] = ranges[i];
  for (int i = tid; i < nnz; i += THREADS) fb_weights[i] = weights[i];
  // span[p] = padded[f0 * HOP + p], padded = the clip reflect-padded by 200
  // on each side; j0 is a multiple of 4, so a chunk that lies inside the
  // clip is one aligned 16-byte load when the rows are 16-byte aligned
  const int j0 = f0 * HOP - N_FFT / 2;
  for (int q = tid; q < SPAN / 4; q += THREADS) {
    const int j = j0 + 4 * q;
    float4 v;
    if (vec_loads && j >= 0 && j + 3 < n_samples) {
      v = __ldg(reinterpret_cast<const float4*>(x + j));
    } else {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int jj = j + u;
        if (jj < 0) jj = -jj;
        if (jj >= n_samples) jj = 2 * (n_samples - 1) - jj;
        // frames past the clip's end in the last block read nothing real
        e[u] = (jj >= 0 && jj < n_samples) ? __ldg(x + jj) : 0.f;
      }
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    reinterpret_cast<float4*>(span)[q] = v;
  }
  __syncthreads();

  // pass 1: radix 8 over n1 of n = 25 n1 + n2, then the twiddle W_200^(n2 k1);
  // z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] is read straight from the span
  {
    const float2 w8 = tw[50], w83 = tw[150];
    for (int t = tid; t < FRAMES * 25; t += THREADS) {
      const int f = t / 25, n2 = t - f * 25;
      const float2* xs = reinterpret_cast<const float2*>(span + f * HOP);
      const float2* ws = reinterpret_cast<const float2*>(win);
      float2 a[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const float2 s = xs[25 * n1 + n2], w = ws[25 * n1 + n2];
        a[n1] = make_float2(s.x * w.x, s.y * w.y);
      }
      dft8(a, w8, w83);
      float2* y = buf + f * N_CPX + n2;
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) y[25 * k1] = k1 ? cmul(a[k1], tw1[25 * k1 + n2]) : a[0];
    }
  }
  __syncthreads();

  const float2 w5 = tw[80], w52 = tw[160];
  // pass 2: for each k1, radix 5 over a of n2 = 5 a + b, then W_25^(b c)
  for (int t = tid; t < FRAMES * 40; t += THREADS) {
    const int f = t / 40, r = t - f * 40;
    const int k1 = r / 5, bb = r - k1 * 5;
    float2* y = buf + f * N_CPX + 25 * k1 + bb;
    float2 u[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) u[a] = y[5 * a];
    dft5(u, w5, w52);
#pragma unroll
    for (int c = 0; c < 5; ++c) y[5 * c] = c ? cmul(u[c], tw2[5 * c + bb]) : u[0];
  }
  __syncthreads();

  // pass 3: for each (k1, c), radix 5 over b: bin k1 + 8 (c + 5 d) at slot 25 k1 + 5 c + d
  for (int t = tid; t < FRAMES * 40; t += THREADS) {
    const int f = t / 40, r = t - f * 40;
    float2* y = buf + f * N_CPX + 5 * r;  // r = 5 k1 + c
    float2 u[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) u[v] = y[v];
    dft5(u, w5, w52);
#pragma unroll
    for (int d = 0; d < 5; ++d) y[d] = u[d];
  }
  __syncthreads();

  // real-input split: with Z the 200-point FFT of z, 2E = Z[k] + conj Z[200-k]
  // and 2O = (Z[k] - conj Z[200-k]) / i are the even and odd samples' DFTs,
  // X[k] = E + W_400^k O and X[200-k] = conj(E - W_400^k O)
  for (int t = tid; t < FRAMES * 101; t += THREADS) {
    const int f = t / 101, k = t - f * 101;
    const float2* z = buf + f * N_CPX;
    const float2 zk = z[fft_slot(k)];
    const float2 zm = z[fft_slot(k ? N_CPX - k : 0)];
    const float2 e = {zk.x + zm.x, zk.y - zm.y};
    const float2 o = {zk.y + zm.y, zm.x - zk.x};
    const float2 wo = cmul(o, tw[k]);
    const float2 lo = cadd(e, wo), hi = csub(e, wo);
    float* p = pw + f * PW_STRIDE;
    p[k] = 0.25f * fmaf(lo.x, lo.x, lo.y * lo.y);
    p[N_CPX - k] = 0.25f * fmaf(hi.x, hi.x, hi.y * hi.y);
  }
  __syncthreads();

  // sparse mel projection: a thread owns one filter for 4 frames, so each
  // weight it reads serves 4 products; the block's outputs are one
  // contiguous run, written a frame at a time by consecutive filters
  const int valid = min(FRAMES, n_frames - f0);
  float* o_blk = out + (static_cast<size_t>(b) * n_frames + f0) * n_mels;
  for (int i = tid; i < (FRAMES / 4) * n_mels; i += THREADS) {
    const int fq = i / n_mels, m = i - fq * n_mels;
    const int first = fb_ranges[3 * m], count = fb_ranges[3 * m + 1];
    const float* wt = fb_weights + fb_ranges[3 * m + 2];
    const float* p = pw + 4 * fq * PW_STRIDE + first;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < count; ++j) {
      const float w = wt[j];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(p[u * PW_STRIDE + j], w, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * fq + u < valid) o_blk[(4 * fq + u) * n_mels + m] = acc[u];
  }
}

}  // namespace

// audio (batch, n_samples) f32; twiddles (400, 2) f32; window (400,) f32;
// ranges (n_mels, 3) int32 and weights (nnz,) f32: the sparse filterbank;
// out (batch, n_samples / 160, n_mels) f32 mel energies.
WCB_EXPORT int wcb_mel(const float* audio, int batch, int n_samples, const float* twiddles,
                       const float* window, const int* ranges, const float* weights,
                       int n_mels, int nnz, float* out, cudaStream_t stream) {
  const int n_frames = n_samples / HOP;
  const size_t smem = smem_bytes(n_mels, nnz);
  cudaError_t err = cudaFuncSetAttribute(
      mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(audio) % 16 == 0) && (n_samples % 4 == 0);
  const dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  mel_fft_kernel<<<grid, THREADS, smem, stream>>>(
      audio, n_samples, n_frames, vec, reinterpret_cast<const float2*>(twiddles), window,
      ranges, weights, n_mels, nnz, out);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4]: registers, shared memory bytes, local memory bytes, resident
// blocks per SM and threads per block of the kernel, for n_mels filters with
// nnz nonzeros.
WCB_EXPORT int wcb_mel_info(int n_mels, int nnz, int* out) {
  return kernel_info(mel_fft_kernel, THREADS, smem_bytes(n_mels, nnz), out);
}
