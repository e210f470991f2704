// Permuted-spectrum FFT kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in fastgaussianprocesses_tpu/ops/pallas_fft.py:
//   fgp_passb (inverse = 0)  <- _passb_kernel      (K1, pass B of pfft)
//   fgp_passb (inverse = 1)  <- _passb_inv_kernel  (K2, pass B of pifft, run backwards)
//   fgp_quad                 <- _quad_kernel       (K3, fused pass A + pass B + w|Z|^2)
//
// Factorization (same tables and bin order as the JAX package):
//   n = A * B,  B = Bh * Bl,   j = a*B + bh*Bl + bl,   k = k1 + A*kh + A*Bh*kl
//   pass A : Y[k1, b]      = sum_a F_A[k1, a] x[a, b]
//   tw 1   : Y[k1, bh, bl] *= T1[k1, bh] * T2[k1, bl]        (= w_n^{k1 b})
//   DFT_Bh : Z[kh, bl]     = sum_bh F_Bh[kh, bh] Y[bh, bl]
//   tw 2   : Z            *= T3[kh, bl]                      (= w_B^{kh bl})
//   DFT_Bl : O[kh, kl]     = sum_bl Z[kh, bl] F_Bl[bl, kl]
// and the spectrum is stored as (Bh, A, Bl): out[kh, k1, kl] = X[k1 + A*kh + A*Bh*kl].
//
// Design.  One thread block owns one (row r, k1) slab of B = Bh*Bl complex values
// (128 KB of dynamic shared memory at B = 2^14).  The two short DFTs run as radix-2
// butterflies inside shared memory: decimation in time down the bh axis (the slab is
// stored bh-bit-reversed on load, so that pass yields natural kh) and decimation in
// frequency along the bl axis (natural in, bit-reversed out; the store un-reverses).
// The inverse kernel runs the same stages in reverse order with the conjugate tables.
// All arithmetic is float32 FFMA; the twiddles come from the float64-built tables.
// The TPU kernels hold K1B (8..128) k1 rows per grid step because VMEM is large; here a
// block holds exactly one slab, so the grid is (A, R) and K1/K2 at R = 1 fill only
// A = 64 of the 132 SMs at n = 2^20.
//
// Layouts differ from the Pallas kernels where that removes a transpose: K1 reads the
// pass-A output k1-major (R, A, B), so its slab is contiguous; K2 writes k1-major
// (R, A, B), so the inverse pass A is a plain matmul.  The spectrum layout (R, Bh, A, Bl)
// is the JAX package's, bin for bin.
//
// K3 computes pass A inside the block: for its k1 it reads the whole mean-centred row
// (n floats, 4 MB at n = 2^20) and forms Y[k1, :] as a direct length-A DFT.  The grid is
// r-major (blockIdx.x = k1), so the A blocks of one row run together and re-read the row
// from L2, not from device memory.  The per-block weighted sum is reduced in a fixed
// order and written to partial[r, k1]: no atomics, deterministic.
//
// Every entry point returns cudaGetLastError() (or the first failing CUDA call); the
// Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int i, int log_len) {
  return log_len == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log_len));
}

// Radix-2 stages of a length-L (L = 2^log_len) DFT along one axis of the slab, for all
// 2^log_lines lines at once.  Element i of line q lives at s[q*line_stride + i*elem_stride].
// tw[k] = w_L^k for k < L/2 (sign of the transform's direction), already in shared memory.
// kDIT: bit-reversed input, natural output.  Otherwise (DIF): natural in, bit-reversed out.
// kLineFast: consecutive threads take consecutive lines (use when line_stride == 1).
template <bool kDIT, bool kLineFast>
__device__ void fft_axis(float2* s, const float2* tw, int log_len, int log_lines,
                         int line_stride, int elem_stride) {
  const int log_half = log_len - 1;
  const int nbf = log_len > 0 ? (1 << (log_half + log_lines)) : 0;
  for (int st = 0; st < log_len; ++st) {
    const int lh = kDIT ? st : (log_half - st);   // butterfly span h = 2^lh
    const int h = 1 << lh;
    const int tw_shift = log_half - lh;           // w_{2h}^p = w_L^{p * L/(2h)}
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      int q, b;
      if (kLineFast) {
        q = t & ((1 << log_lines) - 1);
        b = t >> log_lines;
      } else {
        b = t & ((1 << log_half) - 1);
        q = t >> log_half;
      }
      const int p = b & (h - 1);
      const int i0 = ((b >> lh) << (lh + 1)) + p;
      float2* a0 = s + q * line_stride + i0 * elem_stride;
      float2* a1 = a0 + h * elem_stride;
      const float2 w = tw[p << tw_shift];
      const float2 u = *a0;
      const float2 v = *a1;
      if (kDIT) {
        const float2 vw = cmul(v, w);
        *a0 = make_float2(u.x + vw.x, u.y + vw.y);
        *a1 = make_float2(u.x - vw.x, u.y - vw.y);
      } else {
        *a0 = make_float2(u.x + v.x, u.y + v.y);
        *a1 = cmul(make_float2(u.x - v.x, u.y - v.y), w);
      }
    }
    __syncthreads();
  }
}

struct Tables {
  const float* t1r;  // (A, Bh)
  const float* t1i;
  const float* t2r;  // (A, Bl)
  const float* t2i;
  const float* t3r;  // (Bh, Bl)
  const float* t3i;
  const float2* twh;  // (max(Bh/2, 1),) w_Bh^k
  const float2* twl;  // (max(Bl/2, 1),) w_Bl^k
};

__device__ __forceinline__ void load_twiddles(const Tables& t, float2* sh_twh, float2* sh_twl,
                                              int log_bh, int log_bl) {
  for (int i = threadIdx.x; i < ((1 << log_bh) >> 1); i += blockDim.x) sh_twh[i] = t.twh[i];
  for (int i = threadIdx.x; i < ((1 << log_bl) >> 1); i += blockDim.x) sh_twl[i] = t.twl[i];
}

__device__ __forceinline__ float2 twiddle1(const Tables& t, int k1, int bh, int bl,
                                           int log_bh, int log_bl, float2 y) {
  const int i1 = (k1 << log_bh) + bh;
  const int i2 = (k1 << log_bl) + bl;
  y = cmul(y, make_float2(__ldg(t.t1r + i1), __ldg(t.t1i + i1)));
  return cmul(y, make_float2(__ldg(t.t2r + i2), __ldg(t.t2i + i2)));
}

__device__ __forceinline__ void twiddle3(const Tables& t, float2* slab, int B) {
  for (int i = threadIdx.x; i < B; i += blockDim.x)
    slab[i] = cmul(slab[i], make_float2(__ldg(t.t3r + i), __ldg(t.t3i + i)));
  __syncthreads();
}

// Forward pass B of the slab already in shared memory (bh-bit-reversed, tw 1 applied):
// DFT_Bh (DIT), tw 2, DFT_Bl (DIF).  Leaves O[kh][bitrev(kl)] in the slab.
__device__ __forceinline__ void forward_stages(const Tables& t, float2* slab, const float2* sh_twh,
                                               const float2* sh_twl, int log_bh, int log_bl) {
  const int Bl = 1 << log_bl;
  fft_axis<true, true>(slab, sh_twh, log_bh, log_bl, 1, Bl);
  twiddle3(t, slab, 1 << (log_bh + log_bl));
  fft_axis<false, false>(slab, sh_twl, log_bl, log_bh, Bl, 1);
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
passb_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
             float* __restrict__ out_re, float* __restrict__ out_im, Tables t,
             int A, int log_bh, int log_bl) {
  extern __shared__ float2 smem[];
  const int Bh = 1 << log_bh, Bl = 1 << log_bl, B = Bh * Bl;
  float2* slab = smem;
  float2* sh_twh = slab + B;
  float2* sh_twl = sh_twh + max(Bh >> 1, 1);
  const int k1 = blockIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * A * B;
  load_twiddles(t, sh_twh, sh_twl, log_bh, log_bl);
  if (!kInverse) {
    // in: pass-A output, k1-major (R, A, B): this block's slab is contiguous
    const size_t base = row + static_cast<size_t>(k1) * B;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const int bh = i >> log_bl, bl = i & (Bl - 1);
      const float2 y = make_float2(in_re[base + i], in_im[base + i]);
      slab[(bitrev(bh, log_bh) << log_bl) + bl] = twiddle1(t, k1, bh, bl, log_bh, log_bl, y);
    }
    __syncthreads();
    forward_stages(t, slab, sh_twh, sh_twl, log_bh, log_bl);
    // out: permuted spectrum (R, Bh, A, Bl)
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const int kh = i >> log_bl, kl = i & (Bl - 1);
      const float2 z = slab[(kh << log_bl) + bitrev(kl, log_bl)];
      const size_t o = row + (static_cast<size_t>(kh) * A + k1) * Bl + kl;
      out_re[o] = z.x;
      out_im[o] = z.y;
    }
  } else {
    // in: permuted spectrum (R, Bh, A, Bl), stored kl-bit-reversed for the DIT
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const int kh = i >> log_bl, kl = i & (Bl - 1);
      const size_t o = row + (static_cast<size_t>(kh) * A + k1) * Bl + kl;
      slab[(kh << log_bl) + bitrev(kl, log_bl)] = make_float2(in_re[o], in_im[o]);
    }
    __syncthreads();
    fft_axis<true, false>(slab, sh_twl, log_bl, log_bh, Bl, 1);   // undo DFT_Bl
    twiddle3(t, slab, B);                                          // undo tw 2
    fft_axis<false, true>(slab, sh_twh, log_bh, log_bl, 1, Bl);   // undo DFT_Bh
    // undo tw 1; out: k1-major (R, A, B) for the inverse pass A matmul
    const size_t base = row + static_cast<size_t>(k1) * B;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const int bh = i >> log_bl, bl = i & (Bl - 1);
      const float2 y = twiddle1(t, k1, bh, bl, log_bh, log_bl,
                                slab[(bitrev(bh, log_bh) << log_bl) + bl]);
      out_re[base + i] = y.x;
      out_im[base + i] = y.y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quad_kernel(const float* __restrict__ xm, const float* __restrict__ fa_r,
            const float* __restrict__ fa_i, Tables t, const float* __restrict__ wk,
            float* __restrict__ partial, int A, int log_bh, int log_bl) {
  extern __shared__ float2 smem[];
  const int Bh = 1 << log_bh, Bl = 1 << log_bl, B = Bh * Bl;
  float2* slab = smem;
  float2* sh_twh = slab + B;
  float2* sh_twl = sh_twh + max(Bh >> 1, 1);
  float2* sh_fa = sh_twl + max(Bl >> 1, 1);
  float* sh_red = reinterpret_cast<float*>(sh_fa + A);
  const int k1 = blockIdx.x;
  const int r = blockIdx.y;
  load_twiddles(t, sh_twh, sh_twl, log_bh, log_bl);
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    sh_fa[a] = make_float2(fa_r[k1 * A + a], fa_i[k1 * A + a]);
  __syncthreads();

  // pass A for this k1 (real input): Y[b] = sum_a F_A[k1, a] * x[a, b], 4 columns a thread
  const int B4 = B >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(xm + static_cast<size_t>(r) * A * B);
  for (int q = threadIdx.x; q < B4; q += blockDim.x) {
    float4 yr = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 yi = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int a = 0; a < A; ++a) {
      const float4 v = __ldg(x4 + static_cast<size_t>(a) * B4 + q);
      const float2 f = sh_fa[a];
      yr.x = fmaf(f.x, v.x, yr.x); yi.x = fmaf(f.y, v.x, yi.x);
      yr.y = fmaf(f.x, v.y, yr.y); yi.y = fmaf(f.y, v.y, yi.y);
      yr.z = fmaf(f.x, v.z, yr.z); yi.z = fmaf(f.y, v.z, yi.z);
      yr.w = fmaf(f.x, v.w, yr.w); yi.w = fmaf(f.y, v.w, yi.w);
    }
    const float re[4] = {yr.x, yr.y, yr.z, yr.w};
    const float im[4] = {yi.x, yi.y, yi.z, yi.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 4 * q + c;
      const int bh = b >> log_bl, bl = b & (Bl - 1);
      slab[(bitrev(bh, log_bh) << log_bl) + bl] =
          twiddle1(t, k1, bh, bl, log_bh, log_bl, make_float2(re[c], im[c]));
    }
  }
  __syncthreads();
  forward_stages(t, slab, sh_twh, sh_twl, log_bh, log_bl);

  // sum_{kh, kl} w[kh, k1, kl] * |O[kh, kl]|^2 in a fixed order
  float acc = 0.f;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int kh = i >> log_bl, kl = i & (Bl - 1);
    const float2 z = slab[(kh << log_bl) + bitrev(kl, log_bl)];
    acc = fmaf(__ldg(wk + (static_cast<size_t>(kh) * A + k1) * Bl + kl), z.x * z.x + z.y * z.y, acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh_red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    acc = lane < nwarps ? sh_red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[static_cast<size_t>(r) * A + k1] = acc;
  }
}

size_t slab_bytes(int log_bh, int log_bl) {
  const int Bh = 1 << log_bh, Bl = 1 << log_bl;
  const int twh = Bh > 1 ? Bh >> 1 : 1, twl = Bl > 1 ? Bl >> 1 : 1;
  return static_cast<size_t>(Bh * Bl + twh + twl) * sizeof(float2);
}

// Raise a kernel's dynamic shared memory limit once per device (not on every launch,
// so that launches can be captured in a CUDA graph).  `granted` holds, per device, the
// largest size set so far.
constexpr int kMaxDevices = 64;
size_t g_granted_passb[kMaxDevices], g_granted_passb_inv[kMaxDevices],
    g_granted_quad[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) granted[dev] = bytes;
  return e;
}

}  // namespace

extern "C" {

const char* fgp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fgp_passb(const float* in_re, const float* in_im, float* out_re, float* out_im,
              const float* t1r, const float* t1i, const float* t2r, const float* t2i,
              const float* t3r, const float* t3i, const float* twh, const float* twl,
              int R, int A, int log_bh, int log_bl, int inverse, void* stream) {
  const Tables t{t1r, t1i, t2r, t2i, t3r, t3i, reinterpret_cast<const float2*>(twh),
                 reinterpret_cast<const float2*>(twl)};
  const size_t smem = slab_bytes(log_bh, log_bl);
  const dim3 grid(A, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (inverse) {
    if ((e = allow_smem(passb_kernel<true>, smem, g_granted_passb_inv)) != cudaSuccess) return e;
    passb_kernel<true><<<grid, kThreads, smem, s>>>(in_re, in_im, out_re, out_im, t, A,
                                                    log_bh, log_bl);
  } else {
    if ((e = allow_smem(passb_kernel<false>, smem, g_granted_passb)) != cudaSuccess) return e;
    passb_kernel<false><<<grid, kThreads, smem, s>>>(in_re, in_im, out_re, out_im, t, A,
                                                     log_bh, log_bl);
  }
  return static_cast<int>(cudaGetLastError());
}

int fgp_quad(const float* xm, const float* fa_r, const float* fa_i,
             const float* t1r, const float* t1i, const float* t2r, const float* t2i,
             const float* t3r, const float* t3i, const float* twh, const float* twl,
             const float* wk, float* partial, int R, int A, int log_bh, int log_bl,
             void* stream) {
  const Tables t{t1r, t1i, t2r, t2i, t3r, t3i, reinterpret_cast<const float2*>(twh),
                 reinterpret_cast<const float2*>(twl)};
  const size_t smem = slab_bytes(log_bh, log_bl) + static_cast<size_t>(A) * sizeof(float2) +
                      32 * sizeof(float);
  const dim3 grid(A, R);
  cudaError_t e;
  if ((e = allow_smem(quad_kernel, smem, g_granted_quad)) != cudaSuccess) return e;
  quad_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xm, fa_r, fa_i, t, wk, partial, A, log_bh, log_bl);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
