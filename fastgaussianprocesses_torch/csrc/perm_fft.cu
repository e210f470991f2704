// Permuted-spectrum FFT kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in fastgaussianprocesses_tpu/ops/pallas_fft.py:
//   fgp_passb (inverse = 0)  <- _passb_kernel      (K1, pass B of pfft)
//   fgp_passb (inverse = 1)  <- _passb_inv_kernel  (K2, pass B of pifft, run backwards)
//   fgp_quad                 <- _quad_kernel       (K3, pass A + pass B + w|Z|^2, two launches:
//                               quad_pass_a_kernel, then quad_slab_kernel)
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
// K3 replaces pallas_fft.py:419 (_quad_kernel) behind pfft_quad (pallas_fft.py:515):
// per mean-centred real row, sum_k w_k |X_k|^2 with the spectrum X never stored whole
// (pass A subtracts the row mean as it loads the row, so the caller writes no centred
// copy; the exact DC term stays outside, as in the JAX package).
// The TPU kernel held the whole row in VMEM; the function's bound on the H100 is the
// single read of the row, 0.0751 ms at n = 2^20, R = 59 (247.5 MB at 3.35 TB/s).  A
// block's 227 KB of shared memory cannot hold a 4 MB row, so K3 runs in two phases with
// the half spectrum as a bounded intermediate, on its own split n = A * B (A = 256,
// B = 2^12 at n = 2^20; _quad_plan in ops/perm_fft.py), bins k = k1 + A*k2:
//   quad_pass_a_kernel : pass A as a length-A FFT (A = A1 * A2, radix-2 butterflies in
//                        registers, one exchange through shared memory) on tiles of
//                        W = 4096 / A columns; the row is read once, and only the slabs
//                        k1 = 0..A/2 are written (complex, (R, A/2+1, B)): for real input
//                        slab A-k1 is the conjugate mirror of slab k1.
//   quad_slab_kernel   : per (row, k1 <= A/2) block, tw 1 (w_n^{k1 b}) on the load, then
//                        the length-B DFT of the slab as Stockham radix-16 passes (one
//                        radix 2/4/8 pass first where log2 B is not a multiple of 4): 16
//                        values a thread in registers, 2 exchanges through shared memory
//                        at B = 2^12 (padded one slot in 16 against bank conflicts), then
//                        sum_k2 w'[k1, k2] |Z[k2]|^2 straight from registers.  w' is the
//                        folded weight w_k + w_{n-k} (1 <= k1 < A/2) or w_k (the
//                        self-mirrored slabs 0 and A/2), gathered by the wrapper in
//                        natural k2 order so the read is coalesced.  A 32 KB slab leaves
//                        room for four blocks an SM, so one block's loads overlap
//                        another's butterflies.
// At n = 2^20, R = 59 the two phases move the row once (247.5 MB) and the half spectrum
// twice (2 x 249.4 MB): 0.75 GB, 0.223 ms at 3.35 TB/s, ~3x the fused bound; the FFT
// FLOPs (~5 n log2 n / 2 a row) are far below the byte time.  The first design ran pass
// A inside a slab block of _plan's 2^14 values as a direct length-64 DFT: every row
// crossed L2 64 times (15.8 GB a launch), it cost 4*A*n FLOP a row, and a 128 KB slab
// allowed one block an SM: 2.21 ms, behind torch.fft's 2.08 ms.  Each block writes one
// partial sum per (row, k1), reduced in a fixed order: no atomics, deterministic.
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

// ---- K3 -------------------------------------------------------------------------------

// w_L^x = exp(-2 pi i x / L) for L <= 16 and 0 <= x < L/2, as compile-time constants
template <int L>
__device__ __forceinline__ float2 wconst(int x) {
  const int j = x * (16 / L);
  const float c0 = 1.f, c1 = 0.923879532511286756f, c2 = 0.707106781186547524f,
              c3 = 0.382683432365089772f;
  const float c = j == 0 ? c0 : j == 1 ? c1 : j == 2 ? c2 : j == 3 ? c3 : j == 4 ? 0.f
                : j == 5 ? -c3 : j == 6 ? -c2 : -c1;
  const float s = j == 0 ? 0.f : j == 1 ? c3 : j == 2 ? c2 : j == 3 ? c1 : j == 4 ? c0
                : j == 5 ? c1 : j == 6 ? c2 : c3;
  return make_float2(c, -s);
}

template <int L>
__host__ __device__ constexpr int brev_c(int i) {
  int r = 0;
  for (int b = 1; b < L; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// One radix-2 decimation-in-frequency stage of span Hh on L registers, then the rest.
template <int L, int Hh>
struct DifStages {
  static __device__ __forceinline__ void run(float2 (&v)[L]) {
#pragma unroll
    for (int s = 0; s < L; s += 2 * Hh) {
#pragma unroll
      for (int j = 0; j < Hh; ++j) {
        const float2 u = v[s + j], w = v[s + j + Hh];
        v[s + j] = make_float2(u.x + w.x, u.y + w.y);
        const float2 d = make_float2(u.x - w.x, u.y - w.y);
        v[s + j + Hh] = j == 0 ? d : cmul(d, wconst<2 * Hh>(j));
      }
    }
    DifStages<L, Hh / 2>::run(v);
  }
};

template <int L>
struct DifStages<L, 0> {
  static __device__ __forceinline__ void run(float2 (&)[L]) {}
};

// In-register length-L DFT (L = 2, 4, 8, 16): natural order in, v[brev_c<L>(k)] = X[k] out.
template <int L>
__device__ __forceinline__ void dft_reg(float2 (&v)[L]) {
  DifStages<L, L / 2>::run(v);
}

constexpr int kPassAThreads = 256;
constexpr int kPassATile = 4096;   // complex values a block holds: A rows x W columns

// Phase 1: pass A of real rows as an FFT, A = A1 * A2, a = A2*a1 + a2, k1 = p + A1*q:
//   U[a2, p]      = sum_a1 x[a, b] w_A1^{a1 p}          (registers)
//   Y[p + A1 q, b] = sum_a2 U[a2, p] w_A^{a2 p} w_A2^{a2 q}  (after one exchange)
// for the W = 4096/A columns b0.. of row blockIdx.y, x = xr - mean[r]; only k1 <= A/2
// is written, to y (R, A/2+1, B) complex.  twa[j] = w_A^j.
template <int A, int A1>
__global__ void __launch_bounds__(kPassAThreads)
quad_pass_a_kernel(const float* __restrict__ xr, const float* __restrict__ mean,
                   const float2* __restrict__ twa, float2* __restrict__ y, int log_b) {
  constexpr int A2 = A / A1, W = kPassATile / A, H = A / 2 + 1;
  __shared__ float2 u[kPassATile];   // u[(a2 * A1 + p) * W + c]
  __shared__ float2 sh_tw[A];
  const int b0 = blockIdx.x * W;
  const size_t r = blockIdx.y;
  for (int i = threadIdx.x; i < A; i += blockDim.x) sh_tw[i] = twa[i];
  __syncthreads();
  const float* x = xr + (r * A << log_b) + b0;
  const float m = mean[r];
  for (int t = threadIdx.x; t < A2 * W; t += blockDim.x) {
    const int c = t % W, a2 = t / W;
    float2 v[A1];
#pragma unroll
    for (int a1 = 0; a1 < A1; ++a1)
      v[a1] = make_float2(__ldg(x + (static_cast<size_t>(A2 * a1 + a2) << log_b) + c) - m, 0.f);
    dft_reg<A1>(v);
#pragma unroll
    for (int p = 0; p < A1; ++p)
      u[(a2 * A1 + p) * W + c] = cmul(v[brev_c<A1>(p)], sh_tw[a2 * p]);
  }
  __syncthreads();
  float2* yr = y + (r * H << log_b) + b0;
  for (int t = threadIdx.x; t < A1 * W; t += blockDim.x) {
    const int c = t % W, p = t / W;
    float2 v[A2];
#pragma unroll
    for (int a2 = 0; a2 < A2; ++a2) v[a2] = u[(a2 * A1 + p) * W + c];
    dft_reg<A2>(v);
#pragma unroll
    for (int q = 0; q < A2; ++q) {
      const int k = p + A1 * q;
      if (k <= A / 2) yr[(static_cast<size_t>(k) << log_b) + c] = v[brev_c<A2>(q)];
    }
  }
}

constexpr int kQuadLogBl = 7, kQuadBl = 1 << kQuadLogBl;   // tw tables split b = bh*128 + bl

// slab index in shared memory, one pad slot every 16 (strided radix-16 stores would
// otherwise hit one bank)
__host__ __device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// Phase 2, first Stockham pass (stride Ns = 1), in two steps so that the slab's loads
// from device memory overlap the staging of the tables: load_first_pass reads radix-R
// groups v[i][q] = Y[j + q*N/R] (j = threadIdx.x + i*blockDim.x, 16/R groups a thread);
// first_pass applies tw 1 (w_n^{k1 b} = t1[b / 128] * t2[b mod 128]), the radix-R DFT,
// and stores into shared memory.
template <int R>
__device__ __forceinline__ void load_first_pass(const float2* __restrict__ yk,
                                                float2 (&v)[16 / R][R], int log_b) {
  const int NR = (1 << log_b) / R;
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (j < NR) v[i][q] = yk[j + q * NR];
  }
}

template <int R>
__device__ __forceinline__ void first_pass(float2 (&v)[16 / R][R], float2* s, const float2* t1,
                                           const float2* t2, int log_b) {
  const int NR = (1 << log_b) / R;
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < NR) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int b = j + q * NR;
        v[i][q] = cmul(cmul(v[i][q], t1[b >> kQuadLogBl]), t2[b & (kQuadBl - 1)]);
      }
      dft_reg<R>(v[i]);
#pragma unroll
      for (int q = 0; q < R; ++q) s[pad16(j * R + q)] = v[i][brev_c<R>(q)];
    }
  }
}

template <int R>
__device__ __forceinline__ void slab_first_pass(const float2* __restrict__ yk, float2* s,
                                                float2* t1, float2* t2, float2* lo, float2* hi,
                                                const float2* __restrict__ qt1,
                                                const float2* __restrict__ qt2,
                                                const float2* __restrict__ qtw, int k1,
                                                int log_b) {
  const int Bh = 1 << (log_b - kQuadLogBl);
  float2 v[16 / R][R];
  load_first_pass<R>(yk, v, log_b);
  for (int i = threadIdx.x; i < kQuadBl; i += blockDim.x) {
    lo[i] = qtw[i];
    t2[i] = qt2[k1 * kQuadBl + i];
  }
  for (int i = threadIdx.x; i < Bh; i += blockDim.x) {
    hi[i] = qtw[kQuadBl + i];
    t1[i] = qt1[k1 * Bh + i];
  }
  __syncthreads();
  first_pass<R>(v, s, t1, t2, log_b);
}

// w_B^e for 0 <= e < B from the two-level table: lo[e mod 128] * hi[e / 128]
__device__ __forceinline__ float2 tw_b(const float2* lo, const float2* hi, int e) {
  return cmul(lo[e & (kQuadBl - 1)], hi[e >> kQuadLogBl]);
}

// Phase 2, a radix-16 Stockham pass at stride Ns = 2^log_ns > 1, in place in shared
// memory, twiddles w_B^{q k B / (16 Ns)}.  The last pass (Ns = B/16)
// leaves X[j + q*Ns] in registers and returns this thread's
// sum_q wf[j + q*Ns] |X[j + q*Ns]|^2 in a fixed order.
template <bool kLast>
__device__ __forceinline__ float slab_pass16(float2* s, const float2* lo, const float2* hi,
                                             const float* __restrict__ wf, int log_ns,
                                             int log_b) {
  const int NR = 1 << (log_b - 4), Ns = 1 << log_ns;
  const int j = threadIdx.x;
  const bool active = j < NR;
  float2 v[16];
  if (active) {
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = s[pad16(j + q * NR)];
    // w^q for w = w_B^{k B / (16 Ns)}, k = j mod Ns: w, w^2, w^4, w^8 from the tables,
    // the rest as products of those (at most three a twiddle)
    const int e1 = (j & (Ns - 1)) << (log_b - log_ns - 4);
    float2 w[16];
    w[1] = tw_b(lo, hi, e1);
    w[2] = tw_b(lo, hi, 2 * e1);
    w[4] = tw_b(lo, hi, 4 * e1);
    w[8] = tw_b(lo, hi, 8 * e1);
    w[3] = cmul(w[1], w[2]);
#pragma unroll
    for (int q = 5; q < 8; ++q) w[q] = cmul(w[4], w[q - 4]);
#pragma unroll
    for (int q = 9; q < 16; ++q) w[q] = cmul(w[8], w[q - 8]);
#pragma unroll
    for (int q = 1; q < 16; ++q) v[q] = cmul(v[q], w[q]);
    dft_reg<16>(v);
  }
  float acc = 0.f;
  if (kLast) {
    if (active) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 z = v[brev_c<16>(q)];
        acc = fmaf(__ldg(wf + j + q * Ns), z.x * z.x + z.y * z.y, acc);
      }
    }
  } else {
    __syncthreads();
    if (active) {
      const int base = ((j >> log_ns) << (log_ns + 4)) + (j & (Ns - 1));
#pragma unroll
      for (int q = 0; q < 16; ++q) s[pad16(base + q * Ns)] = v[brev_c<16>(q)];
    }
    __syncthreads();
  }
  return acc;
}

constexpr int kSlabMaxThreads = 1024;   // B / 16 at B = 2^14

// Phase 2: one block per (k1 = blockIdx.x <= A/2, row blockIdx.y) slab of the half
// spectrum; Z = DFT_B(tw 1 * Y[k1, :]) in natural k2 order, where bin k1 + A*k2 of the
// row's spectrum is Z[k2]; partial[r, k1] = sum_k2 wf[k1, k2] |Z[k2]|^2.
__global__ void __launch_bounds__(kSlabMaxThreads)
quad_slab_kernel(const float2* __restrict__ y, const float2* __restrict__ qt1,
                 const float2* __restrict__ qt2, const float2* __restrict__ qtw,
                 const float* __restrict__ wf, float* __restrict__ partial, int A, int log_b) {
  extern __shared__ float2 smem[];
  const int Bh = 1 << (log_b - kQuadLogBl);
  const int H = A / 2 + 1, k1 = blockIdx.x, r = blockIdx.y;
  float2* s = smem;
  float2* lo = s + pad16(1 << log_b);
  float2* hi = lo + kQuadBl;
  float2* t1 = hi + Bh;
  float2* t2 = t1 + Bh;
  float* red = reinterpret_cast<float*>(t2 + kQuadBl);
  const float2* yk = y + ((static_cast<size_t>(r) * H + k1) << log_b);
  const int r0 = log_b & 3;
  switch (r0) {
    case 0: slab_first_pass<16>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    case 1: slab_first_pass<2>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    case 2: slab_first_pass<4>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    default: slab_first_pass<8>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
  }
  __syncthreads();
  int log_ns = r0 ? r0 : 4;
  for (; log_ns + 4 < log_b; log_ns += 4) slab_pass16<false>(s, lo, hi, nullptr, log_ns, log_b);
  float acc = slab_pass16<true>(s, lo, hi, wf + (static_cast<size_t>(k1) << log_b), log_ns,
                                log_b);

  // block sum in a fixed order
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    acc = lane < nwarps ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[static_cast<size_t>(r) * H + k1] = acc;
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

int fgp_quad(const float* x, const float* mean, const float* twa, const float* qt1,
             const float* qt2, const float* qtw, const float* wf, float* y, float* partial,
             int R, int A, int log_b, void* stream) {
  const int B = 1 << log_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw_a = reinterpret_cast<const float2*>(twa);
  float2* y2 = reinterpret_cast<float2*>(y);
  const dim3 grid_a(B / (kPassATile / A), R);
  switch (A) {
    case 64: quad_pass_a_kernel<64, 8><<<grid_a, kPassAThreads, 0, s>>>(x, mean, tw_a, y2, log_b); break;
    case 128: quad_pass_a_kernel<128, 16><<<grid_a, kPassAThreads, 0, s>>>(x, mean, tw_a, y2, log_b); break;
    case 256: quad_pass_a_kernel<256, 16><<<grid_a, kPassAThreads, 0, s>>>(x, mean, tw_a, y2, log_b); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int Bh = B >> kQuadLogBl;
  const size_t smem = static_cast<size_t>(pad16(B) + 2 * kQuadBl + 2 * Bh) * sizeof(float2) +
                      32 * sizeof(float);
  if ((e = allow_smem(quad_slab_kernel, smem, g_granted_quad)) != cudaSuccess) return e;
  const int threads = B / 16 > 32 ? B / 16 : 32;
  quad_slab_kernel<<<dim3(A / 2 + 1, R), threads, smem, s>>>(
      y2, reinterpret_cast<const float2*>(qt1), reinterpret_cast<const float2*>(qt2),
      reinterpret_cast<const float2*>(qtw), wf, partial, A, log_b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
