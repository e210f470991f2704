// Permuted-spectrum FFT kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in fastgaussianprocesses_tpu/ops/pallas_fft.py,
// each entry point two launches on one stream:
//   fgp_pfft       <- _passb_kernel      (K1: the whole pfft, pass A included):
//                     pass_a_kernel, then pfft_slab_kernel
//   fgp_pifft_real <- _passb_inv_kernel  (K2: the whole pifft_real, inverse pass A included):
//                     pifft_slab_kernel, then pass_a_kernel
//   fgp_pifft      <- _passb_inv_kernel  (K2 with complex output: the whole pifft), the same
//                     two launches, pass A storing the whole complex value
//   fgp_quad       <- _quad_kernel       (K3: per row sum_k w_k |X_k|^2, X never stored whole):
//                     pass_a_kernel, then quad_slab_kernel
//
// Split.  All three run on one split n = A * B (_slab_plan in ops/perm_fft.py: A in
// {64, 128, 256}, B = n / A, so A = 256, B = 2^12 at n = 2^20), j = a*B + b, bins
// k = k1 + A*k2:
//   pass A : Y[k1, b]      = sum_a x[a, b] w_A^{a k1}
//   slab   : X[k1 + A*k2]  = sum_b w_B^{b k2} (w_n^{k1 b} Y[k1, b])        ("tw 1" = w_n^{k1 b})
// K1 writes X in the JAX package's permuted order, _plan's (Bh, A0, Bl) layout (A0 = _plan's
// A, Bl = 128, Bh = n / (A0 Bl)): bin k = k1' + A0*kh + A0*Bh*kl at (kh*A0 + k1')*Bl + kl.
// With c = A / A0 (1, 2 or 4; the splits coincide at n <= 2^18 and 2^22) and
// k1 = k1h*A0 + k1', slab k1 holds, for each g < G = B/128, the run kl = 0..127 of
// kh = k1h + c*g at k2 = g + G*kl: G runs of 128 contiguous bins (1 KB) of the output row.
// K2 uses ifft(X) = conj(fft(conj X)) / n with the two factors in swapped roles:
//   x[a*B + b] = (1/n) Re sum_k1 w_A^{a k1} w_n^{b k1} sum_k2 conj(X[k1 + A k2]) w_B^{b k2}
// so it runs the forward slab DFT on the conjugated slab, tw 1 after it, then the forward
// pass A, keeping the real part (pifft_real) or the conjugate (pifft): K1's tables and
// code, in the other order.
//
// Bound on the H100.  pfft of a real n = 2^20 row reads 4 MB and writes 8 MB; pifft_real
// reads 8 MB and writes 4 MB: 12 MB, 3.6 us at 3.35 TB/s, against ~52 MFLOP of a real FFT
// (0.8 us at 67 TFLOP/s).  Bound by bytes.  pifft (complex output) reads 8 MB and writes
// 8 MB: 16 MB, 5.0 us.  K3 reads the row once: 0.0751 ms at n = 2^20, R = 59 (247.5 MB).
//
// Design.  A block's 227 KB of shared memory cannot hold a 4 MB row, so every op is two
// launches with a (R, A, B) or (R, A/2+1, B) complex scratch between them (8 MB at
// n = 2^20, R = 1: it stays in the 50 MB L2):
//   pass_a_kernel<A, A1, in, out> : pass A as a length-A FFT (A = A1 * A2, radix-2
//        butterflies in registers, one exchange through a 32 KB tile) on tiles of
//        W = 4096 / A columns; the rows are read once.  Input real float32 (K1; K3 also
//        subtracts the row mean as it loads) or interleaved complex64 (K1 on complex rows,
//        K2 on its scratch).  Output all A slabs (K1), the half k1 = 0..A/2 (K3: for real
//        rows slab A - k1 is the conjugate mirror of slab k1), the real part scaled by
//        1/n in natural order (K2, pifft_real), or the conjugate scaled by 1/n in natural
//        order as interleaved complex64 (K2, pifft).
//   slab kernels : one block per (row, k1), B/16 threads (256 at B = 2^12), the length-B
//        DFT of the slab as Stockham radix-16 passes (one radix 2/4/8 pass first where
//        log2 B is not a multiple of 4): 16 values a thread in registers, exchanges through
//        shared memory padded one slot in 16 against bank conflicts; twiddles from
//        float64-built two-level tables, w_B^e = lo[e mod 128] * hi[e / 128].  A 32 KB slab
//        leaves room for several blocks an SM, so one block's loads overlap another's
//        butterflies, and at R = 1 there are A = 256 blocks for the 132 SMs.
//     pfft_slab_kernel  : tw 1 on the load; the last pass goes from registers into shared
//        memory as G rows of 129 slots (one run and a pad slot each, so neither the
//        transposing store nor the reads of a run conflict), then out as 1 KB runs.
//     pifft_slab_kernel : the slab's G runs in through the same 129-slot rows, conjugated;
//        the first pass reads them from there; tw 1 on the last pass's registers, which go
//        to the scratch row as natural b.
//     quad_slab_kernel  : tw 1 on the load, then sum_k2 w'[k1, k2] |Z[k2]|^2 straight from
//        the last pass's registers.  w' is the folded weight w_k + w_{n-k}
//        (1 <= k1 < A/2) or w_k (the self-mirrored slabs 0 and A/2), gathered by the wrapper
//        in natural k2 order so the read is coalesced; one partial sum per (row, k1),
//        reduced in a fixed order: no atomics, deterministic.
// Cost against the bound: K1 and K2 move the row's 12 MB plus the scratch twice (16 MB at
// n = 2^20, R = 1, from L2); the FFT FLOPs are far below the byte time.  At R = 1 each
// launch is a single wave, so their fixed costs (launch, ramp, tail) weigh as much as the
// bytes.  K3 moves the row once and the half spectrum twice: 0.75 GB, 0.223 ms at
// 3.35 TB/s at R = 59, ~3x its fused bound.
//
// Every entry point returns cudaGetLastError() (or the first failing CUDA call); the
// Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

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

// ---- pass A -----------------------------------------------------------------------------

constexpr int kPassAThreads = 256;
constexpr int kPassATile = 4096;   // complex values a block holds: A rows x W columns

// what pass_a_kernel writes: slabs k1 = 0..A/2 (K3), all A slabs (K1), the real part
// times `scale` as float32 in natural order (K2, pifft_real), or the conjugate times
// `scale` as complex64 in natural order (K2, pifft: conj(fft(conj X)) / n = ifft(X))
enum PassAOut { kOutHalf, kOutAll, kOutReal, kOutConj };

// Pass A as an FFT, A = A1 * A2, a = A2*a1 + a2, k1 = p + A1*q:
//   U[a2, p]       = sum_a1 x[a, b] w_A1^{a1 p}                (registers)
//   Y[p + A1 q, b] = sum_a2 U[a2, p] w_A^{a2 p} w_A2^{a2 q}    (after one exchange)
// for the W = 4096/A columns b0.. of row blockIdx.y.  x is real float32 (minus mean[r] when
// `mean` is given) or, with kComplexIn, interleaved complex64.  twa[j] = w_A^j.
template <int A, int A1, bool kComplexIn, int kOut>
__global__ void __launch_bounds__(kPassAThreads)
pass_a_kernel(const float* __restrict__ x, const float* __restrict__ mean,
              const float2* __restrict__ twa, void* __restrict__ y, int log_b, float scale) {
  constexpr int A2 = A / A1, W = kPassATile / A, H = kOut == kOutHalf ? A / 2 + 1 : A;
  __shared__ float2 u[kPassATile];   // u[(a2 * A1 + p) * W + c]
  __shared__ float2 sh_tw[A];
  const int b0 = blockIdx.x * W;
  const size_t r = blockIdx.y;
  for (int i = threadIdx.x; i < A; i += blockDim.x) sh_tw[i] = twa[i];
  __syncthreads();
  const size_t in0 = (r * A << log_b) + b0;
  const float m = mean ? mean[r] : 0.f;
  for (int t = threadIdx.x; t < A2 * W; t += blockDim.x) {
    const int c = t % W, a2 = t / W;
    float2 v[A1];
#pragma unroll
    for (int a1 = 0; a1 < A1; ++a1) {
      const size_t o = in0 + (static_cast<size_t>(A2 * a1 + a2) << log_b) + c;
      if constexpr (kComplexIn)
        v[a1] = __ldg(reinterpret_cast<const float2*>(x) + o);
      else
        v[a1] = make_float2(__ldg(x + o) - m, 0.f);
    }
    dft_reg<A1>(v);
#pragma unroll
    for (int p = 0; p < A1; ++p)
      u[(a2 * A1 + p) * W + c] = cmul(v[brev_c<A1>(p)], sh_tw[a2 * p]);
  }
  __syncthreads();
  const size_t out0 = (r * H << log_b) + b0;
  for (int t = threadIdx.x; t < A1 * W; t += blockDim.x) {
    const int c = t % W, p = t / W;
    float2 v[A2];
#pragma unroll
    for (int a2 = 0; a2 < A2; ++a2) v[a2] = u[(a2 * A1 + p) * W + c];
    dft_reg<A2>(v);
#pragma unroll
    for (int q = 0; q < A2; ++q) {
      const int k = p + A1 * q;
      const size_t o = out0 + (static_cast<size_t>(k) << log_b) + c;
      if constexpr (kOut == kOutReal) {
        reinterpret_cast<float*>(y)[o] = v[brev_c<A2>(q)].x * scale;
      } else if constexpr (kOut == kOutConj) {
        const float2 z = v[brev_c<A2>(q)];
        reinterpret_cast<float2*>(y)[o] = make_float2(z.x * scale, -z.y * scale);
      } else if (kOut == kOutAll || k <= A / 2) {
        reinterpret_cast<float2*>(y)[o] = v[brev_c<A2>(q)];
      }
    }
  }
}

// ---- slab DFT ---------------------------------------------------------------------------

constexpr int kLogBl = 7, kBl = 1 << kLogBl;     // tw tables split b = bh*128 + bl
constexpr int kLogRun = 7, kRun = 1 << kLogRun;  // _plan's Bl: a run of the permuted output
constexpr int kRunSlots = kRun + 1;              // a run's row in shared memory, padded

// slab index in shared memory, one pad slot every 16 (strided radix-16 stores would
// otherwise hit one bank)
__host__ __device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// shared-memory slot of bin k2 = g + G*kl of the slab held as G padded runs
__device__ __forceinline__ int run_slot(int k2, int log_g) {
  return (k2 & ((1 << log_g) - 1)) * kRunSlots + (k2 >> log_g);
}

// offset in the permuted spectrum row of run g of slab k1 (kh = k1h + c*g, k1' = k1 mod A0)
__device__ __forceinline__ int run_offset(int k1, int g, int log_a0, int log_c) {
  const int kh = (k1 >> log_a0) + (g << log_c);
  return ((kh << log_a0) + (k1 & ((1 << log_a0) - 1))) << kLogRun;
}

// the tables of slab k1 into shared memory: w_B^j (j < 128) and w_B^{128 j} (j < B/128);
// tw 1 as t1[bh] = w_n^{k1 128 bh}, t2[bl] = w_n^{k1 bl}
__device__ __forceinline__ void stage_tables(float2* t1, float2* t2, float2* lo, float2* hi,
                                             const float2* __restrict__ qt1,
                                             const float2* __restrict__ qt2,
                                             const float2* __restrict__ qtw, int k1,
                                             int log_b) {
  const int Bh = 1 << (log_b - kLogBl);
  for (int i = threadIdx.x; i < kBl; i += blockDim.x) {
    lo[i] = qtw[i];
    t2[i] = qt2[k1 * kBl + i];
  }
  for (int i = threadIdx.x; i < Bh; i += blockDim.x) {
    hi[i] = qtw[kBl + i];
    t1[i] = qt1[k1 * Bh + i];
  }
}

// First Stockham pass (stride Ns = 1), radix R, on groups v[i][q] = Y[j + q*N/R]
// (j = threadIdx.x + i*blockDim.x, 16/R groups a thread): tw 1 when kTw1, the radix-R DFT,
// the store into shared memory.
template <int R, bool kTw1>
__device__ __forceinline__ void first_pass(float2 (&v)[16 / R][R], float2* s, const float2* t1,
                                           const float2* t2, int log_b) {
  const int NR = (1 << log_b) / R;
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < NR) {
      if (kTw1) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int b = j + q * NR;
          v[i][q] = cmul(cmul(v[i][q], t1[b >> kLogBl]), t2[b & (kBl - 1)]);
        }
      }
      dft_reg<R>(v[i]);
#pragma unroll
      for (int q = 0; q < R; ++q) s[pad16(j * R + q)] = v[i][brev_c<R>(q)];
    }
  }
}

// The first pass of a forward slab (K1, K3) read straight from device memory, in two
// steps so that the loads overlap the staging of the tables.
template <int R>
__device__ __forceinline__ void first_pass_global(const float2* __restrict__ yk, float2* s,
                                                  float2* t1, float2* t2, float2* lo,
                                                  float2* hi, const float2* __restrict__ qt1,
                                                  const float2* __restrict__ qt2,
                                                  const float2* __restrict__ qtw, int k1,
                                                  int log_b) {
  const int NR = (1 << log_b) / R;
  float2 v[16 / R][R];
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (j < NR) v[i][q] = yk[j + q * NR];
  }
  stage_tables(t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b);
  __syncthreads();
  first_pass<R, true>(v, s, t1, t2, log_b);
}

__device__ __forceinline__ void slab_first_pass(const float2* __restrict__ yk, float2* s,
                                                float2* t1, float2* t2, float2* lo, float2* hi,
                                                const float2* __restrict__ qt1,
                                                const float2* __restrict__ qt2,
                                                const float2* __restrict__ qtw, int k1,
                                                int log_b) {
  switch (log_b & 3) {
    case 0: first_pass_global<16>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    case 1: first_pass_global<2>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    case 2: first_pass_global<4>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
    default: first_pass_global<8>(yk, s, t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b); break;
  }
}

// The first pass of K2's slab, read from the G padded runs in shared memory (no tw 1).
template <int R>
__device__ __forceinline__ void first_pass_runs(float2* s, int log_b) {
  const int NR = (1 << log_b) / R, log_g = log_b - kLogRun;
  float2 v[16 / R][R];
#pragma unroll
  for (int i = 0; i < 16 / R; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (j < NR) v[i][q] = s[run_slot(j + q * NR, log_g)];
  }
  __syncthreads();
  first_pass<R, false>(v, s, nullptr, nullptr, log_b);
}

__device__ __forceinline__ void slab_first_pass_runs(float2* s, int log_b) {
  switch (log_b & 3) {
    case 0: first_pass_runs<16>(s, log_b); break;
    case 1: first_pass_runs<2>(s, log_b); break;
    case 2: first_pass_runs<4>(s, log_b); break;
    default: first_pass_runs<8>(s, log_b); break;
  }
}

// w_B^e for 0 <= e < B from the two-level table: lo[e mod 128] * hi[e / 128]
__device__ __forceinline__ float2 tw_b(const float2* lo, const float2* hi, int e) {
  return cmul(lo[e & (kBl - 1)], hi[e >> kLogBl]);
}

// A radix-16 Stockham pass at stride Ns = 2^log_ns > 1 of the slab in shared memory, into
// registers (threads j < B/16): twiddles w_B^{q k B / (16 Ns)}, k = j mod Ns; on return
// v[brev_c<16>(q)] is the pass's output at j + q*Ns (Stockham order base + q*Ns, with
// base = (j / Ns) * 16 Ns + j mod Ns, which is j in the last pass, Ns = B/16).
__device__ __forceinline__ void pass16_regs(const float2* s, const float2* lo, const float2* hi,
                                            int log_ns, int log_b, float2 (&v)[16]) {
  const int NR = 1 << (log_b - 4), Ns = 1 << log_ns;
  const int j = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = s[pad16(j + q * NR)];
  // w^q for w = w_B^{k B / (16 Ns)}: w, w^2, w^4, w^8 from the tables, the rest as
  // products of those (at most three a twiddle)
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

// Every radix-16 pass after the first but the last, in place in shared memory; returns
// log2 of the last pass's stride (B/16).
__device__ __forceinline__ int slab_middle_passes(float2* s, const float2* lo, const float2* hi,
                                                  int log_b) {
  const int j = threadIdx.x;
  const bool active = j < (1 << (log_b - 4));
  int log_ns = (log_b & 3) ? (log_b & 3) : 4;
  for (; log_ns + 4 < log_b; log_ns += 4) {
    const int Ns = 1 << log_ns;
    float2 v[16];
    if (active) pass16_regs(s, lo, hi, log_ns, log_b, v);
    __syncthreads();
    if (active) {
      const int base = ((j >> log_ns) << (log_ns + 4)) + (j & (Ns - 1));
#pragma unroll
      for (int q = 0; q < 16; ++q) s[pad16(base + q * Ns)] = v[brev_c<16>(q)];
    }
    __syncthreads();
  }
  return log_ns;
}

constexpr int kSlabMaxThreads = 1024;   // B / 16 at B = 2^14

// dynamic shared memory of a slab block: the padded slab, lo, hi, t1, t2 (+ `extra` bytes)
size_t slab_smem(int log_b, size_t extra) {
  const int Bh = 1 << (log_b - kLogBl);
  return static_cast<size_t>(pad16(1 << log_b) + 2 * kBl + 2 * Bh) * sizeof(float2) + extra;
}

int slab_threads(int log_b) { return (1 << (log_b - 4)) > 32 ? (1 << (log_b - 4)) : 32; }

// K1: one block per (k1 = blockIdx.x < A, row blockIdx.y); Z = DFT_B(tw 1 * Y[k1, :]) and
// bin k1 + A*k2 = Z[k2] to its place in the permuted spectrum X (R, n), run by run.
__global__ void __launch_bounds__(kSlabMaxThreads)
pfft_slab_kernel(const float2* __restrict__ y, const float2* __restrict__ qt1,
                 const float2* __restrict__ qt2, const float2* __restrict__ qtw,
                 float2* __restrict__ X, int A, int log_a0, int log_c, int log_b) {
  extern __shared__ float2 smem[];
  const int B = 1 << log_b, Bh = B >> kLogBl, log_g = log_b - kLogRun;
  const int k1 = blockIdx.x, r = blockIdx.y, j = threadIdx.x;
  float2* s = smem;
  float2* lo = s + pad16(B);
  float2* hi = lo + kBl;
  float2* t1 = hi + Bh;
  float2* t2 = t1 + Bh;
  slab_first_pass(y + ((static_cast<size_t>(r) * A + k1) << log_b), s, t1, t2, lo, hi, qt1,
                  qt2, qtw, k1, log_b);
  __syncthreads();
  const int log_ns = slab_middle_passes(s, lo, hi, log_b);
  const bool active = j < (B >> 4);
  float2 v[16];
  if (active) pass16_regs(s, lo, hi, log_ns, log_b, v);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int q = 0; q < 16; ++q) s[run_slot(j + (q << log_ns), log_g)] = v[brev_c<16>(q)];
  }
  __syncthreads();
  float2* Xr = X + (static_cast<size_t>(r) * A << log_b);
  for (int i = j; i < B; i += blockDim.x) {
    const int g = i >> kLogRun, kl = i & (kRun - 1);
    Xr[run_offset(k1, g, log_a0, log_c) + kl] = s[g * kRunSlots + kl];
  }
}

// K2: one block per (k1 = blockIdx.x < A, row blockIdx.y); the slab's bins conj X[k1 + A k2]
// from the permuted spectrum X (R, n), V = DFT_B of them, y[r, k1, b] = w_n^{k1 b} V[b].
__global__ void __launch_bounds__(kSlabMaxThreads)
pifft_slab_kernel(const float2* __restrict__ X, const float2* __restrict__ qt1,
                  const float2* __restrict__ qt2, const float2* __restrict__ qtw,
                  float2* __restrict__ y, int A, int log_a0, int log_c, int log_b) {
  extern __shared__ float2 smem[];
  const int B = 1 << log_b, Bh = B >> kLogBl;
  const int k1 = blockIdx.x, r = blockIdx.y, j = threadIdx.x;
  float2* s = smem;
  float2* lo = s + pad16(B);
  float2* hi = lo + kBl;
  float2* t1 = hi + Bh;
  float2* t2 = t1 + Bh;
  // the slab's runs: all 16 loads of a thread in flight together (blockDim >= B/16), the
  // tables staged meanwhile, then conjugated into the padded rows
  const float2* Xr = X + (static_cast<size_t>(r) * A << log_b);
  float2 z[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int i = j + u * blockDim.x;
    if (i < B) z[u] = __ldg(Xr + run_offset(k1, i >> kLogRun, log_a0, log_c) + (i & (kRun - 1)));
  }
  stage_tables(t1, t2, lo, hi, qt1, qt2, qtw, k1, log_b);
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int i = j + u * blockDim.x;
    if (i < B) s[(i >> kLogRun) * kRunSlots + (i & (kRun - 1))] = make_float2(z[u].x, -z[u].y);
  }
  __syncthreads();
  slab_first_pass_runs(s, log_b);
  __syncthreads();
  const int log_ns = slab_middle_passes(s, lo, hi, log_b);
  if (j < (B >> 4)) {
    float2 v[16];
    pass16_regs(s, lo, hi, log_ns, log_b, v);
    float2* yk = y + ((static_cast<size_t>(r) * A + k1) << log_b);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int b = j + (q << log_ns);
      yk[b] = cmul(cmul(v[brev_c<16>(q)], t1[b >> kLogBl]), t2[b & (kBl - 1)]);
    }
  }
}

// K3: one block per (k1 = blockIdx.x <= A/2, row blockIdx.y) slab of the half spectrum;
// Z = DFT_B(tw 1 * Y[k1, :]) in natural k2 order, where bin k1 + A*k2 of the row's spectrum
// is Z[k2]; partial[r, k1] = sum_k2 wf[k1, k2] |Z[k2]|^2.
__global__ void __launch_bounds__(kSlabMaxThreads)
quad_slab_kernel(const float2* __restrict__ y, const float2* __restrict__ qt1,
                 const float2* __restrict__ qt2, const float2* __restrict__ qtw,
                 const float* __restrict__ wf, float* __restrict__ partial, int A, int log_b) {
  extern __shared__ float2 smem[];
  const int Bh = 1 << (log_b - kLogBl);
  const int H = A / 2 + 1, k1 = blockIdx.x, r = blockIdx.y, j = threadIdx.x;
  float2* s = smem;
  float2* lo = s + pad16(1 << log_b);
  float2* hi = lo + kBl;
  float2* t1 = hi + Bh;
  float2* t2 = t1 + Bh;
  float* red = reinterpret_cast<float*>(t2 + kBl);
  slab_first_pass(y + ((static_cast<size_t>(r) * H + k1) << log_b), s, t1, t2, lo, hi, qt1,
                  qt2, qtw, k1, log_b);
  __syncthreads();
  const int log_ns = slab_middle_passes(s, lo, hi, log_b);
  float acc = 0.f;
  if (j < (1 << (log_b - 4))) {
    float2 v[16];
    pass16_regs(s, lo, hi, log_ns, log_b, v);
    const float* wk = wf + (static_cast<size_t>(k1) << log_b);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float2 z = v[brev_c<16>(q)];
      acc = fmaf(__ldg(wk + j + (q << log_ns)), z.x * z.x + z.y * z.y, acc);
    }
  }

  // block sum in a fixed order
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = j >> 5, lane = j & 31;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    acc = lane < nwarps ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[static_cast<size_t>(r) * H + k1] = acc;
  }
}

// Raise a kernel's dynamic shared memory limit once per device (not on every launch,
// so that launches can be captured in a CUDA graph).  `granted` holds, per device, the
// largest size set so far.
constexpr int kMaxDevices = 64;
size_t g_granted_pfft[kMaxDevices], g_granted_pifft[kMaxDevices], g_granted_quad[kMaxDevices];

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

template <bool kComplexIn, int kOut>
cudaError_t launch_pass_a(const float* x, const float* mean, const float* twa, void* y, int R,
                          int A, int log_b, float scale, cudaStream_t s) {
  const dim3 grid((1 << log_b) / (kPassATile / A), R);
  const float2* tw = reinterpret_cast<const float2*>(twa);
  switch (A) {
    case 64:
      pass_a_kernel<64, 8, kComplexIn, kOut><<<grid, kPassAThreads, 0, s>>>(x, mean, tw, y,
                                                                             log_b, scale);
      break;
    case 128:
      pass_a_kernel<128, 16, kComplexIn, kOut><<<grid, kPassAThreads, 0, s>>>(x, mean, tw, y,
                                                                               log_b, scale);
      break;
    case 256:
      pass_a_kernel<256, 16, kComplexIn, kOut><<<grid, kPassAThreads, 0, s>>>(x, mean, tw, y,
                                                                               log_b, scale);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int ilog2(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

// the splits the kernels take: A in {64, 128, 256} a multiple of A0, 2^7 <= B <= 2^14
bool valid_split(int A, int A0, int log_b) {
  return (A == 64 || A == 128 || A == 256) && A0 > 0 && A % A0 == 0 && A / A0 <= 4 &&
         log_b >= kLogRun && log_b <= 14;
}

// K2's two launches: the slab DFTs of the conjugated spectrum into the scratch y, then
// pass A storing kOut (kOutReal: float32 out; kOutConj: complex64 out), 1/n included
template <int kOut>
cudaError_t run_pifft(const float* X, const float* twa, const float* qt1, const float* qt2,
                      const float* qtw, float* y, void* out, int R, int A, int log_a0,
                      int log_b, cudaStream_t s) {
  if (!valid_split(A, 1 << log_a0, log_b)) return cudaErrorInvalidValue;
  const size_t smem = slab_smem(log_b, 0);
  cudaError_t e = allow_smem(pifft_slab_kernel, smem, g_granted_pifft);
  if (e != cudaSuccess) return e;
  pifft_slab_kernel<<<dim3(A, R), slab_threads(log_b), smem, s>>>(
      reinterpret_cast<const float2*>(X), reinterpret_cast<const float2*>(qt1),
      reinterpret_cast<const float2*>(qt2), reinterpret_cast<const float2*>(qtw),
      reinterpret_cast<float2*>(y), A, log_a0, ilog2(A) - log_a0, log_b);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const float inv_n = 1.f / static_cast<float>(static_cast<size_t>(A) << log_b);   // exact
  return launch_pass_a<true, kOut>(y, nullptr, twa, out, R, A, log_b, inv_n, s);
}

}  // namespace

extern "C" {

const char* fgp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: x (R, n) float32, or interleaved complex64 when complex_in; y (R, A, B) complex scratch;
// X (R, n) complex64, the permuted spectrum of _plan(n) (A0 = 2^log_a0).
int fgp_pfft(const float* x, int complex_in, const float* twa, const float* qt1,
             const float* qt2, const float* qtw, float* y, float* X, int R, int A, int log_a0,
             int log_b, void* stream) {
  if (!valid_split(A, 1 << log_a0, log_b)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = complex_in
      ? launch_pass_a<true, kOutAll>(x, nullptr, twa, y, R, A, log_b, 1.f, s)
      : launch_pass_a<false, kOutAll>(x, nullptr, twa, y, R, A, log_b, 1.f, s);
  if (e != cudaSuccess) return e;
  const size_t smem = slab_smem(log_b, 0);
  if ((e = allow_smem(pfft_slab_kernel, smem, g_granted_pfft)) != cudaSuccess) return e;
  pfft_slab_kernel<<<dim3(A, R), slab_threads(log_b), smem, s>>>(
      reinterpret_cast<const float2*>(y), reinterpret_cast<const float2*>(qt1),
      reinterpret_cast<const float2*>(qt2), reinterpret_cast<const float2*>(qtw),
      reinterpret_cast<float2*>(X), A, log_a0, ilog2(A) - log_a0, log_b);
  return static_cast<int>(cudaGetLastError());
}

// K2: X (R, n) interleaved complex64 in _plan(n)'s permuted order; y (R, A, B) complex
// scratch; out (R, n) float32, the real part of the inverse, 1/n included.
int fgp_pifft_real(const float* X, const float* twa, const float* qt1, const float* qt2,
                   const float* qtw, float* y, float* out, int R, int A, int log_a0, int log_b,
                   void* stream) {
  return static_cast<int>(run_pifft<kOutReal>(X, twa, qt1, qt2, qtw, y, out, R, A, log_a0,
                                              log_b, static_cast<cudaStream_t>(stream)));
}

// K2 with complex output: as fgp_pifft_real, but out (R, n) interleaved complex64, the
// whole inverse, 1/n included.
int fgp_pifft(const float* X, const float* twa, const float* qt1, const float* qt2,
              const float* qtw, float* y, float* out, int R, int A, int log_a0, int log_b,
              void* stream) {
  return static_cast<int>(run_pifft<kOutConj>(X, twa, qt1, qt2, qtw, y, out, R, A, log_a0,
                                              log_b, static_cast<cudaStream_t>(stream)));
}

// K3: x (R, n) float32 rows, mean (R,); y (R, A/2+1, B) complex scratch; wf (A/2+1, B)
// folded weights; partial (R, A/2+1).
int fgp_quad(const float* x, const float* mean, const float* twa, const float* qt1,
             const float* qt2, const float* qtw, const float* wf, float* y, float* partial,
             int R, int A, int log_b, void* stream) {
  if (!valid_split(A, A, log_b)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_pass_a<false, kOutHalf>(x, mean, twa, y, R, A, log_b, 1.f, s);
  if (e != cudaSuccess) return e;
  const size_t smem = slab_smem(log_b, 32 * sizeof(float));
  if ((e = allow_smem(quad_slab_kernel, smem, g_granted_quad)) != cudaSuccess) return e;
  quad_slab_kernel<<<dim3(A / 2 + 1, R), slab_threads(log_b), smem, s>>>(
      reinterpret_cast<const float2*>(y), reinterpret_cast<const float2*>(qt1),
      reinterpret_cast<const float2*>(qt2), reinterpret_cast<const float2*>(qtw), wf, partial,
      A, log_b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
