// Shift-invariant (lattice) cross-kernel for Hopper (sm_90a), plain C interface: kernel K5.
//
// fgp_si_cross computes, for query rows x (R, d) against columns z (M, d), a batch of B
// hyperparameter rows and P derivative pairs p = (i0, i1),
//
//   out[b, r, c] = s_b sum_p w_p prod_j (ind_pj + ls_bj coeff_pj B_m((x[r,j] - z[c,j]) mod 1))
//
// with m = m_pj = 2 alpha_j - beta0[i0, j] - beta1[i1, j], B_m the Bernoulli polynomial,
// ind_pj = 1 where beta0 + beta1 = 0, w_p = c0[i0] c1[i1] and s_b the scale, times the task
// factor f_b where one is given: kernels/series.kernel_fused_scan's Bernoulli series.  With `paired` it computes
// the diagonal out[b, r] of x (R, d) against z (R, d), row with row.
//
// It replaces no Pallas kernel: the JAX package writes kernel_fused_scan as a lax.scan
// that XLA fuses into one pass over the output.  The port's loop of in-place torch ops
// reads and writes the whole (R, M) buffer ~14 times a dimension (~115 passes, ~55 GB at
// R = 59, M = 2^20, d = 8); this kernel stores it once.
//
// Bound on the H100.  At R = 59, M = 2^20, d = 8, alpha = 2 the one store is 247 MB and
// z, 34 MB, is read once from memory: 0.084 ms at 3.35 TB/s.  The folded series below
// needs 2 + 2 DEG = 10 FLOPs a (row, column, dimension), 4.9e9 FLOPs, 0.074 ms at
// 67 TFLOP/s: ~18 FLOPs a byte against the card's FP32 ridge of ~20.  Both limits are
// close, so the kernel may waste neither instructions nor bytes.
//
// Design.
//  * The host folds each (pair, dimension)'s series into one polynomial: coeff times the
//    Bernoulli coefficients, zero-padded to an even degree DEG (a template), then ind and
//    whether the degree is odd.  Each block multiplies its batch row's lengthscale in as it
//    loads the table into shared memory and adds ind to the constant term (no copy to the
//    host, so no synchronisation): a factor is then DEG fused multiply-adds.
//  * The mod 1 costs nothing.  x and z are wrapped into [0, 1] once as they are staged, so
//    delta = x - z lies in [-1, 1] and B_m(delta mod 1) = (+-1)^m B_m(|delta|), since
//    B_m(1 - t) = (-1)^m B_m(t) and B_m(1) = B_m(0) for m >= 2.  Horner runs on |delta|
//    and an odd degree flips the sign where delta < 0 (a branch uniform over the block).
//    A (row, column, dimension) is a subtract, DEG FMAs and a multiply.
//  * A block owns kRows (8) rows and kTile (512) columns; each of its 128 threads owns 4
//    consecutive columns and keeps their 8 x 4 running products in registers.  The
//    columns' coordinates (up to stage_dims dimensions at a time) are staged transposed in
//    shared memory and read as one vector a dimension; the rows' coordinates and the table
//    are shared-memory broadcasts.  The row tile varies fastest along the grid, so the
//    blocks of one column tile run together and all but the first read z from L2.  A last
//    tile of at most 4 rows runs the 4-row variant.
//  * Stores are coalesced vectors (float4, or two double2: a warp writes 512 or 1024
//    contiguous bytes a row) with the streaming hint, as 247 MB does not stay in the 50 MB
//    L2.  Pairs accumulate in registers (acc += w_p prod_p) and s_b multiplies once, so
//    nothing touches the rows again before K3 and the posterior mean read them.
//  * float32 and float64 (templates), built without fast math: the configuration's float32
//    stays float32 arithmetic.
//
// Every entry point returns cudaGetLastError() (or the first failing CUDA call); the
// Python wrapper (ops/si_cross.py) raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;             // threads a block
constexpr int kCols = 4;                  // consecutive columns a thread owns
constexpr int kTile = kThreads * kCols;   // columns a block
constexpr int kZStride = kTile + 4;       // a staged dimension's slots: the pad spreads the
                                          // staging stores over the banks, keeps 16 B rows
constexpr int kRows = 8;                  // rows a block
constexpr size_t kMaxSmem = 232448;       // a block's shared memory on the H100

// dimensions of z staged at a time: 16 float or 8 double, 33 KB
template <typename T>
__host__ __device__ constexpr int stage_dims() { return 64 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
// into [0, 1] (1 only by rounding, where B_m(1) = B_m(0))
__device__ __forceinline__ float wrap(float v) { return v - floorf(v); }
__device__ __forceinline__ double wrap(double v) { return v - floor(v); }

// four consecutive values of 16-byte aligned memory
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}

template <typename T>
struct Args {
  const T* x;     // (R, d) rows
  const T* z;     // (M, d) columns; paired: (R, d)
  const T* tab;   // (P, d, DEG + 3): the polynomial (highest power first), ind, odd
  const T* w;     // (P,) pair weights
  const T* ls;    // (B, d) lengthscales
  const T* s;     // (B,) scales
  const T* f;     // (B,) task factors, or null
  T* out;         // (B, R, M); paired: (B, R)
  long long M;
  int R, d, P, row_tiles;
  bool vec;       // rows of out start 16-byte aligned: vector stores
  bool zvec;      // rows of z, and their every 4th value, 16-byte aligned: vector loads
};

// The block's table in shared memory: hs[p, j, :] = ls[b, j] * tab[p, j, :DEG+1], the
// constant term plus ind; odd[p, j] the degree's parity.
template <typename T, int DEG>
__device__ __forceinline__ void load_table(const Args<T>& a, int b, T* hs, int* odd) {
  const int n = a.P * a.d;
  const T* ls = a.ls + static_cast<long long>(b) * a.d;
  for (int e = threadIdx.x; e < n * (DEG + 1); e += blockDim.x) {
    const int pj = e / (DEG + 1), i = e - pj * (DEG + 1);
    const T* src = a.tab + pj * (DEG + 3);
    T v = ls[pj % a.d] * src[i];
    if (i == DEG) v += src[DEG + 1];
    hs[e] = v;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    odd[e] = a.tab[e * (DEG + 3) + DEG + 2] != T(0);
}

template <typename T, int DEG>
__device__ __forceinline__ T factor(const T (&h)[DEG + 1], T dl, bool odd) {
  const T t = abs_(dl);
  T f = h[0];
#pragma unroll
  for (int i = 1; i <= DEG; ++i) f = fma_(f, t, h[i]);
  return odd && dl < T(0) ? -f : f;
}

// prod[r][q] *= the factors of dimension j (rows xr[r], columns zq[q])
template <bool ODD, typename T, int DEG, int NR>
__device__ __forceinline__ void mul_factors(T (&prod)[NR][kCols], const T* xr,
                                            const T (&zq)[kCols], const T (&h)[DEG + 1]) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const T xv = xr[r];
#pragma unroll
    for (int q = 0; q < kCols; ++q) prod[r][q] *= factor<T, DEG>(h, xv - zq[q], ODD);
  }
}

// zs[jj][col] = wrap(z[c_blk + col, j0 + jj]) for jj < jl, 0 past the columns; float
// columns of a multiple of 4 dimensions load as float4
template <typename T>
__device__ __forceinline__ void stage(const Args<T>& a, T* zs, long long c_blk, int j0,
                                      int jl) {
  for (int col = threadIdx.x; col < kTile; col += kThreads) {
    const long long c = c_blk + col;
    const T* zc = a.z + c * a.d + j0;
    if constexpr (sizeof(T) == 4) {
      if (a.zvec) {
        for (int jj = 0; jj < jl; jj += 4) {
          const float4 v = c < a.M ? *reinterpret_cast<const float4*>(zc + jj)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          zs[jj * kZStride + col] = wrap(v.x);
          zs[(jj + 1) * kZStride + col] = wrap(v.y);
          zs[(jj + 2) * kZStride + col] = wrap(v.z);
          zs[(jj + 3) * kZStride + col] = wrap(v.w);
        }
        continue;
      }
    }
    for (int jj = 0; jj < jl; ++jj) zs[jj * kZStride + col] = c < a.M ? wrap(zc[jj]) : T(0);
  }
}

// One block's NR rows (nr of them real) against its kTile columns; ONE: a single pair.
template <typename T, int DEG, int NR, bool ONE>
__device__ __forceinline__ void cross_tile(const Args<T>& a, T* zs, const T* xs, const T* hs,
                                           const int* odd, long long c_blk, int b, int r0,
                                           int nr) {
  constexpr int JC = stage_dims<T>();
  const int t = threadIdx.x;
  const bool whole = a.d <= JC;
  if (whole) stage(a, zs, c_blk, 0, a.d);
  __syncthreads();
  T prod[NR][kCols], acc[NR][kCols];   // acc: the pairs' sum, unused when ONE
  for (int p = 0; p < (ONE ? 1 : a.P); ++p) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q) prod[r][q] = T(1);
    for (int j0 = 0; j0 < a.d; j0 += JC) {
      const int jl = min(JC, a.d - j0);
      if (!whole) {
        __syncthreads();
        stage(a, zs, c_blk, j0, jl);
        __syncthreads();
      }
      for (int jj = 0; jj < jl; ++jj) {
        const int pj = p * a.d + j0 + jj;
        T zq[kCols];
        load4(zs + jj * kZStride + kCols * t, zq);
        T h[DEG + 1];
#pragma unroll
        for (int i = 0; i <= DEG; ++i) h[i] = hs[pj * (DEG + 1) + i];
        const T* xr = xs + (j0 + jj) * kRows;
        if (odd[pj])
          mul_factors<true, T, DEG, NR>(prod, xr, zq, h);
        else
          mul_factors<false, T, DEG, NR>(prod, xr, zq, h);
      }
    }
    if constexpr (!ONE) {
      const T wp = a.w[p];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          acc[r][q] = fma_(wp, prod[r][q], p == 0 ? T(0) : acc[r][q]);
    }
  }
  const T sb = a.f ? a.s[b] * a.f[b] : a.s[b], w0 = a.w[0];
  const long long c = c_blk + kCols * t;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < nr) {
      T v[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) v[q] = sb * (ONE ? w0 * prod[r][q] : acc[r][q]);
      T* o = a.out + (static_cast<long long>(b) * a.R + r0 + r) * a.M + c;
      if (a.vec && c + kCols <= a.M) {
        store4(o, v);
      } else {
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          if (c + q < a.M) __stcs(o + q, v[q]);
      }
    }
  }
}

// Blocks an SM the float32 one-pair kernel is compiled for: 7 caps it at 72 registers
// (95 uncapped: 5 blocks an SM), with no spills at DEG = 4 (8 bytes at DEG = 2).  On the
// H100 at R = 59, M = 2^20, d = 8: 0.225 ms uncapped, 0.201 ms at 6 blocks, 0.186 ms at 7,
// 0.195 ms at 8 (64 registers).
template <typename T, bool ONE>
constexpr int kMinBlocks = sizeof(T) == 4 && ONE ? 7 : 1;

// grid (row_tiles * ceil(M / kTile), B), kThreads threads; block u holds row tile
// u % row_tiles of column tile u / row_tiles, batch row blockIdx.y.  ONE (P = 1) is a
// kernel of its own: without the pairs' sum it needs half the registers.
template <typename T, int DEG, bool ONE>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, ONE>))
    si_cross_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int jc = min(a.d, stage_dims<T>());
  T* zs = reinterpret_cast<T*>(smem);      // [jc][kZStride]
  T* xs = zs + jc * kZStride;              // [d][kRows]
  T* hs = xs + a.d * kRows;                // [P][d][DEG + 1]
  int* odd = reinterpret_cast<int*>(hs + a.P * a.d * (DEG + 1));   // [P][d]
  const int rt = blockIdx.x % a.row_tiles;
  const long long c_blk = static_cast<long long>(blockIdx.x / a.row_tiles) * kTile;
  const int b = blockIdx.y, r0 = rt * kRows, nr = min(kRows, a.R - r0);
  load_table<T, DEG>(a, b, hs, odd);
  for (int e = threadIdx.x; e < a.d * kRows; e += kThreads) {   // xs[j][r], 0 past the rows
    const int j = e / kRows, r = e - j * kRows;
    xs[e] = r < nr ? wrap(a.x[static_cast<long long>(r0 + r) * a.d + j]) : T(0);
  }
  // (cross_tile synchronises before it reads any of these)
  if (nr <= kRows / 2)
    cross_tile<T, DEG, kRows / 2, ONE>(a, zs, xs, hs, odd, c_blk, b, r0, nr);
  else
    cross_tile<T, DEG, kRows, ONE>(a, zs, xs, hs, odd, c_blk, b, r0, nr);
}

// grid (ceil(R / kThreads), B), kThreads threads: one thread an output
template <typename T, int DEG>
__global__ void __launch_bounds__(kThreads) si_pair_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);                              // [P][d][DEG + 1]
  int* odd = reinterpret_cast<int*>(hs + a.P * a.d * (DEG + 1));   // [P][d]
  const int b = blockIdx.y;
  load_table<T, DEG>(a, b, hs, odd);
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= a.R) return;
  T acc = T(0);
  for (int p = 0; p < a.P; ++p) {
    T prod = T(1);
    for (int j = 0; j < a.d; ++j) {
      const int pj = p * a.d + j;
      T h[DEG + 1];
#pragma unroll
      for (int i = 0; i <= DEG; ++i) h[i] = hs[pj * (DEG + 1) + i];
      prod *= factor<T, DEG>(h, wrap(a.x[r * a.d + j]) - wrap(a.z[r * a.d + j]), odd[pj] != 0);
    }
    acc = fma_(a.w[p], prod, acc);
  }
  a.out[static_cast<long long>(b) * a.R + r] = (a.f ? a.s[b] * a.f[b] : a.s[b]) * acc;
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DEG>
cudaError_t launch(const Args<T>& a, int B, bool paired, cudaStream_t s) {
  const size_t table = static_cast<size_t>(a.P) * a.d * ((DEG + 1) * sizeof(T) + sizeof(int));
  cudaError_t e;
  if (paired) {
    if (table > kMaxSmem) return cudaErrorInvalidValue;
    if ((e = allow_smem(si_pair_kernel<T, DEG>, table)) != cudaSuccess) return e;
    si_pair_kernel<T, DEG><<<dim3((a.R + kThreads - 1) / kThreads, B), kThreads, table, s>>>(a);
  } else {
    const int jc = a.d < stage_dims<T>() ? a.d : stage_dims<T>();
    const size_t smem = (static_cast<size_t>(jc) * kZStride + static_cast<size_t>(a.d) * kRows)
                        * sizeof(T) + table;
    const long long blocks = ((a.M + kTile - 1) / kTile) * a.row_tiles;
    if (smem > kMaxSmem || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    auto kernel = a.P == 1 ? si_cross_kernel<T, DEG, true> : si_cross_kernel<T, DEG, false>;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(static_cast<unsigned>(blocks), B), kThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* z, const void* tab, const void* w, const void* ls,
                const void* s, const void* f, void* out, long long R, long long M, int d, int P,
                int deg, int B, bool paired, cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(x), static_cast<const T*>(z), static_cast<const T*>(tab),
            static_cast<const T*>(w), static_cast<const T*>(ls), static_cast<const T*>(s),
            static_cast<const T*>(f), static_cast<T*>(out), M, static_cast<int>(R), d, P,
            static_cast<int>((R + kRows - 1) / kRows),
            M % kCols == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0,
            d % 4 == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0};
  switch (deg) {
    case 2: return launch<T, 2>(a, B, paired, stream);
    case 4: return launch<T, 4>(a, B, paired, stream);
    case 6: return launch<T, 6>(a, B, paired, stream);
    case 8: return launch<T, 8>(a, B, paired, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (R, d) and z (M, d), or z (R, d) when `paired`; tab (P, d, deg + 3), w (P,), ls (B, d),
// s (B,), f (B,) or null, all contiguous in one type (`is_double`: float64, else float32);
// out (B, R, M), or (B, R) when `paired`.  deg is even, 2..8.
int fgp_si_cross(const void* x, const void* z, const void* tab, const void* w,
                 const void* ls, const void* s, const void* f, void* out, long long R,
                 long long M, int d, int P, int deg, int B, int paired, int is_double,
                 void* stream) {
  if (R < 1 || R > 0x7fffffffLL || M < 1 || d < 1 || P < 1 || B < 1 || B > 65535 ||
      static_cast<long long>(P) * d > (1 << 20) || (paired && M != R))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_double
      ? run<double>(x, z, tab, w, ls, s, f, out, R, M, d, P, deg, B, paired != 0, st)
      : run<float>(x, z, tab, w, ls, s, f, out, R, M, d, P, deg, B, paired != 0, st);
  return static_cast<int>(e);
}

}  // extern "C"
