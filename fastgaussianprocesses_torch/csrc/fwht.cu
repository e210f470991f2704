// Orthonormal fast Walsh-Hadamard transform of the last axis for Hopper (sm_90a),
// plain C interface: kernel K4.
//
// Replaces the Pallas TPU kernel in fastgaussianprocesses_tpu/ops/pallas_fwht.py:
// `_make_kernel` (:59), launched by `_fwht_fused` (:93), together with the XLA
// contraction that `fwht_pallas` adds above 2^18 and the XLA path that `fwht_best`
// takes for one row above 2^18.  Here every float32 (and float64) FWHT on the card,
// any power-of-two n and any number of rows R, goes through this kernel.
//
// Function: out[r] = H_n x[r] / sqrt(n), H_n the +/-1 Sylvester-order Hadamard matrix.
// The TPU kernel computed it as two +/-1 matrix products per row on the MXU
// (H_{n1} X H_{n2}); here it is the radix-2 butterfly network (u, v) -> (u + v, u - v),
// n log2 n float adds and subtracts per row, in plain FP32 (FP64) arithmetic: no
// tensor cores, no TF32, so the data are never rounded to fewer bits.
//
// Bound on the H100: the function reads R*n*4 bytes and writes R*n*4 bytes.  At
// n = 2^20, R = 119 that is 998 MB, 0.298 ms at 3.35 TB/s, against 2.5 GFLOP of adds
// (0.037 ms at 67 TFLOP/s): bound by bytes.  At R = 1 the bytes take 2.5 us.
//
// Design: H_n = H_{n_hi} (x) H_{n_lo} over the bits of the index.
//   Pass 1 (`fwht_rows_kernel`): a block loads 4096 contiguous values (n_lo = 2^12, or
//   the whole row below that, several rows per block) into shared memory, runs the
//   log2(n_lo) lowest stages in place and writes them out.  At n = 2^20, R = 1 that is
//   256 blocks for the 132 SMs.
//   Pass 2 (`fwht_cols_kernel`), in place, once for every further 10 bits of the index:
//   a block takes a (2^k, 16) tile, 2^k values 2^lo apart down 16 neighbouring columns,
//   read and written as 64-byte runs, and runs those k stages in shared memory.  At
//   n = 2^20 one such pass (k = 8, 256 blocks at R = 1) finishes the transform, and the
//   last pass folds in 1/sqrt(n).
// Cost against the bound: each pass reads and writes every value once, so for
// 2^12 < n <= 2^22 the kernel moves 2x the function's bytes; the bound it can reach is
// 0.596 ms at n = 2^20, R = 119.  Fusing both passes would need a whole row (4 MB) on
// chip, which one block's 227 KB of shared memory does not hold.
// Deterministic: a fixed order of operations, no atomics.
//
// The entry point returns cudaGetLastError() (or the first failing CUDA call); the
// Python wrapper (ops/fwht.py) raises when it is not 0.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kLogChunk = 12;    // pass 1: values per block
constexpr int kThreadsRows = 512;
constexpr int kLogCols = 4;      // pass 2: 16 columns per tile
constexpr int kMaxLogStrided = 10;  // pass 2: at most 2^10 values down a column
constexpr int kThreadsCols = 256;

// Pass 1: the log_seg lowest stages of every run of 2^log_seg values.  `total` values
// (R * n) are split into blocks of 2^kLogChunk; every block holds whole runs.
template <typename T>
__global__ void __launch_bounds__(kThreadsRows)
fwht_rows_kernel(const T* __restrict__ in, T* __restrict__ out, long long total, int log_seg,
                 T scale) {
  __shared__ T s[1 << kLogChunk];
  const long long base = static_cast<long long>(blockIdx.x) << kLogChunk;
  const long long left = total - base;
  const int count = left < (1 << kLogChunk) ? static_cast<int>(left) : (1 << kLogChunk);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = in[base + i];
  __syncthreads();
  const int nbf = count >> 1;
  for (int lh = 0; lh < log_seg; ++lh) {
    const int h = 1 << lh;
    for (int b = threadIdx.x; b < nbf; b += blockDim.x) {
      const int i0 = ((b >> lh) << (lh + 1)) + (b & (h - 1));
      const T u = s[i0];
      const T v = s[i0 + h];
      s[i0] = u + v;
      s[i0 + h] = u - v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) out[base + i] = s[i] * scale;
}

// Pass 2: the stages of index bits [log_lo, log_lo + log_k), in place.  With
// j = (hi << (log_lo + log_k)) + (a << log_lo) + c, one block owns the 2^log_k values
// a = 0.. of 16 neighbouring c for one hi (hi counting over all rows).
template <typename T>
__global__ void __launch_bounds__(kThreadsCols)
fwht_cols_kernel(T* __restrict__ x, int log_lo, int log_k, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  constexpr int W = 1 << kLogCols;
  const long long col = static_cast<long long>(blockIdx.x) << kLogCols;
  const long long c = col & ((1LL << log_lo) - 1);
  const long long hi = col >> log_lo;
  T* base = x + (hi << (log_lo + log_k)) + c;
  const long long stride = 1LL << log_lo;
  const int size = W << log_k;
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    s[i] = base[(i >> kLogCols) * stride + (i & (W - 1))];
  __syncthreads();
  const int nbf = size >> 1;
  for (int lh = 0; lh < log_k; ++lh) {
    const int h = 1 << lh;
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      const int w = t & (W - 1);
      const int b = t >> kLogCols;
      const int a0 = ((b >> lh) << (lh + 1)) + (b & (h - 1));
      T* p = s + (a0 << kLogCols) + w;
      const T u = p[0];
      const T v = p[h << kLogCols];
      p[0] = u + v;
      p[h << kLogCols] = u - v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    base[(i >> kLogCols) * stride + (i & (W - 1))] = s[i] * scale;
}

// Raise the column kernel's dynamic shared memory limit once per device and type (not
// on every launch, so that launches can be captured in a CUDA graph).
constexpr int kMaxDevices = 64;
size_t g_granted_cols[2][kMaxDevices];

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

template <typename T>
cudaError_t launch_fwht(const T* in, T* out, long long rows, int log_n, cudaStream_t stream,
                        size_t* granted) {
  const long long total = rows << log_n;
  if (total == 0) return cudaSuccess;
  const T inv_sqrt_n = static_cast<T>(1.0 / std::sqrt(static_cast<double>(1LL << log_n)));
  const int log_seg = log_n < kLogChunk ? log_n : kLogChunk;
  const long long blocks_rows = (total + (1 << kLogChunk) - 1) >> kLogChunk;
  fwht_rows_kernel<T><<<static_cast<unsigned>(blocks_rows), kThreadsRows, 0, stream>>>(
      in, out, total, log_seg, log_seg == log_n ? inv_sqrt_n : static_cast<T>(1));
  cudaError_t e = cudaGetLastError();
  for (int lo = log_seg; e == cudaSuccess && lo < log_n; lo += kMaxLogStrided) {
    const int k = log_n - lo < kMaxLogStrided ? log_n - lo : kMaxLogStrided;
    const size_t smem = (static_cast<size_t>(1) << (k + kLogCols)) * sizeof(T);
    if ((e = allow_smem(fwht_cols_kernel<T>, smem, granted)) != cudaSuccess) return e;
    const long long blocks = (total >> k) >> kLogCols;
    fwht_cols_kernel<T><<<static_cast<unsigned>(blocks), kThreadsCols, smem, stream>>>(
        out, lo, k, lo + k == log_n ? inv_sqrt_n : static_cast<T>(1));
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

extern "C" {

// rows x 2^log_n values, contiguous; `is_double` selects float64, else float32.
int fgp_fwht(const void* in, void* out, long long rows, int log_n, int is_double,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(launch_fwht(static_cast<const double*>(in),
                                        static_cast<double*>(out), rows, log_n, s,
                                        g_granted_cols[1]));
  return static_cast<int>(launch_fwht(static_cast<const float*>(in), static_cast<float*>(out),
                                      rows, log_n, s, g_granted_cols[0]));
}

}  // extern "C"
