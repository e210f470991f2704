// Orthonormal fast Walsh-Hadamard transform of the last axis for Hopper (sm_90a),
// plain C interface: kernel K4.
//
// Replaces the Pallas TPU kernel in fastgaussianprocesses_tpu/ops/pallas_fwht.py:
// `_make_kernel` (:59), launched by `_fwht_fused` (:93), together with the XLA
// contraction that `fwht_pallas` adds above 2^18 and the XLA path that `fwht_best`
// takes for one row above 2^18.  Here every float32 (and float64) FWHT on the card,
// any power-of-two n and any number of rows R, goes through this kernel.
//
// Function: out[r] = H_n (x[r] - mean[r]) / sqrt(n), H_n the +/-1 Sylvester-order
// Hadamard matrix, the mean optional (null: none).  The TPU kernel computed it as two
// +/-1 matrix products per row on the MXU (H_{n1} X H_{n2}); here it is the radix-2
// butterfly network (u, v) -> (u + v, u - v), stage by stage from the lowest index bit
// up, times 1/sqrt(n) once at the end, in plain FP32 (FP64) arithmetic: no tensor cores,
// no TF32.  The float32 result equals float32 numpy butterflies in that order bit for
// bit (x - mean rounds as torch's `x - xmean`).
//
// Bound on the H100: the function reads R*n*4 bytes and writes R*n*4 bytes.  At
// n = 2^20, R = 119 that is 998 MB, 0.298 ms at 3.35 TB/s, against 2.5 GFLOP of adds
// (0.037 ms at 67 TFLOP/s): bound by bytes, by 8x.
//
// HBM traffic of the design: the input read once and the output written once, about
// the function's own 998 MB at n = 2^20, R = 119.  A pass over device memory per group
// of index bits, as before this design, moved twice that (0.596 ms at best).
//
// Design: H_n = H_{n_hi} (x) H_{n_lo} over the bits of the index, as passes over tiles
// of 2^L values (L = 13; 14 at n = 2^14 and above n = 2^20), 16 values a (virtual)
// thread: float tiles of 2^13 run two virtual threads a thread (32 values in registers,
// 256 threads), the others one.  A register layout (a, b) holds the tile bits a, a+1,
// b, b+1 in registers; a thread runs those 4 stages in registers, then exchanges its
// values through shared memory (padded one slot in 32: no bank conflict but in the
// windows at bits 2-5 and 4-7) into the next layout.
//   Pass 1: the 12 lowest index bits of 2^L contiguous values (all the bits up to
//   n = 2^14, a row a tile, so that a short row is one pass): stages 0-1 in layout
//   (0, 10), whose registers are 4 contiguous values, loaded and stored as 16-byte
//   vectors with neighbouring threads on neighbouring vectors; 2-5 and 6-9 in windows;
//   10-11 back in (0, 10).  All loads are in flight before the first is used; the row mean,
//   when given, is subtracted from each value as it is loaded.
//   Later passes, in place on the output: up to 10 more bits each, on a tile of 2^k
//   values 2^lo apart down W = 2^(L - k) neighbouring columns (at n = 2^20: bits 12-19,
//   256 x 32, two radix-16 steps, 128-byte runs; at 2^22: bits 12-21, 1024 x 16).
//   One persistent launch.  Blocks take tiles from a ticket counter, groups of rows
//   staggered: slot s deals pass 1 of group s, then pass 2 of group s - 1 (and so on
//   for more passes), so a pass-2 tile is dealt a whole group after the pass-1 tiles it
//   needs.  It waits (acquire load) until every pass-1 tile of its row has stored and
//   released (fence, relaxed add) the row's counter.  Only running blocks take tickets
//   and a tile waits only on lower tickets, so no tile waits on a block that has not
//   started, whatever the grid.  Thread 0 takes the next ticket as a tile starts and
//   releases a finished tile once the next tile's loads are in flight.  The pass-1
//   output of the two live groups (2 x 12 MB at n = 2^20, float32: group size measured
//   among 8, 12, 16 and 32 MB) stays in the 50 MB L2: the input is read as streaming
//   (__ldcs), pass 1 stores to L2 (__stcg), later passes read through L2 (__ldcg), and
//   the final stores stream out (__stcs).  At R = 1 a whole row (4 MB at 2^20, 16 MB at
//   2^22) is one group.  One pass needs no order: its blocks stride over the tiles.
// The schedule (passes, steps, tiles, groups, tickets, grid) is `fwht_plan` in
// ops/fwht.py; this file derives the same passes, steps and ticket order from log_n,
// log_tile, log_first, log_single, log_later and group_rows.  Deterministic: a fixed
// order of operations; the atomics touch only the ticket and row counters.
//
// The entry point zeroes the counters with cudaMemsetAsync on the stream (so a CUDA
// graph that captures it replays correctly) and returns cudaGetLastError() (or the
// first failing CUDA call); the Python wrapper (ops/fwht.py) raises when it is not 0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

struct Args {
  const void* in;
  void* out;
  const void* mean;    // per-row mean to subtract on load, or null
  unsigned* counters;  // [0]: tickets dealt; [1 + p*rows + r]: pass-p tiles of row r done
  int rows;
  int tickets;
  int log_n;
  int log_first;       // index bits of pass 1 ...
  int log_single;      // ... or all of them, in one pass, up to this many
  int log_later;       // at most this many bits in each later pass
  int group_rows;
};

constexpr int kMaxSpins = 1 << 25;  // seconds of waiting: far beyond any real wait
constexpr int kVecA = 0;            // pass 1 loads and stores in layout (0, 10):
constexpr int kVecB = 10;           // registers 0-3 are 4 contiguous values

// shared-memory slot of tile index i: one pad slot every 32 (no bank conflict in any
// layout but the windows at bits 2-5 and 4-7, which have 2-way conflicts)
__host__ __device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// Layout (a, b): register bits 0-1 at tile bits a, a+1 and 2-3 at b, b+1; the thread
// index fills the other tile bits, lowest first.  lay_base: the tile index of
// register 0; register q adds lay_off(q).
__device__ __forceinline__ int lay_base(int vt, int a, int b) {
  return (vt & ((1 << a) - 1)) | (((vt >> a) & ((1 << (b - a - 2)) - 1)) << (a + 2)) |
         ((vt >> (b - 2)) << (b + 2));
}
__device__ __forceinline__ int lay_off(int q, int a, int b) {
  return ((q & 3) << a) | ((q >> 2) << b);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;"
               : : "l"(p) : "memory");
}

// 4 contiguous values as 16-byte vectors, read once (streaming)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// the final pass streams its stores out; an earlier pass keeps them in L2
template <typename T>
__device__ __forceinline__ void store1(T* p, T v, bool last) {
  if (last)
    __stcs(p, v);
  else
    __stcg(p, v);
}

__device__ __forceinline__ void store4(float* p, const float* v, bool last) {
  store1(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]), last);
}

__device__ __forceinline__ void store4(double* p, const double* v, bool last) {
  store1(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]), last);
  store1(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]), last);
}

// stages r0..r1-1 of the radix-16 butterfly network on each virtual thread's registers
template <typename T, int VT>
__device__ __forceinline__ void radix16(T (&v)[VT][16], int r0, int r1) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (h < r0 || h >= r1) continue;
#pragma unroll
    for (int j = 0; j < VT; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int lo = ((e >> h) << (h + 1)) | (e & ((1 << h) - 1));
        const int hi = lo | (1 << h);
        const T u = v[j][lo];
        const T w = v[j][hi];
        v[j][lo] = u + w;
        v[j][hi] = u - w;
      }
    }
  }
}

// Slot of register q, relative to the slot of register 0, in layout (a, b): for every
// layout the kernel uses, the low 5 bits of the thread's base index and of lay_off(q)
// never carry, so pad32(base + off) = pad32(base) + off + (off >> 5).
__device__ __forceinline__ int slot_off(int q, int a, int b) {
  const int off = lay_off(q, a, b);
  return off + (off >> 5);
}

// Registers of layout (a0, b0) -> padded shared memory -> registers of layout (a1, b1).
// Inlined with the layouts known at compile time, every slot is the thread's base slot
// plus a constant; a window (w, w + 2) at w >= 5 is a fixed step of 2^w + 2^(w-5).
template <typename T, int VT, int NT>
__device__ __forceinline__ void exchange(T* s, T (&v)[VT][16], int a0, int b0, int a1, int b1) {
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    T* p = s + pad32(lay_base(threadIdx.x + j * NT, a0, b0));
    if (b0 == a0 + 2 && a0 >= 5) {
      const int step = (1 << a0) + (1 << (a0 - 5));
#pragma unroll
      for (int q = 0; q < 16; ++q) p[q * step] = v[j][q];
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) p[slot_off(q, a0, b0)] = v[j][q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const T* p = s + pad32(lay_base(threadIdx.x + j * NT, a1, b1));
    if (b1 == a1 + 2 && a1 >= 5) {
      const int step = (1 << a1) + (1 << (a1 - 5));
#pragma unroll
      for (int q = 0; q < 16; ++q) v[j][q] = p[q * step];
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) v[j][q] = p[slot_off(q, a1, b1)];
    }
  }
}

// A later pass's tile index i = a * 2^log_w + (column) lies at a * 2^lo + (column)
// from the tile's origin.
__device__ __forceinline__ long long strided(int i, int log_w, int lo) {
  return (static_cast<long long>(i >> log_w) << lo) + (i & ((1 << log_w) - 1));
}

// A thread's 16 values of a later pass in window (w, w + 2), its register 0 at tile
// index base.  In a window at or above log_w (all but that of a pass of fewer than 4
// bits) register q adds q << (w - log_w) to a: a fixed step in memory.
template <typename T>
__device__ __forceinline__ void load_strided(const T* x, T (&v)[16], int base, int w, int log_w,
                                             int lo) {
  if (w >= log_w) {
    const T* px = x + strided(base, log_w, lo);
    const long long step = 1LL << (w - log_w + lo);
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = __ldcg(px + q * step);
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = __ldcg(x + strided(base + (q << w), log_w, lo));
  }
}

template <typename T>
__device__ __forceinline__ void store_strided(T* x, const T (&v)[16], int base, int w, int log_w,
                                              int lo, bool last) {
  if (w >= log_w) {
    T* px = x + strided(base, log_w, lo);
    const long long step = 1LL << (w - log_w + lo);
#pragma unroll
    for (int q = 0; q < 16; ++q) store1(px + q * step, v[q], last);
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) store1(x + strided(base + (q << w), log_w, lo), v[q], last);
  }
}

// tickets dealt before slot s: pass p of group g runs in slot g + p
__device__ __forceinline__ int slot_start(int s, int n_pass, int groups, const Args& a,
                                          int log_tpr) {
  int c = 0;
  for (int p = 0; p < n_pass; ++p) {
    int k = s - p;
    k = k < 0 ? 0 : (k > groups ? groups : k);
    const int r = k * a.group_rows;
    c += r < a.rows ? r : a.rows;
  }
  return c << log_tpr;
}

// (pass, flat tile) of ticket tk; pass -1 when the tickets are spent
__device__ void decode(int tk, const Args& a, int n_pass, int log_tpr, int* p_out, int* f_out) {
  if (tk >= a.tickets) {
    *p_out = -1;
    return;
  }
  if (n_pass == 1) {
    *p_out = 0;
    *f_out = tk;
    return;
  }
  const int groups = (a.rows + a.group_rows - 1) / a.group_rows;
  const int last_slot = groups + n_pass - 2;
  // between the ramps every slot holds n_pass whole groups
  int s = (tk / (a.group_rows << log_tpr) + n_pass * (n_pass - 1) / 2) / n_pass;
  s = s > last_slot ? last_slot : s;
  while (s > 0 && slot_start(s, n_pass, groups, a, log_tpr) > tk) --s;
  while (s < last_slot && slot_start(s + 1, n_pass, groups, a, log_tpr) <= tk) ++s;
  int u = tk - slot_start(s, n_pass, groups, a, log_tpr);
  int p = 0;
  for (; p < n_pass - 1; ++p) {
    const int g = s - p;
    int size = 0;
    if (g >= 0 && g < groups) {
      const int end = (g + 1) * a.group_rows;
      size = ((end < a.rows ? end : a.rows) - g * a.group_rows) << log_tpr;
    }
    if (u < size) break;
    u -= size;
  }
  *p_out = p;
  *f_out = ((s - p) * a.group_rows << log_tpr) + u;
}

template <typename T, int VT>
__device__ __forceinline__ void scale_all(T (&v)[VT][16], T scale) {
#pragma unroll
  for (int j = 0; j < VT; ++j)
#pragma unroll
    for (int q = 0; q < 16; ++q) v[j][q] *= scale;
}

// What a block knows of the call.
struct Shape {
  int m;          // log_n
  int b1;         // index bits of pass 1
  int n_pass;
  int log_tpr;    // tiles of a row in each pass (several passes only)
  long long total;
};

// Pass 1 of a tile within one row (n >= 2^L), aligned: 16-byte vectors and the
// layouts known at compile time.  `pending`, a counter to release once the loads
// are in flight, is released and cleared by thread 0.
template <typename T, int L, int VT, int NT>
__device__ __forceinline__ void first_pass_rows(const Args& a, const Shape& sh, T* s, long long f,
                                                bool last, T scale, unsigned*& pending) {
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  T v[VT][16];
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const T* p = in + (f << L) + lay_base(threadIdx.x + j * NT, kVecA, kVecB);
#pragma unroll
    for (int c = 0; c < 4; ++c) load4(p + (c << kVecB), &v[j][4 * c]);
  }
  if (threadIdx.x == 0 && pending != nullptr) {
    add_release(pending);
    pending = nullptr;
  }
  if (a.mean != nullptr) {
    const T mu = static_cast<const T*>(a.mean)[f >> sh.log_tpr];
#pragma unroll
    for (int j = 0; j < VT; ++j)
#pragma unroll
      for (int q = 0; q < 16; ++q) v[j][q] -= mu;
  }
  radix16(v, 0, 2);
  exchange<T, VT, NT>(s, v, kVecA, kVecB, 2, 4);
  radix16(v, 0, 4);
  exchange<T, VT, NT>(s, v, 2, 4, 6, 8);
  radix16(v, 0, 4);
  exchange<T, VT, NT>(s, v, 6, 8, kVecA, kVecB);
  radix16(v, 2, 4);
  if (sh.b1 > 12) {  // a row of 2^13 or 2^14 values in one tile: its top window
    exchange<T, VT, NT>(s, v, kVecA, kVecB, L - 4, L - 2);
    radix16(v, 12 - (L - 4), sh.b1 - (L - 4));
    exchange<T, VT, NT>(s, v, L - 4, L - 2, kVecA, kVecB);
  }
  if (last) scale_all(v, scale);
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    T* p = out + (f << L) + lay_base(threadIdx.x + j * NT, kVecA, kVecB);
#pragma unroll
    for (int c = 0; c < 4; ++c) store4(p + (c << kVecB), &v[j][4 * c], last);
  }
}

// Pass 1 of any other tile (rows shorter than a tile, or unaligned data): the same
// steps, every access a checked scalar one.
template <typename T, int L, int VT, int NT>
__device__ __forceinline__ void first_pass_any(const Args& a, const Shape& sh, T* s, long long f,
                                               bool last, T scale, unsigned*& pending) {
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  const T* mean = static_cast<const T*>(a.mean);
  T v[VT][16];
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const long long g = (f << L) + lay_base(threadIdx.x + j * NT, kVecA, kVecB);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const long long gq = g + lay_off(q, kVecA, kVecB);
      v[j][q] = gq < sh.total ? __ldcs(in + gq) : T(0);
    }
  }
  if (threadIdx.x == 0 && pending != nullptr) {
    add_release(pending);
    pending = nullptr;
  }
  if (mean != nullptr) {
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      const long long g = (f << L) + lay_base(threadIdx.x + j * NT, kVecA, kVecB);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const long long gq = g + lay_off(q, kVecA, kVecB);
        if (gq < sh.total) v[j][q] -= mean[gq >> sh.m];
      }
    }
  }
  const int b1 = sh.b1;
  int ca = kVecA, cb = kVecB;
  if (b1 > 0) radix16(v, 0, b1 < 2 ? b1 : 2);
  const int b10 = b1 < 10 ? b1 : 10;
  for (int s0 = 2; s0 < b10; s0 += 4) {
    exchange<T, VT, NT>(s, v, ca, cb, s0, s0 + 2);
    ca = s0;
    cb = s0 + 2;
    radix16(v, 0, b10 - s0 < 4 ? b10 - s0 : 4);
  }
  if (b1 > 10) {
    if (ca != kVecA) exchange<T, VT, NT>(s, v, ca, cb, kVecA, kVecB);
    ca = kVecA;
    cb = kVecB;
    radix16(v, 2, (b1 < 12 ? b1 : 12) - 8);
  }
  if (b1 > 12) {
    exchange<T, VT, NT>(s, v, ca, cb, L - 4, L - 2);
    ca = L - 4;
    cb = L - 2;
    radix16(v, 12 - ca, b1 - ca);
  }
  if (ca != kVecA) exchange<T, VT, NT>(s, v, ca, cb, kVecA, kVecB);
  if (last) scale_all(v, scale);
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const long long g = (f << L) + lay_base(threadIdx.x + j * NT, kVecA, kVecB);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const long long gq = g + lay_off(q, kVecA, kVecB);
      if (gq < sh.total) store1(out + gq, v[j][q], last);
    }
  }
}

// A later pass p of flat tile f, in place on the output, once every pass p-1 tile of
// its row is done.
template <typename T, int L, int VT, int NT>
__device__ __forceinline__ void later_pass(const Args& a, const Shape& sh, T* s, int p,
                                          long long f, bool last, T scale,
                                          unsigned*& pending) {
  if (threadIdx.x == 0) {
    if (pending != nullptr) add_release(pending);
    pending = nullptr;
    const unsigned* c = a.counters + 1 + (p - 1) * a.rows + (f >> sh.log_tpr);
    // a fault in the schedule traps (the wrapper raises) rather than hang
    for (int spin = 0; ld_acquire(c) < (1u << sh.log_tpr); ++spin) {
      if (spin == kMaxSpins) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  const int lo = a.log_first + (p - 1) * a.log_later;
  const int k = sh.m - lo < a.log_later ? sh.m - lo : a.log_later;
  const int log_w = L - k;
  const long long col = f << log_w;
  T* x = static_cast<T*>(a.out) + ((col >> lo) << (lo + k)) + (col & ((1LL << lo) - 1));
  T v[VT][16];
  int w = L - k < L - 4 ? L - k : L - 4;
#pragma unroll
  for (int j = 0; j < VT; ++j) load_strided(x, v[j], lay_base(threadIdx.x + j * NT, w, w + 2), w,
                                            log_w, lo);
  for (int s0 = 0; s0 < k; s0 += 4) {
    const int qb = L - k + s0;
    const int ws = qb < L - 4 ? qb : L - 4;
    if (ws != w) {
      exchange<T, VT, NT>(s, v, w, w + 2, ws, ws + 2);
      w = ws;
    }
    radix16(v, qb - ws, qb - ws + (k - s0 < 4 ? k - s0 : 4));
  }
  if (last) scale_all(v, scale);
#pragma unroll
  for (int j = 0; j < VT; ++j)
    store_strided(x, v[j], lay_base(threadIdx.x + j * NT, w, w + 2), w, log_w, lo, last);
}

// One persistent block: NT threads, each running VT virtual threads of 16 values.
// ANY: pass 1 by first_pass_any (rows shorter than a tile, or unaligned data), a
// separate instantiation so that its registers do not weigh on the main path's.
template <typename T, int L, int VT, bool ANY>
__global__ void __launch_bounds__((1 << (L - 4)) / VT, 1024 / ((1 << (L - 4)) / VT))
fwht_kernel(Args a, T scale) {
  constexpr int NT = (1 << (L - 4)) / VT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_pass[2];  // this tile's (pass, flat tile) and the next, by parity
  __shared__ int s_tile[2];
  const int t = threadIdx.x;
  Shape sh;
  sh.m = a.log_n;
  sh.b1 = sh.m <= a.log_single ? sh.m : a.log_first;
  sh.n_pass = sh.b1 == sh.m ? 1 : 1 + (sh.m - a.log_first + a.log_later - 1) / a.log_later;
  sh.log_tpr = sh.m - L;
  sh.total = static_cast<long long>(a.rows) << sh.m;
  const bool dealt = sh.n_pass > 1;  // one pass: no order to keep, a block-strided loop

  // Thread 0 takes the next tile's ticket as the block starts this one (and decodes it
  // at the end), and releases a finished tile's row counter only once the next tile's
  // loads are in flight (or before the next tile waits), so neither latency stalls the
  // block.
  unsigned* pending = nullptr;
  if (t == 0) {
    if (dealt) {
      decode(atomicAdd(a.counters, 1u), a, sh.n_pass, sh.log_tpr, &s_pass[0], &s_tile[0]);
    } else {
      s_pass[0] = static_cast<int>(blockIdx.x) < a.tickets ? 0 : -1;
      s_tile[0] = blockIdx.x;
    }
  }
  for (int it = 0;; ++it) {
    __syncthreads();  // the ticket is in; the last tile's stores and smem reads are done
    const int p = s_pass[it & 1];
    if (p < 0) break;
    const int f = s_tile[it & 1];
    unsigned next = 0;
    if (t == 0 && dealt) next = atomicAdd(a.counters, 1u);
    const bool last = p == sh.n_pass - 1;
    if (p > 0)
      later_pass<T, L, VT, NT>(a, sh, s, p, f, last, scale, pending);
    else if (ANY)
      first_pass_any<T, L, VT, NT>(a, sh, s, f, last, scale, pending);
    else
      first_pass_rows<T, L, VT, NT>(a, sh, s, f, last, scale, pending);
    if (t == 0) {
      if (dealt) {
        // released after the next loop-top barrier, which every thread's stores precede
        if (!last) pending = a.counters + 1 + p * a.rows + (f >> sh.log_tpr);
        decode(next, a, sh.n_pass, sh.log_tpr, &s_pass[(it + 1) & 1], &s_tile[(it + 1) & 1]);
      } else {
        const int nf = f + gridDim.x;
        s_pass[(it + 1) & 1] = nf < a.tickets ? 0 : -1;
        s_tile[(it + 1) & 1] = nf;
      }
    }
  }
  if (t == 0 && pending != nullptr) add_release(pending);
}

// Raise the kernel's dynamic shared memory limit once per device, type and tile size
// (not on every launch, so that launches can be captured in a CUDA graph).
constexpr int kMaxDevices = 64;
size_t g_granted[2][2][2][kMaxDevices];

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

template <typename T, int L, bool ANY>
cudaError_t launch_as(const Args& a, int grid, cudaStream_t stream) {
  // float tiles of 2^13: two virtual threads a thread (32 values in registers, 256
  // threads, four blocks an SM); otherwise one (what measured faster on the H100)
  constexpr int VT = sizeof(T) == 4 && L == 13 ? 2 : 1;
  const size_t smem = static_cast<size_t>(pad32(1 << L)) * sizeof(T);
  cudaError_t e = allow_smem(fwht_kernel<T, L, VT, ANY>, smem,
                             g_granted[sizeof(T) == 8][L - 13][ANY]);
  if (e != cudaSuccess) return e;
  const T scale = static_cast<T>(1.0 / std::sqrt(static_cast<double>(1LL << a.log_n)));
  fwht_kernel<T, L, VT, ANY><<<grid, (1 << (L - 4)) / VT, smem, stream>>>(a, scale);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch(const Args& a, int grid, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.in) | reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
  return a.log_n >= L && aligned ? launch_as<T, L, false>(a, grid, stream)
                                 : launch_as<T, L, true>(a, grid, stream);
}

}  // namespace

extern "C" {

// rows x 2^log_n values, contiguous, into `out` (not `in`); `mean`: rows values or null;
// `counters`: n_counters 32-bit words of scratch.  The schedule's ints come from
// `fwht_plan` (ops/fwht.py).  `is_double` selects float64, else float32.
int fgp_fwht(const void* in, void* out, const void* mean, void* counters, long long rows,
             int log_n, int log_tile, int log_first, int log_single, int log_later,
             int group_rows,
             long long tickets, int grid, int n_counters, int is_double, void* stream) {
  if (tickets == 0) return cudaSuccess;
  // tickets (and the ticket counter, which overshoots by the grid) and rows fit an int
  if ((log_tile != 13 && log_tile != 14) || log_first < 1 || log_first > 12 ||
      log_single < log_first || (log_n <= log_single && log_n > log_tile) ||
      log_later < 1 || log_later > log_tile - 1 || group_rows < 1 || grid < 1 ||
      log_n < 0 || rows < 1 || rows > (1LL << 29) || tickets + grid >= (1LL << 31) ||
      n_counters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;  // one pass takes no tickets: no counters
  if (n_counters > 0) e = cudaMemsetAsync(counters, 0, static_cast<size_t>(n_counters) * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{in, out, mean, static_cast<unsigned*>(counters), static_cast<int>(rows),
               static_cast<int>(tickets), log_n, log_first, log_single, log_later, group_rows};
  if (is_double)
    e = log_tile == 13 ? launch<double, 13>(a, grid, s) : launch<double, 14>(a, grid, s);
  else
    e = log_tile == 13 ? launch<float, 13>(a, grid, s) : launch<float, 14>(a, grid, s);
  return static_cast<int>(e);
}

}  // extern "C"
