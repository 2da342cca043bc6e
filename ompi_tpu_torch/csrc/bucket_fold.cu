// bucket_fold.cu — one bucket flush's allreduce in one pass, for NVIDIA
// Hopper (built for sm_90a).
//
// Replaces no TPU kernel. It was added for the bucket flush of
// coll/persistent's BucketFuser on a stacked comm whose rows all live on
// one card: there the flush packed its members into one (n, total)
// tensor, reduced its n rank rows, expanded the result to every row and
// copied each member's columns out again, four passes over the bucket.
// This kernel reads every member's (n, w_i) rows in place and writes
// their reduction once into each of the n rank rows of one output buffer,
// where member i occupies [n*off_i, n*(off_i + w_i)) as a contiguous
// (n, w_i) block:
//
//   out[n*off_i + r*w_i + c] = x_i[0][c] op x_i[1][c] op ... op x_i[n-1][c]
//
// for every rank row r, in rank order 0, 1, ..., n-1, accumulated in
// float32 (float32, bfloat16, float16) or float64 (float64) and rounded
// once to the storage type. op is SUM, MAX or MIN; MAX and MIN return NaN
// where any row holds one, as torch.maximum/minimum do.
//
// Bound on an H100 (SXM, 700 W): bytes. The flush must read n*total and
// write n*total elements, 2*n*total*itemsize bytes at 3.35 TB/s; it
// computes n-1 adds per column. At the DDP cell's 25 MiB bucket with 8
// rank rows that is about 210 MB read and 210 MB written.
//
// Design:
// - A table on the device, built once per bucket shape by the wrapper
//   (ops/bucket_fold.py): per member (source pointer, w_i, n*off_i, first
//   block), then a block -> member map. Blocks are laid over a flat
//   (member, column-chunk) space; block b handles kThreads * V columns of
//   member map[b].
// - Each thread takes V = 16 / itemsize neighbouring columns: it loads
//   the n rows at those columns as 16-byte vectors, kRows rows at a time
//   so that many loads are in flight before the first add, combines them
//   in registers in rank order, and stores the result with one 16-byte
//   store into each of the n rows. Neighbouring threads touch
//   neighbouring 16 bytes, so every row is read and written in full
//   lines.
// - No shared memory and no synchronisation: the work is one read and n
//   writes per column, all independent.
// - Scalar path: a member whose source, output block or row width is not
//   16-byte aligned, and the last V columns of a member whose width is no
//   multiple of V, go one element at a time, in the same rank order.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;           // rows loaded before they are combined
constexpr int kEntry = 4;          // int64 words per member in the table

enum { kSum = 0, kMax = 1, kMin = 2 };

template <typename T>
struct Acc { using type = float; };
template <>
struct Acc<double> { using type = double; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(typename Acc<T>::type x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ double narrow<double>(double x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

template <int OP, typename A>
__device__ __forceinline__ A combine(A a, A b) {
  if (OP == kSum) return a + b;
  if (a != a) return a;            // NaN wins, as torch.maximum/minimum
  if (b != b) return b;
  if (OP == kMax) return a < b ? b : a;
  return b < a ? b : a;
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const long long* __restrict__ members,
                const int* __restrict__ block_member, T* __restrict__ out,
                int n) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<T>::N;
  const long long* e = members + kEntry * block_member[blockIdx.x];
  const T* __restrict__ src = reinterpret_cast<const T*>(e[0]);
  const long long w = e[1];
  T* __restrict__ dst = out + e[2];
  const long long c = ((long long)blockIdx.x - e[3]) * (kThreads * V) +
                      (long long)threadIdx.x * V;
  if (c >= w) return;
  const bool aligned = (((uintptr_t)src | (uintptr_t)dst |
                         (uintptr_t)(w * (long long)sizeof(T))) & 15) == 0;
  if (aligned && c + V <= w) {
    A acc[V];
    for (int r0 = 0; r0 < n; r0 += kRows) {
      Vec<T> x[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < n)
          x[k] = *reinterpret_cast<const Vec<T>*>(src + (r0 + k) * w + c);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k >= n) break;
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = r0 + k == 0 ? widen(x[k].v[j])
                               : combine<OP>(acc[j], widen(x[k].v[j]));
      }
    }
    Vec<T> y;
#pragma unroll
    for (int j = 0; j < V; ++j) y.v[j] = narrow<T>(acc[j]);
    for (int r = 0; r < n; ++r)
      *reinterpret_cast<Vec<T>*>(dst + r * w + c) = y;
    return;
  }
  const long long end = c + V < w ? c + V : w;
  for (long long i = c; i < end; ++i) {
    A acc = widen(src[i]);
    for (int r = 1; r < n; ++r) acc = combine<OP>(acc, widen(src[r * w + i]));
    const T y = narrow<T>(acc);
    for (int r = 0; r < n; ++r) dst[r * w + i] = y;
  }
}

template <typename T>
int launch(const long long* members, const int* block_member, void* out,
           int blocks, int n, int op, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  if (op == kSum)
    fold_kernel<T, kSum><<<blocks, kThreads, 0, s>>>(members, block_member,
                                                     o, n);
  else if (op == kMax)
    fold_kernel<T, kMax><<<blocks, kThreads, 0, s>>>(members, block_member,
                                                     o, n);
  else
    fold_kernel<T, kMin><<<blocks, kThreads, 0, s>>>(members, block_member,
                                                     o, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The columns one block covers for a dtype of `itemsize` bytes: the
// wrapper lays its block map out by it.
extern "C" int bucket_fold_block_columns(int itemsize) {
  return itemsize == 2 || itemsize == 4 || itemsize == 8
             ? kThreads * (16 / itemsize) : 0;
}

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16; op: 0 SUM, 1 MAX,
// 2 MIN. `members` and `block_member` are the table on the device; `out`
// holds n * total elements. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError().
extern "C" int bucket_fold(const long long* members, const int* block_member,
                           void* out, int blocks, int n, int dtype, int op,
                           void* stream) {
  if (blocks <= 0 || n <= 0 || op < kSum || op > kMin)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(members, block_member, out, blocks, n, op, s);
    case 1: return launch<double>(members, block_member, out, blocks, n, op,
                                  s);
    case 2: return launch<__nv_bfloat16>(members, block_member, out, blocks,
                                         n, op, s);
    case 3: return launch<__half>(members, block_member, out, blocks, n, op,
                                  s);
    default: return (int)cudaErrorInvalidValue;
  }
}
