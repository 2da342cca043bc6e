// flash_fold.cu — one online-softmax fold of a K/V block into the flash
// accumulators (o, m, l), for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel `_block_kernel` in ompi_tpu/ops/flash_attention.py
// (launched by `_pallas_fold` through `pl.pallas_call`). Per (bh, q row):
//   s   = q . k^T                       (q pre-scaled)
//   s   = allow ? s : -1e30             mode 0: all, 1: row >= col, 2: none
//   m'  = max(m, rowmax s)
//   p   = exp(s - m')
//   l'  = l * exp(m - m') + sum p
//   o'  = o * exp(m - m') + p . v
// The fold is computed online over K tiles; the result equals the one-shot
// fold up to float summation order.
//
// Bound on an H100 (SXM, 700 W): 4*BH*Sq*Sk*D flops against
// 4*BH*(3*Sq*D + 2*Sk*D + 4*Sq) bytes. At BH=32, S=1024, D=128 that is
// about 17 GFLOP against about 34 MB, so fp32 on the CUDA cores
// (67 TFLOP/s) bounds it: ~0.26 ms, against ~0.01 ms for the bytes at
// 3.35 TB/s. At the flagship's own shape (BH=16, S=64, D=16) the launch
// itself dominates.
//
// Design, simple and exact first:
// - One thread block per (bh, 64-row q tile): 8 warps, 8 q rows each. A
//   loop over 32-row K/V tiles inside the block takes the place of the TPU
//   grid's sequential K axis.
// - The q tile and each K/V tile are staged in shared memory; every K/V
//   tile is read from device memory once per q tile and reused by 64 rows.
// - Lane j of a warp owns column j of the K tile: it computes that
//   column's score for the warp's 8 rows (the K row stride is padded to
//   D+1 so the 32 lanes hit 32 banks). Row max and row sum are warp
//   shuffles. The running o (lane owns d = lane + 32*i), m and l stay in
//   registers for the whole loop; scores and p never reach device memory.
// - fp32 FMAs and expf, no TF32 and no tensor cores: the wgmma redesign
//   that would lower the bound is later work.
// - Ragged edges: K columns at or past Sk are skipped (p = 0, kept out of
//   the max), never set to -1e30, so mode 2 on fresh accumulators gives
//   l == Sk exactly as the plain fold does. Q rows at or past Sq are not
//   written.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;   // q rows per block
constexpr int kBK = 32;                      // K/V rows per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D);
}

__global__ void __launch_bounds__(kWarps * 32)
flash_fold_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o_in,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, float* __restrict__ o_out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int Sq, int Sk, int D, int mode, int n_qtiles) {
  extern __shared__ float smem[];
  const int kstride = D + 1;
  float* qs = smem;                      // kBQ x D
  float* ks = qs + kBQ * D;              // kBK x (D + 1)
  float* vs = ks + kBK * kstride;        // kBK x D

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRowsPerWarp;   // warp's first row in the tile

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    qs[i] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }

  float o[kRowsPerWarp][kDPerLane];
  float mrow[kRowsPerWarp];
  float lrow[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + r0 + rr;
    const bool live = row < Sq;
    const size_t g = (size_t)bh * Sq + row;
    mrow[rr] = live ? m_in[g] : kNeg;
    lrow[rr] = live ? l_in[g] : 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) {
      const int d = lane + 32 * i;
      o[rr][i] = (live && d < D) ? o_in[g * D + d] : 0.f;
    }
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const bool in = k0 + j < Sk;
      ks[j * kstride + d] = in ? kb[(size_t)(k0 + j) * D + d] : 0.f;
      vs[j * D + d] = in ? vb[(size_t)(k0 + j) * D + d] : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;
    const bool valid = col < Sk;
    const int ncols = min(kBK, Sk - k0);

    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = ks + lane * kstride;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        s[rr] = fmaf(qs[(r0 + rr) * D + d], kv, s[rr]);
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = q0 + r0 + rr;
      if (row >= Sq) {          // the same for the whole warp
        s[rr] = 0.f;
        continue;
      }
      const bool allow = (mode == 0) || (mode == 1 && row >= col);
      const float sv = allow ? s[rr] : kNeg;
      float mx = valid ? sv : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(mrow[rr], mx);
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(mrow[rr] - m_new);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      lrow[rr] = lrow[rr] * corr + psum;
      mrow[rr] = m_new;
      s[rr] = p;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) o[rr][i] *= corr;
    }

    for (int j = 0; j < ncols; ++j) {
      float vv[kDPerLane];
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFull, s[rr], j);
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) o[rr][i] = fmaf(pj, vv[i], o[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + r0 + rr;
    if (row >= Sq) continue;
    const size_t g = (size_t)bh * Sq + row;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o_out[g * D + d] = o[rr][i];
    }
    if (lane == 0) {
      m_out[g] = mrow[rr];
      l_out[g] = lrow[rr];
    }
  }
}

}  // namespace

// C entry, bound with ctypes. All tensors fp32, contiguous, on the current
// device: q, o (BH, Sq, D); k, v (BH, Sk, D); m, l (BH, Sq). Launches on
// `stream` (a cudaStream_t) without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_fold_f32(const float* q, const float* k, const float* v,
                              const float* o_in, const float* m_in,
                              const float* l_in, float* o_out, float* m_out,
                              float* l_out, int BH, int Sq, int Sk, int D,
                              int mode, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {   // above the default limit: opt in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  flash_fold_kernel<<<dim3((unsigned)(BH * n_qtiles)), kWarps * 32, smem,
                      (cudaStream_t)stream>>>(q, k, v, o_in, m_in, l_in,
                                              o_out, m_out, l_out, Sq, Sk, D,
                                              mode, n_qtiles);
  return (int)cudaGetLastError();
}
