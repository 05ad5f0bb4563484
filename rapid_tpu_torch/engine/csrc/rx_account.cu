// Packed delivery accounting of the per-receiver engine, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rapid_tpu/engine/rx_pallas.py:_account_kernel
// (launched by pl.pallas_call in rx_pallas.account). For one message set,
// over little-endian bit-planes packed along the receiver axis:
//
//   ok  = pm & src & pd      (src: 0xFF per live sender row, pd: live-receiver bits)
//   dv  = ok & ~pe           (pe: link-blocked plane)
//   cnt[r] = {popcount(pm[r]), popcount(dv[r]), popcount(ok[r] & pe[r]), 0}
//
// pm, pe, dv are uint8 [rows, cb] with cb = ceil(C/8); src uint8 [rows];
// pd uint8 [cb]; cnt int32 [rows, 4] (column 3 is padding). Pad bits of
// every operand are zero, so the counts equal the dense counts.
//
// Bound: bytes. A launch reads pm and pe and writes dv (3 * rows * cb bytes)
// plus src, pd and cnt (about 17 * rows bytes); the bit algebra and popcounts
// are a few integer operations per byte. At C = 1024 that is about 0.41 MB,
// 0.12 us at 3.35 TB/s, so the launch latency dominates; at C = 4096 about
// 6.4 MB, 1.9 us.
//
// Design, simple on purpose: one warp per row, eight rows per block. Lanes
// stride over the row in 32-bit words when cb is a multiple of 4 and the
// pointers are 4-byte aligned (C % 32 == 0, the main path's widths), else in
// bytes, since a row then starts at an unaligned address. Bits are counted
// with __popc and each row's three sums are reduced inside its warp with
// __shfl_down_sync; a row never spans warps, so no shared memory is needed.
// The kernel allocates nothing; the caller passes the outputs and the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void rx_account_kernel(const uint8_t* __restrict__ pm,
                                  const uint8_t* __restrict__ pe,
                                  const uint8_t* __restrict__ src,
                                  const uint8_t* __restrict__ pd,
                                  uint8_t* __restrict__ dv,
                                  int32_t* __restrict__ cnt,
                                  int rows, int cb, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: one row per warp
  const size_t base = static_cast<size_t>(row) * cb;
  int n_pm = 0, n_dv = 0, n_ld = 0;
  if (vec) {
    const uint32_t s = static_cast<uint32_t>(src[row]) * 0x01010101u;
    const uint32_t* pm4 = reinterpret_cast<const uint32_t*>(pm + base);
    const uint32_t* pe4 = reinterpret_cast<const uint32_t*>(pe + base);
    const uint32_t* pd4 = reinterpret_cast<const uint32_t*>(pd);
    uint32_t* dv4 = reinterpret_cast<uint32_t*>(dv + base);
    const int nw = cb >> 2;
    for (int w = lane; w < nw; w += 32) {
      const uint32_t m = pm4[w];
      const uint32_t ok = m & s & pd4[w];
      const uint32_t e = pe4[w];
      const uint32_t d = ok & ~e;
      dv4[w] = d;
      n_pm += __popc(m);
      n_dv += __popc(d);
      n_ld += __popc(ok & e);
    }
  } else {
    const uint32_t s = src[row];
    for (int b = lane; b < cb; b += 32) {
      const uint32_t m = pm[base + b];
      const uint32_t ok = m & s & pd[b];
      const uint32_t e = pe[base + b];
      const uint32_t d = ok & ~e;
      dv[base + b] = static_cast<uint8_t>(d);
      n_pm += __popc(m);
      n_dv += __popc(d);
      n_ld += __popc(ok & e);
    }
  }
  n_pm = warp_sum(n_pm);
  n_dv = warp_sum(n_dv);
  n_ld = warp_sum(n_ld);
  if (lane == 0) {
    int32_t* out = cnt + static_cast<size_t>(row) * 4;
    out[0] = n_pm;
    out[1] = n_dv;
    out[2] = n_ld;
    out[3] = 0;
  }
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = success).
extern "C" int rx_account_launch(const void* pm, const void* pe,
                                 const void* src, const void* pd, void* dv,
                                 void* cnt, int rows, int cb, void* stream) {
  if (rows <= 0 || cb <= 0) return static_cast<int>(cudaSuccess);
  const int vec = (cb % 4 == 0) && aligned4(pm) && aligned4(pe) &&
                  aligned4(pd) && aligned4(dv);
  const dim3 block(32 * kRowsPerBlock);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  rx_account_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(pe),
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(pd),
      static_cast<uint8_t*>(dv), static_cast<int32_t*>(cnt), rows, cb, vec);
  return static_cast<int>(cudaGetLastError());
}
