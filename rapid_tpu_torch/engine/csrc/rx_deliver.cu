// Fused delivery of the per-receiver engine, for Hopper (sm_90a).
//
// Replaces rapid_tpu/engine/rx_pallas.py:_account_kernel (and the
// packbits/unpackbits/sums of rx_pallas.account around it): the whole of
// rx_pallas.account in one launch, for a batch of message planes of every
// member of a fleet (the reference vmaps it over its members). Over dense
// bool planes msgs[f, p, s, d] (f < members, p < planes, s and d < C):
//
//   ok    = msgs & ~crashed[f, s] & ~crashed[f, d]
//   deliv = ok & ~pe[f, s, d]         (pe: the packed link-blocked plane)
//   acc[f, 0]     += sum popc(deliv)                   delivered
//   acc[f, 1]     += sum popc(msgs) - sum popc(deliv)  dropped
//   acc[f, 2]     += sum popc(ok & pe)                 link_dropped
//   acc[f, phase] += sum popc(deliv)                   (when phase >= 0)
//
// msgs and deliv are bool (one byte each) [members, planes, C, C]; crashed
// bool [members, C]; pe uint8 [members, C, ceil(C/8)], little-endian along
// d with zero pad bits (monitor.link_blocked_packed); acc int32 [members,
// acc_stride], added into in place; all contiguous. These are the dense
// receiver._account precedences: a crashed sender first, then a crashed
// receiver or a link block. One member is members = 1.
//
// Bound: bytes. A launch reads members*(planes*C*C + C*ceil(C/8) + C) bytes
// and writes members*(planes*C*C + 16); the bit algebra is a few integer
// operations per byte. One plane at C = 1024 moves about 2.23 MB (0.665 us
// at 3.35 TB/s), under one launch; at C = 4096 about 35.7 MB (10.64 us).
//
// Design: one streaming pass, no reuse and no matrix product, so no TMA
// and no wgmma: coalesced 16-byte loads already reach the memory rate and
// TMA would add nothing. In a grid-stride loop over a grid that fills
// every SM, a thread loads 16 dense bytes (16 receivers of one row) as one
// uint4 and forms their 16 bits; it forms the same 16 receivers' live bits
// from 16 bytes of crashed (a second uint4 load, which L1 serves after the
// first row), reads the matching 2 bytes of pe and the sender's crashed
// byte, computes deliv and the three __popc counts, widens deliv back to 16
// bools and stores them as one uint4. All loads of a step are independent,
// so a step costs one memory latency: the live bits are not staged in
// shared memory, which would put a round trip and a barrier before the
// first message load (at C = 1024 each thread makes one step). This needs
// C % 16 == 0 and 16-byte-aligned planes (the main path's widths);
// otherwise a byte-wise path takes one packed byte (8 receivers) per step.
// A member is blockIdx.y: a block's grid-stride loop stays inside its
// member's rows, so its counts never mix members. Counts are reduced by
// warp shuffles, then through shared memory, and each block adds its sums
// into its member's row with one atomicAdd per counter: integer adds are
// exact in any order, so the counts equal the reference bit for bit.
// The kernel allocates nothing; the caller passes the outputs and stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;             // 2048 threads: a full SM
constexpr long long kMaxItems = 1LL << 30;  // int indices cannot overflow

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Bits of four bool bytes (a nonzero byte is true), byte j to bit j.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u) & 0x08040201u;
  return (t * 0x01010101u) >> 24;  // the four bytes of t summed, no carry
}

// Bits of sixteen bool bytes, byte j to bit j.
__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return nibble(v.x) | (nibble(v.y) << 4) | (nibble(v.z) << 8) |
         (nibble(v.w) << 12);
}

// Four bits back to four bool bytes, bit j to byte j.
__device__ __forceinline__ uint32_t widen(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rx_deliver_kernel(const uint8_t* __restrict__ msgs,
                  const uint8_t* __restrict__ crashed,
                  const uint8_t* __restrict__ pe,
                  uint8_t* __restrict__ deliv, int32_t* __restrict__ acc,
                  int planes, int c, int acc_stride, int phase, int vec) {
  __shared__ int red[3][kWarps];
  const int cb = (c + 7) >> 3;
  const size_t f = blockIdx.y;
  const size_t plane_bytes = static_cast<size_t>(planes) * c * c;
  msgs += f * plane_bytes;
  deliv += f * plane_bytes;
  crashed += f * c;
  pe += f * c * cb;
  acc += f * acc_stride;
  const int rows = planes * c;
  const int stride = gridDim.x * kThreads;
  int n_m = 0, n_dv = 0, n_ld = 0;
  if (vec) {
    const int cpr = c >> 4;  // 16-receiver chunks per row
    const int items = rows * cpr;
    const uint4* m16 = reinterpret_cast<const uint4*>(msgs);
    const uint4* c16 = reinterpret_cast<const uint4*>(crashed);
    uint4* d16 = reinterpret_cast<uint4*>(deliv);
    const uint16_t* pe16 = reinterpret_cast<const uint16_t*>(pe);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
         i += stride) {
      const int r = i / cpr;
      const int j = i - r * cpr;
      const int s = r % c;
      const uint32_t m = bits16(m16[i]);
      const uint32_t live = ~bits16(c16[j]);
      const uint32_t src = crashed[s] ? 0u : 0xFFFFu;
      const uint32_t ok = m & src & live;
      const uint32_t e = pe16[static_cast<size_t>(s) * (cb >> 1) + j];
      const uint32_t d = ok & ~e;
      n_m += __popc(m);
      n_dv += __popc(d);
      n_ld += __popc(ok & e);
      d16[i] = make_uint4(widen(d & 0xF), widen((d >> 4) & 0xF),
                          widen((d >> 8) & 0xF), widen(d >> 12));
    }
  } else {
    const int items = rows * cb;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
         i += stride) {
      const int r = i / cb;
      const int b = i - r * cb;
      const int s = r % c;
      const int lo = b << 3;
      const int nk = min(8, c - lo);
      const size_t at = static_cast<size_t>(r) * c + lo;
      uint32_t m = 0, live = 0;
      for (int k = 0; k < nk; ++k) {
        m |= (msgs[at + k] != 0) << k;
        live |= (crashed[lo + k] == 0) << k;
      }
      const uint32_t src = crashed[s] ? 0u : 0xFFu;
      const uint32_t ok = m & src & live;
      const uint32_t e = pe[static_cast<size_t>(s) * cb + b];
      const uint32_t d = ok & ~e;
      n_m += __popc(m);
      n_dv += __popc(d);
      n_ld += __popc(ok & e);
      for (int k = 0; k < nk; ++k) deliv[at + k] = (d >> k) & 1u;
    }
  }

  n_m = warp_sum(n_m);
  n_dv = warp_sum(n_dv);
  n_ld = warp_sum(n_ld);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = n_m;
    red[1][warp] = n_dv;
    red[2][warp] = n_ld;
  }
  __syncthreads();
  if (warp == 0) {
    n_m = lane < kWarps ? red[0][lane] : 0;
    n_dv = lane < kWarps ? red[1][lane] : 0;
    n_ld = lane < kWarps ? red[2][lane] : 0;
    n_m = warp_sum(n_m);
    n_dv = warp_sum(n_dv);
    n_ld = warp_sum(n_ld);
    if (lane == 0) {
      atomicAdd(acc + 0, n_dv);
      atomicAdd(acc + 1, n_m - n_dv);
      atomicAdd(acc + 2, n_ld);
      if (phase >= 0) atomicAdd(acc + phase, n_dv);
    }
  }
}

inline bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// success); cudaErrorInvalidValue for more than 2**30 work items a member
// or more than 65535 members. The grid (x: blocks of one member, y: the
// members) is capped at the blocks that fit on the card at once, computed
// on the first call (the process drives one model of card).
extern "C" int rx_deliver_launch(const void* msgs, const void* crashed,
                                 const void* pe, void* deliv, void* acc,
                                 int members, int planes, int c,
                                 int acc_stride, int phase, void* stream) {
  if (members <= 0 || planes <= 0 || c <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (members > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int cb = (c + 7) / 8;
  const long long rows = static_cast<long long>(planes) * c;
  const int vec = (c % 16 == 0) && aligned(msgs, 16) && aligned(deliv, 16) &&
                  aligned(crashed, 16) && aligned(pe, 2);
  const long long items = rows * (vec ? c / 16 : cb);
  if (items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  static int grid_cap = 0;
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rx_deliver_kernel, kThreads, 0);
    grid_cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = (grid_cap + members - 1) / members;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>(members));
  rx_deliver_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(msgs), static_cast<const uint8_t*>(crashed),
      static_cast<const uint8_t*>(pe), static_cast<uint8_t*>(deliv),
      static_cast<int32_t*>(acc), planes, c, acc_stride, phase, vec);
  return static_cast<int>(cudaGetLastError());
}
