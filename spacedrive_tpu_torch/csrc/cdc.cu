// Gear content-defined-chunking candidates on Hopper (sm_90a).
//
// Replaces spacedrive_tpu/ops/cdc.py::_cdc_kernel (:236), the Pallas kernel
// behind _candidates_pallas. It computes, for every byte position i of every
// file in a (B, L) u8 plane, the Gear rolling hash as a windowed sum
//
//     h_i = sum_{k=0..31} GEAR[b_{i-k}] << k   (mod 2^32)
//
// and writes the candidate bit (h_i & mask) == 0, masked to the file's length
// (bit i means a cut at i+1) — the same bits as ops/cdc.py::_candidates_numpy.
// Positions before the file start contribute 0, not GEAR[0]: on the TPU that
// came from padding the gear-mapped plane with zeros (cdc.py:256).
//
// The TPU version left the 256-way table lookup outside the kernel, as an XLA
// gather over the whole plane (cdc.py:316-317), and read a u32 gear plane four
// times the size of the bytes. Here each block stages its tile of bytes plus a
// 31-byte left halo, mapped through the GEAR table, in shared memory, with the
// table itself in shared memory: the kernel reads each input byte from device
// memory about once and writes one byte per position.
//
// What bounds it on the H100: the function is bound by memory. Run as the
// recurrence h = (h << 1) + GEAR[b] by segments with a 31-byte warm-up, a
// position costs ~5 u32 operations (shift, add, lookup, mask test, length
// test) for 2 bytes of traffic; HBM at 3.35 TB/s allows ~1.7e12 positions/s
// and the ALUs (132 SMs x 64 INT32 lanes x ~1.98 GHz) over 3e12. This simple
// kernel does not reach that: its windowed sum spends ~67 operations per
// position, which caps it near 0.25e12 positions/s, about a seventh of the
// memory bound, so it is issue-bound by its own formulation. The 32 terms
// come from shared memory at consecutive addresses across a warp (no bank
// conflicts). The next pass is the sliding-window form: each thread runs the
// recurrence over a segment of consecutive positions after a 31-byte warm-up.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;   // output positions per block
constexpr int kThreads = 256;
constexpr int kWindow = 32;

__global__ void __launch_bounds__(kThreads)
gear_candidates_kernel(const uint8_t* __restrict__ plane,
                       const int32_t* __restrict__ lengths,
                       const uint32_t* __restrict__ gear, uint32_t mask,
                       uint8_t* __restrict__ out, int L) {
  __shared__ uint32_t table[256];
  // g[s] holds GEAR[byte] of position t0 - kWindow + s (0 outside the row)
  __shared__ uint32_t g[kTile + kWindow];
  const int b = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTile;
  const uint8_t* row = plane + (size_t)b * L;
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = gear[i];
  __syncthreads();
  for (int s = threadIdx.x; s < kTile + kWindow; s += kThreads) {
    const long long p = t0 - kWindow + s;
    g[s] = (p >= 0 && p < L) ? table[row[p]] : 0u;
  }
  __syncthreads();
  const long long len = lengths[b];
  uint8_t* dst = out + (size_t)b * L;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long p = t0 + i;
    if (p >= L) break;
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) h += g[kWindow + i - k] << k;
    dst[p] = (p < len && (h & mask) == 0u) ? 1 : 0;
  }
}

}  // namespace

// C launcher (bound with ctypes); returns cudaGetLastError() after the launch.
extern "C" int gear_candidates(const void* plane, const void* lengths,
                               const void* gear, uint32_t mask, void* out,
                               int B, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || L <= 0) return 0;
  const dim3 grid((unsigned int)((L + kTile - 1) / kTile), (unsigned int)B);
  gear_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, (const int32_t*)lengths, (const uint32_t*)gear,
      mask, (uint8_t*)out, L);
  return (int)cudaGetLastError();
}
