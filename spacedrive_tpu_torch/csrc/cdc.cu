// Gear content-defined-chunking candidates on Hopper (sm_90a).
//
// Replaces spacedrive_tpu/ops/cdc.py::_cdc_kernel (:236), the Pallas kernel
// behind _candidates_pallas. For every byte position i of every file in a
// (B, L) u8 plane it computes the Gear rolling hash
//
//     h_i = sum_{k=0..31} GEAR[b_{i-k}] << k  =  (h_{i-1} << 1) + GEAR[b_i]   (mod 2^32)
//
// and writes the candidate byte (h_i & mask) == 0, masked to the file's
// length (byte i means a cut at i+1) — the same bytes as
// ops/cdc.py::_candidates_numpy. Positions before the file start contribute
// 0, not GEAR[0]: on the TPU that came from padding the gear-mapped plane
// with zeros (cdc.py:256). The TPU version left the 256-way table lookup to
// an XLA gather over the whole plane and read a u32 plane four times the
// size of the bytes; here the kernel reads the bytes and looks them up itself.
//
// What bounds it on the H100: bytes. The function must read the files' real
// bytes (sum of lengths) and write the whole (B, L) output; the recurrence
// costs ~5 u32 operations a position, a fraction of the card's INT32 issue
// rate. Half the rows of the scan's dominant plane, (32, 512 KiB) holding 16
// files, are batch padding of length 0. The design:
//
// - The recurrence by segments, no warm-up. A warp takes a unit of 512
//   positions of one row; lane l owns the 16 positions at p0 + 16 l, read as
//   one 16-byte vector (a warp reads 512 contiguous bytes). Each lane looks
//   its 16 bytes up once, keeps them in registers, and folds them into the
//   16-term sum E_l = sum_i GEAR[b_i] << (15 - i). Because a shift by 32
//   expires a byte, the hash just before its segment is
//   E_{l-1} + (E_{l-2} << 16), which two warp shuffles deliver; lanes 0 and
//   1 take E_{-1}, E_{-2} from the unit's 32-byte left halo (one byte per
//   lane, summed by shuffles), 0 at the row's start. Then the lane runs
//   h = (h << 1) + g over its 16 positions: one table lookup a position,
//   where a 31-byte warm-up per segment would cost two.
// - Flags packed four to a word and written as one 16-byte store a lane, so
//   a warp writes 512 contiguous bytes.
// - No work past the length: a unit at or past lengths[b] (all of a padding
//   row) is a 16-byte zero store a lane and reads nothing; inside the unit
//   that holds the length, lanes that start past it read nothing and the
//   flags at or past it are cut to 0. The output comes from torch.empty, so
//   every byte of every row is written.
// - A persistent grid (SMs x resident blocks) walks the units in a
//   grid-stride loop; the 1 KiB table is filled once per resident block.
// - One shared table. A warp's 32 random lookups collide in its banks, but
//   the shared-memory time that costs hides under the memory time; 32 copies
//   (entry b of copy c at table[b * 32 + c], lane l reading copy l, always
//   bank l) cost 32 KiB of shared stores per block to fill and ran slower at
//   every plane tier measured (PERF.md).
// - Bytes are not staged in shared memory: each byte is used by one lane
//   only and the carry between lanes travels by shuffle, so a staged tile
//   would add a round trip through shared memory and save no read. Loads of
//   the next unit issued before hashing this one (a register ring, 256
//   threads a block for its 48 registers) won on planes of 4 KiB and less,
//   tied at 256 KiB and lost at 128 KiB, 512 KiB and 4 MiB, where most of
//   the scan's launches are.
//
// Rows whose length L is not a multiple of 16, or planes not 16-byte
// aligned, take the same kernel with byte loads and stores.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W
// (profiler device time; every run in PERF.md), with the L2 cleared before
// each call and, in brackets, with the plane and output left in L2 by the
// call before: (32, 512 KiB) with 16 files 0.0110 ms, 62% of its 0.0068 ms
// bytes bound [0.0086 ms]; (32, 256 KiB) with 32 files 0.0088 ms, 49% of
// 0.0043 ms [0.0074]; (8, 4 MiB) with 2 files 0.0161 ms, 75% of 0.0121 ms
// [0.0131]. The windowed-sum kernel this replaces took 0.0867, 0.0453 and
// 0.1711 ms there (L2-warm). A plane of a few KiB takes ~0.003 ms: the
// launch and one chain of dependent loads, which is most of what the
// 256 KiB plane misses.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSeg = 16;              // positions per lane: one 16-byte vector
constexpr int kUnit = kLanes * kSeg;  // positions per warp unit
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kLanes;
constexpr unsigned kFull = 0xffffffffu;

// the 16 bytes of a row at [p, p + 16), 0 past L
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int p, int L) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row + p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kSeg; ++i)
    if (p + i < L) w[i / 4] |= (uint32_t)row[p + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* row, int p, int L, uint4 v) {
  if (kVec) {
    *reinterpret_cast<uint4*>(row + p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < kSeg; ++i)
    if (p + i < L) row[p + i] = (uint8_t)(w[i / 4] >> (8 * (i % 4)));
}

// kVec: L % 16 == 0 and both planes 16-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gear_candidates_kernel(const uint8_t* __restrict__ plane,
                       const int32_t* __restrict__ lengths,
                       const uint32_t* __restrict__ gear, uint32_t mask,
                       uint8_t* __restrict__ out, int L, unsigned units_per_row,
                       unsigned n_units) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = __ldg(gear + i);
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (unsigned u = blockIdx.x * kWarps + threadIdx.x / kLanes; u < n_units;
       u += gridDim.x * kWarps) {
    const unsigned b = u / units_per_row;
    const int p0 = (int)(u - b * units_per_row) * kUnit;  // warp-uniform
    const int p = p0 + lane * kSeg;
    uint8_t* dst = out + (size_t)b * L;
    const int len = min(max(__ldg(lengths + b), 0), L);
    if (p0 >= len) {  // past the file: zeros, nothing read
      if (p < L) store16<kVec>(dst, p, L, zero);
      continue;
    }
    const uint8_t* row = plane + (size_t)b * L;
    const uint4 v = p < len ? load16<kVec>(row, p, L) : zero;

    // the unit's left halo: lanes 0-15 sum E_{-2}, lanes 16-31 E_{-1}
    uint32_t halo = 0u;
    if (p0 > 0) halo = table[row[p0 - 32 + lane]] << (15 - lane % 16);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) halo += __shfl_xor_sync(kFull, halo, o);

    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t g[kSeg];
    uint32_t e = 0u;  // E_lane = sum_i g_i << (15 - i)
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      g[i] = table[(w[i / 4] >> (8 * (i % 4))) & 0xffu];
      e = (e << 1) + g[i];
    }
    uint32_t e1 = __shfl_up_sync(kFull, e, 1);
    uint32_t e2 = __shfl_up_sync(kFull, e, 2);
    const uint32_t halo1 = __shfl_sync(kFull, halo, 16);
    const uint32_t halo2 = __shfl_sync(kFull, halo, 0);
    if (lane == 0) {
      e1 = halo1;
      e2 = halo2;
    } else if (lane == 1) {
      e2 = halo1;
    }
    uint32_t h = e1 + (e2 << 16);  // the hash at p - 1
    uint32_t f[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      h = (h << 1) + g[i];
      f[i / 4] |= ((h & mask) == 0u ? 1u : 0u) << (8 * (i % 4));
    }
    // the length cut: flags at or past len are 0
    const int valid = len - p;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = valid - 4 * k;
      if (n < 4) f[k] = n <= 0 ? 0u : f[k] & ((1u << (8 * n)) - 1u);
    }
    if (p < L) store16<kVec>(dst, p, L, make_uint4(f[0], f[1], f[2], f[3]));
  }
}

template <bool kVec>
cudaError_t launch(const uint8_t* plane, const int32_t* lengths, const uint32_t* gear,
                   uint32_t mask, uint8_t* out, int B, int L, int device,
                   cudaStream_t stream) {
  static int resident[64];  // blocks the card holds at once, by device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gear_candidates_kernel<kVec>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[device] = std::max(1, sms * per_sm);
  }
  // a plane that fits on the card has fewer than 2^31 units of 512 bytes
  const unsigned units_per_row = (unsigned)((L + kUnit - 1) / kUnit);
  const unsigned units = (unsigned)B * units_per_row;
  const unsigned grid = std::min<unsigned>((units + kWarps - 1) / kWarps, resident[device]);
  gear_candidates_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      plane, lengths, gear, mask, out, L, units_per_row, units);
  return cudaGetLastError();
}

}  // namespace

// C launcher (bound with ctypes); returns cudaGetLastError() after the launch.
extern "C" int gear_candidates(const void* plane, const void* lengths,
                               const void* gear, uint32_t mask, void* out,
                               int B, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || L <= 0) return 0;
  const bool vec = L % 16 == 0 && (reinterpret_cast<uintptr_t>(plane) |
                                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const auto fn = vec ? launch<true> : launch<false>;
  return (int)fn((const uint8_t*)plane, (const int32_t*)lengths, (const uint32_t*)gear,
                 mask, (uint8_t*)out, B, L, device, (cudaStream_t)stream);
}
