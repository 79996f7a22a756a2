// Batched BLAKE3 on Hopper (sm_90a): the cas_id and chunk-id hash.
//
// Replaces spacedrive_tpu/ops/blake3_pallas.py::_compress_kernel (:84), the
// Pallas compression that ops/blake3_jax.py::_blake3_batch_impl calls
// 16 + ceil(log2 C) times per batch, each call a round trip of every lane's
// state through memory. Here the whole batched hash is two launches:
//
//   blake3_chunk_cvs  one thread per REAL chunk: lanes are numbered over the
//                     batch's chunks, message after message, through an
//                     exclusive prefix of the per-message chunk counts that
//                     every block builds in shared memory from the lengths
//                     (no host sync: each block reads the total there). A
//                     warp's 32 lanes are 32 real chunks whatever the message
//                     sizes; only each message's final chunk is short. A lane
//                     walks its chunk's <= 16 blocks with the 16 state words
//                     and the block's 16 message words in registers, counter =
//                     its chunk index in the message, CHUNK_START/CHUNK_END
//                     from its length and, on the final block of a one-chunk
//                     message, ROOT (the JAX _single_chunk_root); it writes 8
//                     CV words. Slots past a message's chunk count get zeros
//                     from 16-byte stores, one warp a message, no compression.
//   blake3_merge      one block per group of messages, one group an SM (at
//                     most 32 messages, and the group's CVs within 64 KiB of
//                     shared memory). At each level the pairs of all the
//                     group's messages form one list, indexed by a block-local
//                     prefix of their pair counts; thread t takes items t,
//                     t + blockDim, ... in rounds: read both children into
//                     registers, barrier, write the parent at slot p of its
//                     message (in place), barrier. The odd tail is promoted,
//                     the pair taken when two nodes remain gets PARENT|ROOT
//                     (blake3_jax.py:218-243), a one-chunk message passes its
//                     CV through; levels run to the depth of the group's
//                     deepest message. Writes the 8 digest words into the
//                     (8, B) output.
//
// Both read the blake3_batch_rows layout: (B, C*256) u32 words, one message
// per row, zero-padded past its length.
//
// Windows of a longer message (the validator's full-file hash, the mesh's
// seq shards). Given per-row 64-bit chunk offsets `base` and message byte
// lengths `total`, row b of the chunk kernel holds chunks base[b], base[b]+1,
// ... of its message: chunk c's counter is base + c (low and high word), its
// length clamp(total - (base + c) * 1024, 0, 1024), it is valid while base + c
// is under the message's chunk count, and it takes ROOT only when the whole
// message is one chunk. Given a per-row `root` flag, the merge leaves ROOT off
// the rows where it is 0 and writes their subtree's chaining value. Null
// arrays keep the whole-message behaviour above, bit for bit.
//
// What bounds it on the H100: integer issue, not memory. A 64-byte block costs
// ~800 u32 operations (7 rounds x 8 G x 14, plus the output feed-forward),
// 12.5 per byte; at 132 SMs x 64 INT32 lanes x ~1.98 GHz that sustains about
// 1.3 TB/s of message, below the 3.35 TB/s the HBM delivers. So the design
// spends nothing but ALU work per block: state and message stay in registers
// for all 16 blocks of a chunk (no memory traffic between compressions), the
// rounds are fully unrolled with the message permutation applied by register
// renaming, and each rotate is one funnel shift (__funnelshift_r). The
// compiler issues fewer instructions than the 800 operations, since a + b + m
// is one three-input add; chip_smoke.py counts them in the built SASS.
//
// A warp issues a compression's instructions whatever number of its lanes
// work, so what the chunk kernel spends is warps x 16 blocks. Numbering lanes
// by real chunk packs the chunk-id batch (CDC chunks of ~8 KiB in 64-chunk
// rows) into ~1/6 of the warps a (message x C + chunk) numbering occupies.
// The grid is one block of 512 threads per SM, and warps take 32-lane units
// dealt round-robin across the blocks first, so every SM holds the same
// number of units, give or take one. With as few as two warps a scheduler, a
// load's trip to HBM is exposed, so loads ask the L2 for whole 128-byte lines
// (a lane's next block comes with this one). The merge's cost is its levels:
// one compression's issue and dependent chain each, plus two barriers. One
// block an SM keeps a level's warps on distinct schedulers; two blocks an SM
// put both blocks' first warps on one scheduler at every level.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;
constexpr int kChunkLen = 1024;
constexpr int kBlockLen = 64;
constexpr int kWordsPerChunk = kChunkLen / 4;

#define IV0 0x6A09E667u
#define IV1 0xBB67AE85u
#define IV2 0x3C6EF372u
#define IV3 0xA54FF53Au
#define IV4 0x510E527Fu
#define IV5 0x9B05688Cu
#define IV6 0x1F83D9ABu
#define IV7 0x5BE0CD19u

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define G(a, b, c, d, mx, my)      \
  a = a + b + (mx);                \
  d = rotr(d ^ a, 16);             \
  c = c + d;                       \
  b = rotr(b ^ c, 12);             \
  a = a + b + (my);                \
  d = rotr(d ^ a, 8);              \
  c = c + d;                       \
  b = rotr(b ^ c, 7);

__device__ __forceinline__ void round_fn(uint32_t v[16], const uint32_t m[16]) {
  G(v[0], v[4], v[8], v[12], m[0], m[1]);
  G(v[1], v[5], v[9], v[13], m[2], m[3]);
  G(v[2], v[6], v[10], v[14], m[4], m[5]);
  G(v[3], v[7], v[11], v[15], m[6], m[7]);
  G(v[0], v[5], v[10], v[15], m[8], m[9]);
  G(v[1], v[6], v[11], v[12], m[10], m[11]);
  G(v[2], v[7], v[8], v[13], m[12], m[13]);
  G(v[3], v[4], v[9], v[14], m[14], m[15]);
}

// MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);
// with constant indices this is register renaming, no data movement
__device__ __forceinline__ void permute(uint32_t m[16]) {
  uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0], m[4], m[13],
                    m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = t[i];
}

// One compression; cv is replaced by the 8 output words.
__device__ __forceinline__ void compress(uint32_t cv[8], uint32_t m[16],
                                         uint32_t counter, uint32_t block_len,
                                         uint32_t flags, uint32_t counter_hi = 0u) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    IV0,   IV1,   IV2,   IV3,   counter, counter_hi, block_len, flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    round_fn(v, m);
    if (r < 6) permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

__device__ __forceinline__ int clamped_len(const int32_t* lengths, int b, int C) {
  return min(max(lengths[b], 0), C * kChunkLen);
}

__device__ __forceinline__ int n_chunks_of(int len) {
  return max(1, (len + kChunkLen - 1) / kChunkLen);
}

// Chunks of row b: its whole message's, or, for a window, those of the
// message from chunk base on (0 past its end), at most C.
__device__ __forceinline__ int row_chunks(const int32_t* lengths, const long long* base,
                                          const long long* msg_len, int b, int C) {
  if (base == nullptr) return n_chunks_of(clamped_len(lengths, b, C));
  const long long t = max(msg_len[b], 0LL);
  const long long n = max(1LL, (t + kChunkLen - 1) / kChunkLen) - max(base[b], 0LL);
  return (int)min(max(n, 0LL), (long long)C);
}

constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Largest i in [0, n) with first[i] <= x, for a non-decreasing first[] with
// first[0] <= x < first[n]: the message (or group member) that item x
// belongs to.
__device__ __forceinline__ int owner_of(const int* first, int n, int x) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

constexpr int kChunkThreads = 512;
// messages one chunk-kernel launch takes: its prefix of chunk counts is
// (B + 1) ints of shared memory, built from runs of kRun messages a thread;
// the launcher slices larger batches
constexpr int kRun = 16;
constexpr int kChunkMaxBatch = kChunkThreads * kRun;

// A 16-byte load of message words that asks the L2 to fetch the whole
// 128-byte line on a miss: a lane's next block shares the line, so a chunk
// costs 8 trips to HBM, not 16 (the chunk kernel's lanes have few warps a
// scheduler to hide each trip behind).
__device__ __forceinline__ uint4 load_line_hint(const uint4* p) {
  uint4 w;
  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
      : "l"(p));
  return w;
}

// 48 registers, as many as the compression loop took before lanes were
// numbered by real chunk; ptxas reports no spills at this cap
__global__ void __maxnreg__(48)
chunk_cvs_kernel(const uint32_t* __restrict__ rows,
                 const int32_t* __restrict__ lengths,
                 const long long* __restrict__ base,
                 const long long* __restrict__ msg_len,
                 uint32_t* __restrict__ cvs, int B, int C) {
  extern __shared__ int first[];  // B + 1: exclusive prefix of chunk counts
  __shared__ int warp_sums[kChunkThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kChunkThreads / 32;

  // the prefix: each thread reads the counts of a run of <= kRun messages
  // (all its loads in flight at once), the run sums are scanned across the
  // block, and each thread writes its run's exclusive starts
  const int per = (B + kChunkThreads - 1) / kChunkThreads;
  const int lo = min(B, tid * per), hi = min(B, lo + per);
  int count[kRun];
  int run = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    count[k] = lo + k < hi ? row_chunks(lengths, base, msg_len, lo + k, C) : 0;
    run += count[k];
  }
  const int incl = warp_inclusive_scan(run, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    const int w_incl = warp_inclusive_scan(w, lane);
    if (lane < kWarps) warp_sums[lane] = w_incl;
  }
  __syncthreads();
  int start = (warp ? warp_sums[warp - 1] : 0) + incl - run;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (lo + k < hi) first[lo + k] = start;
    start += count[k];
  }
  if (tid == kChunkThreads - 1) first[B] = warp_sums[kWarps - 1];
  __syncthreads();
  const int total = first[B];

  // warps numbered across blocks first, so units spread evenly over SMs
  const int n_warps = gridDim.x * kWarps;
  const int gwarp = warp * gridDim.x + blockIdx.x;

  // zeros past each message's chunk count: one warp a message, 16-byte stores
  uint4* out4 = reinterpret_cast<uint4*>(cvs);
  for (int b = gwarp; b < B; b += n_warps) {
    const int n = first[b + 1] - first[b];
    uint4* dst = out4 + ((size_t)b * C + n) * 2;
    for (int k = lane; k < (C - n) * 2; k += 32) dst[k] = make_uint4(0u, 0u, 0u, 0u);
  }

  for (int unit = gwarp; unit * 32 < total; unit += n_warps) {
    const int i = unit * 32 + lane;
    if (i >= total) break;
    const int b = owner_of(first, B, i);
    const int c = i - first[b];
    int chunk_len;
    bool root;
    uint32_t counter, counter_hi;
    if (base == nullptr) {  // uniform across the launch
      chunk_len = min(clamped_len(lengths, b, C) - c * kChunkLen, kChunkLen);
      root = first[b + 1] - first[b] == 1;
      counter = (uint32_t)c;
      counter_hi = 0u;
    } else {
      const long long g = max(base[b], 0LL) + c;
      const long long t = max(msg_len[b], 0LL);
      chunk_len = (int)min(t - g * kChunkLen, (long long)kChunkLen);
      root = t <= kChunkLen;
      counter = (uint32_t)g;
      counter_hi = (uint32_t)((unsigned long long)g >> 32);
    }
    const int n_blocks = max(1, (chunk_len + kBlockLen - 1) / kBlockLen);
    const uint4* src = reinterpret_cast<const uint4*>(
        rows + ((size_t)b * C + c) * kWordsPerChunk);
    uint32_t cv[8] = {IV0, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
    for (int j = 0; j < n_blocks; ++j) {
      uint32_t m[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 w = load_line_hint(src + j * 4 + q);
        m[4 * q] = w.x;
        m[4 * q + 1] = w.y;
        m[4 * q + 2] = w.z;
        m[4 * q + 3] = w.w;
      }
      const uint32_t block_len = (uint32_t)min(max(chunk_len - j * kBlockLen, 0), kBlockLen);
      uint32_t flags = j == 0 ? kChunkStart : 0u;
      if (j == n_blocks - 1) flags |= kChunkEnd | (root ? kRoot : 0u);
      compress(cv, m, counter, block_len, flags, counter_hi);
    }
    uint4* dst = out4 + ((size_t)b * C + c) * 2;
    dst[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
    dst[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
  }
}

constexpr int kMergeThreads = 256;
constexpr int kMergeMaxGroup = 32;
// shared memory a merge group's CVs may take (the group shrinks to fit;
// one message of more than 2048 chunks takes its own C x 32 bytes)
constexpr int kMergeGroupBytes = 64 * 1024;

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const uint32_t* __restrict__ cvs,
             const int32_t* __restrict__ lengths,
             const uint8_t* __restrict__ root,
             uint32_t* __restrict__ digests, int B, int C, int group) {
  extern __shared__ uint4 nodes4[];  // group x C x 8 words, in place
  __shared__ int first[kMergeMaxGroup + 1];  // exclusive prefix of items
  __shared__ int rem[kMergeMaxGroup];        // nodes left per message
  __shared__ uint32_t root_flag[kMergeMaxGroup];  // ROOT, or 0 for a window
  __shared__ int levels;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b0 = blockIdx.x * group;
  const int g_n = min(group, B - b0);
  const uint32_t* nodes = reinterpret_cast<const uint32_t*>(nodes4);
  uint32_t* nodes_w = reinterpret_cast<uint32_t*>(nodes4);

  // warp 0: chunk counts, their prefix (the load's items), the group's depth
  if (tid < 32) {
    const int n = lane < g_n ? n_chunks_of(clamped_len(lengths, b0 + lane, C)) : 0;
    const int incl = warp_inclusive_scan(n, lane);
    if (lane == 0) first[0] = 0;
    if (lane < g_n) {
      first[lane + 1] = incl;
      rem[lane] = n;
      root_flag[lane] = root == nullptr || root[b0 + lane] ? kRoot : 0u;
    }
    int depth = n > 1 ? 32 - __clz(n - 1) : 0;  // ceil(log2 n)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) depth = max(depth, __shfl_xor_sync(kFullMask, depth, o));
    if (lane == 0) levels = depth;
  }
  __syncthreads();

  // the group's real chunk CVs into shared memory, two 16-byte words each,
  // all of a thread's copies in flight at once
  const uint4* src4 = reinterpret_cast<const uint4*>(cvs) + (size_t)b0 * C * 2;
  for (int i = tid; i < first[g_n] * 2; i += kMergeThreads) {
    const int node = i >> 1;
    const int g = owner_of(first, g_n, node);
    const int slot = (g * C + node - first[g]) * 2 + (i & 1);
    __pipeline_memcpy_async(&nodes4[slot], &src4[slot], sizeof(uint4));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int level = 0; level < levels; ++level) {
    if (tid < 32) {  // this level's items per message: its pairs and odd tail
      int r = lane < g_n ? rem[lane] : 0;
      if (level > 0 && lane < g_n) rem[lane] = r = (r + 1) / 2;  // left after the last level
      const int items = r > 1 ? (r + 1) / 2 : 0;
      const int incl = warp_inclusive_scan(items, lane);
      if (lane < g_n) first[lane + 1] = incl;
    }
    __syncthreads();
    const int n_items = first[g_n];
    for (int base = 0; base < n_items; base += kMergeThreads) {  // uniform
      const int i = base + tid;
      int g = 0, p = 0;
      uint32_t out[8];
      if (i < n_items) {
        g = owner_of(first, g_n, i);
        p = i - first[g];
        const int r = rem[g];
        const uint32_t* left = nodes + ((size_t)g * C + 2 * p) * 8;
        if (2 * p + 1 < r) {
          uint32_t m[16];
#pragma unroll
          for (int w = 0; w < 16; ++w) m[w] = left[w];  // left || right
          uint32_t cv[8] = {IV0, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
          compress(cv, m, 0u, (uint32_t)kBlockLen, kParent | (r == 2 ? root_flag[g] : 0u));
#pragma unroll
          for (int w = 0; w < 8; ++w) out[w] = cv[w];
        } else {
#pragma unroll
          for (int w = 0; w < 8; ++w) out[w] = left[w];  // the odd tail, promoted
        }
      }
      __syncthreads();  // every child read before any parent lands
      if (i < n_items) {
        uint32_t* dst = nodes_w + ((size_t)g * C + p) * 8;
#pragma unroll
        for (int w = 0; w < 8; ++w) dst[w] = out[w];
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < g_n * 8; t += kMergeThreads) {
    const int w = t / g_n, g = t % g_n;
    digests[(size_t)w * B + b0 + g] = nodes[(size_t)g * C * 8 + w];
  }
}


}  // namespace

// C launchers (bound with ctypes). Each returns cudaGetLastError() after its
// launch so a refused launch raises in the Python wrapper.

extern "C" int blake3_chunk_cvs(const void* rows, const void* lengths, const void* base,
                                const void* total, void* cvs, int B, int C, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || C <= 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < B; s += kChunkMaxBatch) {
    const int Bs = std::min(kChunkMaxBatch, B - s);
    const long long lanes = (long long)Bs * C;  // the most real chunks there can be
    const int blocks =
        (int)std::min<long long>(sms, (lanes + kChunkThreads - 1) / kChunkThreads);
    const size_t smem = (size_t)(Bs + 1) * sizeof(int);
    chunk_cvs_kernel<<<blocks, kChunkThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows + (size_t)s * C * kWordsPerChunk, (const int32_t*)lengths + s,
        base == nullptr ? nullptr : (const long long*)base + s,
        total == nullptr ? nullptr : (const long long*)total + s,
        (uint32_t*)cvs + (size_t)s * C * 8, Bs, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int blake3_merge(const void* cvs, const void* lengths, const void* root,
                            void* digests, int B, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || C <= 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // one group an SM, as long as the group's CVs fit the shared-memory budget
  const size_t per_message = (size_t)C * 8 * sizeof(uint32_t);
  const int fit = (int)(kMergeGroupBytes / per_message);
  const int group = std::max(1, std::min({(B + sms - 1) / sms, kMergeMaxGroup, fit}));
  const size_t smem = group * per_message;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + group - 1) / group;
  merge_kernel<<<blocks, kMergeThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)cvs, (const int32_t*)lengths, (const uint8_t*)root,
      (uint32_t*)digests, B, C, group);
  return (int)cudaGetLastError();
}
