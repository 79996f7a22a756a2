// Batched BLAKE3 on Hopper (sm_90a): the cas_id and chunk-id hash.
//
// Replaces spacedrive_tpu/ops/blake3_pallas.py::_compress_kernel (:84), the
// Pallas compression that ops/blake3_jax.py::_blake3_batch_impl calls
// 16 + ceil(log2 C) times per batch, each call a round trip of every lane's
// state through memory. Here the whole batched hash is two launches:
//
//   blake3_chunk_cvs  one thread per (message, chunk) lane walks the chunk's
//                     <= 16 blocks with its 16 state words and the block's 16
//                     message words in registers, sets CHUNK_START/CHUNK_END
//                     from the lane's length, and on the final block of a
//                     one-chunk message also ROOT (the JAX _single_chunk_root),
//                     then writes 8 CV words. Lanes past the message's chunk
//                     count write zeros and read nothing.
//   blake3_merge      one block per message: the chunk CVs go to shared
//                     memory and adjacent nodes pair level by level
//                     (__syncthreads between levels, odd tail promoted), the
//                     pair taken when two nodes remain with PARENT|ROOT, as
//                     blake3_jax.py:218-243; writes the 8 digest words into
//                     the (8, B) output.
//
// Both read the blake3_batch_rows layout: (B, C*256) u32 words, one message
// per row, zero-padded past its length. The counter's high word stays 0.
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

#include <cstdint>
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
                                         uint32_t flags) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    IV0,   IV1,   IV2,   IV3,   counter, 0u, block_len, flags};
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

__global__ void __launch_bounds__(128)
chunk_cvs_kernel(const uint32_t* __restrict__ rows,
                 const int32_t* __restrict__ lengths,
                 uint32_t* __restrict__ cvs, int B, int C) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)B * C) return;
  const int b = (int)(lane / C);
  const int c = (int)(lane % C);
  const int len = clamped_len(lengths, b, C);
  const int n_chunks = n_chunks_of(len);
  uint4* out = reinterpret_cast<uint4*>(cvs + lane * 8);
  if (c >= n_chunks) {
    out[0] = make_uint4(0u, 0u, 0u, 0u);
    out[1] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int chunk_len = min(len - c * kChunkLen, kChunkLen);
  const int n_blocks = max(1, (chunk_len + kBlockLen - 1) / kBlockLen);
  const uint4* src = reinterpret_cast<const uint4*>(
      rows + ((size_t)b * C + c) * kWordsPerChunk);
  uint32_t cv[8] = {IV0, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
  for (int j = 0; j < n_blocks; ++j) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 w = __ldg(src + j * 4 + q);
      m[4 * q] = w.x;
      m[4 * q + 1] = w.y;
      m[4 * q + 2] = w.z;
      m[4 * q + 3] = w.w;
    }
    const uint32_t block_len = (uint32_t)min(max(chunk_len - j * kBlockLen, 0), kBlockLen);
    uint32_t flags = j == 0 ? kChunkStart : 0u;
    if (j == n_blocks - 1) flags |= kChunkEnd | (n_chunks == 1 ? kRoot : 0u);
    compress(cv, m, (uint32_t)c, block_len, flags);
  }
  out[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
  out[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

constexpr int kMergeThreads = 64;

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const uint32_t* __restrict__ cvs,
             const int32_t* __restrict__ lengths,
             uint32_t* __restrict__ digests, int B, int C) {
  extern __shared__ uint32_t nodes[];  // two levels of C x 8 words
  const int b = blockIdx.x;
  const int n = n_chunks_of(clamped_len(lengths, b, C));
  const uint32_t* src = cvs + (size_t)b * C * 8;
  uint32_t* cur = nodes;
  uint32_t* nxt = nodes + (size_t)C * 8;
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) cur[i] = src[i];
  __syncthreads();
  // `remaining` is the same in every thread, so the loop and its barriers
  // are uniform across the block
  for (int remaining = n; remaining > 1; remaining = (remaining + 1) / 2) {
    const int pairs = (remaining + 1) / 2;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      uint32_t* dst = nxt + p * 8;
      const uint32_t* left = cur + 2 * p * 8;
      if (2 * p + 1 < remaining) {
        uint32_t m[16];
#pragma unroll
        for (int w = 0; w < 16; ++w) m[w] = left[w];  // left || right
        uint32_t cv[8] = {IV0, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
        compress(cv, m, 0u, (uint32_t)kBlockLen,
                 kParent | (remaining == 2 ? kRoot : 0u));
#pragma unroll
        for (int w = 0; w < 8; ++w) dst[w] = cv[w];
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) dst[w] = left[w];
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (threadIdx.x < 8) digests[(size_t)threadIdx.x * B + b] = cur[threadIdx.x];
}

}  // namespace

// C launchers (bound with ctypes). Each returns cudaGetLastError() after its
// launch so a refused launch raises in the Python wrapper.

extern "C" int blake3_chunk_cvs(const void* rows, const void* lengths, void* cvs,
                                int B, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || C <= 0) return 0;
  const long long lanes = (long long)B * C;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
  chunk_cvs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)lengths, (uint32_t*)cvs, B, C);
  return (int)cudaGetLastError();
}

extern "C" int blake3_merge(const void* cvs, const void* lengths, void* digests,
                            int B, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || C <= 0) return 0;
  const size_t smem = (size_t)2 * C * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<B, kMergeThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)cvs, (const int32_t*)lengths, (uint32_t*)digests, B, C);
  return (int)cudaGetLastError();
}
