// The search index's predicate scorers on Hopper (sm_90a).
//
// Replaces the three Pallas kernels of spacedrive_tpu/search/kernels.py:
//   search_substring  <- kernel of _substring_pallas_jit (:233): SQLite
//                        LIKE '%needle%' over ASCII-folded names, i.e. per
//                        row the OR over offsets j in [0, W-L] of the AND
//                        over k < L of row[j+k] == needle[k];
//   search_exact      <- kernel of _exact_pallas_jit (:274): SQL = under
//                        BINARY collation, equality of the zero-padded W-byte
//                        value with the zero-padded needle;
//   search_lex        <- kernel of _lex_pallas_jit (:308): the memcmp verdict
//                        of the zero-padded value against a zero-padded bound,
//                        written as int8 -1 / 0 / 1 (the Pallas kernel writes
//                        codes 0 = eq, 1 = gt, 2 = lt, which lex_cmp_jnp maps).
//
// Layout. The TPU kernels read plane-major (W, rows/128, 128) tiles, one byte
// of every row per plane, because its vector unit works on 128-lane rows.
// Here a thread scores a row, so the index keeps each column row-major,
// (CAP, W) u8: a thread loads its row with 16-, 8- or 4-byte loads (as W
// allows: names (64) and paths (96) take 16, dates (40) 8, extensions (12)
// 4), and a warp's loads cover 32 consecutive rows, so every byte of the
// sectors it touches is used. The needle or bound rides in a by-value kernel
// argument (the counterpart of the SMEM operand); each launch carries its own
// copy, so launches from several threads never share it. One u8 flag per row
// is written.
//
// What bounds them on the H100: bytes. At 3.35 TB/s and CAP = 1,003,520
// rows, reading every row whole takes 0.0195 ms for names (W = 64), 0.0291
// ms for paths (96), 0.0039 ms for extensions (12) and 0.0123 ms for dates
// (40), and the functions need less than that.
//
// substring: a filter on the needle's first gram, then a verify of the few
// rows it leaves. The thread forms its row's 4-byte window at every offset
// with one funnel shift over two adjacent words and sets bit j of a 64-bit
// candidate mask where the window equals G, the needle's first min(L, 4)
// bytes (masked below 4), for j <= W-L only: about four integer
// instructions an offset, whatever L is. For L <= 4 that mask is the
// answer. Otherwise a row with candidates is staged in shared memory and
// the needle's other bytes are compared there a word at a time: by the
// row's own lane where it has at most four candidate offsets, else by its
// whole warp, a lane per offset. So a warp pays for the rows that share the
// needle's first gram, about one verify each, not for its longest partial
// match. The kernel's first form built a mask per needle byte with the
// emulated __vcmpeq4 (about 160 instructions a byte a row) and ran each
// warp as long as its longest-lived lane: 0.0781 ms at L = 17 against a
// 0.0147 ms bound; this one takes 0.0264 ms (H100 80GB HBM3, 700 W;
// chip_smoke.py), within 1.4x of reading every row once at every needle
// length of the search benchmark.

// exact: a key column beside the rows. The index keeps a 32-bit key of each
// zero-padded row (search/kernels.py row_keys, computed on the host), and
// the needle's key rides beside it. A thread reads four rows' keys (16 B)
// and reads a row's W bytes only where its key equals the needle's, so a
// collision costs time, never a wrong answer. The kernel's first form read
// at least the first 16 bytes of every row, a sector a row on paths: 0.0239
// ms against a 0.0015 ms bound, where this one takes 0.0045 ms (H100 80GB
// HBM3, 700 W; chip_smoke.py).
//
// lex: an order-preserving prefix column beside the rows. The index keeps
// the first 8 bytes of each zero-padded row read big-endian (search/kernels.py
// date_prefix_of, computed on the host), so an unsigned compare of two
// prefixes is memcmp of those bytes; the bound's prefix rides beside it. A
// thread reads four rows' prefixes (two 16-byte loads), compares each as
// uint64 (a row may start with a byte >= 0x80: a signed compare would flip
// it), reads a row's bytes 8..W-1 only where its prefix ties with the
// bound's, 8 bytes at a time up to the first word that differs, and writes
// the four int8 verdicts in one 32-bit store. The kernel's first form read
// every row from its first byte, a sector a row on dates (at least 40 MB):
// 0.0119-0.0143 ms L2-warm, 0.0194 ms with the L2 cleared, against a
// 0.0024 ms bound. At the search benchmark's bound this one reads the 8 MB
// prefix column and the 1/12 of rows that tie on a month: 0.0031 ms
// L2-warm, 0.0095 ms cleared; at a bound no row ties, 0.0026 / 0.0059 ms,
// so a tied row's read, which waits on its prefix's, costs the rest (H100
// 80GB HBM3, 700 W; chip_smoke.py).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNeedle = 48;
constexpr int kMaxWidth = 96;

// The needle or bound, zero-padded: bytes as the row stores them.
struct Needle {
  union {
    uint8_t b[kMaxWidth];
    uint32_t w[kMaxWidth / 4];
  };
  int len;
};

// Bytes per load for a row of W bytes starting at a multiple of W.
template <int W>
__host__ __device__ constexpr int vec_bytes() {
  return W % 16 == 0 ? 16 : (W % 8 == 0 ? 8 : 4);
}

// Words [i, i + vec_bytes<W>()/4) of row r into w[i..].
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ rows, long long r,
                                           int i, uint32_t* w) {
  const uint8_t* p = rows + r * W + 4 * i;
  if constexpr (vec_bytes<W>() == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
  } else if constexpr (vec_bytes<W>() == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[i] = v.x; w[i + 1] = v.y;
  } else {
    w[i] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

// Offsets a lane verifies alone; a row with more candidate offsets (a row
// of one repeated byte, say) is verified by its whole warp, a lane per offset.
constexpr int kLaneOffsets = 4;
// Words a staged row takes in shared memory: its 16, then one that a window
// at the row's last bytes reads past the end (masked); an odd stride keeps a
// warp's word accesses on distinct banks.
constexpr int kStagedWords = 17;

// True where the needle's bytes 4..len-1 equal the staged row's bytes
// j+4..j+len-1, compared a word at a time (a funnel shift forms the row's
// window at any byte offset; the needle's last word is masked to its length).
__device__ __forceinline__ bool verify_at(const uint32_t* __restrict__ row,
                                          const uint32_t* __restrict__ needle, int len, int j) {
  for (int k = 4; k < len; k += 4) {
    const int p = j + k;
    const uint32_t win = __funnelshift_r(row[p >> 2], row[(p >> 2) + 1], 8 * (p & 3));
    const uint32_t mask = len - k >= 4 ? 0xFFFFFFFFu : (1u << (8 * (len - k))) - 1u;
    if ((win ^ needle[k >> 2]) & mask) return false;
  }
  return true;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
substring_kernel(const uint8_t* __restrict__ rows, int n, Needle nd,
                 uint8_t* __restrict__ out) {
  static_assert(W % 16 == 0 && W <= 64 && W / 4 < kStagedWords,
                "the offset mask is 64 bits, a lane two offsets");
  constexpr int kWords = W / 4;
  __shared__ uint32_t s_needle[kMaxNeedle / 4];
  __shared__ uint32_t s_rows[kThreads][kStagedWords];
  if (threadIdx.x == 0) {
    // constant indices: a runtime index would copy the argument to local memory
#pragma unroll
    for (int i = 0; i < kMaxNeedle / 4; ++i) s_needle[i] = nd.w[i];
  }
  __syncthreads();

  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int len = nd.len;
  const int g = len < 4 ? len : 4;
  const uint32_t gmask = g == 4 ? 0xFFFFFFFFu : (1u << (8 * g)) - 1u;
  const uint32_t gram = nd.w[0] & gmask;
  const int last = W - len;  // the last offset a match may start at
  const uint64_t in_bound = last >= 63 ? ~0ull : (1ull << (last + 1)) - 1ull;

  uint32_t w[kWords + 1];
  uint64_t cand = 0;
  if (r < n) {
#pragma unroll
    for (int i = 0; i < kWords; i += 4) load_words<W>(rows, r, i, w);
    w[kWords] = 0;  // windows past the row's end see zeros (masked by in_bound)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint32_t win = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
      if (((win ^ gram) & gmask) == 0) cand |= 1ull << j;
    }
    cand &= in_bound;
  }

  uint8_t hit = cand != 0;
  if (len > 4) {  // uniform over the launch
    hit = 0;
    uint32_t* mine = s_rows[threadIdx.x];
    if (cand) {
#pragma unroll
      for (int i = 0; i <= kWords; ++i) mine[i] = w[i];
    }
    __syncwarp();
    const int offsets = __popcll(cand);
    for (uint64_t c = offsets <= kLaneOffsets ? cand : 0; c && !hit; c &= c - 1)
      hit = verify_at(mine, s_needle, len, __ffsll(c) - 1);
    // rows with many candidate offsets: the warp takes them one at a time
    const int lane = threadIdx.x & 31;
    uint32_t many = __ballot_sync(0xFFFFFFFFu, offsets > kLaneOffsets);
    while (many) {
      const int src = __ffs(many) - 1;
      many &= many - 1;
      const uint32_t lo = __shfl_sync(0xFFFFFFFFu, (uint32_t)cand, src);
      const uint32_t hi = __shfl_sync(0xFFFFFFFFu, (uint32_t)(cand >> 32), src);
      const uint32_t* row = s_rows[threadIdx.x - lane + src];
      const bool ok = (lo >> lane & 1u && verify_at(row, s_needle, len, lane)) ||
                      (hi >> lane & 1u && verify_at(row, s_needle, len, lane + 32));
      const bool any = __any_sync(0xFFFFFFFFu, ok);
      if (lane == src) hit = any;
    }
  }
  if (r < n) out[r] = hit;
}

// True where row r's W bytes equal the zero-padded needle.
template <int W>
__device__ __forceinline__ bool row_equals(const uint8_t* __restrict__ rows, long long r,
                                           const Needle& nd) {
  constexpr int step = vec_bytes<W>() / 4;
  uint32_t w[W / 4];
#pragma unroll
  for (int i = 0; i < W / 4; i += step) {
    load_words<W>(rows, r, i, w);
    uint32_t diff = 0;
#pragma unroll
    for (int j = i; j < i + step; ++j) diff |= w[j] ^ nd.w[j];
    if (diff) return false;
  }
  return true;
}

// rows a thread in the keyed kernels: one 16-byte load of int32 keys (exact),
// two of int64 prefixes (lex), one 32-bit store of their four results
constexpr int kKeyedRows = 4;

template <int W>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ keys, int n,
             Needle nd, int key, uint8_t* __restrict__ out) {
  const long long r0 = kKeyedRows * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (r0 >= n) return;
  if (r0 + kKeyedRows <= n) {
    const int4 k = __ldg(reinterpret_cast<const int4*>(keys + r0));
    const int ks[kKeyedRows] = {k.x, k.y, k.z, k.w};
    uint32_t flags = 0;
#pragma unroll
    for (int i = 0; i < kKeyedRows; ++i)
      if (ks[i] == key && row_equals<W>(rows, r0 + i, nd)) flags |= 1u << (8 * i);
    *reinterpret_cast<uint32_t*>(out + r0) = flags;
  } else {
    for (long long r = r0; r < n; ++r)
      out[r] = __ldg(keys + r) == key && row_equals<W>(rows, r, nd);
  }
}

constexpr int kPrefixWords = 2;  // the prefix column holds a row's words 0 and 1
using u64 = unsigned long long;  // the prefixes' type, as __ldg and ulonglong2 take it

// memcmp verdict (-1, 0, 1) of row r against the bound, from its prefix p and,
// where p ties with the bound's, its words kPrefixWords.. up to the first
// that differs
template <int W>
__device__ __forceinline__ int lex_verdict(const uint8_t* __restrict__ rows, long long r,
                                           u64 p, u64 bound_prefix,
                                           const Needle& nd) {
  static_assert(vec_bytes<W>() == 8 && W > 8, "rows past the prefix load 8 bytes at a time");
  if (p != bound_prefix) return p > bound_prefix ? 1 : -1;
  uint32_t w[W / 4];
#pragma unroll
  for (int i = kPrefixWords; i < W / 4; i += 2) {
    load_words<W>(rows, r, i, w);
#pragma unroll
    for (int j = i; j < i + 2; ++j) {
      if (w[j] != nd.w[j]) {
        // bytes in memory order are little-endian in the word: swap them so
        // an unsigned compare is memcmp over the four bytes
        return __byte_perm(w[j], 0, 0x0123) > __byte_perm(nd.w[j], 0, 0x0123) ? 1 : -1;
      }
    }
  }
  return 0;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
lex_kernel(const uint8_t* __restrict__ rows, const u64* __restrict__ prefix, int n,
           Needle nd, u64 bound_prefix, int8_t* __restrict__ out) {
  const long long r0 = kKeyedRows * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (r0 >= n) return;
  if (r0 + kKeyedRows <= n) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(prefix + r0));
    const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(prefix + r0 + 2));
    const u64 ps[kKeyedRows] = {a.x, a.y, b.x, b.y};
    uint32_t verdicts = 0;
#pragma unroll
    for (int i = 0; i < kKeyedRows; ++i)
      verdicts |= (uint32_t)(uint8_t)lex_verdict<W>(rows, r0 + i, ps[i], bound_prefix, nd)
                  << (8 * i);
    *reinterpret_cast<uint32_t*>(out + r0) = verdicts;
  } else {
    for (long long r = r0; r < n; ++r)
      out[r] = (int8_t)lex_verdict<W>(rows, r, __ldg(prefix + r), bound_prefix, nd);
  }
}

int launch_substring(void (*kernel)(const uint8_t*, int, Needle, uint8_t*), const void* rows,
                     int n, const Needle& nd, void* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)rows, n, nd,
                                                        (uint8_t*)out);
  return (int)cudaGetLastError();
}

// A keyed kernel over n rows: kKeyedRows rows a thread.
template <typename Col, typename Key, typename Out>
int launch_keyed(void (*kernel)(const uint8_t*, const Col*, int, Needle, Key, Out*),
                 const void* rows, const void* col, int n, const Needle& nd, Key key, void* out,
                 void* stream) {
  if (n <= 0) return 0;
  const long long threads = (n + kKeyedRows - 1) / kKeyedRows;
  const unsigned int blocks = (unsigned int)((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)rows, (const Col*)col,
                                                        n, nd, key, (Out*)out);
  return (int)cudaGetLastError();
}

bool make_needle(const void* bytes, int len, int max_len, Needle* nd) {
  if (len < 0 || len > max_len) return false;
  memset(nd, 0, sizeof(*nd));
  if (len) memcpy(nd->b, bytes, (size_t)len);
  nd->len = len;
  return true;
}

}  // namespace

// C launchers (bound with ctypes). rows: (n, W) u8, row-major, 16-byte
// aligned, W one of the index's columns (substring: names, 64; exact: paths,
// 96, and extensions, 12; lex: dates, 40); needle: host bytes; out: (n,) u8
// (lex: int8), 4-byte aligned. exact also takes keys: (n,) int32, 16-byte
// aligned, the row_keys of the rows, and key, the row_keys of the zero-padded
// needle; lex takes prefix: (n,) int64 holding u64 bits, 16-byte aligned, the
// date_prefix_of the rows, and bound_prefix, that of the zero-padded bound.
// Each returns cudaGetLastError() after its launch, or cudaErrorInvalidValue
// for a width or needle length the kernels do not take.

extern "C" int search_substring(const void* rows, int W, int n, const void* needle,
                                int len, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Needle nd;
  if (len < 1 || !make_needle(needle, len, kMaxNeedle < W ? kMaxNeedle : W, &nd))
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 64: {
      // 17.4 KB of staged rows a block: ask for the shared-memory carveout
      // that keeps eight blocks (2,048 threads) on an SM
      static const cudaError_t carveout = cudaFuncSetAttribute(
          substring_kernel<64>, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
      if (carveout != cudaSuccess) return (int)carveout;
      return launch_substring(substring_kernel<64>, rows, n, nd, out, stream);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int search_exact(const void* rows, const void* keys, int W, int n,
                            const void* needle, int len, int key, void* out, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Needle nd;
  if (!make_needle(needle, len, W < kMaxWidth ? W : kMaxWidth, &nd))
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 12: return launch_keyed(exact_kernel<12>, rows, keys, n, nd, key, out, stream);
    case 96: return launch_keyed(exact_kernel<96>, rows, keys, n, nd, key, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int search_lex(const void* rows, const void* prefix, int W, int n,
                          const void* bound, int len, unsigned long long bound_prefix,
                          void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Needle nd;
  if (!make_needle(bound, len, W < kMaxWidth ? W : kMaxWidth, &nd))
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 40: return launch_keyed(lex_kernel<40>, rows, prefix, n, nd, bound_prefix, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
