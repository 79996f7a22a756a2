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
//                        written as the Pallas kernel writes it (0 = eq,
//                        1 = gt, 2 = lt).
//
// Layout. The TPU kernels read plane-major (W, rows/128, 128) tiles, one byte
// of every row per plane, because its vector unit works on 128-lane rows.
// Here one thread scores one row, so the index keeps each column row-major,
// (CAP, W) u8: a thread loads its row with 16-, 8- or 4-byte loads (as W
// allows: names (64) and paths (96) take 16, dates (40) 8, extensions (12)
// 4), and a warp's loads
// cover 32 consecutive rows, so every byte of the sectors it touches is used.
// The needle or bound rides in a by-value kernel argument (the counterpart of
// the SMEM operand); each launch carries its own copy, so launches from
// several threads never share it. One u8 flag per row is written.
//
// substring compares all offsets at once: for needle byte k, __vcmpeq4 over
// the row's words gives a W-bit mask of the positions equal to that byte;
// the candidate offsets are the AND of those masks shifted down by k, with an
// early exit once no candidate is left.
// An offset j > W-L would need byte j+k >= W for some k, and those bits are
// never set, so no explicit offset bound is needed. exact and lex walk the
// row one vector load at a time and stop at the first one that differs, so
// a row that differs early is not read to its end.
//
// What bounds them on the H100: bytes. The function reads at most W bytes
// of a row and writes one: at 3.35 TB/s and CAP = 1,003,520 rows, 0.0195 ms
// for names (W = 64), 0.0291 ms for paths (96), 0.0039 ms for extensions
// (12) and 0.0123 ms for dates (40); exact and lex need far less, since the
// first byte that differs decides. The kernels do not reach that. substring
// spends ~10 instructions per word per needle byte it tries (16 words at
// W = 64), so a needle whose leading bytes are common in names keeps
// candidates alive for several bytes and the kernel becomes issue-bound
// (0.0775 ms at L = 17 against 0.0267 ms at L = 3, on an H100 80GB HBM3 at
// 700 W; chip_smoke.py). exact and lex read at least one sector per row.

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

// Bit p set where row byte p equals c (p < W <= 64).
template <int W>
__device__ __forceinline__ uint64_t eq_mask(const uint32_t (&w)[W / 4], uint32_t c) {
  const uint32_t rep = c * 0x01010101u;
  uint64_t m = 0;
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    // 0x80 in each equal byte; the multiply gathers bits 7, 15, 23, 31 into
    // bits 28..31 (the four partial products land on distinct bits)
    const uint32_t e = __vcmpeq4(w[i], rep) & 0x80808080u;
    m |= (uint64_t)((e * 0x00204081u) >> 28) << (4 * i);
  }
  return m;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
substring_kernel(const uint8_t* __restrict__ rows, int n, Needle nd,
                 uint8_t* __restrict__ out) {
  static_assert(W <= 64, "the offset mask is 64 bits");
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  uint32_t w[W / 4];
#pragma unroll
  for (int i = 0; i < W / 4; i += vec_bytes<W>() / 4) load_words<W>(rows, r, i, w);
  uint64_t cand = eq_mask<W>(w, nd.b[0]);
  // unrolled, so each needle byte is a constant-bank operand (a runtime
  // index would copy the argument to local memory)
#pragma unroll
  for (int k = 1; k < kMaxNeedle; ++k) {
    if (k >= nd.len || !cand) break;
    cand &= eq_mask<W>(w, nd.b[k]) >> k;
  }
  out[r] = cand != 0;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const uint8_t* __restrict__ rows, int n, Needle nd,
             uint8_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  constexpr int step = vec_bytes<W>() / 4;
  uint32_t w[W / 4];
  uint8_t eq = 1;
#pragma unroll
  for (int i = 0; i < W / 4; i += step) {
    load_words<W>(rows, r, i, w);
    uint32_t diff = 0;
#pragma unroll
    for (int j = i; j < i + step; ++j) diff |= w[j] ^ nd.w[j];
    if (diff) {
      eq = 0;
      break;
    }
  }
  out[r] = eq;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
lex_kernel(const uint8_t* __restrict__ rows, int n, Needle nd,
           uint8_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  constexpr int step = vec_bytes<W>() / 4;
  uint32_t w[W / 4];
  uint8_t verdict = 0;
#pragma unroll
  for (int i = 0; i < W / 4; i += step) {
    load_words<W>(rows, r, i, w);
#pragma unroll
    for (int j = i; j < i + step; ++j) {
      if (w[j] != nd.w[j]) {
        // bytes in memory order are little-endian in the word: swap them so
        // an unsigned compare is memcmp over the four bytes
        const uint32_t a = __byte_perm(w[j], 0, 0x0123);
        const uint32_t b = __byte_perm(nd.w[j], 0, 0x0123);
        verdict = a > b ? 1 : 2;
        break;
      }
    }
    if (verdict) break;
  }
  out[r] = verdict;
}

template <typename Kernel>
int launch(Kernel kernel, const void* rows, int n, const Needle& nd, void* out,
           void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)rows, n, nd,
                                                        (uint8_t*)out);
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
// 96, and extensions, 12; lex: dates, 40); needle: host bytes; out: (n,) u8.
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
    case 64: return launch(substring_kernel<64>, rows, n, nd, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int search_exact(const void* rows, int W, int n, const void* needle, int len,
                            void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Needle nd;
  if (!make_needle(needle, len, W < kMaxWidth ? W : kMaxWidth, &nd))
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 12: return launch(exact_kernel<12>, rows, n, nd, out, stream);
    case 96: return launch(exact_kernel<96>, rows, n, nd, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int search_lex(const void* rows, int W, int n, const void* bound, int len,
                          void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Needle nd;
  if (!make_needle(bound, len, W < kMaxWidth ? W : kMaxWidth, &nd))
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 40: return launch(lex_kernel<40>, rows, n, nd, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
