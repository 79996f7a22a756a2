// The cas gather of the port: each file's sampled cas message read straight
// into a row of a byte matrix, with the interpreter lock released for the
// whole batch (the caller binds it with ctypes.CDLL).
//
// A copy of the gather half of spacedrive_tpu/native/blake3_cas.cc (the
// sampling constants and msg_len_for :746-762, for_each_parallel :805, Uring
// :838, uring_disabled :969, gather_depth :982, ring_entries_for :996,
// uring_gather_ring :1008, uring_gather :1145, the non-Linux stubs
// :1161-1175 and sd_cas_gather_batch :1253). The SIMD BLAKE3 and the CPU
// hashers are left out: the port hashes on the card. Two changes:
// sd_cas_gather_batch returns which path served the batch, and SD_NO_URING
// is read on every call, as SD_CAS_GATHER_DEPTH is.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#if defined(__linux__)
#include <linux/io_uring.h>
#include <sys/syscall.h>
#endif

namespace {

// ---- cas sampling (reference consts cas.rs:10-15) ----
constexpr uint64_t SAMPLE_COUNT = 4;
constexpr uint64_t SAMPLE_SIZE = 1024 * 10;
constexpr uint64_t HEADER_OR_FOOTER = 1024 * 8;
constexpr uint64_t MINIMUM_FILE_SIZE = 1024 * 100;

// cas message length for a file of `size` bytes: 8-byte size prefix, then
// either the whole file (small) or header + 4 samples + footer (sampled).
// The single source of truth for every gather/hash path below.
constexpr uint64_t msg_len_for(uint64_t size) {
  return 8 + (size <= MINIMUM_FILE_SIZE
                  ? size
                  : 2 * HEADER_OR_FOOTER + SAMPLE_COUNT * SAMPLE_SIZE);
}


// Run fn(i) for i in [0, n) across up to n_threads workers (atomic work
// stealing); the single-threaded path spawns nothing.
template <typename F>
void for_each_parallel(int32_t n, int32_t n_threads, F fn) {
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min(n_threads, n);
  if (n_threads <= 1 || n <= 1) {
    for (int32_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---- io_uring batched sample gather -------------------------------------
//
// The sampling pattern costs 9 syscalls per file (open, 6 preads, close)
// — on this host ~2/3 of the whole identify budget once hashing is SIMD.
// io_uring batches a whole group of files into a handful of
// submit-and-wait calls: one round of OPENATs, rounds of READs (with
// short-read resubmission), one round of CLOSEs. Falls back to the
// synchronous path when the kernel or a seccomp policy refuses the ring.

#if defined(__linux__)

struct Uring {
  int ring_fd = -1;
  unsigned sq_entries = 0;
  void* sq_ring_ptr = nullptr;
  void* cq_ring_ptr = nullptr;
  size_t sq_ring_sz = 0, cq_ring_sz = 0;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_sz = 0;
  unsigned *sq_tail = nullptr, *sq_mask = nullptr, *sq_array = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;
  unsigned to_submit = 0;

  // The ops this gather needs; probed at init so a kernel old enough to
  // have io_uring but not these (5.1–5.5: OPENAT/READ/CLOSE landed in 5.6)
  // fails init and the caller keeps the synchronous path. REGISTER_PROBE
  // itself is also 5.6+, so its absence likewise means "don't use uring".
  static bool ops_supported(int fd) {
    constexpr unsigned NOPS = 64;
    alignas(io_uring_probe) uint8_t buf[sizeof(io_uring_probe) +
                                        NOPS * sizeof(io_uring_probe_op)] = {};
    auto* probe = reinterpret_cast<io_uring_probe*>(buf);
    if (syscall(__NR_io_uring_register, fd, IORING_REGISTER_PROBE, probe,
                NOPS) < 0)
      return false;
    for (unsigned op : {static_cast<unsigned>(IORING_OP_OPENAT),
                        static_cast<unsigned>(IORING_OP_READ),
                        static_cast<unsigned>(IORING_OP_CLOSE)}) {
      if (op > probe->last_op || !(probe->ops[op].flags & IO_URING_OP_SUPPORTED))
        return false;
    }
    return true;
  }

  bool init(unsigned entries) {
    io_uring_params p{};
    ring_fd = static_cast<int>(syscall(__NR_io_uring_setup, entries, &p));
    if (ring_fd < 0) return false;
    if (!ops_supported(ring_fd)) {
      close(ring_fd);
      ring_fd = -1;
      return false;
    }
    sq_entries = p.sq_entries;
    sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    sq_ring_ptr = mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                       MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    cq_ring_ptr = mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                       MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_CQ_RING);
    sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
    sqes = static_cast<io_uring_sqe*>(
        mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQES));
    if (sq_ring_ptr == MAP_FAILED || cq_ring_ptr == MAP_FAILED ||
        sqes == MAP_FAILED) {
      destroy();
      return false;
    }
    auto* sq = static_cast<uint8_t*>(sq_ring_ptr);
    auto* cq = static_cast<uint8_t*>(cq_ring_ptr);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(cq + p.cq_off.cqes);
    return true;
  }

  void destroy() {
    if (sq_ring_ptr && sq_ring_ptr != MAP_FAILED) munmap(sq_ring_ptr, sq_ring_sz);
    if (cq_ring_ptr && cq_ring_ptr != MAP_FAILED) munmap(cq_ring_ptr, cq_ring_sz);
    if (sqes && sqes != reinterpret_cast<io_uring_sqe*>(MAP_FAILED))
      munmap(sqes, sqes_sz);
    if (ring_fd >= 0) close(ring_fd);
    ring_fd = -1;
  }
  ~Uring() { destroy(); }

  io_uring_sqe* next_sqe() {
    unsigned tail = *sq_tail;  // single-threaded: plain read of our own tail
    unsigned idx = tail & *sq_mask;
    io_uring_sqe* s = &sqes[idx];
    std::memset(s, 0, sizeof(*s));
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    to_submit++;
    return s;
  }

  // submit everything queued and wait for that many completions; calls
  // cb(user_data, res) for each. Returns false on enter failure (EINTR is
  // retried — a blocking enter is signal-interruptible under a Python
  // host, and one signal must not poison a whole group of files).
  template <typename F>
  bool submit_wait(F cb) {
    unsigned want = to_submit;
    to_submit = 0;
    unsigned submitted = 0;
    while (submitted < want) {
      long r = syscall(__NR_io_uring_enter, ring_fd, want - submitted,
                       want - submitted, IORING_ENTER_GETEVENTS, nullptr, 0);
      if (r < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      submitted += static_cast<unsigned>(r);
    }
    unsigned got = 0;
    while (got < want) {
      unsigned head = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
      unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
      while (head != tail && got < want) {
        const io_uring_cqe& c = cqes[head & *cq_mask];
        cb(c.user_data, c.res);
        head++;
        got++;
      }
      __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
      if (got < want) {
        long r = syscall(__NR_io_uring_enter, ring_fd, 0, want - got,
                         IORING_ENTER_GETEVENTS, nullptr, 0);
        if (r < 0 && errno != EINTR) return false;
      }
    }
    return true;
  }
};

// SD_NO_URING set to anything but "" or "0" keeps the ring off. Read per
// call (the reference caches it for the process), so that a process can
// switch paths at run time.
bool uring_disabled() {
  const char* e = getenv("SD_NO_URING");
  return e && *e && *e != '0';
}

// Effective gather queue depth: files in flight per uring round
// (SD_CAS_GATHER_DEPTH, default 128, clamped 1..2048). Read per call, not
// statically cached — the bench sweep and tests mutate the environment at
// runtime. The sampled-file round queues 6 reads per file, so the ring
// must be sized (and the group clamped) to 6× the depth.
int32_t gather_depth() {
  int32_t depth = 128;
  const char* e = getenv("SD_CAS_GATHER_DEPTH");
  if (e && *e) {
    char* end = nullptr;
    long v = strtol(e, &end, 10);
    if (end != e && v > 0) depth = static_cast<int32_t>(std::min<long>(v, 2048));
  }
  return depth;
}

// Smallest power-of-two ring that fits a full reads round at this depth
// (io_uring_setup rounds entries up to a power of two anyway; 32768 is the
// kernel's default ceiling).
unsigned ring_entries_for(int32_t depth) {
  uint64_t need = static_cast<uint64_t>(depth) * 6;
  unsigned entries = 64;
  while (entries < need && entries < 32768) entries <<= 1;
  return entries;
}

// Fill rows exactly like the synchronous gather loop, via an
// already-initialized ring (reused across groups by the batch hasher).
// Returns false only on ring INFRASTRUCTURE failure (enter refused) — the
// group's fds are plain-closed and the caller must redo the whole batch on
// the synchronous path; per-file IO errors stay in-band as lengths[i]=0.
bool uring_gather_ring(Uring& ring, const char* const* paths,
                       const uint64_t* sizes, int32_t n, uint8_t* out,
                       int64_t row_stride, int32_t* lengths,
                       int32_t group_hint) {
  struct Read {
    int32_t file;
    uint8_t* dst;
    uint64_t off;
    uint32_t want;
  };
  // 6 reads/file: the group is clamped so one reads round can never
  // overflow the ring the caller initialized (next_sqe has no overflow
  // check by design — rounds are sized to fit)
  const int32_t GROUP = std::max<int32_t>(
      1, std::min(group_hint, static_cast<int32_t>(ring.sq_entries / 6)));
  std::vector<int> fds(GROUP);
  std::vector<Read> reads, retry;
  std::vector<int32_t> remaining(GROUP);  // per-file outstanding read count
  std::vector<uint8_t> failed(GROUP);

  auto bail = [&](int32_t gn) {  // infra failure: recover fds, let caller
    for (int32_t j = 0; j < gn; j++)  // fall back to the sync path
      if (fds[j] >= 0) close(fds[j]);
    return false;
  };

  for (int32_t g0 = 0; g0 < n; g0 += GROUP) {
    int32_t gn = std::min<int32_t>(GROUP, n - g0);
    // --- opens
    for (int32_t j = 0; j < gn; j++) {
      io_uring_sqe* s = ring.next_sqe();
      s->opcode = IORING_OP_OPENAT;
      s->fd = AT_FDCWD;
      s->addr = reinterpret_cast<uint64_t>(paths[g0 + j]);
      s->open_flags = O_RDONLY;
      s->user_data = static_cast<uint64_t>(j);
      fds[j] = -1;
    }
    if (!ring.submit_wait([&](uint64_t ud, int32_t res) {
          fds[ud] = res;  // negative on failure
        }))
      return bail(gn);

    // --- build read list (size prefix written inline; oversize rows and
    // failed opens are marked straight away)
    reads.clear();
    for (int32_t j = 0; j < gn; j++) {
      int32_t i = g0 + j;
      lengths[i] = 0;
      remaining[j] = 0;
      failed[j] = 1;
      uint64_t size = sizes[i];
      uint64_t msg_len = msg_len_for(size);
      if (fds[j] < 0 || static_cast<int64_t>(msg_len) > row_stride) continue;
      failed[j] = 0;
      uint8_t* row = out + static_cast<int64_t>(i) * row_stride;
      for (int b = 0; b < 8; b++)
        row[b] = static_cast<uint8_t>(size >> (8 * b));
      uint8_t* dst = row + 8;
      if (size <= MINIMUM_FILE_SIZE) {
        if (size > 0) {
          reads.push_back({j, dst, 0, static_cast<uint32_t>(size)});
          remaining[j] = 1;
        }
      } else {
        uint64_t seek_jump = (size - HEADER_OR_FOOTER * 2) / SAMPLE_COUNT;
        reads.push_back({j, dst, 0, static_cast<uint32_t>(HEADER_OR_FOOTER)});
        dst += HEADER_OR_FOOTER;
        for (uint64_t smp = 0; smp < SAMPLE_COUNT; smp++) {
          reads.push_back({j, dst, HEADER_OR_FOOTER + smp * seek_jump,
                           static_cast<uint32_t>(SAMPLE_SIZE)});
          dst += SAMPLE_SIZE;
        }
        reads.push_back({j, dst, size - HEADER_OR_FOOTER,
                         static_cast<uint32_t>(HEADER_OR_FOOTER)});
        remaining[j] = 6;
      }
    }

    // --- reads, resubmitting short reads until each op errors or fills
    while (!reads.empty()) {
      retry.clear();
      for (size_t k = 0; k < reads.size(); k++) {
        const Read& rd = reads[k];
        io_uring_sqe* s = ring.next_sqe();
        s->opcode = IORING_OP_READ;
        s->fd = fds[rd.file];
        s->addr = reinterpret_cast<uint64_t>(rd.dst);
        s->len = rd.want;
        s->off = rd.off;
        s->user_data = k;
      }
      bool ok = ring.submit_wait([&](uint64_t ud, int32_t res) {
        Read& rd = reads[ud];
        if (failed[rd.file]) return;
        if (res <= 0) {
          failed[rd.file] = 1;
        } else if (static_cast<uint32_t>(res) < rd.want) {
          retry.push_back({rd.file, rd.dst + res, rd.off + res,
                           rd.want - static_cast<uint32_t>(res)});
        } else {
          remaining[rd.file]--;
        }
      });
      if (!ok) return bail(gn);
      reads.swap(retry);
    }

    // --- closes (results ignored; fd exhaustion surfaces on the next open)
    for (int32_t j = 0; j < gn; j++) {
      if (fds[j] < 0) continue;
      io_uring_sqe* s = ring.next_sqe();
      s->opcode = IORING_OP_CLOSE;
      s->fd = fds[j];
      s->user_data = static_cast<uint64_t>(j);
    }
    // close-round enter failure: an unknown subset of the CLOSEs already
    // ran, so re-closing here could hit a recycled fd — accept a one-time
    // leak of <= GROUP fds instead and let the caller fall back
    if (!ring.submit_wait([](uint64_t, int32_t) {})) return false;

    // --- finalize rows
    for (int32_t j = 0; j < gn; j++) {
      if (failed[j] || remaining[j] != 0) continue;
      int32_t i = g0 + j;
      uint64_t msg_len = msg_len_for(sizes[i]);
      uint8_t* row = out + static_cast<int64_t>(i) * row_stride;
      uint64_t pad = (64 - (msg_len & 63)) & 63;
      if (pad && static_cast<int64_t>(msg_len + pad) <= row_stride)
        std::memset(row + msg_len, 0, pad);
      lengths[i] = static_cast<int32_t>(msg_len);
    }
  }
  return true;
}

// One-shot wrapper: own ring sized to the configured depth, whole batch.
bool uring_gather(const char* const* paths, const uint64_t* sizes, int32_t n,
                  uint8_t* out, int64_t row_stride, int32_t* lengths) {
  if (uring_disabled()) return false;
  int32_t depth = gather_depth();
  Uring ring;
  // a host that refuses the big ring (memlock limits) still gets the
  // default-depth one — the clamp in uring_gather_ring keeps rounds legal
  if (!ring.init(ring_entries_for(depth))) {
    ring.destroy();
    if (!ring.init(1024)) return false;
  }
  return uring_gather_ring(ring, paths, sizes, n, out, row_stride, lengths,
                           depth);
}

#else
struct Uring {
  bool init(unsigned) { return false; }
};
bool uring_disabled() { return true; }
int32_t gather_depth() { return 128; }
unsigned ring_entries_for(int32_t) { return 1024; }
bool uring_gather_ring(Uring&, const char* const*, const uint64_t*, int32_t,
                       uint8_t*, int64_t, int32_t*, int32_t) {
  return false;
}
bool uring_gather(const char* const*, const uint64_t*, int32_t, uint8_t*,
                  int64_t, int32_t*) {
  return false;
}
#endif  // __linux__

}  // namespace

extern "C" {

// Which path served a sd_cas_gather_batch call.
enum GatherPath : int32_t {
  GATHER_RING = 0,          // io_uring
  GATHER_THREADS = 1,       // pread threads: n < 8 or SD_NO_URING
  GATHER_RING_REFUSED = 2,  // pread threads: the ring was refused or failed
};

// Gather stage of the device hash: read each file's cas sample message
// (size_le8 ‖ samples, cas.rs layout) straight into row i of a zero-padded
// (n, row_stride) byte matrix, fused with IO so Python never copies per
// file. lengths[i] gets the true message byte count; err-rows get length 0
// (the caller routes per-file errors). Returns the GatherPath that served
// the batch: the ring for n >= 8 unless SD_NO_URING, else pread threads.
int32_t sd_cas_gather_batch(const char* const* paths, const uint64_t* sizes,
                            int32_t n, int32_t n_threads, uint8_t* out,
                            int64_t row_stride, int32_t* lengths) {
  int32_t path = GATHER_THREADS;
  if (n >= 8 && !uring_disabled()) {
    if (uring_gather(paths, sizes, n, out, row_stride, lengths))
      return GATHER_RING;
    path = GATHER_RING_REFUSED;
  }
  for_each_parallel(n, n_threads, [&](int32_t i) {
      uint8_t* row = out + static_cast<int64_t>(i) * row_stride;
      lengths[i] = 0;
      uint64_t size = sizes[i];
      uint64_t msg_len = msg_len_for(size);
      if (static_cast<int64_t>(msg_len) > row_stride) return;
      int fd = open(paths[i], O_RDONLY);
      if (fd < 0) return;
      for (int b = 0; b < 8; b++) row[b] = static_cast<uint8_t>(size >> (8 * b));
      uint8_t* dst = row + 8;
      auto read_exact = [&](uint64_t off, uint64_t len) -> bool {
        uint64_t got = 0;
        while (got < len) {
          ssize_t r = pread(fd, dst + got, len - got, off + got);
          if (r <= 0) return false;
          got += static_cast<uint64_t>(r);
        }
        dst += len;
        return true;
      };
      bool ok = true;
      if (size <= MINIMUM_FILE_SIZE) {
        ok = size == 0 || read_exact(0, size);
      } else {
        uint64_t seek_jump = (size - HEADER_OR_FOOTER * 2) / SAMPLE_COUNT;
        ok = read_exact(0, HEADER_OR_FOOTER);
        for (uint64_t s = 0; ok && s < SAMPLE_COUNT; s++) {
          ok = read_exact(HEADER_OR_FOOTER + s * seek_jump, SAMPLE_SIZE);
        }
        ok = ok && read_exact(size - HEADER_OR_FOOTER, HEADER_OR_FOOTER);
      }
      close(fd);
      if (ok) {
        // zero to the 64-byte block boundary: the device kernel compresses
        // whole blocks and relies on zero padding within the final one
        // (beyond that, per-lane block/chunk masks ignore the row tail)
        uint64_t pad = (64 - (msg_len & 63)) & 63;
        if (pad && static_cast<int64_t>(msg_len + pad) <= row_stride) {
          std::memset(row + msg_len, 0, pad);
        }
        lengths[i] = static_cast<int32_t>(msg_len);
      }
  });
  return path;
}

}  // extern "C"
