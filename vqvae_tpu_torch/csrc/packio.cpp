// packio — mmap'd packed-record image dataset reader.
//
// Native equivalent of the reference's FFCV `.beton` fast-loading path
// (reference common_utils.py:56-100, data/create_beton_file.py; FFCV itself
// is a Numba/C-accelerated external package). Design:
//
//   header (64 B): magic 'VQPK' | version u32 | count u64 | h u32 | w u32 |
//                  c u32 | mode u32 (0 = raw u8, 1 = zlib u8) | reserved
//   index: count x { offset u64, length u64 }
//   records: raw or zlib-compressed HWC uint8 images
//
// The reader mmaps the file (zero-copy for raw mode), decodes batches with a
// small thread pool, and fills caller-provided numpy buffers through a C ABI
// (ctypes — no pybind11 dependency in this image).
//
// A copy of the JAX package's csrc/packio.cpp, kept here so that the
// PyTorch port builds it without the JAX package; the file format is the
// same, so either package reads what the other writes.
//
// Build: vqvae_tpu_torch/ops/_build.py (g++ -pthread -lz, at first use).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x4b505156;  // 'VQPK' little-endian

#pragma pack(push, 1)
struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t count;
  uint32_t height;
  uint32_t width;
  uint32_t channels;
  uint32_t mode;  // 0 raw, 1 zlib
  uint8_t reserved[32];
};
struct IndexEntry {
  uint64_t offset;
  uint64_t length;
};
#pragma pack(pop)

static_assert(sizeof(Header) == 64, "header must be 64 bytes");

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  const Header* header = nullptr;
  const IndexEntry* index = nullptr;
};

}  // namespace

extern "C" {

void* packio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(mem, st.st_size, MADV_WILLNEED);

  Reader* r = new Reader;
  r->fd = fd;
  r->data = static_cast<const uint8_t*>(mem);
  r->size = st.st_size;
  r->header = reinterpret_cast<const Header*>(r->data);
  // validate structure against the real file size: a truncated/corrupt
  // .pack must fail open() cleanly, not SIGSEGV in a later memcpy
  // overflow-safe: count * sizeof(IndexEntry) can wrap uint64 for a corrupt
  // header, so bound count by the space actually available instead
  bool ok = static_cast<size_t>(st.st_size) >= sizeof(Header) &&
            r->header->magic == kMagic && r->header->version == 1 &&
            r->header->count <=
                (static_cast<size_t>(st.st_size) - sizeof(Header)) /
                    sizeof(IndexEntry);
  if (ok) {
    r->index = reinterpret_cast<const IndexEntry*>(r->data + sizeof(Header));
    for (uint64_t i = 0; i < r->header->count; ++i) {
      const IndexEntry& e = r->index[i];
      if (e.offset > r->size || e.length > r->size ||
          e.offset + e.length > r->size) {
        ok = false;
        break;
      }
    }
  }
  if (!ok) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

void packio_info(void* handle, uint64_t* count, uint32_t* h, uint32_t* w,
                 uint32_t* c, uint32_t* mode) {
  const Reader* r = static_cast<Reader*>(handle);
  *count = r->header->count;
  *h = r->header->height;
  *w = r->header->width;
  *c = r->header->channels;
  *mode = r->header->mode;
}

// Fills out[(n, h*w*c)] for the given record indices. Returns 0 on success.
int packio_read_batch(void* handle, const int64_t* indices, int64_t n,
                      uint8_t* out, int num_threads) {
  const Reader* r = static_cast<Reader*>(handle);
  const Header& hd = *r->header;
  const size_t record_size =
      static_cast<size_t>(hd.height) * hd.width * hd.channels;

  std::atomic<int64_t> next(0);
  std::atomic<int> error(0);

  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || error.load()) return;
      uint64_t idx = static_cast<uint64_t>(indices[i]);
      if (idx >= hd.count) { error.store(1); return; }
      const IndexEntry& e = r->index[idx];
      const uint8_t* src = r->data + e.offset;
      uint8_t* dst = out + static_cast<size_t>(i) * record_size;
      if (hd.mode == 0) {
        if (e.length != record_size) { error.store(2); return; }
        std::memcpy(dst, src, record_size);
      } else {
        uLongf dst_len = record_size;
        if (uncompress(dst, &dst_len, src, e.length) != Z_OK ||
            dst_len != record_size) {
          error.store(3);
          return;
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return error.load();
}

void packio_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->data) munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
