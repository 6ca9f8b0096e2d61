// Native clip store reader: the port's host-side C++ component.
//
// The reference holds every preprocessed clip in RAM through one data_map
// pickle (hwgat/data_preprocess.py:102-116): a full deserialize at start-up,
// and no sharing across loader workers. This store is one mmap-ed file of
// variable-length float32 records with an offset/dims index. Reads make no
// system call after open (the page cache is shared across processes), cost
// O(1) a clip, and copy straight into a buffer the caller provides.
//
// File layout (little-endian), version 2:
//   [0:4)              magic "SLCS"
//   [4:8)              version u32 (=2)
//   [8:16)             n u64 (record count)
//   [16:32)            store uuid (16 raw bytes); the Python reader checks
//                      it against the .ids sidecar, so a crash between the
//                      two writes can never pair a new store with a stale
//                      id -> row table
//   [32 : 32+16n)      per-record index: offset u64 (absolute, bytes),
//                                        T u32, VC u32 (V<<16 | C)
//   [data...]          float32 payloads
//
// The id -> row map is a Python-side sidecar (<path>.ids pickle); this layer
// deals only in row numbers. sl_hwgat_tpu_torch/data/clipstore.py builds it
// with g++ at first use and binds it through ctypes; its numpy reader reads
// the same format.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Index {
  uint64_t offset;
  uint32_t t;
  uint32_t vc;
};

struct Store {
  void* base = nullptr;
  size_t size = 0;
  uint64_t n = 0;
  const Index* index = nullptr;
};

}  // namespace

extern "C" {

// Returns a handle (heap pointer) or nullptr on failure.
void* cs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);  // mapping keeps its own reference
  if (base == MAP_FAILED) return nullptr;
  const unsigned char* b = static_cast<const unsigned char*>(base);
  if (memcmp(b, "SLCS", 4) != 0) {
    munmap(base, st.st_size);
    return nullptr;
  }
  uint32_t version;
  memcpy(&version, b + 4, 4);
  if (version != 2) {
    munmap(base, st.st_size);
    return nullptr;
  }
  uint64_t n;
  memcpy(&n, b + 8, 8);
  // a truncated/corrupt store must fail cleanly, not SIGSEGV on index reads
  if (32 + n * sizeof(Index) > static_cast<uint64_t>(st.st_size)) {
    munmap(base, st.st_size);
    return nullptr;
  }
  Store* s = new Store;
  s->base = base;
  s->size = st.st_size;
  s->n = n;
  s->index = reinterpret_cast<const Index*>(b + 32);
  return s;
}

void cs_close(void* handle) {
  if (!handle) return;
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->size);
  delete s;
}

int64_t cs_len(void* handle) {
  return handle ? static_cast<int64_t>(static_cast<Store*>(handle)->n) : -1;
}

// dims_out: [T, V, C]; returns element count or -1.
int64_t cs_shape(void* handle, int64_t row, uint32_t* dims_out) {
  Store* s = static_cast<Store*>(handle);
  if (!s || row < 0 || static_cast<uint64_t>(row) >= s->n) return -1;
  const Index& ix = s->index[row];
  dims_out[0] = ix.t;
  dims_out[1] = ix.vc >> 16;
  dims_out[2] = ix.vc & 0xffff;
  return static_cast<int64_t>(ix.t) * dims_out[1] * dims_out[2];
}

// Copies the record's float32 payload into dst (must hold cs_shape elements).
int cs_read(void* handle, int64_t row, float* dst) {
  Store* s = static_cast<Store*>(handle);
  if (!s || row < 0 || static_cast<uint64_t>(row) >= s->n) return -1;
  const Index& ix = s->index[row];
  size_t count = static_cast<size_t>(ix.t) * (ix.vc >> 16) * (ix.vc & 0xffff);
  size_t bytes = count * sizeof(float);
  if (ix.offset + bytes > s->size) return -2;
  memcpy(dst, static_cast<const unsigned char*>(s->base) + ix.offset, bytes);
  return 0;
}

}  // extern "C"
