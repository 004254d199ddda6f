// Native fast5 batch reader over libhdf5 (C API, serial build).
//
// Reference parity: deepbinner/load_fast5s.py::get_read_id_and_signal reads
// one dataset per h5py call with Python-object overhead per read; this
// reader decodes an entire fast5 (all reads, both single- and multi-read
// layouts) in one C++ call, off the GIL, into malloc'd buffers that the
// ctypes wrapper copies into numpy arrays.
//
// Only the HDF5 runtime library is needed, not its development headers: the
// prototypes used are declared here directly — the HDF5 1.10 C ABI is stable
// and native/build.py links with -Wl,--no-undefined, so a symbol the runtime
// lacks fails the link.  The runtime is not assumed to be a threadsafe HDF5
// build; a process-wide mutex serialises calls (the win over h5py is
// per-call cost, not lock-free threading).
//
// A copy of deepbinner_tpu/native/src/fast5_reader.cc for the PyTorch port.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

extern "C" {
typedef int64_t hid_t;
typedef int herr_t;
typedef int htri_t;
typedef unsigned long long hsize_t;
typedef long long hssize_t;

herr_t H5open(void);
herr_t H5Eset_auto2(hid_t, void *, void *);
herr_t H5Eclear2(hid_t);

hid_t H5Fopen(const char *, unsigned, hid_t);
herr_t H5Fclose(hid_t);
hid_t H5Gopen2(hid_t, const char *, hid_t);
herr_t H5Gclose(hid_t);
hid_t H5Dopen2(hid_t, const char *, hid_t);
herr_t H5Dclose(hid_t);
hid_t H5Dget_space(hid_t);
herr_t H5Dread(hid_t, hid_t, hid_t, hid_t, hid_t, void *);
hssize_t H5Sget_simple_extent_npoints(hid_t);
hid_t H5Screate_simple(int, const hsize_t *, const hsize_t *);
herr_t H5Sselect_hyperslab(hid_t, int, const hsize_t *, const hsize_t *,
                           const hsize_t *, const hsize_t *);
herr_t H5Sclose(hid_t);
htri_t H5Lexists(hid_t, const char *, hid_t);

typedef herr_t (*H5L_iterate_t)(hid_t, const char *, const void *, void *);
herr_t H5Literate(hid_t, int, int, hsize_t *, H5L_iterate_t, void *);

htri_t H5Aexists(hid_t, const char *);
hid_t H5Aopen(hid_t, const char *, hid_t);
herr_t H5Aclose(hid_t);
hid_t H5Aget_type(hid_t);
herr_t H5Aread(hid_t, hid_t, void *);
hid_t H5Tcopy(hid_t);
herr_t H5Tset_size(hid_t, size_t);
herr_t H5Tset_cset(hid_t, int);
htri_t H5Tis_variable_str(hid_t);
size_t H5Tget_size(hid_t);
herr_t H5Tclose(hid_t);
herr_t H5free_memory(void *);

extern hid_t H5T_NATIVE_SHORT_g;  // int16 memory type
extern hid_t H5T_C_S1_g;          // C string base type
}

namespace {

constexpr unsigned kRdOnly = 0u;     // H5F_ACC_RDONLY
constexpr hid_t kDefault = 0;        // H5P_DEFAULT
constexpr hid_t kAllSpace = 0;       // H5S_ALL
constexpr size_t kVariable = static_cast<size_t>(-1);  // H5T_VARIABLE
constexpr int kIdxName = 0;          // H5_INDEX_NAME
constexpr int kIterInc = 0;          // H5_ITER_INC
constexpr int kCsetUtf8 = 1;         // H5T_CSET_UTF8
constexpr int kSelectSet = 0;        // H5S_SELECT_SET

struct DbRead {
  char read_id[64];
  int16_t *signal;
  int64_t length;
};

struct Ctx {
  hid_t loc;
  int64_t head;  // >0: read only the first `head` samples …
  int64_t tail;  // … and the last `tail` samples (classify's access pattern)
  std::vector<DbRead> reads;
};

std::mutex g_mutex;

void ensure_init() {
  static bool done = [] {
    H5open();
    return true;
  }();
  (void)done;
  // A threadsafe HDF5 build keeps one error stack per thread, and the
  // reader is called from several threads: silence each calling thread's
  // stack (no stderr spew on bad files) and clear it after every call, so
  // that no thread leaves errors behind for the library's shutdown.
  H5Eset_auto2(0, nullptr, nullptr);
}

// Read a string attribute (h5py writes vlen UTF-8 by default; fixed-width
// also handled).  Returns false if absent/unreadable.
bool read_string_attr(hid_t obj, const char *name, char *buf, size_t cap) {
  if (H5Aexists(obj, name) <= 0) return false;
  hid_t attr = H5Aopen(obj, name, kDefault);
  if (attr < 0) return false;
  bool ok = false;
  hid_t type = H5Aget_type(attr);
  if (type >= 0) {
    if (H5Tis_variable_str(type) > 0) {
      hid_t mem = H5Tcopy(H5T_C_S1_g);
      H5Tset_size(mem, kVariable);
      H5Tset_cset(mem, kCsetUtf8);
      char *value = nullptr;
      if (H5Aread(attr, mem, &value) >= 0 && value != nullptr) {
        std::strncpy(buf, value, cap - 1);
        buf[cap - 1] = '\0';
        H5free_memory(value);
        ok = true;
      }
      H5Tclose(mem);
    } else {
      size_t size = H5Tget_size(type);
      if (size > 0 && size < cap) {
        hid_t mem = H5Tcopy(H5T_C_S1_g);
        H5Tset_size(mem, size);
        std::vector<char> tmp(size + 1, '\0');
        if (H5Aread(attr, mem, tmp.data()) >= 0) {
          std::strncpy(buf, tmp.data(), cap - 1);
          buf[cap - 1] = '\0';
          ok = true;
        }
        H5Tclose(mem);
      }
    }
    H5Tclose(type);
  }
  H5Aclose(attr);
  return ok;
}

// One hyperslab of `count` samples at file offset `src` into buf+dst.
bool read_slab(hid_t dset, hid_t space, int16_t *buf, hsize_t buf_len,
               hsize_t src, hsize_t dst, hsize_t count) {
  hsize_t start = src;
  if (H5Sselect_hyperslab(space, kSelectSet, &start, nullptr, &count,
                          nullptr) < 0) {
    return false;
  }
  hid_t mem = H5Screate_simple(1, &buf_len, nullptr);
  if (mem < 0) return false;
  bool ok = false;
  hsize_t mstart = dst;
  if (H5Sselect_hyperslab(mem, kSelectSet, &mstart, nullptr, &count,
                          nullptr) >= 0) {
    ok = H5Dread(dset, H5T_NATIVE_SHORT_g, mem, space, kDefault, buf) >= 0;
  }
  H5Sclose(mem);
  return ok;
}

bool read_signal_dataset(hid_t loc, const char *path, int64_t head,
                         int64_t tail, int16_t **out, int64_t *length) {
  hid_t dset = H5Dopen2(loc, path, kDefault);
  if (dset < 0) return false;
  bool ok = false;
  hid_t space = H5Dget_space(dset);
  if (space >= 0) {
    hssize_t n = H5Sget_simple_extent_npoints(space);
    if (n >= 0) {
      if (head > 0 && tail >= 0 && head + tail < n) {
        // Partial decode: first `head` + last `tail` samples only.  The
        // concatenation preserves executor.build_batch's head/tail slice
        // semantics (see mp_reader._trim_signal) while skipping the bulk
        // of long reads — classify never looks at the middle.
        hsize_t keep = static_cast<hsize_t>(head + tail);
        auto *buf = static_cast<int16_t *>(std::malloc(sizeof(int16_t) * keep));
        if (buf != nullptr &&
            read_slab(dset, space, buf, keep, 0, 0,
                      static_cast<hsize_t>(head)) &&
            (tail == 0 ||
             read_slab(dset, space, buf, keep,
                       static_cast<hsize_t>(n - tail),
                       static_cast<hsize_t>(head),
                       static_cast<hsize_t>(tail)))) {
          *out = buf;
          *length = static_cast<int64_t>(keep);
          ok = true;
        } else {
          std::free(buf);
        }
      } else {
        auto *buf =
            static_cast<int16_t *>(std::malloc(sizeof(int16_t) * (n ? n : 1)));
        if (buf != nullptr &&
            H5Dread(dset, H5T_NATIVE_SHORT_g, kAllSpace, kAllSpace, kDefault,
                    buf) >= 0) {
          *out = buf;
          *length = static_cast<int64_t>(n);
          ok = true;
        } else {
          std::free(buf);
        }
      }
    }
    H5Sclose(space);
  }
  H5Dclose(dset);
  return ok;
}

// Single-read layout: Raw/Reads/Read_*/Signal with read_id attr on Read_*.
herr_t single_read_cb(hid_t group, const char *name, const void *, void *op) {
  auto *ctx = static_cast<Ctx *>(op);
  hid_t read_grp = H5Gopen2(group, name, kDefault);
  if (read_grp < 0) return 0;  // skip, keep iterating
  DbRead entry;
  std::memset(&entry, 0, sizeof(entry));
  if (!read_string_attr(read_grp, "read_id", entry.read_id,
                        sizeof(entry.read_id))) {
    std::strncpy(entry.read_id, name, sizeof(entry.read_id) - 1);
  }
  if (read_signal_dataset(read_grp, "Signal", ctx->head, ctx->tail,
                          &entry.signal, &entry.length)) {
    ctx->reads.push_back(entry);
  }
  H5Gclose(read_grp);
  return 0;
}

// Multi-read layout: /read_<id>/Raw/Signal with read_id attr on Raw.
herr_t multi_read_cb(hid_t group, const char *name, const void *, void *op) {
  auto *ctx = static_cast<Ctx *>(op);
  if (std::strncmp(name, "read_", 5) != 0) return 0;
  std::string raw_path = std::string(name) + "/Raw";
  if (H5Lexists(group, name, kDefault) <= 0) return 0;
  hid_t raw = H5Gopen2(group, raw_path.c_str(), kDefault);
  if (raw < 0) return 0;
  DbRead entry;
  std::memset(&entry, 0, sizeof(entry));
  if (!read_string_attr(raw, "read_id", entry.read_id,
                        sizeof(entry.read_id))) {
    std::strncpy(entry.read_id, name + 5, sizeof(entry.read_id) - 1);
  }
  if (read_signal_dataset(raw, "Signal", ctx->head, ctx->tail, &entry.signal,
                          &entry.length)) {
    ctx->reads.push_back(entry);
  }
  H5Gclose(raw);
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success. *out is a malloc'd array of *count DbRead entries,
// each owning a malloc'd signal buffer; release with db_free_reads.
// head/tail > 0 decode only those end slices of each signal (classify's
// access pattern); 0/0 decodes everything (prep's).
int db_read_fast5_slices(const char *path, int64_t head, int64_t tail,
                         DbRead **out, int *count) {
  std::lock_guard<std::mutex> lock(g_mutex);
  ensure_init();
  *out = nullptr;
  *count = 0;
  hid_t file = H5Fopen(path, kRdOnly, kDefault);
  if (file < 0) {
    H5Eclear2(0);
    return 1;
  }

  Ctx ctx;
  ctx.loc = file;
  ctx.head = head;
  ctx.tail = tail;
  if (H5Lexists(file, "Raw", kDefault) > 0 &&
      H5Lexists(file, "Raw/Reads", kDefault) > 0) {
    hid_t reads_grp = H5Gopen2(file, "Raw/Reads", kDefault);
    if (reads_grp >= 0) {
      H5Literate(reads_grp, kIdxName, kIterInc, nullptr, single_read_cb, &ctx);
      H5Gclose(reads_grp);
    }
  }
  H5Literate(file, kIdxName, kIterInc, nullptr, multi_read_cb, &ctx);
  H5Fclose(file);
  H5Eclear2(0);

  if (ctx.reads.empty()) return 2;  // opened but no raw-signal reads
  auto *array =
      static_cast<DbRead *>(std::malloc(sizeof(DbRead) * ctx.reads.size()));
  if (array == nullptr) {
    for (auto &entry : ctx.reads) std::free(entry.signal);
    return 3;
  }
  std::memcpy(array, ctx.reads.data(), sizeof(DbRead) * ctx.reads.size());
  *out = array;
  *count = static_cast<int>(ctx.reads.size());
  return 0;
}

// Back-compat full-read entry point (the original ABI).
int db_read_fast5(const char *path, DbRead **out, int *count) {
  return db_read_fast5_slices(path, 0, 0, out, count);
}

void db_free_reads(DbRead *array, int count) {
  if (array == nullptr) return;
  for (int i = 0; i < count; ++i) std::free(array[i].signal);
  std::free(array);
}

}  // extern "C"
