// Native vbz signal decode: svb16 unpack + zigzag + wrapping prefix sum.
//
// The pod5 signal codec (utils/pod5.py) is zstd over svb16-packed
// zigzag-encoded int16 deltas.  zstd decompression is already C (the
// system libzstd, called through native/zstd.py), but the numpy unpack
// path costs ~8 separate passes over the samples (unpackbits, cumsum for
// offsets, two fancy gathers, zigzag arithmetic, int64 cumsum, int16
// cast); the JAX package measured it at 4x the C++ fast5 reader's whole
// per-read cost on its host (BENCH_POD5_r05.jsonl).  This single fused
// pass does the same work in one scalar loop.
//
// Reference parity: the vbz v1 codec semantics mirrored from
// utils/pod5.py::vbz_decompress (itself written to the public pod5
// format spec — SURVEY.md §2 item 10); bit-identical output is pinned
// by tests/test_torch_native.py against the numpy path.
//
// Begun as a copy of deepbinner_tpu/native/src/vbz_decode.cc; the port's
// unpack takes a `keep` bound, so a chunk of which a read's head needs only
// a prefix is unpacked only that far (utils/pod5.py::_decode_read_signal).

#include <cstdint>
#include <cstring>

extern "C" {

static int64_t popcount(uint64_t x) {  // SWAR: no -mpopcnt in the flags
  x = x - ((x >> 1) & 0x5555555555555555ull);
  x = (x & 0x3333333333333333ull) + ((x >> 2) & 0x3333333333333333ull);
  x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0Full;
  return static_cast<int64_t>((x * 0x0101010101010101ull) >> 56);
}

// The data bytes that `count` values take: one each, and one more for
// each wide value, i.e. each key bit set among the first `count`.
static int64_t data_len(const uint8_t* keys, int64_t count) {
  const int64_t whole = count / 8;  // key bytes all of whose bits count
  int64_t wide = 0;
  int64_t b = 0;
  for (; b + 8 <= whole; b += 8) {
    uint64_t word;
    std::memcpy(&word, keys + b, 8);
    wide += popcount(word);
  }
  for (; b < whole; ++b) wide += popcount(keys[b]);
  if (count % 8) wide += popcount(keys[whole] & ((1u << (count % 8)) - 1));
  return count + wide;
}

// svb16-unpack the first `keep` of `count` values from `raw` (keys block
// for all `count` values, then data block), zigzag-decode each to an int16
// delta, and write the wrapping int16 prefix sum into `out[0, keep)`.  The
// prefix sum runs from the chunk's first value, so the kept values are
// those of the whole unpack; `keep == count` unpacks everything.  Returns 0
// on success, -1 on bad sizes or a stream shorter than its keys say the
// whole chunk needs (checked before any value is decoded, whatever
// `keep`, so a chunk truncated after the kept prefix is still rejected;
// never reads past raw + raw_len).
int64_t db_vbz_unpack(const uint8_t* raw, int64_t raw_len, int64_t count,
                      int64_t keep, int16_t* out) {
  if (count < 0 || keep < 0 || keep > count) return -1;
  const int64_t key_len = (count + 7) / 8;
  if (raw_len < key_len) return -1;
  const uint8_t* keys = raw;
  if (raw_len - key_len < data_len(keys, count)) return -1;
  const uint8_t* data = raw + key_len;
  const uint8_t* const end = raw + raw_len;
  uint16_t acc = 0;  // unsigned: wrapping int16 accumulation without UB
  int64_t i = 0;
  // Branchless main loop: always load two bytes and mask the high one
  // away for narrow values — a data-dependent branch per element costs
  // ~2x (measured for the JAX package).  Safe while a full 2-byte load
  // fits.
  for (; i < keep && data + 2 <= end; ++i) {
    const uint16_t wide = (keys[i >> 3] >> (i & 7)) & 1;
    uint16_t v = static_cast<uint16_t>(data[0] | (data[1] << 8));
    v = static_cast<uint16_t>(v & (0x00FF | (0xFF00u * wide)));
    data += 1 + wide;
    // zigzag: (v >> 1) ^ (all-ones if v odd else 0)
    const uint16_t z =
        static_cast<uint16_t>((v >> 1) ^ static_cast<uint16_t>(-(v & 1)));
    acc = static_cast<uint16_t>(acc + z);
    out[i] = static_cast<int16_t>(acc);
  }
  // Tail (final byte may be a narrow value): bounds-checked per element.
  for (; i < keep; ++i) {
    const int wide = (keys[i >> 3] >> (i & 7)) & 1;
    if (data + 1 + wide > end) return -1;
    uint16_t v = data[0];
    if (wide) v = static_cast<uint16_t>(v | (data[1] << 8));
    data += 1 + wide;
    const uint16_t z =
        static_cast<uint16_t>((v >> 1) ^ static_cast<uint16_t>(-(v & 1)));
    acc = static_cast<uint16_t>(acc + z);
    out[i] = static_cast<int16_t>(acc);
  }
  return 0;
}

}  // extern "C"
