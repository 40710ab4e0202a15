// Native roaring bitmap codec of the port (a copy of the JAX package's
// native/roaring_codec.cpp, plus the word decode of the open path).
//
// The reference's storage hot loops are Go (container codecs and op-log
// replay, reference roaring/roaring.go:1044-1126 writer, :1562-1654
// pilosa reader, :5076+ official-spec reader, ops :4415-4610). Here they
// are C++ behind a C ABI, bound with ctypes
// (pilosa_tpu_torch/storage/_native.py) and built by
// pilosa_tpu_torch/nativelib.py into build/native/<hash>/. The bytes it
// writes are those of the plain Python codec in
// pilosa_tpu_torch/storage/roaring.py.
//
// rt_decode_rows + rt_decode_words open a fragment file straight into its
// dense row words (uint32[rows, width/32]): a bitmap container whose row
// holds whole containers is OR-ed in as 2048 words, other containers and
// the op log set and clear single bits. No positions array is made, so a
// 64-row fragment of 2^20 columns opens at memory speed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <set>
#include <vector>

namespace {

constexpr uint16_t kMagic = 12348;
constexpr uint16_t kCookieNoRun = 12346;
constexpr uint16_t kCookieRun = 12347;

constexpr uint16_t kTypeArray = 1;
constexpr uint16_t kTypeBitmap = 2;
constexpr uint16_t kTypeRun = 3;

constexpr size_t kArrayMaxSize = 4096;  // reference roaring.go:1984
constexpr size_t kRunMaxSize = 2048;    // reference roaring.go:1987

constexpr uint8_t kOpAdd = 0;
constexpr uint8_t kOpRemove = 1;
constexpr uint8_t kOpAddBatch = 2;
constexpr uint8_t kOpRemoveBatch = 3;
constexpr uint8_t kOpAddRoaring = 4;
constexpr uint8_t kOpRemoveRoaring = 5;

inline uint32_t fnv32a(uint32_t h, const uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 0x01000193u;
  }
  return h;
}
constexpr uint32_t kFnvOffset = 0x811C9DC5u;

template <typename T>
inline T load_le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));  // x86/arm little-endian
  return v;
}

template <typename T>
inline void push_le(std::vector<uint8_t>& out, T v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out.insert(out.end(), p, p + sizeof(T));
}

struct Reader {
  const uint8_t* data;
  size_t len;
  // Subtraction form: `off + need <= len` wraps for attacker-controlled
  // lengths near SIZE_MAX, letting the check pass and the read run off
  // the buffer.
  bool ok(size_t off, size_t need) const {
    return off <= len && need <= len - off;
  }
};

// -- container decode -------------------------------------------------------

bool decode_container(const Reader& r, uint64_t key, uint16_t type,
                      uint32_t card, size_t off, bool run_is_len,
                      std::vector<uint64_t>* out, size_t* end) {
  uint64_t base = key << 16;
  if (type == kTypeArray) {
    if (!r.ok(off, 2ul * card)) return false;
    for (uint32_t i = 0; i < card; i++)
      out->push_back(base + load_le<uint16_t>(r.data + off + 2ul * i));
    *end = off + 2ul * card;
    return true;
  }
  if (type == kTypeBitmap) {
    if (!r.ok(off, 8192)) return false;
    for (size_t w = 0; w < 1024; w++) {
      uint64_t word = load_le<uint64_t>(r.data + off + 8 * w);
      while (word) {
        int b = __builtin_ctzll(word);
        out->push_back(base + w * 64 + b);
        word &= word - 1;
      }
    }
    *end = off + 8192;
    return true;
  }
  if (type == kTypeRun) {
    if (!r.ok(off, 2)) return false;
    uint16_t run_count = load_le<uint16_t>(r.data + off);
    if (!r.ok(off + 2, 4ul * run_count)) return false;
    for (uint16_t i = 0; i < run_count; i++) {
      uint16_t start = load_le<uint16_t>(r.data + off + 2 + 4ul * i);
      uint16_t second = load_le<uint16_t>(r.data + off + 4 + 4ul * i);
      // pilosa runs are [start, last]; official runs are [start, length]
      uint32_t last = run_is_len ? uint32_t(start) + second : second;
      for (uint32_t v = start; v <= last; v++) out->push_back(base + v);
    }
    *end = off + 2 + 4ul * run_count;
    return true;
  }
  return false;
}

bool deserialize_any(const uint8_t* data, size_t len,
                     std::vector<uint64_t>* out, uint64_t* op_count);

// The end of one container's data, its bounds checked, without decoding it.
bool container_end(const Reader& r, uint16_t type, uint32_t card, size_t off,
                   size_t* end) {
  if (type == kTypeArray) {
    if (!r.ok(off, 2ul * card)) return false;
    *end = off + 2ul * card;
    return true;
  }
  if (type == kTypeBitmap) {
    if (!r.ok(off, 8192)) return false;
    *end = off + 8192;
    return true;
  }
  if (type == kTypeRun) {
    if (!r.ok(off, 2)) return false;
    uint16_t run_count = load_le<uint16_t>(r.data + off);
    if (!r.ok(off + 2, 4ul * run_count)) return false;
    *end = off + 2 + 4ul * run_count;
    return true;
  }
  return false;
}

// -- op log -----------------------------------------------------------------

// Walk the op-log records from ``pos`` to the end or to the first bad
// record: ``record()`` before each valid record, then ``add(v)`` or
// ``remove(v)`` for each of its positions. ``*op_count`` accumulates the
// bits the records carry (a roaring record counts its own opN), which
// restores a reopened fragment's snapshot trigger.
template <typename Record, typename Add, typename Remove>
void walk_ops(const Reader& r, size_t pos, Record&& record, Add&& add,
              Remove&& remove, uint64_t* op_count) {
  while (r.ok(pos, 13)) {
    uint8_t op = r.data[pos];
    uint64_t value = load_le<uint64_t>(r.data + pos + 1);
    uint32_t chk = load_le<uint32_t>(r.data + pos + 9);
    uint32_t h = fnv32a(kFnvOffset, r.data + pos, 9);
    if (op == kOpAdd || op == kOpRemove) {
      if (h != chk) break;
      record();
      if (op == kOpAdd)
        add(value);
      else
        remove(value);
      (*op_count)++;
      pos += 13;
    } else if (op == kOpAddBatch || op == kOpRemoveBatch) {
      if (value > r.len / 8) break;  // value*8 must not wrap
      size_t payload = size_t(value) * 8;
      if (!r.ok(pos + 13, payload)) break;
      if (fnv32a(h, r.data + pos + 13, payload) != chk) break;
      record();
      for (uint64_t i = 0; i < value; i++) {
        uint64_t v = load_le<uint64_t>(r.data + pos + 13 + 8 * i);
        if (op == kOpAddBatch)
          add(v);
        else
          remove(v);
      }
      *op_count += value;
      pos += 13 + payload;
    } else if (op == kOpAddRoaring || op == kOpRemoveRoaring) {
      if (value > r.len) break;  // 4+value must not wrap
      if (!r.ok(pos + 13, 4) || !r.ok(pos + 17, value)) break;
      uint32_t h2 = fnv32a(h, r.data + pos + 13, 4);  // opN tail
      if (fnv32a(h2, r.data + pos + 17, value) != chk) break;
      uint32_t op_n = load_le<uint32_t>(r.data + pos + 13);
      std::vector<uint64_t> sub;
      uint64_t sub_ops = 0;
      if (!deserialize_any(r.data + pos + 17, value, &sub, &sub_ops)) break;
      record();
      for (uint64_t v : sub) {
        if (op == kOpAddRoaring)
          add(v);
        else
          remove(v);
      }
      *op_count += op_n;
      pos += 17 + value;
    } else {
      break;
    }
  }
}

void apply_ops(const Reader& r, size_t pos, std::vector<uint64_t>* positions,
               uint64_t* op_count) {
  std::set<uint64_t> cur;
  bool live = false;  // the set is built at the first valid record
  walk_ops(
      r, pos,
      [&]() {
        if (!live) {
          cur.insert(positions->begin(), positions->end());
          live = true;
        }
      },
      [&](uint64_t v) { cur.insert(v); }, [&](uint64_t v) { cur.erase(v); },
      op_count);
  if (live) positions->assign(cur.begin(), cur.end());
}

// -- container walks --------------------------------------------------------

// Each container of a Pilosa file in header order:
// ``fn(key, type, card, off, run_is_len, &end)`` reads one (false on a
// parse error). ``*data_end`` is where the op log starts.
template <typename F>
bool walk_pilosa(const Reader& r, F&& fn, size_t* data_end) {
  uint32_t cookie = load_le<uint32_t>(r.data);
  if (((cookie >> 16) & 0xFF) != 0) return false;  // storage version
  uint32_t count = load_le<uint32_t>(r.data + 4);
  size_t pos = 8;
  if (!r.ok(pos, 12ul * count + 4ul * count)) return false;
  size_t off_header = pos + 12ul * count;
  *data_end = off_header + 4ul * count;
  for (uint32_t i = 0; i < count; i++) {
    uint64_t key = load_le<uint64_t>(r.data + pos + 12ul * i);
    uint16_t type = load_le<uint16_t>(r.data + pos + 12ul * i + 8);
    uint32_t card = uint32_t(load_le<uint16_t>(r.data + pos + 12ul * i + 10)) + 1;
    uint32_t off = load_le<uint32_t>(r.data + off_header + 4ul * i);
    size_t end = 0;
    if (!fn(key, type, card, size_t(off), false, &end)) return false;
    *data_end = std::max(*data_end, end);
  }
  return true;
}

// The same over an official-format file (16-bit keys, no op log).
template <typename F>
bool walk_official(const Reader& r, F&& fn) {
  uint32_t cookie = load_le<uint32_t>(r.data);
  uint16_t magic = cookie & 0xFFFF;
  size_t pos = 4;
  uint32_t count;
  std::vector<bool> is_run;
  if (magic == kCookieRun) {
    count = (cookie >> 16) + 1;
    size_t bitset_len = (count + 7) / 8;
    if (!r.ok(pos, bitset_len)) return false;
    is_run.resize(count);
    for (uint32_t i = 0; i < count; i++)
      is_run[i] = (r.data[pos + i / 8] >> (i % 8)) & 1;
    pos += bitset_len;
  } else {
    if (!r.ok(pos, 4)) return false;
    count = load_le<uint32_t>(r.data + pos);
    pos += 4;
    is_run.assign(count, false);
  }
  if (!r.ok(pos, 4ul * count)) return false;
  std::vector<uint16_t> keys(count);
  std::vector<uint32_t> cards(count);
  for (uint32_t i = 0; i < count; i++) {
    keys[i] = load_le<uint16_t>(r.data + pos + 4ul * i);
    cards[i] = uint32_t(load_le<uint16_t>(r.data + pos + 4ul * i + 2)) + 1;
  }
  pos += 4ul * count;
  bool has_offsets = magic == kCookieNoRun || count >= 4;
  std::vector<uint32_t> offsets;
  if (has_offsets) {
    if (!r.ok(pos, 4ul * count)) return false;
    offsets.resize(count);
    for (uint32_t i = 0; i < count; i++)
      offsets[i] = load_le<uint32_t>(r.data + pos + 4ul * i);
    pos += 4ul * count;
  }
  size_t cur = pos;
  for (uint32_t i = 0; i < count; i++) {
    size_t off = has_offsets ? offsets[i] : cur;
    size_t end = 0;
    bool ok = is_run[i]
                  ? fn(uint64_t(keys[i]), kTypeRun, cards[i], off, true, &end)
                  : fn(uint64_t(keys[i]),
                       cards[i] <= kArrayMaxSize ? kTypeArray : kTypeBitmap,
                       cards[i], off, false, &end);
    if (!ok) return false;
    cur = end;
  }
  return true;
}

// Either format: ``*has_ops`` is set for a Pilosa file, whose op log
// starts at ``*data_end``.
template <typename F>
bool walk_file(const Reader& r, F&& fn, bool* has_ops, size_t* data_end) {
  if (r.len < 8) return false;
  uint16_t magic = load_le<uint32_t>(r.data) & 0xFFFF;
  *has_ops = magic == kMagic;
  if (magic == kMagic) return walk_pilosa(r, fn, data_end);
  if (magic == kCookieNoRun || magic == kCookieRun) return walk_official(r, fn);
  return false;
}

// -- top-level readers ------------------------------------------------------

bool deserialize_any(const uint8_t* data, size_t len,
                     std::vector<uint64_t>* out, uint64_t* op_count) {
  Reader r{data, len};
  if (len >= 8 && (load_le<uint32_t>(data) & 0xFFFF) == kMagic) {
    uint32_t count = load_le<uint32_t>(data + 4);
    if (r.ok(8, 16ul * count)) {  // one allocation for every position
      size_t total = 0;
      for (uint32_t i = 0; i < count; i++)
        total += size_t(load_le<uint16_t>(data + 8 + 12ul * i + 10)) + 1;
      out->reserve(out->size() + total);
    }
  }
  bool has_ops = false;
  size_t data_end = 0;
  auto fn = [&](uint64_t key, uint16_t type, uint32_t card, size_t off,
                bool run_is_len, size_t* end) {
    return decode_container(r, key, type, card, off, run_is_len, out, end);
  };
  if (!walk_file(r, fn, &has_ops, &data_end)) return false;
  if (has_ops) apply_ops(r, data_end, out, op_count);
  return true;
}

// -- word decode (the port's open path) -------------------------------------

// The dense words of one fragment: rows ``ids`` (ascending) of ``n_words``
// uint32 words each, at shard width ``width`` = 32 * n_words.
struct WordRows {
  const uint64_t* ids;
  size_t n;
  uint64_t n_words;
  uint64_t width;
  uint32_t* words;
  size_t last = 0;  // the row found last: runs of one row skip the search

  uint32_t* row(uint64_t rid) {
    if (last < n && ids[last] == rid) return words + last * n_words;
    const uint64_t* it = std::lower_bound(ids, ids + n, rid);
    if (it == ids + n || *it != rid) return nullptr;
    last = size_t(it - ids);
    return words + last * n_words;
  }
  void set(uint64_t pos) {
    uint32_t* w = row(pos / width);
    uint64_t c = pos % width;
    if (w) w[c >> 5] |= uint32_t(1) << (c & 31);
  }
  void clear(uint64_t pos) {
    uint32_t* w = row(pos / width);
    uint64_t c = pos % width;
    if (w) w[c >> 5] &= ~(uint32_t(1) << (c & 31));
  }
};

// The rows a file's bits can fall in, ascending and unique: the rows of
// its containers and of its op log's adds (a row whose bits the log removes
// stays a candidate; the caller drops rows left empty).
bool decode_rows(const Reader& r, uint64_t width, std::vector<uint64_t>* rows,
                 uint64_t* op_count) {
  std::vector<uint64_t> scratch;
  bool aligned = width % 65536 == 0;  // a container lies in one row
  auto fn = [&](uint64_t key, uint16_t type, uint32_t card, size_t off,
                bool run_is_len, size_t* end) {
    if (aligned) {  // (an official run container has the same size)
      if (!container_end(r, type, card, off, end)) return false;
      rows->push_back((key << 16) / width);
      return true;
    }
    scratch.clear();
    if (!decode_container(r, key, type, card, off, run_is_len, &scratch, end))
      return false;
    for (uint64_t v : scratch) rows->push_back(v / width);
    return true;
  };
  bool has_ops = false;
  size_t data_end = 0;
  if (!walk_file(r, fn, &has_ops, &data_end)) return false;
  if (has_ops)
    walk_ops(
        r, data_end, []() {}, [&](uint64_t v) { rows->push_back(v / width); },
        [](uint64_t) {}, op_count);
  std::sort(rows->begin(), rows->end());
  rows->erase(std::unique(rows->begin(), rows->end()), rows->end());
  return true;
}

// OR a file's containers into ``rows``' words, then replay its op log on
// them.
bool decode_words(const Reader& r, WordRows* rows, uint64_t* op_count) {
  std::vector<uint64_t> scratch;
  bool aligned = rows->width % 65536 == 0;
  auto fn = [&](uint64_t key, uint16_t type, uint32_t card, size_t off,
                bool run_is_len, size_t* end) {
    if (aligned && type == kTypeBitmap) {
      // the container is 2048 consecutive words of one row
      if (!r.ok(off, 8192)) return false;
      uint64_t base = key << 16;
      uint32_t* w = rows->row(base / rows->width);
      if (w) {
        w += (base % rows->width) / 32;
        for (size_t i = 0; i < 2048; i++)
          w[i] |= load_le<uint32_t>(r.data + off + 4 * i);
      }
      *end = off + 8192;
      return true;
    }
    scratch.clear();
    if (!decode_container(r, key, type, card, off, run_is_len, &scratch, end))
      return false;
    for (uint64_t v : scratch) rows->set(v);
    return true;
  };
  bool has_ops = false;
  size_t data_end = 0;
  if (!walk_file(r, fn, &has_ops, &data_end)) return false;
  if (has_ops)
    walk_ops(
        r, data_end, []() {}, [&](uint64_t v) { rows->set(v); },
        [&](uint64_t v) { rows->clear(v); }, op_count);
  return true;
}

// -- serializer -------------------------------------------------------------

struct Header {
  uint64_t key;
  uint16_t type;
  uint16_t card_minus_1;
};

// Encode one container from its SORTED low-16 values and run count;
// smallest encoding wins, ties keep the earlier candidate in
// array < run < bitmap order (mirrors the Python serializer's min()
// over (size, type) tuples).
void emit_container(uint64_t key, const std::vector<uint16_t>& vals,
                    size_t run_count, std::vector<Header>* headers,
                    std::vector<std::vector<uint8_t>>* datas) {
  size_t n = vals.size();
  size_t array_size = 2 * n;
  size_t run_size = 2 + 4 * run_count;
  size_t bitmap_size = 8192;
  size_t inf = size_t(1) << 30;
  uint16_t type = kTypeArray;
  size_t best = n <= kArrayMaxSize ? array_size : inf;
  size_t run_eff = run_count <= kRunMaxSize ? run_size : inf;
  if (run_eff < best) {
    best = run_eff;
    type = kTypeRun;
  }
  if (bitmap_size < best) {
    best = bitmap_size;
    type = kTypeBitmap;
  }

  std::vector<uint8_t> data;
  if (type == kTypeArray) {
    data.resize(2 * n);
    std::memcpy(data.data(), vals.data(), 2 * n);  // little-endian host
  } else if (type == kTypeRun) {
    push_le<uint16_t>(data, uint16_t(run_count));
    uint16_t start = vals[0];
    for (size_t k = 1; k <= n; k++) {
      if (k == n || vals[k] != uint16_t(vals[k - 1] + 1)) {
        push_le<uint16_t>(data, start);
        push_le<uint16_t>(data, vals[k - 1]);
        if (k < n) start = vals[k];
      }
    }
  } else {
    data.assign(8192, 0);
    for (uint16_t v : vals) data[v >> 3] |= uint8_t(1) << (v & 7);
  }
  headers->push_back({key, type, uint16_t(n - 1)});
  datas->push_back(std::move(data));
}

void assemble(const std::vector<Header>& headers,
              const std::vector<std::vector<uint8_t>>& datas, uint8_t flags,
              std::vector<uint8_t>* out);

void serialize_positions(std::vector<uint64_t> positions, uint8_t flags,
                         std::vector<uint8_t>* out) {
  std::sort(positions.begin(), positions.end());
  positions.erase(std::unique(positions.begin(), positions.end()),
                  positions.end());

  std::vector<Header> headers;
  std::vector<std::vector<uint8_t>> datas;

  std::vector<uint16_t> vals;
  size_t i = 0;
  while (i < positions.size()) {
    uint64_t key = positions[i] >> 16;
    size_t j = i;
    while (j < positions.size() && (positions[j] >> 16) == key) j++;
    size_t n = j - i;
    // count runs of consecutive low-16 values
    size_t run_count = 1;
    for (size_t k = i + 1; k < j; k++)
      if (positions[k] != positions[k - 1] + 1) run_count++;
    vals.clear();
    vals.reserve(n);
    for (size_t k = i; k < j; k++)
      vals.push_back(uint16_t(positions[k] & 0xFFFF));
    emit_container(key, vals, run_count, &headers, &datas);
    i = j;
  }
  assemble(headers, datas, flags, out);
}

// Serialize straight from dense row words — the snapshot hot path
// (reference unprotectedWriteToFragment -> Bitmap.WriteTo walks its
// containers the same way; here the containers are STREAMED off the
// mirror words, so no 8-bytes-per-bit position array is ever
// materialized).  ``slots[r]`` selects the word row for ascending
// ``row_ids[r]``; byte output is identical to serialize_positions on
// the extracted positions.
// One 65536-bit container straight from its 2048 aligned words:
// popcount + run starts are counted WORDWISE (a run start is a set bit
// whose predecessor bit is clear: x & ~(x<<1 | carry)), the bitmap
// payload is a straight memcpy, and the per-bit ctz walk only runs for
// the small array/run winners.
void emit_block(uint64_t key, const uint32_t* blk, std::vector<Header>* headers,
                std::vector<std::vector<uint8_t>>* datas,
                std::vector<uint16_t>* scratch) {
  size_t n = 0, runs = 0;
  uint64_t carry = 0;
  for (size_t w = 0; w < 2048; w += 2) {
    uint64_t x;  // two consecutive uint32 words; little-endian keeps
    std::memcpy(&x, blk + w, 8);  // bit k == column (w*32 + k)
    if (!x) {  // sparse rows skip at one compare per 8 bytes
      carry = 0;
      continue;
    }
    n += __builtin_popcountll(x);
    runs += __builtin_popcountll(x & ~((x << 1) | carry));
    carry = x >> 63;
  }
  if (n == 0) return;
  size_t array_size = 2 * n;
  size_t run_size = 2 + 4 * runs;
  size_t inf = size_t(1) << 30;
  size_t best_array = n <= kArrayMaxSize ? array_size : inf;
  size_t best_run = runs <= kRunMaxSize ? run_size : inf;
  if (size_t(8192) < best_array && size_t(8192) < best_run) {
    // bitmap wins: payload is the words verbatim
    std::vector<uint8_t> data(8192);
    std::memcpy(data.data(), blk, 8192);
    headers->push_back({key, kTypeBitmap, uint16_t(n - 1)});
    datas->push_back(std::move(data));
    return;
  }
  scratch->clear();
  scratch->reserve(n);
  for (size_t w = 0; w < 2048; w++) {
    uint32_t x = blk[w];
    while (x) {
      scratch->push_back(uint16_t(w * 32 + __builtin_ctz(x)));
      x &= x - 1;
    }
  }
  emit_container(key, *scratch, runs, headers, datas);
}

void serialize_words(const uint64_t* row_ids, const int64_t* slots,
                     size_t n_rows, const uint32_t* words, int64_t n_words,
                     uint8_t flags, std::vector<uint8_t>* out) {
  std::vector<Header> headers;
  std::vector<std::vector<uint8_t>> datas;

  if (n_words % 2048 == 0) {
    // rows are whole containers (the default 2^20-bit shard width is
    // 32768 words = 16 containers per row): stream container-aligned
    // blocks, no cross-row state
    std::vector<uint16_t> scratch;
    for (size_t r = 0; r < n_rows; r++) {
      uint64_t base_key = row_ids[r] * uint64_t(n_words) / 2048;
      const uint32_t* row = words + slots[r] * n_words;
      for (int64_t blk = 0; blk < n_words / 2048; blk++) {
        emit_block(base_key + uint64_t(blk), row + blk * 2048, &headers,
                   &datas, &scratch);
      }
    }
    assemble(headers, datas, flags, out);
    return;
  }

  uint64_t cur_key = ~uint64_t(0);
  std::vector<uint16_t> vals;
  size_t run_count = 0;
  auto flush = [&]() {
    if (!vals.empty()) {
      emit_container(cur_key, vals, run_count, &headers, &datas);
      vals.clear();
    }
  };
  for (size_t r = 0; r < n_rows; r++) {
    uint64_t base = row_ids[r] * uint64_t(n_words) * 32;
    const uint32_t* row = words + slots[r] * n_words;
    for (int64_t w = 0; w < n_words; w++) {
      uint32_t word = row[w];
      if (!word) continue;
      uint64_t wbase = base + uint64_t(w) * 32;
      while (word) {
        int b = __builtin_ctz(word);
        word &= word - 1;
        uint64_t pos = wbase + b;
        uint64_t key = pos >> 16;
        uint16_t v = uint16_t(pos & 0xFFFF);
        if (key != cur_key) {
          flush();
          cur_key = key;
          run_count = 1;
        } else if (v != uint16_t(vals.back() + 1)) {
          run_count++;
        }
        vals.push_back(v);
      }
    }
  }
  flush();
  assemble(headers, datas, flags, out);
}

void assemble(const std::vector<Header>& headers,
              const std::vector<std::vector<uint8_t>>& datas, uint8_t flags,
              std::vector<uint8_t>* out) {
  uint32_t count = headers.size();
  push_le<uint32_t>(*out, uint32_t(kMagic) | (uint32_t(flags) << 24));
  push_le<uint32_t>(*out, count);
  for (const auto& h : headers) {
    push_le<uint64_t>(*out, h.key);
    push_le<uint16_t>(*out, h.type);
    push_le<uint16_t>(*out, h.card_minus_1);
  }
  uint32_t offset = 8 + count * 12 + count * 4;
  for (const auto& d : datas) {
    push_le<uint32_t>(*out, offset);
    offset += d.size();
  }
  for (const auto& d : datas)
    out->insert(out->end(), d.begin(), d.end());
}

}  // namespace

// -- C ABI ------------------------------------------------------------------

extern "C" {

// Returns 0 on success. *out is malloc'd; free with rt_free.
int rt_serialize(const uint64_t* positions, size_t n, uint8_t flags,
                 uint8_t** out, size_t* out_len) {
  std::vector<uint8_t> buf;
  serialize_positions(std::vector<uint64_t>(positions, positions + n), flags,
                      &buf);
  *out = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
  if (!*out) return 2;
  std::memcpy(*out, buf.data(), buf.size());
  *out_len = buf.size();
  return 0;
}

// Serialize straight from dense row words (see serialize_words).
// Returns 0 on success. *out is malloc'd; free with rt_free.
int rt_serialize_words(const uint64_t* row_ids, const int64_t* slots,
                       size_t n_rows, const uint8_t* words, int64_t n_words,
                       uint8_t flags, uint8_t** out, size_t* out_len) {
  std::vector<uint8_t> buf;
  serialize_words(row_ids, slots, n_rows,
                  reinterpret_cast<const uint32_t*>(words), n_words, flags,
                  &buf);
  *out = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
  if (!*out) return 2;
  std::memcpy(*out, buf.data(), buf.size());
  *out_len = buf.size();
  return 0;
}

// Returns 0 on success, 1 on parse error. *out is malloc'd uint64 array.
int rt_deserialize(const uint8_t* data, size_t len, uint64_t** out,
                   size_t* out_n, uint64_t* op_count) {
  std::vector<uint64_t> positions;
  uint64_t ops = 0;
  if (!deserialize_any(data, len, &positions, &ops)) return 1;
  *out = static_cast<uint64_t*>(
      std::malloc(positions.size() ? positions.size() * 8 : 1));
  if (!*out) return 2;
  std::memcpy(*out, positions.data(), positions.size() * 8);
  *out_n = positions.size();
  *op_count = ops;
  return 0;
}

// Decode straight into a caller-owned buffer (the ingest staging path:
// the positions land in a reusable pinned buffer, no malloc/copy pair
// per batch).  Returns 0 on success, 1 on parse error, 3 when the
// buffer is too small — *out_n then holds the required capacity so the
// caller can grow and retry.
int rt_deserialize_into(const uint8_t* data, size_t len, uint64_t* out,
                        size_t cap, size_t* out_n, uint64_t* op_count) {
  std::vector<uint64_t> positions;
  uint64_t ops = 0;
  if (!deserialize_any(data, len, &positions, &ops)) return 1;
  *out_n = positions.size();
  *op_count = ops;
  if (positions.size() > cap) return 3;
  std::memcpy(out, positions.data(), positions.size() * 8);
  return 0;
}

// Pass one of the word decode: the candidate row ids of a file at shard
// width ``width`` (ascending; *out is malloc'd, free with rt_free) and its
// op count. Returns 0 on success, 1 on a parse error.
int rt_decode_rows(const uint8_t* data, size_t len, uint64_t width,
                   uint64_t** out, size_t* out_n, uint64_t* op_count) {
  if (width == 0) return 1;
  std::vector<uint64_t> rows;
  uint64_t ops = 0;
  if (!decode_rows(Reader{data, len}, width, &rows, &ops)) return 1;
  *out = static_cast<uint64_t*>(std::malloc(rows.size() ? rows.size() * 8 : 1));
  if (!*out) return 2;
  std::memcpy(*out, rows.data(), rows.size() * 8);
  *out_n = rows.size();
  *op_count = ops;
  return 0;
}

// Pass two: OR the file's bits into the caller's zeroed uint32 words
// [n_rows, n_words] (row r holds row id row_ids[r], ascending) and replay
// its op log on them. Returns 0 on success, 1 on a parse error.
int rt_decode_words(const uint8_t* data, size_t len, const uint64_t* row_ids,
                    size_t n_rows, int64_t n_words, uint8_t* words,
                    uint64_t* op_count) {
  if (n_words <= 0) return 1;
  WordRows rows{row_ids, n_rows, uint64_t(n_words), uint64_t(n_words) * 32,
                reinterpret_cast<uint32_t*>(words)};
  uint64_t ops = 0;
  if (!decode_words(Reader{data, len}, &rows, &ops)) return 1;
  *op_count = ops;
  return 0;
}

uint32_t rt_fnv32a(const uint8_t* data, size_t len, uint32_t h) {
  // exposed for the op-log writer: the Python FNV loop is ~7 MB/s and
  // dominates sustained-ingest batches (encode_op checksums)
  return fnv32a(h, data, len);
}

size_t rt_encode_batch_ops(uint8_t op_type, const uint64_t* pos, size_t n, size_t chunk,
                           uint8_t* out) {
  // The op records of `pos` in chunks of `chunk` positions, back to back in
  // `out` (13 bytes of head and checksum a record plus 8 a position); the
  // bytes encode_op writes chunk by chunk. FNV-1a is serial within a
  // record, so the checksums of 8 equal-length records run interleaved:
  // one multiply's latency hides the others'.
  if (chunk == 0) return 0;
  const size_t n_rec = (n + chunk - 1) / chunk;
  const size_t stride = 13 + 8 * chunk;
  for (size_t r = 0; r < n_rec; r++) {
    uint8_t* rec = out + r * stride;
    const size_t len = std::min(chunk, n - r * chunk);
    rec[0] = op_type;
    for (int b = 0; b < 8; b++) rec[1 + b] = uint8_t(uint64_t(len) >> (8 * b));
    const uint64_t* src = pos + r * chunk;
    uint8_t* dst = rec + 13;
    for (size_t i = 0; i < len; i++)
      for (int b = 0; b < 8; b++) dst[8 * i + b] = uint8_t(src[i] >> (8 * b));
  }
  auto put = [&](size_t r, uint32_t h) {
    for (int b = 0; b < 4; b++) out[r * stride + 9 + b] = uint8_t(h >> (8 * b));
  };
  const size_t full = n / chunk;  // records of exactly `chunk` positions
  const size_t bytes = 8 * chunk;
  size_t r = 0;
  for (; r + 8 <= full; r += 8) {
    const uint8_t* __restrict p0 = out + (r + 0) * stride;
    const uint8_t* __restrict p1 = out + (r + 1) * stride;
    const uint8_t* __restrict p2 = out + (r + 2) * stride;
    const uint8_t* __restrict p3 = out + (r + 3) * stride;
    const uint8_t* __restrict p4 = out + (r + 4) * stride;
    const uint8_t* __restrict p5 = out + (r + 5) * stride;
    const uint8_t* __restrict p6 = out + (r + 6) * stride;
    const uint8_t* __restrict p7 = out + (r + 7) * stride;
    uint32_t h0 = fnv32a(kFnvOffset, p0, 9), h1 = fnv32a(kFnvOffset, p1, 9);
    uint32_t h2 = fnv32a(kFnvOffset, p2, 9), h3 = fnv32a(kFnvOffset, p3, 9);
    uint32_t h4 = fnv32a(kFnvOffset, p4, 9), h5 = fnv32a(kFnvOffset, p5, 9);
    uint32_t h6 = fnv32a(kFnvOffset, p6, 9), h7 = fnv32a(kFnvOffset, p7, 9);
    for (size_t i = 13; i < 13 + bytes; i++) {
      h0 = (h0 ^ p0[i]) * 0x01000193u;
      h1 = (h1 ^ p1[i]) * 0x01000193u;
      h2 = (h2 ^ p2[i]) * 0x01000193u;
      h3 = (h3 ^ p3[i]) * 0x01000193u;
      h4 = (h4 ^ p4[i]) * 0x01000193u;
      h5 = (h5 ^ p5[i]) * 0x01000193u;
      h6 = (h6 ^ p6[i]) * 0x01000193u;
      h7 = (h7 ^ p7[i]) * 0x01000193u;
    }
    put(r + 0, h0); put(r + 1, h1); put(r + 2, h2); put(r + 3, h3);
    put(r + 4, h4); put(r + 5, h5); put(r + 6, h6); put(r + 7, h7);
  }
  for (; r < n_rec; r++) {
    const uint8_t* rec = out + r * stride;
    const size_t len = std::min(chunk, n - r * chunk);
    put(r, fnv32a(fnv32a(kFnvOffset, rec, 9), rec + 13, 8 * len));
  }
  return n_rec * 13 + 8 * n;
}

uint64_t rt_popcount(const uint8_t* data, size_t len) {
  uint64_t total = 0;
  size_t i = 0;
  for (; i + 8 <= len; i += 8)
    total += __builtin_popcountll(load_le<uint64_t>(data + i));
  for (; i < len; i++) total += __builtin_popcount(data[i]);
  return total;
}

void rt_free(void* p) { std::free(p); }

}  // extern "C"
