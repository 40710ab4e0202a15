// Host latency-tier bitmap kernels (a copy of the JAX package's
// native/hostops.cpp).
//
// The serving architecture splits by regime: the card runs the
// throughput tier (batched gram launches, full-index scans —
// pilosa_tpu_torch/ops/kernels.py), while a LONE cold query is answered
// from the fragment's authoritative host mirror, because a single
// row-pair count moves ~2 rows * n_shards of words and a host memory
// pass beats a stack build, a launch and a result copy at that size.
// The reference serves the same shape from its roaring word loops
// (reference roaring.go:568 intersectionCountBitmapBitmap,
// roaring.go:5057 popcount); these are the dense-word equivalents,
// fused (no AND temporary) and threaded across shards by the caller
// (ctypes releases the GIL, so Python-thread fan-out scales on
// multi-core hosts).
//
// C ABI only — bound via ctypes (pilosa_tpu_torch/ops/_hostops.py), built
// by pilosa_tpu_torch/nativelib.py into build/native/<hash>/.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

inline uint64_t load64(const uint8_t* p) {
    uint64_t x;
    std::memcpy(&x, p, 8);  // unaligned-safe; compiles to one mov
    return x;
}

inline uint64_t popcnt(uint64_t x) {
#if defined(__GNUC__) || defined(__clang__)
    return static_cast<uint64_t>(__builtin_popcountll(x));
#else
    x = x - ((x >> 1) & 0x5555555555555555ULL);
    x = (x & 0x3333333333333333ULL) + ((x >> 2) & 0x3333333333333333ULL);
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0FULL;
    return (x * 0x0101010101010101ULL) >> 56;
#endif
}

enum Op { OP_AND = 0, OP_OR = 1, OP_ANDNOT = 2, OP_XOR = 3 };

inline uint64_t apply(uint64_t a, uint64_t b, int op) {
    switch (op) {
        case OP_AND: return a & b;
        case OP_OR: return a | b;
        case OP_ANDNOT: return a & ~b;
        default: return a ^ b;
    }
}

// Fused op+popcount over n_words uint32 words (single pass, no
// temporary).  Unrolled 4x64-bit; the tail runs word-at-a-time.
template <int OP>
uint64_t pair_count_t(const uint8_t* a, const uint8_t* b, size_t n_words) {
    size_t n8 = n_words / 2;  // 64-bit lanes
    size_t i = 0;
    uint64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (; i + 4 <= n8; i += 4) {
        c0 += popcnt(apply(load64(a + 8 * i), load64(b + 8 * i), OP));
        c1 += popcnt(apply(load64(a + 8 * (i + 1)), load64(b + 8 * (i + 1)), OP));
        c2 += popcnt(apply(load64(a + 8 * (i + 2)), load64(b + 8 * (i + 2)), OP));
        c3 += popcnt(apply(load64(a + 8 * (i + 3)), load64(b + 8 * (i + 3)), OP));
    }
    uint64_t c = c0 + c1 + c2 + c3;
    for (; i < n8; i++) {
        c += popcnt(apply(load64(a + 8 * i), load64(b + 8 * i), OP));
    }
    if (n_words & 1) {  // odd uint32 tail
        uint32_t xa, xb;
        std::memcpy(&xa, a + 8 * n8, 4);
        std::memcpy(&xb, b + 8 * n8, 4);
        c += popcnt(apply(xa, xb, OP));
    }
    return c;
}

}  // namespace

extern "C" {

// popcount of n_words uint32 words
uint64_t ph_popcount(const uint8_t* a, size_t n_words) {
    size_t n8 = n_words / 2;
    size_t i = 0;
    uint64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (; i + 4 <= n8; i += 4) {
        c0 += popcnt(load64(a + 8 * i));
        c1 += popcnt(load64(a + 8 * (i + 1)));
        c2 += popcnt(load64(a + 8 * (i + 2)));
        c3 += popcnt(load64(a + 8 * (i + 3)));
    }
    uint64_t c = c0 + c1 + c2 + c3;
    for (; i < n8; i++) c += popcnt(load64(a + 8 * i));
    if (n_words & 1) {
        uint32_t x;
        std::memcpy(&x, a + 8 * n8, 4);
        c += popcnt(x);
    }
    return c;
}

// fused op(a,b)+popcount; op: 0=and 1=or 2=andnot 3=xor
uint64_t ph_pair_count(const uint8_t* a, const uint8_t* b, size_t n_words,
                       int op) {
    switch (op) {
        case OP_AND: return pair_count_t<OP_AND>(a, b, n_words);
        case OP_OR: return pair_count_t<OP_OR>(a, b, n_words);
        case OP_ANDNOT: return pair_count_t<OP_ANDNOT>(a, b, n_words);
        default: return pair_count_t<OP_XOR>(a, b, n_words);
    }
}

// op(a,b) materialized into out (for host Row algebra without numpy's
// ufunc dispatch overhead on the hot path); out may alias a.
void ph_pair_op(const uint8_t* a, const uint8_t* b, uint8_t* out,
                size_t n_words, int op) {
    size_t n8 = n_words / 2;
    for (size_t i = 0; i < n8; i++) {
        uint64_t r = apply(load64(a + 8 * i), load64(b + 8 * i), op);
        std::memcpy(out + 8 * i, &r, 8);
    }
    if (n_words & 1) {
        uint32_t xa, xb;
        std::memcpy(&xa, a + 8 * n8, 4);
        std::memcpy(&xb, b + 8 * n8, 4);
        uint32_t r = static_cast<uint32_t>(
            apply(xa, xb, op) & 0xFFFFFFFFULL);
        std::memcpy(out + 8 * n8, &r, 4);
    }
}

// Extract set-bit offsets of an n_words uint32 vector into out
// (caller sized it via ph_popcount), each offset + base.  The
// classic ctz loop — the hot part of snapshot encoding and op-record
// position extraction (reference roaring.go walks containers the same
// way when it serializes).  Bit addressing: word w bit b -> w*32+b,
// which under little-endian 64-bit lanes is lane*64 + ctz.
size_t ph_extract(const uint8_t* words, size_t n_words, uint64_t base,
                  uint64_t* out) {
    size_t k = 0;
    size_t n8 = n_words / 2;
    for (size_t i = 0; i < n8; i++) {
        uint64_t x = load64(words + 8 * i);
        while (x) {
#if defined(__GNUC__) || defined(__clang__)
            uint64_t b = static_cast<uint64_t>(__builtin_ctzll(x));
#else
            uint64_t b = 0;
            while (!((x >> b) & 1)) b++;
#endif
            out[k++] = base + i * 64 + b;
            x &= x - 1;
        }
    }
    if (n_words & 1) {
        uint32_t x;
        std::memcpy(&x, words + 8 * n8, 4);
        while (x) {
#if defined(__GNUC__) || defined(__clang__)
            uint32_t b = static_cast<uint32_t>(__builtin_ctz(x));
#else
            uint32_t b = 0;
            while (!((x >> b) & 1)) b++;
#endif
            out[k++] = base + n8 * 64 + b;
            x &= x - 1;
        }
    }
    return k;
}

// The set bits of a word vector as JSON list text: each offset + base in
// decimal followed by ", " (the caller drops the last separator; it sized
// ``out`` from ph_popcount and the widest number).  The body of a bitmap
// answer's "columns" list, as json.dumps writes it.  Returns bytes written.
static inline char* put_u64(char* o, uint64_t v) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = static_cast<char>('0' + v % 10);
        v /= 10;
    } while (v);
    while (n) *o++ = tmp[--n];
    *o++ = ',';
    *o++ = ' ';
    return o;
}

size_t ph_columns_text(const uint8_t* words, size_t n_words, uint64_t base,
                       char* out) {
    char* o = out;
    size_t n8 = n_words / 2;
    for (size_t i = 0; i < n8; i++) {
        uint64_t x = load64(words + 8 * i);
        while (x) {
            o = put_u64(o, base + i * 64 +
                               static_cast<uint64_t>(__builtin_ctzll(x)));
            x &= x - 1;
        }
    }
    if (n_words & 1) {
        uint32_t x;
        std::memcpy(&x, words + 8 * n8, 4);
        while (x) {
            o = put_u64(o, base + n8 * 64 +
                               static_cast<uint64_t>(__builtin_ctz(x)));
            x &= x - 1;
        }
    }
    return static_cast<size_t>(o - out);
}

// One-pass bulk-import merge over SORTED compact keys (row_index *
// width + col, duplicates allowed) — the whole middle of
// Fragment.import_bits (reference fragment.go:2052 importPositions ->
// roaring AddN/RemoveN + changed tracking) as a single native pass:
// sets/clears mirror bits, and emits, in one walk, everything the
// Python layer needs afterwards:
//   wal_pos[c]        changed positions as original-row-id*width+col
//                     (ascending row-major, the op-log record order);
//                     nullable — store-less fragments (ingest staging,
//                     benches) skip the extraction and its allocation
//   perrow[ri]        changed-bit count per row index (TopN maintained
//                     counts + dirty-slot set)
//   changed_words[w]  flat mirror word indices that changed, deduped
//                     (word-granular device delta sync)
// Returns the changed-bit count.  The caller owns bounds: keys must
// lie in [0, n_rows*width) and slots/mirror must cover them.
// ``id_keys``: keys are row_id*width+col (skips the caller-side
// inverse/searchsorted pass entirely); the row index is recovered by a
// binary search over the sorted ``row_ids`` once per ROW RUN — a few
// thousand searches against a million-key pass.  0 means keys are
// row_index*width+col.
int64_t ph_import_merge(const int64_t* keys, size_t n, int64_t width,
                        int64_t n_words, const int64_t* slots,
                        const uint64_t* row_ids, size_t n_rows,
                        int id_keys, uint8_t* mirror, int clear,
                        uint64_t* wal_pos, int64_t* perrow,
                        int64_t* changed_words,
                        int64_t* n_changed_words) {
    uint32_t* m32 = reinterpret_cast<uint32_t*>(mirror);
    int64_t ri = -1;
    int64_t row_lo = 0, row_hi = 0;  // current row's key range
    uint32_t* row_base = nullptr;
    uint64_t wal_base = 0;
    int64_t nc = 0, nw = 0;
    for (size_t i = 0; i < n; i++) {
        int64_t k = keys[i];
        if (k >= row_hi || k < row_lo) {
            int64_t row_of_k = k / width;
            if (id_keys) {
                uint64_t rid = static_cast<uint64_t>(row_of_k);
                size_t lo = 0, hi = n_rows;
                while (lo < hi) {
                    size_t mid = (lo + hi) / 2;
                    if (row_ids[mid] < rid) lo = mid + 1;
                    else hi = mid;
                }
                if (lo >= n_rows || row_ids[lo] != rid) {
                    // row id absent from the fragment's row table: a
                    // caller invariant break.  Skip this row run rather
                    // than index slots[]/row_ids[] out of bounds.
                    ri = -1;
                    row_lo = row_of_k * width;
                    row_hi = row_lo + width;
                    row_base = nullptr;
                    continue;
                }
                ri = static_cast<int64_t>(lo);
            } else {
                ri = row_of_k;
            }
            row_lo = row_of_k * width;
            row_hi = row_lo + width;
            row_base = m32 + slots[ri] * n_words;
            wal_base = row_ids[ri] * static_cast<uint64_t>(width);
        }
        if (row_base == nullptr) continue;  // inside a skipped row run
        int64_t col = k - row_lo;
        int64_t w = col >> 5;
        uint32_t bit = 1u << (col & 31);
        uint32_t& word = row_base[w];
        if (clear) {
            if (!(word & bit)) continue;
            word &= ~bit;
        } else {
            if (word & bit) continue;
            word |= bit;
        }
        if (wal_pos) wal_pos[nc] = wal_base + static_cast<uint64_t>(col);
        perrow[ri]++;
        nc++;
        int64_t flat = slots[ri] * n_words + w;
        if (nw == 0 || changed_words[nw - 1] != flat) {
            changed_words[nw++] = flat;
        }
    }
    *n_changed_words = nw;
    return nc;
}

// Batched fused pair counts over many same-length row pairs — the
// multi-shard latency-tier fan (one call per chunk; the caller spreads
// chunks across Python threads only when cores allow).  Addresses
// arrive as uint64 values in flat arrays (numpy computes
// base+slot*stride vectorized, so Python builds NO per-row ctypes
// objects) and the sum is reduced natively.
uint64_t ph_pair_count_addr(const uint64_t* addr_a, const uint64_t* addr_b,
                            size_t n_pairs, size_t n_words, int op) {
    uint64_t total = 0;
    for (size_t i = 0; i < n_pairs; i++) {
        total += ph_pair_count(
            reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(addr_a[i])),
            reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(addr_b[i])),
            n_words, op);
    }
    return total;
}

}  // extern "C"
