// Tree evaluation: the compiled PQL trees of exec/astbatch.py.
//   pilosa_tree_count: out[b, s] = sum_w popc(tree(leaves of item b)[s, w])
//   pilosa_tree_words: out[s, w] = tree(leaves of one item)[s, w]
// A tree of Row/Intersect/Union/Difference/Xor/Not over field stacks runs
// as a program of steps (ops/kernels.py, tree_steps): push a leaf, fold a
// leaf into the top of the operand stack, or fold the top into the entry
// below it, with AND, OR, XOR, ANDNOT or NOTAND (~a & b). A leaf is a row
// of a stack at the block's shard, or an absent row: a zero leaf, never
// read. exec/astbatch.py orders each program so that it needs at most
// floor(log2(leaves)) + 1 operand-stack entries, so TREE_MAX_DEPTH (32)
// holds every tree; programs of any length and any number of leaves run.
//
// Replaces: pilosa_tpu/exec/astbatch.py, the XLA programs of compiled
// (count mode: _count_scan, a lax.scan over the batch with the tree fused
// per item; bitmap mode: the tree's [S, W] words). No Pallas kernel stands
// behind them.
//
// The count has two routes; the wrapper (ops/kernels.py, tree_plan) picks
// one, and its instance, from the batch's shape before the launch.
//
// Direct route (pilosa_tree_count), for batches whose items share no rows
// (one item of 300 leaves, a lone Count), programs needing more than 2
// operand-stack entries or naming more than 64 leaves, and word-by-word
// rows. The wrapper lists each item's distinct rows once (an item's leaves
// name each of them, any number of times) and writes the item's steps
// against that list. The grid is (item, slice, shard): each shard's words
// are cut into slices (TREE_DIRECT_SLICE_WORDS in ops/kernels.py), items
// fastest so that the blocks in flight share one slice of one shard
// through L2, and each warp adds its count into out[b, s] with atomicAdd
// (exact in any order; the C entry zeroes out first). Two instances:
// - rows (pilosa_tree_rows), where the item's rows fit shared memory (16-
//   byte rows): a block of TREE_ROWS_LANES or half as many lanes walks its
//   slice a chunk at a time (16 bytes of each row a lane); each lane copies
//   its own 16 bytes of every distinct row of the chunk into a ring of 1-4
//   stages by cp.async (no lane waits for another, so a one-stage ring
//   leaves the overlap to the other blocks of the SM) and evaluates every
//   leaf from there, so each distinct row is read from device memory once
//   per (shard, slice) however often the program names it, and an absent
//   leaf names the stage's zero row. The wrapper picks the lanes and stages
//   that put the most warps on an SM. The steps sit in shared memory with
//   each leaf's stage offset; a general program decodes four steps at a
//   time (their four loads in flight), its operand stack below the top in
//   this lane's column of shared memory (any depth, no local memory); a
//   flat chain of one fold of any length (the 300-leaf Union) runs on an
//   instance with the fold fixed at compile time that loads eight leaves
//   before folding them.
// - through L2 (pilosa_tree_l2), for an item of more rows than a block
//   stages and for word-by-word rows: 256 lanes, each evaluating
//   TREE_L2_GROUPS groups (16 bytes, or a word) per decoded step, so that
//   many loads are in flight; the stack below the top in registers for
//   programs of at most 2 entries, else in local memory. The first
//   TREE_SMEM_OPS steps and TREE_SMEM_ROWS row pointers sit in shared
//   memory, the rest of a longer program is read from the table.
// A table of at most TREE_PARAM_BYTES goes to the kernel as its parameter
// (no upload). tree_words runs the through-L2 instance with one item and
// slices of TREE_WORDS_CHUNK words, and stores the words.
//
// Staged route (pilosa_tree_count_staged), for batches whose items share
// rows. The wrapper lists the distinct rows the batch names (one tensor
// passed as several stacks shares its rows), remaps every slot to an index
// into that list, sorts the items by those indices (the leaf with the
// fewest distinct rows first) and cuts them into tiles whose rows fit in
// shared memory. A block owns one tile, one shard and one slice of the
// shard's words (the wrapper cuts each shard into slices of 32 chunks,
// TREE_SLICE_CHUNKS). It walks the slice in chunks of TREE_CHUNK_WORDS (512
// bytes of each row, one warp step of 32 lanes x 16 bytes); each chunk of
// every row of the tile is copied once into a ring of 2-4 shared-memory
// stages by cp.async, and every item of the tile is evaluated from it. A
// warp evaluates a group of TREE_GROUP (8) neighbouring items at a time:
// an opcode is decoded once per group, a leaf that the wrapper marked
// uniform (all 8 items name one row) is loaded once, an absent slot names
// the stage's zero row, and the operand stack (1 or 2 entries a word: the
// route takes programs that need at most 2 with a leaf followed by a fold
// applied to the top) lives in registers. A flat chain of at most 4 steps
// of one fold (Intersect, Union, Xor or Not of rows) runs on an instance
// of its own with the fold fixed at compile time, every step's slots
// loaded first, and the uniform leaves, which the wrapper puts first,
// folded in one register before the chain widens to the 8 items. The
// popcounts run on the tensor cores: the warp's 32 lanes x 4 words of one
// item are the A operand of mma.sync.m16n8k256.and.popc (BMMA), and a B
// operand whose column j is all ones and the rest zeros adds item j's
// popcount into column j of one accumulator shared by the group. Each
// group's accumulator (two int32 a lane) stays in shared memory across
// the slice's chunks; its rows are summed once, after the last chunk, and
// added into out[b, s] with atomicAdd (the wrapper zeroes out). A shard's
// count is at most 32 * W < 2^31 (the wrapper checks W).
//
// Bounds on an H100 (3.35 TB/s, 132 SMs; chip_smoke.py computes each from
// the run's shapes and logs it beside the kernel's time):
// - the staged route at the trees path of chip_smoke.py (1024 items of
//   Intersect(Row(f), Row(g), Row(h)) over two 64-row stacks and a 4-row
//   stack, S = 160, W = 32768): the 132 distinct rows read once and B x S
//   counts written, 2.77 GB, 0.83 ms. Its shared-memory reads (one 512-byte
//   warp row per item and leaf, or one per group for a uniform leaf, 2.1
//   loads per item with the items sorted) take 1.36 ms at 128 bytes per
//   clock per SM, its largest floor; its BMMA popcounts, one per item and
//   chunk, 0.27 ms; and a group's steps are a dependent chain (slots, then
//   rows, then the fold) with only the 16 warps of one block an SM (its
//   stages fill shared memory) to hide it.
// - the direct route at one item of 300 leaves over the same stacks: the
//   item's distinct rows read once, the rows instance's floor and the
//   bound, 0.651 ms for 104 seeded rows and 0.826 ms for the 132 rows of the
//   trees path's Count of a Union of 300 rows. Its shared-memory traffic
//   (the copies in, and a 16-byte read per lane, leaf and chunk) is a 0.25-
//   0.27 ms floor; its popcounts, one __popc per shard and word, 0.001 ms.
//   An item of 104 rows fills 106 KB with one stage of 64 lanes, so two
//   blocks of two warps run on an SM; 132 rows take blocks of 32 lanes,
//   three an SM. Measured on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py, chip_tree_pairs.py): 0.69-0.82 ms and 0.97 ms of device
//   time, against 4.6 and 5.2 ms for the one-block-per-(item, shard) kernel
//   before it. What holds it above its floor is the instruction stream of
//   each warp's copies and leaves, which overlap only across the few warps
//   an SM holds
//   (each row pointer is read before its copy: a copy's memory clobber
//   would hold the next read behind it, which cost a third of the time). A
//   lone three-leaf Count is 0.024 ms (bound 0.019).
//
// Left for later: reuse of rows that neighbouring items share within a
// staged group without the whole group sharing them (the batch above loads
// g and most f rows once per item), a persistent grid (the W split only
// cuts fixed slices), more warps per SM on the staged route (registers and
// the stage ring bound them at 16); on the direct route, TMA bulk copies of
// each row's chunk in place of one cp.async per lane and row (fewer copy
// instructions per warp, the direct route's wall; TMA in place of the
// staged route's ring was slower, as there the copies are not the wall),
// and a split of a flat chain's leaves across the warps of a block (more
// warps an SM on the same stage).

#include <string.h>

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

// Operand-stack entries per word; pilosa_tpu_torch/ops/kernels.py holds the
// same number.
#define TREE_MAX_DEPTH 32
// Step kinds of a program (the wrapper's tree_steps): push leaf l; fold leaf
// l into the top; fold the top into the entry below. A step is kind | fold
// << 2 | operand << 5, the fold 0-4 = AND, OR, XOR, ANDNOT, NOTAND.
#define TREE_PUSH 0
#define TREE_LEAF_FOLD 1
#define TREE_POP_FOLD 2
// A step that does nothing (pads a rows-instance program to whole int4s).
#define TREE_NOP 3
// Dynamic shared memory a block may have on sm_90.
#define TREE_SMEM_LIMIT 232448

template <int F>
__device__ __forceinline__ uint32_t tree_fold(uint32_t a, uint32_t b) {
    return F == 0 ? a & b : F == 1 ? a | b : F == 2 ? a ^ b : F == 3 ? a & ~b : ~a & b;
}

template <int F>
__device__ __forceinline__ uint4 tree_fold(uint4 a, uint4 b) {
    return make_uint4(tree_fold<F>(a.x, b.x), tree_fold<F>(a.y, b.y), tree_fold<F>(a.z, b.z),
                      tree_fold<F>(a.w, b.w));
}

__device__ __forceinline__ int tree_popc(uint32_t v) { return __popc(v); }

__device__ __forceinline__ int tree_popc(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <typename V>
__device__ __forceinline__ V tree_zero();

template <>
__device__ __forceinline__ uint32_t tree_zero<uint32_t>() { return 0u; }

template <>
__device__ __forceinline__ uint4 tree_zero<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }

__host__ __device__ __forceinline__ long long tree_pad16(long long n) {
    return (n + 15) & ~15LL;
}

// Wait for all but the newest n cp.async groups (n < 4).
__device__ __forceinline__ void tree_cp_wait(int n) {
    if (n <= 0) pilosa_cp_wait<0>();
    else if (n == 1) pilosa_cp_wait<1>();
    else if (n == 2) pilosa_cp_wait<2>();
    else pilosa_cp_wait<3>();
}

// Add this warp's sum of v into *dst.
__device__ __forceinline__ void tree_add_count(int v, int32_t* dst) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(dst, v);
}

// ---------------------------------------------------------------------------
// The direct route, and the words
// ---------------------------------------------------------------------------

// Words of a row per chunk of the through-L2 instance: the unit of its W
// split. The rows instance's chunk is one stage row, 16 bytes a lane of its
// block of TREE_ROWS_LANES (or half as many, for items of more rows).
#define TREE_ROW_CHUNK_WORDS 256
#define TREE_ROWS_LANES 64
// The through-L2 instance: threads, groups per lane per decoded step, and
// the steps and row pointers a block stages in shared memory.
#define TREE_L2_THREADS 256
#define TREE_L2_GROUPS 4
#define TREE_SMEM_OPS 512
#define TREE_SMEM_ROWS 256
// Words of a block's slice of pilosa_tree_words.
#define TREE_WORDS_CHUNK 8192
// A table of at most TREE_PARAM_BYTES goes to the kernel as its parameter
// (the C entry copies it from the host at the launch: no upload); a longer
// one is read from device memory. ops/kernels.py holds the same numbers.
#define TREE_PARAM_BYTES 256

// The direct table the wrapper sends (tree_direct_layout), for B items:
//   int64 rowptr[n_rows]     each item's distinct rows, item by item: the
//                            row's word 0 at shard 0
//   int64 rowstride[n_rows]  words from one shard of the row to the next
//   int32 item_rows[B + 1]   item b's rows are [item_rows[b], item_rows[b + 1])
//   int32 steps[B][n_steps]  item b's program; a leaf step's operand is the
//                            row's index among the item's rows, or the
//                            launch's rows_max for an absent row
// and what one block (item b, shard s) reads of it.
struct TreeDirect {
    const long long* rowptr;
    const long long* rowstride;
    const int* steps;  // item b's
    int r0, nb, s;
};

__device__ __forceinline__ TreeDirect tree_direct(const unsigned char* table, int B, int n_rows,
                                                  int n_steps, int b, int s) {
    TreeDirect t;
    t.rowptr = reinterpret_cast<const long long*>(table);
    t.rowstride = t.rowptr + n_rows;
    const int* item_rows = reinterpret_cast<const int*>(t.rowstride + n_rows);
    t.r0 = item_rows[b];
    t.nb = item_rows[b + 1] - t.r0;
    t.steps = item_rows + B + 1 + (size_t)b * n_steps;
    t.s = s;
    return t;
}

// Row r of the item at the block's shard; nullptr past the item's rows (an
// absent leaf).
__device__ __forceinline__ const uint32_t* tree_row(const TreeDirect& t, int r) {
    if (r >= t.nb) return nullptr;
    return reinterpret_cast<const uint32_t*>(t.rowptr[t.r0 + r]) +
           (size_t)t.s * t.rowstride[t.r0 + r];
}

// dst[j] = fold f of (a[j], b[j]); f is warp-uniform.
template <typename V, int K>
__device__ __forceinline__ void tree_fold_k(int f, V (&dst)[K], const V (&a)[K], const V (&b)[K]) {
    switch (f) {
#define TREE_FOLD_CASE(F)                                               \
        case F:                                                         \
            _Pragma("unroll") for (int j = 0; j < K; ++j) dst[j] = tree_fold<F>(a[j], b[j]); \
            break;
        TREE_FOLD_CASE(0)
        TREE_FOLD_CASE(1)
        TREE_FOLD_CASE(2)
        TREE_FOLD_CASE(3)
        default:
            _Pragma("unroll") for (int j = 0; j < K; ++j) dst[j] = tree_fold<4>(a[j], b[j]);
#undef TREE_FOLD_CASE
    }
}

// Group i (of V-sized groups) of a row; zeros for an absent row or a group
// past the slice.
template <typename V>
__device__ __forceinline__ V tree_load(const uint32_t* row, int i, bool ok) {
    if (row == nullptr || !ok) return tree_zero<V>();
    return __ldg(reinterpret_cast<const V*>(row) + i);
}

// The through-L2 instance: the item's program on this lane's
// TREE_L2_GROUPS groups i0, i0 + blockDim.x, ... (those below g1). DEEP:
// the entries below the top in local memory (any depth), else one register.
template <typename V, bool DEEP>
__device__ __forceinline__ void tree_l2_eval(const TreeDirect& t, const int* s_steps,
                                             const uint32_t* const* s_rowp, int n_steps, int i0,
                                             int g1, V (&top)[TREE_L2_GROUPS]) {
    constexpr int K = TREE_L2_GROUPS;
    V below[DEEP ? TREE_MAX_DEPTH - 1 : 1][K];
    int n = 0;
    for (int k = 0; k < n_steps; ++k) {
        const int st = k < TREE_SMEM_OPS ? s_steps[k] : t.steps[k];
        const int kind = st & 3;
        const int f = (st >> 2) & 7;
        if (kind == TREE_POP_FOLD) {
            tree_fold_k(f, top, below[DEEP ? n - 2 : 0], top);
            --n;
            continue;
        }
        const int r = st >> 5;
        const uint32_t* row = r < TREE_SMEM_ROWS ? s_rowp[r] : tree_row(t, r);
        V v[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int i = i0 + j * (int)blockDim.x;
            v[j] = tree_load<V>(row, i, i < g1);
        }
        if (kind == TREE_LEAF_FOLD) {
            tree_fold_k(f, top, top, v);
        } else {
            if (n > 0) {
#pragma unroll
                for (int j = 0; j < K; ++j) below[DEEP ? n - 1 : 0][j] = top[j];
            }
#pragma unroll
            for (int j = 0; j < K; ++j) top[j] = v[j];
            ++n;
        }
    }
}

// One block of the through-L2 instance: item b = blockIdx.x % B, slice
// blockIdx.x / B of `slice` chunks, shard blockIdx.y. WORDS: store the
// words into out[s, w] (int32[S, W]), else add the count into out[b, s].
template <typename V, bool DEEP, bool WORDS>
__device__ __forceinline__ void tree_l2_body(const unsigned char* table, int B, int n_rows,
                                             int n_steps, int S, int W, int rows_max, int slice,
                                             void* out) {
    __shared__ int s_steps[TREE_SMEM_OPS];
    __shared__ const uint32_t* s_rowp[TREE_SMEM_ROWS];
    const int b = blockIdx.x % B;
    const int s = blockIdx.y;
    constexpr int per = (int)(sizeof(V) / 4);
    const int groups = W / per;
    const int g0 = (blockIdx.x / B) * slice * (TREE_ROW_CHUNK_WORDS / per);
    const int g1 = min(groups, g0 + slice * (TREE_ROW_CHUNK_WORDS / per));
    if (g0 >= g1) return;
    const TreeDirect t = tree_direct(table, B, n_rows, n_steps, b, s);
    for (int k = threadIdx.x; k < min(n_steps, TREE_SMEM_OPS); k += blockDim.x)
        s_steps[k] = t.steps[k];
    for (int r = threadIdx.x; r < min(rows_max + 1, TREE_SMEM_ROWS); r += blockDim.x)
        s_rowp[r] = tree_row(t, r);
    __syncthreads();
    int acc = 0;
    for (int i = g0 + threadIdx.x; i < g1; i += TREE_L2_GROUPS * blockDim.x) {
        V top[TREE_L2_GROUPS];
        tree_l2_eval<V, DEEP>(t, s_steps, s_rowp, n_steps, i, g1, top);
#pragma unroll
        for (int j = 0; j < TREE_L2_GROUPS; ++j) {
            if constexpr (WORDS) {
                const int g = i + j * (int)blockDim.x;
                if (g < g1) reinterpret_cast<V*>(static_cast<uint32_t*>(out) + (size_t)s * W)[g] = top[j];
            } else {
                acc += tree_popc(top[j]);  // zero past g1: every fold maps zeros to zero
            }
        }
    }
    if constexpr (!WORDS) tree_add_count(acc, static_cast<int32_t*>(out) + (size_t)b * S + s);
}

// Byte offsets of a rows-instance block's dynamic shared memory: the stage
// ring (each stage the item's rows and a zero row, which absent leaves
// name, 16 bytes a lane each), the rows' pointers at the block's shard, the
// steps (whole int4s) and the operand stack below the top (depth - 1
// entries of 16 bytes a lane). ops/kernels.py (_tree_rows_smem) computes
// the same total.
struct TreeRowsSmem {
    long long stage_bytes, rowp, steps, stack, total;
};

__host__ __device__ __forceinline__ TreeRowsSmem tree_rows_smem(int stages, int rows, int n_steps,
                                                                int depth, int lanes) {
    TreeRowsSmem m;
    m.stage_bytes = (rows + 1LL) * lanes * 16;
    m.rowp = stages * m.stage_bytes;
    m.steps = m.rowp + tree_pad16(8LL * rows);
    m.stack = m.steps + 16LL * ((n_steps + 3) / 4);
    m.total = m.stack + (depth - 1LL) * lanes * 16;
    return m;
}

// One step of a general program on this lane's 16 bytes: v is the step's
// leaf (the zero row for a fold of the top or a pad), below this lane's
// column of the operand stack (entry e at e * blockDim.x).
__device__ __forceinline__ void tree_rows_step(int st, uint4 v, uint4& top, int& n, uint4* below) {
    switch (st & 31) {
        case TREE_PUSH:
            if (n > 0) below[(n - 1) * blockDim.x] = top;
            top = v;
            ++n;
            break;
#define TREE_STEP_CASES(F)                                                     \
        case TREE_LEAF_FOLD | F << 2: top = tree_fold<F>(top, v); break;       \
        case TREE_POP_FOLD | F << 2:                                           \
            top = tree_fold<F>(below[(n - 2) * blockDim.x], top);              \
            --n;                                                               \
            break;
        TREE_STEP_CASES(0)
        TREE_STEP_CASES(1)
        TREE_STEP_CASES(2)
        TREE_STEP_CASES(3)
        TREE_STEP_CASES(4)
#undef TREE_STEP_CASES
        default: break;  // TREE_NOP
    }
}

// The item's program on this lane's 16 bytes of one stage (`stage`: this
// lane's column of it). The shared steps hold each leaf's byte offset in a
// stage (a multiple of 512) above their low 5 bits. FLAT >= 0: a chain of
// that one fold, eight leaves loaded before they are folded.
template <int FLAT>
__device__ __forceinline__ uint4 tree_rows_eval(const int* s_steps, int n_steps,
                                                const unsigned char* stage, uint4* below) {
    constexpr int MASK = ~31;
    auto leaf = [&](int st) { return *reinterpret_cast<const uint4*>(stage + (st & MASK)); };
    if constexpr (FLAT >= 0) {
        uint4 top = leaf(s_steps[0]);
        int k = 1;
        for (; k + 8 <= n_steps; k += 8) {
            uint4 v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = leaf(s_steps[k + j]);
#pragma unroll
            for (int j = 0; j < 8; ++j) top = tree_fold<FLAT>(top, v[j]);
        }
        for (; k < n_steps; ++k) top = tree_fold<FLAT>(top, leaf(s_steps[k]));
        return top;
    } else {
        uint4 top = make_uint4(0u, 0u, 0u, 0u);
        int n = 0;
        for (int k = 0; k < n_steps; k += 4) {
            const int4 st = *reinterpret_cast<const int4*>(s_steps + k);
            const uint4 v0 = leaf(st.x), v1 = leaf(st.y), v2 = leaf(st.z), v3 = leaf(st.w);
            tree_rows_step(st.x, v0, top, n, below);
            tree_rows_step(st.y, v1, top, n, below);
            tree_rows_step(st.z, v2, top, n, below);
            tree_rows_step(st.w, v3, top, n, below);
        }
        return top;
    }
}

// One block of the rows instance: item b = blockIdx.x % B, slice
// blockIdx.x / B of `slice` chunks (blockDim.x lanes x 4 words each),
// shard blockIdx.y; the item's rows (at most rows_max) staged a chunk at a
// time in a ring of `stages`.
template <int FLAT>
__device__ __forceinline__ void tree_rows_body(const unsigned char* table, int B, int n_rows,
                                               int n_steps, int depth, int S, int W, int stages,
                                               int rows_max, int slice, int32_t* out) {
    extern __shared__ __align__(128) unsigned char tree_smem_buf[];
    const int lanes = blockDim.x;
    const int row_bytes = lanes * 16;
    const TreeRowsSmem m = tree_rows_smem(stages, rows_max, n_steps, depth, lanes);
    const int b = blockIdx.x % B;
    const int s = blockIdx.y;
    const int chunks = (W + lanes * 4 - 1) / (lanes * 4);
    const int c0 = (blockIdx.x / B) * slice;
    const int c1 = min(chunks, c0 + slice);
    if (c0 >= c1) return;
    const TreeDirect t = tree_direct(table, B, n_rows, n_steps, b, s);
    const int nb = t.nb;
    const uint32_t** rowp = reinterpret_cast<const uint32_t**>(tree_smem_buf + m.rowp);
    int* s_steps = reinterpret_cast<int*>(tree_smem_buf + m.steps);
    for (int r = threadIdx.x; r < nb; r += blockDim.x) rowp[r] = tree_row(t, r);
    for (int k = threadIdx.x; k < ((n_steps + 3) & ~3); k += blockDim.x) {
        const int st = k < n_steps ? t.steps[k] : TREE_NOP | rows_max << 5;
        s_steps[k] = (st & 31) | (st >> 5) * row_bytes;
    }
    const uint32_t stage_bytes = (uint32_t)m.stage_bytes;
    unsigned char* col = tree_smem_buf + threadIdx.x * 16;
    // this lane's 16 bytes of each stage's zero row: no copy writes them
    for (int st = 0; st < stages; ++st)
        *reinterpret_cast<uint4*>(col + st * stage_bytes + rows_max * row_bytes) =
            make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const uint32_t col0 = pilosa_smem_addr(col);
    const int words = W;  // (plain locals: the lambda then copies no parameter)
    // chunk c of every row of the item into stage st: each lane copies the
    // 16 bytes of each row that it evaluates (eight rows' pointers read
    // before their copies: a copy's memory clobber would hold the next read
    // behind it); words past W are zero-filled, and every fold maps zeros
    // to zero
    auto load = [&](int st, int c) {
        const int w = (c * lanes + threadIdx.x) * 4;
        const bool ok = w < words;
        const uint32_t dst = col0 + st * stage_bytes;
        for (int r0 = 0; r0 < nb; r0 += 8) {
            const uint32_t* src[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) src[j] = rowp[min(r0 + j, nb - 1)] + (ok ? w : 0);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (r0 + j < nb) pilosa_cp16(dst + (r0 + j) * row_bytes, src[j], ok ? 16 : 0);
        }
    };
    const int nk = c1 - c0;
    for (int st = 0; st < stages - 1; ++st) {
        if (st < nk) load(st, c0 + st);
        pilosa_cp_commit();
    }
    uint4* below = reinterpret_cast<uint4*>(tree_smem_buf + m.stack) + threadIdx.x;
    int acc = 0;
    for (int i = 0; i < nk; ++i) {
        // fill the stage this lane evaluated in the last iteration (only this
        // lane reads its column, so no barrier), then wait for chunk i
        if (i + stages - 1 < nk) load((i + stages - 1) % stages, c0 + i + stages - 1);
        pilosa_cp_commit();
        tree_cp_wait(stages - 1);
        acc += tree_popc(tree_rows_eval<FLAT>(s_steps, n_steps, col + (i % stages) * stage_bytes,
                                              below));
    }
    pilosa_cp_wait<0>();
    tree_add_count(acc, out + (size_t)b * S + s);
}

struct __align__(16) TreeTableParam {
    unsigned char bytes[TREE_PARAM_BYTES];
};

template <typename V, bool DEEP, bool WORDS>
__global__ void __launch_bounds__(TREE_L2_THREADS)
pilosa_tree_l2(const unsigned char* __restrict__ table, int B, int n_rows, int n_steps, int S,
               int W, int rows_max, int slice, void* __restrict__ out) {
    tree_l2_body<V, DEEP, WORDS>(table, B, n_rows, n_steps, S, W, rows_max, slice, out);
}

template <typename V, bool DEEP, bool WORDS>
__global__ void __launch_bounds__(TREE_L2_THREADS)
pilosa_tree_l2_param(const __grid_constant__ TreeTableParam table, int B, int n_rows, int n_steps,
                     int S, int W, int rows_max, int slice, void* __restrict__ out) {
    tree_l2_body<V, DEEP, WORDS>(table.bytes, B, n_rows, n_steps, S, W, rows_max, slice, out);
}

template <int FLAT>
__global__ void __launch_bounds__(TREE_ROWS_LANES)
pilosa_tree_rows(const unsigned char* __restrict__ table, int B, int n_rows, int n_steps,
                 int depth, int S, int W, int stages, int rows_max, int slice,
                 int32_t* __restrict__ out) {
    tree_rows_body<FLAT>(table, B, n_rows, n_steps, depth, S, W, stages, rows_max, slice, out);
}

template <int FLAT>
__global__ void __launch_bounds__(TREE_ROWS_LANES)
pilosa_tree_rows_param(const __grid_constant__ TreeTableParam table, int B, int n_rows,
                       int n_steps, int depth, int S, int W, int stages, int rows_max, int slice,
                       int32_t* __restrict__ out) {
    tree_rows_body<FLAT>(table.bytes, B, n_rows, n_steps, depth, S, W, stages, rows_max, slice,
                         out);
}

// The launch arguments of the direct route, as the C entries take them.
struct TreeDirectArgs {
    const void* table;
    int host_bytes, B, n_rows, n_steps, depth, S, W, rows_max, slice;
    void* out;
};

template <typename V, bool DEEP, bool WORDS>
static void tree_l2_launch(dim3 grid, cudaStream_t st, const TreeDirectArgs& a) {
    if (a.host_bytes > 0) {
        TreeTableParam prm;
        memcpy(prm.bytes, a.table, (size_t)a.host_bytes);
        pilosa_tree_l2_param<V, DEEP, WORDS><<<grid, TREE_L2_THREADS, 0, st>>>(
            prm, a.B, a.n_rows, a.n_steps, a.S, a.W, a.rows_max, a.slice, a.out);
    } else {
        pilosa_tree_l2<V, DEEP, WORDS><<<grid, TREE_L2_THREADS, 0, st>>>(
            (const unsigned char*)a.table, a.B, a.n_rows, a.n_steps, a.S, a.W, a.rows_max,
            a.slice, a.out);
    }
}

template <bool WORDS>
static int tree_l2(dim3 grid, cudaStream_t st, bool vec16, const TreeDirectArgs& a) {
    const bool deep = a.depth > 2;
    if (vec16) {
        if (deep) tree_l2_launch<uint4, true, WORDS>(grid, st, a);
        else tree_l2_launch<uint4, false, WORDS>(grid, st, a);
    } else {
        if (deep) tree_l2_launch<uint32_t, true, WORDS>(grid, st, a);
        else tree_l2_launch<uint32_t, false, WORDS>(grid, st, a);
    }
    return (int)cudaGetLastError();
}

// Set a kernel's dynamic shared-memory limit, once per device.
template <typename K>
static int tree_smem_ready(K kern, bool (&ready)[64], int device) {
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TREE_SMEM_LIMIT);
        if (err != cudaSuccess) return (int)err;
        ready[device] = true;
    }
    return 0;
}

template <int FLAT>
static int tree_rows(dim3 grid, int lanes, long long smem, cudaStream_t st, int device,
                     int stages, const TreeDirectArgs& a) {
    static bool ready[64], ready_param[64];
    int32_t* o = static_cast<int32_t*>(a.out);
    if (a.host_bytes > 0) {
        int err = tree_smem_ready(pilosa_tree_rows_param<FLAT>, ready_param, device);
        if (err) return err;
        TreeTableParam prm;
        memcpy(prm.bytes, a.table, (size_t)a.host_bytes);
        pilosa_tree_rows_param<FLAT><<<grid, lanes, (size_t)smem, st>>>(
            prm, a.B, a.n_rows, a.n_steps, a.depth, a.S, a.W, stages, a.rows_max, a.slice, o);
    } else {
        int err = tree_smem_ready(pilosa_tree_rows<FLAT>, ready, device);
        if (err) return err;
        pilosa_tree_rows<FLAT><<<grid, lanes, (size_t)smem, st>>>(
            (const unsigned char*)a.table, a.B, a.n_rows, a.n_steps, a.depth, a.S, a.W, stages,
            a.rows_max, a.slice, o);
    }
    return (int)cudaGetLastError();
}

static bool tree_direct_args_ok(int host_bytes, int n_rows, int n_steps, int depth, int S, int W,
                                int vec16, int rows_max) {
    return host_bytes >= 0 && host_bytes <= TREE_PARAM_BYTES && n_rows >= 0 && n_steps > 0 &&
           depth >= 1 && depth <= TREE_MAX_DEPTH && S <= 65535 && W < (1 << 26) &&
           !(vec16 && (W & 3)) && rows_max >= 0;
}

// out: int32[B, S], zeroed here on the stream before the launch. table:
// the direct table above, on the device, or (host_bytes > 0, at most
// TREE_PARAM_BYTES) in host memory, passed as the kernel's parameter. depth: the operand-stack entries the steps need.
// vec16: every row 16-byte aligned at every shard with W a multiple of 4.
// rows_max: the index an absent leaf names (at least every item's row
// count). The plan (kernels.tree_plan): stages 0 runs the through-L2
// instance (flat -1, lanes 0); stages 1-4 the rows instance with a ring of
// that many stages of rows_max rows and a zero row (vec16), blocks of
// `lanes` (TREE_ROWS_LANES or half as many), flat the fold of a flat chain
// of any length (0-3: AND, OR, XOR, ANDNOT; depth 1) or -1; wsplit slices
// of each shard's chunks. Arguments past the limits (a depth past
// TREE_MAX_DEPTH, W past 2^26, a host table past TREE_PARAM_BYTES, no
// slice, a ring past shared memory) return cudaErrorInvalidValue and
// launch nothing.
extern "C" int pilosa_tree_count(const void* table, int host_bytes, int B, int n_rows,
                                 int n_steps, int depth, int S, int W, int vec16, int rows_max,
                                 int stages, int lanes, int wsplit, int flat, void* out,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const bool rows = stages > 0;
    const long long smem =
        rows ? tree_rows_smem(stages, rows_max, n_steps, depth, lanes).total : 0;
    const bool ok =
        tree_direct_args_ok(host_bytes, n_rows, n_steps, depth, S, W, vec16, rows_max) &&
        B >= 0 && wsplit >= 1 && (long long)B * wsplit <= 0x7fffffffLL &&
        (!rows ? flat == -1 && lanes == 0
               : stages >= 1 && stages <= 4 && vec16 &&
                     (lanes == TREE_ROWS_LANES || lanes == TREE_ROWS_LANES / 2) &&
                     smem <= TREE_SMEM_LIMIT && flat >= -1 && flat <= 3 &&
                     (flat < 0 || depth == 1));
    if (!ok) return (int)cudaErrorInvalidValue;
    if (B == 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    const int chunk_words = rows ? lanes * 4 : TREE_ROW_CHUNK_WORDS;
    const int chunks = (W + chunk_words - 1) / chunk_words;
    const TreeDirectArgs a{table, host_bytes, B, n_rows, n_steps, depth, S, W, rows_max,
                           (chunks + wsplit - 1) / wsplit, out};
    const dim3 grid((unsigned)(B * wsplit), (unsigned)S);
    cudaStream_t st = (cudaStream_t)stream;
    err = cudaMemsetAsync(out, 0, (size_t)B * S * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    if (stages == 0) return tree_l2<false>(grid, st, vec16, a);
    switch (flat) {
        case 0: return tree_rows<0>(grid, lanes, smem, st, device, stages, a);
        case 1: return tree_rows<1>(grid, lanes, smem, st, device, stages, a);
        case 2: return tree_rows<2>(grid, lanes, smem, st, device, stages, a);
        case 3: return tree_rows<3>(grid, lanes, smem, st, device, stages, a);
        default: return tree_rows<-1>(grid, lanes, smem, st, device, stages, a);
    }
}

// out: int32[S, W] (16-byte aligned when vec16); table: the direct table of
// one item (rows_max = n_rows), on the through-L2 instance.
extern "C" int pilosa_tree_words(const void* table, int host_bytes, int n_rows, int n_steps,
                                 int depth, int S, int W, int vec16, void* out, int device,
                                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!tree_direct_args_ok(host_bytes, n_rows, n_steps, depth, S, W, vec16, n_rows))
        return (int)cudaErrorInvalidValue;
    if (S <= 0 || W <= 0) return (int)cudaSuccess;
    const int slice = TREE_WORDS_CHUNK / TREE_ROW_CHUNK_WORDS;
    const int chunks = (W + TREE_ROW_CHUNK_WORDS - 1) / TREE_ROW_CHUNK_WORDS;
    const TreeDirectArgs a{table, host_bytes, 1, n_rows, n_steps, depth, S, W, n_rows, slice, out};
    return tree_l2<true>(dim3((unsigned)((chunks + slice - 1) / slice), (unsigned)S),
                         (cudaStream_t)stream, vec16, a);
}

// ---------------------------------------------------------------------------
// The staged route
// ---------------------------------------------------------------------------

// Words of a row per stage: one warp step, 32 lanes x 16 bytes.
#define TREE_CHUNK_WORDS 128
#define TREE_CHUNK_BYTES (TREE_CHUNK_WORDS * 4)
// Items per single-bit MMA accumulator (its 8 columns).
#define TREE_GROUP 8
#define TREE_STAGED_MAX_LEAVES 64
// Warps per block: one block per SM (its stages fill shared memory), and
// 128 registers a thread at most.
#define TREE_STAGED_WARPS 16
// A slot of the staged table: the row's index in its tile's stages, with
// this bit set when all 8 items of the group name that row.
#define TREE_UNIFORM (1 << 30)

// Byte offsets of one block's dynamic shared memory: the stage ring (each
// stage the tile's rows and one zero row, which absent slots name), the
// rows' pointers at the block's shard, the steps, the tile's slots and each
// group's accumulator (two int32 a lane). ops/kernels.py
// (_tree_staged_smem) computes the same total.
struct TreeSmem {
    long long stage_bytes, rowp, steps, slots, acc, total;
};

__host__ __device__ __forceinline__ TreeSmem tree_smem(int stages, int rows, int items,
                                                       int L, int n_steps) {
    TreeSmem m;
    m.stage_bytes = (rows + 1LL) * TREE_CHUNK_BYTES;
    m.rowp = stages * m.stage_bytes;
    m.steps = m.rowp + tree_pad16(8LL * rows);
    m.slots = m.steps + tree_pad16(4LL * n_steps);
    m.acc = m.slots + 4LL * L * items;
    m.total = m.acc + 32LL * items;  // 32 lanes x 8 bytes per group of 8
    return m;
}

template <int F>
__device__ __forceinline__ void tree_fold8(uint4 (&dst)[TREE_GROUP], const uint4 (&a)[TREE_GROUP],
                                           const uint4 (&b)[TREE_GROUP]) {
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) dst[j] = tree_fold<F>(a[j], b[j]);
}

// dst[j] = fold(a[j], b[j]) for the group's items; f is warp-uniform.
__device__ __forceinline__ void tree_fold8(int f, uint4 (&dst)[TREE_GROUP],
                                           const uint4 (&a)[TREE_GROUP],
                                           const uint4 (&b)[TREE_GROUP]) {
    switch (f) {
        case 0: tree_fold8<0>(dst, a, b); break;
        case 1: tree_fold8<1>(dst, a, b); break;
        case 2: tree_fold8<2>(dst, a, b); break;
        case 3: tree_fold8<3>(dst, a, b); break;
        default: tree_fold8<4>(dst, a, b); break;
    }
}

template <int F>
__device__ __forceinline__ void tree_fold1(uint4 (&top)[TREE_GROUP], uint4 v) {
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) top[j] = tree_fold<F>(top[j], v);
}

// top[j] = fold(top[j], v): a leaf every item of the group shares.
__device__ __forceinline__ void tree_fold1(int f, uint4 (&top)[TREE_GROUP], uint4 v) {
    switch (f) {
        case 0: tree_fold1<0>(top, v); break;
        case 1: tree_fold1<1>(top, v); break;
        case 2: tree_fold1<2>(top, v); break;
        case 3: tree_fold1<3>(top, v); break;
        default: tree_fold1<4>(top, v); break;
    }
}

// Add the popcounts of the group's 8 items into its accumulator (this
// lane's two int32).
__device__ __forceinline__ void tree_popc8(const uint4 (&top)[TREE_GROUP], int2* acc,
                                           const uint32_t (&sel)[TREE_GROUP]) {
    // item j's 128 words are the A operand; B's column j is all ones, so
    // column j of the accumulator holds item j's popcounts by A row (two
    // accumulators, even and odd items, halve the chain of dependent MMAs)
    int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) {
        const uint32_t a[4] = {top[j].x, top[j].y, top[j].z, top[j].w};
        const uint32_t b[2] = {sel[j], sel[j]};
        pilosa_bmma(d[j & 1], a, b);
    }
    // accumulator e: row (lane >> 2) + 8 * (e >> 1), column 2 * (lane & 3) + (e & 1);
    // the rows are summed once, after the last chunk
    int2 sum = *acc;
    sum.x += d[0][0] + d[0][2] + d[1][0] + d[1][2];
    sum.y += d[0][1] + d[0][3] + d[1][1] + d[1][3];
    *acc = sum;
}

// Leaf values of the group's 8 items (this lane's 16 bytes of each row)
// into v: one load when the wrapper marked the slots uniform, else one per
// item (an absent slot names the stage's zero row).
__device__ __forceinline__ void tree_leaf8(uint4 (&v)[TREE_GROUP], const int* s8,
                                           const unsigned char* stage) {
    const int4 lo = *reinterpret_cast<const int4*>(s8);
    if (lo.x & TREE_UNIFORM) {
        const uint4 one = *reinterpret_cast<const uint4*>(
            stage + (lo.x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES);
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j) v[j] = one;
    } else {
        const int4 hi = *reinterpret_cast<const int4*>(s8 + 4);
        const int u[TREE_GROUP] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j)
            v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
    }
}

// Fold a leaf into the top in place: top[j] = fold(top[j], leaf of item j),
// the leaf loaded once when the group's slots are uniform.
__device__ __forceinline__ void tree_leaf_fold8(int f, uint4 (&top)[TREE_GROUP], const int* s8,
                                                const unsigned char* stage) {
    const int4 lo = *reinterpret_cast<const int4*>(s8);
    if (lo.x & TREE_UNIFORM) {
        tree_fold1(f, top, *reinterpret_cast<const uint4*>(
                               stage + (lo.x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES));
    } else {
        const int4 hi = *reinterpret_cast<const int4*>(s8 + 4);
        const int u[TREE_GROUP] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint4 v[TREE_GROUP];
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j)
            v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
        tree_fold8(f, top, top, v);
    }
}

// Evaluate the program for one group of 8 items on one staged chunk and add
// their popcounts into the group's accumulator. The first step, a push,
// loads the top; a program that needs one entry then only folds leaves into
// it in place. Every branch is warp-uniform.
template <int MAXN>
__device__ __forceinline__ void tree_group(const int* s_steps, int n_steps, const int* slots,
                                           int n_items, const unsigned char* stage, int2* acc,
                                           const uint32_t (&sel)[TREE_GROUP]) {
    uint4 top[TREE_GROUP];
    uint4 below[MAXN > 1 ? TREE_GROUP : 1];
    tree_leaf8(top, slots + (s_steps[0] >> 5) * n_items, stage);
    int st = n_steps > 1 ? s_steps[1] : 0;
    for (int k = 1; k < n_steps; ++k) {
        const int next = k + 1 < n_steps ? s_steps[k + 1] : 0;
        const int kind = st & 3;
        const int f = (st >> 2) & 7;
        const int* s8 = slots + (st >> 5) * n_items;
        if (kind == TREE_LEAF_FOLD) {
            tree_leaf_fold8(f, top, s8, stage);
        } else if constexpr (MAXN > 1) {
            if (kind == TREE_PUSH) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) below[j] = top[j];
                tree_leaf8(top, s8, stage);
            } else {
                tree_fold8(f, top, below, top);
            }
        }
        st = next;
    }
    tree_popc8(top, acc, sel);
}

// Steps of a flat chain (a push, then leaf folds of one fold F: AND, OR,
// XOR or ANDNOT) that the flat instances take, unrolled.
#define TREE_FLAT_STEPS 4

// The group's evaluation for a flat chain of fold F: the slots of every step
// are loaded first; while every leaf so far is one row for the whole group
// the chain is one register, and it widens to the 8 items at the first leaf
// that differs between them (the wrapper puts the leaves with the fewest
// distinct rows first where F allows it).
template <int F>
__device__ __forceinline__ void tree_group_flat(const int (&leaf_off)[TREE_FLAT_STEPS],
                                                int n_steps, const int* slots,
                                                const unsigned char* stage, int2* acc,
                                                const uint32_t (&sel)[TREE_GROUP]) {
    int4 lo[TREE_FLAT_STEPS], hi[TREE_FLAT_STEPS];
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k) {
        if (k < n_steps) {
            lo[k] = *reinterpret_cast<const int4*>(slots + leaf_off[k]);
            hi[k] = *reinterpret_cast<const int4*>(slots + leaf_off[k] + 4);
        }
    }
    uint4 top[TREE_GROUP];
    uint4 one = make_uint4(0u, 0u, 0u, 0u);
    bool wide = false;
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k) {
        if (k >= n_steps) break;
        if (lo[k].x & TREE_UNIFORM) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                stage + (lo[k].x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES);
            if (k == 0) one = v;
            else if (!wide) one = tree_fold<F>(one, v);
            else tree_fold1<F>(top, v);
        } else {
            const int u[TREE_GROUP] = {lo[k].x, lo[k].y, lo[k].z, lo[k].w,
                                       hi[k].x, hi[k].y, hi[k].z, hi[k].w};
            uint4 v[TREE_GROUP];
#pragma unroll
            for (int j = 0; j < TREE_GROUP; ++j)
                v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
            if (k == 0) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) top[j] = v[j];
            } else if (!wide) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) top[j] = tree_fold<F>(one, v[j]);
            } else {
                tree_fold8<F>(top, top, v);
            }
            wide = true;
        }
    }
    if (!wide) {
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j) top[j] = one;
    }
    tree_popc8(top, acc, sel);
}

// The staged table the wrapper uploads in one copy:
//   int64 rowptr[n_rows]      each tile row's words at shard 0
//   int64 rowstride[n_rows]   its words per shard
//   int32 head[tiles][4]      row offset, rows, item offset, items (a
//                             multiple of TREE_GROUP) of each tile
//   int32 steps[n_steps]
//   int32 slots[n_items * L]  tile t at item offset * L: [L][items], row
//                             indices in the tile (its row count: absent),
//                             TREE_UNIFORM on a group that shares one row
//   int32 ids[n_items]        each item's row of out (< 0: padding)
// blockIdx.x = tile * wsplit + slice (slice chunks each), blockIdx.y = shard.
template <int MAXN, int FLAT>
__global__ void __launch_bounds__(TREE_STAGED_WARPS * 32, 1)
pilosa_tree_count_staged(const unsigned char* __restrict__ table, int tiles, int n_rows,
                         int n_items, int n_steps, int L, int S, int W, int stages,
                         int rows_max, int items_max, int wsplit, int slice,
                         int32_t* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char tree_smem_buf[];
    const TreeSmem m = tree_smem(stages, rows_max, items_max, L, n_steps);
    const int t = blockIdx.x / wsplit;
    const int s = blockIdx.y;
    const int chunks = (W + TREE_CHUNK_WORDS - 1) / TREE_CHUNK_WORDS;
    const int c0 = (blockIdx.x - t * wsplit) * slice;
    const int c1 = min(chunks, c0 + slice);
    if (c0 >= c1) return;

    const long long* rowptr = reinterpret_cast<const long long*>(table);
    const long long* rowstride = rowptr + n_rows;
    const int* ints = reinterpret_cast<const int*>(rowstride + n_rows);
    const int* head = ints + 4 * t;
    const int* steps = ints + 4 * tiles;
    const int* slots = steps + n_steps;
    const int* ids = slots + (size_t)n_items * L;
    const int row_off = head[0], rows = head[1], item_off = head[2], items = head[3];

    const uint32_t stage_bytes = (uint32_t)m.stage_bytes;
    const uint32_t** rowp = reinterpret_cast<const uint32_t**>(tree_smem_buf + m.rowp);
    int* s_steps = reinterpret_cast<int*>(tree_smem_buf + m.steps);
    int* s_slots = reinterpret_cast<int*>(tree_smem_buf + m.slots);
    int2* acc = reinterpret_cast<int2*>(tree_smem_buf + m.acc);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
        rowp[r] = reinterpret_cast<const uint32_t*>(rowptr[row_off + r]) +
                  (size_t)s * rowstride[row_off + r];
    for (int k = threadIdx.x; k < n_steps; k += blockDim.x) s_steps[k] = steps[k];
    for (int i = threadIdx.x; i < L * items; i += blockDim.x)
        s_slots[i] = slots[(size_t)item_off * L + i];
    for (int i = threadIdx.x; i < items * 4; i += blockDim.x)
        acc[i] = make_int2(0, 0);
    // each stage's zero row (row `rows`): no copy writes it
    for (int i = threadIdx.x; i < stages * (TREE_CHUNK_BYTES / 16); i += blockDim.x)
        *reinterpret_cast<uint4*>(tree_smem_buf + (i / (TREE_CHUNK_BYTES / 16)) * stage_bytes +
                                  rows * TREE_CHUNK_BYTES + (i % (TREE_CHUNK_BYTES / 16)) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const uint32_t smem0 = pilosa_smem_addr(tree_smem_buf);
    const int words = W;  // (plain locals: the lambda then copies no parameter)
    // chunk c of every tile row into stage st; words past W are zero-filled,
    // and every fold maps zeros to zero
    auto load = [&](int st, int c) {
        const uint32_t base = smem0 + st * stage_bytes;
        const int w0 = c * TREE_CHUNK_WORDS;
        for (int q = threadIdx.x; q < rows * (TREE_CHUNK_BYTES / 16); q += TREE_STAGED_WARPS * 32) {
            const int r = q / (TREE_CHUNK_BYTES / 16);
            const int piece = q % (TREE_CHUNK_BYTES / 16);
            const int w = w0 + piece * 4;
            const bool ok = w < words;
            pilosa_cp16(base + r * TREE_CHUNK_BYTES + piece * 16, rowp[r] + (ok ? w : 0),
                        ok ? 16 : 0);
        }
    };

    const int nk = c1 - c0;
    for (int st = 0; st < stages - 1; ++st) {
        if (st < nk) load(st, c0 + st);
        pilosa_cp_commit();
    }
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int groups = items / TREE_GROUP;
    // B operand of item j: all ones in column j (lanes 4j .. 4j + 3)
    uint32_t sel[TREE_GROUP];
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) sel[j] = (lane >> 2) == j ? 0xffffffffu : 0u;
    // a flat chain's slot columns, in step order
    int leaf_off[TREE_FLAT_STEPS];
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k)
        leaf_off[k] = k < n_steps && FLAT >= 0 ? (s_steps[k] >> 5) * items : 0;
    for (int i = 0; i < nk; ++i) {
        tree_cp_wait(stages - 2);
        __syncthreads();
        // refill the stage every warp finished with in the last iteration
        if (i + stages - 1 < nk) load((i + stages - 1) % stages, c0 + i + stages - 1);
        pilosa_cp_commit();
        const unsigned char* stage = tree_smem_buf + (i % stages) * stage_bytes + lane * 16;
        for (int g = warp; g < groups; g += TREE_STAGED_WARPS) {
            if constexpr (FLAT >= 0)
                tree_group_flat<FLAT>(leaf_off, n_steps, s_slots + g * TREE_GROUP, stage,
                                      acc + g * 32 + lane, sel);
            else
                tree_group<MAXN>(s_steps, n_steps, s_slots + g * TREE_GROUP, items, stage,
                                 acc + g * 32 + lane, sel);
        }
    }
    pilosa_cp_wait<0>();
    // each group's accumulator: sum its 16 rows (lanes of one column), then
    // add item 2 * lane and 2 * lane + 1 into out
    for (int g = warp; g < groups; g += TREE_STAGED_WARPS) {
        int2 v = acc[g * 32 + lane];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
        }
        if (lane < 4) {
            const int i = item_off + g * TREE_GROUP + 2 * lane;
            if (ids[i] >= 0 && v.x != 0) atomicAdd(out + (size_t)ids[i] * S + s, v.x);
            if (ids[i + 1] >= 0 && v.y != 0) atomicAdd(out + (size_t)ids[i + 1] * S + s, v.y);
        }
    }
}

template <int MAXN, int FLAT>
static int tree_staged_launch(dim3 grid, long long smem, cudaStream_t st,
                              const unsigned char* table, int tiles, int n_rows, int n_items,
                              int n_steps, int L, int S, int W, int stages, int rows_max,
                              int items_max, int wsplit, int slice, int32_t* out, int device) {
    auto kern = pilosa_tree_count_staged<MAXN, FLAT>;
    static bool ready[64];
    int err = tree_smem_ready(kern, ready, device);
    if (err) return err;
    kern<<<grid, TREE_STAGED_WARPS * 32, (size_t)smem, st>>>(table, tiles, n_rows, n_items, n_steps, L, S,
                                                W, stages, rows_max, items_max, wsplit, slice,
                                                out);
    return (int)cudaGetLastError();
}

// out: zeroed int32[B, S]. table: the staged table above, on the device.
// fused_depth: operand-stack entries the steps need (1 or 2). The plan
// (kernels.tree_plan): stages of the ring (2-4), the largest tile's rows
// and items, wsplit slices of each shard's chunks, and flat: the fold of a
// flat chain of at most TREE_FLAT_STEPS steps (0-3: AND, OR, XOR, ANDNOT;
// one entry), or -1. Every row must
// be 16-byte aligned at every shard with W a multiple of 4. A plan it
// cannot run returns cudaErrorInvalidValue and launches nothing.
extern "C" int pilosa_tree_count_staged(const void* table, int tiles, int n_rows, int n_items,
                                        int n_steps, int L, int fused_depth, int S, int W,
                                        int stages, int rows_max, int items_max, int wsplit,
                                        int flat, void* out, int device,
                                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long smem = tree_smem(stages, rows_max, items_max, L, n_steps).total;
    const bool ok = tiles > 0 && n_steps > 0 && L >= 1 && L <= TREE_STAGED_MAX_LEAVES &&
                    (fused_depth == 1 || fused_depth == 2) && stages >= 2 && stages <= 4 &&
                    rows_max >= 0 && items_max > 0 && items_max % TREE_GROUP == 0 &&
                    S > 0 && S <= 65535 && W > 0 && W < (1 << 26) && (W & 3) == 0 &&
                    wsplit >= 1 && (long long)tiles * wsplit <= 0x7fffffffLL &&
                    smem <= TREE_SMEM_LIMIT &&
                    flat >= -1 && flat <= 3 &&
                    (flat < 0 || (fused_depth == 1 && n_steps <= TREE_FLAT_STEPS));
    if (!ok) return (int)cudaErrorInvalidValue;
    const int chunks = (W + TREE_CHUNK_WORDS - 1) / TREE_CHUNK_WORDS;
    const int slice = (chunks + wsplit - 1) / wsplit;
    const dim3 grid((unsigned)(tiles * wsplit), (unsigned)S);
    const unsigned char* t = (const unsigned char*)table;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* o = (int32_t*)out;
#define TREE_STAGED(MAXN, FLAT)                                                             \
    tree_staged_launch<MAXN, FLAT>(grid, smem, st, t, tiles, n_rows, n_items, n_steps,        \
                                          L, S, W, stages, rows_max, items_max, wsplit, slice, \
                                          o, device)
    switch (flat) {
        case 0: return TREE_STAGED(1, 0);
        case 1: return TREE_STAGED(1, 1);
        case 2: return TREE_STAGED(1, 2);
        case 3: return TREE_STAGED(1, 3);
        default: break;
    }
    return fused_depth == 1 ? TREE_STAGED(1, -1) : TREE_STAGED(2, -1);
#undef TREE_STAGED
}
