// Tree evaluation: the compiled PQL trees of exec/astbatch.py.
//   pilosa_tree_count: out[b, s] = sum_w popc(tree(leaves of item b)[s, w])
//   pilosa_tree_words: out[s, w] = tree(leaves of one item)[s, w]
// A tree of Row/Intersect/Union/Difference/Xor/Not over field stacks runs
// as a postfix program: a leaf opcode (>= 0) pushes leaf l, the row
// slots[b, l] of stack leaf_stack[l] at shard s; a fold opcode pops two
// operands and pushes AND, OR, XOR, ANDNOT or NOTAND of them. A slot below 0
// is an absent row: a zero leaf, never read. exec/astbatch.py orders each
// program so that it needs at most floor(log2(leaves)) + 1 operand-stack
// entries, so TREE_MAX_DEPTH (32) holds every tree; programs of any length
// and any number of leaves run.
//
// Replaces: pilosa_tpu/exec/astbatch.py, the XLA programs of compiled
// (count mode: _count_scan, a lax.scan over the batch with the tree fused
// per item; bitmap mode: the tree's [S, W] words). No Pallas kernel stands
// behind them.
//
// Bound on an H100, by route. Bytes: the function reads each distinct row the
// batch names once and writes B x S counts (or S x W words); at the trees
// path of chip_smoke.py (1024 items, three leaves over two 64-row stacks and
// a 4-row stack at S = 160, W = 32768) that is at most 2.77 GB, 0.83 ms at
// 3.35 TB/s. Popcounts: this SIMT route issues one __popc per item, shard
// and word, B x S x W = 5.4e9 at that shape; at 16 POPC per clock per SM
// (132 SMs, 1.98 GHz) that alone takes about 1.3 ms, above the byte bound,
// before the folds and the interpreter. Only a popcount on the tensor cores
// (BMMA against an all-ones operand, as the grams issue BMMA) or fewer
// popcounts (carry-save adders over words before one popc) could approach
// the byte bound.
//
// Design, simple first: one block of 256 threads per (item b, shard s),
// blockIdx.x = b fastest, so the blocks in flight share one shard's rows and
// read them from L2. The block stages the first TREE_SMEM_OPS opcodes and the
// row pointers of the first TREE_SMEM_LEAVES leaves in shared memory; the
// rest of a longer program is read from the table in device memory, by a
// second instance of the kernel (LONG) that only such programs launch. Threads
// stride over W in 16-byte groups when the wrapper says every row and the
// output are 16-byte aligned (vec16), else word by word. Each group runs the
// program with the top of the operand stack in registers and the entries
// below it in a small array (TREE_MAX_DEPTH entries at most); a leaf followed
// by a fold is applied to the top directly, so a flat Intersect or Union
// needs no stack at all. The block sums its popcounts with warp shuffles and
// one shared-memory pass and stores one int32 per (b, s): no atomics. A
// shard's count is at most 32 * W < 2^31 (the wrapper checks W). tree_words
// runs one block per (chunk of TREE_WORDS_CHUNK words, shard) and stores the
// words.
//
// Left for later: items that name the same rows read them once per item
// (from L2, nominally B x L x S x W x 4 bytes); tiling items that share rows
// through shared memory, as the grams stage their rows, would cut that to
// the distinct rows, and the popcount floor above is then the next wall.

#include "scan_common.cuh"

// Operand-stack entries per word; pilosa_tpu_torch/ops/kernels.py holds the
// same number.
#define TREE_MAX_DEPTH 32
// Opcodes and leaf row pointers staged in shared memory; the rest of a longer
// program is read from device memory.
#define TREE_SMEM_OPS 512
#define TREE_SMEM_LEAVES 256
// Fold opcodes (a leaf opcode is the leaf's index, >= 0).
#define TREE_AND -1
#define TREE_OR -2
#define TREE_XOR -3
#define TREE_ANDNOT -4
#define TREE_NOTAND -5
// Words per block of pilosa_tree_words.
#define TREE_WORDS_CHUNK 8192

__device__ __forceinline__ uint32_t tree_fold(int op, uint32_t a, uint32_t b) {
    switch (op) {
        case TREE_AND: return a & b;
        case TREE_OR: return a | b;
        case TREE_XOR: return a ^ b;
        case TREE_ANDNOT: return a & ~b;
        default: return ~a & b;
    }
}

__device__ __forceinline__ uint4 tree_fold(int op, uint4 a, uint4 b) {
    return make_uint4(tree_fold(op, a.x, b.x), tree_fold(op, a.y, b.y),
                      tree_fold(op, a.z, b.z), tree_fold(op, a.w, b.w));
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

// Group i (of V-sized groups) of a leaf row; zeros for an absent row.
template <typename V>
__device__ __forceinline__ V tree_load(const uint32_t* row, int i) {
    if (row == nullptr) return tree_zero<V>();
    return __ldg(reinterpret_cast<const V*>(row) + i);
}

// The table the wrapper uploads in one copy:
//   int64 base[P]           each stack's base pointer, int32[S, rows[p], W]
//   int32 rows[P]
//   int32 code[n_ops]       the postfix program
//   int32 leaf_stack[L]     leaf -> stack
//   int32 slots[B, L]       leaf rows per item (< 0: absent)
// and what one block of item b at shard s reads of it: the staged head of
// the program and of the leaf row pointers, and the table for the rest.
struct TreeProgram {
    const int* s_code;
    const uint32_t* const* s_leaf;
    const long long* base;
    const int* rows;
    const int* code;
    const int* leaf_stack;
    const int* slots;  // item b's row
    int n_ops, s, W;
};

__device__ __forceinline__ const uint32_t* tree_leaf_row(const TreeProgram& t, int l) {
    const int slot = t.slots[l];
    if (slot < 0) return nullptr;
    const int p = t.leaf_stack[l];
    return reinterpret_cast<const uint32_t*>(t.base[p]) +
           ((size_t)t.s * t.rows[p] + slot) * (size_t)t.W;
}

// LONG: the program passes the staged head (the launch decides, so a
// program that fits it pays no test per opcode).
template <bool LONG>
__device__ __forceinline__ int tree_op(const TreeProgram& t, int k) {
    return !LONG || k < TREE_SMEM_OPS ? t.s_code[k] : t.code[k];
}

template <bool LONG>
__device__ __forceinline__ const uint32_t* tree_leaf(const TreeProgram& t, int l) {
    return !LONG || l < TREE_SMEM_LEAVES ? t.s_leaf[l] : tree_leaf_row(t, l);
}

// Run the postfix program on group i of the leaves. The top of the operand
// stack lives in `top`, the n - 1 entries below it in `below`.
template <typename V, bool LONG>
__device__ __forceinline__ V tree_eval(const TreeProgram& t, int i) {
    V below[TREE_MAX_DEPTH - 1];
    V top = tree_zero<V>();
    int n = 0;
    for (int k = 0; k < t.n_ops; ++k) {
        const int op = tree_op<LONG>(t, k);
        if (op >= 0) {
            const V v = tree_load<V>(tree_leaf<LONG>(t, op), i);
            const int next = k + 1 < t.n_ops ? tree_op<LONG>(t, k + 1) : 0;
            if (n > 0 && next < 0) {  // leaf, then a fold: fold into the top
                top = tree_fold(next, top, v);
                ++k;
            } else {
                if (n > 0) below[n - 1] = top;
                top = v;
                ++n;
            }
        } else {
            --n;
            top = tree_fold(op, below[n - 1], top);
        }
    }
    return top;
}

// Item b's program at shard s, with its head staged in shared memory.
__device__ __forceinline__ TreeProgram tree_stage(const unsigned char* table, int P,
                                                  int n_ops, int L, int b, int s, int W,
                                                  int* s_code, const uint32_t** s_leaf) {
    TreeProgram t;
    t.base = reinterpret_cast<const long long*>(table);
    t.rows = reinterpret_cast<const int*>(table + 8 * (size_t)P);
    t.code = t.rows + P;
    t.leaf_stack = t.code + n_ops;
    t.slots = t.leaf_stack + L + (size_t)b * L;
    t.s_code = s_code;
    t.s_leaf = s_leaf;
    t.n_ops = n_ops;
    t.s = s;
    t.W = W;
    for (int k = threadIdx.x; k < min(n_ops, TREE_SMEM_OPS); k += blockDim.x)
        s_code[k] = t.code[k];
    for (int l = threadIdx.x; l < min(L, TREE_SMEM_LEAVES); l += blockDim.x)
        s_leaf[l] = tree_leaf_row(t, l);
    __syncthreads();
    return t;
}

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_count_kernel(const unsigned char* __restrict__ table, int P, int n_ops,
                         int L, int S, int W, int32_t* __restrict__ out) {
    __shared__ int s_code[TREE_SMEM_OPS];
    __shared__ const uint32_t* s_leaf[TREE_SMEM_LEAVES];
    const int b = blockIdx.x;
    const int s = blockIdx.y;
    const TreeProgram t = tree_stage(table, P, n_ops, L, b, s, W, s_code, s_leaf);
    const int groups = W / (int)(sizeof(V) / 4);
    int acc = 0;
    for (int i = threadIdx.x; i < groups; i += blockDim.x)
        acc += tree_popc(tree_eval<V, LONG>(t, i));
    const int total = pilosa_block_sum(acc);
    if (threadIdx.x == 0) out[(size_t)b * S + s] = total;
}

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_words_kernel(const unsigned char* __restrict__ table, int P, int n_ops,
                         int L, int W, uint32_t* __restrict__ out) {
    __shared__ int s_code[TREE_SMEM_OPS];
    __shared__ const uint32_t* s_leaf[TREE_SMEM_LEAVES];
    const int s = blockIdx.y;
    const TreeProgram t = tree_stage(table, P, n_ops, L, 0, s, W, s_code, s_leaf);
    const int per = (int)(sizeof(V) / 4);
    const int groups = W / per;
    const int g0 = blockIdx.x * (TREE_WORDS_CHUNK / per);
    const int g1 = min(groups, g0 + TREE_WORDS_CHUNK / per);
    V* dst = reinterpret_cast<V*>(out + (size_t)s * W);
    for (int i = g0 + threadIdx.x; i < g1; i += blockDim.x)
        dst[i] = tree_eval<V, LONG>(t, i);
}

static bool tree_long(int n_ops, int L) {
    return n_ops > TREE_SMEM_OPS || L > TREE_SMEM_LEAVES;
}

static bool tree_args_ok(int P, int n_ops, int L, int depth, int S, int W, int vec16) {
    return P > 0 && n_ops > 0 && L > 0 && depth >= 1 && depth <= TREE_MAX_DEPTH &&
           S <= 65535 && W < (1 << 26) && !(vec16 && (W & 3));
}

// out: int32[B, S]. table: as above, on the device. depth: the program's
// operand-stack depth (the wrapper computes it). vec16: every row and the
// table's stacks 16-byte aligned with W a multiple of 4. Arguments past the
// limits (a depth past TREE_MAX_DEPTH, W past 2^26) return
// cudaErrorInvalidValue and launch nothing.
extern "C" int pilosa_tree_count(const void* table, int P, int n_ops, int L,
                                 int depth, int B, int S, int W, int vec16,
                                 void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!tree_args_ok(P, n_ops, L, depth, S, W, vec16)) return (int)cudaErrorInvalidValue;
    if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)B, (unsigned)S);
    const unsigned char* t = (const unsigned char*)table;
    cudaStream_t st = (cudaStream_t)stream;
    auto kernel = vec16 ? (tree_long(n_ops, L) ? pilosa_tree_count_kernel<uint4, true>
                                               : pilosa_tree_count_kernel<uint4, false>)
                        : (tree_long(n_ops, L) ? pilosa_tree_count_kernel<uint32_t, true>
                                               : pilosa_tree_count_kernel<uint32_t, false>);
    kernel<<<grid, PILOSA_SCAN_THREADS, 0, st>>>(t, P, n_ops, L, S, W, (int32_t*)out);
    return (int)cudaGetLastError();
}

// out: int32[S, W] (16-byte aligned when vec16); table with B = 1.
extern "C" int pilosa_tree_words(const void* table, int P, int n_ops, int L,
                                 int depth, int S, int W, int vec16, void* out,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!tree_args_ok(P, n_ops, L, depth, S, W, vec16)) return (int)cudaErrorInvalidValue;
    if (S <= 0 || W <= 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)((W + TREE_WORDS_CHUNK - 1) / TREE_WORDS_CHUNK), (unsigned)S);
    const unsigned char* t = (const unsigned char*)table;
    cudaStream_t st = (cudaStream_t)stream;
    auto kernel = vec16 ? (tree_long(n_ops, L) ? pilosa_tree_words_kernel<uint4, true>
                                               : pilosa_tree_words_kernel<uint4, false>)
                        : (tree_long(n_ops, L) ? pilosa_tree_words_kernel<uint32_t, true>
                                               : pilosa_tree_words_kernel<uint32_t, false>);
    kernel<<<grid, PILOSA_SCAN_THREADS, 0, st>>>(t, P, n_ops, L, W, (uint32_t*)out);
    return (int)cudaGetLastError();
}
