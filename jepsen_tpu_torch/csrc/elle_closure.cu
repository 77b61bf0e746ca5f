// Transitive closure and SCC labels of a batch of dependency graphs, and the
// block-row sharded closure of one graph, written by hand for Hopper
// (sm_90a). Replaces the reference's XLA closure programs in
// jepsen_tpu/elle/ops.py: `batched_closure_kernel` -> `one` (lines 236-248)
// with the bit packing it ends with, `_pack_device` (line 187), and
// `_sharded_closure_kernel` (lines 296-336) with `_unpack_device` (line 199).
//
// A member is one (graph, edge mask) of a size bucket `pad` (a power of two,
// 128..8192). Its adjacency is a dense bf16 [pad, pad] matrix of 0/1 values;
// every buffer is member-major [nb, pad, pad] (or [nb, pad, pad/32] words,
// [nb, pad] labels), contiguous. Three entry points, launched in this order
// by jepsen_tpu_torch/elle/ops.py `batched_closure`:
//
// - elle_adjacency: zero-fill, then scatter each member's edges. Padding
//   edges carry the sacrificial index `pad` and are dropped (the reference
//   writes them into row/column `pad` of a [pad+1, pad+1] matrix and slices
//   them off).
// - elle_square: one step A <- min(A + A.A, 1) (jepsen_tpu/elle/ops.py
//   lines 240-242), launched ceil(log2 pad) times between two buffers, on
//   the square kernel described below. Every entry is a path count of at
//   most pad, exact in the fp32 accumulator while pad < 2^24, and the epilogue writes 1 where the old entry or the count is
//   nonzero, re-binarising every step, so the bits equal the reference's
//   whatever the rounding, at any pad.
// - elle_labels_pack: reach = A > 0 packed into words (bit j of word w is
//   column 32w+j), and label[i] = the first j with reach[i][j] and
//   reach[j][i], or i (the reference's argmax over (reach & reach^T) | I).
//   One warp per row: it packs the row, and for each word of candidates
//   j < i it reads the 32 entries reach[j][i] of that word's rows as one
//   ballot; it stops at the first mutual bit.
//
// The sharded closure (jepsen_tpu_torch/elle/ops.py `sharded_closure`) keeps
// the D shards of a mesh on this one card: shard d's P = pad/D rows are rows
// d*P.. of one bf16 [pad, pad] `blocks` buffer (double-buffered), exactly as
// shard_map lays P(axis, None), and the reference's all_gather becomes a
// kernel between buffers into ONE `full` matrix that every shard reads (D
// copies would only multiply memory on one card). Four entry points:
//
// - elle_unpack (row 10b): words [r, w] -> bf16 0/1 [r, m], one 16-byte store
//   of 8 columns a thread. The entry (the host's packed adjacency into
//   `blocks`) and, in packed mode, each step's gathered words into `full`.
// - elle_pack_rows: bf16 [r, c] -> words of b > 0, the pack of row 10a
//   without the labels: one coalesced 16-byte load of 8 columns a thread,
//   four lanes joined into a word by shuffles. In packed mode each step it
//   writes every shard's rows into rows d*P of the one `words` buffer (the
//   pack and the all_gather in one pass); it also packs the output.
// - elle_gather: the dense all_gather from `blocks` into `full`: on one
//   card the D row blocks are one contiguous range, copied 16 bytes wide
//   with sixteen streaming loads in flight a thread (below). A stage of its
//   own, so a transport across cards can take its place and its bytes show.
// - elle_block_square (row 11's step): out = min(b + b.full, 1)
//   (jepsen_tpu/elle/ops.py line 325), the D block-row [P, pad] x [pad, pad]
//   products as one [pad, pad] product with A = `blocks` and B = `full`, on
//   the same square kernel given a B apart from A. A 128-row tile may span
//   several shards when P < 128; that is the same product.
//
// The square kernel (k_square). What bounds it: 2 pad^3 operations per
// member and step over 989 TFLOP/s of bf16 tensor cores, against 4-6 pad^2
// bytes, so it is bound by operations, provided each byte fetched from
// device memory feeds enough products: a 128x256 output tile does 2*128*256
// operations for each k against 2*(128+256) bytes of operands, about 85
// operations a byte, so operands shared between tiles in L2 have to supply
// the rest of the card's 295. The design, for Hopper only
// (sm_90a):
//
// - wgmma.mma_async m64n256k16 (m64n128k16 at pad 128, where a row has only
//   128 columns), bf16 operands from shared memory, fp32 accumulators in
//   registers: A (the left matrix) K-major, B (the right one, row-major, so
//   N-contiguous) through wgmma's transpose bit, both 128-byte swizzled;
// - TMA (cp.async.bulk.tensor) loads of 64x64 boxes into a ring of 4 stages
//   of 64-deep K, each with a full and an empty mbarrier; one producer
//   warpgroup whose single thread only issues loads (setmaxnreg gives its
//   registers to the two consumer warpgroups, 64 rows of the tile each);
// - one block per SM (the persistent grid) walking the tiles of every
//   member in bands of 16 row panels with the rows fastest, so the ~132
//   tiles in flight share 16 A row panels and ~9 B column panels in L2;
// - no separate read of the old entries: the old entry A[r][c] is column c
//   of A itself (B = A for elle_square, A = b for elle_block_square), so a
//   consumer copies its old bits out of the A stages whose K range is the
//   tile's columns while the products run; the binarised tile leaves
//   through shared memory by TMA stores, 64 columns at a time, double
//   buffered, while the producer already fills the ring for the next tile.
//
// The tensor maps are encoded on the host for each launch
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint) and
// passed as __grid_constant__ parameters; a batch [nb, pad, pad] is one 2-D
// map of nb*pad rows, since a tile never crosses a member (pad % 128 == 0).
// TMA needs 16-byte-aligned bases; the entry points refuse others.
//
// The other kernels are one pass over their matrix and bound by memory.
// The plain PyTorch version of every entry point is in
// jepsen_tpu_torch/elle/ops.py and the two are compared bit for bit.
//
// Every extern "C" entry point returns cudaGetLastError(), or the square's
// refusal (a bad shape, a misaligned base, a tensor map that did not encode).

#include <cuda.h>  // CUtensorMap and its enums (declarations only; libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

typedef uint16_t bf16_t;  // raw bf16 bits; the kernels need no bf16 arithmetic
#define BF16_ONE 0x3F80u
#define BF16_NONZERO(x) (((x) & 0x7FFFu) != 0u)
#define FULL_MASK 0xFFFFFFFFu

// ---------------------------------------------------------------------------
// elle_adjacency

__global__ void k_zero(uint4* a, long n16) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (long)gridDim.x * blockDim.x)
    a[i] = z;
}

__global__ void k_scatter(const int* __restrict__ src, const int* __restrict__ dst,
                          bf16_t* __restrict__ a, int epad, int pad) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= epad) return;
  const long b = blockIdx.y;
  const int s = src[b * epad + e], d = dst[b * epad + e];
  if (s < 0 || s >= pad || d < 0 || d >= pad) return;  // padding edge
  a[(b * pad + s) * pad + d] = (bf16_t)BF16_ONE;
}

// ---------------------------------------------------------------------------
// elle_square and elle_block_square: one persistent, warp-specialised kernel

#define SQ_BM 128        // output tile rows: one 64-row slab per consumer warpgroup
#define SQ_BK 64         // K depth of a stage: one 128-byte swizzle row of bf16
#define SQ_STAGES 4      // the ring of stages in shared memory
#define SQ_BOX 64        // every TMA box is 64 x 64 bf16, 128-byte swizzled
#define SQ_BOX_BYTES (SQ_BOX * SQ_BOX * 2)
#define SQ_CONSUMERS 2   // consumer warpgroups; warpgroup 0 is the producer
#define SQ_THREADS (128 * (1 + SQ_CONSUMERS))
#define SQ_GROUP 16      // row panels in one band of the tile order
#define SQ_A_BYTES (SQ_BM * SQ_BK * 2)

// Shared memory from a 1024-byte-aligned base (the 128-byte swizzle repeats
// every 1024 bytes): the A ring, the B ring, two 64x64 staging boxes per
// consumer for the output, then full[STAGES] and empty[STAGES] mbarriers.
template <int BN>
struct SqShape {
  static constexpr int kBBytes = SQ_BK * BN * 2;
  static constexpr int kStageBytes = SQ_A_BYTES + kBBytes;
  static constexpr int kCBytes = SQ_CONSUMERS * 2 * SQ_BOX_BYTES;
  static constexpr int kSmem = 1024 + SQ_STAGES * kStageBytes + kCBytes + 2 * SQ_STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64x64 box at (column c0, row c1) into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   (uint64_t)map),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N of this thread's bulk stores still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the TMA store.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` over the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sq_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across a wgmma fence or wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x N] (+)= A[64 x 16] . B[16 x N], fp32 accumulators: A K-major, B
// MN-major (imm-trans-b = 1), both read from shared memory by descriptor;
// scale_d = 0 starts the sums afresh.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

// Tile t of the persistent order: member-major; inside a member, bands of
// SQ_GROUP row panels, and inside a band the row panels fastest, so that the
// tiles in flight at one moment share a few A row panels and B column panels
// in L2.
__device__ __forceinline__ void sq_tile(int t, int tiles_m, int tiles_n, int& member, int& tm,
                                        int& tn) {
  const int per = tiles_m * tiles_n;
  member = t / per;
  const int r = t - member * per;
  const int first = r / (SQ_GROUP * tiles_n) * SQ_GROUP;
  const int rows = min(SQ_GROUP, tiles_m - first);
  const int in = r - first * tiles_n;
  tm = first + in % rows;
  tn = in / rows;
}

// out = 1 where the old entry or (A.B) is nonzero, else 0, for every member
// of a batch laid out as [nb * pad, pad] rows; a SQ_BM x BN output tile
// never crosses a member. One block per SM walks the tiles t = blockIdx.x,
// + gridDim.x, ... Warpgroup 0's first thread issues every TMA load into a
// ring of SQ_STAGES stages (A: 128 rows x 64 k, two boxes; B: 64 k x BN
// columns, BN/64 boxes); warpgroups 1 and 2 each run wgmma on their 64 rows
// of A against the whole B stage, read their old entries out of the A
// stages whose k range is the tile's columns (the old entry A[r][c] is A's
// own column c: B = A for elle_square, and A = b for elle_block_square),
// and store the binarised tile through shared memory by TMA, 64 columns at
// a time, while the producer already fills the ring with the next tile.
template <int BN>
__global__ void __launch_bounds__(SQ_THREADS, 1)
    k_square(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_out, int pad, int nb) {
  typedef SqShape<BN> Sh;
  extern __shared__ unsigned char sq_raw[];
  const uint32_t base = (smem_addr(sq_raw) + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = a_ring + SQ_STAGES * SQ_A_BYTES;
  const uint32_t c_bufs = b_ring + SQ_STAGES * Sh::kBBytes;
  const uint32_t full_bar = c_bufs + Sh::kCBytes;       // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * SQ_STAGES;  // + 8 * stage
  const int tiles_m = pad / SQ_BM, tiles_n = pad / BN;
  const int ntiles = tiles_m * tiles_n * nb;
  const int KT = pad / SQ_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SQ_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, SQ_CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int member, tm, tn;
        sq_tile(t, tiles_m, tiles_n, member, tm, tn);
        const int arow = member * pad + tm * SQ_BM, brow = member * pad, col0 = tn * BN;
        for (int kb = 0; kb < KT; ++kb) {
          const uint32_t full = full_bar + 8 * stage;
          mbar_wait(empty_bar + 8 * stage, phase ^ 1u);  // the first pass finds it free
          mbar_expect_tx(full, Sh::kStageBytes);
          const uint32_t a = a_ring + stage * SQ_A_BYTES, b = b_ring + stage * Sh::kBBytes;
          const int k0 = kb * SQ_BK;
          tma_load(a, &map_a, k0, arow, full);
          tma_load(a + SQ_BOX_BYTES, &map_a, k0, arow + SQ_BOX, full);
#pragma unroll
          for (int j = 0; j < BN / SQ_BOX; ++j)
            tma_load(b + j * SQ_BOX_BYTES, &map_b, col0 + j * SQ_BOX, brow + k0, full);
          if (++stage == SQ_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = (threadIdx.x >> 7) - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, quad = lane >> 2;
    // This thread's accumulator rows are warp*16 + quad (+8): quad is also
    // the row's 128-byte swizzle (row % 8), its columns 8j + 2*(lane%4) (+1).
    const uint32_t row_off = (warp * 16 + quad) * 128, col_off = (lane & 3) * 4;
    const uint32_t stage_bufs = c_bufs + c * 2 * SQ_BOX_BYTES;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, sbuf = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int member, tm, tn;
      sq_tile(t, tiles_m, tiles_n, member, tm, tn);
      const int kb_cols = tn * (BN / SQ_BK);  // the k block of the tile's first columns
      uint32_t old[BN / SQ_BOX];              // bit 4jj + 2h + e: the old entry of acc[4(8s+jj)+2h+e]
#pragma unroll
      for (int s = 0; s < BN / SQ_BOX; ++s) old[s] = 0u;
      int prev = -1;
      for (int kb = 0; kb < KT; ++kb) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a = a_ring + stage * SQ_A_BYTES + c * SQ_BOX_BYTES;  // this slab's rows
        const uint32_t b = b_ring + stage * Sh::kBBytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < SQ_BK / 16; ++k)  // A: +32 bytes a k16 step; B: +16 rows of 128 bytes
          wgmma_tile<BN>(acc, sq_desc(a + 32 * k, 16, 1024),
                         sq_desc(b + 2048 * k, SQ_BOX_BYTES, 1024), (kb | k) != 0);
        wgmma_commit();
        const int s = kb - kb_cols;
        if (s >= 0 && s < BN / SQ_BOX) {  // this A stage holds the old entries of columns 64s..
          uint32_t bits = 0u;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v =
                  ld_shared_u32(a + row_off + h * 1024 + ((jj ^ quad) << 4) + col_off);
              bits |= (BF16_NONZERO(v) ? 1u : 0u) << (4 * jj + 2 * h);
              bits |= (BF16_NONZERO(v >> 16) ? 1u : 0u) << (4 * jj + 2 * h + 1);
            }
#pragma unroll
          for (int si = 0; si < BN / SQ_BOX; ++si)
            if (si == s) old[si] = bits;
        }
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
        }
        prev = stage;
        if (++stage == SQ_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

      // Epilogue: 64 columns at a time into a staging box, then a TMA store.
      const int orow = member * pad + tm * SQ_BM + c * SQ_BOX;
#pragma unroll
      for (int s = 0; s < BN / SQ_BOX; ++s) {
        const uint32_t buf = stage_bufs + sbuf * SQ_BOX_BYTES;
        if (tid == 0) bulk_wait_read<1>();  // this box's previous store has read it
        named_sync(1 + c);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * s + jj) + 2 * h;
            const uint32_t ob = old[s] >> (4 * jj + 2 * h);
            const uint32_t lo = ((ob & 1u) || acc[i] != 0.f) ? BF16_ONE : 0u;
            const uint32_t hi = ((ob & 2u) || acc[i + 1] != 0.f) ? BF16_ONE : 0u;
            st_shared_u32(buf + row_off + h * 1024 + ((jj ^ quad) << 4) + col_off, lo | (hi << 16));
          }
        fence_proxy_async();
        named_sync(1 + c);
        if (tid == 0) {
          tma_store(&map_out, buf, tn * BN + s * SQ_BOX, orow);
          bulk_commit();
        }
        sbuf ^= 1;
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// ---------------------------------------------------------------------------
// elle_labels_pack

#define LP_WARPS 8

// One warp per row i of one member: grid (pad / LP_WARPS, nb).
__global__ void __launch_bounds__(LP_WARPS * 32)
    k_labels_pack(const bf16_t* __restrict__ a, uint32_t* __restrict__ packed,
                  int* __restrict__ labels, int pad) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * LP_WARPS + (threadIdx.x >> 5);
  if (i >= pad) return;  // warp-uniform
  const long b = blockIdx.y;
  const bf16_t* A = a + b * pad * pad;
  const bf16_t* row = A + (long)i * pad;
  const int nw = pad >> 5;
  uint32_t* prow = packed + (b * pad + i) * nw;
  int label = i;
  bool found = false;
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + lane;
    uint32_t word = 0u;
    if (w < nw) {
      // Lane w packs columns [32w, 32w+32): 64 bytes, four 16-byte loads.
      const uint4* src = (const uint4*)(row + (long)w * 32);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = __ldg(src + q);
        const uint32_t parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          word |= (uint32_t)BF16_NONZERO(parts[e]) << (q * 8 + 2 * e);
          word |= (uint32_t)BF16_NONZERO(parts[e] >> 16) << (q * 8 + 2 * e + 1);
        }
      }
      prow[w] = word;
    }
    if (!found && w0 * 32 < i) {  // warp-uniform
      // Candidates j < i of this lane's word, in increasing word order.
      const int jb = w * 32;
      uint32_t cand = jb >= i ? 0u : (jb + 32 > i ? word & ((1u << (i - jb)) - 1u) : word);
      uint32_t words = __ballot_sync(FULL_MASK, cand != 0u);
      while (words) {
        const int k = __ffs(words) - 1;
        words &= words - 1u;
        const uint32_t cw = __shfl_sync(FULL_MASK, cand, k);
        const int j0 = (w0 + k) * 32;
        // Bit l: reach[j0 + l][i].
        const uint32_t col = __ballot_sync(FULL_MASK, BF16_NONZERO(A[(long)(j0 + lane) * pad + i]));
        const uint32_t mutual = cw & col;
        if (mutual) {
          label = j0 + __ffs(mutual) - 1;
          found = true;
          break;
        }
      }
    }
  }
  if (lane == 0) labels[b * pad + i] = label;
}

// ---------------------------------------------------------------------------
// The sharded closure's exchange: elle_unpack, elle_pack_rows, elle_gather

#define XC_THREADS 256
#define MAX_GRID_Y 65535

// Thread g of a row writes columns [8g, 8g+8) from byte g%4 of word g/4:
// grid (ceil(ceil(m/8) / 256), min(r, 65535)), rows strided by gridDim.y.
__global__ void __launch_bounds__(XC_THREADS)
    k_unpack(const uint32_t* __restrict__ words, bf16_t* __restrict__ out, int r, int w,
             int m) {
  const int g = blockIdx.x * XC_THREADS + threadIdx.x;
  if (8 * g >= m) return;
  for (long row = blockIdx.y; row < r; row += gridDim.y) {
    const uint32_t byte = (__ldg(words + row * w + (g >> 2)) >> (8 * (g & 3))) & 0xFFu;
    bf16_t* dst = out + row * m + 8 * g;
    if ((m & 7) == 0) {  // rows start on 16 bytes: one store of 8 columns
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (((byte >> (2 * e)) & 1u) ? BF16_ONE : 0u) |
               ((((byte >> (2 * e + 1)) & 1u) ? BF16_ONE : 0u) << 16);
      *(uint4*)dst = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      const int cols = min(8, m - 8 * g);
      for (int j = 0; j < cols; ++j) dst[j] = ((byte >> j) & 1u) ? (bf16_t)BF16_ONE : (bf16_t)0;
    }
  }
}

// Thread g of a row reads columns [8g, 8g+8) (one 16-byte load) into a byte;
// lanes 4k..4k+3 join theirs into word g/4 by shuffles. c % 32 == 0, so the
// four lanes of a word are all inside the row or all past it. Grid as
// k_unpack's over c/8 groups.
__global__ void __launch_bounds__(XC_THREADS)
    k_pack_rows(const bf16_t* __restrict__ a, uint32_t* __restrict__ words, int r, int c) {
  const int g = blockIdx.x * XC_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = 8 * g < c;
  for (long row = blockIdx.y; row < r; row += gridDim.y) {  // block-uniform
    uint32_t byte = 0u;
    if (live) {
      const uint4 v = __ldg((const uint4*)(a + row * c) + g);
      const uint32_t parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        byte |= ((uint32_t)BF16_NONZERO(parts[e]) << (2 * e)) |
                ((uint32_t)BF16_NONZERO(parts[e] >> 16) << (2 * e + 1));
    }
    uint32_t word = byte << (8 * (lane & 3));
    word |= __shfl_xor_sync(FULL_MASK, word, 1);
    word |= __shfl_xor_sync(FULL_MASK, word, 2);
    if (live && (lane & 3) == 0) words[row * (c >> 5) + (g >> 2)] = word;
  }
}

// elle_gather: the D shards' row blocks are rows d*P.. of `blocks` and go
// to the same rows of `full`, so on one card the all_gather is one
// contiguous copy of n16 16-byte pieces. It is bound by bytes (each read
// once and written once: 2 x 2 GiB at pad 32768 through a 50 MB L2), so
// each thread issues GA_UNROLL independent streaming loads (evict-first)
// before their stores, and the grid is GA_BLOCKS_PER_SM blocks an SM:
// 128 KB in flight an SM, several times what HBM's latency needs. Of 4-16
// loads a thread at 2-8 blocks an SM, with and without the hints, this
// was the fastest on the H100; bulk copies through a shared-memory ring
// came within 2% of it either way, at several times the code.
#define GA_UNROLL 16
#define GA_BLOCKS_PER_SM 2

__global__ void __launch_bounds__(XC_THREADS)
    k_gather(const uint4* __restrict__ blocks, uint4* __restrict__ full, long n16) {
  const long step = (long)gridDim.x * XC_THREADS * GA_UNROLL;
  for (long i0 = (long)blockIdx.x * XC_THREADS * GA_UNROLL + threadIdx.x; i0 < n16;
       i0 += step) {
    uint4 v[GA_UNROLL];
#pragma unroll
    for (int u = 0; u < GA_UNROLL; ++u)
      if (i0 + u * XC_THREADS < n16) v[u] = __ldcs(blocks + i0 + u * XC_THREADS);
#pragma unroll
    for (int u = 0; u < GA_UNROLL; ++u)
      if (i0 + u * XC_THREADS < n16) __stcs(full + i0 + u * XC_THREADS, v[u]);
  }
}

// ---------------------------------------------------------------------------
// Host side of the square

// The square's tensor maps. cuTensorMapEncodeTiled lives in libcuda: it is
// fetched once through the runtime's entry-point query, so the library
// links against the runtime alone.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 [rows, pad] row-major matrix read or written in 64x64 boxes,
// 128-byte swizzled. Returns 0, or the error the entry point returns.
static int square_map(CUtensorMap* map, const void* ptr, long rows, int pad) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (((uintptr_t)ptr & 15u) != 0u) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pad * sizeof(bf16_t)};
  const cuuint32_t box[2] = {SQ_BOX, SQ_BOX};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)ptr, dims, strides,
                            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The current device's SM count: the persistent grid.
static int sm_count(int* n) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *n = cached[dev];
  return 0;
}

template <int BN>
static int launch_square_tiles(const CUtensorMap& ma, const CUtensorMap& mb,
                               const CUtensorMap& mo, int pad, int nb, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k_square<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SqShape<BN>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long tiles = (long)(pad / SQ_BM) * (pad / BN) * nb;
  const int grid = (int)(tiles < sms ? tiles : sms);
  k_square<BN><<<grid, SQ_THREADS, SqShape<BN>::kSmem, s>>>(ma, mb, mo, pad, nb);
  return (int)cudaGetLastError();
}

// out = min(A + A.B, 1) for nb members: A, B, out bf16 [nb, pad, pad] (B's
// member stride pad*pad like A's; nb = 1 for the block square). 256-column
// tiles, or 128-column ones where pad is not a multiple of 256 (pad 128).
static int launch_square(const void* a, const void* b, void* out, int pad, int nb,
                         void* stream) {
  if (pad % SQ_BM != 0 || nb < 1 || nb > 65535 || (long)nb * pad > 0x7FFFFFFFL ||
      (long)(pad / SQ_BM) * (pad / SQ_BM) * nb > 0x7FFFFFFFL)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)nb * pad;
  CUtensorMap ma, mb, mo;
  int rc = square_map(&ma, a, rows, pad);
  if (rc == 0) rc = square_map(&mb, b, rows, pad);
  if (rc == 0) rc = square_map(&mo, out, rows, pad);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  return pad % 256 == 0 ? launch_square_tiles<256>(ma, mb, mo, pad, nb, s)
                        : launch_square_tiles<128>(ma, mb, mo, pad, nb, s);
}

// ---------------------------------------------------------------------------
// C entry points (ctypes). Pointers and the stream arrive as void*.

extern "C" {

// src, dst: int32 [nb, epad]; a: bf16 [nb, pad, pad].
int elle_adjacency(void* src, void* dst, void* a, int epad, int pad, int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (pad % SQ_BM != 0 || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  const long n16 = (long)nb * pad * pad / 8;
  long blocks = (n16 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  k_zero<<<(unsigned)blocks, 256, 0, s>>>((uint4*)a, n16);
  if (epad > 0)
    k_scatter<<<dim3((epad + 255) / 256, nb), 256, 0, s>>>((const int*)src, (const int*)dst,
                                                         (bf16_t*)a, epad, pad);
  return (int)cudaGetLastError();
}

// a_in, a_out: bf16 [nb, pad, pad], distinct buffers.
int elle_square(void* a_in, void* a_out, int pad, int nb, void* stream) {
  return launch_square(a_in, a_in, a_out, pad, nb, stream);
}

// b, full, out: bf16 [pad, pad]; out distinct from both.
int elle_block_square(void* b, void* full, void* out, int pad, void* stream) {
  return launch_square(b, full, out, pad, 1, stream);
}

// The exchange kernels' grid: blocks of 256 eight-column groups across a
// row, and rows (strided past 65535).
static unsigned groups_grid(int cols) {
  return (unsigned)((cols + 8 * XC_THREADS - 1) / (8 * XC_THREADS));
}
static unsigned rows_grid(int rows) { return (unsigned)(rows < MAX_GRID_Y ? rows : MAX_GRID_Y); }

// words: u32 [r, w]; out: bf16 [r, m], m <= 32 w.
int elle_unpack(void* words, void* out, int r, int w, int m, void* stream) {
  if (r < 1 || m < 1 || m > 32L * w) return (int)cudaErrorInvalidValue;
  dim3 grid(groups_grid(m), rows_grid(r));
  k_unpack<<<grid, XC_THREADS, 0, (cudaStream_t)stream>>>((const uint32_t*)words,
                                                          (bf16_t*)out, r, w, m);
  return (int)cudaGetLastError();
}

// a: bf16 [r, c], c % 32 == 0; words: u32 [r, c/32].
int elle_pack_rows(void* a, void* words, int r, int c, void* stream) {
  if (r < 1 || c < 32 || c % 32 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(groups_grid(c), rows_grid(r));
  k_pack_rows<<<grid, XC_THREADS, 0, (cudaStream_t)stream>>>((const bf16_t*)a,
                                                             (uint32_t*)words, r, c);
  return (int)cudaGetLastError();
}

// blocks, full: bf16 [rows, cols] at 16-byte-aligned bases, rows split
// into `shards` blocks of whole 16-byte pieces. The shards are the seam a
// transport across cards (one block a card) takes the place of; on one
// card their blocks are one contiguous range.
int elle_gather(void* blocks, void* full, int rows, int cols, int shards, void* stream) {
  if (shards < 1 || shards > MAX_GRID_Y || rows < 1 || cols < 1 || rows % shards != 0)
    return (int)cudaErrorInvalidValue;
  const long per = (long)(rows / shards) * cols;
  if (per % 8 != 0 || ((uintptr_t)blocks | (uintptr_t)full) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long n16 = per / 8 * shards;
  const long need = (n16 + XC_THREADS * GA_UNROLL - 1) / (XC_THREADS * GA_UNROLL);
  const long cap = (long)sms * GA_BLOCKS_PER_SM;
  k_gather<<<(unsigned)(need < cap ? need : cap), XC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)blocks, (uint4*)full, n16);
  return (int)cudaGetLastError();
}

// a: bf16 [nb, pad, pad]; packed: u32 [nb, pad, pad/32]; labels: int32 [nb, pad].
int elle_labels_pack(void* a, void* packed, void* labels, int pad, int nb, void* stream) {
  if (pad % SQ_BM != 0 || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  k_labels_pack<<<dim3(pad / LP_WARPS, nb), LP_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16_t*)a, (uint32_t*)packed, (int*)labels, pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
