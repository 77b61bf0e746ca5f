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
// - elle_square: one step A <- min(A + A.A, 1), launched ceil(log2 pad)
//   times between two buffers. bf16 tensor-core products (mma.sync m16n8k16,
//   fp32 accumulate) on 128x128 output tiles, a 3-stage cp.async ring of
//   32-deep K tiles; the add and the clamp are fused into the epilogue. Every
//   entry is a path count of at most pad, exact in the fp32 accumulator while
//   pad < 2^24, and the epilogue writes 1 where the old entry or the count is
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
// - elle_gather: the dense all_gather, a 16-byte-wide copy of each shard's
//   rows (blockIdx.y = shard) from `blocks` into `full`. A stage of its own,
//   so a transport across cards can take its place and its bytes show.
// - elle_block_square (row 11's step): out = min(b + b.full, 1), the D
//   block-row [P, pad] x [pad, pad] products as one [pad, pad] product with
//   A = `blocks` and B = `full`, on elle_square's tile machinery (the same
//   kernel, given a B pointer apart from A). A 128-row tile may span several
//   shards when P < 128; that is the same product.
//
// What bounds them: elle_square and elle_block_square are 2 pad^3 operations
// per member and step against 4-6 pad^2 bytes, far above the card's 295
// operations per byte, so they are bound by the tensor cores; the others are
// one pass over their matrix and bound by memory. The plain PyTorch version
// of every entry point is in jepsen_tpu_torch/elle/ops.py and the two are
// compared bit for bit.
//
// Every extern "C" entry point returns cudaGetLastError().

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
// elle_square

#define SQ_BM 128
#define SQ_BN 128
#define SQ_BK 32
#define SQ_STAGES 3
#define SQ_THREADS 256
#define SQ_A_LD (SQ_BK + 8)  // halves per A-tile row (80 bytes: ldmatrix is conflict-free)
#define SQ_B_LD (SQ_BN + 8)  // halves per B-tile row (272 bytes)
#define SQ_SMEM (SQ_STAGES * (SQ_BM * SQ_A_LD + SQ_BK * SQ_B_LD) * 2)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 128x128 tile of out = min(A + A.B, 1) for one member: grid (pad/128
// column tiles, pad/128 row tiles, nb). Eight warps in a 2x4 grid, each 64x32
// (4x4 mma tiles). elle_square passes B = A; elle_block_square the gathered
// matrix.
__global__ void __launch_bounds__(SQ_THREADS)
    k_square(const bf16_t* __restrict__ ain, const bf16_t* __restrict__ bin,
             bf16_t* __restrict__ aout, int pad) {
  extern __shared__ __align__(128) unsigned char sq_smem[];
  bf16_t* As = (bf16_t*)sq_smem;                  // [STAGES][BM][A_LD]
  bf16_t* Bs = As + SQ_STAGES * SQ_BM * SQ_A_LD;  // [STAGES][BK][B_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long base = (long)blockIdx.z * pad * pad;
  const bf16_t* A = ain + base;
  const bf16_t* B = bin + base;
  const int row0 = blockIdx.y * SQ_BM, col0 = blockIdx.x * SQ_BN;
  const int KT = pad / SQ_BK;

  // A operand: rows [row0, +128) x k [k0, +32); B operand: k [k0, +32) x
  // columns [col0, +128). 16-byte copies.
  auto load = [&](int stage, int kt) {
    const int k0 = kt * SQ_BK;
    bf16_t* as = As + stage * SQ_BM * SQ_A_LD;
    bf16_t* bs = Bs + stage * SQ_BK * SQ_B_LD;
#pragma unroll
    for (int c = tid; c < SQ_BM * SQ_BK / 8; c += SQ_THREADS) {
      const int r = c >> 2, q = c & 3;
      cp_async16(as + r * SQ_A_LD + q * 8, A + (long)(row0 + r) * pad + k0 + q * 8);
    }
#pragma unroll
    for (int c = tid; c < SQ_BK * SQ_BN / 8; c += SQ_THREADS) {
      const int r = c >> 4, q = c & 15;
      cp_async16(bs + r * SQ_B_LD + q * 8, B + (long)(k0 + r) * pad + col0 + q * 8);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < SQ_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<SQ_STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt-1
    const int nk = kt + SQ_STAGES - 1;
    if (nk < KT) load(nk % SQ_STAGES, nk);
    cp_async_commit();
    const bf16_t* as = As + (kt % SQ_STAGES) * SQ_BM * SQ_A_LD;
    const bf16_t* bs = Bs + (kt % SQ_STAGES) * SQ_BK * SQ_B_LD;
#pragma unroll
    for (int kk = 0; kk < SQ_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                as + (wm * 64 + mi * 16 + (lane & 15)) * SQ_A_LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bfr[2 * nj][0], bfr[2 * nj][1], bfr[2 * nj + 1][0], bfr[2 * nj + 1][1],
                      bs + (kk + (lane & 15)) * SQ_B_LD + wn * 32 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: out = 1 where the old entry or the path count is nonzero.
  bf16_t* Out = aout + base;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
        const int c = col0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        const long off = (long)r * pad + c;
        const uint32_t old = *(const uint32_t*)(A + off);
        const uint32_t lo = (BF16_NONZERO(old) || acc[mi][ni][2 * h] != 0.f) ? BF16_ONE : 0u;
        const uint32_t hi =
            (BF16_NONZERO(old >> 16) || acc[mi][ni][2 * h + 1] != 0.f) ? BF16_ONE : 0u;
        *(uint32_t*)(Out + off) = lo | (hi << 16);
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

// Shard blockIdx.y's rows, n16 16-byte pieces of them, copied from the
// blocks into the full matrix: grid (min(ceil(n16 / 256), 264), shards).
__global__ void __launch_bounds__(XC_THREADS)
    k_gather(const uint4* __restrict__ blocks, uint4* __restrict__ full, long n16) {
  const long base = (long)blockIdx.y * n16;
  for (long i = (long)blockIdx.x * XC_THREADS + threadIdx.x; i < n16;
       i += (long)gridDim.x * XC_THREADS)
    full[base + i] = __ldg(blocks + base + i);
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

static int launch_square(const void* a, const void* b, void* out, int pad, int nb,
                         void* stream) {
  static bool configured = false;
  if (pad % SQ_BM != 0 || pad / SQ_BM > 65535 || nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(k_square, cudaFuncAttributeMaxDynamicSharedMemorySize, SQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(pad / SQ_BN, pad / SQ_BM, nb);
  k_square<<<grid, SQ_THREADS, SQ_SMEM, (cudaStream_t)stream>>>(
      (const bf16_t*)a, (const bf16_t*)b, (bf16_t*)out, pad);
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

// blocks, full: bf16 [rows, cols], rows split into `shards` blocks of whole
// 16-byte pieces.
int elle_gather(void* blocks, void* full, int rows, int cols, int shards, void* stream) {
  if (shards < 1 || shards > MAX_GRID_Y || rows % shards != 0)
    return (int)cudaErrorInvalidValue;
  const long per = (long)(rows / shards) * cols;
  if (per % 8 != 0) return (int)cudaErrorInvalidValue;
  const long n16 = per / 8;
  long bx = (n16 + XC_THREADS - 1) / XC_THREADS;
  const long cap = 132L * 16 / shards + 1;
  if (bx > cap) bx = cap;
  k_gather<<<dim3((unsigned)bx, shards), XC_THREADS, 0, (cudaStream_t)stream>>>(
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
