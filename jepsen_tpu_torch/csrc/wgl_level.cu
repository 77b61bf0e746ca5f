// One BFS level of the WGL linearizability search, written by hand for
// Hopper (sm_90a), over a batch of nb independent searches (members).
// Replaces the reference's XLA level program, jepsen_tpu/ops/wgl.py
// `_build_kernel` -> `level` (lines 301-934), its vmapped batch form
// `_build_batch_kernel` (line 949), every device model's `step_jax` it
// inlines (jepsen_tpu/models/*.py; see "Model steps" below), and the
// re-batch of stacked frontiers between rungs (`wgl_regroup`, below). The
// single-history search launches the same entry points with nb = 1.
//
// A level is a fixed sequence of launches on one stream, one launch per
// stage for the whole batch; the plain PyTorch version of every entry
// point is in jepsen_tpu_torch/ops/wgl_level.py and the two are compared
// bit for bit. The member is a grid coordinate (blockIdx.y, or blockIdx.x
// for the one-block-per-member kernels), never part of a sort key: every
// buffer is member-major ([nb, ...], contiguous) and each kernel offsets
// its pointers by its member's stride. Every kernel first reads its
// member's control block `ctl[b]` and returns at once when
// ctl[b][CTL_GO] == 0, so the host can enqueue levels ahead of the stop
// test (reference lines 830-873) and a stopped member costs one read.
// A member's true op counts nD and nO (the tables are padded to the
// batch's common ND, NO) live in its control block.
//
// What bounds it: every stage moves a few bytes per candidate row and does
// a handful of integer operations on them, so the level is memory- and
// latency-bound (the byte floor is `level_byte_floor` in ops/wgl.py).
// At the main path's shapes most launches are small and the level is
// bound by launch latency; the design keeps each stage one pass over its
// rows with no host round trip inside a level, the frontier is updated in
// place, and a batch adds members to each launch's grid instead of
// launches.
//
// Every extern "C" entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define CTL_LVL 0
#define CTL_ACC 1
#define CTL_OVF 2
#define CTL_FMAX 3
#define CTL_STUCK 4
#define CTL_MAXLVL 5
#define CTL_LOSSY 6
#define CTL_GO 7
#define CTL_FCOUNT 8
#define CTL_NEXP 9
#define CTL_ACCNOW 10
#define CTL_ROWOVF 11
#define CTL_COUNT 12
#define CTL_ND 13
#define CTL_NO 14
// Frontier-sharded levels only (the cross-shard reduce in the last block
// of k_prune, or of k_chunk_init at a chunk's start, writes them,
// replicated to every shard's block): this level's global keep count and
// overflow, and the sum, max and min over shards of the frontier counts
// the level leaves (or the chunk starts with).
#define CTL_GCOUNT 15
#define CTL_GOVF 16
#define CTL_NSUM 17
#define CTL_NMAX 18
#define CTL_NMIN 19
#define CTL_SIZE 20

// Exchange modes of a frontier-sharded level (0: not sharded).
#define EX_ALLTOALL 1
#define EX_ALLGATHER 2
// Shards of one mesh (the ops wrapper's limit).
#define MAX_SHARDS 256

#define I32MAX 0x7FFFFFFF
#define UNKNOWN_VAL ((int)0x80000000)
#define FULL 0xFFFFFFFFu

// The radix sort (K3 below). Path S: pairs one block holds (must match
// _build.SORT_CTA_MAX), items a thread holds there, and the stride of the
// per-warp digit counters (257: the scan's column reads avoid bank
// conflicts). Path L: threads and items of a tile, the tile (must match
// _build.SORT_TILE) and the per-member state header (_build.SORT_HDR).
#define RS_CTA_MAX 16384
#define RS_CTA_IPT 16
#define RS_CNT 257
#define RS_L_THREADS 512
#define RS_L_IPT 8
#define RS_TILE (RS_L_THREADS * RS_L_IPT)
#define RS_HDR 1040

typedef unsigned int u32;

__device__ __forceinline__ bool stopped(const int* ctl) {
  return ctl != nullptr && ctl[CTL_GO] == 0;
}

// Member b's control block (null stays null: a stage run outside a search).
__device__ __forceinline__ const int* member_ctl(const int* ctl, int b) {
  return ctl ? ctl + (size_t)b * CTL_SIZE : nullptr;
}

__device__ __forceinline__ u32 lane_lt_mask(int lane) {
  return (lane == 0) ? 0u : (FULL >> (32 - lane));
}

// Decoupled look-back (Merrill & Garland 2016), used by the stage-1
// compaction and the radix sort's Onesweep passes: a tile publishes its
// own count, then the count through it, in one 32-bit word (two flag
// bits, a 30-bit count; zero means not yet published). The sort's words
// are written with release and read with acquire semantics; the stage-1
// compaction keeps its words beside a call epoch (see K2).
#define LB_AGG (1u << 30)   // the tile's own count
#define LB_INCL (2u << 30)  // the count through this tile
#define LB_VALUE (LB_AGG - 1u)

__device__ __forceinline__ u32 ld_acquire(const u32* p) {
  u32 v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u32* p, u32 v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// atomicAdd(p, 1) with acq_rel semantics at device scope (atomicAdd is
// relaxed): the ticket that tells a launch's last block that every other
// block's writes before its ticket are visible to it.
__device__ __forceinline__ u32 ticket_acq_rel(u32* p) {
  u32 t;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(t) : "l"(p) : "memory");
  return t;
}

// A load from L2, never from a stale L1 line (ld.global.cg): the last
// block's reads of the other shards' control blocks, after the ticket's
// acquire. A plain load to the compiler, so a lane's loads issue together.
__device__ __forceinline__ int ld_l2(const int* p) { return __ldcg(p); }

// ---------------------------------------------------------------------------
// Block-wide exclusive sum (blockDim.x a multiple of 32, at most 1024)

__device__ int block_excl_sum(int v, int* total) {
  __shared__ int ws[32];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < (int)(blockDim.x >> 5) ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    ws[lane] = s;  // inclusive warp-total prefix
  }
  __syncthreads();
  int before = (w > 0) ? ws[w - 1] : 0;
  int res = before + x - v;
  if (total) *total = ws[31];
  __syncthreads();
  return res;
}

// ---------------------------------------------------------------------------
// Cross-shard reductions of a frontier-sharded search (the reference's
// pmax / psum / pmin over the mesh axis). The D shards of a mesh are the
// members of one batch on one card, so a collective over them is a pass
// over their D control blocks by the last block of a launch that spans
// every shard: each block takes an acq_rel ticket after its own writes,
// and the block that draws the last one runs the reduce on warp 0 (a
// lane a shard, shuffles across the warp, the lanes looping when D > 32)
// and writes the result to every shard's block. No block of that launch
// reads the fields the reduce writes.

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Rows shard s of D keeps: alltoall, its own owned rows; allgather, its
// slice of the global order of `count` kept rows.
__device__ __forceinline__ int shard_kept(int mode, int count_local, int count, int s, int F,
                                          int D) {
  if (mode == EX_ALLTOALL) return min(count_local, F);
  return max(0, min(min(count, F * D) - s * F, F));
}

// Writes the sum, max and min of the shards' frontier counts `f` (lane
// values, one a shard) to every shard; warp 0.
__device__ __forceinline__ void put_counts(int* ctl, int D, int sum, int mx, int mn, int lane) {
  sum = warp_sum(sum);
  mx = warp_max(mx);
  mn = warp_min(mn);
  for (int s = lane; s < D; s += 32) {
    int* c = ctl + (size_t)s * CTL_SIZE;
    c[CTL_NSUM] = sum;
    c[CTL_NMAX] = mx;
    c[CTL_NMIN] = mn;
  }
}

// At a chunk's start (reference lines 830-836): the shards' frontier
// counts and the global stop test (shard 0's loop carry, which every shard
// holds). All loads issue in one round.
__device__ void chunk_reduce(int* ctl, int D) {
  const int lane = threadIdx.x & 31;
  const int acc = ld_l2(ctl + CTL_ACC), lossy = ld_l2(ctl + CTL_LOSSY),
            ovf = ld_l2(ctl + CTL_OVF), stuck = ld_l2(ctl + CTL_STUCK),
            lvl = ld_l2(ctl + CTL_LVL), maxlvl = ld_l2(ctl + CTL_MAXLVL);
  int sum = 0, mx = 0, mn = I32MAX;
  for (int s = lane; s < D; s += 32) {
    const int f = ld_l2(ctl + (size_t)s * CTL_SIZE + CTL_FCOUNT);
    sum += f;
    mx = max(mx, f);
    mn = min(mn, f);
  }
  const int nonempty = warp_sum(sum) > 0;
  const bool go = !acc && (lossy || !ovf) && !stuck && nonempty && lvl < maxlvl;
  for (int s = lane; s < D; s += 32) ctl[(size_t)s * CTL_SIZE + CTL_GO] = go ? 1 : 0;
  put_counts(ctl, D, sum, mx, mn, lane);
}

// After the prune: acc_now (pmax, line 490), pre_ovf (pmax, line 612), the
// keep count (psum under alltoall, line 697; shard 0's under allgather,
// where every shard counts the same global rows) and its overflow, and the
// frontier count each shard holds after the level (the finalize's stop
// test reads their sum, the chunk's flags their sum, max and min: lines
// 877-890). Nothing when shard 0 is stopped (every shard's go is the
// same). A lane holds its shards' fields (at most MAX_SHARDS / 32), all
// loaded in one round.
__device__ void level_reduce(int* ctl, int D, int F, int P, int mode) {
  constexpr int PER = MAX_SHARDS / 32;
  const int lane = threadIdx.x & 31;
  const int go0 = ld_l2(ctl + CTL_GO), lossy = ld_l2(ctl + CTL_LOSSY),
            count0 = ld_l2(ctl + CTL_COUNT);
  int cnt[PER], fc[PER];
  bool acc = false, pre = false, big = false;
  int csum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = lane + 32 * k;
    cnt[k] = fc[k] = 0;
    if (s < D) {
      const int* c = ctl + (size_t)s * CTL_SIZE;
      cnt[k] = ld_l2(c + CTL_COUNT);
      fc[k] = ld_l2(c + CTL_FCOUNT);
      acc = acc || ld_l2(c + CTL_ACCNOW) != 0;
      pre = pre || ld_l2(c + CTL_ROWOVF) != 0 || ld_l2(c + CTL_NEXP) > P;
      big = big || cnt[k] > F;
      csum += cnt[k];
    }
  }
  if (go0 == 0) return;  // uniform across the warp
  // Every shuffle and vote runs on the whole warp before any branch.
  const int a2a = mode == EX_ALLTOALL;
  csum = warp_sum(csum);
  const bool any_pre = __any_sync(FULL, pre), any_big = __any_sync(FULL, big);
  const int accnow = __any_sync(FULL, acc) ? 1 : 0;
  const int count = a2a ? csum : count0;
  const bool ovf_now = any_pre || (a2a ? any_big : count > F * D);
  const bool dead = (ovf_now && !lossy) || count == 0;
  int sum = 0, mx = 0, mn = I32MAX;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = lane + 32 * k;
    if (s < D) {
      const int f = dead ? fc[k] : shard_kept(mode, cnt[k], count, s, F, D);
      sum += f;
      mx = max(mx, f);
      mn = min(mn, f);
    }
  }
  for (int s = lane; s < D; s += 32) {
    int* c = ctl + (size_t)s * CTL_SIZE;
    c[CTL_ACCNOW] = accnow;
    c[CTL_GCOUNT] = count;
    c[CTL_GOVF] = ovf_now ? 1 : 0;
  }
  put_counts(ctl, D, sum, mx, mn, lane);
}

// ---------------------------------------------------------------------------
// Chunk start (reference lines 830-843 and the loop carry the reference's
// while_loop starts from): the whole start of a chunk in one launch, one
// block a member. Each member's control block gets its initial values (the
// level it starts at, its level budget, the beam flag and its true op
// counts; every other field zero), its stats ring is zeroed, and its
// frontier count and stop test are computed. With `ticket` (one zero word,
// left zero) the members are the D shards of one sharded search, and the
// last block by the ticket, taken after thread 0 wrote the block's control
// block, runs the chunk-start reduce (chunk_reduce).
//
// What bounds it: the valid flags read (F bytes a member) and the stats
// ring written (8 KB a member) are a few microseconds of HBM time at most;
// the launch and one dependent chain (count, stop test, ticket, reduce)
// set its time. The parent design paid more than the kernel: the host
// built the control blocks in pageable memory, copied them to the card (a
// copy that holds the host and that no stream capture can take) and
// enqueued a memset of the stats rings before the count. Here the initial
// values ride in the launch's parameters (CsArgs): one row for every
// member (a sharded search's shards, a single search), or a row a member
// up to CS_INLINE members. A larger batch keeps its values in a small
// table on the card (CS_TW words a member), written once per rung by the
// host: there each chunk after the rung's first starts where the member's
// last chunk ended (its control block's level) with the rung's budget of
// `lpc` levels while the member is active (the batch ladder's rule, the
// active flag kept in the table by this kernel), else with none.

#define CS_THREADS 256
#define CS_INLINE 128  // members whose initial values ride in the parameters
#define CS_TW 8        // words a member of the ladder table
#define CS_ENTRY 0     // the level the member enters the rung at
#define CS_TOTAL 1     // the levels it may run in all (nD + nO + 1)
#define CS_LOSSY 2
#define CS_ND 3
#define CS_NO 4
#define CS_ACTIVE 5  // 1 active, 0 not; CS_FRESH before the rung's first chunk
#define CS_FRESH 2

struct CsArgs {
  int n;    // rows below: 1 (every member takes row 0), nb, or 0 (the ladder table)
  int lpc;  // the ladder's level budget a chunk (n == 0)
  int lvl0[CS_INLINE], maxlvl[CS_INLINE], nd[CS_INLINE], no[CS_INLINE];
  unsigned char lossy[CS_INLINE];
};
// 2184 bytes: under the 4 KB that every toolkit and driver takes for a
// launch's parameters (CUDA 12.1 and later take up to 32764 on sm_70+).
static_assert(sizeof(CsArgs) <= 4096, "the chunk start's parameters exceed 4 KB");

__global__ void __launch_bounds__(CS_THREADS)
k_chunk_init(const __grid_constant__ CsArgs a, int* ctl, const unsigned char* valid, int* stats,
             int stat_words, int* table, int F, u32* ticket) {
  const int b = blockIdx.x;
  int* c = ctl + (size_t)b * CTL_SIZE;
  int* st = stats + (size_t)b * stat_words;
  for (int i = threadIdx.x; i < stat_words; i += CS_THREADS) st[i] = 0;
  valid += (size_t)b * F;
  int n = 0;
  if ((F & 15) == 0 && ((uintptr_t)valid & 15) == 0) {
    // 16 flags a load; a flag is one byte, 0 or 1
    const uint4* v4 = (const uint4*)valid;
    for (int i = threadIdx.x; i < (F >> 4); i += CS_THREADS) {
      const uint4 w = v4[i];
      n += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    }
  } else {
    for (int i = threadIdx.x; i < F; i += CS_THREADS) n += valid[i] ? 1 : 0;
  }
  int total;
  block_excl_sum(n, &total);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    int lvl0, maxlvl, lossy, nd, no;
    if (a.n == 0) {
      // the ladder: the previous chunk's control block, read before it is
      // overwritten below
      int* t = table + (size_t)b * CS_TW;
      const int total_lv = t[CS_TOTAL];
      lossy = t[CS_LOSSY];
      nd = t[CS_ND];
      no = t[CS_NO];
      int act;
      if (t[CS_ACTIVE] == CS_FRESH) {
        lvl0 = t[CS_ENTRY];
        act = 1;
      } else {
        lvl0 = c[CTL_LVL];
        act = t[CS_ACTIVE] && !c[CTL_ACC] && (lossy || !c[CTL_OVF]) && c[CTL_FCOUNT] > 0 &&
              !c[CTL_STUCK] && lvl0 < total_lv;
      }
      t[CS_ACTIVE] = act;
      maxlvl = act ? min(total_lv, lvl0 + a.lpc) : lvl0;
    } else {
      const int r = a.n == 1 ? 0 : b;
      lvl0 = a.lvl0[r];
      maxlvl = a.maxlvl[r];
      lossy = a.lossy[r];
      nd = a.nd[r];
      no = a.no[r];
    }
    for (int k = 0; k < CTL_SIZE; ++k) c[k] = 0;
    c[CTL_LVL] = lvl0;
    c[CTL_FMAX] = 1;
    c[CTL_MAXLVL] = maxlvl;
    c[CTL_LOSSY] = lossy;
    c[CTL_ND] = nd;
    c[CTL_NO] = no;
    c[CTL_FCOUNT] = total;
    // acc, ovf and stuck start clear (reference lines 830-843)
    c[CTL_GO] = (total > 0 && lvl0 < maxlvl) ? 1 : 0;
    if (ticket) s_last = ticket_acq_rel(ticket) == gridDim.x - 1;
  }
  if (ticket == nullptr) return;
  __syncthreads();
  if (s_last && threadIdx.x < 32) {
    if (threadIdx.x == 0) *ticket = 0u;
    chunk_reduce(ctl, gridDim.x);
  }
}

// The fused key of a row (reference lines 628-645): a valid row's is its
// FNV group hash shifted right by one, an invalid row's has the sign bit
// set. The kernels that write a level's rows write their keys with them:
// the single-stage expand (an invalid slot's key is the sign bit alone: its
// row is not written, and no stage reads it), stage 1, the route and the
// exchange (a zero row's key is zero_row_key).
#define KEY_INVALID 0x80000000u

// The FNV group hash of a row's NID identity words: they are loaded eight
// at a time before they are combined, so a row in device memory costs one
// round trip, not NID.
__device__ __forceinline__ u32 fnv_row(const u32* r, int NID) {
  u32 gh = 2166136261u;
  for (int k0 = 0; k0 < NID; k0 += 8) {
    u32 w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = k0 + k < NID ? r[k0 + k] : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < NID) gh = (gh ^ w[k]) * 16777619u;
  }
  return gh;
}

// The key of an invalid row of NID zero words: the received rows' empty
// slots.
__device__ __forceinline__ u32 zero_row_key(int NID) {
  u32 gh = 2166136261u;
  for (int k = 0; k < NID; ++k) gh *= 16777619u;
  return (gh >> 1) | KEY_INVALID;
}

// ---------------------------------------------------------------------------
// K1 expand (reference lines 363-490): one warp per configuration, EX_WARPS
// configurations a block, the member in blockIdx.y.
//
// What bounds it: a few hundred bytes a configuration (its frontier row,
// its window's table rows, its valid candidate rows), about 0.2 us of HBM
// time at the main path's F = 4096; what costs is the chain of dependent
// loads (frontier row -> window rows -> stores) and the instructions a
// configuration issues. The design:
//
// - two round trips: the control block, p and valid first, so that a
//   stopped member or an invalid configuration (most of a batch's at the
//   ladder's top rung) costs one and writes only its zero nvalid words;
//   then the configuration's masks and state, the open-op table fields and
//   its window's table rows, all at once;
// - the window is read once: lane l holds the table fields of slots
//   c * 32 + l in registers (KDM words at most, a template parameter), and
//   m1, its slot am and m2 come from one butterfly that carries (min,
//   argmin, second min);
// - one model step a candidate, for every family: the child's state lanes
//   are written straight into the row's slot of the warp's staging buffer;
// - the selected layout's written rows are one contiguous run ([0,
//   min(cnt, B)) of the configuration's B), staged 32 at a time and stored
//   as 16-byte stores (a refused candidate's row holds whatever its slot
//   held: its nvalid byte is zero); its nvalid bytes are gathered in
//   shared memory and written as whole words at the end. The unselected
//   layout stores each valid row from its lane and nvalid as words of a
//   ballot;
// - at most 64 registers a thread for windows of up to 64 slots
//   (EX_MIN_BLOCKS), so that a full frontier of 4096 configurations is one
//   wave of warps on the card;
// - NEXP, ACCNOW and ROWOVF are reduced in shared memory: one atomic each a
//   block, not a warp;
// - a single-stage level (KEYS, fkey not null) has no stage 1: the lane
//   that stages a valid row hashes its identity words from shared memory
//   and writes the row's key (the unselected layout one coalesced word a
//   lane and chunk), the invalid slots get KEY_INVALID with their nvalid
//   bytes. A template parameter, so that a two-stage level's expand (the
//   main path's at F = 4096) keeps its registers: the keys' pointer and
//   hash cost the KDM = 2 instantiation a few spilled words.

// Model steps. Each is a transcription of the reference model's `step_jax`
// (not of its `step_scalar`: the two differ on opcodes outside the model's
// range and on the state a refused op leaves, and the reference's device
// program runs `step_jax`); its plain version is the model's `step_torch`
// in jepsen_tpu_torch/models/. A step reads the parent's S state lanes
// `s` and returns ok; when `o` is not null it also writes the child's S
// lanes there (k_expand calls it once a candidate, `o` the child's lanes
// in the row's staging slot, which a refused candidate's row discards).
//
// Dispatch: one `switch` on a step id that is a kernel argument, so it is
// uniform across the grid and costs one predictable branch per candidate;
// every member of a batch shares one model (the batch refuses mixed
// families). A template per model would compile eleven copies of k_expand
// for no measurable gain: the level is bound by its sorts, not by the
// step. `prm` carries the one behaviour parameter a model has
// (ReentrantMutex.max_depth, Semaphore.capacity,
// ReentrantFencedMutex.LOCK_LIMIT); no model has two.
//
// The state width S is a runtime argument with no cap: MultiRegister and
// Bank have one lane per register or account. Their steps copy the
// parent's lanes and overwrite the one or two that change; the fixed-width
// steps (S = 1, 2, 4) read and write fixed lanes. The reference's arithmetic is
// int32 and wraps, so sums and differences are taken in u32 (signed
// overflow is undefined in C++) and compared as int. Lane indices from a
// padded or clamped table row (the unselected layout steps every slot)
// are kept inside the state; such rows are discarded by `nvalid`, and a
// valid encoding gives every candidate a lane in range, so the guard
// cannot change a result.

#define STEP_CAS_REGISTER 0
#define STEP_MULTI_REGISTER 1
#define STEP_COUNTER 2
#define STEP_SET 3
#define STEP_BANK 4
#define STEP_MUTEX 5
#define STEP_OWNER_AWARE_MUTEX 6
#define STEP_REENTRANT_MUTEX 7
#define STEP_FENCED_MUTEX 8
#define STEP_REENTRANT_FENCED_MUTEX 9
#define STEP_SEMAPHORE 10

__device__ __forceinline__ int wrap_add(int x, int y) { return (int)((u32)x + (u32)y); }
__device__ __forceinline__ int wrap_sub(int x, int y) { return (int)((u32)x - (u32)y); }
__device__ __forceinline__ int clamp_lane(int i, int S) { return min(max(i, 0), S - 1); }

__device__ __forceinline__ void copy_lanes(const int* s, int S, u32* o) {
  for (int i = 0; i < S; ++i) o[i] = (u32)s[i];
}

// cas-register and register (models/register.py:64): a read matches or is
// UNKNOWN, a write sets, a cas hits on equal; any other opcode fails.
__device__ __forceinline__ bool cas_register_step(const int* s, int op, int a1, int a2, u32* o) {
  const int v = s[0];
  const bool hit = (v == a1);
  bool ok = false;
  int v2 = v;
  if (op == 0) ok = a1 == UNKNOWN_VAL || hit;
  if (op == 1) { ok = true; v2 = a1; }
  if (op == 2) { ok = hit; v2 = hit ? a2 : v; }
  if (o) o[0] = (u32)v2;
  return ok;
}

// multi-register (models/register.py:162): a1 is the register's lane; a
// read matches a2 or a2 is UNKNOWN; any other opcode writes a2.
__device__ __forceinline__ bool multi_register_step(const int* s, int S, int op, int a1, int a2,
                                                    u32* o) {
  const bool is_read = op == 0;
  const int cur = s[clamp_lane(a1, S)];
  if (o) {
    copy_lanes(s, S, o);
    if (!is_read && a1 >= 0 && a1 < S) o[a1] = (u32)a2;
  }
  return !is_read || a2 == UNKNOWN_VAL || cur == a2;
}

// counter (models/counter.py:70): a read matches a1 or is UNKNOWN; any
// other opcode adds a1.
__device__ __forceinline__ bool counter_step(const int* s, int op, int a1, u32* o) {
  const int v = s[0];
  const bool is_read = op == 0;
  if (o) o[0] = (u32)(is_read ? v : wrap_add(v, a1));
  return !is_read || a1 == UNKNOWN_VAL || v == a1;
}

// set (models/sets.py:95): add ORs a1's bits in, remove needs one of them
// present and clears them, read compares the whole mask; other opcodes fail.
__device__ __forceinline__ bool set_step(const int* s, int op, int a1, u32* o) {
  const int m = s[0];
  const bool ok = op == 0 || (op == 1 && (m & a1) != 0) ||
                  (op == 2 && (a1 == UNKNOWN_VAL || m == a1));
  if (o) o[0] = (u32)(op == 0 ? (m | a1) : op == 1 ? (m & ~a1) : m);
  return ok;
}

// bank (models/bank.py:110): lanes are accounts. A read (opcode 0) matches
// the balance of lane a1 % S; any other opcode transfers a2 from
// src = a1 / S to dst = a1 % S (Python's floor division and modulus) when
// the source covers it.
__device__ __forceinline__ bool bank_step(const int* s, int S, int op, int a1, int a2, u32* o) {
  const bool is_read = op == 0;
  int dst = a1 % S;
  int src = a1 / S;
  if (dst < 0) { dst += S; src -= 1; }
  if (is_read) {
    const int cur = s[dst];
    if (o) copy_lanes(s, S, o);
    return a2 == UNKNOWN_VAL || cur == a2;
  }
  const bool ok = s[clamp_lane(src, S)] >= a2;
  if (o) {
    copy_lanes(s, S, o);
    if (ok) {
      if (src >= 0 && src < S) o[src] = (u32)wrap_sub((int)o[src], a2);
      o[dst] = (u32)wrap_add((int)o[dst], a2);
    }
  }
  return ok;
}

// mutex (models/mutex.py:55): opcode 0 acquires a free lock; any other
// opcode releases a held one.
__device__ __forceinline__ bool mutex_step(const int* s, int op, u32* o) {
  const int locked = s[0];
  const bool is_acq = op == 0;
  if (o) o[0] = is_acq ? 1u : 0u;
  return is_acq ? locked == 0 : locked == 1;
}

// owner-aware mutex (models/mutex.py:92): lane = owner + 1, 0 when free;
// a release must come from the owner a1.
__device__ __forceinline__ bool owner_aware_mutex_step(const int* s, int op, int a1, u32* o) {
  const int owner = s[0];
  const int client = wrap_add(a1, 1);
  const bool is_acq = op == 0;
  if (o) o[0] = (u32)(is_acq ? client : 0);
  return is_acq ? owner == 0 : owner == client;
}

// reentrant mutex (models/mutex.py:148): depth below max_depth acquires,
// a held lock releases one level.
__device__ __forceinline__ bool reentrant_mutex_step(const int* s, int op, int max_depth,
                                                     u32* o) {
  const int depth = s[0];
  const bool is_acq = op == 0;
  if (o) o[0] = (u32)(is_acq ? wrap_add(depth, 1) : max(wrap_sub(depth, 1), 0));
  return is_acq ? depth < max_depth : depth > 0;
}

// fenced mutex (models/mutex.py:196): lanes [owner + 1, last fence]; an
// acquire's observed fence a2 must exceed the last one unless UNKNOWN.
__device__ __forceinline__ bool fenced_mutex_step(const int* s, int op, int a1, int a2, u32* o) {
  const int owner = s[0], last = s[1];
  const int client = wrap_add(a1, 1);
  const bool is_acq = op == 0;
  const bool fence_ok = a2 == UNKNOWN_VAL || a2 > last;
  if (o) {
    o[0] = (u32)(is_acq ? client : 0);
    o[1] = (u32)((is_acq && a2 != UNKNOWN_VAL) ? a2 : last);
  }
  return is_acq ? (owner == 0 && fence_ok) : owner == client;
}

// reentrant fenced mutex (models/mutex.py:280): lanes [owner + 1, count,
// current fence, highest observed fence], the `jnp.where` chains of
// step_jax written out as the same conditions.
__device__ __forceinline__ bool reentrant_fenced_mutex_step(const int* s, int op, int a1, int a2,
                                                            int lock_limit, u32* o) {
  const int owner = s[0], count = s[1], cur = s[2], hof = s[3];
  const int client = wrap_add(a1, 1);
  const int f = a2;
  const bool is_acq = op == 0;
  const bool f_known = f != UNKNOWN_VAL;
  const bool fresh_ok = !f_known || f > hof;
  const bool room = owner == client && count < lock_limit;
  const bool c1 = is_acq && owner == 0;
  const bool c2 = is_acq && room && cur == UNKNOWN_VAL;
  const bool c3 = is_acq && room && cur != UNKNOWN_VAL && (!f_known || f == cur);
  const bool rel_ok = !is_acq && owner == client && owner != 0;
  if (o) {
    const bool last_hold = count == 1;
    o[0] = (u32)(is_acq ? client : (last_hold ? 0 : owner));
    o[1] = (u32)(c1 ? 1 : (c2 || c3) ? wrap_add(count, 1) : max(wrap_sub(count, 1), 0));
    o[2] = (u32)((c1 || c2) ? f : c3 ? cur : (last_hold ? UNKNOWN_VAL : cur));
    o[3] = (u32)(((c1 || c2) && f_known) ? max(f, hof) : hof);
  }
  return ((c1 || c2) && fresh_ok) || c3 || rel_ok;
}

// semaphore (models/mutex.py:370): lane = permits held; an acquire of a1
// permits fits under capacity, a release needs a1 held.
__device__ __forceinline__ bool semaphore_step(const int* s, int op, int a1, int capacity,
                                               u32* o) {
  const int acquired = s[0];
  const int total = wrap_add(acquired, a1);
  const bool is_acq = op == 0;
  if (o) o[0] = (u32)(is_acq ? total : max(wrap_sub(acquired, a1), 0));
  return is_acq ? total <= capacity : acquired >= a1;
}

__device__ __forceinline__ bool model_step(int step, const int* s, int S, int op, int a1, int a2,
                                           int prm, u32* o) {
  switch (step) {
    case STEP_CAS_REGISTER: return cas_register_step(s, op, a1, a2, o);
    case STEP_MULTI_REGISTER: return multi_register_step(s, S, op, a1, a2, o);
    case STEP_COUNTER: return counter_step(s, op, a1, o);
    case STEP_SET: return set_step(s, op, a1, o);
    case STEP_BANK: return bank_step(s, S, op, a1, a2, o);
    case STEP_MUTEX: return mutex_step(s, op, o);
    case STEP_OWNER_AWARE_MUTEX: return owner_aware_mutex_step(s, op, a1, o);
    case STEP_REENTRANT_MUTEX: return reentrant_mutex_step(s, op, prm, o);
    case STEP_FENCED_MUTEX: return fenced_mutex_step(s, op, a1, a2, o);
    case STEP_REENTRANT_FENCED_MUTEX: return reentrant_fenced_mutex_step(s, op, a1, a2, prm, o);
    case STEP_SEMAPHORE: return semaphore_step(s, op, a1, prm, o);
    default: return false;  // the wrapper admits only the ids above
  }
}

#define EX_WARPS 4  // configurations a block
// Blocks an SM for windows of up to two words (W <= 64, the main path's):
// at most 64 registers a thread. The wider templates hold 4 * KDM window
// fields in registers and are left to the compiler.
#define EX_MIN_BLOCKS 8

// Words of one warp's slot of the expand's shared memory: the staging rows
// (32 rows), the parent's open masks and state, and the selected layout's
// nvalid bytes (nvb words); rounded up to 16 bytes.
__host__ __device__ constexpr int ex_warp_words(int NC, int KO1, int S, int nvb) {
  return (32 * NC + KO1 + S + nvb + 3) & ~3;
}

// The expand's dynamic shared memory: EX_WARPS warp slots.
__host__ __device__ constexpr size_t ex_smem(int NC, int KO, int S, int B) {
  return (size_t)4 * EX_WARPS *
         ex_warp_words(NC, KO > 0 ? KO : 1, S, B > 0 ? (B + 3) / 4 : 0);
}

// Words [0, n) of src to dst by one warp, as 16-byte stores where dst is
// aligned (src is read a word at a time: the two need not share an
// alignment).
__device__ __forceinline__ void warp_store_words(u32* dst, const u32* src, int n, int lane) {
  const int head = min(n, (int)((4u - (u32)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u)) & 3u));
  if (lane < head) dst[lane] = src[lane];
  const int n4 = (n - head) >> 2;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int q = lane; q < n4; q += 32) {
    const u32* w = src + head + 4 * q;
    d4[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int done = head + 4 * n4;
  if (lane < n - done) dst[done + lane] = src[done + lane];
}

template <int KDM, bool KEYS>
__global__ void __launch_bounds__(EX_WARPS * 32, KDM == 2 ? EX_MIN_BLOCKS : 1)
k_expand(const int* __restrict__ tabD, const int* __restrict__ sufret,
         const int* __restrict__ invO, const int* __restrict__ opO,
         const int* __restrict__ a1O, const int* __restrict__ a2O,
         const int* __restrict__ p, const u32* __restrict__ mD,
         const u32* __restrict__ mO, const int* __restrict__ st,
         const unsigned char* __restrict__ valid, int* ctl,
         u32* __restrict__ rows, unsigned char* __restrict__ nvalid, u32* __restrict__ fkey,
         int F, int W, int KO, int ND, int NO, int B, int S, int step, int prm) {
  extern __shared__ __align__(16) u32 ex_buf[];
  __shared__ int s_nok[EX_WARPS], s_flags[EX_WARPS];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int f = blockIdx.x * EX_WARPS + wid;
  const int KD = W >> 5;
  const int KO1 = KO > 0 ? KO : 1;
  const int NC = 1 + KD + S + KO1;
  const int C = W + 32 * KO;
  const bool SEL = B > 0;
  const int R = SEL ? B : C;  // rows a configuration owns
  // This member's control block and tables, this configuration's rows.
  ctl += (size_t)b * CTL_SIZE;
  tabD += (size_t)b * ND * 8;
  sufret += (size_t)b * (ND + 1);
  invO += (size_t)b * NO;
  opO += (size_t)b * NO;
  a1O += (size_t)b * NO;
  a2O += (size_t)b * NO;
  const size_t bf = (size_t)b * F + f;
  const int NID = 1 + KD + S;
  rows += bf * R * NC;
  nvalid += bf * R;
  if (KEYS) fkey += bf * R;
  u32* stage = ex_buf + (size_t)wid * ex_warp_words(NC, KO1, S, SEL ? (B + 3) / 4 : 0);
  u32* sMO = stage + 32 * NC;
  int* sST = reinterpret_cast<int*>(sMO + KO1);
  u32* sNV = reinterpret_cast<u32*>(sST + S);
  // First round trip: the control block and whether this configuration
  // is valid; a stopped member or an invalid configuration goes no further.
  const int go = ctl[CTL_GO], nD = ctl[CTL_ND], nO = ctl[CTL_NO];
  const bool live = f < F;
  const int pf = live ? p[bf] : 0;
  const bool vf = live && valid[bf] != 0;
  if (go == 0) return;  // block-uniform

  int n_ok = 0;
  bool acc = false;
  int cnt = 0;  // candidates so far (warp-uniform; selected layout)
  if (vf) {
    // Second round trip: the configuration's masks and state and the
    // window's table rows, read once: lane l holds slot c * 32 + l's
    // fields.
    u32 mdw[KDM];
#pragma unroll
    for (int c = 0; c < KDM; ++c) mdw[c] = c < KD ? mD[bf * KD + c] : 0u;
    for (int k = lane; k < KO1; k += 32) sMO[k] = mO[bf * KO1 + k];
    for (int k = lane; k < S; k += 32) sST[k] = st[bf * S + k];
    if (SEL)
      for (int k = lane; k < (B + 3) / 4; k += 32) sNV[k] = 0u;
    const int tail = sufret[min(pf + W, nD)];
    // The window's fields, and the local (min, argmin, second min) of the
    // unlinearized rets.
    int inv[KDM], op[KDM], a1[KDM], a2[KDM];
    u32 open = 0u;  // bit c: the slot is in range and unlinearized
    int best = I32MAX, bidx = I32MAX, second = I32MAX;
#pragma unroll
    for (int c = 0; c < KDM; ++c) {
      if (c < KD) {
        const int t = c * 32 + lane;
        const int row = pf + t;
        const bool inr = row < nD;
        const int* tr = tabD + (size_t)min(row, ND - 1) * 8;
        const int4 q = *reinterpret_cast<const int4*>(tr);
        const int q4 = tr[4];
        const bool avail = inr && !((mdw[c] >> lane) & 1u);
        inv[c] = inr ? q.x : I32MAX;
        op[c] = inr ? q.z : 0;
        a1[c] = inr ? q.w : 0;
        a2[c] = inr ? q4 : 0;
        open |= avail ? (1u << c) : 0u;
        const int val = avail ? q.y : I32MAX;
        if (val < best || (val == best && t < bidx)) {
          second = best;
          best = val;
          bidx = t;
        } else {
          second = min(second, val);
        }
      }
    }
    for (int o = 16; o; o >>= 1) {
      const int ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bidx, o);
      const int os = __shfl_xor_sync(FULL, second, o);
      if (ob < best || (ob == best && oi < bidx)) {
        second = min(best, os);
        best = ob;
        bidx = oi;
      } else {
        second = min(second, ob);
      }
    }
    const int m1 = best, am = bidx, m2 = second;
    const int mra = min(m1, tail);
    __syncwarp();  // the state, open masks and nvalid bytes in shared memory

    // The selected layout's rows [base, cnt) wait in the staging buffer
    // (row k at slot k - base) and go out in one run once a chunk would
    // overflow it, or at the end.
    int base = 0;
    // One chunk of 32 slots a step (c < KD: window, else open): select,
    // step and build each written row in the staging buffer. One call
    // site for every chunk: the lane's fields are picked from registers.
    for (int c = 0; c < KD + KO; ++c) {
      int t, iv, op_, a1_, a2_;
      bool cand;
      if (c < KD) {
        t = c * 32 + lane;
        iv = inv[0], op_ = op[0], a1_ = a1[0], a2_ = a2[0];
#pragma unroll
        for (int j = 1; j < KDM; ++j)
          if (c == j) iv = inv[j], op_ = op[j], a1_ = a1[j], a2_ = a2[j];
        const int excl = min((t == am) ? m2 : m1, tail);
        cand = ((open >> c) & 1u) && iv < excl;
      } else {
        // The open-op table (only its first 32 * KO entries are slots),
        // the same for every configuration: read through L1.
        const int o = (c - KD) * 32 + lane;
        const int oc = min(o, NO - 1);
        t = W + o;
        iv = invO[oc], op_ = opO[oc], a1_ = a1O[oc], a2_ = a2O[oc];
        cand = o < nO && !((sMO[c - KD] >> lane) & 1u) && iv < mra;
      }
      const u32 bal = __ballot_sync(FULL, cand);
      if (SEL && bal == 0u) continue;
      int slot = lane, k = 0;
      bool write = true;
      if (SEL) {
        const int n = __popc(bal);
        if (min(cnt + n, B) - base > 32) {  // flush the staged rows first
          __syncwarp();
          warp_store_words(rows + (size_t)base * NC, stage, (min(cnt, B) - base) * NC, lane);
          __syncwarp();
          base = min(cnt, B);
        }
        k = cnt + __popc(bal & lane_lt_mask(lane));
        write = cand && k < B;
        slot = k - base;
        cnt += n;
      }
      u32* r = stage + slot * NC;
      bool nv = false;
      if (write && cand) {
        nv = model_step(step, sST, S, op_, a1_, a2_, prm, r + 1 + KD);
        if (nv) {
          // bit set, trailing ones across the words, multi-word right
          // shift (in place in the row: word k reads words k + sw and up)
          int s = 0;
          bool carry = true;
#pragma unroll
          for (int w = 0; w < KDM; ++w) {
            if (w < KD) {
              const u32 x = mdw[w] | ((t < W && (t >> 5) == w) ? (1u << (t & 31)) : 0u);
              r[1 + w] = x;
              const int t1 = (x == FULL) ? 32 : (__ffs(~x) - 1);
              s += carry ? t1 : 0;
              carry = carry && t1 == 32;
            }
          }
          const int sw = s >> 5, sb = s & 31;
          for (int w = 0; w < KD; ++w) {
            const u32 lo = w + sw < KD ? r[1 + w + sw] : 0u;
            const u32 hi = w + sw + 1 < KD ? r[2 + w + sw] : 0u;
            r[1 + w] = __funnelshift_r(lo, hi, sb);
          }
          r[0] = (u32)(pf + s);
          for (int w = 0; w < KO1; ++w) {
            u32 ow = 0u;
            if (KO > 0) {
              ow = sMO[w];
              const int o = t - W;
              if (o >= 0 && (o >> 5) == w) ow |= 1u << (o & 31);
            }
            r[1 + KD + S + w] = ow;
          }
          n_ok += 1;
          acc = acc || (pf + s >= nD);
          if (SEL) {
            reinterpret_cast<unsigned char*>(sNV)[k] = 1;
            // the row's fused key, from the identity words it just staged
            if (KEYS) fkey[k] = fnv_row(r, NID) >> 1;
          }
        }
      }
      if (!SEL) {
        if (KEYS) fkey[(size_t)c * 32 + lane] = nv ? fnv_row(r, NID) >> 1 : KEY_INVALID;
        const u32 nvb = __ballot_sync(FULL, nv);
        if (lane < 8)
          reinterpret_cast<u32*>(nvalid + (size_t)c * 32)[lane] =
              ((nvb >> (4 * lane)) & 1u) | (((nvb >> (4 * lane + 1)) & 1u) << 8) |
              (((nvb >> (4 * lane + 2)) & 1u) << 16) | (((nvb >> (4 * lane + 3)) & 1u) << 24);
        if (nv) {
          u32* dst = rows + ((size_t)c * 32 + lane) * NC;
          for (int w = 0; w < NC; ++w) dst[w] = r[w];
        }
      }
    }
    if (SEL && min(cnt, B) > base) {
      __syncwarp();
      warp_store_words(rows + (size_t)base * NC, stage, (min(cnt, B) - base) * NC, lane);
    }
    if (SEL) {
      // The configuration's B nvalid bytes, as words (bytes where B is not
      // a multiple of 4).
      __syncwarp();
      const unsigned char* nb8 = reinterpret_cast<const unsigned char*>(sNV);
      if ((B & 3) == 0 && (reinterpret_cast<uintptr_t>(nvalid) & 3u) == 0) {
        for (int k = lane; k < B / 4; k += 32) reinterpret_cast<u32*>(nvalid)[k] = sNV[k];
      } else {
        for (int k = lane; k < B; k += 32) nvalid[k] = nb8[k];
      }
      // the invalid slots' keys (the valid ones were written with their rows)
      if (KEYS)
        for (int k = lane; k < B; k += 32)
          if (!nb8[k]) fkey[k] = KEY_INVALID;
    }
  } else if (live) {
    // No candidate: every row's nvalid byte is zero (as words where the
    // row count allows), and every key invalid.
    const int R4 = (R & 3) == 0 && (reinterpret_cast<uintptr_t>(nvalid) & 3u) == 0 ? R / 4 : 0;
    for (int k = lane; k < R4; k += 32) reinterpret_cast<u32*>(nvalid)[k] = 0u;
    for (int k = 4 * R4 + lane; k < R; k += 32) nvalid[k] = 0;
    if (KEYS)
      for (int k = lane; k < R; k += 32) fkey[k] = KEY_INVALID;
  }
  for (int o = 16; o; o >>= 1) n_ok += __shfl_xor_sync(FULL, n_ok, o);
  const bool any_acc = __any_sync(FULL, acc);
  if (lane == 0) {
    s_nok[wid] = n_ok;
    s_flags[wid] = (any_acc ? 1 : 0) | ((SEL && cnt > B) ? 2 : 0);
  }
  __syncthreads();
  if (tid == 0) {
    int nok = 0, fl = 0;
    for (int w = 0; w < EX_WARPS; ++w) {
      nok += s_nok[w];
      fl |= s_flags[w];
    }
    // nok is the count of the block's nonzero nvalid bytes, so CTL_NEXP
    // ends as the member's count of valid rows: wgl_stage1_hash relies on
    // it (its tail hash reads drows rows [n_cand, P) while other blocks
    // write rows [0, min(n_cand, P))), and chip_smoke's StageCheck checks it.
    if (nok) atomicAdd(&ctl[CTL_NEXP], nok);
    if (fl & 1) atomicOr(&ctl[CTL_ACCNOW], 1);
    if (fl & 2) atomicOr(&ctl[CTL_ROWOVF], 1);
  }
}

// ---------------------------------------------------------------------------
// K2 stage-1 compaction (reference lines 523-549) fused with the group
// hash and fused key (lines 628-645), one launch for every member.
//
// What bounds it: the member's nvalid bytes, its valid rows (NC words
// each) read once, the P survivors and their keys written once: well
// under 1 MB at the main path's shapes, about 0.1 us of HBM time. What
// costs is latency: the dependent steps of a scan across the member.
// The design is a single-pass stable compaction with decoupled look-back:
//
// - a block takes a tile of T = IPT * S1_THREADS rows of its member
//   (blockIdx.y), its tile number from the member's atomic counter, so
//   that it only ever waits on tiles whose blocks are already running;
// - each thread reads IPT validity bytes as one vector, the block scans
//   the counts and lists the tile's valid rows in order in shared memory,
//   and publishes the tile's count at once;
// - warp 0 looks back over 32 predecessors at a time to the nearest tile
//   that holds its inclusive count, and publishes its own;
// - the tile's rows of rank < P are gathered into shared memory with
//   cp.async (every load in flight at once) and written as one coalesced
//   run of contiguous words at rank * NC; the FNV hash of each is taken
//   from shared memory and its key written beside it, so no row is read
//   from device memory twice;
// - while warp 0 looks back, the other warps hash the tail rows
//   [min(n_cand, P), P) from what drows holds, as invalid (the sign bit):
//   the expand's count n_cand (ctl[CTL_NEXP]) is the member's number of
//   valid rows, so no block writes those rows in this launch;
// - the look-back words (64-bit: the call's epoch beside the flags and the
//   count), the ticket and done counters and the epoch live in a scratch of
//   4 + 2 * nb * tiles words (zero on the first call); the call's last
//   block to finish its look-back resets the counters and moves the epoch
//   on, so an earlier call's words read as unpublished and neither a
//   memset launch nor a zeroing pass is needed.
//
// With fkey null (an alltoall level's stage 1: the route writes the
// received rows' keys) the rows are compacted only; with `tail` 0 (an
// allgather level's: the exchange gives the rows past n_cand the zero
// row's key) the keys of the survivors only are written.

#define S1_THREADS 512
#define S1_STAGE_WORDS 8192  // the staging buffer: 32 KB of rows

// Bit k set where byte k of x is nonzero.
__device__ __forceinline__ u32 nonzero_bytes(u32 x) {
  const u32 m = __vcmpne4(x, 0u) & 0x01010101u;
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xFu;
}

// IPT validity bytes from p (IPT-aligned) as bits, by one vector load.
template <int IPT>
__device__ __forceinline__ u32 load_flags(const unsigned char* p) {
  if constexpr (IPT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4) | (nonzero_bytes(v.z) << 8) |
           (nonzero_bytes(v.w) << 12);
  } else if constexpr (IPT == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4);
  } else {
    return nonzero_bytes(*reinterpret_cast<const u32*>(p));
  }
}

// Bits of rows i0 .. i0 + IPT - 1 (< M) of a member's validity bytes.
template <int IPT>
__device__ __forceinline__ u32 tile_flags(const unsigned char* nvalid, int i0, int M) {
  if (i0 + IPT <= M && ((uintptr_t)(nvalid + i0) & (IPT - 1)) == 0)
    return load_flags<IPT>(nvalid + i0);
  u32 fl = 0u;
  for (int k = 0; k < IPT; ++k)
    if (i0 + k < M && nvalid[i0 + k]) fl |= 1u << k;
  return fl;
}

__device__ __forceinline__ void cp_async4(u32* smem, const u32* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Dynamic shared memory: the tile's valid-row list (T u16), then the
// staging buffer.
__host__ __device__ constexpr size_t s1_smem(int ipt) {
  return (size_t)ipt * S1_THREADS * 2 + (size_t)S1_STAGE_WORDS * 4;
}

// Scratch: a header of S1_HDR words (the call's epoch, the ticket counter,
// the done counter), then a 64-bit look-back word for each tile of each
// member: the epoch of the call that wrote it above the flag bits and the
// count. Its layout does not depend on the member count or the tile, and a
// word of an earlier call reads as unpublished (epochs repeat only after
// 2^32 calls), so one scratch serves calls of any shape.
#define S1_HDR 4
#define S1_EPOCH 0
#define S1_CTR 1
#define S1_DONE 2
#define S1_LB_WORDS 4  // look-back words a lane reads in one round

// A look-back word carries all it publishes, so relaxed (coherent at gpu
// scope, unordered) loads and stores suffice.
__device__ __forceinline__ u32 lb_word(const unsigned long long* p, unsigned long long epoch) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return (v & 0xFFFFFFFF00000000ull) == epoch ? (u32)v : 0u;
}

__device__ __forceinline__ void lb_publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Warp 0's look-back of a count: the sum of the counts of the tiles
// before `tile`, on every lane. 32 * S1_LB_WORDS predecessors a round,
// nearest first, until the nearest that holds its inclusive count; a word
// of another epoch (an earlier call's) is not yet published.
__device__ __forceinline__ int lb_sum_before(const unsigned long long* lb, int tile,
                                             unsigned long long epoch, int lane) {
  int pre = 0;
  for (int t = tile - 1; t >= 0; t -= 32 * S1_LB_WORDS) {
    u32 x[S1_LB_WORDS];
#pragma unroll
    for (int k = 0; k < S1_LB_WORDS; ++k) {
      const int j = t - 32 * k - lane;
      x[k] = j >= 0 ? lb_word(&lb[j], epoch) : LB_INCL;  // before tile 0: an inclusive zero
    }
    bool found = false;
#pragma unroll
    for (int k = 0; k < S1_LB_WORDS && !found; ++k) {
      const int j = t - 32 * k - lane;
      while (__any_sync(FULL, x[k] == 0u))
        if (x[k] == 0u) x[k] = lb_word(&lb[j], epoch);
      const u32 incl = __ballot_sync(FULL, (x[k] & LB_INCL) != 0u);
      // the nearest tile with its inclusive count is the lowest such lane
      const int upto = incl ? __ffs(incl) - 1 : 31;
      int v = lane <= upto ? (int)(x[k] & LB_VALUE) : 0;
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      pre += v;
      found = incl != 0u;
    }
    if (found) break;
  }
  return pre;
}

// The last of the call's blocks to be done with the look-back words (the
// one whose done ticket is blocks - 1) resets the counters and moves the
// epoch on, so no word needs zeroing between calls.
__device__ __forceinline__ void s1_last(u32* hdr, u32 done_ticket, int blocks) {
  if (done_ticket == (u32)(blocks - 1)) {
    hdr[S1_CTR] = 0u;
    hdr[S1_DONE] = 0u;
    hdr[S1_EPOCH] += 1u;
  }
}

template <int IPT>
__global__ void __launch_bounds__(S1_THREADS)
k_stage1(const u32* __restrict__ rows, const unsigned char* __restrict__ nvalid,
         const int* __restrict__ ctl, u32* __restrict__ drows, u32* __restrict__ fkey,
         u32* state, int M, int NC, int NID, int P, int tail) {
  constexpr int T = IPT * S1_THREADS;
  const int tid = threadIdx.x, lane = tid & 31;
  extern __shared__ __align__(16) u32 s1_buf[];
  unsigned short* list = reinterpret_cast<unsigned short*>(s1_buf);
  u32* stage = s1_buf + T / 2;
  __shared__ int s_ticket, s_off, s_warp[S1_THREADS / 32];
  __shared__ u32 s_epoch;
  const int tiles = gridDim.x, blocks = gridDim.x * gridDim.y;
  u32* hdr = state;
  // The block's (member, tile) comes from one ticket counter over the whole
  // grid, member-major, so a block looks back only at tiles whose blocks
  // took earlier tickets and are running. The ticket, the call's epoch, and
  // the control block and flags of (blockIdx.y, blockIdx.x) (blocks start in
  // blockIdx order, so most likely its own) are all read at once; the
  // guess is read again only if the ticket names another tile. A stopped
  // member's blocks take tickets too.
  if (tid == 0) {
    s_ticket = (int)atomicAdd(&hdr[S1_CTR], 1u);
    s_epoch = hdr[S1_EPOCH];
  }
  int b = blockIdx.y, tile = blockIdx.x;
  const int* c = ctl + (size_t)b * CTL_SIZE;
  int go = c[CTL_GO], n_cand = c[CTL_NEXP];
  u32 fl = tile_flags<IPT>(nvalid + (size_t)b * M, tile * T + tid * IPT, M);
  // The block's exclusive scan of the counts: warps, and the warps' totals
  // through the barrier that also brings the ticket.
  int sc = warp_incl_sum(__popc(fl), lane);
  if (lane == 31) s_warp[tid >> 5] = sc;
  __syncthreads();
  if (s_ticket != b * tiles + tile) {  // the guess was wrong: read the tile's own
    b = s_ticket / tiles;
    tile = s_ticket - b * tiles;
    c = ctl + (size_t)b * CTL_SIZE;
    go = c[CTL_GO];
    n_cand = c[CTL_NEXP];
    fl = tile_flags<IPT>(nvalid + (size_t)b * M, tile * T + tid * IPT, M);
    sc = warp_incl_sum(__popc(fl), lane);
    if (lane == 31) s_warp[tid >> 5] = sc;
    __syncthreads();
  }
  n_cand = min(max(n_cand, 0), P);
  const unsigned long long epoch = (unsigned long long)s_epoch << 32;
  if (go == 0) {
    if (tid == 0) s1_last(hdr, atomicAdd(&hdr[S1_DONE], 1u), blocks);
    return;
  }
  unsigned long long* lb = reinterpret_cast<unsigned long long*>(hdr + S1_HDR) + (size_t)b * tiles;
  const int t0 = tile * T;
  rows += (size_t)b * M * NC;
  drows += (size_t)b * P * NC;
  if (fkey) fkey += (size_t)b * P;
  int count = 0, pos = sc - __popc(fl);
  for (int w = 0; w < S1_THREADS / 32; ++w) {
    const int v = s_warp[w];
    count += v;
    if (w < (tid >> 5)) pos += v;
  }
  for (int k = 0; k < IPT; ++k)
    if ((fl >> k) & 1u) list[pos++] = (unsigned short)(tid * IPT + k);
  if (tid == 0) lb_publish(&lb[tile], epoch | (tile == 0 ? LB_INCL : LB_AGG) | (u32)count);
  __syncthreads();
  // The first chunk of the tile's valid rows is on its way into shared
  // memory while warp 0 looks back (it is written only if its ranks are
  // below P) and the other warps hash the tail.
  const int chunk = S1_STAGE_WORDS / NC;
  const int n0 = min(chunk, count), nw0 = n0 * NC;
  for (int j = tid; j < nw0; j += S1_THREADS) {
    const int r = j / NC;
    cp_async4(stage + j, rows + (size_t)(t0 + list[r]) * NC + (j - r * NC));
  }
  u32 done_ticket = 0u;
  if (tid < 32) {
    const int pre = lb_sum_before(lb, tile, epoch, lane);
    if (lane == 0) {
      if (tile > 0) lb_publish(&lb[tile], epoch | LB_INCL | (u32)(pre + count));
      s_off = pre;
      // This block reads no look-back word again: its done ticket is taken
      // now and read at the end, so the atomic's round trip is not waited on.
      done_ticket = atomicAdd(&hdr[S1_DONE], 1u);
    }
  } else if (fkey && tail) {
    const int per = S1_THREADS - 32;
    for (int r = n_cand + tile * per + tid - 32; r < P; r += tiles * per)
      fkey[r] = (fnv_row(drows + (size_t)r * NC, NID) >> 1) | KEY_INVALID;
  }
  cp_async_wait_all();
  __syncthreads();
  const int off = s_off;
  const int n_out = max(0, min(count, P - off));
  for (int r0 = 0; r0 < n_out; r0 += chunk) {
    const int n = min(chunk, n_out - r0), nw = n * NC;
    if (r0 > 0) {
      for (int j = tid; j < nw; j += S1_THREADS) {
        const int r = j / NC;
        cp_async4(stage + j, rows + (size_t)(t0 + list[r0 + r]) * NC + (j - r * NC));
      }
      cp_async_wait_all();
      __syncthreads();
    }
    u32* dst = drows + (size_t)(off + r0) * NC;
    for (int j = tid; j < nw; j += S1_THREADS) dst[j] = stage[j];
    if (fkey) {
      for (int r = tid; r < n; r += S1_THREADS) {
        const int rank = off + r0 + r;
        fkey[rank] = (fnv_row(stage + r * NC, NID) >> 1) | (rank < n_cand ? 0u : KEY_INVALID);
      }
    }
    if (r0 + chunk < n_out) __syncthreads();  // the stage is loaded again
  }
  if (tid == 0) s1_last(hdr, done_ticket, blocks);
}

// ---------------------------------------------------------------------------
// K3 stable ascending LSD radix sort of (u32 key, u32 value) pairs, 8-bit
// digits, segmented: each member's row of n pairs is sorted on its own (the
// member is a grid coordinate, not a key prefix), in place. Used for the
// dedup sort (reference lines 644-657, one sort per key from the last
// open-mask word to the fused key; stability makes it lexicographic) and
// the compaction sort (lines 725-740, stability is the position
// tiebreak: its values are the dedup order's row indices, so they come
// out as the rows in compaction order and the gather reads them direct).
//
// What bounds it: 16 bytes a pair (keys and values read once and written
// once), about 0.08 us of HBM time at the main path's 16384 pairs; what
// costs is the chain of dependent passes and their launches. Two paths,
// chosen by the scratch the caller passes (ops/wgl_level.py sort_scratch):
//
// Path S (k_sort_cta, n <= RS_CTA_MAX): one launch, one 1024-thread block
// per member. The keys live in registers, warp-striped (warp w holds items
// [w * 32 * ipt, (w + 1) * 32 * ipt), lane l item w * 32 * ipt + 32 j + l),
// the values in shared memory; every digit pass stays in the block: a
// stable rank per warp (match8 below and per-warp digit counters), one
// block scan of the counters in (digit, warp) order, a scatter of keys and
// values into shared memory and a re-read of the keys. The pairs cross
// device memory once each way.
//
// Path L (above that): Onesweep (Adinets & Merrill 2022). One upsweep
// launch builds the four digit histograms of every member in one read of
// the keys (and zeroes the look-back words and tile counters); then one
// launch per digit pass, in which each block takes its tile from an atomic
// counter (so that look-back waits only on tiles that are already
// running), ranks the tile in shared memory, publishes its digit counts by
// decoupled look-back (status and count in one 32-bit word, read with
// acquire) and writes the tile out digit run by digit run: each pass reads
// and writes the data once. Five launches at most.
//
// Both skip a digit that is the same on every key of the member (`diff`,
// the OR of each key XOR the first, has a zero byte there): the compaction
// key has PB + 7 bits, so its top byte is zero at every realistic ND, and
// an all-zero open-mask word skips all four. Path L ping-pongs between
// keys/vals and the scratch; when the passes that run are odd in number it
// runs the first uniform digit too (an identity copy), so the result ends
// in keys/vals. A member whose control block says stop is not touched.
//
// The dedup sorts take their keys through a gather (wgl_take_col_sort,
// replacing the reference's sort operands, lines 647-651): key i of member
// b is src[b][v * stride + col], v = i for the first key (the identity
// order) and vals[b][i] after it; rows [0, n) of src exist. There is no
// gather launch: the kernels take a compile-time GATHER and gather where
// they load the keys anyway. Path S reads the key column (rows [0, n), in
// row order) and the values in one round of loads, with the control
// block: the identity's keys are the column, and read values take theirs
// from the column staged in shared memory (one SM gathering 16384
// scattered words from device memory would fetch a 32-byte sector for
// each). It stores nothing before every load is done (vals is the index
// and the output of the launch).
// Path L's upsweep, which reads every key once for its histograms,
// gathers them and writes keys (and the identity values) as it goes, and
// the passes run as they are. Either way the gathered pairs are stored
// even when every digit is uniform (an all-zero open-mask column, sorted
// first at every level with no open op): nothing else writes them. With
// GATHER false the kernels are the plain sort's.

// The key gather of a take-col sort (see above).
struct KeyGather {
  const u32* src;
  long member;  // src's stride between members, in words
  int stride, col, ident;
};

// Bit mask of the passes path L runs: each digit that is not uniform,
// plus the first uniform one when those are odd in number.
__device__ __forceinline__ int rs_passes(u32 diff) {
  int live = 0;
  for (int p = 0; p < 4; ++p)
    if ((diff >> (8 * p)) & 255u) live |= 1 << p;
  if (__popc(live) & 1) live |= 1 << (__ffs(~live) - 1);
  return live;
}

// The OR of v over the block; *slot is shared, zero, and published by a
// __syncthreads() before the call.
__device__ __forceinline__ u32 block_or(u32 v, u32* slot) {
  v = __reduce_or_sync(FULL, v);
  if ((threadIdx.x & 31) == 0 && v) atomicOr(slot, v);
  __syncthreads();
  return *slot;
}

// The lanes of `act` whose 8-bit digit d equals this lane's, two ways to
// the same mask: __match_any_sync, whose cost grows with the number of
// distinct digits in the warp (cheap on the level's open-mask and priority
// keys, which take few values), or `many`: eight ballots, one a digit bit,
// a fixed cost (cheaper on random digits such as the fused hash). Every
// lane of the warp calls it.
#define RS_MATCH_ANY_MAX 16
__device__ __forceinline__ u32 match8(u32 d, u32 act, bool many) {
  const int lane = threadIdx.x & 31;
  if (!many) return __match_any_sync(FULL, ((act >> lane) & 1u) ? d : 256u + lane) & act;
  u32 m = act;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const u32 v = __ballot_sync(FULL, (d >> b) & 1u);
    m &= ((d >> b) & 1u) ? v : ~v;
  }
  return m;
}

// Stable rank of digit d among the warp's items so far, for the lanes of
// `act` (the others take part and get nothing): the count of the warp's
// earlier items with digit d (its counter wc[d], which the group's leader
// advances) plus the lanes below with the same digit in this step. A
// pass's first step (`probe`) matches with __match_any_sync and sets
// `many` when it saw more than RS_MATCH_ANY_MAX distinct digits: a warp's
// items are alike along a pass (a run of the fused hash, or of
// priorities), so the rest of the pass takes the cheaper way for them.
__device__ __forceinline__ int warp_rank8(u32 d, u32 act, int* wc, bool& many, bool probe) {
  const int lane = threadIdx.x & 31;
  const bool on = (act >> lane) & 1u;
  const u32 peers = match8(d, act, many);
  const bool leader = on && lane == __ffs(peers) - 1;
  if (probe) many = __popc(__ballot_sync(FULL, leader)) > RS_MATCH_ANY_MAX;
  const int before = on ? wc[d] : 0;
  __syncwarp();
  if (leader) wc[d] = before + __popc(peers);
  __syncwarp();
  return before + __popc(peers & lane_lt_mask(lane));
}

static size_t rs_cta_smem(int ipt) {
  return (size_t)3 * 1024 * ipt * sizeof(u32) + (size_t)32 * RS_CNT * sizeof(int);
}

template <bool GATHER>
__global__ void __launch_bounds__(1024, 1)
k_sort_cta(u32* __restrict__ keys, u32* __restrict__ vals, int n, const int* ctl, KeyGather kg) {
  const int b = blockIdx.x;
  // Read with the keys below: a stopped member's block loads and leaves.
  const bool stop = stopped(member_ctl(ctl, b));
  keys += (size_t)b * n;
  vals += (size_t)b * n;
  extern __shared__ u32 rs_smem[];
  __shared__ u32 s_diff;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ipt = (n + 1023) >> 10;       // 1 .. RS_CTA_IPT, block-uniform
  const int cap = ipt << 10;              // items, the padded ones last
  const int wbase = w * 32 * ipt + lane;  // item j of this thread: wbase + 32 j
  u32* sk = rs_smem;                      // [cap] keys in the pass's order
  u32* vs = sk + cap;                     // [cap] values, current order
  u32* vd = vs + cap;                     // [cap] values, next order
  int* cnt = (int*)(vd + cap);            // [32][RS_CNT] per-warp digit counters
  int* wc = cnt + w * RS_CNT;
  if (threadIdx.x == 0) s_diff = 0;
  u32 k[RS_CTA_IPT];
  int rk[RS_CTA_IPT];
  u32 diff = 0;
  if constexpr (GATHER) {
    // One round of loads, with the control block: the key column (rows
    // [0, n) of src, which the wrapper checks exist) and the values. The
    // identity's keys are the column itself. Read values take theirs from
    // the column staged in shared memory, so no device load waits on
    // another and one SM never gathers scattered words (a value past n,
    // which the level never passes, is read from device memory).
    const u32* src = kg.src + (size_t)b * kg.member + kg.col;
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j) {
      const int i = wbase + 32 * j;
      k[j] = FULL;
      if (j < ipt && i < n) {
        const u32 x = src[(size_t)i * kg.stride];
        if (kg.ident) {
          k[j] = x;
          vs[i] = (u32)i;
        } else {
          sk[i] = x;
          vs[i] = vals[i];
        }
      }
    }
    auto key_of = [&](u32 v) { return v < (u32)n ? sk[v] : src[(size_t)v * kg.stride]; };
    if (!kg.ident) {
      __syncthreads();
      if (stop) return;
#pragma unroll
      for (int j = 0; j < RS_CTA_IPT; ++j) {
        const int i = wbase + 32 * j;
        if (j < ipt && i < n) k[j] = key_of(vs[i]);
      }
    }
    const u32 k0 = kg.ident ? src[0] : key_of(vs[0]);
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j)
      if (j < ipt && wbase + 32 * j < n) diff |= k[j] ^ k0;
  } else {
    const u32 k0 = keys[0];
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j) {
      const int i = wbase + 32 * j;
      k[j] = FULL;  // padding sorts after every real key: it comes last
      if (j < ipt && i < n) {
        k[j] = keys[i];
        vs[i] = vals[i];
        diff |= k[j] ^ k0;
      }
    }
  }
  __syncthreads();
  diff = block_or(diff, &s_diff);
  // diff 0: every digit uniform, the row is sorted (a gathered row is
  // still stored below)
  if (stop || (!GATHER && diff == 0)) return;
  for (int p = 0; p < 4; ++p) {
    const int shift = 8 * p;
    if (((diff >> shift) & 255u) == 0) continue;
    for (int i = threadIdx.x; i < 32 * RS_CNT; i += 1024) cnt[i] = 0;
    __syncthreads();
    // Stable rank inside the warp: its items in order, equal digits of one
    // step by lane.
    bool many = false;
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j)
      if (j < ipt) rk[j] = warp_rank8((k[j] >> shift) & 255u, FULL, wc, many, j == 0);
    __syncthreads();
    // Exclusive offsets in (digit, warp) order: thread t sums digit t / 4
    // over warps 8 (t % 4) .. 8 (t % 4) + 7, one block scan, and writes
    // each counter's start back.
    {
      const int d = threadIdx.x >> 2, w0 = (threadIdx.x & 3) * 8;
      int s = 0;
      for (int u = 0; u < 8; ++u) s += cnt[(w0 + u) * RS_CNT + d];
      int off = block_excl_sum(s, nullptr);
      for (int u = 0; u < 8; ++u) {
        int* c = cnt + (w0 + u) * RS_CNT + d;
        const int v = *c;
        *c = off;
        off += v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j) {
      if (j < ipt) {
        const int pos = wc[(k[j] >> shift) & 255u] + rk[j];
        sk[pos] = k[j];
        vd[pos] = vs[wbase + 32 * j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RS_CTA_IPT; ++j)
      if (j < ipt) k[j] = sk[wbase + 32 * j];
    u32* t = vs;
    vs = vd;
    vd = t;
  }
#pragma unroll
  for (int j = 0; j < RS_CTA_IPT; ++j) {
    const int i = wbase + 32 * j;
    if (j < ipt && i < n) {
      keys[i] = k[j];
      vals[i] = vs[i];
    }
  }
}

// Path L state, per member b at state + b * RS_HDR: hist[4][256] (each
// pass's digit counts), diff, ctr[4] (each pass's tile counter) and done
// (blocks of the last pass finished); after all members' headers, two
// look-back buffers of [nb][tiles][256] words. A call starts with hist and
// diff zero (sort_scratch allocates zeros, and the last block of each
// call's final launch zeroes them again); the upsweep zeroes ctr, done and
// look-back buffer 0, and each pass zeroes its tile's row of the buffer the
// next pass uses.
#define RS_H_DIFF 1024
#define RS_H_CTR 1025
#define RS_H_DONE 1029
__device__ __forceinline__ u32* rs_lookback(u32* state, int nb, int tiles, int buf, int b) {
  return state + (size_t)nb * RS_HDR + ((size_t)buf * nb + b) * tiles * 256;
}

// Upsweep: the four digit histograms and diff of each member's keys, a
// block per `chunk` keys.
template <bool GATHER>
__global__ void __launch_bounds__(RS_L_THREADS)
k_sort_upsweep(u32* __restrict__ keys, u32* __restrict__ vals, int n, int chunk, u32* state,
               int tiles, int nb, const int* ctl, KeyGather kg) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  keys += (size_t)b * n;
  vals += (size_t)b * n;
  const u32* src = GATHER ? kg.src + (size_t)b * kg.member + kg.col : nullptr;
  u32* hdr = state + (size_t)b * RS_HDR;
  u32* lb0 = rs_lookback(state, nb, tiles, 0, b);
  __shared__ int h[4 * 256];
  __shared__ u32 s_diff;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) h[i] = 0;
  if (threadIdx.x == 0) s_diff = 0;
  if (blockIdx.x == 0 && threadIdx.x < 5) hdr[RS_H_CTR + threadIdx.x] = 0;  // ctr, done
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)tiles * 256;
       i += (size_t)gridDim.x * blockDim.x)
    lb0[i] = 0;
  __syncthreads();
  // Key 0, gathered by every block: block 0 writes keys[0] in this launch.
  const u32 k0 = GATHER ? src[(size_t)(kg.ident ? 0u : vals[0]) * kg.stride] : keys[0];
  u32 diff = 0;
  bool many[4] = {false, false, false, false};  // see warp_rank8
  const int i0 = blockIdx.x * chunk, i1 = min(n, i0 + chunk);
  for (int base = i0; base < i1; base += blockDim.x) {  // uniform across the block
    const int i = base + threadIdx.x;
    const bool act = i < i1;
    u32 k = 0u;
    if (act) {
      if constexpr (GATHER) {
        const u32 v = kg.ident ? (u32)i : vals[i];
        k = src[(size_t)v * kg.stride];
        keys[i] = k;
        if (kg.ident) vals[i] = v;
      } else {
        k = keys[i];
      }
      diff |= k ^ k0;
    }
    const u32 am = __ballot_sync(FULL, act);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const u32 d = (k >> (8 * p)) & 255u;
      const u32 peers = match8(d, am, many[p]);
      const bool leader = act && lane == __ffs(peers) - 1;
      if (base == i0) many[p] = __popc(__ballot_sync(FULL, leader)) > RS_MATCH_ANY_MAX;
      if (leader) atomicAdd(&h[p * 256 + d], __popc(peers));
    }
  }
  diff = block_or(diff, &s_diff);
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
    if (h[i]) atomicAdd(&hdr[i], (u32)h[i]);
  if (threadIdx.x == 0 && diff) atomicOr(&hdr[RS_H_DIFF], diff);
}

// One digit pass of path L over every member: (ka, va) -> (kb, vb) when the
// pass is an even one of those that run, else back. Shared memory: the
// tile's keys and values in digit order, then the per-warp counters.
__global__ void __launch_bounds__(RS_L_THREADS, 2)
k_sort_pass(u32* ka, u32* va, u32* kb, u32* vb, int n, u32* state, int tiles, int nb, int pass,
            const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  extern __shared__ u32 rs_smem[];
  __shared__ int s_tile, s_last;
  __shared__ int s_start[256], s_gex[256], s_shift[256];
  u32* hdr = state + (size_t)b * RS_HDR;
  const u32 diff = hdr[RS_H_DIFF];
  const int run = rs_passes(diff);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((run >> pass) & 1) {
    const int nth = __popc(run & ((1 << pass) - 1));  // passes run before this one
    const size_t m = (size_t)b * n;
    const u32* sk_ = (nth & 1) ? kb + m : ka + m;
    const u32* sv_ = (nth & 1) ? vb + m : va + m;
    u32* dk = (nth & 1) ? ka + m : kb + m;
    u32* dv = (nth & 1) ? va + m : vb + m;
    u32* lb = rs_lookback(state, nb, tiles, nth & 1, b);
    u32* lbn = rs_lookback(state, nb, tiles, (nth & 1) ^ 1, b);
    const int shift = 8 * pass;
    if (((diff >> shift) & 255u) == 0) {
      // A uniform digit run for parity: the identity, tile by tile.
      const int t0 = blockIdx.x * RS_TILE, tn = min(RS_TILE, n - t0);
      for (int q = threadIdx.x; q < tn; q += RS_L_THREADS) {
        dk[t0 + q] = sk_[t0 + q];
        dv[t0 + q] = sv_[t0 + q];
      }
      if (threadIdx.x < 256) lbn[(size_t)blockIdx.x * 256 + threadIdx.x] = 0;
    } else {
      u32* tk = rs_smem;                // [RS_TILE] the tile in digit order
      u32* tv = tk + RS_TILE;
      int* cnt = (int*)(tv + RS_TILE);  // [16][RS_CNT] per-warp digit counters
      int* wc = cnt + w * RS_CNT;
      if (threadIdx.x == 0) s_tile = (int)atomicAdd(&hdr[RS_H_CTR + pass], 1u);
      for (int i = threadIdx.x; i < (RS_L_THREADS / 32) * RS_CNT; i += RS_L_THREADS) cnt[i] = 0;
      __syncthreads();
      const int tile = s_tile;
      const int t0 = tile * RS_TILE, tn = min(RS_TILE, n - t0);
      const int wbase = w * 32 * RS_L_IPT + lane;
      u32 k[RS_L_IPT], v[RS_L_IPT];
      int rk[RS_L_IPT];
#pragma unroll
      for (int j = 0; j < RS_L_IPT; ++j) {
        const int i = wbase + 32 * j;
        const bool act = i < tn;
        k[j] = act ? sk_[t0 + i] : 0u;
        v[j] = act ? sv_[t0 + i] : 0u;
      }
      bool many = false;
#pragma unroll
      for (int j = 0; j < RS_L_IPT; ++j)
        rk[j] = warp_rank8((k[j] >> shift) & 255u, __ballot_sync(FULL, wbase + 32 * j < tn), wc,
                           many, j == 0);
      __syncthreads();
      // Digit d's count in the tile and each warp's start inside it.
      int tcount = 0;
      if (threadIdx.x < 256) {
        for (int u = 0; u < RS_L_THREADS / 32; ++u) {
          int* c = cnt + u * RS_CNT + threadIdx.x;
          const int x = *c;
          *c = tcount;
          tcount += x;
        }
      }
      // One scan gives both the tile's digit starts (threads 0-255, its
      // counts) and the member's global digit offsets (threads 256-511,
      // the pass's histogram, less the tile's tn counted before them).
      const int hv = threadIdx.x < 256 ? tcount : (int)hdr[pass * 256 + threadIdx.x - 256];
      const int ex = block_excl_sum(hv, nullptr);
      if (threadIdx.x < 256)
        s_start[threadIdx.x] = ex;
      else
        s_gex[threadIdx.x - 256] = ex - tn;
      __syncthreads();
      if (threadIdx.x < 256) {
        // Decoupled look-back for digit d: publish the tile's count, add
        // the earlier tiles' until one that holds its inclusive count.
        const int d = threadIdx.x;
        u32* mine = lb + (size_t)tile * 256 + d;
        int pre = 0;
        if (tile == 0) {
          st_release(mine, LB_INCL | (u32)tcount);
        } else {
          st_release(mine, LB_AGG | (u32)tcount);
          for (int t = tile - 1;; --t) {
            u32 x;
            do {
              x = ld_acquire(lb + (size_t)t * 256 + d);
            } while ((x & ~LB_VALUE) == 0);
            pre += (int)(x & LB_VALUE);
            if (x & LB_INCL) break;
          }
          st_release(mine, LB_INCL | (u32)(pre + tcount));
        }
        s_shift[d] = s_gex[d] + pre - s_start[d];
      }
#pragma unroll
      for (int j = 0; j < RS_L_IPT; ++j) {
        if (wbase + 32 * j < tn) {
          const u32 d = (k[j] >> shift) & 255u;
          const int pos = s_start[d] + wc[d] + rk[j];
          tk[pos] = k[j];
          tv[pos] = v[j];
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < tn; q += RS_L_THREADS) {
        const u32 x = tk[q];
        const int o = s_shift[(x >> shift) & 255u] + q;
        dk[o] = x;
        dv[o] = tv[q];
      }
      if (threadIdx.x < 256) lbn[(size_t)tile * 256 + threadIdx.x] = 0;
    }
  }
  if (pass == 3) {
    // The member's last block of the call's last launch leaves hist and
    // diff zero for the next call.
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      s_last = atomicAdd(&hdr[RS_H_DONE], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last)
      for (int i = threadIdx.x; i <= RS_H_DIFF; i += RS_L_THREADS) hdr[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// K4 prune (reference lines 657-736): over the dedup-sorted order, the
// same-group test on the real identity columns, the adjacent-subset rule,
// the group-head rule (each row's segment start is a prefix max), the keep
// count and the fused compaction priority; one launch for every member.
//
// What bounds it: the member's sorted keys and perm read once, its L rows
// gathered once through perm, the priorities written once: about 0.5 MB,
// 0.15 us of HBM time, at the main path's L = 16384. What costs is
// latency, so the design is one single-pass launch:
//
// - a block takes a tile of T rows of its member (blockIdx.y), one row a
//   thread, its tile number from one ticket counter over the grid (as
//   k_stage1), so that it only ever waits on tiles whose blocks run;
// - the tile's keys and perm, and those of the PR_HALO rows before it, are
//   read with the ticket; then those rows are gathered once through perm
//   into shared memory with cp.async, a word a thread, every load in
//   flight at once;
// - the predecessor tests read shared memory; the tile's segment starts
//   come from a block-wide prefix max;
// - a row before the tile's first start continues a group from an earlier
//   tile; its start is the last start before the tile, found in the halo
//   when the group began there (groups are short: the common case needs no
//   other block), else carried by a decoupled look-back on a max
//   (idempotent: a tile that knows its inclusive value publishes it at
//   once, a tile that needs the carry looks back first, any other tile
//   publishes only that it holds no start). The words are stage 1's,
//   64-bit with a call epoch, in a scratch of the same layout that cleans
//   itself;
// - the head's open words come from shared memory when the head is in the
//   tile or the halo, else from device memory, once a tile;
// - the keep count: one atomicAdd a block into ctl[CTL_COUNT];
// - in a frontier-sharded level (SHARDED: the members are the D shards of
//   one search) the launch also runs the cross-shard reduce that the
//   parent design launched after it (level_reduce): each block takes its
//   done ticket after its keep count is added, with an acq_rel add
//   instead of the relaxed one taken early, and the block that draws the
//   last ticket sees every shard's count. The single level's
//   instantiation is the prune as it was: no ticket order, no reduce.

#define PR_HALO 32  // rows before the tile a block reads: warp 0's

// Dynamic shared memory of a tile of T rows of NC words: the halo's and
// the tile's rows, their perm entries and validity bytes, and the carried
// head's open words.
__host__ __device__ constexpr size_t pr_smem(int T, int NC, int KO1) {
  return 4 * ((size_t)(T + PR_HALO) * NC + (T + PR_HALO) + KO1) + (size_t)(T + PR_HALO);
}

template <bool SHARDED>
__global__ void __launch_bounds__(1024)
k_prune(const u32* __restrict__ drows, const u32* __restrict__ skey, const int* __restrict__ perm,
        int* ctl, u32* __restrict__ fprio, u32* state, int L, int NC, int NID, int KO1, int PB,
        int F, int P, int mode) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // Slot s holds row i0 - PR_HALO + s: the halo in slots [0, PR_HALO).
  extern __shared__ __align__(16) u32 pr_buf[];
  u32* srow = pr_buf;                                                      // [T + PR_HALO][NC]
  int* sperm = reinterpret_cast<int*>(srow + (size_t)(T + PR_HALO) * NC);   // [T + PR_HALO]
  u32* shead = reinterpret_cast<u32*>(sperm + T + PR_HALO);                 // [KO1]
  unsigned char* sval = reinterpret_cast<unsigned char*>(shead + KO1);     // [T + PR_HALO]
  __shared__ int s_ticket, s_max[32], s_first[32], s_cont[32], s_carry;
  __shared__ u32 s_epoch;
  __shared__ bool s_last;
  const int tiles = gridDim.x, blocks = gridDim.x * gridDim.y;
  u32* hdr = state;
  // SHARDED: the done ticket, taken once the block's count is in; the
  // last runs the reduce on warp 0.
  auto done_last = [&]() {
    if (tid == 0) {
      const u32 t = ticket_acq_rel(&hdr[S1_DONE]);
      s1_last(hdr, t, blocks);
      s_last = t == (u32)(blocks - 1);
    }
    __syncthreads();
    if (s_last && wid == 0) level_reduce(ctl, gridDim.y, F, P, mode);
  };
  if (tid == 0) {
    s_ticket = (int)atomicAdd(&hdr[S1_CTR], 1u);
    s_epoch = hdr[S1_EPOCH];
  }
  // The guessed tile's control block, keys and perm (blocks start in
  // blockIdx order, so most likely its own) are read, and put in shared
  // memory, with the ticket; again only if the ticket names another tile.
  int b = blockIdx.y, tile = blockIdx.x, go;
  auto load = [&]() {
    go = ctl[(size_t)b * CTL_SIZE + CTL_GO];
    const int i = tile * T + tid;
    const u32 key = i < L ? skey[(size_t)b * L + i] : FULL;
    sperm[PR_HALO + tid] = i < L ? perm[(size_t)b * L + i] : 0;
    sval[PR_HALO + tid] = (key >> 31) == 0u ? 1 : 0;
    if (tid < PR_HALO) {  // warp 0: the halo
      const int h = tile * T - PR_HALO + tid;
      const u32 hkey = h >= 0 ? skey[(size_t)b * L + h] : FULL;
      sperm[tid] = h >= 0 ? perm[(size_t)b * L + h] : 0;
      sval[tid] = (hkey >> 31) == 0u ? 1 : 0;
    }
  };
  load();
  __syncthreads();
  if (s_ticket != b * tiles + tile) {
    b = s_ticket / tiles;
    tile = s_ticket - b * tiles;
    load();
    __syncthreads();
  }
  const unsigned long long epoch = (unsigned long long)s_epoch << 32;
  if (go == 0) {
    if (SHARDED) done_last();
    else if (tid == 0) s1_last(hdr, atomicAdd(&hdr[S1_DONE], 1u), blocks);
    return;
  }
  const int i0 = tile * T, i = i0 + tid;
  const int n = min(T, L - i0);  // rows of the tile
  drows += (size_t)b * L * NC;
  const int s0 = max(0, PR_HALO - i0);  // the first slot of a row >= 0
  for (int j = s0 * NC + tid; j < (PR_HALO + n) * NC; j += T) {
    const int r = j / NC;
    cp_async4(srow + j, drows + (size_t)sperm[r] * NC + (j - r * NC));
  }
  cp_async_wait_all();
  __syncthreads();
  // Row r's group tests against row r - 1 (slots r and r - 1 >= 0).
  auto tests = [&](int r, bool& same, bool& psub) {
    const u32* me = srow + (size_t)r * NC;
    const u32* pr = me - NC;
    same = psub = false;
    if (sval[r] && sval[r - 1]) {
      same = true;
      for (int c = 0; c < NID; ++c) same = same && (me[c] == pr[c]);
      if (same) {
        psub = true;
        for (int w = 0; w < KO1; ++w) psub = psub && ((pr[NID + w] & ~me[NID + w]) == 0u);
      }
    }
  };
  const int slot = PR_HALO + tid;
  const u32* me = srow + (size_t)slot * NC;
  const bool sv = sval[slot] != 0;
  bool same, psub;
  tests(slot, same, psub);
  const bool is_start = sv && !same;
  // The last start in the halo (slots 1 .. PR_HALO - 1; slot 0 has no
  // predecessor here), as a look-back value: its row + 1, 0 for none.
  u32 hc = 0u;
  if (wid == 0) {
    bool hs = false, hp;
    if (lane > 0) {
      tests(lane, hs, hp);
      hs = sval[lane] && !hs;
    }
    const u32 hb = __ballot_sync(FULL, hs);
    if (hb) hc = (u32)(i0 - PR_HALO + 31 - __clz(hb) + 1);
  }
  // The block's inclusive prefix max of the starts: each warp's scan, then
  // each thread's max over the earlier warps' last starts. Each warp's
  // first start and first continuing row (valid, not a start) tell
  // whether a row before the tile's first start continues a group.
  int seg = is_start ? i : -1;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, seg, o);
    if (lane >= o) seg = max(seg, y);
  }
  const u32 starts = __ballot_sync(FULL, is_start), conts = __ballot_sync(FULL, sv && !is_start);
  if (lane == 31) s_max[wid] = seg;
  if (lane == 0) {
    s_first[wid] = starts ? i0 + 32 * wid + __ffs(starts) - 1 : I32MAX;
    s_cont[wid] = conts ? i0 + 32 * wid + __ffs(conts) - 1 : I32MAX;
  }
  __syncthreads();
  for (int w = 0; w < wid; ++w) seg = max(seg, s_max[w]);
  int last = -1;  // the tile's last start, or -1 (warp 0's)
  bool need = false;  // a row before the tile's first start continues a group (warp 0's)
  if (wid == 0) {
    int first = I32MAX, cont = I32MAX;
    for (int w = 0; w < (T >> 5); ++w) {
      last = max(last, s_max[w]);
      first = min(first, s_first[w]);
      cont = min(cont, s_cont[w]);
    }
    need = cont < first;
  }
  unsigned long long* lb =
      reinterpret_cast<unsigned long long*>(hdr + S1_HDR) + (size_t)b * tiles;
  u32 done_ticket = 0u;
  const bool look = need && hc == 0u;  // warp-0 values; tid 0 decides
  if (tid == 0) {
    if (last >= 0) lb_publish(&lb[tile], epoch | LB_INCL | (u32)(last + 1));
    else if (hc != 0u || tile == 0) lb_publish(&lb[tile], epoch | LB_INCL | hc);
    else lb_publish(&lb[tile], epoch | LB_AGG);
    if (!SHARDED && !look) done_ticket = atomicAdd(&hdr[S1_DONE], 1u);
    s_carry = (int)hc;
  }
  if (wid == 0 && look) {
    // 32 * S1_LB_WORDS predecessors a round, nearest first, until the
    // nearest that holds its inclusive value; the ones between hold no
    // start.
    u32 carry = 0u;
    for (int t = tile - 1; t >= 0; t -= 32 * S1_LB_WORDS) {
      u32 x[S1_LB_WORDS];
#pragma unroll
      for (int k = 0; k < S1_LB_WORDS; ++k) {
        const int j = t - 32 * k - lane;
        x[k] = j >= 0 ? lb_word(&lb[j], epoch) : LB_INCL;  // before tile 0: none
      }
      bool found = false;
#pragma unroll
      for (int k = 0; k < S1_LB_WORDS && !found; ++k) {
        const int j = t - 32 * k - lane;
        while (__any_sync(FULL, x[k] == 0u))
          if (x[k] == 0u) x[k] = lb_word(&lb[j], epoch);
        const u32 incl = __ballot_sync(FULL, (x[k] & LB_INCL) != 0u);
        const int upto = incl ? __ffs(incl) - 1 : 31;
        u32 v = lane <= upto ? (x[k] & LB_VALUE) : 0u;
        for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
        carry = max(carry, v);
        found = incl != 0u;
      }
      if (found) break;
    }
    if (lane == 0) {
      if (last < 0) lb_publish(&lb[tile], epoch | LB_INCL | carry);
      if (!SHARDED) done_ticket = atomicAdd(&hdr[S1_DONE], 1u);
      s_carry = (int)carry;
    }
    // The carried head's open words: it lies before the halo.
    const int h = (int)carry - 1;
    if (h >= 0) {
      const u32* hr = drows + (size_t)perm[(size_t)b * L + h] * NC + NID;
      for (int w = lane; w < KO1; w += 32) shead[w] = hr[w];
    }
  }
  __syncthreads();
  bool keep = false;
  if (i < L) {
    bool head_sub = false;
    if (sv && !is_start) {
      const int h = seg >= 0 ? seg : s_carry - 1;
      const u32* ho = h >= i0 - PR_HALO ? srow + (size_t)(h - i0 + PR_HALO) * NC + NID : shead;
      head_sub = true;
      for (int w = 0; w < KO1; ++w) head_sub = head_sub && ((ho[w] & ~me[NID + w]) == 0u);
    }
    keep = sv && !(same && psub) && !head_sub;
    int opc = 0;
    for (int w = 0; w < KO1; ++w) opc += __popc(me[NID + w]);
    const u32 maxp = (PB >= 32) ? FULL : ((1u << PB) - 1u);
    fprio[(size_t)b * L + i] =
        ((keep ? 0u : 1u) << (PB + 6)) | ((maxp - me[0]) << 6) | (u32)min(opc, 63);
  }
  const int kept = __syncthreads_count(keep);
  if (tid == 0 && kept) atomicAdd(&ctl[(size_t)b * CTL_SIZE + CTL_COUNT], kept);
  if (SHARDED) done_last();
  else if (tid == 0) s1_last(hdr, done_ticket, blocks);
}

// ---------------------------------------------------------------------------
// K5 top-F gather into the frontier (reference lines 741-811) and the loop
// carry update (lines 791-843), each member into its own frontier, control
// block and stats ring. In a frontier-sharded level (`mode` EX_ALLTOALL or
// EX_ALLGATHER) the members are the shards of one search, and the outcome
// comes from the replicated fields the prune's reduce wrote (reference lines
// 697-711 and 743-757): alltoall keeps the first min(count_local, F) rows
// of the shard's own order, allgather the shard's slice [s*F, s*F + F) of
// the global order, valid below min(count, F*D); no stats row is written
// (the reference collects none when sharded).
//
// What bounds it: the kept rows (NC words each) and their indices read
// once, the frontier (F rows of NC words and a validity byte) written
// once: about 0.3 MB, 0.1 us of HBM time, at the main path's F = 4096
// with every row kept. What costs is latency, so the design is one launch
// with two dependent loads a row:
//
// - the compaction sort carries the dedup order's row indices as its
//   values, so perm[off + k] is the row of frontier slot k (no separate
//   order to read first);
// - a block takes GF_ROWS slots of its member (blockIdx.y): it reads their
//   indices, then gathers the kept rows into shared memory with cp.async,
//   a word a thread of warps 1-7, every load in flight at once, and all
//   its warps store p, mD, st, mO and valid each as one coalesced run of
//   the block's slots (zeros past the kept rows);
// - the slots' row indices are read with the control block (where they
//   lie does not depend on the outcome);
// - every block that did not find the member stopped takes a ticket from
//   a per-member counter in a scratch once all its threads have read the
//   control block, on thread 0 with an acq_rel add while warps 1-7
//   gather; the block that drew the last ticket runs the loop carry
//   update, the stats row and the stop test on one thread (the other
//   blocks only write the frontier, which the finalize does not read) and
//   puts the counter back to zero: the scratch cleans itself. A dead level (the frontier kept)
//   stores no row but still takes its tickets.

__device__ __forceinline__ void level_outcome(const int* ctl, int F, int P2, bool* ovf_now,
                                              bool* dead, bool* stuck_now, int* kept) {
  int count = ctl[CTL_COUNT];
  bool pre_ovf = ctl[CTL_ROWOVF] != 0 || (P2 > 0 && ctl[CTL_NEXP] > P2);
  *ovf_now = pre_ovf || count > F;
  bool lossy = ctl[CTL_LOSSY] != 0;
  *stuck_now = (count == 0) && !(*ovf_now && !lossy);
  *dead = (*ovf_now && !lossy) || count == 0;
  *kept = min(count, F);
}

__device__ __forceinline__ void sharded_outcome(const int* ctl, int s, int F, int D, int mode,
                                                bool* ovf_now, bool* dead, bool* stuck_now,
                                                int* kept, int* off) {
  int count = ctl[CTL_GCOUNT];
  *ovf_now = ctl[CTL_GOVF] != 0;
  bool lossy = ctl[CTL_LOSSY] != 0;
  *stuck_now = (count == 0) && !(*ovf_now && !lossy);
  *dead = (*ovf_now && !lossy) || count == 0;
  *kept = shard_kept(mode, ctl[CTL_COUNT], count, s, F, D);
  *off = (mode == EX_ALLGATHER) ? s * F : 0;
}

#define GF_THREADS 256
#define GF_ROWS 128  // frontier slots a block, at most GF_THREADS
static_assert(GF_ROWS <= GF_THREADS, "a thread reads each slot's row index");

// Dynamic shared memory of k_gather_finalize: the block's rows and their
// indices.
__host__ __device__ constexpr size_t gf_smem(int NC) {
  return 4 * ((size_t)GF_ROWS * NC + GF_ROWS);
}

// The loop carry update, stats row and stop test of member s (of D) after
// its level (reference lines 791-843), on one thread.
__device__ void finalize_member(int* ctl, int* stats, int s, int D, int F, int P2,
                                int n_stat_rows, int mode) {
  bool ovf_now, dead, stuck_now;
  int kept, off = 0, fm, nonempty;
  int lvl = ctl[CTL_LVL];
  if (mode) {
    sharded_outcome(ctl, s, F, D, mode, &ovf_now, &dead, &stuck_now, &kept, &off);
    fm = min(ctl[CTL_GCOUNT], F * D);
    nonempty = ctl[CTL_NSUM] > 0;  // every shard's, as the reduce saw them
  } else {
    level_outcome(ctl, F, P2, &ovf_now, &dead, &stuck_now, &kept);
    fm = kept;
    nonempty = (dead ? ctl[CTL_FCOUNT] : kept) > 0;
    int* row = stats + (size_t)s * n_stat_rows * 4 + ((lvl + 1) % n_stat_rows) * 4;
    row[0] = lvl + 1;
    row[1] = kept;
    row[2] = ctl[CTL_NEXP];
    row[3] = ovf_now ? 1 : 0;
  }
  int acc = ctl[CTL_ACC] | ctl[CTL_ACCNOW];
  int ovf = ctl[CTL_OVF] | (ovf_now ? 1 : 0);
  int stuck = ctl[CTL_STUCK] | (stuck_now ? 1 : 0);
  int fcount = dead ? ctl[CTL_FCOUNT] : kept;
  int lvl2 = dead ? lvl : lvl + 1;
  bool go = !acc && (ctl[CTL_LOSSY] || !ovf) && !stuck && nonempty && lvl2 < ctl[CTL_MAXLVL];
  ctl[CTL_LVL] = lvl2;
  ctl[CTL_ACC] = acc;
  ctl[CTL_OVF] = ovf;
  ctl[CTL_FMAX] = max(ctl[CTL_FMAX], fm);
  ctl[CTL_STUCK] = stuck;
  ctl[CTL_FCOUNT] = fcount;
  ctl[CTL_GO] = go ? 1 : 0;
  ctl[CTL_NEXP] = 0;
  ctl[CTL_ACCNOW] = 0;
  ctl[CTL_ROWOVF] = 0;
  ctl[CTL_COUNT] = 0;
}

// Words [c0, c0 + w) of the block's nr staged rows to dst (w words a slot),
// zeros from row nk on.
__device__ __forceinline__ void gf_store(u32* __restrict__ dst, const u32* srow, int NC, int c0,
                                         int w, int nr, int nk) {
  for (int j = threadIdx.x; j < nr * w; j += GF_THREADS) {
    const int r = j / w;
    dst[j] = r < nk ? srow[r * NC + c0 + (j - r * w)] : 0u;
  }
}

__global__ void __launch_bounds__(GF_THREADS)
k_gather_finalize(const u32* __restrict__ drows, const int* __restrict__ perm, int* ctl,
                  int* stats, int* __restrict__ p, u32* __restrict__ mD, u32* __restrict__ mO,
                  int* __restrict__ st, unsigned char* __restrict__ valid, u32* tickets, int F,
                  int L, int NC, int KD, int S, int KO1, int P2, int n_stat_rows, int mode) {
  const int b = blockIdx.y, tid = threadIdx.x;
  int* c = ctl + (size_t)b * CTL_SIZE;
  extern __shared__ __align__(16) u32 gf_buf[];
  u32* srow = gf_buf;                                               // [GF_ROWS][NC]
  int* sidx = reinterpret_cast<int*>(srow + (size_t)GF_ROWS * NC);  // [GF_ROWS]
  __shared__ int s_last;
  const int k0 = blockIdx.x * GF_ROWS;
  const int nr = min(GF_ROWS, F - k0);  // the block's slots
  // The slots' row indices are read with the control block: where they
  // lie in perm does not depend on the level's outcome.
  const size_t pi = (size_t)(mode == EX_ALLGATHER ? b * F : 0) + k0 + tid;
  const int idx = tid < nr && pi < (size_t)L ? perm[(size_t)b * L + pi] : 0;
  if (stopped(c)) return;  // the member is skipped whole: no ticket
  bool ovf_now, dead, stuck_now;
  int kept, off = 0;
  if (mode)
    sharded_outcome(c, b, F, gridDim.y, mode, &ovf_now, &dead, &stuck_now, &kept, &off);
  else
    level_outcome(c, F, P2, &ovf_now, &dead, &stuck_now, &kept);
  const int nk = dead ? 0 : max(0, min(nr, kept - k0));  // slots kept
  if (tid < GF_ROWS) sidx[tid] = idx;
  // Every thread's reads of the control block, which the member's last
  // block overwrites, are ordered by this barrier before thread 0's
  // ticket, an acq_rel add at device scope: its release half (cumulative)
  // puts the block's reads before the ticket, every later ticket of the
  // member continues its release sequence, and its acquire half puts the
  // finalize's writes after the last ticket. So every block's reads happen
  // before the finalize's writes. Thread 0 takes the ticket while warps
  // 1-7 gather, so the add's ordering waits behind neither the gather nor
  // the stores.
  __syncthreads();
  if (tid == 0) s_last = ticket_acq_rel(tickets + b) == gridDim.x - 1;
  // A dead level (lossless restore or dead end: the old frontier is kept)
  // has nk = 0 and stores nothing.
  const u32* rows = drows + (size_t)b * L * NC;
  if (tid >= 32)
    for (int j = tid - 32; j < nk * NC; j += GF_THREADS - 32) {
      const int r = j / NC;
      cp_async4(srow + j, rows + (size_t)sidx[r] * NC + (j - r * NC));
    }
  cp_async_wait_all();
  __syncthreads();
  if (!dead) {
    const size_t f0 = (size_t)b * F + k0;
    if (tid < nr) {
      p[f0 + tid] = tid < nk ? (int)srow[(size_t)tid * NC] : 0;
      valid[f0 + tid] = tid < nk ? 1 : 0;
    }
    gf_store(mD + f0 * KD, srow, NC, 1, KD, nr, nk);
    gf_store(reinterpret_cast<u32*>(st) + f0 * S, srow, NC, 1 + KD, S, nr, nk);
    gf_store(mO + f0 * KO1, srow, NC, 1 + KD + S, KO1, nr, nk);
  }
  if (s_last && tid == 0) {
    tickets[b] = 0;
    finalize_member(c, stats, b, gridDim.y, F, P2, n_stat_rows, mode);
  }
}

// ---------------------------------------------------------------------------
// Frontier-sharded level: owner routing with the exchange, and the
// allgather. Replaces the reference's sharded program,
// jepsen_tpu/parallel/frontier.py `_sharded_kernel` (line 72), i.e. the
// `axis_name` arms of ops/wgl.py `_build_kernel` (lines 490-493, 525-630,
// 697-757, 830-836, 877-890). The D shards of a mesh are the members of
// one batch on one device, so each collective becomes a kernel over the
// shards' buffers: `all_to_all` is folded into the owner routing
// (k_route), `all_gather` is a row copy (k_exchange), and
// `pmax`/`psum`/`pmin` run in the last block of the launch before them
// (k_prune, k_chunk_init; see "Cross-shard reductions" above).

// Owner routing and the alltoall exchange in one scatter (reference lines
// 551-611): shard s's stage-1 rows i < n_s = min(n_cand of s, P), in
// position order, each to its owner d = FNV(identity words) mod D
// (unsigned) at drows[d][s * PBK + j], j its rank among s's rows owned by
// d, with rvalid 1, when j < PBK; slots [count(s, d), PBK) are zeros with
// rvalid 0; count(s, d) > PBK sets ctl[s][CTL_ROWOVF]. The TPU program
// sorted each shard's rows by owner into send buckets and let the
// collective move them; with every shard on one card each row is written
// once, straight to its place in its owner's receive rows, so there is no
// send buffer and no second copy (on several cards a send layout comes
// back). A destination that is stopped is not written; a source that is
// stopped sends nothing (its buckets are empty). Each slot's key is
// written too (the received rows' hash, reference lines 612-645): a routed
// row's is the hash its owner test took, shifted right by one; an empty
// slot's the zero row's key. So no launch hashes the received rows again.
//
// What bounds it: each routed row is read and written once and each bucket
// slot written once: about 0.14 us of HBM time at sharded_10k's 8 x 2048
// stage-1 rows. What costs is latency, and the identity words that every
// (s, d) block reads (each row's D times, from L2). The design:
//
// - a block owns destination d of source s over a tile of RT_THREADS * IPT
//   rows (row i0 + k * RT_THREADS + tid for k < IPT); its (s, tile, d)
//   comes from one ticket counter over the grid, so it only waits on
//   blocks that took earlier tickets and run;
// - one owner is tested a block, so a warp ranks its rows with one ballot a
//   k and a popcount, not with __match_any_sync (whose cost grows with the
//   distinct owners of a warp: ~0.56 us each on the H100); warp 0 scans
//   the (k, warp) counts, which are in position order;
// - a tile's offset in its bucket is carried across the tiles of (s, d) by
//   stage 1's decoupled look-back (epoch-tagged 64-bit words keyed by (s,
//   d, tile), a scratch that cleans itself);
// - rows of at most RT_REG_WORDS words (RW, a template parameter: the
//   north star's are 5) are read whole with the hash's loads and kept in
//   registers; the thread that holds a selected row stores it at its rank
//   (a warp's selected rows are one contiguous run), so the stores wait on
//   no load. Wider rows: the selected rows' positions are listed in shared
//   memory and their words copied into the bucket's run, consecutive
//   threads storing consecutive words, four loads in flight a thread.
//   Staging the whole tile in shared memory first, as the expand and the
//   gather-finalize stage theirs, was slower on the H100 (PERF.md §6):
//   only 1/D of the tile is stored. A selected row's key goes out with it:
//   hashed again from the row's registers at the store (keeping the owner
//   test's hashes live across the look-back cost the 4-row tile 80
//   registers a thread, one block an SM instead of two); wide rows list
//   the hash beside the position;
// - the bucket's end: the last tile of (s, d) knows its count, sets the
//   overflow flag and zeroes the slots [count, min(PBK, RT_FILL)); the
//   slots past RT_FILL (a bucket of the largest rungs) are zeroed by fill
//   blocks, RT_FILL slots each, whose tickets follow the source's data
//   blocks and which wait on the last tile's inclusive count (an earlier
//   ticket: its block runs or has run).

#define RT_THREADS 512
#define RT_FILL 2048  // bucket slots a fill block zeroes
#define RT_REG_WORDS 8  // rows at most this wide are kept in registers

// Zeros with rvalid 0 (and the zero row's key zk) in rows [a, b) of the
// run that starts at row r0.
__device__ __forceinline__ void rt_zero(u32* __restrict__ drows, unsigned char* __restrict__ rvalid,
                                        u32* __restrict__ fkey, u32 zk, size_t r0, int a, int b,
                                        int NC) {
  if (a >= b) return;
  u32* dst = drows + (r0 + a) * NC;
  for (int j = threadIdx.x; j < (b - a) * NC; j += RT_THREADS) dst[j] = 0u;
  for (int r = a + threadIdx.x; r < b; r += RT_THREADS) {
    rvalid[r0 + r] = 0;
    fkey[r0 + r] = zk;
  }
}

template <int IPT, int RW>
__global__ void __launch_bounds__(RT_THREADS)
k_route(const u32* __restrict__ crows, int* ctl, u32* __restrict__ drows,
        unsigned char* __restrict__ rvalid, u32* __restrict__ fkey, u32* state, int P, int NC,
        int NID, int D, int PBK, int tiles, int nfill) {
  constexpr int T = IPT * RT_THREADS, NW = RT_THREADS / 32, E = IPT * NW;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  __shared__ unsigned short s_list[T];
  __shared__ u32 s_hash[RW == 0 ? T : 1];  // the listed rows' hashes (wide rows)
  __shared__ int s_cnt[E];
  __shared__ int s_ticket, s_count, s_off;
  __shared__ u32 s_epoch;
  const int per_s = (tiles + nfill) * D, blocks = gridDim.x;
  u32* hdr = state;
  if (tid == 0) {
    s_ticket = (int)atomicAdd(&hdr[S1_CTR], 1u);
    s_epoch = hdr[S1_EPOCH];
  }
  // A ticket's block: source s, then its data blocks (tile-major, then d),
  // then its fill blocks (slice z >= 1, then d).
  int s, d, tile, z;
  auto role = [&](int t) {
    s = t / per_s;
    const int r = t - s * per_s;
    if (r < tiles * D) {
      tile = r / D;
      d = r - tile * D;
      z = 0;
    } else {
      z = 1 + (r - tiles * D) / D;
      d = r - tiles * D - (z - 1) * D;
      tile = tiles - 1;
    }
  };
  // The control blocks and (a data block) the owners of the tile's rows,
  // each warp's ballot a k and its count in shared memory. The rows past
  // n_s are hashed too (whatever they hold) and masked: their loads need
  // not wait for n_s.
  int n = 0, go_d = 0, live = 0;
  u32 ball[IPT], h[IPT];  // the owner ballots, the thread's rows' hashes (wide rows keep them)
  u32 rw[IPT][RW > 0 ? RW : 1];  // RW: the thread's rows
  const u32* src = nullptr;  // the tile's rows
  auto load = [&]() {
    const int* cs = ctl + (size_t)s * CTL_SIZE;
    const int go_s = cs[CTL_GO];
    go_d = ctl[(size_t)d * CTL_SIZE + CTL_GO];
    n = go_s ? min(max(cs[CTL_NEXP], 0), P) : 0;
    live = go_s || go_d;
    if (z > 0) return;
    src = crows + ((size_t)s * P + (size_t)tile * T) * NC;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int i = tile * T + k * RT_THREADS + tid;
      const u32* r = src + (size_t)(k * RT_THREADS + tid) * NC;
      if constexpr (RW > 0) {
#pragma unroll
        for (int c = 0; c < RW; ++c) rw[k][c] = i < P && c < NC ? r[c] : 0u;
        u32 gh = 2166136261u;
#pragma unroll
        for (int c = 0; c < RW; ++c)
          if (c < NID) gh = (gh ^ rw[k][c]) * 16777619u;
        h[k] = gh;
      } else {
        h[k] = i < P ? fnv_row(r, NID) : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int i = tile * T + k * RT_THREADS + tid;
      ball[k] = __ballot_sync(FULL, i < n && h[k] % (u32)D == (u32)d);
      if (lane == 0) s_cnt[k * NW + wid] = __popc(ball[k]);
    }
  };
  // Blocks start in blockIdx order, so the guess is most likely the
  // ticket; it is loaded again only if the ticket names another block.
  role(blockIdx.x);
  load();
  __syncthreads();
  if (s_ticket != (int)blockIdx.x) {
    role(s_ticket);
    load();
    __syncthreads();
  }
  const unsigned long long epoch = (unsigned long long)s_epoch << 32;
  if (!live) {  // both shards stopped
    if (tid == 0) s1_last(hdr, atomicAdd(&hdr[S1_DONE], 1u), blocks);
    return;
  }
  const size_t r0 = ((size_t)d * D + s) * PBK;  // the bucket's first row in drows
  unsigned long long* lb =
      reinterpret_cast<unsigned long long*>(hdr + S1_HDR) + ((size_t)s * D + d) * tiles;
  u32 done_ticket = 0u;
  if (z > 0) {  // a fill block: the bucket's count from its last tile
    if (tid == 0) {
      u32 x;
      do x = lb_word(&lb[tiles - 1], epoch);
      while ((x & LB_INCL) == 0u);
      s_count = (int)(x & LB_VALUE);
      done_ticket = atomicAdd(&hdr[S1_DONE], 1u);
    }
    __syncthreads();
    if (go_d)
      rt_zero(drows, rvalid, fkey, zero_row_key(NID), r0, max(s_count, z * RT_FILL),
              min(PBK, (z + 1) * RT_FILL), NC);
    if (tid == 0) s1_last(hdr, done_ticket, blocks);
    return;
  }
  // Warp 0 scans the (k, warp) counts (at most 64: two a lane) and
  // publishes the tile's count before it looks back.
  if (wid == 0) {
    constexpr int PER = (E + 31) / 32;
    int v[PER], own = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane * PER + j;
      v[j] = e < E ? s_cnt[e] : 0;
      own += v[j];
    }
    const int incl = warp_incl_sum(own, lane);
    int run = incl - own;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane * PER + j;
      if (e < E) s_cnt[e] = run;
      run += v[j];
    }
    const int count = __shfl_sync(FULL, incl, 31);
    if (lane == 0) {
      s_count = count;
      lb_publish(&lb[tile], epoch | (tile == 0 ? LB_INCL : LB_AGG) | (u32)count);
    }
  }
  __syncthreads();
  if constexpr (RW == 0) {
#pragma unroll
    for (int k = 0; k < IPT; ++k)
      if ((ball[k] >> lane) & 1u) {
        const int j = s_cnt[k * NW + wid] + __popc(ball[k] & lane_lt_mask(lane));
        s_list[j] = (unsigned short)(k * RT_THREADS + tid);
        s_hash[j] = h[k];
      }
  }
  if (wid == 0) {
    const int pre = lb_sum_before(lb, tile, epoch, lane);
    if (lane == 0) {
      if (tile > 0) lb_publish(&lb[tile], epoch | LB_INCL | (u32)(pre + s_count));
      s_off = pre;
      done_ticket = atomicAdd(&hdr[S1_DONE], 1u);
    }
  }
  __syncthreads();
  const int off = s_off, count = s_count;
  if (go_d && RW > 0) {
    u32* dst = drows + (r0 + off) * NC;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int j = s_cnt[k * NW + wid] + __popc(ball[k] & lane_lt_mask(lane));
      if (((ball[k] >> lane) & 1u) && off + j < PBK) {
#pragma unroll
        for (int c = 0; c < (RW > 0 ? RW : 1); ++c)
          if (c < NC) dst[(size_t)j * NC + c] = rw[k][c];
        rvalid[r0 + off + j] = 1;
        u32 gh = 2166136261u;  // the hash again from the row's registers: h[] is not kept live
#pragma unroll
        for (int c = 0; c < (RW > 0 ? RW : 1); ++c)
          if (c < NID) gh = (gh ^ rw[k][c]) * 16777619u;
        fkey[r0 + off + j] = gh >> 1;
      }
    }
  } else if (go_d) {
    const int nw = max(0, min(count, PBK - off)) * NC;
    u32* dst = drows + (r0 + off) * NC;
    for (int j0 = 0; j0 < nw; j0 += 4 * RT_THREADS) {
      u32 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * RT_THREADS + tid;
        if (j < nw) {
          const int r = j / NC;
          w[u] = src[(size_t)s_list[r] * NC + (j - r * NC)];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * RT_THREADS + tid;
        if (j < nw) dst[j] = w[u];
      }
    }
    for (int r = tid; r * NC < nw; r += RT_THREADS) {
      rvalid[r0 + off + r] = 1;
      fkey[r0 + off + r] = s_hash[r] >> 1;
    }
  }
  if (tile == tiles - 1) {  // the bucket's end
    const int total = off + count;
    if (tid == 0 && total > PBK) ctl[(size_t)s * CTL_SIZE + CTL_ROWOVF] = 1;
    if (go_d) rt_zero(drows, rvalid, fkey, zero_row_key(NID), r0, total, min(PBK, RT_FILL), NC);
  }
  if (tid == 0) s1_last(hdr, done_ticket, blocks);
}

// The tiled all_gather of the stage-1 rows (reference lines 592-611):
// recv[d][s * P + j] = send[s][j], valid below min(n_cand of s, P), for
// destination shard d and source shard s; invalid rows are written as
// zeros, so the received buffers are the same on every run. Received rows
// are in source order, as the tiled collective gives them.
//
// Each (d, s) pair is one contiguous run of P * NC words in both buffers,
// so the exchange is D^2 block copies: a block moves EX_WORDS words of one
// run (grid x: the chunk, y: s, z: d), a thread one 16-byte vector aligned
// to the destination, with a scalar head and tail where the run does not
// start on 16 bytes (P * NC need not be a multiple of 4), and a vector
// load too where the source has the same alignment. Bound by bytes: each
// row is read once (from L2 after the first destination) and written once;
// at the main path's sizes a call is a few microseconds of latency, so a
// thread issues its row and the stop test at once and waits a single
// round trip. Each row's key goes with it (skey [D, P] stage 1's, fkey [D,
// D * P]): a valid row's from skey, the zero row's key past the valid
// prefix; a block's rows are at most one a thread, and the key's load goes
// out with the row's.
#define EX_THREADS 256
#define EX_WORDS (EX_THREADS * 4)  // a 16-byte group a thread

// Loads the compiler keeps where they are written (volatile asm is not
// moved past another): k_exchange issues its row before it tests the stop.
__device__ __forceinline__ uint4 ld_v4_now(const u32* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_now(const int* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(EX_THREADS)
k_exchange(const u32* __restrict__ send, const int* ctl, u32* __restrict__ recv,
           unsigned char* __restrict__ rvalid, const u32* __restrict__ skey,
           u32* __restrict__ fkey, int P, int NC, int NID) {
  const int s = blockIdx.y, d = blockIdx.z;
  const int RW = P * NC;  // words of the run
  const int c0 = blockIdx.x * EX_WORDS;
  if (c0 >= RW) return;
  const int c1 = min(RW, c0 + EX_WORDS);
  const size_t drow = ((size_t)d * gridDim.y + s) * P;
  const u32* a = send + (size_t)s * P * NC;
  u32* o = recv + drow * NC;
  // The destination's 16-byte groups inside [c0, c1), a scalar head and tail.
  const int g0 = min(c1, c0 + (int)((4 - (((uintptr_t)(o + c0) >> 2) & 3)) & 3));
  const int ng = (c1 - g0) >> 2;
  const int g1 = g0 + 4 * ng;
  const int t = threadIdx.x;
  const int w = g0 + 4 * t;
  // The loads go out together: the stop test and the source's n_cand do
  // not hold up the row's (a stopped destination's are just not stored).
  const bool stop = ctl != nullptr && ld_now(ctl + (size_t)d * CTL_SIZE + CTL_GO) == 0;
  const int ncand = ld_now(ctl + (size_t)s * CTL_SIZE + CTL_NEXP);
  // the first row whose first word is in [c0, c1) for this thread, its key
  const int rk = (c0 + NC - 1) / NC + t;
  const u32 key0 = rk * NC < c1 ? (u32)ld_now((const int*)skey + (size_t)s * P + rk) : 0u;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (t < ng) {
    if ((((uintptr_t)(a + g0)) & 15) == 0) {
      x = ld_v4_now(a + w);
    } else {
      x.x = a[w];
      x.y = a[w + 1];
      x.z = a[w + 2];
      x.w = a[w + 3];
    }
  }
  if (stop) return;
  // The valid prefix ends on a row boundary, so a word's test is its row's.
  const int vw = max(0, min(ncand, P)) * NC;
  if (t < g0 - c0) o[c0 + t] = c0 + t < vw ? a[c0 + t] : 0u;
  if (t < c1 - g1) o[g1 + t] = g1 + t < vw ? a[g1 + t] : 0u;
  if (t < ng) {
    x.x = w < vw ? x.x : 0u;
    x.y = w + 1 < vw ? x.y : 0u;
    x.z = w + 2 < vw ? x.z : 0u;
    x.w = w + 3 < vw ? x.w : 0u;
    *reinterpret_cast<uint4*>(o + w) = x;
  }
  // The validity bytes and keys of the rows whose first word is in [c0, c1).
  const u32 zk = zero_row_key(NID);
  for (int r = rk; r * NC < c1; r += EX_THREADS) {
    const bool v = r * NC < vw;
    rvalid[drow + r] = v ? 1 : 0;
    fkey[drow + r] = !v ? zk : r == rk ? key0 : skey[(size_t)s * P + r];
  }
}

// ---------------------------------------------------------------------------
// Re-batch of stacked frontiers. Replaces the reference's
// jepsen_tpu/parallel/batch.py `_regroup_program` (line 95) and, with one
// member and idx = [0], the single-history frontier grow
// jepsen_tpu/ops/wgl.py `_pad_program` (line 1074) and the sharded
// escalation's grow of the global frontier (jepsen_tpu/parallel/
// frontier.py lines 375, 401): dst[j, f, c] = src[idx[j], f, c] for f <
// F_old, else 0, for each of the five frontier arrays; an index may repeat
// (one member regrouped twice).
//
// What bounds it: bytes, each selected member's rows read once and each
// output byte written once (about 6.9 MB at the sharded grow from 65536
// to 262144 rows, 2 us of HBM time). A selected member's rows in one array
// are one contiguous byte run of F_old * R * size bytes, so the whole
// regroup is n_new * 5 run copies, each followed by a zero fill up to
// F_new * R * size bytes. The design: one launch for all five arrays; a
// block takes RG_CHUNK bytes of one destination run (its (array, member,
// chunk) from blockIdx.x through the arrays' block counts), copies the
// part below the source run's end and zeroes the rest. Up to RG_INLINE
// member indices travel in the launch's parameters, so the call needs no
// copy of them to the card. A thread moves
// RG_UNROLL 16-byte groups aligned to the destination, their loads all in
// flight before the first store: one 16-byte load a group where the source
// shares the destination's alignment, four words where it shares a word's
// (the u32 arrays at any F), bytes otherwise (valid at an F that is not a
// multiple of 16); a scalar head and tail where the run does not start or
// end on 16 bytes.

#define RG_THREADS 256
#define RG_UNROLL 4
#define RG_CHUNK (RG_THREADS * RG_UNROLL * 16)  // destination bytes a block
#define RG_ARRAYS 5
#define RG_INLINE 256  // member indices passed in the launch's parameters

struct RgArray {
  const unsigned char* src;
  unsigned char* dst;
  long old_bytes, new_bytes;  // a member's run in src and in dst
  int chunks;                 // blocks a member's destination run
};

struct RgArgs {
  RgArray a[RG_ARRAYS];
  int blocks[RG_ARRAYS];  // blocks of each array: n_new * chunks
  int idx[RG_INLINE];     // the member indices, when there are at most RG_INLINE
};

__device__ __forceinline__ unsigned char rg_byte(const unsigned char* src, long x, long ncp) {
  return x < ncp ? src[x] : (unsigned char)0;
}

__global__ void __launch_bounds__(RG_THREADS)
k_regroup(const __grid_constant__ RgArgs args, const int* __restrict__ idx) {
  int r = blockIdx.x, k = 0;
  while (k < RG_ARRAYS - 1 && r >= args.blocks[k]) r -= args.blocks[k++];
  const RgArray& A = args.a[k];
  const int j = r / A.chunks, chunk = r - j * A.chunks;
  const long lo = (long)chunk * RG_CHUNK;
  const long hi = lo + RG_CHUNK < A.new_bytes ? lo + RG_CHUNK : A.new_bytes;
  const unsigned char* src = A.src + (long)(idx ? idx[j] : args.idx[j]) * A.old_bytes;
  unsigned char* dst = A.dst + (long)j * A.new_bytes;
  const long ncp = A.old_bytes;  // bytes [0, ncp) of the run are copied
  // [g0, g1): the destination's 16-byte groups inside [lo, hi)
  const long h0 = lo + (long)((16 - ((uintptr_t)(dst + lo) & 15)) & 15);
  const long g0 = h0 < hi ? h0 : hi;
  const long g1 = g0 + ((hi - g0) & ~15L);
  const int t = threadIdx.x;
  if (t < g0 - lo) dst[lo + t] = rg_byte(src, lo + t, ncp);
  if (t < hi - g1) dst[g1 + t] = rg_byte(src, g1 + t, ncp);
  const uintptr_t mis = ((uintptr_t)src ^ (uintptr_t)dst) & 15;
  uint4 v[RG_UNROLL];
#pragma unroll
  for (int u = 0; u < RG_UNROLL; ++u) {
    const long x = g0 + 16L * (u * RG_THREADS + t);
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (x >= g1 || x >= ncp) continue;
    if (x + 16 <= ncp && mis == 0) {
      v[u] = *reinterpret_cast<const uint4*>(src + x);
    } else if (x + 16 <= ncp && (mis & 3) == 0) {
      const u32* w = reinterpret_cast<const u32*>(src + x);
      v[u] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      unsigned char* b = reinterpret_cast<unsigned char*>(&v[u]);
#pragma unroll
      for (int q = 0; q < 16; ++q) b[q] = rg_byte(src, x + q, ncp);
    }
  }
#pragma unroll
  for (int u = 0; u < RG_UNROLL; ++u) {
    const long x = g0 + 16L * (u * RG_THREADS + t);
    if (x < g1) *reinterpret_cast<uint4*>(dst + x) = v[u];
  }
}

// ---------------------------------------------------------------------------
// C entry points (ctypes). Pointers and the stream arrive as void*; `nb` is
// the number of members, each buffer [nb, ...] contiguous.

static inline int nblk(long n, int per) { return (int)((n + per - 1) / per); }

template <int IPT>
static int stage1_launch(dim3 grid, cudaStream_t s, const u32* rows, const unsigned char* nvalid,
                         const int* ctl, void* drows, void* fkey, void* state, int M, int NC,
                         int NID, int P, int tail) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(k_stage1<IPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s1_smem(IPT));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  k_stage1<IPT><<<grid, S1_THREADS, s1_smem(IPT), s>>>(rows, nvalid, ctl, (u32*)drows,
                                                       (u32*)fkey, (u32*)state, M, NC, NID, P,
                                                       tail);
  return (int)cudaGetLastError();
}

// One k_expand<KDM, KEYS> launch, its dynamic shared memory allowed past 48 KB
// when a wide row needs it.
template <int KDM, bool KEYS>
static int expand_launch(dim3 grid, size_t smem, cudaStream_t s, void* tabD, void* sufret,
                         void* invO, void* opO, void* a1O, void* a2O, void* p, void* mD, void* mO,
                         void* st, void* valid, void* ctl, void* rows, void* nvalid, void* fkey,
                         int F, int W, int KO, int ND, int NO, int B, int S, int step, int prm) {
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(k_expand<KDM, KEYS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  k_expand<KDM, KEYS><<<grid, EX_WARPS * 32, smem, s>>>(
      (const int*)tabD, (const int*)sufret, (const int*)invO, (const int*)opO, (const int*)a1O,
      (const int*)a2O, (const int*)p, (const u32*)mD, (const u32*)mO, (const int*)st,
      (const unsigned char*)valid, (int*)ctl, (u32*)rows, (unsigned char*)nvalid, (u32*)fkey, F, W,
      KO, ND, NO, B, S, step, prm);
  return (int)cudaGetLastError();
}

// radix_sort_pairs, with the key gather of wgl_take_col_sort when GATHER.
template <bool GATHER>
static int sort_pairs(void* keys, void* vals, void* tmp_k, void* tmp_v, void* state, int n,
                      int nb, void* ctl, void* stream, KeyGather kg) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)ctl;
  if (n <= 0 || nb <= 0) return (int)cudaGetLastError();
  if (tmp_k == nullptr) {
    if (n > RS_CTA_MAX) return (int)cudaErrorInvalidValue;
    static bool sized = false;
    if (!sized) {
      cudaError_t e = cudaFuncSetAttribute(k_sort_cta<GATHER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)rs_cta_smem(RS_CTA_IPT));
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    k_sort_cta<GATHER><<<nb, 1024, rs_cta_smem((n + 1023) >> 10), s>>>((u32*)keys, (u32*)vals,
                                                                       n, c, kg);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)2 * RS_TILE * sizeof(u32) + (RS_L_THREADS / 32) * RS_CNT * sizeof(int);
  static bool sized_l = false;
  if (!sized_l) {
    cudaError_t e =
        cudaFuncSetAttribute(k_sort_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized_l = true;
  }
  const int tiles = nblk(n, RS_TILE);
  // Upsweep blocks: a tile each, or more tiles a block once the batch has
  // more than 512 tiles (fewer histogram atomics).
  const int chunk = RS_TILE * nblk((long)tiles * nb, 512);
  u32* st = (u32*)state;
  k_sort_upsweep<GATHER><<<dim3(nblk(n, chunk), nb), RS_L_THREADS, 0, s>>>(
      (u32*)keys, (u32*)vals, n, chunk, st, tiles, nb, c, kg);
  for (int pass = 0; pass < 4; ++pass)
    k_sort_pass<<<dim3(tiles, nb), RS_L_THREADS, smem, s>>>((u32*)keys, (u32*)vals, (u32*)tmp_k,
                                                           (u32*)tmp_v, n, st, tiles, nb, pass, c);
  return (int)cudaGetLastError();
}

// One k_prune<SHARDED> launch, its dynamic shared memory allowed past
// 48 KB when the tile's rows need it.
template <bool SHARDED>
static int prune_launch(dim3 grid, int tile, size_t smem, cudaStream_t s, void* drows,
                        void* skey, void* perm, void* ctl, void* fprio, void* state, int L, int NC,
                        int NID, int KO1, int PB, int F, int P, int mode) {
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(k_prune<SHARDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  k_prune<SHARDED><<<grid, tile, smem, s>>>((const u32*)drows, (const u32*)skey,
                                            (const int*)perm, (int*)ctl, (u32*)fprio,
                                            (u32*)state, L, NC, NID, KO1, PB, F, P, mode);
  return (int)cudaGetLastError();
}

extern "C" {

const char* wgl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// ctl [nb, CTL_SIZE], valid [nb, F] u8, stats [nb, stat_words]; ticket:
// null, or for the nb shards of one sharded search one word, zero before
// the call (each call leaves it so). rows_host: n_rows rows of (lvl0,
// max_levels, lossy, nD, nO) in host memory, read during the call: one row
// for every member, or a row a member up to CS_INLINE; n_rows 0 reads the
// ladder table [nb, CS_TW] on the card instead, with lpc levels a chunk.
int wgl_chunk_init(void* ctl, void* valid, void* stats, void* ticket, void* table,
                   void* rows_host, int n_rows, int lpc, int stat_words, int F, int nb,
                   void* stream) {
  if (nb <= 0 || F < 0 || stat_words < 0 || n_rows < 0 || n_rows > CS_INLINE ||
      (n_rows > 1 && n_rows != nb) || (n_rows == 0 ? table == nullptr : rows_host == nullptr))
    return (int)cudaErrorInvalidValue;
  CsArgs args;
  args.n = n_rows;
  args.lpc = lpc;
  const int* rows = (const int*)rows_host;
  for (int r = 0; r < CS_INLINE; ++r) {
    const bool in = r < n_rows;
    args.lvl0[r] = in ? rows[5 * r] : 0;
    args.maxlvl[r] = in ? rows[5 * r + 1] : 0;
    args.lossy[r] = in ? (unsigned char)(rows[5 * r + 2] != 0) : 0;
    args.nd[r] = in ? rows[5 * r + 3] : 0;
    args.no[r] = in ? rows[5 * r + 4] : 0;
  }
  k_chunk_init<<<nb, CS_THREADS, 0, (cudaStream_t)stream>>>(
      args, (int*)ctl, (const unsigned char*)valid, (int*)stats, stat_words, (int*)table, F,
      (u32*)ticket);
  return (int)cudaGetLastError();
}

// tabD 16-byte aligned; W a multiple of 32, at most 1024. fkey: null, or
// (a single-stage level) [nb, F * R] the rows' keys.
int wgl_expand(void* tabD, void* sufret, void* invO, void* opO, void* a1O, void* a2O,
               void* p, void* mD, void* mO, void* st, void* valid, void* ctl, void* rows,
               void* nvalid, void* fkey, int F, int W, int KO, int ND, int NO, int B, int S,
               int step, int prm, int nb, void* stream) {
  const int KD = W >> 5;
  if (W <= 0 || (W & 31) || KD > 32 || ((uintptr_t)tabD & 15)) return (int)cudaErrorInvalidValue;
  const int NC = 1 + KD + S + (KO > 0 ? KO : 1);
  const size_t smem = ex_smem(NC, KO, S, B);
  const dim3 grid(nblk(F, EX_WARPS), nb);
  cudaStream_t s = (cudaStream_t)stream;
#define EXPAND_CASE(KDM)                                                                      \
  case KDM:                                                                                   \
    return fkey ? expand_launch<KDM, true>(grid, smem, s, tabD, sufret, invO, opO, a1O, a2O, p, \
                                           mD, mO, st, valid, ctl, rows, nvalid, fkey, F, W,  \
                                           KO, ND, NO, B, S, step, prm)                       \
                : expand_launch<KDM, false>(grid, smem, s, tabD, sufret, invO, opO, a1O, a2O, \
                                            p, mD, mO, st, valid, ctl, rows, nvalid, fkey, F, \
                                            W, KO, ND, NO, B, S, step, prm);
  switch (KD <= 2 ? 2 : KD <= 8 ? 8 : 32) {
    EXPAND_CASE(2)
    EXPAND_CASE(8)
    EXPAND_CASE(32)
  }
#undef EXPAND_CASE
  return (int)cudaErrorInvalidValue;
}

// Two-stage, in one launch: compact the valid rows of `rows` into `drows`
// (P rows) and write their keys, unless `fkey` is null (compaction only);
// with `tail` the keys of rows [n_cand, P) too, as invalid. `state`: 4 + 2 *
// nb * ceil(M / tile) words, zero before its first call; tile is 2048, 4096
// or 8192 rows, M below 2^30. (A single-stage level's keys come from the
// expand.)
int wgl_stage1_hash(void* rows, void* nvalid, void* ctl, void* drows, void* fkey, void* state,
                    int M, int NC, int NID, int P, int tail, int nb, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)ctl;
  if (M <= 0 || M >= (1 << 30) || nb <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  if (state == nullptr) return (int)cudaErrorInvalidValue;
  if (tile <= 0 || (long)nb * nblk(M, tile) >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk(M, tile), nb);
  const u32* r = (const u32*)rows;
  const unsigned char* v = (const unsigned char*)nvalid;
  void* d = drows;
  switch (tile) {
    case 2048: return stage1_launch<4>(grid, s, r, v, c, d, fkey, state, M, NC, NID, P, tail);
    case 4096: return stage1_launch<8>(grid, s, r, v, c, d, fkey, state, M, NC, NID, P, tail);
    case 8192: return stage1_launch<16>(grid, s, r, v, c, d, fkey, state, M, NC, NID, P, tail);
    default: return (int)cudaErrorInvalidValue;
  }
}

// keys/vals [nb, n]. Path S (tmp_k null, n <= RS_CTA_MAX): one launch.
// Path L: tmp_k/tmp_v [nb, n] each and `state`, nb * RS_HDR +
// 2 * nb * ceil(n / RS_TILE) * 256 words, zero on the first call (each
// call leaves it so): at most five launches, whatever the digits.
int radix_sort_pairs(void* keys, void* vals, void* tmp_k, void* tmp_v, void* state, int n, int nb,
                     void* ctl, void* stream) {
  return sort_pairs<false>(keys, vals, tmp_k, tmp_v, state, n, nb, ctl, stream, KeyGather{});
}

// radix_sort_pairs of the pairs (src[b][v * stride + col], v) with v = i
// (ident) or vals[b][i]: keys and vals are written whatever the digits.
// src [nb, rows >= n, stride] (member stride src_member words) must not
// overlap keys or vals; the scratch is radix_sort_pairs'.
int wgl_take_col_sort(void* src, long src_member, int stride, int col, int ident, void* keys,
                      void* vals, void* tmp_k, void* tmp_v, void* state, int n, int nb,
                      void* ctl, void* stream) {
  if (src == nullptr || stride <= 0 || col < 0 || col >= stride)
    return (int)cudaErrorInvalidValue;
  return sort_pairs<true>(keys, vals, tmp_k, tmp_v, state, n, nb, ctl, stream,
                          KeyGather{(const u32*)src, src_member, stride, col, ident ? 1 : 0});
}

// state: 4 + 2 * nb * ceil(L / tile) words, zero before its first call
// (each call leaves its counters zero and its epoch one higher); tile: rows
// a block, a multiple of 32 up to 1024; L below 2^30. mode: 0, or
// EX_ALLTOALL / EX_ALLGATHER for the nb shards of one sharded search at
// capacity F a shard and P stage-1 rows (the launch then also runs the
// cross-shard reduce).
int wgl_prune(void* drows, void* skey, void* perm, void* ctl, void* fprio, void* state, int L,
              int NC, int NID, int KO1, int PB, int F, int P, int mode, int nb, int tile,
              void* stream) {
  if (L <= 0 || L >= (1 << 30) - 1 || nb <= 0 || state == nullptr || tile < 32 || tile > 1024 ||
      (tile & 31) || (long)nb * nblk(L, tile) >= (1L << 31) || mode < 0 || mode > EX_ALLGATHER)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pr_smem(tile, NC, KO1);
  const dim3 grid(nblk(L, tile), nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode)
    return prune_launch<true>(grid, tile, smem, s, drows, skey, perm, ctl, fprio, state, L, NC,
                              NID, KO1, PB, F, P, mode);
  return prune_launch<false>(grid, tile, smem, s, drows, skey, perm, ctl, fprio, state, L, NC,
                             NID, KO1, PB, F, P, mode);
}

// mode: 0, or EX_ALLTOALL / EX_ALLGATHER for the nb shards of one sharded
// search (stats may then be null). perm [nb, L]: the rows in compaction
// order. tickets [nb] words, zero before the first call (each call leaves
// them so).
int wgl_gather_finalize(void* drows, void* perm, void* ctl, void* stats, void* p, void* mD,
                        void* mO, void* st, void* valid, void* tickets, int F, int L, int NC,
                        int KD, int S, int KO1, int P2, int n_stat_rows, int mode, int nb,
                        void* stream) {
  if (F <= 0 || nb <= 0 || tickets == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = gf_smem(NC);
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(k_gather_finalize,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  k_gather_finalize<<<dim3(nblk(F, GF_ROWS), nb), GF_THREADS, smem, (cudaStream_t)stream>>>(
      (const u32*)drows, (const int*)perm, (int*)ctl, (int*)stats, (int*)p, (u32*)mD, (u32*)mO,
      (int*)st, (unsigned char*)valid, (u32*)tickets, F, L, NC, KD, S, KO1, P2, n_stat_rows,
      mode);
  return (int)cudaGetLastError();
}

// crows [D, P, NC] stage-1 rows; drows [D, D * PBK, NC] and rvalid [D, D *
// PBK] the received rows, fkey [D, D * PBK] their keys; state: 4 + 2 * D *
// D * ceil(P / tile) words, zero before its first call (each call leaves
// its counters zero and its epoch one higher); tile: RT_THREADS times 1, 2
// or 4 rows.
int wgl_route(void* crows, void* ctl, void* drows, void* rvalid, void* fkey, void* state, int P,
              int NC, int NID, int D, int PBK, int tile, void* stream) {
  if (D < 1 || D > MAX_SHARDS || P <= 0 || P >= (1 << 30) || PBK <= 0 || state == nullptr ||
      fkey == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = nblk(P, tile), nfill = (PBK - 1) / RT_FILL;
  const long blocks = (long)D * D * (tiles + nfill);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const u32* c = (const u32*)crows;
  switch (tile) {
#define RT_LAUNCH(IPT, RW)                                                                  \
  k_route<IPT, RW><<<(unsigned)blocks, RT_THREADS, 0, s>>>(c, (int*)ctl, (u32*)drows,       \
                                                           (unsigned char*)rvalid,          \
                                                           (u32*)fkey, (u32*)state, P, NC,  \
                                                           NID, D, PBK, tiles, nfill)
#define RT_CASE(IPT)                    \
  case IPT * RT_THREADS:                \
    if (NC <= RT_REG_WORDS)             \
      RT_LAUNCH(IPT, RT_REG_WORDS);     \
    else                                \
      RT_LAUNCH(IPT, 0);                \
    break;
    RT_CASE(1)
    RT_CASE(2)
    RT_CASE(4)
#undef RT_CASE
#undef RT_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The allgather: send [D, P, NC] the stage-1 rows, valid below each
// source's n_cand and P; recv [D, D * P, NC], rvalid [D, D * P]; skey [D,
// P] stage 1's keys of the rows, fkey [D, D * P] the received keys.
int wgl_exchange(void* send, void* ctl, void* recv, void* rvalid, void* skey, void* fkey, int P,
                 int NC, int NID, int D, void* stream) {
  if (D < 1 || D > MAX_SHARDS || P <= 0 || skey == nullptr || fkey == nullptr)
    return (int)cudaErrorInvalidValue;
  k_exchange<<<dim3(nblk((long)P * NC, EX_WORDS), D, D), EX_THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)send, (const int*)ctl, (u32*)recv, (unsigned char*)rvalid, (const u32*)skey,
      (u32*)fkey, P, NC, NID);
  return (int)cudaGetLastError();
}

// Five arrays: p [nb, F] i32, mD [nb, F, KD] u32, mO [nb, F, KO1] u32,
// st [nb, F, S] i32, valid [nb, F] u8; idx_host [n_new] i32 in host
// memory, read during the call when n_new <= RG_INLINE; above that idx
// [n_new] i32 on the device. One launch.
int wgl_regroup(void* p, void* mD, void* mO, void* st, void* valid, void* p2, void* mD2,
                void* mO2, void* st2, void* valid2, void* idx, void* idx_host, int n_new,
                int F_old, int F_new, int KD, int KO1, int S, void* stream) {
  if (n_new < 0 || F_old < 0 || F_new < F_old || KD < 0 || KO1 < 0 || S < 0 ||
      (n_new <= RG_INLINE ? idx_host == nullptr : idx == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* src[RG_ARRAYS] = {p, mD, mO, st, valid};
  void* dst[RG_ARRAYS] = {p2, mD2, mO2, st2, valid2};
  const long row[RG_ARRAYS] = {4, 4L * KD, 4L * KO1, 4L * S, 1};  // bytes a frontier row
  RgArgs args;
  long blocks = 0;
  for (int k = 0; k < RG_ARRAYS; ++k) {
    const long nb = row[k] * F_new;
    const long chunks = (nb + RG_CHUNK - 1) / RG_CHUNK;
    if (chunks >= (1L << 31)) return (int)cudaErrorInvalidValue;
    args.a[k] = {(const unsigned char*)src[k], (unsigned char*)dst[k], row[k] * F_old, nb,
                 chunks > 0 ? (int)chunks : 1};
    args.blocks[k] = (int)(n_new * chunks);
    blocks += (long)n_new * chunks;
  }
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const bool inline_idx = n_new <= RG_INLINE;
  for (int j = 0; j < RG_INLINE; ++j)
    args.idx[j] = inline_idx && j < n_new ? ((const int*)idx_host)[j] : 0;
  if (blocks > 0)
    k_regroup<<<(unsigned)blocks, RG_THREADS, 0, (cudaStream_t)stream>>>(
        args, inline_idx ? nullptr : (const int*)idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
