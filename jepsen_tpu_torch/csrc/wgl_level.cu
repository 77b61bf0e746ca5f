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
// Frontier-sharded levels only (wgl_shard_reduce writes them, replicated
// to every shard's block): this level's global keep count and overflow,
// and the sum, max and min over shards of the frontier counts the level
// leaves (or the chunk starts with).
#define CTL_GCOUNT 15
#define CTL_GOVF 16
#define CTL_NSUM 17
#define CTL_NMAX 18
#define CTL_NMIN 19
#define CTL_SIZE 20

// Exchange modes of a frontier-sharded level (0: not sharded).
#define EX_ALLTOALL 1
#define EX_ALLGATHER 2
// Shards of one mesh: k_route keeps a per-warp count per destination in
// shared memory.
#define MAX_SHARDS 256

#define I32MAX 0x7FFFFFFF
#define UNKNOWN_VAL ((int)0x80000000)
#define FULL 0xFFFFFFFFu

// Elements per warp tile of the radix sort (must match _build.RS_TILE).
#define RS_TILE 1024
#define RS_WARPS 8

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

// ---------------------------------------------------------------------------
// Block-wide scans (blockDim.x == 1024, 32 warps)

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
    int s = ws[lane];
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

__device__ int block_incl_max(int v, int* total) {
  __shared__ int ws[32];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = ws[lane];
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s = max(s, y);
    }
    ws[lane] = s;
  }
  __syncthreads();
  int res = (w > 0) ? max(ws[w - 1], x) : x;
  if (total) *total = ws[31];
  __syncthreads();
  return res;
}

// Exclusive prefix sum of each member's row a[b][0..n) in place: one block
// of 1024 threads per member, each thread owning a contiguous segment.
__global__ void k_scan_excl_sum(int* a, int n, const int* ctl) {
  const int b = blockIdx.x;
  if (stopped(member_ctl(ctl, b))) return;
  a += (size_t)b * n;
  int per = (n + 1023) / 1024;
  int s0 = threadIdx.x * per;
  int s1 = min(s0 + per, n);
  int sum = 0;
  for (int i = s0; i < s1; ++i) sum += a[i];
  int off = block_excl_sum(sum, nullptr);
  for (int i = s0; i < s1; ++i) {
    int v = a[i];
    a[i] = off;
    off += v;
  }
}

// Exclusive prefix max of each member's row a[b][0..n) in place (-1 before
// the first), one block per member.
__global__ void k_scan_excl_max(int* a, int n, const int* ctl) {
  const int b = blockIdx.x;
  if (stopped(member_ctl(ctl, b))) return;
  a += (size_t)b * n;
  __shared__ int pre[1024];
  int per = (n + 1023) / 1024;
  int s0 = threadIdx.x * per;
  int s1 = min(s0 + per, n);
  int m = -1;
  for (int i = s0; i < s1; ++i) m = max(m, a[i]);
  pre[threadIdx.x] = block_incl_max(m, nullptr);
  __syncthreads();
  int run = threadIdx.x ? pre[threadIdx.x - 1] : -1;
  for (int i = s0; i < s1; ++i) {
    int v = a[i];
    a[i] = run;
    run = max(run, v);
  }
}

// ---------------------------------------------------------------------------
// Chunk start: frontier count and the stop test (reference lines 830-843),
// one block per member.

__global__ void k_chunk_init(int* ctl, const unsigned char* valid, int F) {
  const int b = blockIdx.x;
  ctl += (size_t)b * CTL_SIZE;
  valid += (size_t)b * F;
  int c = 0;
  for (int i = threadIdx.x; i < F; i += blockDim.x) c += valid[i] ? 1 : 0;
  int total;
  block_excl_sum(c, &total);
  if (threadIdx.x == 0) {
    ctl[CTL_FCOUNT] = total;
    bool go = !ctl[CTL_ACC] && (ctl[CTL_LOSSY] || !ctl[CTL_OVF]) && !ctl[CTL_STUCK] &&
              total > 0 && ctl[CTL_LVL] < ctl[CTL_MAXLVL];
    ctl[CTL_GO] = go ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K1 expand (reference lines 363-490): one warp per configuration, the
// member in blockIdx.y.

// Model steps. Each is a transcription of the reference model's `step_jax`
// (not of its `step_scalar`: the two differ on opcodes outside the model's
// range and on the state a refused op leaves, and the reference's device
// program runs `step_jax`); its plain version is the model's `step_torch`
// in jepsen_tpu_torch/models/. A step reads the parent's S state lanes
// `s` and returns ok; when `o` is not null it also writes the child's S
// lanes there (k_expand calls it once without `o` to decide the row and
// once with it for a row it keeps).
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
// steps (S = 1, 2, 4) work in registers. The reference's arithmetic is
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

__device__ __forceinline__ u32 new_word(const u32* mDf, int KD, int k, int t, int W) {
  if (k >= KD) return 0u;
  u32 x = mDf[k];
  if (t < W && (t >> 5) == k) x |= 1u << (t & 31);
  return x;
}

__global__ void k_expand(const int* __restrict__ tabD, const int* __restrict__ sufret,
                         const int* __restrict__ invO, const int* __restrict__ opO,
                         const int* __restrict__ a1O, const int* __restrict__ a2O,
                         const int* __restrict__ p, const u32* __restrict__ mD,
                         const u32* __restrict__ mO, const int* __restrict__ st,
                         const unsigned char* __restrict__ valid, int* ctl,
                         u32* __restrict__ rows, unsigned char* __restrict__ nvalid,
                         int F, int W, int KO, int ND, int NO, int B, int S, int step,
                         int prm) {
  const int b = blockIdx.y;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  const int lane = threadIdx.x & 31;
  const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (f >= F) return;
  const int KD = W >> 5;
  const int KO1 = KO > 0 ? KO : 1;
  const int NC = 1 + KD + S + KO1;
  const int C = W + 32 * KO;
  const bool SEL = B > 0;
  const size_t M = (size_t)F * (SEL ? B : C);
  // This member's tables, frontier and candidate rows.
  tabD += (size_t)b * ND * 8;
  sufret += (size_t)b * (ND + 1);
  invO += (size_t)b * NO;
  opO += (size_t)b * NO;
  a1O += (size_t)b * NO;
  a2O += (size_t)b * NO;
  p += (size_t)b * F;
  mD += (size_t)b * F * KD;
  mO += (size_t)b * F * KO1;
  st += (size_t)b * F * S;
  valid += (size_t)b * F;
  rows += (size_t)b * M * NC;
  nvalid += (size_t)b * M;
  const int nD = ctl[CTL_ND], nO = ctl[CTL_NO];
  const int pf = p[f];
  const bool vf = valid[f] != 0;
  const u32* mDf = mD + (size_t)f * KD;
  const u32* mOf = mO + (size_t)f * KO1;
  const int* stf = st + (size_t)f * S;

  // Two-min over unlinearized window rets: m1, its first slot am, and the
  // min over the other slots m2.
  int best = I32MAX, bidx = I32MAX;
  for (int c = 0; c < KD; ++c) {
    int t = c * 32 + lane;
    int row = pf + t;
    bool inr = row < nD;
    bool bit = (mDf[c] >> lane) & 1u;
    int val = (inr && !bit) ? tabD[(size_t)min(row, ND - 1) * 8 + 1] : I32MAX;
    if (val < best || (val == best && t < bidx)) { best = val; bidx = t; }
  }
  for (int o = 16; o; o >>= 1) {
    int ob = __shfl_xor_sync(FULL, best, o);
    int oi = __shfl_xor_sync(FULL, bidx, o);
    if (ob < best || (ob == best && oi < bidx)) { best = ob; bidx = oi; }
  }
  const int m1 = best, am = bidx;
  int m2 = I32MAX;
  for (int c = 0; c < KD; ++c) {
    int t = c * 32 + lane;
    int row = pf + t;
    bool inr = row < nD;
    bool bit = (mDf[c] >> lane) & 1u;
    int val = (inr && !bit) ? tabD[(size_t)min(row, ND - 1) * 8 + 1] : I32MAX;
    if (t != am) m2 = min(m2, val);
  }
  for (int o = 16; o; o >>= 1) m2 = min(m2, __shfl_xor_sync(FULL, m2, o));
  const int tail = sufret[min(pf + W, nD)];
  const int mra = min(m1, tail);

  int cnt = 0;  // candidates so far (warp-uniform)
  int n_ok = 0;
  bool acc = false;
  for (int c = 0; c < KD + KO; ++c) {
    const int t = c * 32 + lane;
    bool cand;
    int op, a1, a2;
    if (c < KD) {
      int row = pf + t;
      bool inr = row < nD;
      int rr = min(row, ND - 1);
      bool bit = (mDf[c] >> lane) & 1u;
      const int* tr = tabD + (size_t)rr * 8;
      int inv = inr ? tr[0] : I32MAX;
      int excl = min((t == am) ? m2 : m1, tail);
      cand = inr && !bit && inv < excl;
      op = inr ? tr[2] : 0;
      a1 = inr ? tr[3] : 0;
      a2 = inr ? tr[4] : 0;
    } else {
      int o = t - W;
      int oc = min(o, NO - 1);
      bool oin = o < nO;
      bool obit = (mOf[c - KD] >> lane) & 1u;
      int invo = oin ? invO[oc] : I32MAX;
      cand = oin && !obit && invo < mra;
      op = opO[oc];
      a1 = a1O[oc];
      a2 = a2O[oc];
    }
    cand = cand && vf;
    const u32 bal = __ballot_sync(FULL, cand);
    bool write;
    size_t outrow;
    if (SEL) {
      int k = cnt + __popc(bal & lane_lt_mask(lane));
      write = cand && k < B;
      outrow = (size_t)f * B + k;
      cnt += __popc(bal);
    } else {
      write = true;
      outrow = (size_t)f * C + t;
    }
    if (!write) continue;
    bool nv = cand && model_step(step, stf, S, op, a1, a2, prm, nullptr);
    nvalid[outrow] = nv ? 1 : 0;
    if (!nv) continue;
    // bit set, trailing ones across the words, multi-word right shift
    int s = 0;
    for (int k = 0; k < KD; ++k) {
      u32 x = new_word(mDf, KD, k, t, W);
      int t1 = (x == FULL) ? 32 : (__ffs(~x) - 1);
      s += t1;
      if (t1 != 32) break;
    }
    const int np = pf + s;
    const int sw = s >> 5, sb = s & 31;
    u32* out = rows + outrow * NC;
    out[0] = (u32)np;
    for (int k = 0; k < KD; ++k) {
      u32 lo = new_word(mDf, KD, k + sw, t, W);
      u32 hi = new_word(mDf, KD, k + sw + 1, t, W);
      out[1 + k] = (lo >> sb) | (sb ? (hi << (32 - sb)) : 0u);
    }
    model_step(step, stf, S, op, a1, a2, prm, out + 1 + KD);
    for (int k = 0; k < KO1; ++k) {
      u32 ow = 0u;
      if (KO > 0) {
        ow = mOf[k];
        int o = t - W;
        if (o >= 0 && (o >> 5) == k) ow |= 1u << (o & 31);
      }
      out[1 + KD + S + k] = ow;
    }
    n_ok += 1;
    acc = acc || (np >= nD);
  }
  if (SEL) {
    for (int k = min(cnt, B) + lane; k < B; k += 32) nvalid[(size_t)f * B + k] = 0;
  }
  for (int o = 16; o; o >>= 1) n_ok += __shfl_xor_sync(FULL, n_ok, o);
  bool any_acc = __any_sync(FULL, acc);
  if (lane == 0) {
    if (n_ok) atomicAdd(&ctl[CTL_NEXP], n_ok);
    if (any_acc) atomicOr(&ctl[CTL_ACCNOW], 1);
    if (SEL && cnt > B) atomicOr(&ctl[CTL_ROWOVF], 1);
  }
}

// ---------------------------------------------------------------------------
// K2 stage-1 compaction (reference lines 523-549) and group hash + fused
// key (lines 628-645). The per-block counts `blk` are [nb, gridDim.x], so
// the block prefix never crosses a member boundary.

__global__ void k_block_count(const unsigned char* nvalid, int M, int* blk, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  nvalid += (size_t)b * M;
  int i = blockIdx.x * 1024 + threadIdx.x;
  int c = __syncthreads_count(i < M && nvalid[i]);
  if (threadIdx.x == 0) blk[(size_t)b * gridDim.x + blockIdx.x] = c;
}

__global__ void k_compact(const u32* __restrict__ rows, const unsigned char* __restrict__ nvalid,
                          const int* __restrict__ blk_off, u32* __restrict__ crows,
                          int M, int NC, int P, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  rows += (size_t)b * M * NC;
  nvalid += (size_t)b * M;
  crows += (size_t)b * P * NC;
  int i = blockIdx.x * 1024 + threadIdx.x;
  int v = (i < M && nvalid[i]) ? 1 : 0;
  int rank = blk_off[(size_t)b * gridDim.x + blockIdx.x] + block_excl_sum(v, nullptr);
  if (v && rank < P) {
    const u32* src = rows + (size_t)i * NC;
    u32* dst = crows + (size_t)rank * NC;
    for (int c = 0; c < NC; ++c) dst[c] = src[c];
  }
}

// valid row i: nvalid[i] when nvalid != null, else i < min(ctl[NEXP], P).
__global__ void k_hash(const u32* __restrict__ drows, const unsigned char* __restrict__ nvalid,
                       u32* __restrict__ fkey, int L, int NC, int NID, int P, const int* ctl) {
  const int b = blockIdx.y;
  const int* c = member_ctl(ctl, b);
  if (stopped(c)) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  drows += (size_t)b * L * NC;
  fkey += (size_t)b * L;
  bool valid = nvalid ? (nvalid[(size_t)b * L + i] != 0) : (i < min(c[CTL_NEXP], P));
  const u32* r = drows + (size_t)i * NC;
  u32 gh = 2166136261u;
  for (int k = 0; k < NID; ++k) gh = (gh ^ r[k]) * 16777619u;
  fkey[i] = (gh >> 1) | (valid ? 0u : 0x80000000u);
}

// ---------------------------------------------------------------------------
// Sort-key gather: out[b][i] = src[b][idx[b][i] * stride + col].

__global__ void k_take_col(const u32* __restrict__ src, long src_member, int stride, int col,
                           const int* __restrict__ idx, u32* __restrict__ out, int n,
                           const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[(size_t)b * n + i] =
        src[(size_t)b * src_member + (size_t)idx[(size_t)b * n + i] * stride + col];
}

// ---------------------------------------------------------------------------
// K3 stable LSD radix sort of (u32 key, u32 value) pairs, 8-bit digits,
// segmented: each member's row of n pairs is sorted on its own (the
// member is the grid's y coordinate, not a key prefix, so no pass is
// added). Used for the dedup sort (reference lines 644-657, one pass per
// key from the last open-mask word to the fused key; stability makes it
// lexicographic) and the compaction sort (lines 725-740, stability is the
// iota tiebreak). Per pass: a per-warp-tile digit histogram
// ([nb, 256, tiles], digit-major per member), one exclusive scan of each
// member's histogram, and a stable scatter inside the member's segment in
// which each warp walks its tile in order and ranks equal digits with
// __match_any_sync.

__global__ void k_rs_hist(const u32* __restrict__ keys, int n, int shift, int* __restrict__ hist,
                          int NT, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  keys += (size_t)b * n;
  hist += (size_t)b * 256 * NT;
  __shared__ int h[RS_WARPS][256];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int tile = blockIdx.x * RS_WARPS + w;
  for (int d = lane; d < 256; d += 32) h[w][d] = 0;
  __syncwarp();
  if (tile < NT) {
    int base = tile * RS_TILE;
    for (int j = lane; j < RS_TILE; j += 32) {
      int i = base + j;
      if (i < n) atomicAdd(&h[w][(keys[i] >> shift) & 255u], 1);
    }
  }
  __syncwarp();
  if (tile < NT)
    for (int d = lane; d < 256; d += 32) hist[d * NT + tile] = h[w][d];
}

__global__ void k_rs_scatter(const u32* __restrict__ kin, const u32* __restrict__ vin,
                             u32* __restrict__ kout, u32* __restrict__ vout, int n, int shift,
                             const int* __restrict__ hist, int NT, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  kin += (size_t)b * n;
  vin += (size_t)b * n;
  kout += (size_t)b * n;
  vout += (size_t)b * n;
  hist += (size_t)b * 256 * NT;
  __shared__ int base[RS_WARPS][256];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int tile = blockIdx.x * RS_WARPS + w;
  if (tile >= NT) return;  // warp-uniform
  for (int d = lane; d < 256; d += 32) base[w][d] = hist[d * NT + tile];
  __syncwarp();
  int start = tile * RS_TILE;
  for (int j = 0; j < RS_TILE; j += 32) {
    int i = start + j + lane;
    if (start + j >= n) break;  // warp-uniform
    bool act = i < n;
    u32 k = act ? kin[i] : 0u;
    u32 d = act ? ((k >> shift) & 255u) : (256u + lane);
    u32 peers = __match_any_sync(FULL, d);
    int rank = __popc(peers & lane_lt_mask(lane));
    int dst = act ? base[w][d] + rank : 0;
    __syncwarp();
    if (act) {
      kout[dst] = k;
      vout[dst] = vin[i];
      if (rank == 0) base[w][d] += __popc(peers);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K4 prune (reference lines 657-736): over the dedup-sorted order, the
// same-group test on the real identity columns, the adjacent-subset rule,
// the group-head rule (each row's segment start found by a prefix max over
// the member's own block maxima), the keep count and the fused compaction
// priority.

#define PF_VALID 1
#define PF_SAME 2
#define PF_PSUB 4

__global__ void k_prune_a(const u32* __restrict__ drows, const u32* __restrict__ skey,
                          const int* __restrict__ perm, unsigned char* __restrict__ pflags,
                          int* __restrict__ blk, int L, int NC, int NID, int KO1, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  drows += (size_t)b * L * NC;
  skey += (size_t)b * L;
  perm += (size_t)b * L;
  pflags += (size_t)b * L;
  int i = blockIdx.x * 1024 + threadIdx.x;
  int st = -1;
  if (i < L) {
    bool sv = (skey[i] >> 31) == 0;
    bool same = false, psub = false;
    if (sv && i > 0 && (skey[i - 1] >> 31) == 0) {
      const u32* r = drows + (size_t)perm[i] * NC;
      const u32* q = drows + (size_t)perm[i - 1] * NC;
      same = true;
      for (int c = 0; c < NID; ++c) same = same && (r[c] == q[c]);
      if (same) {
        psub = true;
        for (int w = 0; w < KO1; ++w) psub = psub && ((q[NID + w] & ~r[NID + w]) == 0u);
      }
    }
    pflags[i] = (sv ? PF_VALID : 0) | (same ? PF_SAME : 0) | (psub ? PF_PSUB : 0);
    if (sv && !same) st = i;
  }
  int m;
  block_incl_max(st, &m);
  if (threadIdx.x == 0) blk[(size_t)b * gridDim.x + blockIdx.x] = m;
}

__global__ void k_prune_b(const u32* __restrict__ drows, const int* __restrict__ perm,
                          const unsigned char* __restrict__ pflags, const int* __restrict__ blk_pre,
                          int* ctl, u32* __restrict__ fprio, int L, int NC, int NID, int KO1,
                          int PB) {
  const int b = blockIdx.y;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  drows += (size_t)b * L * NC;
  perm += (size_t)b * L;
  pflags += (size_t)b * L;
  fprio += (size_t)b * L;
  int i = blockIdx.x * 1024 + threadIdx.x;
  unsigned char fl = (i < L) ? pflags[i] : 0;
  bool sv = fl & PF_VALID, same = fl & PF_SAME, psub = fl & PF_PSUB;
  bool is_start = sv && !same;
  int seg = block_incl_max(is_start ? i : -1, nullptr);
  seg = max(seg, blk_pre[(size_t)b * gridDim.x + blockIdx.x]);
  bool keep = false;
  if (i < L) {
    const u32* r = drows + (size_t)perm[i] * NC;
    bool head_sub = false;
    if (sv && !is_start && seg >= 0) {
      const u32* h = drows + (size_t)perm[seg] * NC;
      head_sub = true;
      for (int w = 0; w < KO1; ++w) head_sub = head_sub && ((h[NID + w] & ~r[NID + w]) == 0u);
    }
    keep = sv && !(same && psub) && !head_sub;
    int opc = 0;
    for (int w = 0; w < KO1; ++w) opc += __popc(r[NID + w]);
    u32 maxp = (PB >= 32) ? FULL : ((1u << PB) - 1u);
    fprio[i] = ((keep ? 0u : 1u) << (PB + 6)) | ((maxp - r[0]) << 6) | (u32)min(opc, 63);
  }
  int total;
  block_excl_sum(keep ? 1 : 0, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&ctl[CTL_COUNT], total);
}

// ---------------------------------------------------------------------------
// K5 top-F gather into the frontier (reference lines 741-811) and the loop
// carry update (lines 791-843), each member into its own frontier, control
// block and stats ring. In a frontier-sharded level (`mode` EX_ALLTOALL or
// EX_ALLGATHER) the members are the shards of one search, and the outcome
// comes from the replicated fields wgl_shard_reduce wrote (reference lines
// 697-711 and 743-757): alltoall keeps the first min(count_local, F) rows
// of the shard's own order, allgather the shard's slice [s*F, s*F + F) of
// the global order, valid below min(count, F*D); no stats row is written
// (the reference collects none when sharded).

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

// Rows shard s of D keeps: alltoall, its own owned rows; allgather, its
// slice of the global order of `count` kept rows.
__device__ __forceinline__ int shard_kept(int mode, int count_local, int count, int s, int F,
                                          int D) {
  if (mode == EX_ALLTOALL) return min(count_local, F);
  return max(0, min(min(count, F * D) - s * F, F));
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

__global__ void k_gather(const u32* __restrict__ drows, const int* __restrict__ perm,
                         const int* __restrict__ order, const int* ctl, int* __restrict__ p,
                         u32* __restrict__ mD, u32* __restrict__ mO, int* __restrict__ st,
                         unsigned char* __restrict__ valid, int F, int L, int NC, int KD, int S,
                         int KO1, int P2, int mode) {
  const int b = blockIdx.y;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  bool ovf_now, dead, stuck_now;
  int kept, off = 0;
  if (mode)
    sharded_outcome(ctl, b, F, gridDim.y, mode, &ovf_now, &dead, &stuck_now, &kept, &off);
  else
    level_outcome(ctl, F, P2, &ovf_now, &dead, &stuck_now, &kept);
  if (dead) return;  // lossless restore / dead end: keep the old frontier
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= F) return;
  drows += (size_t)b * L * NC;
  perm += (size_t)b * L;
  order += (size_t)b * L;
  p += (size_t)b * F;
  mD += (size_t)b * F * KD;
  mO += (size_t)b * F * KO1;
  st += (size_t)b * F * S;
  valid += (size_t)b * F;
  bool kv = k < kept;
  const u32* r = kv ? drows + (size_t)perm[order[off + k]] * NC : nullptr;
  p[k] = kv ? (int)r[0] : 0;
  for (int w = 0; w < KD; ++w) mD[(size_t)k * KD + w] = kv ? r[1 + w] : 0u;
  for (int i = 0; i < S; ++i) st[(size_t)k * S + i] = kv ? (int)r[1 + KD + i] : 0;
  for (int w = 0; w < KO1; ++w) mO[(size_t)k * KO1 + w] = kv ? r[1 + KD + S + w] : 0u;
  valid[k] = kv ? 1 : 0;
}

__global__ void k_finalize(int* ctl, int* stats, int F, int P2, int n_stat_rows, int mode) {
  const int b = blockIdx.x;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  bool ovf_now, dead, stuck_now;
  int kept, off, fm, nonempty;
  int lvl = ctl[CTL_LVL];
  if (mode) {
    sharded_outcome(ctl, b, F, gridDim.x, mode, &ovf_now, &dead, &stuck_now, &kept, &off);
    fm = min(ctl[CTL_GCOUNT], F * (int)gridDim.x);
    nonempty = ctl[CTL_NSUM] > 0;  // every shard's, as the reduce saw them
  } else {
    level_outcome(ctl, F, P2, &ovf_now, &dead, &stuck_now, &kept);
    fm = kept;
    nonempty = (dead ? ctl[CTL_FCOUNT] : kept) > 0;
    stats += (size_t)b * n_stat_rows * 4;
    int* row = stats + ((lvl + 1) % n_stat_rows) * 4;
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

// ---------------------------------------------------------------------------
// Frontier-sharded level: owner routing, exchange and cross-shard reduce.
// Replaces the reference's sharded program, jepsen_tpu/parallel/frontier.py
// `_sharded_kernel` (line 72), i.e. the `axis_name` arms of ops/wgl.py
// `_build_kernel` (lines 490-493, 525-630, 697-757, 830-836, 877-890). The
// D shards of a mesh are the members of one batch on one device, so each
// collective becomes a kernel: `all_to_all`/`all_gather` a row copy between
// the shards' buffers (k_exchange), `pmax`/`psum`/`pmin` a pass over the D
// control blocks (k_shard_reduce). Shards run in one launch as blocks that
// cannot wait for each other, so a reduction sits at a launch boundary
// after the stage that wrote its inputs: one reduce a level, after the
// prune, computes everything the rest of the level needs (acc_now,
// pre_ovf, the global and per-shard counts, the next frontier sizes and
// hence the global nonempty of the stop test). What bounds these kernels:
// bytes (k_route and k_exchange copy each candidate row once) and, at
// the main path's sizes, launch latency; each is one pass and one launch.

// Owner routing (reference lines 551-598), one block per shard over its P
// stage-1 survivors in position order: owner = FNV(p, window mask, state)
// mod D (unsigned), a stable partition by owner into fixed buckets of PBK
// rows (send[d * PBK + j], j the row's rank among its owner's rows), the
// bucket-overflow flag when an owner gets more than PBK rows, and empty
// slots zeroed. Ranks: per chunk of 1024 rows, __match_any_sync inside a
// warp and per-warp counts in shared memory across warps, added to the
// rows routed by earlier chunks.
__global__ void k_route(const u32* __restrict__ crows, int* ctl, u32* __restrict__ send,
                        unsigned char* __restrict__ svalid, int P, int NC, int NID, int D,
                        int PBK) {
  const int b = blockIdx.x;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  crows += (size_t)b * P * NC;
  send += (size_t)b * D * PBK * NC;
  svalid += (size_t)b * D * PBK;
  __shared__ int base[MAX_SHARDS];
  __shared__ int wc[32 * MAX_SHARDS];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < D; d += blockDim.x) base[d] = 0;
  const int n = min(ctl[CTL_NEXP], P);
  for (int c0 = 0; c0 < P; c0 += blockDim.x) {  // uniform across the block
    for (int k = threadIdx.x; k < 32 * D; k += blockDim.x) wc[(k / D) * MAX_SHARDS + k % D] = 0;
    __syncthreads();
    int i = c0 + threadIdx.x;
    int o = D;  // not routed
    if (i < n) {
      const u32* r = crows + (size_t)i * NC;
      u32 gh = 2166136261u;
      for (int k = 0; k < NID; ++k) gh = (gh ^ r[k]) * 16777619u;
      o = (int)(gh % (u32)D);
    }
    u32 peers = __match_any_sync(FULL, (u32)o);
    int rank = __popc(peers & lane_lt_mask(lane));
    if (o < D && rank == 0) wc[w * MAX_SHARDS + o] = __popc(peers);
    __syncthreads();
    if (o < D) {
      int j = base[o] + rank;
      for (int v = 0; v < w; ++v) j += wc[v * MAX_SHARDS + o];
      if (j < PBK) {
        const u32* r = crows + (size_t)i * NC;
        u32* dst = send + ((size_t)o * PBK + j) * NC;
        for (int k = 0; k < NC; ++k) dst[k] = r[k];
        svalid[(size_t)o * PBK + j] = 1;
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      int t = 0;
      for (int v = 0; v < 32; ++v) t += wc[v * MAX_SHARDS + d];
      base[d] += t;
    }
    __syncthreads();
  }
  for (int slot = threadIdx.x; slot < D * PBK; slot += blockDim.x) {
    if (slot % PBK >= base[slot / PBK]) {
      svalid[slot] = 0;
      for (int k = 0; k < NC; ++k) send[(size_t)slot * NC + k] = 0u;
    }
  }
  if (threadIdx.x == 0) {
    bool over = false;
    for (int d = 0; d < D; ++d) over = over || base[d] > PBK;
    if (over) ctl[CTL_ROWOVF] = 1;
  }
}

// The exchange (reference lines 592-611), a thread per received row of
// each destination shard d: recv[d][s * Bk + j] = send[s][d * dst_stride
// + j] for source shard s, with dst_stride = PBK = Bk (tiled all_to_all)
// or 0 and Bk = P (tiled all_gather). Received rows are in source order,
// as the tiled collectives give them. Validity: svalid, or (all_gather
// of the stage-1 rows) j < min(n_cand of s, P); invalid rows are written
// as zeros, so the received buffers are the same on every run.
__global__ void k_exchange(const u32* __restrict__ send, const unsigned char* __restrict__ svalid,
                           const int* ctl, u32* __restrict__ recv,
                           unsigned char* __restrict__ rvalid, int SR, int Bk, int dst_stride,
                           int NC, int P) {
  const int d = blockIdx.y;
  if (stopped(member_ctl(ctl, d))) return;
  const int L = gridDim.y * Bk;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= L) return;
  int s = r / Bk, j = r - s * Bk;
  size_t src = (size_t)s * SR + (size_t)d * dst_stride + j;
  bool v = svalid ? svalid[src] != 0 : j < min(ctl[(size_t)s * CTL_SIZE + CTL_NEXP], P);
  const u32* a = send + src * NC;
  u32* o = recv + ((size_t)d * L + r) * NC;
  for (int k = 0; k < NC; ++k) o[k] = v ? a[k] : 0u;
  rvalid[(size_t)d * L + r] = v ? 1 : 0;
}

// The cross-shard reductions over the D control blocks, one thread (D is
// a mesh's shard count). stage 0, at a chunk's start (reference lines
// 830-836): the global nonempty and the stop test. stage 1, after the
// prune: acc_now (pmax, line 490), pre_ovf (pmax, line 612), the keep
// count (psum under alltoall, line 697; already replicated under
// allgather) and its overflow, and the frontier count each shard will
// hold after the level (the finalize's stop test reads their sum, the
// chunk's flags their sum, max and min: lines 877-890). The results go
// to every shard's block.
__global__ void k_shard_reduce(int* ctl, int D, int F, int P, int mode, int stage) {
  if (threadIdx.x != 0) return;
  int sum = 0, mx = 0, mn = I32MAX;
  if (stage == 0) {
    for (int s = 0; s < D; ++s) {
      int f = ctl[(size_t)s * CTL_SIZE + CTL_FCOUNT];
      sum += f;
      mx = max(mx, f);
      mn = min(mn, f);
    }
    bool go = !ctl[CTL_ACC] && (ctl[CTL_LOSSY] || !ctl[CTL_OVF]) && !ctl[CTL_STUCK] && sum > 0 &&
              ctl[CTL_LVL] < ctl[CTL_MAXLVL];
    for (int s = 0; s < D; ++s) {
      int* c = ctl + (size_t)s * CTL_SIZE;
      c[CTL_NSUM] = sum;
      c[CTL_NMAX] = mx;
      c[CTL_NMIN] = mn;
      c[CTL_GO] = go ? 1 : 0;
    }
    return;
  }
  if (stopped(ctl)) return;  // every shard's go is the same
  int acc = 0, pre = 0, csum = 0, cbig = 0;
  for (int s = 0; s < D; ++s) {
    const int* c = ctl + (size_t)s * CTL_SIZE;
    acc |= c[CTL_ACCNOW] != 0;
    pre |= c[CTL_ROWOVF] != 0 || c[CTL_NEXP] > P;
    csum += c[CTL_COUNT];
    cbig |= c[CTL_COUNT] > F;
  }
  int count = (mode == EX_ALLTOALL) ? csum : ctl[CTL_COUNT];
  bool ovf_now = pre || ((mode == EX_ALLTOALL) ? cbig != 0 : count > F * D);
  bool dead = (ovf_now && !ctl[CTL_LOSSY]) || count == 0;
  for (int s = 0; s < D; ++s) {
    const int* c = ctl + (size_t)s * CTL_SIZE;
    int f = dead ? c[CTL_FCOUNT] : shard_kept(mode, c[CTL_COUNT], count, s, F, D);
    sum += f;
    mx = max(mx, f);
    mn = min(mn, f);
  }
  for (int s = 0; s < D; ++s) {
    int* c = ctl + (size_t)s * CTL_SIZE;
    c[CTL_ACCNOW] = acc;
    c[CTL_GCOUNT] = count;
    c[CTL_GOVF] = ovf_now ? 1 : 0;
    c[CTL_NSUM] = sum;
    c[CTL_NMAX] = mx;
    c[CTL_NMIN] = mn;
  }
}

// ---------------------------------------------------------------------------
// Re-batch of stacked frontiers. Replaces the reference's
// jepsen_tpu/parallel/batch.py `_regroup_program` (line 95) and, with one
// member and idx = [0], the single-history frontier grow
// jepsen_tpu/ops/wgl.py `_pad_program` (line 1074):
// dst[j, f, c] = src[idx[j], f, c] for f < F_old, else 0, for each of the
// five frontier arrays. One pass per array, a thread per output element;
// an index may repeat (one member regrouped twice). Bound by bytes: each
// selected row is read once and each output element written once.

template <typename T>
__global__ void k_regroup(const T* __restrict__ src, T* __restrict__ dst,
                          const int* __restrict__ idx, long n_out, int F_old, int F_new,
                          int R) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  long row = (long)F_new * R;
  int j = (int)(i / row);
  long rem = i - (long)j * row;
  int f = (int)(rem / R);
  int c = (int)(rem - (long)f * R);
  dst[i] = f < F_old ? src[((long)idx[j] * F_old + f) * R + c] : (T)0;
}

template <typename T>
static void regroup_launch(const void* src, void* dst, const int* idx, int n_new, int F_old,
                           int F_new, int R, cudaStream_t s) {
  long n_out = (long)n_new * F_new * R;
  if (n_out == 0) return;
  const int threads = 256;
  long blocks = (n_out + threads - 1) / threads;
  k_regroup<T><<<(unsigned)blocks, threads, 0, s>>>((const T*)src, (T*)dst, idx, n_out, F_old,
                                                    F_new, R);
}

// ---------------------------------------------------------------------------
// C entry points (ctypes). Pointers and the stream arrive as void*; `nb` is
// the number of members, each buffer [nb, ...] contiguous.

static inline int nblk(long n, int per) { return (int)((n + per - 1) / per); }

extern "C" {

const char* wgl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int wgl_chunk_init(void* ctl, void* valid, int F, int nb, void* stream) {
  k_chunk_init<<<nb, 1024, 0, (cudaStream_t)stream>>>((int*)ctl, (const unsigned char*)valid, F);
  return (int)cudaGetLastError();
}

int wgl_expand(void* tabD, void* sufret, void* invO, void* opO, void* a1O, void* a2O,
               void* p, void* mD, void* mO, void* st, void* valid, void* ctl, void* rows,
               void* nvalid, int F, int W, int KO, int ND, int NO, int B, int S, int step,
               int prm, int nb, void* stream) {
  const int threads = 128;  // 4 configurations per block
  dim3 grid(nblk((long)F * 32, threads), nb);
  k_expand<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tabD, (const int*)sufret, (const int*)invO, (const int*)opO,
      (const int*)a1O, (const int*)a2O, (const int*)p, (const u32*)mD, (const u32*)mO,
      (const int*)st, (const unsigned char*)valid, (int*)ctl, (u32*)rows,
      (unsigned char*)nvalid, F, W, KO, ND, NO, B, S, step, prm);
  return (int)cudaGetLastError();
}

// P > 0: two-stage (compact the valid rows of `rows` into `drows`, then
// hash P rows, unless `fkey` is null); P == 0: hash the M rows of `rows`
// (== drows) in place, validity from `nvalid`.
// `blk` is scratch of nb * ceil(M / 1024) ints.
int wgl_stage1_hash(void* rows, void* nvalid, void* ctl, void* drows, void* fkey, void* blk_,
                    int M, int NC, int NID, int P, int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* c = (int*)ctl;
  if (P > 0) {
    int nbk = nblk(M, 1024);
    int* blk = (int*)blk_;
    k_block_count<<<dim3(nbk, nb), 1024, 0, s>>>((const unsigned char*)nvalid, M, blk, c);
    k_scan_excl_sum<<<nb, 1024, 0, s>>>(blk, nbk, c);
    k_compact<<<dim3(nbk, nb), 1024, 0, s>>>((const u32*)rows, (const unsigned char*)nvalid,
                                            blk, (u32*)drows, M, NC, P, c);
    if (fkey)  // a sharded level hashes the exchanged rows instead
      k_hash<<<dim3(nblk(P, 256), nb), 256, 0, s>>>((const u32*)drows, nullptr, (u32*)fkey, P,
                                                    NC, NID, P, c);
  } else {
    k_hash<<<dim3(nblk(M, 256), nb), 256, 0, s>>>((const u32*)rows,
                                                  (const unsigned char*)nvalid, (u32*)fkey, M,
                                                  NC, NID, 0, c);
  }
  return (int)cudaGetLastError();
}

int wgl_take_col(void* src, long src_member, int stride, int col, void* idx, void* out, int n,
                 int nb, void* ctl, void* stream) {
  k_take_col<<<dim3(nblk(n, 256), nb), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)src, src_member, stride, col, (const int*)idx, (u32*)out, n, (const int*)ctl);
  return (int)cudaGetLastError();
}

// keys/vals [nb, n]; tmp_k/tmp_v [nb, n] each; hist [nb, 256 * ceil(n / RS_TILE)].
int radix_sort_pairs(void* keys, void* vals, void* tmp_k, void* tmp_v, void* hist, int n, int nb,
                     void* ctl, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)ctl;
  int NT = nblk(n, RS_TILE);
  dim3 grid(nblk(NT, RS_WARPS), nb);
  u32* ka = (u32*)keys;
  u32* va = (u32*)vals;
  u32* kb = (u32*)tmp_k;
  u32* vb = (u32*)tmp_v;
  for (int pass = 0; pass < 4; ++pass) {
    int shift = 8 * pass;
    k_rs_hist<<<grid, 32 * RS_WARPS, 0, s>>>(ka, n, shift, (int*)hist, NT, c);
    k_scan_excl_sum<<<nb, 1024, 0, s>>>((int*)hist, 256 * NT, c);
    k_rs_scatter<<<grid, 32 * RS_WARPS, 0, s>>>(ka, va, kb, vb, n, shift, (const int*)hist, NT,
                                               c);
    u32* t = ka; ka = kb; kb = t;
    t = va; va = vb; vb = t;
  }
  return (int)cudaGetLastError();  // four passes: the result is back in keys/vals
}

int wgl_prune(void* drows, void* skey, void* perm, void* ctl, void* fprio, void* pflags,
              void* blk, int L, int NC, int NID, int KO1, int PB, int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nbk = nblk(L, 1024);
  k_prune_a<<<dim3(nbk, nb), 1024, 0, s>>>((const u32*)drows, (const u32*)skey,
                                          (const int*)perm, (unsigned char*)pflags, (int*)blk,
                                          L, NC, NID, KO1, (const int*)ctl);
  k_scan_excl_max<<<nb, 1024, 0, s>>>((int*)blk, nbk, (const int*)ctl);
  k_prune_b<<<dim3(nbk, nb), 1024, 0, s>>>((const u32*)drows, (const int*)perm,
                                          (const unsigned char*)pflags, (const int*)blk,
                                          (int*)ctl, (u32*)fprio, L, NC, NID, KO1, PB);
  return (int)cudaGetLastError();
}

// mode: 0, or EX_ALLTOALL / EX_ALLGATHER for the nb shards of one sharded
// search (stats may then be null).
int wgl_gather_finalize(void* drows, void* perm, void* order, void* ctl, void* stats, void* p,
                        void* mD, void* mO, void* st, void* valid, int F, int L, int NC, int KD,
                        int S, int KO1, int P2, int n_stat_rows, int mode, int nb,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  k_gather<<<dim3(nblk(F, 256), nb), 256, 0, s>>>(
      (const u32*)drows, (const int*)perm, (const int*)order, (const int*)ctl, (int*)p,
      (u32*)mD, (u32*)mO, (int*)st, (unsigned char*)valid, F, L, NC, KD, S, KO1, P2, mode);
  k_finalize<<<nb, 1, 0, s>>>((int*)ctl, (int*)stats, F, P2, n_stat_rows, mode);
  return (int)cudaGetLastError();
}

// crows [D, P, NC] stage-1 rows; send [D, D * PBK, NC]; svalid [D, D * PBK].
int wgl_route(void* crows, void* ctl, void* send, void* svalid, int P, int NC, int NID, int D,
              int PBK, void* stream) {
  if (D < 1 || D > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  k_route<<<D, 1024, 0, (cudaStream_t)stream>>>((const u32*)crows, (int*)ctl, (u32*)send,
                                                (unsigned char*)svalid, P, NC, NID, D, PBK);
  return (int)cudaGetLastError();
}

// send [D, SR, NC] (svalid [D, SR] or null: validity from each source's
// n_cand and P); recv [D, D * Bk, NC], rvalid [D, D * Bk].
int wgl_exchange(void* send, void* svalid, void* ctl, void* recv, void* rvalid, int SR, int Bk,
                 int dst_stride, int NC, int P, int D, void* stream) {
  long L = (long)D * Bk;
  k_exchange<<<dim3(nblk(L, 256), D), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)send, (const unsigned char*)svalid, (const int*)ctl, (u32*)recv,
      (unsigned char*)rvalid, SR, Bk, dst_stride, NC, P);
  return (int)cudaGetLastError();
}

int wgl_shard_reduce(void* ctl, int D, int F, int P, int mode, int stage, void* stream) {
  k_shard_reduce<<<1, 32, 0, (cudaStream_t)stream>>>((int*)ctl, D, F, P, mode, stage);
  return (int)cudaGetLastError();
}

// Five arrays: p [nb, F] i32, mD [nb, F, KD] u32, mO [nb, F, KO1] u32,
// st [nb, F, S] i32, valid [nb, F] u8; idx [n_new] i32 on the device.
int wgl_regroup(void* p, void* mD, void* mO, void* st, void* valid, void* p2, void* mD2,
                void* mO2, void* st2, void* valid2, void* idx, int n_new, int F_old, int F_new,
                int KD, int KO1, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  regroup_launch<uint32_t>(p, p2, ix, n_new, F_old, F_new, 1, s);
  regroup_launch<uint32_t>(mD, mD2, ix, n_new, F_old, F_new, KD, s);
  regroup_launch<uint32_t>(mO, mO2, ix, n_new, F_old, F_new, KO1, s);
  regroup_launch<uint32_t>(st, st2, ix, n_new, F_old, F_new, S, s);
  regroup_launch<uint8_t>(valid, valid2, ix, n_new, F_old, F_new, 1, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
