// Timing yardsticks: the parent designs that the port's kernels replaced,
// built only by chip_smoke.py (its gather_sort_scale, sharded_kernels and
// exchange_scale phases time them beside their replacements on the same
// inputs, each against the plain version). They are not part of the
// port's kernel library and nothing in the port launches them:
//
// - a take-col launch before each sort (out[b][i] = src[b][idx[b][i] *
//   stride + col]);
// - a gather of three dependent loads a row (order, then perm, then the
//   row) with stores strided by each field's width, followed by a finalize
//   launch of one thread a member;
// - the sharded level's owner routing into send buckets (one 1024-thread
//   block a shard, ranks by __match_any_sync), then the alltoall exchange
//   of the buckets into the receive rows: two launches where wgl_route is
//   one;
// - the allgather's exchange without the keys (the same block copies'
//   allgather arm), whose received rows the hash below then keys;
// - the cross-shard reduce on one thread in a launch of its own, after the
//   prune (stage 1) or the chunk start (stage 0): the parent's sharded
//   prune is the single level's (wgl_prune with mode 0) and then this;
// - the fused-key hash in a launch of its own, one thread a row (NID
//   words a row, strided by NC), validity from a byte a row: a
//   single-stage level's rows after the expand, a sharded level's
//   received rows after the route or the exchange (the kernels that write
//   those rows now write their keys);
// - the re-batch of stacked frontiers as five launches, one an array, a
//   thread an output element (two 64-bit divisions each);
// - the chunk start's count and stop test (one 1024-thread block a member,
//   a byte a load; with a ticket word its last block runs the chunk-start
//   reduce) over control blocks the host copied to the card and stats
//   rings a memset zeroed first (chip_smoke.py times that whole start:
//   the host's copy, the memset, this launch and the host's read before
//   the first level).
//
// The control-block layout and the level's outcome and finalize are the
// library's own, so the source includes it whole; this file's shared
// library is separate from the port's, and its extern "C" names are its
// own.

#include "../jepsen_tpu_torch/csrc/wgl_level.cu"

__global__ void k_yard_take_col(const u32* __restrict__ src, long src_member, int stride, int col,
                                const int* __restrict__ idx, u32* __restrict__ out, int n,
                                const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[(size_t)b * n + i] =
        src[(size_t)b * src_member + (size_t)idx[(size_t)b * n + i] * stride + col];
}

__global__ void k_yard_gather(const u32* __restrict__ drows, const int* __restrict__ perm,
                              const int* __restrict__ order, const int* ctl, int* __restrict__ p,
                              u32* __restrict__ mD, u32* __restrict__ mO, int* __restrict__ st,
                              unsigned char* __restrict__ valid, int F, int L, int NC, int KD,
                              int S, int KO1, int P2, int mode) {
  const int b = blockIdx.y;
  ctl += (size_t)b * CTL_SIZE;
  if (stopped(ctl)) return;
  bool ovf_now, dead, stuck_now;
  int kept, off = 0;
  if (mode)
    sharded_outcome(ctl, b, F, gridDim.y, mode, &ovf_now, &dead, &stuck_now, &kept, &off);
  else
    level_outcome(ctl, F, P2, &ovf_now, &dead, &stuck_now, &kept);
  if (dead) return;
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

__global__ void k_yard_finalize(int* ctl, int* stats, int F, int P2, int n_stat_rows, int mode) {
  const int b = blockIdx.x;
  int* c = ctl + (size_t)b * CTL_SIZE;
  if (stopped(c)) return;
  finalize_member(c, stats, b, gridDim.x, F, P2, n_stat_rows, mode);
}

// The parent's owner routing (reference lines 551-598), one block per shard
// over its P stage-1 survivors in position order: owner = FNV(p, window
// mask, state) mod D (unsigned), a stable partition by owner into fixed
// buckets of PBK rows (send[d * PBK + j], j the row's rank among its
// owner's rows), the bucket-overflow flag when an owner gets more than PBK
// rows, and empty slots zeroed. Ranks: per chunk of 1024 rows,
// __match_any_sync inside a warp and per-warp counts in shared memory
// across warps, added to the rows routed by earlier chunks.
__global__ void k_yard_route(const u32* __restrict__ crows, int* ctl, u32* __restrict__ send,
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


// The parent's exchange (reference lines 592-611), both arms: recv[d][s *
// Bk + j] = send[s][d * dst_stride + j], validity svalid (the alltoall's
// buckets) or j < min(n_cand of s, P) (svalid null, the allgather).

// Whether word w of the run is a valid row's: its row's svalid byte, or
// (svalid null) w below the all_gather's valid prefix of vw words.
__device__ __forceinline__ bool ex_valid(const unsigned char* sv, int vw, int w, int NC) {
  return sv ? sv[w / NC] != 0 : w < vw;
}

__device__ __forceinline__ bool ld_flag_now(const unsigned char* p) {
  u32 v;
  asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v != 0;
}

__global__ void __launch_bounds__(EX_THREADS)
k_yard_exchange(const u32* __restrict__ send, const unsigned char* __restrict__ svalid,
           const int* ctl, u32* __restrict__ recv, unsigned char* __restrict__ rvalid, int SR,
           int Bk, int dst_stride, int NC, int P) {
  const int s = blockIdx.y, d = blockIdx.z;
  const int RW = Bk * NC;  // words of the run
  const int c0 = blockIdx.x * EX_WORDS;
  if (c0 >= RW) return;
  const int c1 = min(RW, c0 + EX_WORDS);
  const size_t srow = (size_t)s * SR + (size_t)d * dst_stride;
  const size_t drow = ((size_t)d * gridDim.y + s) * Bk;
  const u32* a = send + srow * NC;
  u32* o = recv + drow * NC;
  const unsigned char* sv = svalid ? svalid + srow : nullptr;
  // The destination's 16-byte groups inside [c0, c1), a scalar head and tail.
  const int g0 = min(c1, c0 + (int)((4 - (((uintptr_t)(o + c0) >> 2) & 3)) & 3));
  const int ng = (c1 - g0) >> 2;
  const int g1 = g0 + 4 * ng;
  const int t = threadIdx.x;
  const int w = g0 + 4 * t;
  // The loads go out together: the stop test and the source's n_cand do
  // not hold up the row's (a stopped destination's are just not stored).
  const bool stop = ctl != nullptr && ld_now(ctl + (size_t)d * CTL_SIZE + CTL_GO) == 0;
  const int ncand = sv ? 0 : ld_now(ctl + (size_t)s * CTL_SIZE + CTL_NEXP);
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  // The group's words lie in row r (from word e of it) and, past its end,
  // row r + 1 (NC >= 3: four words span at most two rows); their validity.
  const int r = w / NC, e = w - r * NC;
  bool v0 = true, v1 = true;
  if (t < ng) {
    if ((((uintptr_t)(a + g0)) & 15) == 0) {
      x = ld_v4_now(a + w);
    } else {
      x.x = a[w];
      x.y = a[w + 1];
      x.z = a[w + 2];
      x.w = a[w + 3];
    }
    if (sv) {
      v0 = ld_flag_now(sv + r);
      if (e + 3 >= NC) v1 = ld_flag_now(sv + r + 1);
    }
  }
  if (stop) return;
  const int vw = sv ? 0 : max(0, min(ncand, P)) * NC;
  if (t < g0 - c0) o[c0 + t] = ex_valid(sv, vw, c0 + t, NC) ? a[c0 + t] : 0u;
  if (t < c1 - g1) o[g1 + t] = ex_valid(sv, vw, g1 + t, NC) ? a[g1 + t] : 0u;
  if (t < ng) {
    if (!sv) {
      v0 = w < vw;  // the valid prefix ends on a row boundary
      v1 = w + 3 < vw;
    }
    x.x = (e < NC ? v0 : v1) ? x.x : 0u;
    x.y = (e + 1 < NC ? v0 : v1) ? x.y : 0u;
    x.z = (e + 2 < NC ? v0 : v1) ? x.z : 0u;
    x.w = (e + 3 < NC ? v0 : v1) ? x.w : 0u;
    *reinterpret_cast<uint4*>(o + w) = x;
  }
  // The validity bytes of the rows whose first word is in [c0, c1).
  for (int r = (c0 + NC - 1) / NC + t; r * NC < c1; r += EX_THREADS)
    rvalid[drow + r] = ex_valid(sv, vw, r * NC, NC) ? 1 : 0;
}


// The parent's cross-shard reduce, one thread: stage 0 at a chunk's start
// (reference lines 830-836), stage 1 after the prune (lines 490, 612,
// 697-711, 877-890); the results go to every shard's block.
__global__ void k_yard_shard_reduce(int* ctl, int D, int F, int P, int mode, int stage) {
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

__global__ void k_yard_hash(const u32* __restrict__ drows, const unsigned char* __restrict__ nvalid,
                            u32* __restrict__ fkey, int L, int NC, int NID, const int* ctl) {
  const int b = blockIdx.y;
  if (stopped(member_ctl(ctl, b))) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const size_t r = (size_t)b * L + i;
  fkey[r] = (fnv_row(drows + r * NC, NID) >> 1) | (nvalid[r] ? 0u : KEY_INVALID);
}

template <typename T>
__global__ void k_yard_regroup(const T* __restrict__ src, T* __restrict__ dst,
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
static void yard_regroup_launch(const void* src, void* dst, const int* idx, int n_new, int F_old,
                                int F_new, int R, cudaStream_t s) {
  long n_out = (long)n_new * F_new * R;
  if (n_out == 0) return;
  const int threads = 256;
  long blocks = (n_out + threads - 1) / threads;
  k_yard_regroup<T><<<(unsigned)blocks, threads, 0, s>>>((const T*)src, (T*)dst, idx, n_out,
                                                         F_old, F_new, R);
}

__global__ void k_yard_chunk_init(int* ctl, const unsigned char* valid, int F, u32* ticket) {
  const int b = blockIdx.x;
  int* c = ctl + (size_t)b * CTL_SIZE;
  valid += (size_t)b * F;
  int n = 0;
  for (int i = threadIdx.x; i < F; i += blockDim.x) n += valid[i] ? 1 : 0;
  int total;
  block_excl_sum(n, &total);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    c[CTL_FCOUNT] = total;
    bool go = !c[CTL_ACC] && (c[CTL_LOSSY] || !c[CTL_OVF]) && !c[CTL_STUCK] &&
              total > 0 && c[CTL_LVL] < c[CTL_MAXLVL];
    c[CTL_GO] = go ? 1 : 0;
    if (ticket) s_last = ticket_acq_rel(ticket) == gridDim.x - 1;
  }
  if (ticket == nullptr) return;
  __syncthreads();
  if (s_last && threadIdx.x < 32) {
    if (threadIdx.x == 0) *ticket = 0u;
    chunk_reduce(ctl, gridDim.x);
  }
}

extern "C" {

// The parent's chunk start on the card: the count and stop test
// over control blocks already copied in; with ticket (one zero word, left
// zero) the last block runs the chunk-start reduce.
int yardstick_chunk_init(void* ctl, void* valid, void* ticket, int F, int nb, void* stream) {
  k_yard_chunk_init<<<nb, 1024, 0, (cudaStream_t)stream>>>(
      (int*)ctl, (const unsigned char*)valid, F, (u32*)ticket);
  return (int)cudaGetLastError();
}

int yardstick_take_col(void* src, long src_member, int stride, int col, void* idx, void* out,
                       int n, int nb, void* ctl, void* stream) {
  k_yard_take_col<<<dim3(nblk(n, 256), nb), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)src, src_member, stride, col, (const int*)idx, (u32*)out, n, (const int*)ctl);
  return (int)cudaGetLastError();
}

int yardstick_gather_finalize(void* drows, void* perm, void* order, void* ctl, void* stats,
                              void* p, void* mD, void* mO, void* st, void* valid, int F, int L,
                              int NC, int KD, int S, int KO1, int P2, int n_stat_rows, int mode,
                              int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  k_yard_gather<<<dim3(nblk(F, 256), nb), 256, 0, s>>>(
      (const u32*)drows, (const int*)perm, (const int*)order, (const int*)ctl, (int*)p,
      (u32*)mD, (u32*)mO, (int*)st, (unsigned char*)valid, F, L, NC, KD, S, KO1, P2, mode);
  k_yard_finalize<<<nb, 1, 0, s>>>((int*)ctl, (int*)stats, F, P2, n_stat_rows, mode);
  return (int)cudaGetLastError();
}

// The parent's alltoall route and exchange: crows [D, P, NC]; send [D, D *
// PBK, NC], svalid [D, D * PBK]; recv [D, D * PBK, NC], rvalid [D, D * PBK].
int yardstick_route_exchange(void* crows, void* ctl, void* send, void* svalid, void* recv,
                             void* rvalid, int P, int NC, int NID, int D, int PBK,
                             void* stream) {
  if (D < 1 || D > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  k_yard_route<<<D, 1024, 0, s>>>((const u32*)crows, (int*)ctl, (u32*)send,
                                  (unsigned char*)svalid, P, NC, NID, D, PBK);
  k_yard_exchange<<<dim3(nblk((long)PBK * NC, EX_WORDS), D, D), EX_THREADS, 0, s>>>(
      (const u32*)send, (const unsigned char*)svalid, (const int*)ctl, (u32*)recv,
      (unsigned char*)rvalid, D * PBK, PBK, PBK, NC, P);
  return (int)cudaGetLastError();
}

// The parent's allgather exchange, rows only: send [D, P, NC] the stage-1
// rows, valid below each source's n_cand and P; recv [D, D * P, NC],
// rvalid [D, D * P].
int yardstick_gather(void* send, void* ctl, void* recv, void* rvalid, int P, int NC, int D,
                     void* stream) {
  if (D < 1 || D > MAX_SHARDS || P <= 0) return (int)cudaErrorInvalidValue;
  k_yard_exchange<<<dim3(nblk((long)P * NC, EX_WORDS), D, D), EX_THREADS, 0,
                    (cudaStream_t)stream>>>((const u32*)send, nullptr, (const int*)ctl,
                                            (u32*)recv, (unsigned char*)rvalid, P, P, 0, NC, P);
  return (int)cudaGetLastError();
}

// The parent's sharded prune: the single level's prune, then the reduce.
int yardstick_prune_reduce(void* drows, void* skey, void* perm, void* ctl, void* fprio,
                           void* state, int L, int NC, int NID, int KO1, int PB, int F, int P,
                           int mode, int nb, int tile, void* stream) {
  const int rc = wgl_prune(drows, skey, perm, ctl, fprio, state, L, NC, NID, KO1, PB, F, P, 0,
                           nb, tile, stream);
  if (rc) return rc;
  k_yard_shard_reduce<<<1, 32, 0, (cudaStream_t)stream>>>((int*)ctl, nb, F, P, mode, 1);
  return (int)cudaGetLastError();
}

// The earlier sharded chunk start: the chunk init, then the reduce.
int yardstick_chunk_init_reduce(void* ctl, void* valid, int F, int nb, void* stream) {
  const int rc = yardstick_chunk_init(ctl, valid, nullptr, F, nb, stream);
  if (rc) return rc;
  k_yard_shard_reduce<<<1, 32, 0, (cudaStream_t)stream>>>((int*)ctl, nb, F, 0, 0, 0);
  return (int)cudaGetLastError();
}

// The parent's hash of a level's rows: drows [nb, L, NC], nvalid [nb, L],
// fkey [nb, L].
int yardstick_hash(void* drows, void* nvalid, void* ctl, void* fkey, int L, int NC, int NID,
                   int nb, void* stream) {
  k_yard_hash<<<dim3(nblk(L, 256), nb), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)drows, (const unsigned char*)nvalid, (u32*)fkey, L, NC, NID, (const int*)ctl);
  return (int)cudaGetLastError();
}

// The parent's re-batch: wgl_regroup's arguments, five launches.
int yardstick_regroup(void* p, void* mD, void* mO, void* st, void* valid, void* p2, void* mD2,
                      void* mO2, void* st2, void* valid2, void* idx, int n_new, int F_old,
                      int F_new, int KD, int KO1, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  yard_regroup_launch<uint32_t>(p, p2, ix, n_new, F_old, F_new, 1, s);
  yard_regroup_launch<uint32_t>(mD, mD2, ix, n_new, F_old, F_new, KD, s);
  yard_regroup_launch<uint32_t>(mO, mO2, ix, n_new, F_old, F_new, KO1, s);
  yard_regroup_launch<uint32_t>(st, st2, ix, n_new, F_old, F_new, S, s);
  yard_regroup_launch<uint8_t>(valid, valid2, ix, n_new, F_old, F_new, 1, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
