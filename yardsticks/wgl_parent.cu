// Timing yardsticks: the parent designs that the port's wgl_take_col_sort
// and one-launch wgl_gather_finalize replaced, built only by chip_smoke.py
// (its gather_sort_scale phase times them beside their replacements on the
// same inputs, each against the plain version). They are not part of the
// port's kernel library and nothing in the port launches them: a take-col
// launch before each sort (out[b][i] = src[b][idx[b][i] * stride + col]),
// and a gather of three dependent loads a row (order, then perm, then the
// row) with stores strided by each field's width, followed by a finalize
// launch of one thread a member.
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

extern "C" {

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

}  // extern "C"
